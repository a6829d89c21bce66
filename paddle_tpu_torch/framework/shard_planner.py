"""The auto-sharding planner: search (data, fsdp, tp, pipe, expert)
layouts before anything runs — the port of
paddle_tpu/framework/shard_planner.py.

For every legal factorization of the device count, a clone of the
program is stamped with that layout (the expert, ZeRO-3 and pipeline
rewrites and the gradient-sync insertion the real compile applies),
priced statically — the per-rank peak estimate
(``memory_analysis.analyze_memory``), the ``wire`` channel's ring cost
(``memory_analysis.collective_wire_summary``) and the exposed-comm
roofline over the ``flops`` channel (``memory_analysis.
exposed_comm_model``, the link figure ``flag("link_gbps")`` and the peak
``observability.flops.device_peak_flops``) — and ranked.  Nothing is
launched and no device memory is touched: the shapes come from a forward
on ``meta`` tensors.

Selection rule (the JAX package's): among the configs whose peak fits
``hbm_budget_gb``, the winner minimizes the exposed communication time
plus a pipeline schedule's bubble; ties break toward fewer wire bytes,
then more data parallelism, then less fsdp, tp, pipe and expert, then
recompute-free.  The planner prices every layout the JAX package prices,
so its ranking is the JAX package's; a winner the port cannot run is
refused by name at :func:`stamp_winning_layout` (``MeshLayout.
check_ported``), never swapped for the runner-up.

``plan_sharding(..., audit_winner=True)`` needs the differential spec
auditor (``spec_audit.audit_static``), which is not ported: it raises
:class:`UnimplementedError`.

Wired through ``DistributedStrategy.auto_shard = True``
(``distributed/fleet.py``); usable standalone::

    plan = plan_sharding(program, num_devices=2, loss_name=loss.name,
                         hbm_budget_gb=16.0)
    plan.winner.layout          # MeshLayout(fsdp=2)
"""

from __future__ import annotations

import json
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .core import Program
from .errors import InvalidArgumentError, UnimplementedError
from .mesh_layout import TP_AXIS, MeshLayout, _flat_axes

PLAN_FORMAT_VERSION = 2


# ---------------------------------------------------------------------------
# config enumeration
# ---------------------------------------------------------------------------


def _divisor_pairs(n: int) -> List[Tuple[int, int]]:
    """Ordered (data, fsdp) factorizations of n, data descending."""
    out = []
    for d in range(n, 0, -1):
        if n % d == 0:
            out.append((d, n // d))
    return out


def legal_tp_degrees(program: Program, num_devices: int,
                     tp_axis: str = TP_AXIS,
                     max_tp: Optional[int] = None) -> List[int]:
    """tp degrees the PROGRAM supports: 1 always; >1 only when some
    param is tp-annotated, and the degree divides every tp-sharded dim
    AND every ``fused_attention`` head count (a head cannot split across
    tp ranks)."""
    block = program.global_block()
    dims: List[int] = []
    for v in block.vars.values():
        da = getattr(v, "dist_attr", None)
        if not da:
            continue
        for d, entry in enumerate(tuple(da)):
            axes = _flat_axes((entry,))
            if tp_axis in axes and d < len(v.shape):
                dims.append(int(v.shape[d]))
    if not dims:
        return [1]
    for op in block.ops:
        if op.type == "fused_attention" and op.attrs.get("n_head"):
            dims.append(int(op.attrs["n_head"]))
    out = []
    for t in range(1, num_devices + 1):
        if num_devices % t:
            continue
        if max_tp and t > max_tp:
            continue
        if all(s % t == 0 for s in dims):
            out.append(t)
    return out


def legal_pipe_degrees(program: Program, num_devices: int,
                       max_pipe: Optional[int] = None) -> List[int]:
    """pipe degrees the PROGRAM supports: 1 always; >1 only when a
    backward op exists (pipeline partitions training programs) and the
    degree leaves at least one forward op per stage.  ``max_pipe``
    (default 1) is the search opt-in — the pipe dimension only
    enumerates when the caller provides microbatching."""
    cap = int(max_pipe or 1)
    if cap <= 1:
        return [1]
    block = program.global_block()
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    bw_idx = next((i for i, op in enumerate(ops)
                   if op.type == "backward"), None)
    if bw_idx is None:
        return [1]
    out = []
    for p in range(1, num_devices + 1):
        if num_devices % p:
            continue
        if p > cap or p > bw_idx:
            continue
        out.append(p)
    return out or [1]


def legal_expert_degrees(program: Program, num_devices: int,
                         max_expert: Optional[int] = None) -> List[int]:
    """expert (ep) degrees the PROGRAM supports: 1 always; >1 only when
    MoE ops exist (``moe_expert_ffn`` from the decomposed layer, or the
    legacy fused ``moe_ffn``), the degree divides the device count AND
    every routed block's expert count (W1's leading dim).  ``max_expert``
    (default 1) is the search opt-in, like ``max_pipe``."""
    cap = int(max_expert or 1)
    if cap <= 1:
        return [1]
    block = program.global_block()
    expert_counts: List[int] = []
    for op in block.ops:
        if op.type not in ("moe_expert_ffn", "moe_ffn"):
            continue
        names = op.inputs.get("W1") or []
        v = block.vars.get(names[0]) if names else None
        if v is not None and v.shape:
            expert_counts.append(int(v.shape[0]))
    if not expert_counts:
        return [1]
    out = []
    for e in range(1, num_devices + 1):
        if num_devices % e or e > cap:
            continue
        if all(n % e == 0 for n in expert_counts):
            out.append(e)
    return out or [1]


def enumerate_layouts(program: Program, num_devices: int,
                      max_tp: Optional[int] = None,
                      max_pipe: Optional[int] = None,
                      max_expert: Optional[int] = None
                      ) -> List[MeshLayout]:
    """Every legal (data, fsdp, tp, pipe, expert) MeshLayout for
    ``num_devices`` (pipe > 1 / expert > 1 only when ``max_pipe`` /
    ``max_expert`` opt those dimensions in)."""
    layouts = []
    for p in legal_pipe_degrees(program, num_devices, max_pipe=max_pipe):
        for e in legal_expert_degrees(program, num_devices // p,
                                      max_expert=max_expert):
            for t in legal_tp_degrees(program, num_devices // p // e,
                                      max_tp=max_tp):
                for d, f in _divisor_pairs(num_devices // p // e // t):
                    layouts.append(MeshLayout(data=d, fsdp=f, tp=t,
                                              pipe=p, expert=e))
    return layouts


# ---------------------------------------------------------------------------
# per-config pricing
# ---------------------------------------------------------------------------


class PlanConfig:
    """One priced sharding configuration."""

    def __init__(self, layout: MeshLayout):
        self.layout = layout
        self.est = None                   # MemoryEstimate
        self.wire: Dict[str, Any] = {}
        self.exposed: Dict[str, Any] = {}  # exposed_comm_model output
        self.fits = True
        self.winner = False
        self.fsdp_report: Dict[str, Any] = {}
        self.pipe_report: Dict[str, Any] = {}
        self.expert_report: Dict[str, Any] = {}
        self.remat_plan = None             # pipe.RematPlan (remat rows)
        self.error: Optional[str] = None

    @property
    def peak_bytes(self) -> Optional[int]:
        return self.est.peak_bytes if self.est is not None else None

    @property
    def wire_bytes(self) -> Optional[int]:
        return self.wire.get("wire_bytes") if self.wire else None

    @property
    def exposed_comm_s(self) -> Optional[float]:
        return self.exposed.get("exposed_comm_s") if self.exposed else None

    @property
    def remat(self) -> bool:
        return self.remat_plan is not None

    @property
    def cost_s(self) -> Optional[float]:
        """The step-time ranking cost: exposed comm + the 1F1B bubble
        (0 for every non-pipelined config, so pre-pipe rankings are
        bit-identical)."""
        if not self.exposed:
            return None
        return self.exposed.get("cost_s", self.exposed["exposed_comm_s"])

    def sort_key(self):
        # min cost (exposed comm + pipe bubble — the step-time
        # roofline); ties → fewer total wire bytes, more data parallel,
        # then less fsdp, less tp, less pipe, remat-free first.  Cost is
        # rounded to ns so float noise can't shadow the deterministic
        # byte tie-break.
        c = self.cost_s
        return (round(c * 1e9) if c is not None else 2**62,
                self.wire_bytes if self.wire_bytes is not None else 2**62,
                -self.layout.data, self.layout.fsdp, self.layout.tp,
                self.layout.pipe, self.layout.expert,
                1 if self.remat else 0)

    def as_dict(self) -> Dict[str, Any]:
        mb = 1 << 20
        d = {"data": self.layout.data, "fsdp": self.layout.fsdp,
             "tp": self.layout.tp, "pipe": self.layout.pipe,
             "expert": self.layout.expert,
             "axes": self.layout.sizes,
             "remat": self.remat,
             "fits": bool(self.fits), "winner": bool(self.winner)}
        if self.expert_report.get("rewritten"):
            d["expert_exchanges"] = len(self.expert_report["rewritten"])
            d["expert_sharded_params"] = \
                len(self.expert_report.get("stamped") or ())
        if self.remat_plan is not None:
            d["remat_plan"] = self.remat_plan.as_dict()
        if self.pipe_report:
            d["pipe_report"] = {
                k: self.pipe_report.get(k)
                for k in ("cuts", "boundary_bytes",
                          "total_boundary_bytes", "stage_ops",
                          "num_microbatches", "schedule_summary",
                          "schedule_candidates")}
            ws = self.pipe_report.get("weight_sharding")
            if ws:
                d["pipe_report"]["weight_sharded_params"] = \
                    len(ws.get("sharded") or ())
        if self.est is not None:
            d["peak_hbm_bytes"] = int(self.est.peak_bytes)
            d["peak_hbm_mb"] = round(self.est.peak_bytes / mb, 3)
            d["state_bytes"] = int(self.est.state_bytes)
        if self.wire:
            d["wire_bytes"] = int(self.wire["wire_bytes"])
            d["wire_mb"] = round(self.wire["wire_bytes"] / mb, 3)
            d["grad_sync_wire_bytes"] = int(
                self.wire.get("grad_sync_wire_bytes", 0))
            d["forward_wire_bytes"] = int(
                self.wire.get("forward_wire_bytes", 0))
            d["wire_by_op"] = {k: dict(v) for k, v
                               in self.wire.get("by_op", {}).items()}
        if self.exposed:
            d["exposed_comm_ms"] = round(
                self.exposed["exposed_comm_s"] * 1e3, 6)
            d["wire_time_ms"] = round(self.exposed["wire_time_s"] * 1e3, 6)
            d["overlappable_compute_ms"] = round(
                self.exposed["overlappable_compute_s"] * 1e3, 6)
            d["hidden_ms"] = round(self.exposed["hidden_s"] * 1e3, 6)
            if self.exposed.get("pipe_bubble_s"):
                d["pipe_bubble_ms"] = round(
                    self.exposed["pipe_bubble_s"] * 1e3, 6)
                d["cost_ms"] = round(self.exposed["cost_s"] * 1e3, 6)
        if self.fsdp_report.get("sharded"):
            d["fsdp_sharded_params"] = len(self.fsdp_report["sharded"])
        if self.error:
            d["error"] = self.error
        return d


class Plan:
    """Ranked plan-search result (the auditable artifact)."""

    def __init__(self, configs: List[PlanConfig], num_devices: int,
                 budget_gb: Optional[float], module: str = "program",
                 num_microbatches: int = 1, pipe_schedule: str = "1f1b"):
        self.configs = configs
        self.num_devices = num_devices
        self.budget_gb = budget_gb
        self.module = module
        self.num_microbatches = int(num_microbatches)
        self.pipe_schedule = pipe_schedule
        fitting = [c for c in configs
                   if c.fits and c.error is None and c.est is not None]
        self.winner: Optional[PlanConfig] = \
            min(fitting, key=PlanConfig.sort_key) if fitting else None
        if self.winner is not None:
            self.winner.winner = True
        # populated by plan_sharding(audit_winner=True): the static-tier
        # spec audit of the winning config's rewritten clone
        self.winner_audit: Optional[Dict[str, Any]] = None

    def as_dict(self) -> Dict[str, Any]:
        return {
            "artifact": "PLAN_SEARCH",
            "format_version": PLAN_FORMAT_VERSION,
            "module": self.module,
            "num_devices": self.num_devices,
            "num_microbatches": self.num_microbatches,
            "pipe_schedule": self.pipe_schedule,
            "hbm_budget_gb": self.budget_gb,
            "compiles_attempted": 0,    # pricing is static by construction
            "configs_priced": len([c for c in self.configs
                                   if c.est is not None]),
            "configs": [c.as_dict() for c in self.configs],
            "winner": self.winner.as_dict() if self.winner else None,
            "winner_audit": self.winner_audit,
            "pricing": "memory_analysis.analyze_memory (peak HBM) + "
                       "op_spec wire ring-cost channel "
                       "(collective_wire_summary) + exposed-comm "
                       "roofline (exposed_comm_model over the op_spec "
                       "flops channel; ranking = min exposed comm + "
                       "the chosen schedule family's exact per-tick "
                       "bubble fraction (pipe.simulate_schedule), "
                       "ties → fewer wire bytes)",
        }

    def write_report(self, path: str):
        with open(path, "w") as f:
            json.dump(self.as_dict(), f, indent=1)

    def report(self) -> str:
        mb = 1 << 20
        lines = [f"auto-shard plan search: {len(self.configs)} config(s) "
                 f"over {self.num_devices} device(s)"
                 + (f", budget {self.budget_gb:g} GiB"
                    if self.budget_gb else "")]
        for c in sorted(self.configs, key=PlanConfig.sort_key):
            mark = "*" if c.winner else (" " if c.fits else "x")
            peak = f"{c.peak_bytes / mb:9.2f} MiB" if c.peak_bytes \
                is not None else "        ?"
            wire = f"{c.wire_bytes / mb:9.2f} MiB" if c.wire_bytes \
                is not None else "        ?"
            exp = f"{c.cost_s * 1e3:8.3f} ms" \
                if c.cost_s is not None else "       ?"
            lines.append(
                f" {mark} data={c.layout.data:<3d} fsdp={c.layout.fsdp:<3d} "
                f"tp={c.layout.tp:<3d} pipe={c.layout.pipe:<3d} "
                f"ep={c.layout.expert:<3d}"
                f"{'R' if c.remat else ' '} peak {peak}  wire {wire}  "
                f"cost {exp}"
                + (f"  [{c.error}]" if c.error else ""))
        if self.winner is None:
            lines.append("  NO config fits the budget")
        return "\n".join(lines)


def price_config(program: Program, layout: MeshLayout,
                 loss_name: Optional[str] = None, feed_shapes=None,
                 fetch_names: Iterable[str] = (),
                 build_strategy=None,
                 min_shard_numel: int = 2048,
                 flops_total: Optional[float] = None,
                 num_microbatches: int = 1,
                 remat: bool = False,
                 pipe_schedule: str = "1f1b",
                 pipe_shard_weights: bool = False,
                 hbm_budget_gb: Optional[float] = None) -> PlanConfig:
    """Price ONE layout on a clone of ``program``: apply the ZeRO-3
    rewrite (fsdp > 1), the pipeline stage-cut rewrite (pipe > 1, with
    ``num_microbatches`` microbatching under ``pipe_schedule`` — a
    :data:`~.pipe.SCHEDULE_FAMILIES` name, or ``"auto"`` to pick the
    family/chunking with the fewest simulated bubble ticks) and
    grad-sync insertion the real compile would apply, then run the
    static estimators (peak HBM, wire bytes, and — when ``flops_total``
    is given — the exposed-comm roofline with the schedule's EXACT
    per-tick bubble fraction, not the analytic
    ``(pipe − 1)/num_microbatches``).  ``pipe_shard_weights`` prices
    the pipe-axis ZeRO weight sharding rewrite on pipe > 1 rows.
    With ``remat=True`` the clone additionally gets recompute
    checkpoints from :func:`~.pipe.plan_remat` (the remat search
    dimension: the FLOPs delta lands in ``remat_plan`` and the
    estimate reflects the dropped residuals).  The clone is discarded —
    the input program is never mutated and nothing compiles: schedule
    selection is pure simulation (``pipe.enumerate_schedules``)."""
    from .compiler import BuildStrategy, insert_grad_sync
    from .fsdp import apply_fsdp_sharding
    from .memory_analysis import (analyze_memory, collective_wire_summary,
                                  exposed_comm_model)
    from .pipe import (apply_pipeline, apply_remat, enumerate_schedules,
                       plan_remat)
    from ..parallel.moe import apply_expert_sharding

    cfg = PlanConfig(layout)
    clone = program.clone()
    strategy = build_strategy or BuildStrategy()
    bubble = 0.0
    try:
        # expert rewrite FIRST: its dist_attr stamps make the ZeRO-3
        # pass skip the expert weights (they stay ep-sharded, not fsdp)
        if layout.expert > 1:
            cfg.expert_report = apply_expert_sharding(clone, layout)
        if layout.fsdp > 1:
            cfg.fsdp_report = apply_fsdp_sharding(
                clone, layout, min_shard_numel=min_shard_numel)
        if layout.pipe > 1:
            cands = enumerate_schedules(layout.pipe, num_microbatches)
            if pipe_schedule == "auto":
                tries = cands
            else:
                tries = [c for c in cands
                         if c["family"] == pipe_schedule] or cands[:1]
            rep = None
            for cand in tries:
                # interleaving doubles the stage-cut count — small
                # programs may not split that fine; fall through to the
                # next-best simulated candidate
                try:
                    rep = apply_pipeline(
                        clone, layout.pipe, num_microbatches,
                        pipe_axis=layout.pipe_axis,
                        feed_shapes=feed_shapes,
                        schedule=cand["family"],
                        chunks=cand["chunks"],
                        shard_weights=pipe_shard_weights,
                        min_shard_numel=min_shard_numel)
                    break
                except Exception:
                    clone = program.clone()
                    if layout.expert > 1:
                        apply_expert_sharding(clone, layout)
                    if layout.fsdp > 1:
                        apply_fsdp_sharding(
                            clone, layout,
                            min_shard_numel=min_shard_numel)
                    rep = None
            if rep is None:
                rep = apply_pipeline(
                    clone, layout.pipe, num_microbatches,
                    pipe_axis=layout.pipe_axis, feed_shapes=feed_shapes)
            sch = rep.get("schedule") or {}
            bubble = float(sch.get("bubble_frac", 0.0))
            cfg.pipe_report = dict(rep)
            cfg.pipe_report["schedule_summary"] = {
                "family": sch.get("family"),
                "chunks": sch.get("chunks"),
                "ticks": sch.get("ticks"),
                "idle_slots": sch.get("idle_slots"),
                "bubble_ticks": sch.get("bubble_ticks"),
                "bubble_frac": bubble,
            }
            cfg.pipe_report["schedule_candidates"] = [
                {"family": c["family"], "chunks": c["chunks"],
                 "bubble_ticks": c["bubble_ticks"],
                 "bubble_frac": c["bubble_frac"]} for c in cands]
        sizes = layout.sizes
        reduce_axes = tuple(a for a in _flat_axes(layout.batch_axes)
                            if sizes.get(a, 1) > 1)
        if loss_name is not None and reduce_axes:
            n = int(np.prod([sizes[a] for a in reduce_axes]))
            insert_grad_sync(clone, strategy, n,
                             reduce_axes, axis_sizes=sizes)
        kw = dict(feed_shapes=feed_shapes, fetch_names=list(fetch_names),
                  mesh_axes=layout.mesh_axes,
                  batch_axis=layout.batch_axes)
        if remat:
            rplan = plan_remat(clone, feed_shapes=feed_shapes,
                               fetch_names=list(fetch_names),
                               mesh_axes=layout.mesh_axes,
                               batch_axis=layout.batch_axes,
                               budget_gb=hbm_budget_gb)
            if rplan is None:
                cfg.error = "remat: no recompute plan available"
                return cfg
            apply_remat(clone, rplan)
            cfg.remat_plan = rplan
        cfg.est = analyze_memory(clone, **kw)
        cfg.wire = collective_wire_summary(clone, **kw)
        if flops_total is not None:
            has_bw = any(op.type == "backward"
                         for op in clone.global_block().ops)
            flops = flops_total
            if cfg.remat_plan is not None:
                flops = flops + cfg.remat_plan.flops_delta
            cfg.exposed = exposed_comm_model(
                cfg.wire, flops,
                num_devices=layout.num_devices,
                overlap=bool(getattr(strategy, "overlap_grad_sync",
                                     False)),
                has_backward=has_bw, bubble_frac=bubble)
    except Exception as e:      # a pricing bug must not kill the search
        cfg.error = f"{type(e).__name__}: {e}"
    return cfg


# ---------------------------------------------------------------------------
# the search
# ---------------------------------------------------------------------------


def plan_sharding(program: Program, num_devices: int,
                  loss_name: Optional[str] = None, feed_shapes=None,
                  fetch_names: Iterable[str] = (),
                  hbm_budget_gb: Optional[float] = None,
                  build_strategy=None, max_tp: Optional[int] = None,
                  min_shard_numel: int = 2048,
                  module: str = "program",
                  report_path: Optional[str] = None,
                  max_pipe: Optional[int] = None,
                  max_expert: Optional[int] = None,
                  num_microbatches: int = 1,
                  remat: bool = False,
                  pipe_schedule: str = "1f1b",
                  pipe_shard_weights: bool = False,
                  audit_winner: bool = False) -> Plan:
    """Search every legal (data, fsdp, tp, pipe) factorization of
    ``num_devices``, price each statically, and rank them.  Returns the
    :class:`Plan`; ``plan.winner`` is None when no config fits the
    budget (the caller decides whether that is fatal).

    ``max_pipe`` > 1 opts the pipeline dimension in: each pipe > 1
    config is priced on a stage-cut clone under ``pipe_schedule``
    (``"1f1b"``, ``"interleaved"``, ``"zero_bubble"``, or ``"auto"``
    to let each row take the family/chunking with the fewest simulated
    bubble ticks) with the schedule's EXACT per-tick bubble fraction in
    the roofline — the analytic ``(pipe − 1)/num_microbatches`` term is
    gone.  ``pipe_shard_weights`` additionally prices pipe-axis ZeRO
    weight sharding on those rows.  ``remat=True`` adds a
    rematerialized sibling row for every budget-rejected config — when
    the recompute plan fits, the reject flips to an admitted config
    carrying the priced FLOPs delta.

    Nothing is launched: pricing (schedule selection included, which is
    ``pipe.simulate_schedule`` arithmetic) runs on program clones
    through the static memory / wire model only, on ``meta`` tensors.

    ``audit_winner=True`` raises :class:`UnimplementedError`: the spec
    auditor it runs (``spec_audit.audit_static``) is not ported."""
    if audit_winner:
        raise UnimplementedError(
            "plan_sharding(audit_winner=True): the static spec audit of the "
            "winner (spec_audit.audit_static) is not ported yet; plan "
            "without it")
    budget = float(hbm_budget_gb) if hbm_budget_gb else None
    # whole-program GEMM FLOPs priced ONCE on the base program (layout
    # rewrites never change the math) — the exposed-comm roofline's
    # compute term, shared by every config
    try:
        from ..observability.flops import estimate_step_flops
        flops_total = estimate_step_flops(
            program, feed_shapes=feed_shapes,
            fetch_names=list(fetch_names))["total_flops"]
    except Exception:
        flops_total = None
    kw = dict(loss_name=loss_name, feed_shapes=feed_shapes,
              fetch_names=fetch_names, build_strategy=build_strategy,
              min_shard_numel=min_shard_numel, flops_total=flops_total,
              num_microbatches=num_microbatches,
              pipe_schedule=pipe_schedule,
              pipe_shard_weights=pipe_shard_weights)
    configs = []
    for layout in enumerate_layouts(program, num_devices, max_tp=max_tp,
                                    max_pipe=max_pipe,
                                    max_expert=max_expert):
        cfg = price_config(program, layout, **kw)
        if budget is not None and cfg.est is not None:
            cfg.fits = cfg.est.peak_gb <= budget
        configs.append(cfg)
        if budget is not None and remat and not cfg.fits and \
                cfg.error is None:
            # the remat dimension: a rejected config's rematerialized
            # sibling — recompute checkpoints at the liveness peak,
            # priced FLOPs delta in the bubble-aware roofline
            rcfg = price_config(program, layout, remat=True,
                                hbm_budget_gb=budget, **kw)
            if rcfg.est is not None and rcfg.error is None:
                rcfg.fits = rcfg.est.peak_gb <= budget
                configs.append(rcfg)
    plan = Plan(configs, num_devices, budget, module=module,
                num_microbatches=num_microbatches,
                pipe_schedule=pipe_schedule)
    if report_path:
        plan.write_report(report_path)
    return plan


def stamp_winning_layout(program: Program, plan: Plan,
                         min_shard_numel: int = 2048,
                         prefetch_distance: int = 0,
                         feed_shapes=None) -> MeshLayout:
    """Apply ``plan.winner`` to the REAL program: the ZeRO-3 rewrite
    (fsdp > 1, gathers prefetched ``prefetch_distance`` layers early),
    the pipeline stage-cut rewrite (pipe > 1, with the plan's
    microbatch count), the winner's recompute checkpoints (remat rows)
    plus the canonical ``_mesh_layout`` stamp.  Grad-sync insertion
    stays with ``CompiledProgram.with_mesh`` (it reads the stamped
    dist_attrs).  Raises ``InvalidArgumentError`` when no config fit,
    and ``UnimplementedError`` by name (``MeshLayout.check_ported``:
    ``check_pipe_beside``, ``check_expert_beside``) when the winner is a
    layout the port does not run — never the runner-up in its place.  A
    fsdp x tp (x sp) winner runs: the ZeRO-3 rewrite skips the
    parameters the tp layers stamped."""
    if plan.winner is None:
        raise InvalidArgumentError(
            "auto_shard: no sharding configuration fits "
            f"hbm_budget_gb={plan.budget_gb:g} on {plan.num_devices} "
            "device(s); ranked attempts:\n" + plan.report())
    layout = plan.winner.layout
    layout.check_ported()
    if layout.expert > 1:
        from ..parallel.moe import apply_expert_sharding
        apply_expert_sharding(program, layout)
    if layout.fsdp > 1:
        from .fsdp import apply_fsdp_sharding
        apply_fsdp_sharding(program, layout,
                            min_shard_numel=min_shard_numel,
                            prefetch_distance=prefetch_distance)
    if layout.pipe > 1:
        from .pipe import apply_pipeline
        # re-apply exactly what pricing chose: schedule family, chunk
        # count, and (when priced) pipe-axis weight sharding
        summ = plan.winner.pipe_report.get("schedule_summary") or {}
        ws = plan.winner.pipe_report.get("weight_sharding") or {}
        apply_pipeline(program, layout.pipe, plan.num_microbatches,
                       pipe_axis=layout.pipe_axis,
                       feed_shapes=feed_shapes,
                       schedule=summ.get("family") or "1f1b",
                       chunks=int(summ.get("chunks") or 1),
                       shard_weights=bool(ws.get("sharded")),
                       min_shard_numel=min_shard_numel)
    elif plan.num_microbatches > 1:
        from .pipe import set_microbatches
        set_microbatches(program, plan.num_microbatches)
    if plan.winner.remat_plan is not None:
        from .pipe import apply_remat
        apply_remat(program, plan.winner.remat_plan)
    program._mesh_layout = layout
    return layout


__all__ = ["Plan", "PlanConfig", "plan_sharding", "price_config",
           "enumerate_layouts", "legal_tp_degrees", "legal_pipe_degrees",
           "legal_expert_degrees", "stamp_winning_layout",
           "PLAN_FORMAT_VERSION"]
