"""Layout-portable checkpoint resharding — the port of
paddle_tpu/framework/reshard.py: plan and execute the transfer that moves
one sharding layout's persistable state onto another (numpy, ``errors``
and ``mesh_layout`` only, so a plan is the JAX package's byte for byte).

Every (source spec, destination spec) pair decomposes into a static
schedule of

* ``slice``       — refining a dim (fsdp2 → fsdp4): each source shard
                    splits locally, 0 wire bytes;
* ``all_gather``  — coarsening a dim (fsdp4 → fsdp2, fsdp2 → replicated):
                    grouped gather over ``k = s/d`` neighbouring shards;
* ``all_to_all``  — a general re-split (s ∤ d, d ∤ s): micro-shard
                    exchange at ``lcm(s, d)`` granularity;
* ``permute``     — the same divisor under other axis names;
* ``repad``       — ZeRO-1 flat optimizer-shard realignment: the flat
                    state pads to ``n·align`` for ``n`` ranks, so another
                    data degree changes the padded length.

The candidate schedules (the per-dim decomposition against gathering
everything and slicing) are priced on the ring wire-byte model and the
cheapest wins, with no compile.  ``analysis.verify_reshard`` validates a
plan (``reshard-*`` diagnostics) before anything moves;
:func:`execute_reshard` runs the schedule shard by shard on host arrays
(the restore path), counting the bytes it moves so that execution is held
to the plan's accounting.

:meth:`ReshardPlan.price` prices a restore through
``memory_analysis.exposed_comm_model``.  :func:`arm_fault` (the
``reshard_execute`` fault seam of ``testing/faultline.py``) waits for its
slice and raises :class:`UnimplementedError` naming it;
:func:`execute_reshard` crosses no seam."""

from __future__ import annotations

import math
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .errors import InvalidArgumentError, UnimplementedError
from .mesh_layout import MeshLayout, ShardSpec, _flat_axes

RESHARD_FORMAT_VERSION = 1

#: step kind → the registered op types the step lowers to on the live
#: (device-resident) path.  ``verify_reshard`` checks these stay real.
STEP_LOWERING = {
    "slice": ("slice",),
    "all_gather": ("fsdp_all_gather",),
    "all_to_all": ("slice", "fsdp_all_gather"),   # portable decomposition
    "permute": ("c_identity",),
    "repad": ("reshape", "slice", "concat"),
    "identity": ("c_identity",),
}


def _dtype_nbytes(dtype) -> int:
    return int(np.dtype(dtype).itemsize)


def spec_dim_divisors(spec: Optional[ShardSpec], ndim: int,
                      layout: Optional[MeshLayout]) -> List[int]:
    """Per-dim shard counts of ``spec`` under ``layout`` (axes absent
    from the layout — or present at size 1 — don't shard)."""
    if spec is None or layout is None:
        return [1] * ndim
    return list(layout.spec_shards(spec, ndim))


def _a2a_moved_frac(s: int, d: int) -> Tuple[int, int]:
    """(moved_micro, micro): how many lcm-granularity micro-shards must
    change owner when a dim re-splits from ``s`` to ``d`` shards, ranks
    identified linearly (dst rank r colocates with src rank r)."""
    micro = (s * d) // math.gcd(s, d)
    moved = 0
    for r in range(d):
        dst_lo, dst_hi = r * micro // d, (r + 1) * micro // d
        if r < s:
            src_lo, src_hi = r * micro // s, (r + 1) * micro // s
        else:
            src_lo = src_hi = -1
        overlap = max(0, min(dst_hi, src_hi) - max(dst_lo, src_lo))
        moved += (dst_hi - dst_lo) - overlap
    return moved, micro


def flat_moved_bytes(numel: int, src_pad: int, n_src: int,
                     dst_pad: int, n_dst: int, itemsize: int) -> int:
    """Wire bytes of a ZeRO-1 flat realign: true elements each dst rank
    needs that its colocated src rank does not hold (padding is
    update-inert zero and never moves)."""
    moved = 0
    for r in range(n_dst):
        dst_lo = min(r * dst_pad // n_dst, numel)
        dst_hi = min((r + 1) * dst_pad // n_dst, numel)
        if r < n_src:
            src_lo = min(r * src_pad // n_src, numel)
            src_hi = min((r + 1) * src_pad // n_src, numel)
        else:
            src_lo = src_hi = -1
        overlap = max(0, min(dst_hi, src_hi) - max(dst_lo, src_lo))
        moved += (dst_hi - dst_lo) - overlap
    return moved * itemsize


class ReshardStep:
    """One schedule entry for one persistable."""

    __slots__ = ("kind", "dim", "src_parts", "dst_parts", "wire_bytes",
                 "detail")

    def __init__(self, kind: str, dim: int, src_parts: int, dst_parts: int,
                 wire_bytes: int, detail: Optional[Dict[str, Any]] = None):
        self.kind = kind
        self.dim = int(dim)
        self.src_parts = int(src_parts)
        self.dst_parts = int(dst_parts)
        self.wire_bytes = int(wire_bytes)
        self.detail = dict(detail or {})

    @property
    def lowers_to(self) -> Tuple[str, ...]:
        return STEP_LOWERING.get(self.kind, ())

    def as_dict(self) -> Dict[str, Any]:
        d = {"kind": self.kind, "dim": self.dim,
             "src_parts": self.src_parts, "dst_parts": self.dst_parts,
             "wire_bytes": self.wire_bytes,
             "lowers_to": list(self.lowers_to)}
        if self.detail:
            d["detail"] = dict(self.detail)
        return d

    def __repr__(self):
        return (f"ReshardStep({self.kind}, dim={self.dim}, "
                f"{self.src_parts}->{self.dst_parts}, "
                f"wire={self.wire_bytes})")


class VarTransfer:
    """The chosen schedule (plus the rejected candidates) for one var."""

    def __init__(self, name: str, shape: Tuple[int, ...], dtype: str,
                 src_spec: Optional[ShardSpec],
                 dst_spec: Optional[ShardSpec]):
        self.name = name
        self.shape = tuple(int(s) for s in shape)
        self.dtype = str(dtype)
        self.src_spec = src_spec
        self.dst_spec = dst_spec
        self.src_divs: List[int] = []
        self.dst_divs: List[int] = []
        self.steps: List[ReshardStep] = []
        self.candidates: List[Dict[str, Any]] = []
        self.dst_shape: Tuple[int, ...] = self.shape   # repad may change it
        self.flat: Optional[Dict[str, Any]] = None     # ZeRO-1 realign meta
        self.issues: List[Tuple[str, str, str]] = []   # (sev, code, msg)

    @property
    def nbytes(self) -> int:
        return int(np.prod(self.shape or (1,))) * _dtype_nbytes(self.dtype)

    @property
    def wire_bytes(self) -> int:
        return sum(s.wire_bytes for s in self.steps)

    @property
    def identity(self) -> bool:
        return not self.steps

    def as_dict(self) -> Dict[str, Any]:
        return {"name": self.name, "shape": list(self.shape),
                "dst_shape": list(self.dst_shape), "dtype": self.dtype,
                "src_spec": list(tuple(self.src_spec))
                if self.src_spec is not None else None,
                "dst_spec": list(tuple(self.dst_spec))
                if self.dst_spec is not None else None,
                "src_divs": list(self.src_divs),
                "dst_divs": list(self.dst_divs),
                "wire_bytes": self.wire_bytes,
                "identity": self.identity,
                "steps": [s.as_dict() for s in self.steps],
                "candidates": [dict(c) for c in self.candidates]}


def _direct_steps(tr: VarTransfer) -> List[ReshardStep]:
    """Minimal per-dim decomposition (the paper's factored schedule)."""
    steps: List[ReshardStep] = []
    nbytes = tr.nbytes
    for dim, (s, d) in enumerate(zip(tr.src_divs, tr.dst_divs)):
        src_axes = _flat_axes((tuple(tr.src_spec)[dim],)) \
            if tr.src_spec is not None and dim < len(tuple(tr.src_spec)) \
            else ()
        dst_axes = _flat_axes((tuple(tr.dst_spec)[dim],)) \
            if tr.dst_spec is not None and dim < len(tuple(tr.dst_spec)) \
            else ()
        if s == d:
            if s > 1 and tuple(src_axes) != tuple(dst_axes):
                steps.append(ReshardStep(
                    "permute", dim, s, d, nbytes,
                    {"src_axes": list(src_axes),
                     "dst_axes": list(dst_axes)}))
            continue
        if d % s == 0:
            steps.append(ReshardStep("slice", dim, s, d, 0,
                                     {"factor": d // s}))
        elif s % d == 0:
            k = s // d
            steps.append(ReshardStep(
                "all_gather", dim, s, d, (k - 1) * nbytes,
                {"group": k, "axes": list(src_axes)}))
        else:
            moved, micro = _a2a_moved_frac(s, d)
            steps.append(ReshardStep(
                "all_to_all", dim, s, d, nbytes * moved // micro,
                {"micro": micro, "moved_micro": moved}))
    return steps


def _gather_all_steps(tr: VarTransfer) -> List[ReshardStep]:
    """The naive candidate: gather every dim fully, then slice to dst."""
    steps: List[ReshardStep] = []
    nbytes = tr.nbytes
    for dim, s in enumerate(tr.src_divs):
        if s > 1:
            steps.append(ReshardStep("all_gather", dim, s, 1,
                                     (s - 1) * nbytes, {"group": s}))
    for dim, d in enumerate(tr.dst_divs):
        if d > 1:
            steps.append(ReshardStep("slice", dim, 1, d, 0,
                                     {"factor": d}))
    return steps


def plan_var_transfer(name: str, shape: Tuple[int, ...], dtype: str,
                      src_spec, src_layout: MeshLayout,
                      dst_spec, dst_layout: MeshLayout,
                      flat: Optional[Dict[str, Any]] = None) -> VarTransfer:
    """Plan one persistable's transfer; ``flat`` carries the ZeRO-1
    metadata ``{"numel", "align", "axes"}`` for flat optimizer shards."""
    src_spec = ShardSpec.coerce(src_spec)
    dst_spec = ShardSpec.coerce(dst_spec)
    tr = VarTransfer(name, shape, dtype, src_spec, dst_spec)
    ndim = len(tr.shape)

    for side, spec, layout in (("src", src_spec, src_layout),
                               ("dst", dst_spec, dst_layout)):
        if spec is None:
            continue
        for a in spec.axes:
            if layout is not None and a not in layout:
                tr.issues.append((
                    "warning", "reshard-axis-dangling",
                    f"persistable {name!r}: {side} spec axis {a!r} is not "
                    f"in the {side} layout {layout.axis_names} — the dim "
                    f"replicates there"))

    if flat:
        # ZeRO-1 flat optimizer shard: realign padding for the dst
        # data degree, then the (now 1-D, dst-padded) dim reshard below
        numel = int(flat["numel"])
        align = int(flat.get("align", 1)) or 1
        axes = tuple(flat.get("axes") or
                     (src_layout.data_axis if src_layout else "dp",))

        def _rank_count(key, layout):
            if flat.get(key):
                return int(flat[key])
            n = 1
            for a in axes:
                n *= layout.size(a) if layout else 1
            return max(n, 1)

        n_src = _rank_count("n_src", src_layout)
        n_dst = _rank_count("n_dst", dst_layout)
        src_pad = int(flat.get("src_pad") or
                      numel + (-numel % (n_src * align)))
        dst_pad = int(flat.get("dst_pad") or
                      numel + (-numel % (n_dst * align)))
        if ndim != 1 or tr.shape[0] != src_pad:
            tr.issues.append((
                "error", "reshard-flat-shape",
                f"flat shard {name!r}: checkpoint shape {tr.shape} does "
                f"not match the {n_src}-rank {align}-aligned padded "
                f"length ({src_pad},) its metadata implies"))
            return tr
        tr.flat = {"numel": numel, "align": align, "axes": list(axes),
                   "src_pad": src_pad, "dst_pad": dst_pad,
                   "n_src": n_src, "n_dst": n_dst}
        tr.dst_shape = (dst_pad,)
        tr.src_divs = [n_src]
        tr.dst_divs = [n_dst]
        wire = flat_moved_bytes(numel, src_pad, n_src, dst_pad, n_dst,
                                _dtype_nbytes(dtype))
        if src_pad != dst_pad or n_src != n_dst:
            tr.steps = [ReshardStep(
                "repad", 0, n_src, n_dst, wire,
                {"numel": numel, "align": align,
                 "src_pad": src_pad, "dst_pad": dst_pad})]
            tr.candidates = [{"name": "repad", "wire_bytes": wire,
                              "steps": 1, "chosen": True}]
        return tr

    tr.src_divs = spec_dim_divisors(src_spec, ndim, src_layout)
    tr.dst_divs = spec_dim_divisors(dst_spec, ndim, dst_layout)
    for dim, (s, d) in enumerate(zip(tr.src_divs, tr.dst_divs)):
        for side, parts in (("src", s), ("dst", d)):
            if parts > 1 and tr.shape[dim] % parts != 0:
                tr.issues.append((
                    "error", "reshard-indivisible",
                    f"persistable {name!r} dim {dim} (size "
                    f"{tr.shape[dim]}) is not divisible by its {side} "
                    f"shard count {parts}"))
    if any(sev == "error" for sev, _, _ in tr.issues):
        return tr

    if tr.src_divs == tr.dst_divs:
        direct = _direct_steps(tr)      # permutes only (if axes moved)
        tr.steps = direct
        tr.candidates = [{"name": "direct",
                          "wire_bytes": sum(s.wire_bytes for s in direct),
                          "steps": len(direct), "chosen": True}]
        return tr

    cands = [("direct", _direct_steps(tr))]
    gather = _gather_all_steps(tr)
    if [s.as_dict() for s in gather] != [s.as_dict() for s in cands[0][1]]:
        cands.append(("gather-then-slice", gather))
    priced = [(cname, steps, sum(s.wire_bytes for s in steps))
              for cname, steps in cands]
    priced.sort(key=lambda t: (t[2], len(t[1])))
    tr.steps = priced[0][1]
    tr.candidates = [{"name": cname, "wire_bytes": w, "steps": len(steps),
                      "chosen": cname == priced[0][0]}
                     for cname, steps, w in priced]
    return tr


class ReshardPlan:
    """The static transfer schedule between two layouts."""

    def __init__(self, src_layout: Optional[MeshLayout],
                 dst_layout: Optional[MeshLayout]):
        self.src_layout = src_layout
        self.dst_layout = dst_layout
        self.transfers: Dict[str, VarTransfer] = {}
        self.compiles_attempted = 0    # static by construction
        self.pricing: Optional[Dict[str, Any]] = None

    # -- queries ---------------------------------------------------------
    @property
    def wire_bytes(self) -> int:
        return sum(t.wire_bytes for t in self.transfers.values())

    @property
    def identity(self) -> bool:
        return all(t.identity for t in self.transfers.values())

    @property
    def moving(self) -> List[VarTransfer]:
        return [t for t in self.transfers.values() if not t.identity]

    def issues(self) -> List[Tuple[str, str, str]]:
        out = []
        for t in self.transfers.values():
            out.extend(t.issues)
        return out

    def candidates_rejected(self) -> int:
        return sum(1 for t in self.transfers.values()
                   for c in t.candidates if not c["chosen"])

    def steps_by_kind(self) -> Dict[str, int]:
        out: Dict[str, int] = {}
        for t in self.transfers.values():
            for s in t.steps:
                out[s.kind] = out.get(s.kind, 0) + 1
        return out

    def dst_shape(self, name: str) -> Optional[Tuple[int, ...]]:
        t = self.transfers.get(name)
        return t.dst_shape if t is not None else None

    # -- rank-local restore reads ----------------------------------------
    def dst_block_rows(self, name: str, block: int
                       ) -> Optional[Tuple[int, int]]:
        """The GLOBAL dim-0 source row interval dst block ``block``
        needs from the checkpoint.  On the host-side restore there are
        no device collectives — dst block b's content is exactly its
        slice of the (logically ordered) source rows: ``[b·h, (b+1)·h)``
        with h the dst dim-0 block height; a ZeRO-1 flat repad clamps
        to the logical numel (padding is appended, never interleaved).
        None → the var has no dim-0 sharding for this block count (read
        everything)."""
        t = self.transfers.get(name)
        if t is None or not t.shape:
            return None
        if t.flat:
            n_dst = int(t.flat["n_dst"])
            if block < 0 or block >= n_dst:
                return None
            h = int(t.flat["dst_pad"]) // n_dst
            lo = block * h
            hi = min((block + 1) * h, int(t.flat["numel"]))
            return (lo, max(hi, lo))
        d0 = t.dst_divs[0] if t.dst_divs else 1
        if d0 <= 1 or block < 0 or block >= d0 or t.shape[0] % d0:
            return None
        h = t.shape[0] // d0
        return (block * h, (block + 1) * h)

    def dst_read_ranges(self, owned_blocks: Dict[str, Iterable[int]]
                        ) -> Dict[str, List[Tuple[int, int]]]:
        """Per-var merged GLOBAL dim-0 row ranges a process owning
        ``owned_blocks[name]`` (dim-0 dst block indices) must read from
        the checkpoint — what ``io._read_sharded_arrays`` turns into
        byte-range reads.  Vars absent from ``owned_blocks`` (or with no
        dim-0 sharding) are omitted: the reader falls back to reading
        them whole."""
        out: Dict[str, List[Tuple[int, int]]] = {}
        for name, blocks in owned_blocks.items():
            ivs = []
            for b in blocks:
                iv = self.dst_block_rows(name, int(b))
                if iv is None:
                    ivs = None
                    break
                if iv[1] > iv[0]:
                    ivs.append(iv)
            if not ivs:
                continue
            ivs.sort()
            merged = [list(ivs[0])]
            for lo, hi in ivs[1:]:
                if lo <= merged[-1][1]:
                    merged[-1][1] = max(merged[-1][1], hi)
                else:
                    merged.append([lo, hi])
            out[name] = [tuple(iv) for iv in merged]
        return out

    # -- pricing (the planner's cost model, reused) ----------------------
    def wire_summary(self) -> Dict[str, Any]:
        """A ``collective_wire_summary``-shaped dict so the existing
        ``exposed_comm_model`` prices the restore (all exposed — a
        restore has no compute to hide under)."""
        by_op: Dict[str, Dict[str, int]] = {}
        logical = 0
        for t in self.transfers.values():
            logical += t.nbytes
            for s in t.steps:
                op = (s.lowers_to or (s.kind,))[-1]
                row = by_op.setdefault(op, {"count": 0, "wire_bytes": 0,
                                            "logical_bytes": 0})
                row["count"] += 1
                row["wire_bytes"] += s.wire_bytes
                row["logical_bytes"] += t.nbytes
        return {"wire_bytes": self.wire_bytes, "logical_bytes": logical,
                "forward_wire_bytes": self.wire_bytes,
                "grad_sync_wire_bytes": 0, "by_op": by_op,
                "unpriced_collectives": []}

    def price(self, ici_gbps=None) -> Dict[str, Any]:
        """The restore's time through ``memory_analysis.
        exposed_comm_model`` (all of it exposed: a restore has no compute
        to hide under).  ``ici_gbps`` is the JAX package's keyword, read
        as the link's GB/s (default ``flag("link_gbps")``)."""
        from .memory_analysis import exposed_comm_model
        n = self.dst_layout.num_devices if self.dst_layout else 1
        priced = exposed_comm_model(self.wire_summary(), 0.0,
                                    num_devices=n, overlap=False,
                                    has_backward=False, link_gbps=ici_gbps)
        self.pricing = priced
        return priced

    # -- reporting -------------------------------------------------------
    def as_dict(self) -> Dict[str, Any]:
        d = {"artifact": "RESHARD_PLAN",
             "format_version": RESHARD_FORMAT_VERSION,
             "src_layout": self.src_layout.to_desc()
             if self.src_layout else None,
             "dst_layout": self.dst_layout.to_desc()
             if self.dst_layout else None,
             "wire_bytes": self.wire_bytes,
             "identity": self.identity,
             "steps_by_kind": self.steps_by_kind(),
             "vars_total": len(self.transfers),
             "vars_moving": len(self.moving),
             "candidates_rejected": self.candidates_rejected(),
             "compiles_attempted": self.compiles_attempted,
             "transfers": [t.as_dict() for t in self.transfers.values()
                           if not t.identity]}
        # the JAX package also prices the plan here (``wire_time_ms``,
        # ``exposed_comm_ms``); the port's figures are :meth:`price`'s
        return d

    def report(self) -> str:
        mb = 1 << 20
        src = self.src_layout.sizes if self.src_layout else "?"
        dst = self.dst_layout.sizes if self.dst_layout else "?"
        lines = [f"reshard plan {src} -> {dst}: "
                 f"{len(self.moving)}/{len(self.transfers)} var(s) move, "
                 f"{self.wire_bytes / mb:.3f} MiB wire, "
                 f"steps {self.steps_by_kind()}"]
        for t in self.moving:
            lines.append(f"  {t.name} {t.shape}->{t.dst_shape}: " +
                         ", ".join(f"{s.kind}[d{s.dim} "
                                   f"{s.src_parts}->{s.dst_parts}]"
                                   for s in t.steps) +
                         f"  {t.wire_bytes / mb:.3f} MiB")
        return "\n".join(lines)

    def raise_on_error(self):
        from .analysis import verify_reshard
        verify_reshard(self).raise_on_error()
        return self


def flat_shard_meta(program) -> Dict[str, Dict[str, Any]]:
    """ZeRO-1 flat optimizer-shard alignment metadata, extracted from
    the program IR: ``{persistable: {"owner", "numel", "align", "axes"}}``
    for every persistable accumulator living at the flat padded-shard
    layout (``zero_shard_slice``/``zero_all_gather`` pattern).  This is
    what checkpoint format v2 embeds so a different data degree can
    repad the flat state instead of crashing on a shape mismatch."""
    block = program.global_block()
    align_of: Dict[str, Tuple[int, Tuple[str, ...]]] = {}
    owner_of: Dict[str, Tuple[str, int]] = {}
    for op in block.ops:
        if op.type == "zero_shard_slice":
            out = op.outputs.get("Out", [None])[0]
            axes = _flat_axes(op.attrs.get("_axis_name") or ())
            if out:
                align_of[out] = (int(op.attrs.get("align", 1) or 1), axes)
        elif op.type == "zero_all_gather":
            psh = op.inputs.get("X", [None])[0]
            p = op.outputs.get("Out", [None])[0]
            if psh and p:
                owner_of[psh] = (p, int(op.attrs.get("numel", 0)))
    meta: Dict[str, Dict[str, Any]] = {}
    for psh, (owner, numel) in owner_of.items():
        pvar = block.vars.get(psh)
        if pvar is None or not numel:
            continue
        align, axes = align_of.get(psh, (1, ()))
        if not axes:
            da = tuple(getattr(pvar, "dist_attr", None) or ())
            axes = _flat_axes(da)
        shape = tuple(int(s) for s in pvar.shape)
        rec = {"owner": owner, "numel": int(numel), "align": int(align),
               "axes": list(axes)}
        # every persistable coupled to the shard update at the same flat
        # padded shape (Adam moments, gradient-merge accumulators, …)
        for op in block.ops:
            names = set(op.input_names()) | set(op.output_names())
            if psh not in names:
                continue
            for n in names:
                v = block._find_var_recursive(n)
                if v is None or not v.persistable or n == owner:
                    continue
                if tuple(int(s) for s in v.shape) == shape:
                    meta[n] = dict(rec)
    return meta


def plan_reshard(src_layout: Optional[MeshLayout],
                 dst_layout: Optional[MeshLayout],
                 program=None,
                 var_sigs: Optional[Dict[str, Tuple[Tuple[int, ...],
                                                    str]]] = None,
                 src_specs: Optional[Dict[str, Any]] = None,
                 dst_specs: Optional[Dict[str, Any]] = None,
                 flat_meta: Optional[Dict[str, Dict[str, Any]]] = None,
                 validate: bool = True) -> ReshardPlan:
    """Plan the minimal collective schedule that moves every persistable
    from ``src_layout`` onto ``dst_layout``.

    Sources of truth, in precedence order:

    * ``var_sigs`` ``{name: (shape, dtype)}`` — the checkpoint
      manifest's view of the saved state (shapes are SOURCE shapes);
      falls back to ``program``'s persistables.
    * ``src_specs`` — per-var ShardSpec spellings from the checkpoint
      manifest; default: the program's stamped ``dist_attr``.
    * ``dst_specs`` — per-var specs under the destination; default: the
      same spec re-read against ``dst_layout`` (the elastic case — the
      relaunched program stamps the same axis names at new sizes).
    * ``flat_meta`` — ZeRO-1 flat-shard alignment metadata
      (:func:`flat_shard_meta`); flat vars repad instead of resharding
      by annotation.

    0 compiles are attempted; rejected candidate schedules are priced
    from byte arithmetic alone."""
    plan = ReshardPlan(src_layout, dst_layout)
    if var_sigs is None:
        if program is None:
            raise InvalidArgumentError(
                "plan_reshard: need a program or var_sigs to know the "
                "persistable set")
        var_sigs = {}
        for v in program.list_vars():
            if v.persistable:
                var_sigs[v.name] = (tuple(int(s) for s in v.shape),
                                    str(v.dtype))
    if src_specs is None:
        src_specs = {}
        if program is not None:
            for v in program.list_vars():
                if v.persistable and getattr(v, "dist_attr", None):
                    src_specs[v.name] = ShardSpec.coerce(v.dist_attr)
    flat_meta = dict(flat_meta or {})
    for name, (shape, dtype) in sorted(var_sigs.items()):
        s_spec = ShardSpec.coerce(src_specs.get(name))
        if dst_specs is not None:
            d_spec = ShardSpec.coerce(dst_specs.get(name))
        else:
            d_spec = s_spec          # same annotation, new axis sizes
        plan.transfers[name] = plan_var_transfer(
            name, shape, dtype, s_spec, src_layout, d_spec, dst_layout,
            flat=flat_meta.get(name))
    if validate:
        from .analysis import verify_reshard
        verify_reshard(plan).raise_on_error()
    return plan


# ---------------------------------------------------------------------------
# execution (host path: restore-from-checkpoint)
# ---------------------------------------------------------------------------


def _split_dim(shards: Dict[Tuple[int, ...], np.ndarray], dim: int,
               factor: int) -> Dict[Tuple[int, ...], np.ndarray]:
    out = {}
    for rank, arr in shards.items():
        for j, piece in enumerate(np.split(arr, factor, axis=dim)):
            r = list(rank)
            r[dim] = rank[dim] * factor + j
            out[tuple(r)] = piece
    return out


def _gather_dim(shards: Dict[Tuple[int, ...], np.ndarray], dim: int,
                group: int) -> Tuple[Dict[Tuple[int, ...], np.ndarray], int]:
    out = {}
    moved = 0
    groups: Dict[Tuple[int, ...], List[Tuple[int, np.ndarray]]] = {}
    for rank, arr in shards.items():
        key = list(rank)
        key[dim] = rank[dim] // group
        groups.setdefault(tuple(key), []).append((rank[dim] % group, arr))
    for key, members in groups.items():
        members.sort(key=lambda t: t[0])
        arrs = [a for _, a in members]
        total = sum(a.nbytes for a in arrs)
        # ring all-gather: each of the `group` members receives every
        # OTHER member's shard
        moved += (group - 1) * total
        out[key] = np.concatenate(arrs, axis=dim)
    return out, moved


def _execute_var(tr: VarTransfer, arr: np.ndarray
                 ) -> Tuple[np.ndarray, int]:
    """Run the schedule shard-by-shard; returns (dst global array,
    actually-moved wire bytes)."""
    moved_total = 0
    if tr.flat is not None:
        f = tr.flat
        flat = np.ascontiguousarray(arr).reshape(-1)
        true = flat[:f["numel"]]
        out = np.zeros((f["dst_pad"],), dtype=arr.dtype)
        out[:f["numel"]] = true
        if tr.steps:
            moved_total += flat_moved_bytes(
                f["numel"], f["src_pad"], f["n_src"], f["dst_pad"],
                f["n_dst"], arr.dtype.itemsize)
        return out, moved_total

    ndim = max(len(tr.shape), 1)
    cur = list(tr.src_divs) or [1] * ndim
    shards: Dict[Tuple[int, ...], np.ndarray] = {}

    def split_all(a, divs):
        pieces = {(): a}
        for dim, dv in enumerate(divs):
            nxt = {}
            for rank, sub in pieces.items():
                for j, piece in enumerate(
                        np.split(sub, dv, axis=dim) if dv > 1 else [sub]):
                    nxt[rank + (j,)] = piece
            pieces = nxt
        return pieces

    shards = split_all(arr, cur)
    for st in tr.steps:
        if st.kind == "slice":
            shards = _split_dim(shards, st.dim, st.dst_parts
                                // st.src_parts)
            cur[st.dim] = st.dst_parts
        elif st.kind == "all_gather":
            shards, moved = _gather_dim(shards, st.dim,
                                        st.src_parts // st.dst_parts)
            moved_total += moved
            cur[st.dim] = st.dst_parts
        elif st.kind == "all_to_all":
            # exchange at lcm granularity: gather the dim fully per
            # column, re-split to dst — the moved bytes are only the
            # non-overlapping micro-shards (planned accounting)
            shards, _ = _gather_dim(shards, st.dim, st.src_parts)
            shards = _split_dim(shards, st.dim, st.dst_parts)
            moved, micro = _a2a_moved_frac(st.src_parts, st.dst_parts)
            moved_total += tr.nbytes * moved // micro
            cur[st.dim] = st.dst_parts
        elif st.kind == "permute":
            moved_total += st.wire_bytes
        elif st.kind in ("identity",):
            pass
        else:
            raise InvalidArgumentError(
                f"execute_reshard: unknown step kind {st.kind!r} for "
                f"{tr.name!r}")
    # reassemble the dst global array from the final shard set
    def join_all(pieces, divs):
        for dim in reversed(range(len(divs))):
            nxt: Dict[Tuple[int, ...], List[np.ndarray]] = {}
            for rank in sorted(pieces):
                nxt.setdefault(rank[:dim], []).append(pieces[rank])
            pieces = {k: np.concatenate(v, axis=dim) if len(v) > 1
                      else v[0] for k, v in nxt.items()}
        return pieces[()]

    return join_all(shards, cur), moved_total


def execute_reshard(plan: ReshardPlan, arrays: Dict[str, np.ndarray],
                    strict: bool = True
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Execute the plan on host arrays (the checkpoint-restore path).

    Returns ``(dst arrays, stats)`` where stats carries the
    actually-moved wire bytes per var — equal to the plan's static
    accounting by construction, asserted when ``strict``."""
    out: Dict[str, np.ndarray] = {}
    stats = {"wire_bytes": 0, "vars_moved": 0,
             "by_var": {}}
    for name, arr in arrays.items():
        tr = plan.transfers.get(name)
        if tr is None or tr.identity:
            out[name] = arr
            continue
        dst, moved = _execute_var(tr, np.asarray(arr))
        if tuple(dst.shape) != tuple(tr.dst_shape):
            raise InvalidArgumentError(
                f"reshard of {name!r} produced shape {dst.shape}, "
                f"expected {tr.dst_shape} (src layout "
                f"{plan.src_layout.sizes if plan.src_layout else '?'} -> "
                f"dst layout "
                f"{plan.dst_layout.sizes if plan.dst_layout else '?'})")
        if strict and moved != tr.wire_bytes:
            raise InvalidArgumentError(
                f"reshard of {name!r}: executed wire bytes {moved} != "
                f"planned {tr.wire_bytes} — schedule accounting drift")
        out[name] = dst
        stats["wire_bytes"] += moved
        stats["vars_moved"] += 1
        stats["by_var"][name] = moved
    return out, stats


def arm_fault(*args, **kwargs):
    """Not ported: the JAX package's ``reshard_execute`` seam, where a
    drill strikes a restore between two per-var transfers, is armed
    through ``testing/faultline.py``."""
    raise UnimplementedError(
        "reshard fault drills: the reshard_execute seam needs "
        "testing/faultline.py, which is not ported yet")


__all__ = ["ReshardStep", "VarTransfer", "ReshardPlan", "plan_reshard",
           "plan_var_transfer", "execute_reshard", "flat_shard_meta",
           "flat_moved_bytes", "spec_dim_divisors", "STEP_LOWERING",
           "RESHARD_FORMAT_VERSION", "arm_fault"]
