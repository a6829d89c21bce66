"""Run-level telemetry recorder: an append-only JSONL stream per run — the
port of paddle_tpu/observability/recorder.py.

One :class:`TelemetryRecorder` owns one file and writes four record kinds
(the ``"record"`` field), in the JAX package's schema (``SCHEMA``), so
either package's :func:`validate_jsonl` reads either's stream:

* ``header`` (first line) — run id, the device and its peak FLOP/s for
  the program's GEMM dtype (``flops.matmul_dtype``: float32, tf32,
  bfloat16 or float16, written as ``peak_dtype``), and the program's
  static context priced once: GEMM FLOPs a step (``flops.
  estimate_step_flops``, the fusion passes' ops shaped too: the JAX
  package's recorder leaves a fused encoder unpriced), the per-rank peak
  and state bytes
  (``memory_analysis.analyze_memory``), collective wire bytes a step and
  the exposed-communication model (``collective_wire_summary``,
  ``exposed_comm_model``);
* ``step`` — wall time, tokens / examples, **measured MFU** (static FLOPs
  / wall / peak), **goodput** (1 - the share of the wall spent waiting
  for inputs, in a first bind and in a checkpoint snapshot), loss and its
  finiteness, grad norm, wire bytes, the guarded step's skip counters and
  loss scale, a pipelined program's ``bubble_frac`` (``pipeline_lowering.
  last_pipeline_report``), and the card's HBM headroom (device memory
  less the static peak estimate; None on the CPU, as the JAX package's);
* ``event`` — a non-finite loss, with the flight bundle it dumped;
* ``summary`` (last line, on ``close()``).

On the card the kernels of a step run after ``PreparedStep.run`` returns,
so a step's wall must end at a device sync or MFU reads high: the step
timer reads the loss it was given (a wait for the step) and otherwise
synchronizes the device before it stops the clock.
"""

from __future__ import annotations

import json
import math
import os
import time
import uuid
from typing import Any, Dict, Iterable, Optional

import numpy as np

from . import flight, flops, tracing

SCHEMA = "paddle_tpu.telemetry/1"

#: monitor counters diffed per step (ns counters are bumped by the
#: executor's first bind of a program and the AsyncCheckpointer's
#: snapshot)
_STALL_COUNTERS = ("executor_compile_ns", "checkpoint_snapshot_ns")
_DELTA_COUNTERS = ("executor_compile_count",)


def _fnum(v):
    """``v`` (a number, array, tensor or FetchHandle) as a float; None
    when it is None or not a scalar.  Reading a device value waits for
    it."""
    if v is None:
        return None
    try:
        import torch
        if isinstance(v, torch.Tensor):
            return float(v.detach().reshape(()).float().cpu())
        return float(np.asarray(v).reshape(()))
    except Exception:
        return None


def _sync_device():
    import torch
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


class TelemetryRecorder:
    """Append-only per-run JSONL telemetry stream (see module docstring).

    ``program`` / ``feed_shapes`` / ``fetch_names`` price the static
    context; pass ``flops_per_step`` / ``peak_flops`` to override.
    ``tokens_per_step`` / ``examples_per_step`` are defaults for steps
    that don't pass their own.  ``attach(prepared)`` diffs the prepared
    step's input and fetch waits into the goodput accounting and reads
    its guard counters."""

    def __init__(self, path: str, program=None, feed_shapes=None,
                 fetch_names: Iterable[str] = (),
                 run_id: Optional[str] = None,
                 tokens_per_step: Optional[float] = None,
                 examples_per_step: Optional[float] = None,
                 mesh_axes: Optional[Dict[str, int]] = None,
                 flops_per_step: Optional[float] = None,
                 peak_flops: Optional[float] = None):
        self.path = str(path)
        self.run_id = run_id or uuid.uuid4().hex[:12]
        self._tokens_default = tokens_per_step
        self._examples_default = examples_per_step
        self._prepared = None
        self._prev_prepared: Dict[str, int] = {}
        self._prev_counters: Dict[str, int] = {}
        self._steps = 0
        self._wall_ns_total = 0
        self._mfu_sum = 0.0
        self._goodput_sum = 0.0
        self._nonfinite_steps = 0
        self._closed = False

        dtype = flops.matmul_dtype(program) if program is not None \
            else "float32"
        dev = flops.device_info(dtype=dtype)
        self.peak_flops = float(peak_flops or dev["peak_flops"])
        static: Dict[str, Any] = {}
        if flops_per_step is not None:
            static["flops_per_step"] = float(flops_per_step)
            static["flops_source"] = "caller"
        elif program is not None:
            try:
                est = flops.estimate_step_flops(
                    program, feed_shapes=feed_shapes,
                    fetch_names=list(fetch_names), infer_fused=True)
                static["flops_per_step"] = est["total_flops"]
                static["flops_fwd"] = est["fwd_flops"]
                static["flops_source"] = "op_spec"
                static["flops_unpriced_ops"] = est["unpriced"]
            except Exception as e:   # pricing gap ≠ telemetry outage
                static["flops_per_step"] = None
                static["flops_error"] = str(e)
        else:
            static["flops_per_step"] = None
        if program is not None:
            self._price_program(static, program, feed_shapes,
                                list(fetch_names), mesh_axes)
        self.static = static
        self.flops_per_step = static.get("flops_per_step")
        self._program = program
        self._pipelined = bool(program is not None and any(
            op.type == "backward" and int(op.attrs.get("pipe_stages")
                                          or 1) > 1
            for op in program.global_block().ops))

        header = {
            "record": "header", "schema": SCHEMA, "run_id": self.run_id,
            "time": time.time(), "device": dev,
            "peak_flops": self.peak_flops, "peak_dtype": dtype,
            "static": static,
        }
        if program is not None:
            header["program"] = {"uid": getattr(program, "_uid", None),
                                 "version": getattr(program, "_version",
                                                    None)}
        if tokens_per_step is not None:
            header["tokens_per_step"] = tokens_per_step
        d = os.path.dirname(self.path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._f = open(self.path, "a")
        self._write(header)
        self._snap_counters()

    def _price_program(self, static, program, feed_shapes, fetch_names,
                       mesh_axes):
        """The static memory and wire pricing of ``program`` into
        ``static`` (each failure recorded, never raised)."""
        from ..framework.memory_analysis import (analyze_memory,
                                                 collective_wire_summary,
                                                 exposed_comm_model)
        try:
            mem = analyze_memory(program, feed_shapes=feed_shapes,
                                 fetch_names=fetch_names,
                                 mesh_axes=mesh_axes)
            static["peak_hbm_bytes"] = int(mem.peak_bytes)
            static["state_bytes"] = int(mem.state_bytes)
        except Exception as e:
            static["peak_hbm_bytes"] = None
            static["mem_error"] = str(e)
        try:
            wire = collective_wire_summary(
                program, feed_shapes=feed_shapes, fetch_names=fetch_names,
                mesh_axes=mesh_axes)
            static["wire_bytes_per_step"] = int(wire["wire_bytes"])
            static["logical_bytes_per_step"] = int(wire["logical_bytes"])
            static["grad_sync_wire_bytes"] = int(
                wire.get("grad_sync_wire_bytes", 0))
            static["forward_wire_bytes"] = int(
                wire.get("forward_wire_bytes", 0))
            blk = program.global_block()
            overlap = any(op.attrs.get("_overlap") for op in blk.ops)
            has_bw = any(op.type == "backward" for op in blk.ops)
            ndev = 1
            for sz in (mesh_axes or {}).values():
                ndev *= max(int(sz), 1)
            model = exposed_comm_model(
                wire, static.get("flops_per_step") or 0.0,
                num_devices=ndev, overlap=overlap, has_backward=has_bw,
                peak_flops=self.peak_flops)
            static["overlap_grad_sync"] = bool(overlap)
            static["exposed_comm_s_per_step"] = model["exposed_comm_s"]
            static["exposed_comm_model"] = {
                k: model[k] for k in ("wire_time_s",
                                      "overlappable_compute_s", "hidden_s")
                if k in model}
        except Exception as e:
            static["wire_bytes_per_step"] = None
            static["wire_error"] = str(e)

    # -- wiring -----------------------------------------------------------
    def attach(self, prepared):
        """Diff ``prepared.stats`` (input and fetch waits) into each step
        record's stall accounting, and read its guard counters."""
        self._prepared = prepared
        self._prev_prepared = dict(prepared.stats)
        return self

    def _write(self, rec: Dict[str, Any]):
        self._f.write(json.dumps(rec, default=str) + "\n")
        self._f.flush()

    def _snap_counters(self):
        from ..monitor import stat
        self._prev_counters = {
            n: stat(n).get() for n in _STALL_COUNTERS + _DELTA_COUNTERS}

    # -- per-step ---------------------------------------------------------
    def step(self, tokens=None, examples=None):
        """Context manager timing one training step::

            with rec.step(tokens=batch * seq) as st:
                loss, = prepared.run(feed)
                st.loss = loss          # recorded, checked, waited for
        """
        return _StepTimer(self, tokens, examples)

    def record_step(self, wall_ns: float, step_id: Optional[int] = None,
                    tokens=None, examples=None, loss=None, grad_norm=None,
                    extra: Optional[Dict[str, Any]] = None
                    ) -> Dict[str, Any]:
        """Record one step observed to take ``wall_ns``.  Returns the
        record written (with derived MFU / goodput)."""
        from ..monitor import stat
        wall_ns = max(float(wall_ns), 1.0)
        sid = tracing.current_step_id() if step_id is None else step_id
        now_counters = {
            n: stat(n).get() for n in _STALL_COUNTERS + _DELTA_COUNTERS}
        deltas = {n: now_counters[n] - self._prev_counters.get(n, 0)
                  for n in now_counters}
        self._prev_counters = now_counters
        stalls_ns = {
            "compile": deltas["executor_compile_ns"],
            "checkpoint": deltas["checkpoint_snapshot_ns"],
            "feed_wait": 0,
        }
        if self._prepared is not None:
            cur = dict(self._prepared.stats)
            stalls_ns["feed_wait"] = cur.get("feed_wait_ns", 0) - \
                self._prev_prepared.get("feed_wait_ns", 0)
            stalls_ns["fetch_wait"] = cur.get("fetch_wait_ns", 0) - \
                self._prev_prepared.get("fetch_wait_ns", 0)
            self._prev_prepared = cur
        stall_total = sum(max(v, 0) for k, v in stalls_ns.items()
                          if k != "fetch_wait")
        goodput = max(0.0, min(1.0, 1.0 - stall_total / wall_ns))

        tokens = tokens if tokens is not None else self._tokens_default
        examples = examples if examples is not None \
            else self._examples_default
        loss_f = _fnum(loss)
        loss_finite = None if loss_f is None else bool(math.isfinite(loss_f))
        mfu = None
        if self.flops_per_step:
            mfu = self.flops_per_step / (wall_ns / 1e9) / self.peak_flops
        rec = {
            "record": "step", "step": sid,
            "wall_ms": round(wall_ns / 1e6, 4),
            "tokens": tokens, "examples": examples,
            "mfu": mfu, "goodput": round(goodput, 6),
            "stalls_ms": {k: round(v / 1e6, 4)
                          for k, v in stalls_ns.items()},
            "loss": loss_f, "loss_finite": loss_finite,
            "grad_norm": _fnum(grad_norm),
            "wire_bytes": self.static.get("wire_bytes_per_step"),
            "compiles": deltas["executor_compile_count"],
        }
        # the guarded step's facts (framework/guardrails.py): whether the
        # step was skipped, the skip total and the live loss scale
        ginfo = getattr(self._prepared, "guard_info", None)
        if ginfo is not None:
            gs = ginfo(sync=False)
            if gs.get("step") is not None:
                rec["skipped"] = bool(gs["last_skipped"])
                rec["skipped_total"] = int(gs["skipped_total"])
                if gs.get("loss_scale") is not None:
                    rec["loss_scale"] = float(gs["loss_scale"])
        if self._pipelined:
            from ..framework.pipeline_lowering import last_pipeline_report
            prep = last_pipeline_report()
            if prep.get("bubble_frac") is not None:
                rec["bubble_frac"] = round(float(prep["bubble_frac"]), 6)
                rec["pipe_schedule"] = prep.get("family")
        exposed_s = self.static.get("exposed_comm_s_per_step")
        if exposed_s is not None:
            rec["exposed_comm_ms"] = round(exposed_s * 1e3, 4)
            rec["exposed_comm_frac"] = round(
                max(0.0, min(1.0, exposed_s * 1e9 / wall_ns)), 6)
        headroom = self._hbm_headroom()
        if headroom is not None:
            rec["hbm_headroom_bytes"] = headroom
        if extra:
            rec.update(extra)
        self._write(rec)
        self._steps += 1
        self._wall_ns_total += wall_ns
        if mfu is not None:
            self._mfu_sum += mfu
        self._goodput_sum += goodput
        from . import metrics
        metrics.histogram("telemetry_step_wall_seconds",
                          run=self.run_id).observe(wall_ns / 1e9)
        if mfu is not None:
            metrics.gauge("telemetry_mfu", run=self.run_id).set(mfu)
        metrics.gauge("telemetry_goodput", run=self.run_id).set(goodput)
        if loss_finite is False:
            self._nonfinite_steps += 1
            bundle = flight.dump(
                "non_finite_loss", program=self._program,
                extra={"loss": loss_f, "telemetry_path": self.path,
                       "step": sid})
            rec["flight_bundle"] = bundle
            self._write({"record": "event", "kind": "non_finite_loss",
                         "step": sid, "flight_bundle": bundle})
        return rec

    def _hbm_headroom(self) -> Optional[int]:
        """The card's memory less the static peak estimate
        (``torch.cuda.mem_get_info``, where the JAX package reads the
        device's ``bytes_limit``); None on the CPU or without an
        estimate."""
        peak = self.static.get("peak_hbm_bytes")
        if not peak:
            return None
        import torch
        if not (torch.cuda.is_available() and torch.cuda.is_initialized()):
            return None
        _, total = torch.cuda.mem_get_info()
        return int(total) - int(peak)

    # -- lifecycle --------------------------------------------------------
    def close(self) -> Dict[str, Any]:
        if self._closed:
            return {}
        self._closed = True
        steps = self._steps
        summary = {
            "record": "summary", "steps": steps,
            "wall_ms_total": round(self._wall_ns_total / 1e6, 3),
            "wall_ms_mean": round(self._wall_ns_total / 1e6 / steps, 4)
            if steps else None,
            "mfu_mean": (self._mfu_sum / steps)
            if steps and self.flops_per_step else None,
            "goodput_mean": (self._goodput_sum / steps) if steps else None,
            "nonfinite_steps": self._nonfinite_steps,
        }
        self._write(summary)
        self._f.close()
        return summary

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
        return False


class _StepTimer:
    """One step's clock: it stops after the step's loss has been read
    (or, without one, after a device sync), so the wall covers the
    kernels the step queued."""

    __slots__ = ("_rec", "_tokens", "_examples", "_t0", "loss",
                 "grad_norm", "record")

    def __init__(self, rec, tokens, examples):
        self._rec = rec
        self._tokens = tokens
        self._examples = examples
        self.loss = None
        self.grad_norm = None
        self.record = None

    def __enter__(self):
        self._t0 = time.perf_counter_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc is None:
            loss = _fnum(self.loss)
            if loss is None:
                _sync_device()
            wall = time.perf_counter_ns() - self._t0
            self.record = self._rec.record_step(
                wall, tokens=self._tokens, examples=self._examples,
                loss=loss, grad_norm=self.grad_norm)
        return False


def validate_jsonl(path: str) -> Dict[str, Any]:
    """Schema-check one telemetry stream; raises ValueError on the first
    violation and returns aggregate facts otherwise (the JAX package's
    checks, which the port's stream passes too)."""
    with open(path) as f:
        lines = [json.loads(line) for line in f if line.strip()]
    if not lines:
        raise ValueError("empty telemetry stream")
    header = lines[0]
    if header.get("record") != "header" or header.get("schema") != SCHEMA:
        raise ValueError(f"first record must be a {SCHEMA} header, got "
                         f"{header.get('record')!r}/"
                         f"{header.get('schema')!r}")
    if not isinstance(header.get("peak_flops"), (int, float)) or \
            header["peak_flops"] <= 0:
        raise ValueError("header.peak_flops must be > 0")
    steps = [line for line in lines if line.get("record") == "step"]
    mfus = []
    for s in steps:
        for field in ("step", "wall_ms", "goodput", "stalls_ms"):
            if field not in s:
                raise ValueError(f"step record missing {field!r}: {s}")
        if s["wall_ms"] <= 0:
            raise ValueError(f"non-positive wall_ms: {s}")
        if not (0.0 <= s["goodput"] <= 1.0):
            raise ValueError(f"goodput out of [0,1]: {s}")
        if s.get("mfu") is not None:
            if not (0.0 < s["mfu"] <= 1.0):
                raise ValueError(f"mfu out of (0,1]: {s}")
            mfus.append(s["mfu"])
        if s.get("exposed_comm_frac") is not None and \
                not (0.0 <= s["exposed_comm_frac"] <= 1.0):
            raise ValueError(f"exposed_comm_frac out of [0,1]: {s}")
        if s.get("bubble_frac") is not None and \
                not (0.0 <= s["bubble_frac"] <= 1.0):
            raise ValueError(f"bubble_frac out of [0,1]: {s}")
        if "skipped" in s and not isinstance(s["skipped"], bool):
            raise ValueError(f"skipped must be a bool: {s}")
        if s.get("loss_scale") is not None and \
                not (isinstance(s["loss_scale"], (int, float))
                     and s["loss_scale"] >= 1.0):
            raise ValueError(f"loss_scale must be >= 1.0: {s}")
    sids = [s["step"] for s in steps]
    if sids != sorted(sids):
        raise ValueError("step ids are not monotonically increasing")
    summaries = [line for line in lines if line.get("record") == "summary"]
    return {"header": header, "steps": len(steps),
            "mfu_mean": (sum(mfus) / len(mfus)) if mfus else None,
            "nonfinite_steps": sum(
                1 for s in steps if s.get("loss_finite") is False),
            "summary": summaries[-1] if summaries else None}


__all__ = ["TelemetryRecorder", "validate_jsonl", "SCHEMA"]
