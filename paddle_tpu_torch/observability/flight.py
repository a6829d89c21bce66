"""The crash flight recorder — the port of
paddle_tpu/observability/flight.py.

It keeps a lock-light ring of recent activity and, on failure, dumps a
self-contained diagnostic bundle:

* **step breadcrumbs** — one tuple per training step / serving batch
  (step id, kind, program uid), appended from the prepared hot loop: one
  flag lookup and one GIL-atomic deque append;
* **span ring** — the last ``tracing.RING_SIZE`` closed spans (only
  filled while tracing is on);
* **bundle** — a JSON file with the rings, the metric registry, the live
  flag values, the program's identity and the exception's traceback.
  Triggers: an uncaught exception crossing ``PreparedStep.run`` /
  ``Executor.run`` / a serving worker, a failed checkpoint restore, a
  watchdog trip and a non-finite loss (``check_nan_inf`` or
  ``TelemetryRecorder.record_step``).

The bundle schema is the JAX package's (``aot_cache`` stays, empty: the
port keeps no executable cache), so one reader takes either package's.
Gated by ``flag("flight_recorder")`` (default on); bundles land in
``flag("flight_dump_dir")``.  Dumps are capped per process so a crash
loop cannot fill a disk.
"""

from __future__ import annotations

import collections
import json
import os
import time
import traceback
from typing import Any, Dict, List, Optional

from ..flags import _REGISTRY as _FLAGS
from . import tracing
from .tracing import _STEP

SCHEMA = "paddle_tpu.flight/1"
MAX_DUMPS = 20

#: (step_id, kind, info[, unix_time]) — appended once per step from the
#: prepared/executor hot paths (hot-path rows skip the timestamp);
#: deque.append is GIL-atomic (lock-light)
_steps: collections.deque = collections.deque(maxlen=512)
_dumps: List[str] = []


def enabled() -> bool:
    return bool(_FLAGS["flight_recorder"])


def note_step(step_id: int, kind: str, info=None):
    """Hot-path breadcrumb — one flag test + one deque append."""
    if _FLAGS["flight_recorder"]:
        _steps.append((step_id, kind, info, time.time()))


def step_breadcrumb(kind: str, info=None) -> int:
    """The prepared hot loop's ENTIRE per-step telemetry entry point:
    bump the run-level step id and drop the breadcrumb in one call.
    CPython function-call overhead dominates at this scale (~100 ns per
    call), so the two hooks are fused and the breadcrumb carries no
    wall timestamp (the TelemetryRecorder's JSONL owns per-step timing;
    the ring's job is step IDENTITY): the whole per-step cost with the
    telemetry off is one call."""
    _STEP[0] = sid = _STEP[0] + 1
    if _FLAGS["flight_recorder"]:
        _steps.append((sid, kind, info))
    return sid


def note_event(kind: str, **info):
    """Cold-path breadcrumb (compiles, cache evictions, checkpoints)."""
    if _FLAGS["flight_recorder"]:
        _steps.append((tracing.current_step_id(), kind, info or None,
                       time.time()))


def steps_snapshot() -> List[tuple]:
    return list(_steps)


def reset():
    _steps.clear()


def last_dumps() -> List[str]:
    return list(_dumps)


def dump_dir() -> str:
    """The directory bundles (and their replayable sidecars) land in —
    ``flag("flight_dump_dir")``, defaulting to a tmpdir subfolder."""
    out_dir = str(_FLAGS.get("flight_dump_dir") or "")
    if not out_dir:
        import tempfile
        out_dir = os.path.join(tempfile.gettempdir(), "paddle_tpu_torch_flight")
    return out_dir


def _jsonable(v):
    if isinstance(v, (type(None), bool, int, float, str)):
        return v
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, dict):
        return {str(k): _jsonable(x) for k, x in v.items()}
    return str(v)


def dump(reason: str, exc: Optional[BaseException] = None,
         program=None, extra: Optional[Dict[str, Any]] = None
         ) -> Optional[str]:
    """Write the diagnostic bundle; returns its path (None when the
    recorder is off or the per-process dump cap is hit)."""
    if not enabled() or len(_dumps) >= MAX_DUMPS:
        return None
    from ..monitor import stats_snapshot
    bundle: Dict[str, Any] = {
        "schema": SCHEMA,
        "reason": reason,
        "time": time.time(),
        "step_id": tracing.current_step_id(),
        "steps": [list(s[:3]) + [s[3] if len(s) > 3 else None]
                  for s in _steps],
        "spans": [{"name": n, "start_ns": s, "end_ns": e, "tid": t,
                   "attrs": a} for n, s, e, t, a in
                  tracing.ring_snapshot()],
        "stats": stats_snapshot(),
        "aot_cache": {},
        "flags": {k: _jsonable(v) for k, v in _FLAGS.items()},
        "tracing_enabled": tracing.is_enabled(),
    }
    if exc is not None:
        bundle["exception"] = {
            "type": type(exc).__name__,
            "message": str(exc),
            "traceback": traceback.format_exception(
                type(exc), exc, exc.__traceback__),
        }
    if program is not None:
        prog = {"uid": getattr(program, "_uid", None),
                "version": getattr(program, "_version", None)}
        bundle["program"] = prog
    if extra:
        bundle["extra"] = {k: _jsonable(v) for k, v in extra.items()}
    out_dir = dump_dir()
    try:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(
            out_dir, f"flight_bundle_{os.getpid()}_{len(_dumps)}.json")
        with open(path, "w") as f:
            json.dump(bundle, f, default=str)
    except OSError:
        return None            # a dump failure must never mask the crash
    _dumps.append(path)
    import sys
    sys.stderr.write(f"paddle_tpu_torch.flight: [{reason}] diagnostic bundle "
                     f"written to {path}\n")
    return path


def validate_bundle(path: str) -> Dict[str, Any]:
    """Schema-check one bundle file; raises ValueError on violations and
    returns the parsed bundle otherwise."""
    with open(path) as f:
        bundle = json.load(f)
    if bundle.get("schema") != SCHEMA:
        raise ValueError(f"bundle schema {bundle.get('schema')!r} != "
                         f"{SCHEMA!r}")
    for field in ("reason", "time", "step_id", "steps", "spans", "stats",
                  "aot_cache", "flags"):
        if field not in bundle:
            raise ValueError(f"bundle missing field {field!r}")
    if not isinstance(bundle["steps"], list) or \
            not isinstance(bundle["spans"], list):
        raise ValueError("bundle steps/spans must be lists")
    for sp in bundle["spans"]:
        if not {"name", "start_ns", "end_ns", "tid"} <= set(sp):
            raise ValueError(f"malformed span record: {sp}")
    return bundle


__all__ = ["enabled", "note_step", "step_breadcrumb", "note_event",
           "dump", "dump_dir", "validate_bundle",
           "steps_snapshot", "reset", "last_dumps", "SCHEMA", "MAX_DUMPS"]
