"""Profiler — the port of paddle_tpu/profiler.py (ref:
platform/profiler.h:201-211 RecordEvent/Enable/Disable,
python/paddle/fluid/profiler.py context managers, tools/timeline.py).

Host side: ``RecordEvent`` is the tracing layer's ``Span``
(``observability/tracing.py``): every marker carries an attribute dict
and the run-level ``step_id``; ``stop_profiler`` prints the reference's
aggregated table (calls / total / min / max / avg per event name) and
writes a Chrome trace with each span's attributes under ``args`` and a
``thread_name`` row per thread.  :func:`merge_timelines` merges several
processes' traces into one, one Chrome ``pid`` each.

Device side: where the JAX package starts ``jax.profiler`` for the
``GPU`` / ``All`` states, the port starts ``torch.profiler`` with CUDA
activity (CUPTI) when a ``trace_dir`` is given, and ``stop_profiler``
writes its Chrome trace there (``device_trace.json``).  A span measures
host time only: with the kernels queued behind it, a launch's device time
lands in the span that waits for it (``prepared::fetch_sync``)."""

from __future__ import annotations

import contextlib
import json
import os
import weakref
from typing import List, Optional

from .observability import tracing
from .observability.tracing import Span as RecordEvent   # noqa: F401 — API

_device_profile = None
_device_trace_dir: Optional[str] = None
_tracer_option: str = "Default"

#: reference tracer options (fluid/profiler.py): Default = framework
#: markers only; OpDetail / AllOpDetail keep per-op spans too
TRACER_OPTIONS = ("Default", "OpDetail", "AllOpDetail")


def is_profiler_enabled() -> bool:
    return tracing.is_enabled()


def tracer_option() -> str:
    return _tracer_option


@contextlib.contextmanager
def record_event(name: str, **attrs):
    with RecordEvent(name, attrs or None):
        yield


def reset_profiler():
    """ref: fluid/profiler.py reset_profiler."""
    tracing.clear_events()


def _start_device_trace(trace_dir: str):
    """``torch.profiler`` over CPU and CUDA activity (the CUDA activity
    only where a card is present); its trace goes to ``trace_dir`` at
    stop."""
    global _device_profile, _device_trace_dir
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=acts)
    prof.__enter__()
    _device_profile, _device_trace_dir = prof, trace_dir


def start_profiler(state: str = "All", tracer_option: str = "Default",
                   trace_dir: Optional[str] = None):
    """ref: fluid/profiler.py start_profiler.  ``state`` in
    {CPU, GPU, All}; the device states also start a ``torch.profiler``
    trace when ``trace_dir`` is given."""
    global _tracer_option
    if state not in ("CPU", "GPU", "All"):
        raise ValueError("state must be 'CPU', 'GPU' or 'All'")
    if tracer_option not in TRACER_OPTIONS:
        raise ValueError(f"tracer_option must be one of {TRACER_OPTIONS}, "
                         f"got {tracer_option!r}")
    _tracer_option = tracer_option
    tracing.enable()
    if trace_dir and state in ("GPU", "All"):
        try:
            _start_device_trace(trace_dir)
        except Exception:
            _stop_device_trace_state()   # tracing unsupported here


def _stop_device_trace_state():
    global _device_profile, _device_trace_dir
    _device_profile, _device_trace_dir = None, None


def stop_profiler(sorted_key: str = "total",
                  profile_path: Optional[str] = None):
    """ref: fluid/profiler.py stop_profiler — prints the aggregated event
    table; writes a Chrome trace JSON to ``profile_path`` if given.  The
    device trace is stopped and written to its ``trace_dir``; a stop that
    raises still clears the profiler's state, so the next
    ``start_profiler`` starts clean."""
    tracing.disable()
    prof, out_dir = _device_profile, _device_trace_dir
    if prof is not None:
        try:
            prof.__exit__(None, None, None)
            os.makedirs(out_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(out_dir,
                                                  "device_trace.json"))
        except Exception:
            pass
        finally:
            _stop_device_trace_state()
    events = tracing.get_events()
    if profile_path:
        save_chrome_trace(profile_path, events)
    _print_summary(events, sorted_key)
    return events


def save_chrome_trace(path: str, events=None):
    """Chrome trace (tools/timeline.py's input format): one ``X`` event
    per span with its attributes (``step_id`` among them) under ``args``,
    and ``thread_name`` metadata per tid."""
    if events is None:
        events = tracing.get_events()
    trace_events = [
        {"name": "thread_name", "ph": "M", "pid": 0, "tid": tid,
         "args": {"name": tname}}
        for tid, tname in sorted(tracing.thread_names().items())]
    for ev in events:
        name, start, end, tid = ev[0], ev[1], ev[2], ev[3]
        attrs = ev[4] if len(ev) > 4 else None
        rec = {"name": name, "cat": "host", "ph": "X",
               "ts": start / 1e3,                 # chrome wants microseconds
               "dur": (end - start) / 1e3,
               "pid": 0, "tid": tid}
        if attrs:
            rec["args"] = attrs
        trace_events.append(rec)
    with open(path, "w") as f:
        json.dump({"traceEvents": trace_events}, f, default=str)


def merge_timelines(paths, out_path, perfetto=False):
    """Merge per-process Chrome traces into one (the JAX repository's
    tools/timeline.py ``merge``): one ``pid`` per input in command-line
    order, with ``process_name`` and ``process_sort_index`` rows; thread
    names and span ``args`` pass through.  A path may be
    ``"name:file.json"``.  With ``perfetto`` the JSON is gzipped (``.gz``
    appended).  Returns (event count, output path)."""
    import gzip
    merged = {"traceEvents": []}
    for pid, path in enumerate(paths):
        name = path
        if ":" in path:
            name, path = path.split(":", 1)
        with open(path) as f:
            trace = json.load(f)
        merged["traceEvents"].append(
            {"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": name}})
        merged["traceEvents"].append(
            {"name": "process_sort_index", "ph": "M", "pid": pid,
             "args": {"sort_index": pid}})
        for ev in trace.get("traceEvents", []):
            ev = dict(ev)
            ev["pid"] = pid
            merged["traceEvents"].append(ev)
    if perfetto:
        if not out_path.endswith(".gz"):
            out_path += ".gz"
        with gzip.open(out_path, "wt") as f:
            json.dump(merged, f)
    else:
        with open(out_path, "w") as f:
            json.dump(merged, f)
    return len(merged["traceEvents"]), out_path


def _print_summary(events, sorted_key):
    agg = {}
    for ev in events:
        name, start, end = ev[0], ev[1], ev[2]
        ms = (end - start) / 1e6
        c = agg.setdefault(name, [0, 0.0, float("inf"), 0.0])
        c[0] += 1
        c[1] += ms
        c[2] = min(c[2], ms)
        c[3] = max(c[3], ms)
    keyfn = {"total": lambda kv: -kv[1][1], "calls": lambda kv: -kv[1][0],
             "max": lambda kv: -kv[1][3], "min": lambda kv: kv[1][2],
             "ave": lambda kv: -(kv[1][1] / kv[1][0])}.get(
                 sorted_key, lambda kv: -kv[1][1])
    rows = sorted(agg.items(), key=keyfn)
    if not rows:
        return
    print(f"{'Event':<40}{'Calls':>8}{'Total(ms)':>12}{'Min(ms)':>10}"
          f"{'Max(ms)':>10}{'Ave(ms)':>10}")
    for name, (calls, total, mn, mx) in rows:
        print(f"{name:<40}{calls:>8}{total:>12.3f}{mn:>10.3f}"
              f"{mx:>10.3f}{total / calls:>10.3f}")


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: Optional[str] = None,
             trace_dir: Optional[str] = None,
             tracer_option: str = "Default"):
    """ref: fluid/profiler.py profiler context manager."""
    start_profiler(state, tracer_option=tracer_option,
                   trace_dir=trace_dir)
    try:
        yield
    finally:
        stop_profiler(sorted_key, profile_path)


def get_events():
    return tracing.get_events()


# ---------------------------------------------------------------------------
# per-step breakdown
# ---------------------------------------------------------------------------

#: the host phases of one prepared step: the input wait, the op-by-op
#: dispatch, the wait for device results (a FetchHandle's first read),
#: and the hand-over of the state to the scope
PREPARED_PHASES = ("prepared::feed_wait", "prepared::dispatch",
                   "prepared::fetch_sync", "prepared::scope_sync")

#: the host phases of one serving micro-batch (``serving::pack`` is the
#: JAX package's ragged packing, not ported: it never appears here)
SERVING_PHASES = ("serving::wait", "serving::pad", "serving::pack",
                  "serving::run", "serving::split")

#: the paged-decode engine's phases (serving/decode.py)
DECODE_PHASES = ("decode::prefill", "decode::chunk", "decode::chain")

#: the checkpoint writer's phases (io.py)
CHECKPOINT_PHASES = ("checkpoint::snapshot", "checkpoint::write",
                     "checkpoint::reshard")


def step_breakdown(events=None):
    """The prepared step's, the serving and decode engines' and the
    checkpoint writer's spans aggregated into ``{phase: {"calls",
    "total_ms", "avg_us"}}``: where the host time of a step or a served
    batch went.  (The JAX package adds its feed-cache and AOT-cache
    counters; the port has neither cache.)"""
    if events is None:
        events = tracing.get_events()
    phases = PREPARED_PHASES + SERVING_PHASES + DECODE_PHASES + \
        CHECKPOINT_PHASES
    out = {}
    for ev in events:
        name, start, end = ev[0], ev[1], ev[2]
        if name in phases:
            rec = out.setdefault(name, {"calls": 0, "total_ms": 0.0})
            rec["calls"] += 1
            rec["total_ms"] += (end - start) / 1e6
    for rec in out.values():
        rec["avg_us"] = rec["total_ms"] * 1e3 / rec["calls"]
    return out


# ---------------------------------------------------------------------------
# serving-engine stats (ServingEngine registers itself here)
# ---------------------------------------------------------------------------

_serving_engines: List = []   # weakrefs to live ServingEngines


def register_serving_engine(engine):
    """Expose a ServingEngine's stats through :func:`serving_stats` —
    called by the engine constructor."""
    _serving_engines.append(weakref.ref(engine))


def serving_stats():
    """Snapshot of every live serving engine's ``stats()`` (QPS, p50 /
    p99 latency, padding waste, batch histogram)."""
    out = []
    dead = []
    for ref in _serving_engines:
        engine = ref()
        if engine is None:
            dead.append(ref)
            continue
        out.append(engine.stats())
    for ref in dead:
        _serving_engines.remove(ref)
    return out


__all__ = ["RecordEvent", "record_event", "start_profiler",
           "stop_profiler", "reset_profiler", "profiler", "get_events",
           "save_chrome_trace", "merge_timelines", "step_breakdown",
           "serving_stats", "register_serving_engine", "is_profiler_enabled",
           "tracer_option", "TRACER_OPTIONS", "PREPARED_PHASES",
           "SERVING_PHASES", "DECODE_PHASES", "CHECKPOINT_PHASES"]
