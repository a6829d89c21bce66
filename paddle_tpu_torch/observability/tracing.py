"""Structured run-level tracing: spans with attributes on a shared step
axis — the port of paddle_tpu/observability/tracing.py.

* **spans** — RAII markers carrying an attribute dict (program uid,
  bucket shape, collective kind / bytes) that lands in the Chrome trace's
  ``args`` column;
* **step ids** — one process-wide monotonically increasing counter,
  bumped once per training step (``PreparedStep.run`` /
  ``Executor.run``) and once per serving micro-batch.  Every span closed
  while a step is current records that ``step_id``;
* **thread pinning** — ``step_scope(sid)`` pins the id for one thread:
  the serving worker tags a batch's pad / run / split spans with the
  batch's id, the checkpoint writer thread keeps the id of the step that
  snapshotted;
* **flight ring** — the last ``RING_SIZE`` closed spans, which the crash
  flight recorder (``observability/flight.py``) copies into its bundle.

Spans close on the host: on the card a span around a launch measures its
dispatch, and the device time shows up in whatever span waits for it
(``prepared::fetch_sync``).  Disabled, ``Span.__enter__``/``__exit__``
reduce to one module-global bool test and ``next_step_id`` to one
list-slot increment.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time
from typing import Any, Dict, List, Optional

# (name, start_ns, end_ns, tid, attrs-or-None) — the profiler's event
# buffer lives HERE now; profiler.py re-exports its legacy API over it
_events: List[tuple] = []
_lock = threading.Lock()
_enabled = False

#: last-N closed spans for the flight recorder (deque.append is
#: GIL-atomic — no lock on the hot path)
RING_SIZE = 512
_ring: collections.deque = collections.deque(maxlen=RING_SIZE)

#: tid → thread name, captured at span close so chrome traces can emit
#: thread_name metadata (tools/timeline.py preserves it across merges)
_thread_names: Dict[int, str] = {}

_STEP = [0]                    # process-wide monotonically increasing
_tls = threading.local()       # per-thread pinned step id


def is_enabled() -> bool:
    return _enabled


def enable():
    global _enabled
    _enabled = True


def disable():
    global _enabled
    _enabled = False


def next_step_id() -> int:
    """Advance the run-level step counter (one bump per training step /
    serving micro-batch).  Plain list-slot increment: the id must be
    monotone and cheap, not a synchronization primitive."""
    _STEP[0] += 1
    return _STEP[0]


def current_step_id() -> int:
    sid = getattr(_tls, "step_id", None)
    return _STEP[0] if sid is None else sid


def set_step_id(value: int):
    """Re-seed the counter (resume from a checkpointed step so trace step
    ids line up with the training schedule's)."""
    _STEP[0] = int(value)


@contextlib.contextmanager
def step_scope(step_id: int):
    """Pin ``step_id`` for spans closed on THIS thread — the serving
    worker wraps each micro-batch, the checkpoint writer thread wraps its
    write, so their spans correlate to the step that owns them."""
    old = getattr(_tls, "step_id", None)
    _tls.step_id = step_id
    try:
        yield
    finally:
        _tls.step_id = old


class Span:
    """RAII span.  ``attrs`` (or keyword attributes) land in the trace's
    ``args``; ``step_id`` is attached automatically at close.  Cheap
    no-op while tracing is disabled — one bool test per enter/exit."""

    __slots__ = ("name", "attrs", "_start")

    def __init__(self, name: str, attrs: Optional[Dict[str, Any]] = None,
                 **kw):
        self.name = name
        if kw:
            attrs = dict(attrs) if attrs else {}
            attrs.update(kw)
        self.attrs = attrs
        self._start = None

    def set(self, **kw):
        """Attach attributes discovered mid-span (e.g. cache hit/miss)."""
        if self.attrs is None:
            self.attrs = {}
        self.attrs.update(kw)
        return self

    def __enter__(self):
        if _enabled:
            self._start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self._start is not None:
            end = time.perf_counter_ns()
            tid = threading.get_ident()
            attrs = dict(self.attrs) if self.attrs else {}
            attrs.setdefault("step_id", current_step_id())
            rec = (self.name, self._start, end, tid, attrs)
            if tid not in _thread_names:
                _thread_names[tid] = threading.current_thread().name
            with _lock:
                _events.append(rec)
            _ring.append(rec)
        return False


def span(name: str, **attrs) -> Span:
    return Span(name, attrs or None)


@contextlib.contextmanager
def traced(name: str, **attrs):
    with Span(name, attrs or None):
        yield


def get_events() -> List[tuple]:
    with _lock:
        return list(_events)


def clear_events():
    with _lock:
        _events.clear()


def ring_snapshot() -> List[tuple]:
    """Copy of the last-N span ring (newest last) — the flight
    recorder's span section."""
    return list(_ring)


def thread_names() -> Dict[int, str]:
    return dict(_thread_names)


__all__ = ["Span", "span", "traced", "is_enabled", "enable", "disable",
           "next_step_id", "current_step_id", "set_step_id", "step_scope",
           "get_events", "clear_events", "ring_snapshot", "thread_names",
           "RING_SIZE"]
