"""Hang watchdog: turn silent wedges into diagnosable events — the port
of paddle_tpu/observability/watchdog.py.

Instrumented sites mark a unit of work with :func:`begin`/:func:`end`
(the prepared step per ``run()``, the serving and decode workers per
batch, the AsyncCheckpointer per write).  With the watchdog off a beacon
costs one flag-dict read; on, one ``time.monotonic()`` and a dict store.
The monitor thread, started by the first instrumented subsystem when
``flag("step_deadline_s")`` > 0, wakes every ``deadline / 4`` (at most
1 s) and, for a beacon in flight past the deadline, dumps every thread's
stack (``sys._current_frames``) and a flight bundle, bumps
``watchdog::trip{beacon=...}`` and, with ``flag("watchdog_abort")``,
exits with :data:`WATCHDOG_EXIT_CODE`.

On the card a stall inside a CUDA call or a gloo / NCCL collective
releases the GIL, so the thread still runs.  The abort is ``os._exit``
from the watchdog thread: it does not wait for NCCL to tear down, and
``distributed.launch`` reports the rank's exit code like any other.

A beacon trips at most once per stall; idle beacons never trip, so a
slow but healthy run is bounded by the per-unit deadline only.
"""

from __future__ import annotations

import os
import sys
import threading
import time
import traceback
from typing import Any, Dict, List, Optional

from ..flags import _REGISTRY as _FLAGS

#: distinctive exit code for watchdog-initiated aborts (cf. the
#: preemption handler's 42)
WATCHDOG_EXIT_CODE = 66

#: beacon -> monotonic start time of the unit of work currently in
#: flight (absent = idle).  Plain dict ops are GIL-atomic.
_ACTIVE: Dict[str, float] = {}
#: beacon -> start time of the stall already reported (trip-once latch)
_TRIPPED: Dict[str, float] = {}
_trips: List[Dict[str, Any]] = []
_thread: Optional[threading.Thread] = None
_lock = threading.Lock()


def begin(name: str):
    """Mark a unit of work in flight.  Hot-path cost when the watchdog
    is disabled: one flag-dict read."""
    if _FLAGS["step_deadline_s"]:
        _ACTIVE[name] = time.monotonic()


def end(name: str):
    if _ACTIVE:
        _ACTIVE.pop(name, None)
        _TRIPPED.pop(name, None)


def active() -> Dict[str, float]:
    return dict(_ACTIVE)


def trips() -> List[Dict[str, Any]]:
    """Every trip this process recorded (beacon, stalled_s, bundle)."""
    return list(_trips)


def reset():
    _ACTIVE.clear()
    _TRIPPED.clear()
    _trips.clear()


def all_thread_stacks() -> Dict[str, List[str]]:
    """Formatted stack per live thread — the hang diagnosis payload."""
    names = {t.ident: t.name for t in threading.enumerate()}
    out = {}
    for tid, frame in sys._current_frames().items():
        label = f"{names.get(tid, '?')} ({tid})"
        out[label] = traceback.format_stack(frame)
    return out


def ensure_started():
    """Start the monitor thread if ``flag("step_deadline_s")`` > 0 and
    it is not already running.  Called by the instrumented subsystems
    (prepared loop / serving engine / checkpointer) at setup."""
    global _thread
    if not _FLAGS["step_deadline_s"]:
        return False
    with _lock:
        if _thread is not None and _thread.is_alive():
            return True
        _thread = threading.Thread(target=_monitor_loop,
                                   name="paddle-tpu-watchdog",
                                   daemon=True)
        _thread.start()
    return True


def _monitor_loop():
    while True:
        deadline = float(_FLAGS["step_deadline_s"] or 0.0)
        if deadline <= 0:
            # flag cleared at runtime: park cheaply, re-check later
            time.sleep(0.2)
            continue
        now = time.monotonic()
        for name, t0 in list(_ACTIVE.items()):
            stalled = now - t0
            if stalled <= deadline or _TRIPPED.get(name) == t0:
                continue
            _TRIPPED[name] = t0
            _trip(name, t0, stalled, deadline)
        time.sleep(min(max(deadline / 4.0, 0.01), 1.0))


def _trip(name: str, t0: float, stalled: float, deadline: float):
    from . import flight, metrics
    stacks = all_thread_stacks()
    metrics.counter("watchdog::trip", beacon=name).add()
    bundle = flight.dump(
        "watchdog_stall",
        extra={"beacon": name, "stalled_s": round(stalled, 3),
               "deadline_s": deadline, "thread_stacks": stacks,
               "active_beacons": {k: round(time.monotonic() - v, 3)
                                  for k, v in _ACTIVE.items()}})
    rec = {"beacon": name, "stalled_s": stalled, "deadline_s": deadline,
           "bundle": bundle, "time": time.time()}
    _trips.append(rec)
    sys.stderr.write(
        f"paddle_tpu_torch.watchdog: beacon {name!r} stalled "
        f"{stalled:.1f}s > deadline {deadline}s — thread stacks dumped"
        f"{' to ' + bundle if bundle else ''}\n")
    if _FLAGS["watchdog_abort"]:
        sys.stderr.write(
            f"paddle_tpu_torch.watchdog: aborting (watchdog_abort) with exit "
            f"code {WATCHDOG_EXIT_CODE}\n")
        sys.stderr.flush()
        os._exit(WATCHDOG_EXIT_CODE)


__all__ = ["begin", "end", "active", "trips", "reset", "ensure_started",
           "all_thread_stacks", "WATCHDOG_EXIT_CODE"]
