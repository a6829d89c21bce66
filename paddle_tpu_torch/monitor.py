"""Runtime metric counters — the port of paddle_tpu/monitor.py (ref:
platform/monitor.h:43 StatValue registry, STAT_ADD/STAT_RESET macros).

Framework components bump named counters (executor runs, checkpoint
retries); the labeled gauge / histogram tier and the JSON / Prometheus
export live in ``observability.metrics``, which reads this registry."""

from __future__ import annotations

import threading
from typing import Dict


class StatValue:
    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def add(self, v: int = 1) -> int:
        with self._lock:
            self._value += v
            return self._value

    def set(self, v: int):
        with self._lock:
            self._value = v

    def get(self) -> int:
        # under the lock: an unlocked read could observe a torn/stale
        # value mid-`add` on free-threaded builds, and the snapshot
        # contract below depends on reads serializing with writes
        with self._lock:
            return self._value

    def reset(self):
        self.set(0)


_stats: Dict[str, StatValue] = {}
_reg_lock = threading.Lock()


def stat(name: str) -> StatValue:
    """Get-or-create a counter (ref: StatRegistry::get)."""
    with _reg_lock:
        if name not in _stats:
            _stats[name] = StatValue(name)
        return _stats[name]


def stats_snapshot() -> Dict[str, int]:
    """Consistent point-in-time copy of the whole registry — the read
    the telemetry recorder diffs per step and the flight recorder dumps.
    The registry is locked only for the key walk; each value read takes
    its own lock."""
    with _reg_lock:
        items = list(_stats.items())
    return {k: v.get() for k, v in items}


def get_all_stats() -> Dict[str, int]:
    return stats_snapshot()


def reset_all():
    """Zero every counter (tests + recorder run boundaries)."""
    with _reg_lock:
        values = list(_stats.values())
    for v in values:
        v.reset()
