"""Deterministic fault injection: a static registry of named seams — the
port of paddle_tpu/testing/faultline.py.

Production code crosses a **seam** with a one-line hook at the point a
real fault would strike (``faultline.crossing("checkpoint_write",
stage=..., path=...)``).  Unarmed, a crossing is one dict truthiness test
and returns None.  A drill **arms** a seam with a spec
(``faultline.arm("serving_worker", action="raise", at=1)``) and the next
matching crossing performs the spec's action: raise, stall, corrupt the
named file, or deliver a signal.  The registry is static: :func:`seams`
lists every declared seam, and a crossing or arm of an undeclared name
raises.

``grad_nonfinite`` is applied eagerly here: the guarded step knows its
step count, and :func:`poison_step` says whether the armed spec poisons
this one (the JAX package applies it at trace time as a select on its
device step counter).  ``rank_divergence`` (the launch audit's
fingerprint seam) is not declared: the port has no launch audit.

Arming bumps :func:`epoch`, as in the JAX package, where it is part of
the executor's compile key."""

from __future__ import annotations

import os
import time
from typing import Any, Dict, List, Optional

#: the statically declared seam registry: name -> where / what it injects
SEAMS: Dict[str, str] = {
    "grad_nonfinite": (
        "the guarded training step, after the gradients materialize: "
        "poison a chosen gradient with NaN at step k (params: step, var; "
        "applied eagerly, the step count known on the host)"),
    "checkpoint_write": (
        "io.py verified file write, between write and readback "
        "verification: raise OSError or corrupt the just-written file"),
    "serving_worker": (
        "ServingEngine worker loop, top of each iteration: an uncaught "
        "worker exception (outside the per-batch recovery)"),
    "serving_decode": (
        "DecodeEngine worker loop, top of each scheduling round: an "
        "uncaught decode-worker exception (outside the per-step "
        "recovery) — in-flight generations must fail, their cache "
        "blocks must free, and the engine must go unhealthy"),
    "step_stall": (
        "PreparedStep.run, before dispatch: stall the step on the host "
        "(the hang the watchdog must catch)"),
    "collective_impl": (
        "executor run_ops, before a collective op runs: raise from "
        "inside the op (wrapped as EnforceNotMet)"),
    "reshard_execute": (
        "reshard.execute_reshard, between per-var transfers: raise or "
        "deliver a signal mid-restore (the preemption-atomicity drill)"),
}

#: seams whose crossing returns the spec for the caller to apply
_TRACE_SEAMS = frozenset(["grad_nonfinite"])

_ARMED: Dict[str, "FaultSpec"] = {}
_EPOCH = [0]


class FaultlineError(RuntimeError):
    """The error an armed ``action="raise"`` seam injects by default."""


class FaultSpec:
    """One armed injection: fires on crossings ``at <= hit < at+times``
    (per-seam hit counter), optionally only when every ``match`` item
    equals the crossing's context."""

    __slots__ = ("seam", "action", "at", "times", "match", "params",
                 "hits", "fired")

    def __init__(self, seam: str, action: str, at: int = 0,
                 times: Optional[int] = 1,
                 match: Optional[Dict[str, Any]] = None, **params):
        self.seam = seam
        self.action = action
        self.at = int(at)
        self.times = None if times is None else int(times)
        self.match = dict(match or {})
        self.params = params
        self.hits = 0          # matching crossings seen
        self.fired = 0         # injections performed

    def snapshot(self) -> Dict[str, Any]:
        return {"seam": self.seam, "action": self.action, "at": self.at,
                "times": self.times, "match": dict(self.match),
                "params": {k: v for k, v in self.params.items()
                           if isinstance(v, (type(None), bool, int,
                                             float, str))},
                "hits": self.hits, "fired": self.fired}


def seams() -> Dict[str, str]:
    """The full static seam registry (name -> description)."""
    return dict(SEAMS)


def epoch() -> int:
    """Bumped on every arm / disarm."""
    return _EPOCH[0]


def arm(seam: str, action: str = "raise", at: int = 0,
        times: Optional[int] = 1, match: Optional[Dict[str, Any]] = None,
        **params) -> FaultSpec:
    """Arm ``seam``.  Actions:

    * ``"raise"`` — raise ``params["exc"]`` (an exception instance or
      factory; default :class:`FaultlineError`);
    * ``"stall"`` — ``time.sleep(params["seconds"])``;
    * ``"corrupt_file"`` — overwrite the tail of the file named by the
      crossing's ``path`` context with garbage;
    * ``"signal"`` — ``os.kill(self, params["sig"])`` (default SIGTERM);
    * ``"nan"`` — ``grad_nonfinite`` only: the guarded step poisons a
      gradient (``params``: ``step`` = the guard step to poison, every
      step in the window when absent; ``var`` = the gradient's name,
      default the first parameter's).

    ``at``/``times`` select which matching crossings fire (0-based hit
    index); ``times=None`` means every crossing from ``at`` on.
    ``match`` filters crossings by context equality."""
    if seam not in SEAMS:
        raise KeyError(f"unknown faultline seam {seam!r}; declared seams: "
                       f"{sorted(SEAMS)}")
    spec = FaultSpec(seam, action, at=at, times=times, match=match,
                     **params)
    _ARMED[seam] = spec
    _EPOCH[0] += 1
    return spec


def disarm(seam: Optional[str] = None):
    """Disarm one seam (or all with ``seam=None``)."""
    if seam is None:
        if _ARMED:
            _ARMED.clear()
            _EPOCH[0] += 1
        return
    if _ARMED.pop(seam, None) is not None:
        _EPOCH[0] += 1


def armed() -> List[Dict[str, Any]]:
    """Snapshot of the armed specs (recorded into flight bundles so a
    drill's bundle is replayable: re-arm from the snapshot)."""
    return [s.snapshot() for s in _ARMED.values()]


def peek(seam: str) -> Optional[FaultSpec]:
    """The armed spec for ``seam`` without counting a crossing."""
    if seam not in SEAMS:
        raise KeyError(f"unknown faultline seam {seam!r}")
    return _ARMED.get(seam)


def _in_window(spec: FaultSpec) -> bool:
    if spec.hits - 1 < spec.at:
        return False
    return spec.times is None or spec.hits - 1 < spec.at + spec.times


def poison_step(step: int) -> Optional[FaultSpec]:
    """The ``grad_nonfinite`` crossing of guard step ``step`` (None: an
    unguarded run, which has no step count): the armed spec when it
    poisons this step, else None.  A spec with a ``step`` param poisons
    that step only (any step of an unguarded run, as the JAX package's
    does); one without follows the ``at`` / ``times`` window.  Each call
    is a hit."""
    spec = _ARMED.get("grad_nonfinite")
    if spec is None:
        return None
    spec.hits += 1
    k = spec.params.get("step")
    if k is None:
        fire = _in_window(spec)
    else:
        fire = step is None or int(k) == int(step)
    if not fire:
        return None
    spec.fired += 1
    return spec


def crossing(seam: str, **ctx):
    """The production-code hook.  Unarmed: one dict truthiness test.
    Armed and in-window: perform the spec's action (``grad_nonfinite``
    returns the spec instead).  Returns the spec when it fired, None
    otherwise."""
    if not _ARMED:
        return None
    spec = _ARMED.get(seam)
    if spec is None:
        if seam not in SEAMS:
            raise KeyError(f"unknown faultline seam {seam!r}")
        return None
    for k, want in spec.match.items():
        if ctx.get(k) != want:
            return None
    spec.hits += 1
    if not _in_window(spec):
        return None
    spec.fired += 1
    act = spec.action
    if seam in _TRACE_SEAMS or act == "nan":
        return spec
    if act == "raise":
        exc = spec.params.get("exc")
        if exc is None:
            raise FaultlineError(f"faultline: injected fault at seam "
                                 f"{seam!r} (ctx={ctx})")
        raise exc() if callable(exc) else exc
    if act == "stall":
        time.sleep(float(spec.params.get("seconds", 1.0)))
        return spec
    if act == "corrupt_file":
        path = ctx.get("path") or spec.params.get("path")
        if path and os.path.exists(path):
            size = os.path.getsize(path)
            with open(path, "r+b") as f:
                f.seek(max(0, size - 64))
                f.write(b"\xde\xad\xbe\xef" * 16)
        return spec
    if act == "signal":
        import signal as _signal
        os.kill(os.getpid(), int(spec.params.get("sig", _signal.SIGTERM)))
        return spec
    raise ValueError(f"faultline seam {seam!r}: unknown action {act!r}")


__all__ = ["SEAMS", "FaultSpec", "FaultlineError", "seams", "epoch",
           "arm", "disarm", "armed", "peek", "poison_step", "crossing"]
