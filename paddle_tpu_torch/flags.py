"""Process-level flags (ref: platform/flags.cc gflags + fluid.get_flags /
set_flags) — only the flags the port reads so far.

``use_flash_attention`` and ``use_pallas_fused`` keep the JAX package's
names and defaults: they switch the hand-written kernels (ops/cuda/) on
and off, and with both off every op runs its plain PyTorch composition —
the plain path a run on the card is compared against.  The checkpoint
writer's retry count and backoff keep the JAX package's names and
defaults too, and so does ``overlap_lowering``."""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Union

_REGISTRY: Dict[str, Any] = {}


def _register(name: str, default):
    """A flag of ``default``'s type (bool, int or float);
    ``FLAGS_<name>`` in the environment overrides it."""
    env = os.environ.get(f"FLAGS_{name}")
    if env is not None:
        if isinstance(default, bool):
            default = env.lower() in ("1", "true", "yes")
        else:
            default = type(default)(env)
    _REGISTRY[name] = default


_register("use_flash_attention", True)     # flash attention kernel gate
_register("use_pallas_fused", True)        # LN / add-LN / bias-GELU kernels
# checkpoint file writes: attempts after a transient OSError, first backoff
_register("checkpoint_retries", 3)
_register("checkpoint_retry_backoff_s", 0.05)
# overlap_grad_sync's ready-order buckets fire their collectives from
# backward hooks (True) or all at the program tail (False: the same
# program and buckets, every collective after the backward — the control
# that shows the hooks move when a bucket runs, not what it computes)
_register("overlap_lowering", True)
# the pipelined lowering keeps each F unit's sent boundary and holds the
# B / W units' recomputed one to it bit for bit (the dropout replay),
# counted in last_pipeline_report(); off: nothing kept, nothing compared
_register("pipe_replay_check", False)
# the static pricing layer (framework/memory_analysis.py): a per-rank
# budget in GiB that Executor.prepare / Executor.run /
# CompiledProgram.with_mesh hold a program's static peak estimate to
# before any launch (0: no gate); with remat_on_reject an over-budget
# training program gets recompute checkpoints (pipe.plan_remat) instead
_register("hbm_budget_gb", 0.0)
_register("remat_on_reject", False)
# the share of the step's 3x forward GEMM FLOPs that runs in the backward
# and can hide an overlapped gradient sync (the exposed-comm model)
_register("overlap_compute_frac", 2.0 / 3.0)
# peak FLOP/s the exposed-comm model divides the step's FLOPs by (> 0
# overrides observability.flops.device_peak_flops' table)
_register("device_peak_flops", 0.0)
# the bandwidth in GB/s the exposed-comm model moves wire bytes at: the
# gloo exchange measured on an NVIDIA H100 80GB HBM3 at 700 W (two ranks
# on one card, 48 x 25.2 MB in 1611.4 ms: 0.75 GB/s; chip_smoke.py phase
# 20 (b))
_register("link_gbps", 0.75)


def get_flags(flags: Union[str, Iterable[str]]) -> Dict[str, Any]:
    """ref: fluid.get_flags."""
    names: List[str] = [flags] if isinstance(flags, str) else list(flags)
    out = {}
    for n in names:
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise ValueError(f"flag {n!r} is not registered")
        out[n] = _REGISTRY[key]
    return out


def set_flags(flags: Dict[str, Any]):
    """ref: fluid.set_flags."""
    for n, v in flags.items():
        key = n[6:] if n.startswith("FLAGS_") else n
        if key not in _REGISTRY:
            raise ValueError(f"flag {n!r} is not registered")
        _REGISTRY[key] = v


def flag(name: str):
    """Internal fast accessor."""
    return _REGISTRY[name]
