"""Process-level flags (ref: platform/flags.cc gflags + fluid.get_flags /
set_flags) — only the gates the port reads so far.

``use_flash_attention`` and ``use_pallas_fused`` keep the JAX package's
names and defaults: they switch the hand-written kernels (ops/cuda/) on
and off, and with both off every op runs its plain PyTorch composition —
the plain path a run on the card is compared against."""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, List, Union

_REGISTRY: Dict[str, Any] = {}


def _register(name: str, default: bool):
    """A boolean gate; ``FLAGS_<name>`` in the environment overrides it."""
    env = os.environ.get(f"FLAGS_{name}")
    _REGISTRY[name] = default if env is None else \
        env.lower() in ("1", "true", "yes")


_register("use_flash_attention", True)     # flash attention kernel gate
_register("use_pallas_fused", True)        # LN / add-LN / bias-GELU kernels


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
