"""The fused Adam update on Hopper — the counterpart of ``adam_update`` in
``paddle_tpu/ops/pallas/fused_ops.py``.

:func:`adam` updates p, m and v in place in one pass
(``csrc/adam.cu``, replaces ``_adam_kernel``), reading the bias-corrected
step ``lr_t`` from a one-element device tensor so that no host sync is
needed.  Unlike the TPU kernel it takes any element count (the TPU's
``numel % 128 == 0 and numel >= 1024`` was its tiling's limit): BERT-base
has 80 parameters of 768 elements or fewer.  :func:`adam_plain` is the
same update in plain PyTorch, in place too; CPU tensors run it, CUDA
tensors launch the kernel or raise."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import LAUNCHES, check_cuda, raise_on_error, require_cuda, \
    stream_handle
from .build import function

_P = ctypes.c_void_p
_F = ctypes.c_float
_ARGTYPES = (_P, _P, _P, _P, _P, ctypes.c_longlong, _F, _F, _F, _F, _F, _P)


def adam_supported(p, g, m, v) -> Tuple[bool, str]:
    """What the Adam kernel rejects: operands of different sizes and
    dtypes other than float32."""
    if not (p.shape == g.shape == m.shape == v.shape):
        return False, "shape-mismatch"
    for t in (p, g, m, v):
        if t.dtype != torch.float32:
            return False, f"dtype:{t.dtype}"
    if p.numel() == 0:
        return False, "empty"
    return True, ""


def adam_plain(p, g, m, v, lr_t, beta1=0.9, beta2=0.999, eps=1e-8):
    """The kernel's update in plain PyTorch, in place on p, m and v:
    m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g*g;
    p = p - lr_t * m / (sqrt(v) + eps).  Returns (p, m, v)."""
    m.mul_(beta1).add_(g * (1.0 - beta1))
    v.mul_(beta2).add_((g * (1.0 - beta2)) * g)
    p.sub_(lr_t * m / (v.sqrt() + eps))
    return p, m, v


def adam(p, g, m, v, lr_t, beta1=0.9, beta2=0.999, eps=1e-8):
    """One Adam step on float32 p, g, m, v of one shape, in place;
    ``lr_t`` is a one-element float32 tensor on their device.  Returns
    (p, m, v), the same tensors."""
    if p.device.type == "cpu":
        return adam_plain(p, g, m, v, lr_t, beta1, beta2, eps)
    what = "adam"
    require_cuda(what, p)
    check_cuda(what, p, g, m, v)
    ok, why = adam_supported(p, g, m, v)
    if not ok:
        raise ValueError(f"{what}: unsupported ({why})")
    if lr_t.dtype != torch.float32 or lr_t.numel() != 1 or \
            lr_t.device != p.device:
        raise ValueError(f"{what}: lr_t must be one float32 on {p.device}")
    fn = function("adam", "pt_adam", _ARGTYPES)
    rc = fn(p.data_ptr(), g.data_ptr(), m.data_ptr(), v.data_ptr(),
            lr_t.data_ptr(), p.numel(), beta1, 1.0 - beta1, beta2,
            1.0 - beta2, eps, stream_handle(p.device))
    raise_on_error(what, rc)
    LAUNCHES["adam"] += 1
    return p, m, v
