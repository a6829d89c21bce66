"""Fused row kernels on Hopper — the counterpart of
``paddle_tpu/ops/pallas/fused_ops.py`` (forward halves).

* :func:`layer_norm` — LN over the last dim of x2 [R, D]
  (``csrc/layer_norm.cu``, replaces ``_ln_fwd_kernel``);
* :func:`add_layer_norm` — LN(a2 + b2), the sum never written to memory
  (same source, residual variant; replaces ``_aln_fwd_kernel``);
* :func:`bias_gelu` — exact-erf GELU(x2 + bias) (``csrc/bias_gelu.cu``,
  replaces ``_bg_fwd_kernel``).

Each has a ``*_plain`` PyTorch twin computing the same function with the
same float32 statistics; CPU tensors run the twin, CUDA tensors launch
the kernel or raise."""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import (LAUNCHES, check_cuda, dtype_code, raise_on_error,
               require_cuda, stream_handle)
from .build import function

_P = ctypes.c_void_p
_I = ctypes.c_int
_LN_ARGTYPES = (_I, _P, _P, _P, _P, _P, _I, _I, ctypes.c_float, _P)
_BG_ARGTYPES = (_I, _P, _P, _P, _I, _I, _P)

LN_MAX_DIM = 8192
BG_MAX_DIM = 16384


def ln_supported(d: int, dtype=torch.float32) -> Tuple[bool, str]:
    """What the LayerNorm kernels reject (the TPU kernel's gate)."""
    if d % 128 or d > LN_MAX_DIM or d <= 0:
        return False, f"norm-dim:{d}"
    if dtype not in (torch.float32, torch.bfloat16):
        return False, f"dtype:{dtype}"
    return True, ""


def bg_supported(d: int, dtype=torch.float32) -> Tuple[bool, str]:
    """What the bias+GELU kernel rejects (the TPU kernel's gate)."""
    if d % 128 or d > BG_MAX_DIM or d <= 0:
        return False, f"dim:{d}"
    if dtype not in (torch.float32, torch.bfloat16):
        return False, f"dtype:{dtype}"
    return True, ""


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _norm_rows(u, scale, bias, eps):
    mu = u.mean(dim=-1, keepdim=True)
    uc = u - mu
    rstd = torch.rsqrt((uc * uc).mean(dim=-1, keepdim=True) + eps)
    return uc * rstd * scale.float() + bias.float()


def layer_norm_plain(x2, scale, bias, eps=1e-5):
    return _norm_rows(x2.float(), scale, bias, eps).to(x2.dtype)


def add_layer_norm_plain(a2, b2, scale, bias, eps=1e-5):
    return _norm_rows(a2.float() + b2.float(), scale, bias,
                      eps).to(a2.dtype)


def bias_gelu_plain(x2, bias):
    u = x2.float() + bias.float()
    return (0.5 * u * (1.0 + torch.erf(u * 0.7071067811865476))).to(
        x2.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ln_launch(what, counter, a2, b2, scale, bias, eps):
    require_cuda(what, a2)
    extra = (b2,) if b2 is not None else ()
    check_cuda(what, a2, *extra, scale, bias)
    if a2.dim() != 2 or (b2 is not None and b2.shape != a2.shape):
        raise ValueError(f"{what}: expected [R, D] operands")
    r, d = a2.shape
    if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"{what}: scale/bias must be [{d}]")
    ok, why = ln_supported(d, a2.dtype)
    if not ok:
        raise ValueError(f"{what}: unsupported ({why})")
    y = torch.empty_like(a2)
    fn = function("layer_norm", "pt_layer_norm_fwd", _LN_ARGTYPES)
    rc = fn(dtype_code(a2, what), a2.data_ptr(),
            b2.data_ptr() if b2 is not None else None, scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), r, d, float(eps),
            stream_handle(a2.device))
    raise_on_error(what, rc)
    LAUNCHES[counter] += 1
    return y


def layer_norm(x2, scale, bias, eps=1e-5):
    """LayerNorm over the last dim of x2 [R, D]; scale/bias [D] of x2's
    dtype."""
    if x2.device.type == "cpu":
        return layer_norm_plain(x2, scale, bias, eps)
    return _ln_launch("layer_norm", "layer_norm_fwd", x2, None, scale,
                      bias, eps)


def add_layer_norm(a2, b2, scale, bias, eps=1e-5):
    """LN(a2 + b2) over the last dim; a2/b2 [R, D], scale/bias [D]."""
    if a2.device.type == "cpu":
        return add_layer_norm_plain(a2, b2, scale, bias, eps)
    return _ln_launch("add_layer_norm", "add_layer_norm_fwd", a2, b2,
                      scale, bias, eps)


def bias_gelu(x2, bias):
    """gelu(x2 + bias), exact erf; x2 [R, D], bias [D] of x2's dtype."""
    if x2.device.type == "cpu":
        return bias_gelu_plain(x2, bias)
    what = "bias_gelu"
    require_cuda(what, x2)
    check_cuda(what, x2, bias)
    if x2.dim() != 2 or tuple(bias.shape) != (x2.shape[1],):
        raise ValueError(f"{what}: expected x2 [R, D] and bias [D]")
    r, d = x2.shape
    ok, why = bg_supported(d, x2.dtype)
    if not ok:
        raise ValueError(f"{what}: unsupported ({why})")
    y = torch.empty_like(x2)
    fn = function("bias_gelu", "pt_bias_gelu_fwd", _BG_ARGTYPES)
    rc = fn(dtype_code(x2, what), x2.data_ptr(), bias.data_ptr(),
            y.data_ptr(), r, d, stream_handle(x2.device))
    raise_on_error(what, rc)
    LAUNCHES["bias_gelu_fwd"] += 1
    return y
