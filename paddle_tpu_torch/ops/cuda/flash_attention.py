"""Flash attention forward on Hopper — the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``.

``flash_fwd`` is ``_flash_fwd``'s analog on flattened ``(B*H, S, D)``
operands and returns ``(o, lse)``; ``flash_attention_bshd`` takes
``(B, H, S, D)`` operands plus a broadcastable additive bias, exactly as
the TPU wrapper does.  The kernel is ``csrc/flash_attention.cu`` (the
source note there gives its bound and design); ``flash_fwd_plain`` is the
same function in plain PyTorch, used for CPU tensors and as the
reference ``chip_smoke.py`` holds the kernel against.

Dropout is not on the served path: a non-zero rate raises until the
training slice brings a counter-based (Philox) mask into the kernel."""

from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import (LAUNCHES, check_cuda, dtype_code, raise_on_error,
               require_cuda, stream_handle)
from .build import function

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)

_P = ctypes.c_void_p
_I = ctypes.c_int
_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
             ctypes.c_float, _P)


def supported(sq: int, sk: int, d: int, dtype=torch.float32,
              causal: bool = False, dropout_rate: float = 0.0
              ) -> Tuple[bool, str]:
    """What the CUDA kernel rejects: head dims other than 64/128/256,
    dtypes other than float32/bfloat16, a rectangular causal problem and
    dropout.  Any sequence lengths work (rows and keys are masked)."""
    if d not in HEAD_DIMS:
        return False, f"head-dim:{d}"
    if dtype not in (torch.float32, torch.bfloat16):
        return False, f"dtype:{dtype}"
    if causal and sq != sk:
        return False, "causal-rectangular"
    if dropout_rate:
        return False, "dropout"
    return True, ""


def flash_fwd_plain(q, k, v, bias=None, causal=False):
    """Plain PyTorch spec of the kernel: q (BH, Sq, D), k/v (BH, Sk, D),
    bias (B|BH, Sq, Sk) or None.  Returns (o in q's dtype, lse float32 of
    shape (BH, Sq, 1), +inf on rows with no unmasked key)."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    s = torch.matmul(q.float(), k.float().transpose(1, 2)) * \
        (1.0 / math.sqrt(d))
    if bias is not None:
        b = bias.float()
        if b.shape[0] != bh:                       # head-shared bias
            b = b.repeat_interleave(bh // b.shape[0], dim=0)
        s = s + b
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    acc = torch.matmul(p.to(v.dtype).float(), v.float())
    o = (acc / l.clamp_min(1e-30)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, math.inf))
    return o, lse


def flash_fwd(q, k, v, bias: Optional[torch.Tensor] = None,
              causal: bool = False, dropout_rate: float = 0.0):
    """(o, lse) for q (BH, Sq, D), k/v (BH, Sk, D) and an optional float32
    bias (BH / ratio, Sq, Sk).  CPU tensors run :func:`flash_fwd_plain`;
    CUDA tensors launch the kernel or raise."""
    if dropout_rate:
        raise NotImplementedError(
            "flash attention dropout needs a counter-based mask inside the "
            "kernel, which the training slice adds; serve with is_test")
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, bias, causal)
    require_cuda("flash_fwd", q)
    check_cuda("flash_fwd", q, k, v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"flash_fwd: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    ok, why = supported(sq, sk, d, q.dtype, causal)
    if not ok:
        raise ValueError(f"flash_fwd: unsupported problem ({why})")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError("flash_fwd: the kernel reads q, k and v in 16-byte "
                         "vectors; pass 16-byte-aligned tensors")
    ratio = 1
    if bias is not None:
        check_cuda("flash_fwd bias", bias)
        if bias.dtype != torch.float32 or bias.dim() != 3 or \
                tuple(bias.shape[1:]) != (sq, sk) or \
                bias.shape[0] < 1 or bh % bias.shape[0]:
            raise ValueError(f"flash_fwd: bias must be float32 "
                             f"(BH/r, {sq}, {sk}), got {bias.dtype} "
                             f"{tuple(bias.shape)}")
        ratio = bh // bias.shape[0]
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    fn = function("flash_attention", "pt_flash_attn_fwd", _ARGTYPES)
    rc = fn(dtype_code(q, "flash_fwd"), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr(), bh, sq, sk, d, ratio,
            int(bool(causal)), 1.0 / math.sqrt(d), stream_handle(q.device))
    raise_on_error("flash_fwd", rc)
    LAUNCHES["flash_attention_fwd"] += 1
    return o, lse


def flash_attention_bshd(q, k, v, bias=None, dropout_rate=0.0,
                         causal=False):
    """q: (B, H, Sq, D), k/v: (B, H, Sk, D); bias broadcastable
    (B, 1|H, 1|Sq, Sk) or None.  Returns (B, H, Sq, D).  A (B, 1, 1, Sk)
    mask broadcasts over the queries, and a head-shared bias is passed as
    (B, Sq, Sk) so the kernel reads it once per batch row, not per head."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    ok, why = supported(s, sk, d, q.dtype, causal, dropout_rate)
    if not ok and why != "dropout":
        raise ValueError(f"flash_attention: unsupported problem ({why})")
    qf = q.reshape(b * h, s, d).contiguous()
    kf = k.reshape(b * h, sk, d).contiguous()
    vf = v.reshape(b * h, sk, d).contiguous()
    bf = None
    if bias is not None:
        if bias.shape[2] == 1:
            bias = bias.expand(bias.shape[0], bias.shape[1], s, sk)
        if bias.shape[1] == 1:
            bf = bias.reshape(b, s, sk)
        else:
            bf = bias.expand(b, h, s, sk).reshape(b * h, s, sk)
        bf = bf.to(torch.float32).contiguous()
    o, _ = flash_fwd(qf, kf, vf, bf, causal=causal,
                     dropout_rate=dropout_rate)
    return o.reshape(b, h, s, d)
