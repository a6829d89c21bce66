"""Flash attention on Hopper — the counterpart of
``paddle_tpu/ops/pallas/flash_attention.py``.

``flash_fwd`` is ``_flash_fwd``'s analog on flattened ``(B*H, S, D)``
operands and returns ``(o, lse)``; ``flash_bwd`` is ``_flash_bwd``'s and
returns ``(dq, dk, dv)`` from two kernels routed by :func:`bwd_plan`.  On
its "mma" route (head dim 64 or 128, a score gradient of at most
:data:`DS_SCRATCH_CAP` bytes) ``flash_bwd_dkv`` writes dk, dv and the
score gradient ds into a float32 scratch, and ``flash_bwd_dq_ds`` takes
dq = ds.k from it; on its "fma" route (head dim 256, or a larger score
gradient) ``flash_bwd_dkv`` and ``flash_bwd_dq`` each recompute the
scores, in O(S) memory.  :class:`FlashAttention` ties them into one
``torch.autograd.Function`` (the TPU package's ``custom_vjp``), and
``flash_attention_bshd`` takes ``(B, H, S, D)`` operands plus a
broadcastable additive bias, exactly as the TPU wrapper does.
:class:`FlashAttentionLse` and ``flash_attention_with_lse`` return the
per-row logsumexp beside o, differentiable: its cotangent folds into the
same backward kernels as delta - dlse (ring attention's merge).  The
kernels are ``csrc/flash_attention.cu`` and ``csrc/flash_attention_bwd.cu``
(the source notes there give their bounds and designs);
``flash_fwd_plain`` and ``flash_bwd_plain`` are the same functions in plain
PyTorch, written out as the kernels compute them (the backward is the
explicit formula, not autograd of the forward), used for CPU tensors and
as the references ``chip_smoke.py`` holds the kernels against (in float32,
or in float64 when given float64 tensors).

Dropout: an element of the score matrix is kept when its Philox-4x32-10
word is at least ``rate * 2^32``: word 2 * ((row >> 3) & 1) + (col & 1)
of the draw of counter (col >> 1, row & ~8, bh), one draw for four
elements (:func:`philox_bits` reproduces the kernels' generator bit for
bit in integer tensor ops), and the seed is an int32 tensor, read on the
device.
The additive bias gets no gradient, by the TPU kernel's contract."""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import torch

from . import (check_cuda, count_launch, dtype_code, needs_grad,
               raise_on_error, require_cuda, stream_handle)
from .build import function

NEG_INF = -1e30
HEAD_DIMS = (64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16, torch.float16)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
_FWD_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                 _P, _U, _F, _P)
_DQ_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                _I, _F, _P, _U, _F, _P)
_DQ_DS_ARGTYPES = (_I, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P)
_DKV_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                 _I, _I, _F, _P, _U, _F, _P)
#: rows of a score tile in the backward kernels (csrc kBlockM, kBlockN)
BWD_TILE = 64
#: the most bytes of float32 score gradient the "mma" route allocates per
#: backward call (4 BH round64(Sk) round64(Sq): 25.2 MB at B32 H12 S128,
#: 101 MB at B8 H12 S512); a larger problem takes the "fma" route, whose
#: kernels recompute the scores in O(S) memory (:func:`bwd_plan`)
DS_SCRATCH_CAP = 1 << 30

# Philox-4x32-10 constants (csrc/common.cuh pt_philox)
_PHILOX_M = (0xD2511F53, 0xCD9E8D57)
_PHILOX_W = (0x9E3779B9, 0xBB67AE85)
_U32 = 0xFFFFFFFF


def supported(sq: int, sk: int, d: int, dtype=torch.float32,
              causal: bool = False, dropout_rate: float = 0.0
              ) -> Tuple[bool, str]:
    """What the CUDA kernels reject: head dims other than 64/128/256,
    dtypes other than float32/bfloat16/float16, a rectangular causal
    problem and a dropout rate outside [0, 1).  Any sequence lengths work
    (rows and keys are masked)."""
    if d not in HEAD_DIMS:
        return False, f"head-dim:{d}"
    if dtype not in DTYPES:
        return False, f"dtype:{dtype}"
    if causal and sq != sk:
        return False, "causal-rectangular"
    if not 0.0 <= dropout_rate < 1.0:
        return False, f"dropout-rate:{dropout_rate}"
    return True, ""


class BwdPlan(NamedTuple):
    """How the backward kernels take a problem.  ``route`` "mma": the
    tensor-core kernels, dk/dv writing the float32 score gradient ds^T
    into a (BH, ds_rows, ds_cols) scratch (keys by queries, both padded to
    the 64-row tiles) that dq reads; "fma": the float32 FMA kernels, each
    recomputing the scores and the dropout mask (no scratch)."""
    route: str
    ds_rows: int
    ds_cols: int


def bwd_plan(bh: int, sq: int, sk: int, d: int,
             cap: Optional[int] = None) -> BwdPlan:
    """The :class:`BwdPlan` of a problem the gate (:func:`supported`)
    takes, as ``csrc/flash_attention_bwd.cu`` dispatches it: "mma" for
    head dims 64 and 128 while the scratch holds at most ``cap`` bytes
    (default :data:`DS_SCRATCH_CAP`, read at the call), else "fma" (head
    dim 256: a warp's dk and dv rows do not fit its registers)."""
    def pad(n):
        return -(-n // BWD_TILE) * BWD_TILE
    cap = DS_SCRATCH_CAP if cap is None else cap
    if d == 256 or 4 * bh * pad(sk) * pad(sq) > cap:
        return BwdPlan("fma", 0, 0)
    return BwdPlan("mma", pad(sk), pad(sq))


# ---------------------------------------------------------------------------
# the dropout mask
# ---------------------------------------------------------------------------


def dropout_params(rate: float) -> Tuple[int, float]:
    """(threshold, 1 / (1 - rate)): keep an element when its Philox word is
    >= threshold, as the TPU kernel keeps bits >= rate * 2^32."""
    return min(int(rate * 2 ** 32), _U32), 1.0 / (1.0 - rate)


def _mulhilo(a, m: int):
    """(hi, lo) 32-bit words of the 64-bit product a * m, for int64 tensors
    a in [0, 2^32) and a 32-bit constant m, from 16-bit limbs so that no
    intermediate leaves the int64 range."""
    m0, m1 = m & 0xFFFF, m >> 16
    a0, a1 = a & 0xFFFF, a >> 16
    p00, p01, p10, p11 = a0 * m0, a0 * m1, a1 * m0, a1 * m1
    mid = (p00 >> 16) + (p01 & 0xFFFF) + (p10 & 0xFFFF)
    lo = ((mid & 0xFFFF) << 16) | (p00 & 0xFFFF)
    hi = p11 + (p01 >> 16) + (p10 >> 16) + (mid >> 16)
    return hi, lo


def philox_words(seed: torch.Tensor, c0, c1, c2):
    """The four Philox-4x32-10 output words of counters (c0, c1, c2, 0)
    under key (seed, 0), for broadcastable int64 tensors of values in
    [0, 2^32) and an integer ``seed`` tensor broadcastable against them
    (one key per element of its shape): a tuple of four int64 tensors
    (csrc/common.cuh pt_philox)."""
    k0 = seed.to(torch.int64) & _U32
    k1 = 0
    c3 = torch.zeros((), dtype=torch.int64, device=seed.device)
    for r in range(10):
        if r:
            k0 = (k0 + _PHILOX_W[0]) & _U32
            k1 = (k1 + _PHILOX_W[1]) & _U32
        hi0, lo0 = _mulhilo(c0, _PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, _PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def philox_bits(seed: torch.Tensor, bh: int, sq: int, sk: int
                ) -> torch.Tensor:
    """The kernels' dropout word for every element (bh, row, col) of a
    (BH, Sq, Sk) score tensor, as int64 values in [0, 2^32): word
    2 * ((row >> 3) & 1) + (col & 1) of the draw of counter
    (col >> 1, row & ~8, bh, 0), key (seed, 0) (csrc/common.cuh
    pt_dropout_word).  One draw covers rows r and r + 8 at columns c and
    c + 1, so the draws are taken on a grid of a quarter of the elements."""
    dev = seed.device
    blocks, pairs = -(-sq // 16), -(-sk // 2)
    rows = (torch.arange(blocks, dtype=torch.int64, device=dev)[:, None] * 16
            + torch.arange(8, dtype=torch.int64, device=dev)).reshape(-1)
    words = philox_words(
        seed.reshape(()), torch.arange(pairs, dtype=torch.int64, device=dev).view(1, 1, -1),
        rows.view(1, -1, 1),
        torch.arange(bh, dtype=torch.int64, device=dev).view(-1, 1, 1))
    # [bh, block, row & 7, col >> 1, word] -> word = 2 * (row bit 3) + col & 1
    w = torch.stack(torch.broadcast_tensors(*words), dim=-1).view(
        bh, blocks, 8, pairs, 2, 2)
    return w.permute(0, 1, 4, 2, 3, 5).reshape(
        bh, 16 * blocks, 2 * pairs)[:, :sq, :sk]


def dropout_keep(seed: torch.Tensor, rate: float, bh: int, sq: int,
                 sk: int) -> torch.Tensor:
    """The boolean keep mask the kernels draw for (seed, rate)."""
    threshold, _ = dropout_params(rate)
    return philox_bits(seed, bh, sq, sk) >= threshold


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _acc(t):
    """The plain versions' arithmetic: float64 for float64 operands (a
    witness of the float32 result's own rounding), float32 otherwise."""
    return torch.float64 if t.dtype == torch.float64 else torch.float32


def _scores(q, k, bias, causal):
    """s = q.k^T / sqrt(D) + bias in float32 (float64 for float64 q),
    causal entries at NEG_INF."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    ct = _acc(q)
    s = torch.matmul(q.to(ct), k.to(ct).transpose(1, 2)) * \
        (1.0 / math.sqrt(d))
    if bias is not None:
        b = bias.to(ct)
        if b.shape[0] != bh:                       # head-shared bias
            b = b.repeat_interleave(bh // b.shape[0], dim=0)
        s = s + b
    if causal:
        keep = torch.ones(sq, sk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~keep, NEG_INF)
    return s


def _keep_mask(q, k, dropout_rate, seed):
    if not dropout_rate:
        return None
    if seed is None:
        raise ValueError("flash attention: dropout_rate > 0 needs a seed")
    return dropout_keep(seed, dropout_rate, q.shape[0], q.shape[1],
                        k.shape[1])


def flash_fwd_plain(q, k, v, bias=None, causal=False, dropout_rate=0.0,
                    seed=None):
    """Plain PyTorch spec of the forward kernel: q (BH, Sq, D), k/v
    (BH, Sk, D), bias (B|BH, Sq, Sk) or None, seed an int32 tensor when
    dropout_rate > 0.  Returns (o in q's dtype, lse float32 of shape
    (BH, Sq, 1), +inf on rows with no unmasked key; float64 both for
    float64 operands).  The softmax
    denominator sums the undropped p; the mask scales the numerator."""
    s = _scores(q, k, bias, causal)
    m = s.amax(dim=-1, keepdim=True).clamp_min(NEG_INF)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    keep = _keep_mask(q, k, dropout_rate, seed)
    if keep is not None:
        p = torch.where(keep, p * dropout_params(dropout_rate)[1],
                        torch.zeros((), device=p.device))
    acc = torch.matmul(p.to(v.dtype).to(p.dtype), v.to(p.dtype))
    o = (acc / l.clamp_min(1e-30)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, math.inf))
    return o, lse


def flash_bwd_plain(q, k, v, bias, o, lse, do, causal=False,
                    dropout_rate=0.0, seed=None, dlse=None):
    """Plain PyTorch spec of the backward kernels, as explicit formulas:
    p = exp(s - lse); dp = do.v^T masked and rescaled like p;
    ds = p * (dp - delta) with delta = rowsum(do * o), less the lse
    cotangent ``dlse`` (BH, Sq[, 1]) when one is given; dq = ds.k * scale,
    dk = ds^T.q * scale, dv = p_dropped^T.do, in float32 (float64 for
    float64 operands).  Returns (dq, dk, dv) in the dtypes of q, k, v."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = torch.exp(_scores(q, k, bias, causal) - lse)
    dof = do.to(p.dtype)
    dp = torch.matmul(dof, v.to(p.dtype).transpose(1, 2))
    keep = _keep_mask(q, k, dropout_rate, seed)
    pd = p
    if keep is not None:
        inv = dropout_params(dropout_rate)[1]
        zero = torch.zeros((), device=p.device)
        pd = torch.where(keep, p * inv, zero)
        dp = torch.where(keep, dp * inv, zero)
    delta = (dof * o.to(p.dtype)).sum(dim=-1, keepdim=True)
    if dlse is not None:
        delta = delta - dlse.to(p.dtype).reshape(delta.shape)
    ds = p * (dp - delta)
    dq = torch.matmul(ds, k.to(p.dtype)) * scale
    dk = torch.matmul(ds.transpose(1, 2), q.to(p.dtype)) * scale
    dv = torch.matmul(pd.transpose(1, 2), dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _check_problem(what, q, k, v, bias, causal, dropout_rate, seed):
    """Validate CUDA operands; returns (bias ratio, seed pointer or None,
    threshold, 1 / (1 - rate))."""
    require_cuda(what, q)
    check_cuda(what, q, k, v)
    if q.dim() != 3 or k.dim() != 3 or k.shape != v.shape or \
            k.shape[0] != q.shape[0] or k.shape[2] != q.shape[2]:
        raise ValueError(f"{what}: shapes q{tuple(q.shape)} "
                         f"k{tuple(k.shape)} v{tuple(v.shape)}")
    bh, sq, d = q.shape
    sk = k.shape[1]
    ok, why = supported(sq, sk, d, q.dtype, causal, dropout_rate)
    if not ok:
        raise ValueError(f"{what}: unsupported problem ({why})")
    if any(t.data_ptr() % 16 for t in (q, k, v)):
        raise ValueError(f"{what}: the kernel reads q, k and v in 16-byte "
                         f"vectors; pass 16-byte-aligned tensors")
    ratio = 1
    if bias is not None:
        check_cuda(f"{what} bias", bias)
        if bias.dtype != torch.float32 or bias.dim() != 3 or \
                tuple(bias.shape[1:]) != (sq, sk) or \
                bias.shape[0] < 1 or bh % bias.shape[0]:
            raise ValueError(f"{what}: bias must be float32 "
                             f"(BH/r, {sq}, {sk}), got {bias.dtype} "
                             f"{tuple(bias.shape)}")
        ratio = bh // bias.shape[0]
    if not dropout_rate:
        return ratio, None, 0, 1.0
    if seed is None or seed.dtype != torch.int32 or seed.numel() != 1 or \
            seed.device != q.device:
        raise ValueError(f"{what}: dropout needs a one-element int32 seed "
                         f"tensor on {q.device}")
    threshold, inv_keep = dropout_params(dropout_rate)
    return ratio, seed.data_ptr(), threshold, inv_keep


def flash_fwd(q, k, v, bias: Optional[torch.Tensor] = None,
              causal: bool = False, dropout_rate: float = 0.0,
              seed: Optional[torch.Tensor] = None):
    """(o, lse) for q (BH, Sq, D), k/v (BH, Sk, D) and an optional float32
    bias (BH / ratio, Sq, Sk).  CPU tensors run :func:`flash_fwd_plain`;
    CUDA tensors launch the kernel or raise."""
    if q.device.type == "cpu":
        return flash_fwd_plain(q, k, v, bias, causal, dropout_rate, seed)
    ratio, seed_ptr, threshold, inv_keep = _check_problem(
        "flash_fwd", q, k, v, bias, causal, dropout_rate, seed)
    bh, sq, d = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((bh, sq, 1), dtype=torch.float32, device=q.device)
    fn = function("flash_attention", "pt_flash_attn_fwd", _FWD_ARGTYPES)
    rc = fn(dtype_code(q, "flash_fwd"), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr() if bias is not None else None,
            o.data_ptr(), lse.data_ptr(), bh, sq, k.shape[1], d, ratio,
            int(bool(causal)), 1.0 / math.sqrt(d), seed_ptr, threshold,
            inv_keep, stream_handle(q.device))
    raise_on_error("flash_fwd", rc)
    count_launch("flash_attention_fwd", q.dtype)
    return o, lse


def _bwd_args(what, q, k, v, bias, do, lse, causal, dropout_rate, seed):
    ratio, seed_ptr, threshold, inv_keep = _check_problem(
        what, q, k, v, bias, causal, dropout_rate, seed)
    check_cuda(what, q, do)
    if do.shape != q.shape or do.data_ptr() % 16:
        raise ValueError(f"{what}: dO must be a 16-byte-aligned "
                         f"{tuple(q.shape)} tensor")
    bh, sq, d = q.shape
    if lse.dtype != torch.float32 or lse.numel() != bh * sq or \
            not lse.is_contiguous():
        raise ValueError(f"{what}: lse must be contiguous float32 of "
                         f"{bh * sq} rows")
    return ratio, seed_ptr, threshold, inv_keep


def flash_bwd_dkv(q, k, v, bias, do, lse, delta, causal=False,
                  dropout_rate=0.0, seed=None):
    """(dk, dv, ds) on CUDA tensors (the ``_bwd_dkv_kernel`` counterpart):
    ds is the float32 score gradient ds^T that :func:`flash_bwd_dq_ds`
    reads on the "mma" route of :func:`bwd_plan`, None on its "fma"
    route."""
    ratio, seed_ptr, threshold, inv_keep = _bwd_args(
        "flash_bwd_dkv", q, k, v, bias, do, lse, causal, dropout_rate, seed)
    bh, sq, d = q.shape
    plan = bwd_plan(bh, sq, k.shape[1], d)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    ds = None
    if plan.route == "mma":
        ds = torch.empty((bh, plan.ds_rows, plan.ds_cols),
                         dtype=torch.float32, device=q.device)
    fn = function("flash_attention_bwd", "pt_flash_attn_bwd_dkv",
                  _DKV_ARGTYPES)
    rc = fn(dtype_code(q, "flash_bwd_dkv"), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr() if bias is not None else None,
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dk.data_ptr(),
            dv.data_ptr(), ds.data_ptr() if ds is not None else None, bh,
            sq, k.shape[1], d, ratio, int(bool(causal)), 1.0 / math.sqrt(d),
            seed_ptr, threshold, inv_keep, stream_handle(q.device))
    raise_on_error("flash_bwd_dkv", rc)
    count_launch("flash_attention_bwd_dkv", q.dtype)
    return dk, dv, ds


def flash_bwd_dq(q, k, v, bias, do, lse, delta, causal=False,
                 dropout_rate=0.0, seed=None):
    """dq on CUDA tensors from the inputs alone (the ``_bwd_dq_kernel``
    counterpart, on the "fma" route of :func:`bwd_plan`): the kernel
    recomputes the scores and the mask."""
    ratio, seed_ptr, threshold, inv_keep = _bwd_args(
        "flash_bwd_dq", q, k, v, bias, do, lse, causal, dropout_rate, seed)
    dq = torch.empty_like(q)
    bh, sq, d = q.shape
    fn = function("flash_attention_bwd", "pt_flash_attn_bwd_dq",
                  _DQ_ARGTYPES)
    rc = fn(dtype_code(q, "flash_bwd_dq"), q.data_ptr(), k.data_ptr(),
            v.data_ptr(), bias.data_ptr() if bias is not None else None,
            do.data_ptr(), lse.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            bh, sq, k.shape[1], d, ratio, int(bool(causal)),
            1.0 / math.sqrt(d), seed_ptr, threshold, inv_keep,
            stream_handle(q.device))
    raise_on_error("flash_bwd_dq", rc)
    count_launch("flash_attention_bwd_dq", q.dtype)
    return dq


def flash_bwd_dq_ds(k, ds, sq, causal=False):
    """dq = ds.k * scale on CUDA tensors (the ``_bwd_dq_kernel``
    counterpart on the "mma" route of :func:`bwd_plan`): ``ds`` is the
    float32 score gradient :func:`flash_bwd_dkv` returned for the same
    problem, and dq has ``sq`` rows in k's dtype."""
    require_cuda("flash_bwd_dq_ds", k)
    check_cuda("flash_bwd_dq_ds", k)
    if ds.device != k.device:
        raise ValueError(f"flash_bwd_dq_ds: tensors on {ds.device} and "
                         f"{k.device}")
    if k.dim() != 3 or k.data_ptr() % 16:
        raise ValueError("flash_bwd_dq_ds: k must be a 16-byte-aligned "
                         "(BH, Sk, D) tensor")
    bh, sk, d = k.shape
    plan = bwd_plan(bh, sq, sk, d)
    if causal and sq != sk:
        raise ValueError("flash_bwd_dq_ds: unsupported problem "
                         "(causal-rectangular)")
    if plan.route != "mma" or ds.dtype != torch.float32 or \
            not ds.is_contiguous() or \
            tuple(ds.shape) != (bh, plan.ds_rows, plan.ds_cols):
        raise ValueError(f"flash_bwd_dq_ds: needs flash_bwd_dkv's float32 "
                         f"ds scratch for ({bh}, {sq}, {sk}, {d}) on the "
                         f"mma route, got {ds.dtype} {tuple(ds.shape)}")
    dq = torch.empty((bh, sq, d), dtype=k.dtype, device=k.device)
    fn = function("flash_attention_bwd", "pt_flash_attn_bwd_dq_ds",
                  _DQ_DS_ARGTYPES)
    rc = fn(dtype_code(k, "flash_bwd_dq_ds"), k.data_ptr(), ds.data_ptr(),
            dq.data_ptr(), bh, sq, sk, d, int(bool(causal)),
            1.0 / math.sqrt(d), stream_handle(k.device))
    raise_on_error("flash_bwd_dq_ds", rc)
    count_launch("flash_attention_bwd_dq", k.dtype)
    return dq


def flash_bwd(q, k, v, bias, o, lse, do, causal=False, dropout_rate=0.0,
              seed=None, dlse=None):
    """(dq, dk, dv) given the forward's inputs, o, lse and the output
    gradient do.  CPU tensors run :func:`flash_bwd_plain`; CUDA tensors
    launch the dk/dv kernel, then the dq kernel, from its ds on the "mma"
    route and from the inputs on the "fma" route (delta = rowsum(do * o)
    is one float32 reduction here, as ``_flash_bwd`` computes it outside
    its kernels).  An lse cotangent ``dlse`` (BH, Sq[, 1]) folds into the
    same kernels as delta - dlse: dL/ds = p (dp - delta) + dlse p."""
    if q.device.type == "cpu":
        return flash_bwd_plain(q, k, v, bias, o, lse, do, causal,
                               dropout_rate, seed, dlse)
    do = do.contiguous()
    delta = (do.float() * o.float()).sum(dim=-1)
    if dlse is not None:
        delta = delta - dlse.float().reshape(delta.shape)
    dk, dv, ds = flash_bwd_dkv(q, k, v, bias, do, lse, delta, causal,
                               dropout_rate, seed)
    if ds is not None:
        dq = flash_bwd_dq_ds(k, ds, q.shape[1], causal)
    else:
        dq = flash_bwd_dq(q, k, v, bias, do, lse, delta, causal,
                          dropout_rate, seed)
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = flash attention of flattened (BH, S, D) operands, with the dq
    and dk/dv kernels as its backward; the bias and the seed get no
    gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias, seed, causal, dropout_rate):
        o, lse = flash_fwd(q, k, v, bias, causal, dropout_rate, seed)
        ctx.save_for_backward(q, k, v, bias, seed, o, lse)
        ctx.causal, ctx.dropout_rate = causal, dropout_rate
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, bias, seed, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_bwd(q, k, v, bias, o, lse, do, ctx.causal,
                               ctx.dropout_rate, seed)
        return dq, dk, dv, None, None, None, None


class FlashAttentionLse(torch.autograd.Function):
    """(o, lse) of flattened (BH, S, D) operands, both differentiable: the
    backward takes (do, dlse) and hands delta - dlse to the same dq and
    dk/dv kernels (the TPU package's ``_make_flash(with_lse=True)``).  No
    dropout; the bias gets no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, bias):
        o, lse = flash_fwd(q, k, v, bias)
        ctx.save_for_backward(q, k, v, bias, o, lse)
        return o, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, bias, o, lse = ctx.saved_tensors
        if do is None:
            do = torch.zeros_like(o)
        dq, dk, dv = flash_bwd(q, k, v, bias, o, lse, do, dlse=dlse)
        return dq, dk, dv, None


def _flat_bias(bias, b, h, s, sk):
    """A broadcastable (B, 1|H, 1|Sq, Sk) bias as the kernels read it:
    (B, Sq, Sk) when the heads share it (read once per batch row), else
    (B*H, Sq, Sk); float32, no gradient."""
    if bias is None:
        return None
    if bias.shape[2] == 1:
        bias = bias.expand(bias.shape[0], bias.shape[1], s, sk)
    if bias.shape[1] == 1:
        bf = bias.reshape(b, s, sk)
    else:
        bf = bias.expand(b, h, s, sk).reshape(b * h, s, sk)
    return bf.detach().to(torch.float32).contiguous()


def flash_attention_with_lse(q, k, v, bias=None):
    """Attention over ONE K/V block with its residual: ``(o, lse)`` for
    q (B, H, Sq, D) and k/v (B, H, Sk, D), lse (B, H, Sq) float32, both
    differentiable through :class:`FlashAttentionLse` — the building block
    ring attention merges over the rotated K/V shards
    (``parallel/ring_attention.py``).  ``bias`` is a broadcastable
    (B, 1|H, 1|Sq, Sk) additive mask, stop-gradiented.  A row whose keys
    are all masked by a finite bias (the ring's -1e30) gets the uniform
    mean of V and a finite lse near the bias; CPU tensors run the plain
    twins."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    ok, why = supported(s, sk, d, q.dtype)
    if not ok:
        raise ValueError(f"flash_attention_with_lse: unsupported problem "
                         f"({why})")
    qf = q.reshape(b * h, s, d).contiguous()
    kf = k.reshape(b * h, sk, d).contiguous()
    vf = v.reshape(b * h, sk, d).contiguous()
    bf = _flat_bias(bias, b, h, s, sk)
    if needs_grad(qf, kf, vf):
        o, lse = FlashAttentionLse.apply(qf, kf, vf, bf)
    else:
        o, lse = flash_fwd(qf, kf, vf, bf)
    return o.reshape(b, h, s, d), lse.reshape(b, h, s)


def flash_attention_bshd(q, k, v, bias=None, dropout_rate=0.0,
                         causal=False, seed=None):
    """q: (B, H, Sq, D), k/v: (B, H, Sk, D); bias broadcastable
    (B, 1|H, 1|Sq, Sk) or None; seed a one-element int32 tensor when
    dropout_rate > 0.  Returns (B, H, Sq, D), differentiable in q, k and v
    through :class:`FlashAttention`.  A (B, 1, 1, Sk) mask broadcasts over
    the queries, and a head-shared bias is passed as (B, Sq, Sk) so the
    kernels read it once per batch row, not per head."""
    b, h, s, d = q.shape
    sk = k.shape[2]
    ok, why = supported(s, sk, d, q.dtype, causal, dropout_rate)
    if not ok:
        raise ValueError(f"flash_attention: unsupported problem ({why})")
    qf = q.reshape(b * h, s, d).contiguous()
    kf = k.reshape(b * h, sk, d).contiguous()
    vf = v.reshape(b * h, sk, d).contiguous()
    bf = _flat_bias(bias, b, h, s, sk)
    if needs_grad(qf, kf, vf):
        o = FlashAttention.apply(qf, kf, vf, bf, seed, bool(causal),
                                 float(dropout_rate))
    else:
        o, _ = flash_fwd(qf, kf, vf, bf, causal=causal,
                         dropout_rate=dropout_rate, seed=seed)
    return o.reshape(b, h, s, d)
