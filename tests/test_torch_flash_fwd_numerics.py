"""The arithmetic of the port's tensor-core flash-attention forward kernel
(``paddle_tpu_torch/ops/cuda/csrc/flash_attention.cu``), emulated in torch
on the CPU against the plain twin.

The kernel's float32 arithmetic, per 64-key tile of a row block: the score
q.k^T is one float32 FMA chain per score over the head dim, in order from
0; the scale and the bias are applied with their own roundings; the
online softmax keeps a running max m and sum l, rescaling the accumulator
by exp(m_old - m_new) at each tile; p.v is 3xTF32 on the tensor cores
(hi = tf32(a), lo = tf32(a - hi), rounded by ``cvt.rna``;
a.b ~ lo.hi' + hi.lo' + hi.hi').  Emulated at B2 H2 S128 D64 with BERT's
padding bias, with and without dropout, and causal, o must stay within
``chip_smoke.py``'s TOL_F32 of the twin and lse within TOL_LSE of max(1,
|lse|).  The design not taken, q.k^T in 3xTF32 too, is computed beside it
and reported (``-rP``), also at B32 H12 S128.

The 16-bit kernel (bf16, float16; Hopper's design) keeps q.k^T in float32
from the tensor cores, applies the scale and the bias in one rounding,
takes p as 2^(s log2 e - m log2 e) with the row max folded into one fmaf,
and rounds the dropped p to the type for p.v: o within two ulps of the
type of max|o|, lse within TOL_LSE."""

import math

import pytest
import torch

from chip_smoke import TOL_F32, TOL_LSE, padding_bias
from paddle_tpu_torch.ops.cuda import flash_attention as FA
from test_torch_flash_bwd_numerics import REL16, mm_3xtf32, mm_fma_chain

D = 64
TILE = 64                 # keys a stage at head dim 64 (csrc FwdTile)
RATE = 0.1
LOG2E = torch.tensor(math.log2(math.e), dtype=torch.float32)


def forward(q, k, v, bias, causal, mm_s, rate=0.0, seed=None):
    """(o, lse) by the kernel's recurrence over key tiles, the score
    product taken by ``mm_s`` and p.v in 3xTF32."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(d), dtype=torch.float32)
    keep = FA.dropout_keep(seed, rate, bh, sq, sk) if rate else None
    inv_keep = torch.tensor(FA.dropout_params(rate)[1], dtype=torch.float32)
    m = torch.full((bh, sq, 1), FA.NEG_INF)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, TILE):
        cols = torch.arange(k0, min(sk, k0 + TILE))[None, :]
        s = mm_s(q, k[:, k0:k0 + TILE].transpose(1, 2)) * scale
        if bias is not None:
            s = s + bias[:, :, k0:k0 + TILE].repeat_interleave(
                bh // bias.shape[0], 0)
        if causal:
            s = s.masked_fill(cols > rows, FA.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[:, :, k0:k0 + TILE], p * inv_keep,
                            torch.zeros(()))
        acc = acc * alpha + mm_3xtf32(p, v[:, k0:k0 + TILE])
        m = m_new
    o = acc / l.clamp_min(1e-30)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, math.inf))
    return o, lse


def f32(x):
    """float64 -> float32, one rounding (what a single float32 FMA gives
    for an exact float64 intermediate)"""
    return x.to(torch.float32)


def ex2(x):
    """2^x of float32 x, rounded to float32 (MUFU.EX2 to ~2 ulps)"""
    return f32(torch.exp2(x.double()))


def forward16(q, k, v, bias, causal, rate=0.0, seed=None):
    """(o, lse) as the 16-bit kernel (flash_fwd_sm90_kernel) computes
    them over 64-key tiles: q.k^T accumulated in float32, the scale and
    the bias in one rounding (fmaf), p = 2^(s log2 e - m log2 e) with the
    row max folded into one fmaf, the dropped p rounded to the type for
    p.v, float32 accumulation."""
    bh, sq, d = q.shape
    sk = k.shape[1]
    scale = 1.0 / math.sqrt(d)
    keep = FA.dropout_keep(seed, rate, bh, sq, sk) if rate else None
    inv_keep = torch.tensor(FA.dropout_params(rate)[1], dtype=torch.float32)
    m = torch.full((bh, sq, 1), FA.NEG_INF)
    l = torch.zeros(bh, sq, 1)
    acc = torch.zeros(bh, sq, d)
    rows = torch.arange(sq)[:, None]
    for k0 in range(0, sk, TILE):
        cols = torch.arange(k0, min(sk, k0 + TILE))[None, :]
        x = q.float() @ k[:, k0:k0 + TILE].float().transpose(1, 2)
        s = x.double() * scale
        if bias is not None:
            s = s + bias[:, :, k0:k0 + TILE].repeat_interleave(
                bh // bias.shape[0], 0).double()
        s = f32(s)
        if causal:
            s = s.masked_fill(cols > rows, FA.NEG_INF)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        alpha = ex2((m - m_new) * LOG2E)
        p = ex2(f32(s.double() * LOG2E.double() -
                    (m_new * LOG2E).double()))
        l = l * alpha + p.sum(-1, keepdim=True)
        if keep is not None:
            p = torch.where(keep[:, :, k0:k0 + TILE], p * inv_keep,
                            torch.zeros(()))
        acc = acc * alpha + p.to(v.dtype).float() @ v[:, k0:k0 + TILE].float()
        m = m_new
    o = (acc / l.clamp_min(1e-30)).to(q.dtype)
    lse = torch.where(l > 0, m + torch.log(l.clamp_min(1e-30)),
                      torch.full_like(l, math.inf))
    return o, lse


def problem(mode, bsz=2, heads=2, seq=128, dtype=torch.float32):
    gen = torch.Generator().manual_seed(8)
    q, k, v = (torch.randn(bsz * heads, seq, D, generator=gen).to(dtype)
               for _ in range(3))
    causal = mode == "causal"
    bias = None if causal else padding_bias(torch, gen, torch.device("cpu"),
                                            bsz, seq)
    return q, k, v, bias, causal


def errors(got, ref):
    (o, lse), (po, plse) = got, ref
    return (float((o - po).abs().max()),
            float(((lse - plse).abs() / plse.abs().clamp_min(1.0)).max()))


@pytest.mark.parametrize("mode,rate", [("padding-bias", 0.0),
                                       ("padding-bias", RATE),
                                       ("causal", RATE)])
def test_float32_kernel_arithmetic_holds_the_forward_tolerances(mode, rate):
    q, k, v, bias, causal = problem(mode)
    seed = torch.tensor([31], dtype=torch.int32)
    ref = FA.flash_fwd_plain(q, k, v, bias, causal, rate, seed)
    err_o, err_lse = errors(forward(q, k, v, bias, causal, mm_fma_chain,
                                    rate, seed), ref)
    tf32_o, tf32_lse = errors(forward(q, k, v, bias, causal, mm_3xtf32,
                                      rate, seed), ref)
    print(f"{mode} dropout {rate}: kernel arithmetic o {err_o:.3e}, lse "
          f"{err_lse:.3e}; q.k^T in 3xTF32 too (reported) o {tf32_o:.3e}, "
          f"lse {tf32_lse:.3e}; TOL_F32 {TOL_F32}, TOL_LSE {TOL_LSE}")
    assert err_o <= TOL_F32, err_o
    assert err_lse <= TOL_LSE, err_lse


@pytest.mark.parametrize("mode,rate", [("padding-bias", 0.0),
                                       ("padding-bias", RATE),
                                       ("causal", RATE)])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
def test_16bit_kernel_arithmetic_holds_the_forward_tolerances(dtype, mode,
                                                              rate):
    """The 16-bit kernel's arithmetic (forward16) against the twin: o
    within two ulps of the type of max|o| (bf16: BF16_REL), lse within
    TOL_LSE of max(1, |lse|)."""
    q, k, v, bias, causal = problem(mode, dtype=dtype)
    seed = torch.tensor([31], dtype=torch.int32)
    ref = FA.flash_fwd_plain(q, k, v, bias, causal, rate, seed)
    o, lse = forward16(q, k, v, bias, causal, rate, seed)
    err_o = float((o.float() - ref[0].float()).abs().max()) / float(
        ref[0].float().abs().max())
    err_lse = float(((lse - ref[1]).abs() / ref[1].abs().clamp_min(1.0))
                    .max())
    print(f"{dtype} {mode} dropout {rate}: o {err_o:.3e} of max|o|, lse "
          f"{err_lse:.3e}; tolerances {REL16[dtype]}, {TOL_LSE}")
    assert err_o <= REL16[dtype] and err_lse <= TOL_LSE, (err_o, err_lse)


def test_3xtf32_scores_at_bert_base_shape_reported():
    """At B32 H12 S128 with BERT's padding bias: the shipped arithmetic and
    3xTF32 scores against the twin and against the forward in float64.
    Reported; asserted only that the shipped arithmetic holds TOL_F32 and
    TOL_LSE there and that each stays finite."""
    q, k, v, bias, causal = problem("padding-bias", bsz=32, heads=12)
    ref = FA.flash_fwd_plain(q, k, v, bias, causal)
    exact = FA.flash_fwd_plain(q.double(), k.double(), v.double(),
                               bias.double(), causal)
    kernel = forward(q, k, v, bias, causal, mm_fma_chain)
    all3x = forward(q, k, v, bias, causal, mm_3xtf32)

    def vs64(got):
        return errors((got[0].double(), got[1].double()), exact)
    report = {"kernel arithmetic vs twin": errors(kernel, ref),
              "q.k^T in 3xTF32 vs twin": errors(all3x, ref),
              "float32 twin vs float64": vs64(ref),
              "kernel arithmetic vs float64": vs64(kernel),
              "q.k^T in 3xTF32 vs float64": vs64(all3x)}
    print("B32 H12 S128 padding bias, (o max|d|, lse max|d|/max(1,|lse|)): "
          + "; ".join(f"{k} {v[0]:.3e} {v[1]:.3e}"
                      for k, v in report.items())
          + f"; TOL_F32 {TOL_F32}, TOL_LSE {TOL_LSE}")
    for errs in report.values():
        assert all(math.isfinite(e) for e in errs)
    err_o, err_lse = report["kernel arithmetic vs twin"]
    assert err_o <= TOL_F32 and err_lse <= TOL_LSE
