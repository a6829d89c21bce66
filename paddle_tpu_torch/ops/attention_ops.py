"""Fused attention op — the port of paddle_tpu/ops/attention_ops.py (the
plain branch; the paged-cache and sequence-parallel branches come with
the decode and multi-GPU slices).

One op takes projected Q/K/V in (B, S, H*D) layout plus an additive
attention bias and produces the context in (B, S, H*D).  The
``flash_attention`` route runs the hand-written flash kernels
(ops/cuda/flash_attention.py): the forward, and under autograd the dq and
dk/dv kernels as its backward.  In training the dropout mask is drawn
inside the kernels from one int32 seed per op per run, taken from the
run's generator on the device.  With the route's flag off, or on CPU
tensors the kernels reject, :func:`reference_attention` — the JAX
package's composition — computes it; on the card such an input raises
(``registry.cuda_route``)."""

from __future__ import annotations

import math

import torch

from .cuda import flash_attention as cuda_flash
from .registry import cuda_route, register, x


def _split_heads(t, n_head):
    b, s, hd = t.shape
    return t.reshape(b, s, n_head, hd // n_head).permute(0, 2, 1, 3)


def _merge_heads(t):
    b, h, s, d = t.shape
    return t.permute(0, 2, 1, 3).reshape(b, s, h * d)


def resolve_heads(q, attrs):
    """A caller may pass the global head count + head_dim; the local head
    count then follows from the width."""
    n_head = attrs["n_head"]
    head_dim = attrs.get("head_dim")
    if head_dim:
        n_head = max(1, int(q.shape[-1]) // int(head_dim))
    return n_head


def attn_bias(ins):
    """The additive bias: explicit AttnBias, else derived from the [B, S]
    0/1 valid-key KVMask."""
    bias = x(ins, "AttnBias")
    if bias is None:
        kv_mask = x(ins, "KVMask")
        if kv_mask is not None:
            bias = (1.0 - kv_mask.float())[:, None, None, :] * -1e9
    return bias


def reference_attention(q, k, v, bias, n_head, dropout_rate, ctx, is_test,
                        causal=False):
    """Plain attention, numerically the spec for the flash kernel."""
    d_key = q.shape[-1] // n_head
    qh, kh, vh = (_split_heads(t, n_head) for t in (q, k, v))
    scores = torch.matmul(qh.float(), kh.float().transpose(-1, -2))
    scores = scores * (1.0 / math.sqrt(d_key))
    if bias is not None:
        scores = scores + bias.float()
    if causal:
        sq, sk = scores.shape[-2], scores.shape[-1]
        tri = torch.full((sq, sk), -1e9, dtype=scores.dtype,
                         device=scores.device).triu(1)
        scores = scores + tri
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate and not is_test:
        keep = torch.empty(probs.shape, device=probs.device).bernoulli_(
            1.0 - dropout_rate, generator=ctx.generator).bool()
        probs = torch.where(keep, probs / (1.0 - dropout_rate),
                            torch.zeros((), device=probs.device))
    ctxv = torch.matmul(probs.to(vh.dtype).float(), vh.float()).to(vh.dtype)
    return _merge_heads(ctxv)


def dropout_seed(ctx):
    """One int32 seed for the flash kernels' dropout mask, drawn from the
    run's generator straight onto the run's device (no host sync), so the
    mask changes every step while forward and backward agree."""
    return torch.randint(0, 2 ** 31 - 1, (1,), generator=ctx.generator,
                         device=ctx.device, dtype=torch.int32)


def lower_flash_attention(ctx, ins, attrs):
    """The ``flash_attention`` route: the kernels on head-split operands
    (``cuda_route`` has checked that the kernels take the shape)."""
    q, k, v = x(ins, "Q"), x(ins, "K"), x(ins, "V")
    n_head = resolve_heads(q, attrs)
    is_test = attrs.get("is_test", False) or ctx.is_test
    rate = 0.0 if is_test else float(attrs.get("dropout_rate", 0.0))
    out = cuda_flash.flash_attention_bshd(
        _split_heads(q, n_head), _split_heads(k, n_head),
        _split_heads(v, n_head), attn_bias(ins), dropout_rate=rate,
        causal=bool(attrs.get("causal", False)),
        seed=dropout_seed(ctx) if rate else None)
    return {"Out": _merge_heads(out)}


@register("fused_attention")
def _fused_attention(ctx, ins, attrs):
    if x(ins, "KPool") is not None or attrs.get("_seq_axis"):
        raise NotImplementedError(
            "fused_attention: the paged-cache and sequence-parallel "
            "branches are not ported yet (decode and multi-GPU slices)")
    q, k, v = x(ins, "Q"), x(ins, "K"), x(ins, "V")
    is_test = attrs.get("is_test", False) or ctx.is_test
    route, _ = cuda_route("fused_attention", ins,
                          dict(attrs, is_test=is_test),
                          kernel="flash_attention")
    if route is not None:
        return lower_flash_attention(ctx, ins, attrs)
    return {"Out": reference_attention(
        q, k, v, attn_bias(ins), resolve_heads(q, attrs),
        attrs.get("dropout_rate", 0.0), ctx, is_test,
        causal=bool(attrs.get("causal", False)))}
