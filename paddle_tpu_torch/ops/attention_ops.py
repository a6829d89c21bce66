"""Fused attention op — the port of paddle_tpu/ops/attention_ops.py (the
plain, paged-cache and sequence-parallel branches).

One op takes projected Q/K/V in (B, S, H*D) layout plus an additive
attention bias and produces the context in (B, S, H*D).  The
``flash_attention`` route runs the hand-written flash kernels
(ops/cuda/flash_attention.py): the forward, and under autograd the dq and
dk/dv kernels as its backward.  In training the dropout mask is drawn
inside the kernels from one int32 seed per op per run, taken from the
run's generator on the device.  With the route's flag off, or on CPU
tensors the kernels reject, :func:`reference_attention` — the JAX
package's composition — computes it; on the card such an input raises
(``registry.cuda_route``).

The paged-cache branch (``KPool``/``VPool``/``BlockTable``/``CtxLen``
inputs, serving/decode.py) gathers K and V through the block table and
runs the same forward kernel on the gathered context through the
``cached_flash_attention`` route, decode steps (one query row) included.

The sequence-parallel branch (``_seq_axis`` naming an axis of the run:
Q/K/V hold this rank's sequence shard) rings K/V over that axis
(``parallel/ring_attention.py``): the ``ring_flash_attention`` route runs
each block on the flash kernels with a differentiable lse, its flag off
the plain composition.  As in the JAX package the ring applies no
attention dropout.  A ``_seq_axis`` the run does not have takes the plain
branch."""

from __future__ import annotations

import math

import torch

from .cache_ops import ctx_len_bias, gather_cache
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


def _check_q_pos(q, q_pos):
    """The JAX package's static spec of QPos (``_infer_fused_attention``),
    checked on the tensors: one absolute position per query, [B, Sq]."""
    if q_pos.dim() != 2 or tuple(q_pos.shape) != tuple(q.shape[:2]):
        raise ValueError(
            f"fused_attention: QPos {list(q_pos.shape)} must match Q's "
            f"[B, Sq] = {list(q.shape[:2])} (per-query absolute positions "
            f"of the chunked-prefill causal mask)")


def lower_cached_attention(ctx, ins, attrs, use_flash=False):
    """Cache-read attention for the paged decode runtime: K/V come from
    the block pools through the per-sequence block table instead of a
    fresh projection.  ``use_flash`` (the ``cached_flash_attention``
    route) hands the gathered context to the flash forward kernel;
    otherwise :func:`reference_attention` computes it.  Both read the
    cache identically, so routing never changes which bytes attention
    sees.

    Positions at or beyond ``CtxLen`` (padded table entries, reused blocks
    carrying another sequence's leftovers) get a -1e9 bias: an exactly
    zero softmax weight, which keeps co-batched and block-reuse results
    equal to a lone run.  The optional ``QPos`` input ([B, Sq] absolute
    query positions, chunked prefill) adds a per-query causal term: key
    position t is visible to query position p iff ``t <= p``.  Valid pairs
    still get an exactly zero bias (0.0 + 0.0).  The bias is [B, 1, 1, T],
    or [B, 1, Sq, T] with QPos, shared by the heads."""
    q = x(ins, "Q")
    kpool, vpool = x(ins, "KPool"), x(ins, "VPool")
    table, ctx_len = x(ins, "BlockTable"), x(ins, "CtxLen")
    n_head = resolve_heads(q, attrs)
    keys = gather_cache(kpool, table)
    vals = gather_cache(vpool, table)
    bias = ctx_len_bias(ctx_len, keys.shape[1])
    q_pos = x(ins, "QPos")
    if q_pos is not None:
        _check_q_pos(q, q_pos)
        tpos = torch.arange(keys.shape[1], dtype=torch.int64,
                            device=q.device)[None, None, :]
        zero = torch.zeros((), dtype=bias.dtype, device=q.device)
        causal = torch.where(tpos <= q_pos.to(torch.int64)[:, :, None],
                             zero, zero - 1e9)
        bias = bias + causal[:, None, :, :]
    if use_flash:
        out = cuda_flash.flash_attention_bshd(
            _split_heads(q, n_head), _split_heads(keys, n_head),
            _split_heads(vals, n_head), bias)
        return {"Out": _merge_heads(out)}
    return {"Out": reference_attention(q, keys, vals, bias, n_head, 0.0, ctx,
                                       True, causal=False)}


def lower_ring_attention(ctx, ins, attrs, use_flash=False):
    """Sequence-parallel attention: the ring over the ``_seq_axis`` ranks,
    inner step on the flash kernels (the ``ring_flash_attention`` route)
    or the plain composition."""
    from ..parallel.ring_attention import ring_attention
    q, k, v = x(ins, "Q"), x(ins, "K"), x(ins, "V")
    n_head = resolve_heads(q, attrs)
    axis = attrs["_seq_axis"]
    out = ring_attention(
        _split_heads(q, n_head), _split_heads(k, n_head),
        _split_heads(v, n_head), axis, causal=attrs.get("causal", False),
        kv_mask=x(ins, "KVMask"), use_flash=use_flash,
        group=ctx.dp.over(axis))
    return {"Out": _merge_heads(out)}


@register("fused_attention")
def _fused_attention(ctx, ins, attrs):
    if x(ins, "KPool") is not None:
        # the paged-cache read: the route's match is the `_cached` stamp,
        # which every cache-reading instance carries
        route, _ = cuda_route("fused_attention", ins,
                              dict(attrs, _cached=True),
                              kernel="cached_flash_attention")
        return lower_cached_attention(ctx, ins, attrs,
                                      use_flash=route is not None)
    seq_axis = attrs.get("_seq_axis")
    if seq_axis and seq_axis in ctx.axis_names:
        route, _ = cuda_route("fused_attention", ins, attrs,
                              kernel="ring_flash_attention")
        return lower_ring_attention(ctx, ins, attrs,
                                    use_flash=route is not None)
    if seq_axis:
        # the axis is not in this run: the plain branch, as in the JAX op
        attrs = dict(attrs, _seq_axis=None)
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
