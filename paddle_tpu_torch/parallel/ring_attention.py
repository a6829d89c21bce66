"""Ring attention — sequence/context parallelism over the ranks of a
sequence axis, the port of paddle_tpu/parallel/ring_attention.py.

Every rank holds the full Q of its sequence shard and rotates K/V shards
around the ``sp`` ring (:class:`~..ops.collective_ops.RingShift`, one
batch of point-to-point pairs a step), keeping the online-softmax
accumulators (m, l, acc) as flash attention does, so the full S x S score
matrix never exists.  The valid-key mask travels around the ring with
K/V; causal masking uses global positions.

Two inner steps share the (m, l, acc) carry, as in the JAX package:

* the flash kernels (``ops/cuda/flash_attention.py``
  ``flash_attention_with_lse``) on each rotated K/V shard: the masks enter
  as an additive bias of -1e30 built per block, the kernel returns
  (o, lse) with lse differentiable, and the merge is the logsumexp
  combine ``acc·exp(m − m') + o_blk·exp(lse − m')``;
* the plain composition of the scores (einsum) — the kernel's flag off,
  or an explicit per-block ``bias``.

The gradient comes from autograd through the merge and the shifts (a
shift's backward shifts the other way); the flash step's lse cotangent
folds into its backward kernels as delta − dlse.  The ring applies no
attention dropout, as in the JAX package.  A row whose keys are masked
in every block comes out as the uniform mean of V."""

from __future__ import annotations

import math
from typing import Optional

import torch

from ..framework.errors import UnimplementedError

_NEG = -1e30


def _flash_auto(s_loc, d, dtype, bias, device) -> bool:
    """The gate for direct callers, the rule of the op's
    ``ring_flash_attention`` route (which decides for the op and passes
    ``use_flash``): the flag off takes the plain step; else the kernels'
    rules on the local shard, an explicit ``bias`` rejected (its
    per-source-block semantics are the plain step's).  CPU tensors the
    gate rejects take the plain step; tensors on the card raise, as the
    port runs no plain fallback there."""
    from ..flags import flag
    if not flag("use_flash_attention"):
        return False
    if bias is not None:
        ok, why = False, "ring-explicit-bias"
    else:
        from ..ops.cuda.flash_attention import supported
        ok, why = supported(s_loc, s_loc, d, dtype)
    if ok or device.type == "cpu":
        return ok
    raise UnimplementedError(
        f"ring_attention on {device}: the flash kernels reject this input "
        f"({why}), and the port runs no plain fallback on the card; pass "
        f"use_flash=False or turn use_flash_attention off to ask for the "
        f"plain composition")


def _ring_group(axis_name, group):
    """The process group the ring runs over: ``group``, or ``axis_name``
    itself when it is one; None (one rank) otherwise."""
    if group is not None:
        return group
    from ..ops.collective_ops import DataParallelGroup
    return axis_name if isinstance(axis_name, DataParallelGroup) else None


def ring_attention(q, k, v, axis_name, bias: Optional[torch.Tensor] = None,
                   causal: bool = False,
                   kv_mask: Optional[torch.Tensor] = None,
                   use_flash: Optional[bool] = None,
                   interpret: bool = False, group=None):
    """Blockwise ring attention.

    Args:
      q, k, v: [B, H, S_local, D] — this rank's sequence shard.
      axis_name: the sequence axis to ring over (its group is ``group``);
        a ``DataParallelGroup`` may stand in for both.
      bias: optional additive bias for the LOCAL block grid, broadcastable
        to [B, H, S_local, S_local], applied to every source block (forces
        the plain inner step).
      causal: causal masking by global positions.
      kv_mask: [B, S_local] 0/1 valid-key mask of the local shard; travels
        around the ring with K/V.
      use_flash: inner step on the flash kernels (None: the flag and the
        kernels' gate, :func:`_flash_auto`; False: the plain step, on any
        device).  The flash step takes no explicit ``bias``.
      interpret: the JAX package's Pallas interpret mode; the port's CPU
        tensors run the kernels' plain twins, so it changes nothing.
      group: the ``DataParallelGroup`` of ``axis_name``'s ranks, this rank
        at its index (None: one rank).

    Returns [B, H, S_local, D] in q's dtype."""
    from ..ops.collective_ops import RingShift, ring_shift
    from ..ops.cuda.flash_attention import flash_attention_with_lse
    g = _ring_group(axis_name, group)
    n = g.world if g is not None else 1
    my = g.rank if g is not None else 0
    b, h, s_loc, d = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(d)
    if use_flash is None:
        use_flash = _flash_auto(s_loc, d, q.dtype, bias, dev)
    elif use_flash and bias is not None:
        raise UnimplementedError(
            "ring_attention: the flash inner step takes no explicit bias "
            "(ring-explicit-bias); pass use_flash=False")
    m = torch.full((b, h, s_loc), -math.inf, dtype=torch.float32,
                   device=dev)
    l = torch.zeros((b, h, s_loc), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, h, s_loc, d), dtype=torch.float32, device=dev)
    msk = kv_mask if kv_mask is not None else torch.ones(
        (b, s_loc), dtype=torch.float32, device=dev)
    q_pos = my * s_loc + torch.arange(s_loc, device=dev)
    kv = torch.stack([k, v])
    for i in range(n):
        src = (my - i) % n               # owner of this K/V block
        k_blk, v_blk = kv.unbind(0)
        visible = None
        if causal:
            k_pos = src * s_loc + torch.arange(s_loc, device=dev)
            visible = q_pos[:, None] >= k_pos[None, :]
        if use_flash:
            blk_bias = (1.0 - msk.to(torch.float32))[:, None, None, :] * _NEG
            if visible is not None:
                zero = torch.zeros((), dtype=torch.float32, device=dev)
                blk_bias = blk_bias + torch.where(
                    visible, zero, zero + _NEG)[None, None]
            o_blk, lse = flash_attention_with_lse(q, k_blk, v_blk, blk_bias)
            # exp(lse) is the block's softmax mass, o_blk its normalised
            # sum: the same merge as the plain step with the whole block
            # standing in for its score rows
            m_new = torch.maximum(m, lse)
            corr = torch.exp(m - m_new)
            w = torch.exp(lse - m_new)
            l = l * corr + w
            acc = acc * corr[..., None] + o_blk.to(torch.float32) * \
                w[..., None]
        else:
            s = torch.matmul(q.to(torch.float32),
                             k_blk.to(torch.float32).transpose(-1, -2))
            s = s * scale
            if bias is not None:
                s = s + bias.to(s.dtype)
            neg = torch.full((), _NEG, dtype=s.dtype, device=dev)
            s = torch.where(msk[:, None, None, :].to(torch.bool), s, neg)
            if visible is not None:
                s = torch.where(visible[None, None], s, neg)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.matmul(
                p.to(v_blk.dtype).to(torch.float32),
                v_blk.to(torch.float32))
        m = m_new
        if i < n - 1:
            # the last block's shift would only be discarded
            kv = RingShift.apply(kv.contiguous(), g, 1)
            msk = ring_shift(g, msk.contiguous(), 1)
    safe_l = torch.where(l > 0, l, torch.ones((), dtype=l.dtype,
                                              device=dev))
    return (acc / safe_l[..., None]).to(q.dtype)
