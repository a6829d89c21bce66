"""Paged KV-cache ops for the autoregressive decode runtime — the port of
paddle_tpu/ops/cache_ops.py.

* the cache is a preallocated pool of fixed-size blocks — one persistable
  per layer per K/V, shaped ``[num_blocks, block_size, hidden]``,
  allocated once when the decode engine starts;
* sequences own block tables (int32 feeds mapping their logical
  positions onto pool blocks), so a sequence's context can live in any
  scattered set of blocks and freed blocks are reusable at once;
* :func:`cache_write` scatters freshly projected K/V rows into pool slots
  through a host-computed flat slot-index feed (-1 drops the write);
* the read side lives on ``fused_attention`` (attention_ops.py): a
  ``KPool``/``VPool``/``BlockTable``/``CtxLen`` input set selects the
  gather-through-the-table variant.

The pools are the only persistables a decode program writes.  Under a
donated prepared step (``ctx.donate_state``) ``cache_write`` writes them
in place, so every prepared step sharing the scope sees one pool; a plain
run writes a copy."""

from __future__ import annotations

import torch

from .registry import register, x


def flat_slots(kpool_shape):
    """Total writable slots of a pool ``[num_blocks, block_size, H]``."""
    return int(kpool_shape[0]) * int(kpool_shape[1])


def _check_cache_write(kpool, vpool, k, slots):
    """The JAX package's static spec of the op (``_infer_cache_write``),
    checked on the tensors: K/V agree with the pool's hidden width and
    Slots with the K/V token count."""
    if kpool.dim() != 3 or vpool.shape != kpool.shape:
        raise ValueError(f"cache_write: pools must be [NB, BS, H] and "
                         f"equal, got {tuple(kpool.shape)} and "
                         f"{tuple(vpool.shape)}")
    if k.shape[-1] != kpool.shape[-1]:
        raise ValueError(f"cache_write: K hidden width {k.shape[-1]} != "
                         f"pool hidden width {kpool.shape[-1]}")
    if slots.numel() != k.numel() // k.shape[-1]:
        raise ValueError(f"cache_write: Slots covers {list(slots.shape)} "
                         f"tokens but K carries {list(k.shape[:-1])}")


def drop_lanes(idx):
    """``(targets, fill)`` for writing rows into a flat pool at the slots
    ``idx`` while leaving it bitwise unchanged where a slot is -1, with no
    host sync: each dropped lane is pointed at the slot of the first valid
    lane and carries that lane's own row, so duplicate targets write
    identical bytes; when no lane is valid every lane rewrites slot 0 with
    its current contents.  ``fill(flat_pool, rows)`` gives the rows to
    write.  (A boolean index would sync the host; a redirect to slot 0
    with a real row would race a valid write there.)"""
    valid = idx >= 0
    # the first valid lane, as a one-element index: a 0-d index tensor
    # would be read on the host
    first = torch.argmax(valid.to(torch.uint8)).reshape(1)
    any_valid = valid.index_select(0, first)
    first_slot = idx.index_select(0, first)
    targets = torch.where(valid, idx, torch.where(
        any_valid, first_slot, torch.zeros_like(first_slot)))

    def fill(flat_pool, rows):
        row = torch.where(any_valid[:, None], rows.index_select(0, first),
                          flat_pool[:1])
        return torch.where(valid[:, None], rows, row)

    return targets, fill


@register("cache_write")
def _cache_write(ctx, ins, attrs):
    """Scatter per-token K/V rows into the paged pools.

    Inputs: ``KPool``/``VPool`` ``[NB, BS, H]`` (persistable), ``K``/``V``
    ``[B, S, H]`` fresh projections, ``Slots`` ``[B, S]`` int flat slot
    ids (``block * BS + offset``; -1 = padding, dropped).  Outputs
    overwrite the pool vars: in place under ``donate_state``, else on a
    copy.  The drop semantics make one program serve every occupancy: a
    packed prefill writes every valid prompt token, a decode step one slot
    per live row, and warmup/pad rows write nothing, bitwise."""
    kpool, vpool = x(ins, "KPool"), x(ins, "VPool")
    k, v = x(ins, "K"), x(ins, "V")
    slots = x(ins, "Slots")
    _check_cache_write(kpool, vpool, k, slots)
    nslots = flat_slots(kpool.shape)
    h = kpool.shape[-1]
    if not ctx.donate_state:
        kpool, vpool = kpool.clone(), vpool.clone()
    targets, fill = drop_lanes(slots.reshape(-1).to(torch.int64))
    for pool, rows in ((kpool, k), (vpool, v)):
        flat = pool.view(nslots, h)
        flat.index_copy_(0, targets,
                         fill(flat, rows.reshape(-1, h).to(pool.dtype)))
    return {"KPoolOut": kpool, "VPoolOut": vpool}


def gather_cache(pool, block_table, block_size=None):
    """Gather a per-sequence context ``[B, T, H]`` out of the pool through
    the block table (``T = max_blocks_per_seq * block_size``).  Gathered
    values at valid positions are bitwise the written rows, which makes
    block identity transparent."""
    nb, bs, h = pool.shape
    if block_size is None:
        block_size = bs
    table = block_table.to(torch.int64)
    b, nseq = table.shape
    offs = torch.arange(block_size, dtype=torch.int64,
                        device=table.device)[None, None, :]
    idx = (table[:, :, None] * block_size + offs).reshape(-1)
    return pool.reshape(nb * bs, h).index_select(0, idx).reshape(b, -1, h)


def ctx_len_bias(ctx_len, total, dtype=torch.float32):
    """Additive attention bias ``[B, 1, 1, T]`` masking positions at or
    beyond each row's valid context length with -1e9 (exact-zero softmax
    weight after the exp underflow, so garbage gathered from padded table
    entries or reused blocks contributes bitwise nothing)."""
    pos = torch.arange(total, dtype=torch.int64,
                       device=ctx_len.device)[None, :]
    valid = pos < ctx_len.to(torch.int64)[:, None]
    zero = torch.zeros((), dtype=dtype, device=ctx_len.device)
    return torch.where(valid, zero, zero - 1e9)[:, None, None, :]


__all__ = ["gather_cache", "ctx_len_bias", "flat_slots", "drop_lanes"]
