"""Device-side sampling for the chained decode loop — the port of
paddle_tpu/ops/sampling_ops.py.

The chained decode runtime (serving/decode.py, executor.lower_decode_chain)
keeps the whole token loop on the device, so sampling is a tensor function
of the logits and per-sequence policy feeds, with no host round trip:

* **greedy compatibility** — a row with ``temperature <= 0`` returns the
  body's own argmax tokens bit for bit, so greedy requests co-batched with
  sampling requests keep the token-for-token contract;
* **temperature / top-k / top-p** — logits are temperature-scaled, then
  restricted to the intersection of the top-k set (``top_k > 0``) and the
  top-p nucleus (``top_p > 0``), with the JAX package's thresholds; the
  draw is a Gumbel-argmax over the surviving logits;
* **per-sequence keys** — the JAX package folds (seed, position) into a
  threefry key, which PyTorch cannot reproduce.  Here the Gumbel noise of
  vocabulary entry ``v`` comes from Philox-4x32-10 (the flash kernels'
  generator, ``cuda/flash_attention.py philox_words``) with counter
  ``(v, position, 0, 0)`` under key ``(seed, 0)``: a function of the
  request's seed and the absolute position alone, so a fixed-seed request
  draws the same tokens whatever batch row, chain boundary or scheduling
  round it rides.  The tokens drawn differ from the JAX package's; the
  policy (which tokens may be drawn) is the same.

``decode_chain`` itself is a marker op: the executor consumes it
(``lower_decode_chain``); its registered impl only raises."""

from __future__ import annotations

import math

import torch

from .cuda.flash_attention import philox_words
from .registry import register

_U32 = 0xFFFFFFFF


def chain_row_noise(seeds, positions, vocab: int):
    """Gumbel noise ``[B, vocab]``: entry (b, v) from word 0 of the Philox
    draw of counter (v, positions[b]) under key seeds[b] — deterministic
    in (seed, absolute position) alone."""
    dev = seeds.device
    cols = torch.arange(vocab, dtype=torch.int64, device=dev)[None, :]
    pos = positions.to(torch.int64)[:, None] & _U32
    zero = torch.zeros((), dtype=torch.int64, device=dev)
    w0 = philox_words(seeds.to(torch.int64)[:, None] & _U32, cols, pos,
                      zero)[0]
    # 24 high bits as a float32 in (0, 1), then -log(-log(u))
    u = ((w0 >> 8).to(torch.float32) + 0.5) * (1.0 / (1 << 24))
    return -torch.log(-torch.log(u))


def sample_filter(logits, temperature, top_k, top_p):
    """Temperature-scaled ``[B, V]`` logits with every token outside the
    top-k set and the top-p nucleus at -inf (``top_k <= 0`` / ``top_p <=
    0`` disable their filter).  The nucleus keeps a token while the mass
    strictly before it is below p, so the top token always survives."""
    logits = logits.to(torch.float32)
    b, v = logits.shape
    temperature = temperature.to(torch.float32)
    scaled = logits / temperature.clamp_min(1e-6)[:, None]
    # one descending sort; both filters become thresholds on it
    sorted_desc = torch.sort(scaled, dim=-1, descending=True).values
    top_k = top_k.to(torch.int64)
    k = torch.where(top_k > 0, top_k, torch.full_like(top_k, v)).clamp(1, v)
    kth = sorted_desc.gather(1, (k - 1)[:, None])
    probs_sorted = torch.softmax(sorted_desc, dim=-1)
    cum = torch.cumsum(probs_sorted, dim=-1)
    top_p = top_p.to(torch.float32)
    p = torch.where(top_p > 0.0, top_p, torch.ones_like(top_p))[:, None]
    keep = (cum - probs_sorted) < p
    inf = torch.full((), math.inf, device=logits.device)
    p_thr = torch.where(keep, sorted_desc, inf).amin(dim=-1, keepdim=True)
    thr = torch.maximum(kth, p_thr)
    return torch.where(scaled >= thr, scaled, -inf)


def sample_chain_tokens(logits, greedy_tokens, temperature, top_k, top_p,
                        seeds, positions):
    """One sampling step over ``[B, V]`` logits with per-row policies.
    Rows with ``temperature <= 0`` return ``greedy_tokens`` (the body's
    argmax, ``[B]``) unchanged; the others a Gumbel-argmax over
    :func:`sample_filter`'s survivors.  Returns ``[B]`` tokens in
    ``greedy_tokens``' dtype."""
    masked = sample_filter(logits, temperature, top_k, top_p)
    noise = chain_row_noise(seeds, positions, masked.shape[1])
    sampled = torch.argmax(masked + noise, dim=-1).to(greedy_tokens.dtype)
    return torch.where(temperature <= 0.0, greedy_tokens, sampled)


@register("decode_chain")
def _decode_chain(ctx, ins, attrs):
    raise RuntimeError(
        "decode_chain is a marker: the executor runs the program around it "
        "chain_length times on the device (executor.lower_decode_chain). "
        "Running it through the plain op loop means the program was "
        "executed without a prepared decode step — use DecodeEngine / "
        "Executor.prepare.")


__all__ = ["sample_chain_tokens", "sample_filter", "chain_row_noise"]
