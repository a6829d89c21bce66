"""Causal decoder-LM builders for the autoregressive decode runtime — the
port of paddle_tpu/models/decoder.py.

The decode engine (serving/decode.py) splits generation into programs over
a shared paged KV-cache, and this module builds them, plus the cache-free
scoring program that is the reference-shaped baseline, from one parameter
set (the BertConfig transformer stack with causal attention and a
tied-embedding LM head):

* **prefill** — ``[B, S]`` prompt rows (several prompts may share a row as
  segments, separated by one-hot mask channels; causal-safe because the
  block-diagonal segment bias composes with the in-op causal mask),
  writes every prompt token's K/V into the cache pools through the
  ``slot_ids`` feed and emits each segment's first generated token;
* **decode step** — ``[B, 1]``, one token per live sequence, appends its
  K/V to the pools and attends through the per-sequence block table;
* **chains** — the decode step plus a ``decode_chain`` marker that the
  executor runs ``chain_length`` times on the device;
* **chunk** — a ``[B, C]`` prompt slice that writes like prefill and reads
  through the block table like decode (chunked prefill, prefix hits);
* **score** — the same network with no cache ops: full-prefix scoring.

All declare the same parameter names, so one startup program (one scope)
serves them; the cache pools are plain persistables the engine fills with
zeros.  The programs are op for op and name for name the JAX package's,
so a desc built by either package is the same.  With ``moe_experts > 0``
every FFN is the routed MoE block (``parallel.moe_ffn``, built dense: a
served program carries no collective), the same expert weights in every
program; the routing runs inside the moe_dispatch / moe_expert_ffn /
moe_combine ops, so a chain body runs it like any other op.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional

from .. import layers
from ..framework.core import Program, program_guard
from ..framework.initializer import TruncatedNormalInitializer
from ..framework.layer_helper import LayerHelper, ParamAttr
from .bert import BertConfig


def _init(cfg):
    return TruncatedNormalInitializer(0.0, cfg.initializer_range)


def _attr(name, cfg):
    return ParamAttr(name=name, initializer=_init(cfg))


@dataclass
class DecoderPrograms:
    """One decoder parameter set lowered several ways (shared param
    names; ``startup`` initialises all of them once).  Beyond the
    prefill / decode-step / score triple, ``chains`` holds one
    device-chained decode program per configured chain length (the
    ``decode_chain`` marker op drives executor.lower_decode_chain) and
    ``chunk`` the [1, C] cache-read chunked-prefill program (absolute
    ``pos_ids`` double as the QPos causal feed)."""

    prefill: Program
    decode: Program
    score: Program
    startup: Program
    cache_vars: List[str]
    prefill_feeds: List[str]
    decode_feeds: List[str]
    score_feeds: List[str]
    fetch_names: List[str] = field(
        default_factory=lambda: ["next_logits", "next_tokens"])
    chains: Dict[int, Program] = field(default_factory=dict)
    chain_feeds: List[str] = field(default_factory=list)
    chain_fetch_names: List[str] = field(
        default_factory=lambda: ["chain_tokens"])
    chunk: Optional[Program] = None
    chunk_feeds: List[str] = field(default_factory=list)


class _Cache:
    """Per-build cache wiring: the pool vars of the CURRENT program plus
    the slot/table/length feeds the cache ops read."""

    def __init__(self, kpools, vpools, slots, table=None, ctx_len=None,
                 q_pos=None):
        self.kpools = kpools
        self.vpools = vpools
        self.slots = slots
        self.table = table
        self.ctx_len = ctx_len
        # absolute query positions ([B, Sq]) — chunked prefill reads the
        # cache with MORE context than the query's own position, so the
        # cached attention needs a per-query causal bound on top of the
        # per-sequence ctx_len bound
        self.q_pos = q_pos

    @property
    def read(self):
        return self.table is not None


def _cache_write(kpool, vpool, k, v, slots, name):
    helper = LayerHelper("cache_write", name=name)
    helper.append_op(type="cache_write",
                     inputs={"KPool": [kpool], "VPool": [vpool],
                             "K": [k], "V": [v], "Slots": [slots]},
                     outputs={"KPoolOut": [kpool], "VPoolOut": [vpool]})
    return kpool, vpool


def _attention(q, k, v, attn_bias, cfg, name, cache: Optional[_Cache],
               layer_idx):
    helper = LayerHelper("fused_attention", name=f"{name}_attn")
    out = helper.create_variable_for_type_inference(q.dtype, q.shape)
    attrs = {"n_head": cfg.num_attention_heads, "dropout_rate": 0.0,
             "is_test": True}
    if cache is not None and cache.read:
        inputs = {"Q": [q], "KPool": [cache.kpools[layer_idx]],
                  "VPool": [cache.vpools[layer_idx]],
                  "BlockTable": [cache.table], "CtxLen": [cache.ctx_len]}
        if cache.q_pos is not None:
            inputs["QPos"] = [cache.q_pos]
        attrs["_cached"] = True     # routes the cached_flash_attention leg
    else:
        inputs = {"Q": [q], "K": [k], "V": [v]}
        if attn_bias is not None:
            inputs["AttnBias"] = [attn_bias]
        attrs["causal"] = True
    helper.append_op(type="fused_attention", inputs=inputs,
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def _decoder_layer(x, attn_bias, cfg: BertConfig, name: str,
                   cache: Optional[_Cache], layer_idx: int):
    """Post-LN transformer layer (the bert.encoder_layer recipe) with
    the attention swapped for the cache-aware path."""
    d = cfg.hidden_size
    qkv = layers.fc(x, 3 * d, num_flatten_dims=2,
                    param_attr=_attr(f"{name}_qkv_w", cfg),
                    bias_attr=ParamAttr(name=f"{name}_qkv_b"))
    q, k, v = layers.split(qkv, 3, dim=2)
    if cache is not None:
        _cache_write(cache.kpools[layer_idx], cache.vpools[layer_idx],
                     k, v, cache.slots, name=f"{name}_kv")
    ctx = _attention(q, k, v, attn_bias, cfg, name, cache, layer_idx)
    attn_out = layers.fc(ctx, d, num_flatten_dims=2,
                         param_attr=_attr(f"{name}_out_w", cfg),
                         bias_attr=ParamAttr(name=f"{name}_out_b"))
    x = layers.layer_norm(x + attn_out, begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"{name}_ln1_scale"),
                          bias_attr=ParamAttr(name=f"{name}_ln1_bias"))
    if cfg.moe_experts:
        # the routed MoE FFN, built dense (ep_degree None: a served
        # program is collective-free), one set of expert weights by name
        # across the prefill / decode / chain / chunk programs
        from ..parallel import moe_ffn
        ffn, _aux = moe_ffn(
            x, num_experts=cfg.moe_experts,
            ffn_hidden=cfg.intermediate_size, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, act=cfg.hidden_act,
            group_size=cfg.moe_group_size,
            param_attr=_attr(f"{name}_moe", cfg),
            bias_attr=ParamAttr(name=f"{name}_moe_b"),
            name=f"{name}_moe")
    else:
        ffn = layers.fc(x, cfg.intermediate_size, num_flatten_dims=2,
                        act=cfg.hidden_act,
                        param_attr=_attr(f"{name}_ffn1_w", cfg),
                        bias_attr=ParamAttr(name=f"{name}_ffn1_b"))
        ffn = layers.fc(ffn, d, num_flatten_dims=2,
                        param_attr=_attr(f"{name}_ffn2_w", cfg),
                        bias_attr=ParamAttr(name=f"{name}_ffn2_b"))
    return layers.layer_norm(x + ffn, begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{name}_ln2_scale"),
                             bias_attr=ParamAttr(name=f"{name}_ln2_bias"))


def _embed(src_ids, pos_ids, cfg: BertConfig, lift_1d: bool = False):
    """Token + position embeddings → ``[B, S, H]``.  ``lift_1d`` serves
    the decode step, whose ids arrive 1-D (``[B]`` — one token per live
    sequence) and whose hiddens must still be sequence-major."""
    emb = layers.embedding(src_ids,
                           size=[cfg.vocab_size, cfg.hidden_size],
                           dtype=cfg.dtype,
                           param_attr=_attr("word_embedding", cfg))
    pos = layers.embedding(pos_ids,
                           size=[cfg.max_position_embeddings,
                                 cfg.hidden_size], dtype=cfg.dtype,
                           param_attr=_attr("pos_embedding", cfg))
    x = emb + pos
    if lift_1d:
        x = layers.unsqueeze(x, axes=[1])
    return layers.layer_norm(
        x, begin_norm_axis=2,
        param_attr=ParamAttr(name="pre_decoder_ln_scale"),
        bias_attr=ParamAttr(name="pre_decoder_ln_bias"))


def _lm_head(h2d, cfg: BertConfig):
    """Tied-embedding LM head on ``[N, H]`` hiddens → (logits [N, V],
    greedy next tokens [N])."""
    word_emb = h2d.block.program.global_block().var("word_embedding")
    helper = LayerHelper("lm_out")
    bias = helper.create_parameter(ParamAttr(name="lm_out_bias"),
                                   [cfg.vocab_size], cfg.dtype,
                                   is_bias=True)
    logits = layers.matmul(h2d, word_emb, transpose_y=True)
    logits = layers.elementwise_add(logits, bias)
    block = h2d.block
    out_logits = block.create_var(name="next_logits",
                                  shape=logits.shape, dtype=logits.dtype)
    helper.append_op(type="assign", inputs={"X": [logits]},
                     outputs={"Out": [out_logits]})
    tokens = layers.argmax(out_logits, axis=-1)
    out_tokens = block.create_var(name="next_tokens",
                                  shape=tokens.shape, dtype=tokens.dtype)
    helper.append_op(type="assign", inputs={"X": [tokens]},
                     outputs={"Out": [out_tokens]})
    return out_logits, out_tokens


def _mask_bias(input_mask):
    """The PR 7 segment recipe: ``matmul(mask, mask^T)`` over the
    one-hot channel axis is exactly block-diagonal across segments, so
    co-packed prompts get exactly-zero attention into each other; the
    in-op causal mask composes on top (causality on row positions
    restricted to the diagonal blocks = per-segment causality)."""
    mask_sq = layers.matmul(input_mask, input_mask, transpose_y=True)
    attn_bias = layers.scale(mask_sq, scale=1e4, bias=-1e4)
    attn_bias = layers.unsqueeze(attn_bias, axes=[1])
    attn_bias.stop_gradient = True
    return attn_bias


def _gather_last(x, last_pos, cfg):
    helper = LayerHelper("gather_last")
    out = helper.create_variable_for_type_inference(
        x.dtype, (-1, cfg.hidden_size))
    helper.append_op(type="gather_tokens",
                     inputs={"X": [x], "Index": [last_pos]},
                     outputs={"Out": [out]})
    return out


class BertDecoder:
    """BERT-tiny-decoder model family for :class:`DecodeEngine`.

    ``build(num_blocks, block_size, max_blocks_per_seq,
    pack_max_segments)`` returns the prefill / decode-step / score
    program triple over cache pools of the given geometry.  Build order
    and naming are deterministic, so two processes (and the two packages)
    building the same config produce the same programs."""

    def __init__(self, cfg: Optional[BertConfig] = None,
                 name: str = "decoder", seed: int = 0):
        self.cfg = cfg or BertConfig.tiny()
        self.name = name
        self.seed = seed

    # -- cache pools ------------------------------------------------------
    def cache_var_names(self) -> List[str]:
        out = []
        for i in range(self.cfg.num_hidden_layers):
            out += [f"{self.name}_k_cache_{i}", f"{self.name}_v_cache_{i}"]
        return out

    def cache_block_bytes(self, block_size: int) -> int:
        """On-device bytes ONE pool block costs across every layer and
        both K/V pools — the unit the admission ledger prices."""
        import numpy as np
        width = np.dtype(self.cfg.dtype).itemsize
        return (2 * self.cfg.num_hidden_layers * block_size *
                self.cfg.hidden_size * width)

    def _declare_pools(self, block, num_blocks, block_size):
        kpools, vpools = [], []
        for i in range(self.cfg.num_hidden_layers):
            shape = (num_blocks, block_size, self.cfg.hidden_size)
            kpools.append(block.create_var(
                name=f"{self.name}_k_cache_{i}", shape=shape,
                dtype=self.cfg.dtype, persistable=True))
            vpools.append(block.create_var(
                name=f"{self.name}_v_cache_{i}", shape=shape,
                dtype=self.cfg.dtype, persistable=True))
        return kpools, vpools

    # -- program builders -------------------------------------------------
    def _build_prefill(self, startup, num_blocks, block_size,
                       pack_max_segments, score_only=False):
        cfg = self.cfg
        main = Program()
        main.random_seed = self.seed
        main._is_test = True
        k_channels = 1 if score_only else pack_max_segments
        with program_guard(main, startup):
            src = layers.data("src_ids", shape=[-1, -1], dtype="int64",
                              append_batch_size=False)
            pos = layers.data("pos_ids", shape=[-1, -1], dtype="int64",
                              append_batch_size=False)
            mask = layers.data("input_mask", shape=[-1, -1, k_channels],
                               dtype="float32", append_batch_size=False)
            last_pos = layers.data("last_pos", shape=[-1, k_channels],
                                   dtype="int64", append_batch_size=False)
            cache = None
            if not score_only:
                slots = layers.data("slot_ids", shape=[-1, -1],
                                    dtype="int32", append_batch_size=False)
                block = main.global_block()
                kpools, vpools = self._declare_pools(block, num_blocks,
                                                     block_size)
                cache = _Cache(kpools, vpools, slots)
            x = _embed(src, pos, cfg)
            bias = _mask_bias(mask)
            for i in range(cfg.num_hidden_layers):
                x = _decoder_layer(x, bias, cfg,
                                   f"{self.name}_layer_{i}", cache, i)
            h = _gather_last(x, last_pos, cfg)
            _lm_head(h, cfg)
        feeds = ["src_ids", "pos_ids", "input_mask", "last_pos"]
        if not score_only:
            feeds.append("slot_ids")
        return main, feeds

    def _build_decode(self, startup, num_blocks, block_size,
                      max_blocks_per_seq):
        cfg = self.cfg
        main = Program()
        main.random_seed = self.seed
        main._is_test = True
        with program_guard(main, startup):
            tok = layers.data("token_ids", shape=[-1], dtype="int64",
                              append_batch_size=False)
            pos = layers.data("pos_ids", shape=[-1], dtype="int64",
                              append_batch_size=False)
            slots = layers.data("slot_ids", shape=[-1, 1], dtype="int32",
                                append_batch_size=False)
            table = layers.data("block_table",
                                shape=[-1, max_blocks_per_seq],
                                dtype="int32", append_batch_size=False)
            ctx_len = layers.data("ctx_len", shape=[-1], dtype="int32",
                                  append_batch_size=False)
            block = main.global_block()
            kpools, vpools = self._declare_pools(block, num_blocks,
                                                 block_size)
            cache = _Cache(kpools, vpools, slots, table, ctx_len)
            x = _embed(tok, pos, cfg, lift_1d=True)
            for i in range(cfg.num_hidden_layers):
                x = _decoder_layer(x, None, cfg,
                                   f"{self.name}_layer_{i}", cache, i)
            h = layers.reshape(x, [-1, cfg.hidden_size])
            _lm_head(h, cfg)
        return main, ["token_ids", "pos_ids", "slot_ids", "block_table",
                      "ctx_len"]

    def _build_chain(self, startup, num_blocks, block_size,
                     max_blocks_per_seq, chain_length, with_sampling):
        """The decode-step network plus a trailing ``decode_chain``
        marker op.  The executor runs the step body ``chain_length``
        times on the device (executor.lower_decode_chain; token
        feedback, cache writes, block-table walk, EOS/len masks all on
        device); the host fetches one packed ``[chain, B]`` token block
        per chain instead of one token per step.  The marker sits LAST
        and takes the body's ``next_logits``/``next_tokens`` as inputs,
        which keeps the body alive through fetch-list pruning."""
        cfg = self.cfg
        main = Program()
        main.random_seed = self.seed
        main._is_test = True
        with program_guard(main, startup):
            tok = layers.data("token_ids", shape=[-1], dtype="int64",
                              append_batch_size=False)
            pos = layers.data("pos_ids", shape=[-1], dtype="int64",
                              append_batch_size=False)
            slots = layers.data("slot_ids", shape=[-1, 1], dtype="int32",
                                append_batch_size=False)
            table = layers.data("block_table",
                                shape=[-1, max_blocks_per_seq],
                                dtype="int32", append_batch_size=False)
            ctx_len = layers.data("ctx_len", shape=[-1], dtype="int32",
                                  append_batch_size=False)
            steps_left = layers.data("steps_left", shape=[-1],
                                     dtype="int32",
                                     append_batch_size=False)
            eos_ids = layers.data("eos_ids", shape=[-1], dtype="int64",
                                  append_batch_size=False)
            sample_feeds = []
            if with_sampling:
                sample_feeds = [
                    layers.data("temperature", shape=[-1],
                                dtype="float32",
                                append_batch_size=False),
                    layers.data("top_k", shape=[-1], dtype="int32",
                                append_batch_size=False),
                    layers.data("top_p", shape=[-1], dtype="float32",
                                append_batch_size=False),
                    layers.data("seeds", shape=[-1], dtype="int32",
                                append_batch_size=False)]
            block = main.global_block()
            kpools, vpools = self._declare_pools(block, num_blocks,
                                                 block_size)
            cache = _Cache(kpools, vpools, slots, table, ctx_len)
            x = _embed(tok, pos, cfg, lift_1d=True)
            for i in range(cfg.num_hidden_layers):
                x = _decoder_layer(x, None, cfg,
                                   f"{self.name}_layer_{i}", cache, i)
            h = layers.reshape(x, [-1, cfg.hidden_size])
            logits, tokens = _lm_head(h, cfg)
            out = block.create_var(name="chain_tokens",
                                   shape=(chain_length, -1),
                                   dtype="int64")
            helper = LayerHelper("decode_chain")
            inputs = {"TokenIds": [tok], "PosIds": [pos],
                      "SlotIds": [slots], "BlockTable": [table],
                      "CtxLen": [ctx_len], "StepsLeft": [steps_left],
                      "EosIds": [eos_ids], "Logits": [logits],
                      "Tokens": [tokens]}
            if with_sampling:
                inputs.update({"Temperature": [sample_feeds[0]],
                               "TopK": [sample_feeds[1]],
                               "TopP": [sample_feeds[2]],
                               "Seeds": [sample_feeds[3]]})
            helper.append_op(type="decode_chain", inputs=inputs,
                             outputs={"Out": [out]},
                             attrs={"chain_length": chain_length,
                                    "block_size": block_size,
                                    "with_sampling":
                                        bool(with_sampling)})
        feeds = ["token_ids", "pos_ids", "slot_ids", "block_table",
                 "ctx_len", "steps_left", "eos_ids"]
        if with_sampling:
            feeds += ["temperature", "top_k", "top_p", "seeds"]
        return main, feeds

    def _build_chunk(self, startup, num_blocks, block_size,
                     max_blocks_per_seq):
        """Chunked prefill: a ``[B, C]`` prompt slice that WRITES its
        K/V into the pools like prefill but READS attention through the
        block table like decode, with absolute ``pos_ids`` doubling as
        the per-query causal bound (QPos).  ``ctx_len`` covers all
        tokens written so far INCLUDING this chunk, so earlier chunks'
        cache entries are visible and later positions are masked by
        QPos."""
        cfg = self.cfg
        main = Program()
        main.random_seed = self.seed
        main._is_test = True
        with program_guard(main, startup):
            src = layers.data("src_ids", shape=[-1, -1], dtype="int64",
                              append_batch_size=False)
            pos = layers.data("pos_ids", shape=[-1, -1], dtype="int64",
                              append_batch_size=False)
            slots = layers.data("slot_ids", shape=[-1, -1],
                                dtype="int32", append_batch_size=False)
            table = layers.data("block_table",
                                shape=[-1, max_blocks_per_seq],
                                dtype="int32", append_batch_size=False)
            ctx_len = layers.data("ctx_len", shape=[-1], dtype="int32",
                                  append_batch_size=False)
            last_pos = layers.data("last_pos", shape=[-1, 1],
                                   dtype="int64",
                                   append_batch_size=False)
            block = main.global_block()
            kpools, vpools = self._declare_pools(block, num_blocks,
                                                 block_size)
            cache = _Cache(kpools, vpools, slots, table, ctx_len,
                           q_pos=pos)
            x = _embed(src, pos, cfg)
            for i in range(cfg.num_hidden_layers):
                x = _decoder_layer(x, None, cfg,
                                   f"{self.name}_layer_{i}", cache, i)
            h = _gather_last(x, last_pos, cfg)
            _lm_head(h, cfg)
        return main, ["src_ids", "pos_ids", "slot_ids", "block_table",
                      "ctx_len", "last_pos"]

    def cache_layout_key(self, block_size: int) -> str:
        """Identity prefix for cross-request prefix-cache keys: two
        cached blocks are interchangeable ONLY if the model parameters
        and the pool layout that produced them agree.  Seed stands in
        for the parameter values (deterministic init)."""
        cfg = self.cfg
        key = (f"{self.name}/seed={self.seed}/L={cfg.num_hidden_layers}"
               f"/H={cfg.hidden_size}/heads={cfg.num_attention_heads}"
               f"/V={cfg.vocab_size}/dtype={cfg.dtype}/bs={block_size}")
        if cfg.moe_experts:
            # routed FFNs change what a cached block's K/V mean: an MoE
            # and a dense build of one geometry never share prefix-cache
            # entries
            key += (f"/moe=E{cfg.moe_experts}k{cfg.moe_top_k}"
                    f"cf{cfg.moe_capacity_factor}")
        return key

    def build(self, num_blocks: int, block_size: int,
              max_blocks_per_seq: int,
              pack_max_segments: int = 1,
              chain_lengths: tuple = (),
              with_sampling: bool = False,
              chunk_tokens: Optional[int] = None) -> DecoderPrograms:
        from ..framework import unique_name
        startup = Program()
        startup.random_seed = self.seed
        with unique_name.guard(f"{self.name}@"):
            # fresh name generator: the programs' content (incl. tmp var
            # names) depends only on the config, never on what else the
            # process built first
            prefill, prefill_feeds = self._build_prefill(
                startup, num_blocks, block_size, pack_max_segments)
            # the decode/score builds re-declare the same parameters;
            # their initializer ops go to throwaway startups so the real
            # startup initialises each weight exactly once
            decode, decode_feeds = self._build_decode(
                Program(), num_blocks, block_size, max_blocks_per_seq)
            score, score_feeds = self._build_prefill(
                Program(), num_blocks, block_size, 1, score_only=True)
            chains, chain_feeds = {}, []
            for length in chain_lengths:
                chains[int(length)], chain_feeds = self._build_chain(
                    Program(), num_blocks, block_size,
                    max_blocks_per_seq, int(length), with_sampling)
            chunk, chunk_feeds = None, []
            if chunk_tokens:
                chunk, chunk_feeds = self._build_chunk(
                    Program(), num_blocks, block_size,
                    max_blocks_per_seq)
        return DecoderPrograms(
            prefill=prefill, decode=decode, score=score, startup=startup,
            cache_vars=self.cache_var_names(),
            prefill_feeds=prefill_feeds, decode_feeds=decode_feeds,
            score_feeds=score_feeds, chains=chains,
            chain_feeds=chain_feeds, chunk=chunk,
            chunk_feeds=chunk_feeds)


__all__ = ["BertDecoder", "DecoderPrograms"]
