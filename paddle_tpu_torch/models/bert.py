"""BERT — the port of paddle_tpu/models/bert.py: the encoder, the
masked-LM + next-sentence pretraining heads, the synthetic pretraining
batch, and the tensor/sequence-parallel pretraining builder
(:func:`build_pretrain_network_parallel`: Megatron tp layers, ring
attention over the sequence axis).  With ``moe_experts > 0`` every FFN
is the routed MoE block (``parallel.moe_ffn``, built dense: expert
parallelism is retrofitted by ``parallel.apply_expert_sharding``) and
the blocks' load-balance terms join the pretraining loss.

Static-graph builder: embeddings + N post-LN transformer encoder layers
+ the pooled first-token output.  It emits the same program as the JAX
package's builder, op for op and name for name, so a desc built by
either package is byte-identical."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import layers
from ..framework.initializer import TruncatedNormalInitializer
from ..framework.layer_helper import LayerHelper, ParamAttr


@dataclass
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    initializer_range: float = 0.02
    dtype: str = "float32"
    # moe_experts > 0 replaces every FFN with a top-k routed MoE block
    # built dense (parallel/moe.py); the tensor/sequence-parallel builder
    # refuses it
    moe_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 2.0
    moe_group_size: int = 0
    moe_aux_weight: float = 0.01

    @staticmethod
    def base():
        return BertConfig()

    @staticmethod
    def tiny():
        return BertConfig(vocab_size=1024, hidden_size=128,
                          num_hidden_layers=2, num_attention_heads=2,
                          intermediate_size=512, max_position_embeddings=128,
                          type_vocab_size=2)


def _init(cfg):
    return TruncatedNormalInitializer(0.0, cfg.initializer_range)


def _attr(name, cfg):
    return ParamAttr(name=name, initializer=_init(cfg))


def _refuse_moe(cfg: BertConfig):
    """The tensor/sequence-parallel builder has no MoE branch: the JAX
    package's builds the dense FFN there whatever ``moe_experts`` says,
    so the port refuses rather than train another model than asked."""
    if cfg.moe_experts:
        from ..framework.errors import UnimplementedError
        raise UnimplementedError(
            f"build_pretrain_network_parallel(BertConfig(moe_experts="
            f"{cfg.moe_experts})): the tensor/sequence-parallel builder has "
            f"no MoE branch (the JAX package's silently builds the dense "
            f"FFN); build the routed MoE model with build_pretrain_network, "
            f"or the dense one here (moe_experts=0)")


def _ffn_block(x, cfg: BertConfig, name: str):
    """The dense two-fc FFN, or (``cfg.moe_experts`` > 0) the routed MoE
    block, built dense (no collective; ``apply_expert_sharding``
    retrofits the exchange).  The block's aux loss is recorded on the
    program (``parallel.collect_aux_losses`` drains it in the loss
    builder)."""
    if cfg.moe_experts:
        from ..parallel import moe_ffn
        out, _aux = moe_ffn(
            x, num_experts=cfg.moe_experts,
            ffn_hidden=cfg.intermediate_size, top_k=cfg.moe_top_k,
            capacity_factor=cfg.moe_capacity_factor, act=cfg.hidden_act,
            group_size=cfg.moe_group_size,
            param_attr=_attr(f"{name}_moe", cfg),
            bias_attr=ParamAttr(name=f"{name}_moe_b"),
            name=f"{name}_moe")
        return out
    ffn = layers.fc(x, cfg.intermediate_size, num_flatten_dims=2,
                    act=cfg.hidden_act,
                    param_attr=_attr(f"{name}_ffn1_w", cfg),
                    bias_attr=ParamAttr(name=f"{name}_ffn1_b"))
    return layers.fc(ffn, cfg.hidden_size, num_flatten_dims=2,
                     param_attr=_attr(f"{name}_ffn2_w", cfg),
                     bias_attr=ParamAttr(name=f"{name}_ffn2_b"))


def encoder_layer(x, attn_bias, cfg: BertConfig, name: str, is_test=False):
    """Post-LN transformer layer (fused QKV projection, fused attention,
    residual + LayerNorm twice)."""
    d = cfg.hidden_size
    qkv = layers.fc(x, 3 * d, num_flatten_dims=2,
                    param_attr=_attr(f"{name}_qkv_w", cfg),
                    bias_attr=ParamAttr(name=f"{name}_qkv_b"))
    q, k, v = layers.split(qkv, 3, dim=2)
    ctx = fused_attention(q, k, v, attn_bias, cfg.num_attention_heads,
                          cfg.attention_probs_dropout_prob, is_test,
                          name=name)
    attn_out = layers.fc(ctx, d, num_flatten_dims=2,
                         param_attr=_attr(f"{name}_out_w", cfg),
                         bias_attr=ParamAttr(name=f"{name}_out_b"))
    attn_out = layers.dropout(attn_out, cfg.hidden_dropout_prob,
                              is_test=is_test,
                              dropout_implementation="upscale_in_train")
    x = layers.layer_norm(x + attn_out, begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"{name}_ln1_scale"),
                          bias_attr=ParamAttr(name=f"{name}_ln1_bias"))
    ffn = _ffn_block(x, cfg, name)
    ffn = layers.dropout(ffn, cfg.hidden_dropout_prob, is_test=is_test,
                         dropout_implementation="upscale_in_train")
    return layers.layer_norm(x + ffn, begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{name}_ln2_scale"),
                             bias_attr=ParamAttr(name=f"{name}_ln2_bias"))


def fused_attention(q, k, v, attn_bias, n_head, dropout_rate, is_test,
                    name, causal=False):
    helper = LayerHelper("fused_attention", name=f"{name}_attn")
    out = helper.create_variable_for_type_inference(q.dtype, q.shape)
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if attn_bias is not None:
        inputs["AttnBias"] = [attn_bias]
    # causality is an op attr, not a baked [S, S] bias: one program
    # serves every bucketed sequence length
    helper.append_op(type="fused_attention", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"n_head": n_head, "dropout_rate": dropout_rate,
                            "is_test": is_test, "causal": causal})
    return out


def bert_encoder(src_ids, position_ids, sentence_ids, input_mask,
                 cfg: BertConfig, is_test=False, extra_emb=None):
    """Returns (sequence_output, pooled_output).  ``extra_emb`` joins the
    input embedding sum (ERNIE's task-type embedding hook)."""
    emb = layers.embedding(src_ids, size=[cfg.vocab_size, cfg.hidden_size],
                           dtype=cfg.dtype,
                           param_attr=_attr("word_embedding", cfg))
    pos = layers.embedding(position_ids,
                           size=[cfg.max_position_embeddings,
                                 cfg.hidden_size], dtype=cfg.dtype,
                           param_attr=_attr("pos_embedding", cfg))
    sent = layers.embedding(sentence_ids,
                            size=[cfg.type_vocab_size, cfg.hidden_size],
                            dtype=cfg.dtype,
                            param_attr=_attr("sent_embedding", cfg))
    emb = emb + pos + sent
    if extra_emb is not None:
        emb = emb + extra_emb
    emb = layers.layer_norm(emb, begin_norm_axis=2,
                            param_attr=ParamAttr(name="pre_encoder_ln_scale"),
                            bias_attr=ParamAttr(name="pre_encoder_ln_bias"))
    emb = layers.dropout(emb, cfg.hidden_dropout_prob, is_test=is_test,
                         dropout_implementation="upscale_in_train")

    # additive attention bias from the padding mask:
    # (B, S, 1) x (B, 1, S) -> (B, 1, S, S), 0 keep / -1e4 drop
    mask_sq = layers.matmul(input_mask, input_mask, transpose_y=True)
    attn_bias = layers.scale(mask_sq, scale=1e4, bias=-1e4)
    attn_bias = layers.unsqueeze(attn_bias, axes=[1])
    attn_bias.stop_gradient = True

    x = emb
    for i in range(cfg.num_hidden_layers):
        x = encoder_layer(x, attn_bias, cfg, name=f"encoder_layer_{i}",
                          is_test=is_test)

    # pooled output: first token -> fc tanh
    first_tok = layers.slice(x, axes=[1], starts=[0], ends=[1])
    first_tok = layers.reshape(first_tok, [-1, cfg.hidden_size])
    pooled = layers.fc(first_tok, cfg.hidden_size, act="tanh",
                       param_attr=_attr("pooled_fc.w_0", cfg),
                       bias_attr=ParamAttr(name="pooled_fc.b_0"))
    return x, pooled


def build_inference_network(cfg: BertConfig):
    """The served encoder with its four feeds; returns (feeds,
    sequence_output, pooled_output)."""
    src_ids = layers.data("src_ids", shape=[-1, -1], dtype="int64",
                          append_batch_size=False)
    pos_ids = layers.data("pos_ids", shape=[-1, -1], dtype="int64",
                          append_batch_size=False)
    sent_ids = layers.data("sent_ids", shape=[-1, -1], dtype="int64",
                           append_batch_size=False)
    input_mask = layers.data("input_mask", shape=[-1, -1, 1],
                             dtype="float32", append_batch_size=False)
    seq_out, pooled = bert_encoder(src_ids, pos_ids, sent_ids, input_mask,
                                   cfg, is_test=True)
    return [src_ids, pos_ids, sent_ids, input_mask], seq_out, pooled


def bert_pretrain_loss(seq_out, pooled, mask_label, mask_pos, labels,
                       cfg: BertConfig):
    """Masked-LM + next-sentence losses; the masked-LM decoder is the
    transposed word embedding plus an output bias.  mask_pos holds
    per-sample token positions [B, M].  Returns (total, mlm, nsp)."""
    d = cfg.hidden_size
    gh = LayerHelper("gather_tokens")
    mask_feat = gh.create_variable_for_type_inference(seq_out.dtype,
                                                      (-1, d))
    gh.append_op(type="gather_tokens",
                 inputs={"X": [seq_out], "Index": [mask_pos]},
                 outputs={"Out": [mask_feat]})
    mask_trans = layers.fc(mask_feat, d, act=cfg.hidden_act,
                           param_attr=_attr("mask_lm_trans_fc.w_0", cfg),
                           bias_attr=ParamAttr(name="mask_lm_trans_fc.b_0"))
    mask_trans = layers.layer_norm(
        mask_trans, begin_norm_axis=1,
        param_attr=ParamAttr(name="mask_lm_trans_ln_scale"),
        bias_attr=ParamAttr(name="mask_lm_trans_ln_bias"))
    word_emb = mask_trans.block.program.global_block().var("word_embedding")
    helper = LayerHelper("mask_lm_out")
    bias = helper.create_parameter(
        ParamAttr(name="mask_lm_out_fc.b_0"), [cfg.vocab_size], cfg.dtype,
        is_bias=True)
    logits = layers.matmul(mask_trans, word_emb, transpose_y=True)
    logits = layers.elementwise_add(logits, bias)
    mask_lm_loss = layers.mean(
        layers.softmax_with_cross_entropy(logits, mask_label))
    ns_logits = layers.fc(pooled, 2,
                          param_attr=_attr("next_sent_fc.w_0", cfg),
                          bias_attr=ParamAttr(name="next_sent_fc.b_0"))
    ns_loss = layers.mean(
        layers.softmax_with_cross_entropy(ns_logits, labels))
    return mask_lm_loss + ns_loss, mask_lm_loss, ns_loss


def build_pretrain_network(cfg: BertConfig, is_test=False):
    """The pretraining program with its seven feeds; returns (feeds,
    total loss, masked-LM loss, next-sentence loss)."""
    def feed(name, shape, dtype):
        return layers.data(name, shape=shape, dtype=dtype,
                           append_batch_size=False)

    src_ids = feed("src_ids", [-1, -1], "int64")
    pos_ids = feed("pos_ids", [-1, -1], "int64")
    sent_ids = feed("sent_ids", [-1, -1], "int64")
    input_mask = feed("input_mask", [-1, -1, 1], "float32")
    mask_label = feed("mask_label", [-1, 1], "int64")
    mask_pos = feed("mask_pos", [-1, -1], "int64")
    labels = feed("labels", [-1, 1], "int64")
    seq_out, pooled = bert_encoder(src_ids, pos_ids, sent_ids, input_mask,
                                   cfg, is_test=is_test)
    total, mlm, nsp = bert_pretrain_loss(seq_out, pooled, mask_label,
                                         mask_pos, labels, cfg)
    if cfg.moe_experts:
        from ..framework.core import default_main_program
        from ..parallel import collect_aux_losses
        aux_terms = collect_aux_losses(default_main_program())
        if aux_terms:
            aux = layers.sum(aux_terms) if len(aux_terms) > 1 \
                else aux_terms[0]
            total = layers.elementwise_add(
                total, layers.scale(aux, scale=cfg.moe_aux_weight))
    feeds = [src_ids, pos_ids, sent_ids, input_mask, mask_label, mask_pos,
             labels]
    return feeds, total, mlm, nsp


def parallel_encoder_layer(x, kv_mask, cfg: BertConfig, tp_degree: int,
                           name: str, seq_axis=None, is_test=False):
    """Encoder layer with Megatron TP (heads + FFN sharded over tp) and
    optional ring attention over the sequence-parallel axis — the
    dp x tp x sp path."""
    from .. import parallel as par
    d = cfg.hidden_size
    attn = par.parallel_multihead_attention(
        x, d, cfg.num_attention_heads, tp_degree, seq_axis=seq_axis,
        kv_mask=kv_mask, dropout=0.0 if is_test
        else cfg.attention_probs_dropout_prob, name=f"{name}_attn")
    x = layers.layer_norm(x + attn, begin_norm_axis=2,
                          param_attr=ParamAttr(name=f"{name}_ln1_scale"),
                          bias_attr=ParamAttr(name=f"{name}_ln1_bias"))
    ffn = par.parallel_ffn(x, d, cfg.intermediate_size, tp_degree,
                           act=cfg.hidden_act, name=f"{name}_ffn")
    return layers.layer_norm(x + ffn, begin_norm_axis=2,
                             param_attr=ParamAttr(name=f"{name}_ln2_scale"),
                             bias_attr=ParamAttr(name=f"{name}_ln2_bias"))


def build_pretrain_network_parallel(cfg: BertConfig, tp_degree: int = 1,
                                    seq_axis=None, is_test=False):
    """BERT masked-LM with tensor + sequence parallelism.

    Per-token LM loss (label weights select masked positions) instead of
    the gather-based head: under sequence parallelism every rank scores
    only its own token shard, so no cross-shard gather is needed, and the
    loss is this shard's weighted mean (the gradient sync averages over
    the data and sequence shards).

    Feeds [B, S]-shaped: src_ids, pos_ids, sent_ids, kv_mask (float 0/1),
    lm_labels (int), lm_weights (float 0/1).  Returns (feeds, loss)."""
    from .. import parallel as par
    _refuse_moe(cfg)
    src_ids = layers.data("src_ids", shape=[-1, -1], dtype="int64",
                          append_batch_size=False)
    pos_ids = layers.data("pos_ids", shape=[-1, -1], dtype="int64",
                          append_batch_size=False)
    sent_ids = layers.data("sent_ids", shape=[-1, -1], dtype="int64",
                           append_batch_size=False)
    kv_mask = layers.data("kv_mask", shape=[-1, -1], dtype="float32",
                          append_batch_size=False)
    lm_labels = layers.data("lm_labels", shape=[-1, -1], dtype="int64",
                            append_batch_size=False)
    lm_weights = layers.data("lm_weights", shape=[-1, -1], dtype="float32",
                             append_batch_size=False)

    emb = par.vocab_parallel_embedding(
        src_ids, cfg.vocab_size, cfg.hidden_size, tp_degree,
        param_attr=_attr("word_embedding", cfg))
    pos = layers.embedding(pos_ids, size=[cfg.max_position_embeddings,
                                          cfg.hidden_size], dtype=cfg.dtype,
                           param_attr=_attr("pos_embedding", cfg))
    sent = layers.embedding(sent_ids, size=[cfg.type_vocab_size,
                                            cfg.hidden_size],
                            dtype=cfg.dtype,
                            param_attr=_attr("sent_embedding", cfg))
    x = layers.layer_norm(emb + pos + sent, begin_norm_axis=2,
                          param_attr=ParamAttr(name="pre_encoder_ln_scale"),
                          bias_attr=ParamAttr(name="pre_encoder_ln_bias"))
    for i in range(cfg.num_hidden_layers):
        x = parallel_encoder_layer(x, kv_mask, cfg, tp_degree,
                                   name=f"encoder_layer_{i}",
                                   seq_axis=seq_axis, is_test=is_test)
    # LM head: column-parallel projection to vocab, gathered for softmax
    logits = par.column_parallel_fc(
        x, cfg.vocab_size, tp_degree, gather_output=True,
        param_attr=_attr("mask_lm_out_w", cfg), bias_attr=False,
        name="mask_lm_out")
    per_tok = layers.softmax_with_cross_entropy(
        logits, layers.unsqueeze(lm_labels, axes=[-1]))
    per_tok = layers.squeeze(per_tok, axes=[-1])
    wsum = layers.reduce_sum(per_tok * lm_weights)
    wcnt = layers.reduce_sum(lm_weights) + 1e-6
    loss = wsum / wcnt
    feeds = [src_ids, pos_ids, sent_ids, kv_mask, lm_labels, lm_weights]
    return feeds, loss


def make_fake_parallel_batch(rng, cfg: BertConfig, batch_size=8,
                             seq_len=128, mask_frac=0.15):
    """Synthetic batch in :func:`build_pretrain_network_parallel`'s feed
    layout, from a ``numpy.random.RandomState`` in the JAX package's
    generator order."""
    b, s = batch_size, seq_len
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (b, s)).astype("int64"),
        "pos_ids": np.tile(np.arange(s, dtype="int64"), (b, 1)),
        "sent_ids": rng.randint(0, cfg.type_vocab_size,
                                (b, s)).astype("int64"),
        "kv_mask": np.ones((b, s), dtype="float32"),
        "lm_labels": rng.randint(0, cfg.vocab_size, (b, s)).astype("int64"),
        "lm_weights": (rng.rand(b, s) < mask_frac).astype("float32"),
    }


def make_fake_batch(rng, cfg: BertConfig, batch_size=8, seq_len=128,
                    num_masks=20):
    """Synthetic pretraining batch in the feed layout above, from a
    ``numpy.random.RandomState`` (the JAX package's generator order, so
    one seed gives both packages the same batch)."""
    b, s = batch_size, seq_len
    return {
        "src_ids": rng.randint(0, cfg.vocab_size, (b, s)).astype("int64"),
        "pos_ids": np.tile(np.arange(s, dtype="int64"), (b, 1)),
        "sent_ids": rng.randint(0, cfg.type_vocab_size,
                                (b, s)).astype("int64"),
        "input_mask": np.ones((b, s, 1), dtype="float32"),
        "mask_label": rng.randint(0, cfg.vocab_size,
                                  (b * num_masks, 1)).astype("int64"),
        "mask_pos": rng.randint(0, s, (b, num_masks)).astype("int64"),
        "labels": rng.randint(0, 2, (b, 1)).astype("int64"),
    }
