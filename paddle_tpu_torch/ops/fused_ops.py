"""Fused ops emitted by the inference passes — the port of
paddle_tpu/ops/fused_ops.py (+ the ``fc`` op of registry_tail_ops.py).

``fused_elemwise_activation`` (bias + GELU) and ``fused_add_layernorm``
route onto the hand-written kernels (ops/cuda/fused_ops.py),
``multihead_matmul`` onto the flash kernel.  With a route's flag off, or
on CPU tensors a kernel rejects, each runs the JAX package's composition;
on the card such an input raises (``registry.cuda_route``)."""

from __future__ import annotations

import torch

from .cuda import fused_ops as cuda_fused
from .cuda import flash_attention as cuda_flash
from .math_ops import gelu
from .nn_ops import affine_as
from .registry import cuda_route, get_op, register, x

_ACTS = {
    "relu": torch.relu,
    "sigmoid": torch.sigmoid,
    "tanh": torch.tanh,
    "gelu": gelu,
    "identity": lambda a: a,
    "": lambda a: a,
}


@register("fused_elemwise_activation")
def _fused_elemwise_activation(ctx, ins, attrs):
    """ref: operators/fused/fused_elemwise_activation_op.cc —
    functor_list like ["elementwise_add", "relu"]."""
    functors = list(attrs.get("functor_list", ["elementwise_add", "relu"]))
    binary, unary = functors[0], functors[1]
    a, b = x(ins, "X"), x(ins, "Y")
    if a is not None and b is not None:
        route, _ = cuda_route("fused_elemwise_activation", ins, attrs)
        if route is not None:
            d = a.shape[-1]
            out = cuda_fused.bias_gelu(a.reshape(-1, d), b)
            return {"Out": out.reshape(a.shape)}
    # the stock elementwise op keeps the axis-broadcast semantics
    out = get_op(binary)(ctx, ins, attrs)["Out"]
    return {"Out": _ACTS[unary](out)}


@register("fused_add_layernorm")
def _fused_add_layernorm(ctx, ins, attrs):
    """Residual add + LayerNorm in one pass (emitted by the
    fuse_add_layernorm pass).  Mean/Variance come back as zeros, the JAX
    package's contract for the fused op (the pass only fuses when nothing
    reads them)."""
    a = x(ins, "X")
    res = x(ins, "Residual")
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    route, _ = cuda_route("fused_add_layernorm", ins, attrs)
    if route is not None:
        d = 1
        for s in a.shape[bna:]:
            d *= int(s)
        r = a.numel() // d
        y = cuda_fused.add_layer_norm(a.reshape(r, d), res.reshape(r, d),
                                      affine_as(a, scale, d),
                                      affine_as(a, bias, d),
                                      eps).reshape(a.shape)
        zeros = torch.zeros(tuple(a.shape[:bna]), dtype=torch.float32,
                            device=a.device)
        return {"Y": y, "Mean": zeros, "Variance": zeros}
    return get_op("layer_norm")(ctx, {"X": [a + res],
                                      "Scale": ins.get("Scale", []),
                                      "Bias": ins.get("Bias", [])}, attrs)


@register("multihead_matmul")
def _multihead_matmul(ctx, ins, attrs):
    """softmax(alpha * Q K^T + bias) V on head-split [B, H, S, D] operands
    (produced by the multihead_matmul_fuse pass)."""
    q, k, v = x(ins, "Q"), x(ins, "K"), x(ins, "V")
    bias = x(ins, "BiasQK")
    alpha = attrs.get("alpha", 1.0)
    dropout_rate = attrs.get("dropout_rate", 0.0)
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    is_test = attrs.get("is_test", False) or ctx.is_test
    # downgrade_in_infer dropout scales probs by (1-p) at inference; probs
    # enter the context matmul linearly, so scaling the output is the same
    post = (1.0 - dropout_rate) \
        if (dropout_rate and is_test and impl == "downgrade_in_infer") \
        else 1.0
    route, _ = cuda_route("multihead_matmul", ins,
                          dict(attrs, is_test=is_test))
    if route is not None:
        # the kernel scales scores by 1/sqrt(d); fold alpha into q
        comp = alpha * (q.shape[-1] ** 0.5)
        qq = q if comp == 1.0 else q * comp
        out = cuda_flash.flash_attention_bshd(qq, k, v, bias)
        return {"Out": out * post if post != 1.0 else out}
    if alpha != 1.0:
        q = q * alpha
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2))
    if bias is not None:
        scores = scores + bias.float()
    probs = torch.softmax(scores, dim=-1)
    if dropout_rate and not is_test:
        keep = torch.empty(probs.shape, device=probs.device).bernoulli_(
            1.0 - dropout_rate, generator=ctx.generator).bool()
        zero = torch.zeros((), device=probs.device)
        if impl == "upscale_in_train":
            probs = torch.where(keep, probs / (1.0 - dropout_rate), zero)
        else:
            probs = torch.where(keep, probs, zero)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    if post != 1.0:
        out = out * post
    return {"Out": out.to(v.dtype)}


@register("fused_embedding_eltwise_layernorm")
def _fused_embedding_eltwise_layernorm(ctx, ins, attrs):
    """Sum of N embedding lookups + LayerNorm in one op (emitted by the
    embedding_eltwise_layernorm_fuse pass; BERT's word + position +
    sentence stack).  A plain composition, as in the JAX package."""
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    acc = None
    for ids, table in zip(ins.get("Ids", []), ins.get("Embs", [])):
        idx = ids.reshape(ids.shape[:2]).long()
        g = table[idx]                       # [B, S, D]
        acc = g if acc is None else acc + g
    mean = acc.mean(dim=-1, keepdim=True)
    var = ((acc - mean) ** 2).mean(dim=-1, keepdim=True)
    y = (acc - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        y = y * scale.reshape(1, 1, -1)
    if bias is not None:
        y = y + bias.reshape(1, 1, -1)
    zeros = torch.zeros(tuple(acc.shape[:-1]), dtype=torch.float32,
                        device=acc.device)
    y = y.to(acc.dtype)
    return {"Y": y, "Out": y, "Mean": zeros, "Variance": zeros}


@register("fc")
def _fc(ctx, ins, attrs):
    """ref: operators/fc_op.cc — the inference FC (mul + bias + optional
    relu) that fc_fuse emits."""
    a, w, b = x(ins, "Input"), x(ins, "W"), x(ins, "Bias")
    ncd = int(attrs.get("in_num_col_dims", 1))
    lead = 1
    for s in a.shape[:ncd]:
        lead *= s
    out = torch.matmul(a.reshape(lead, -1), w)
    if b is not None:
        out = out + b.reshape(1, -1)
    if attrs.get("activation_type") == "relu":
        out = torch.relu(out)
    return {"Out": out.reshape(tuple(a.shape[:ncd]) + (w.shape[1],))}
