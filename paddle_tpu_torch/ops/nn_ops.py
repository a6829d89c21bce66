"""NN ops — the port of paddle_tpu/ops/nn_ops.py (the subset the BERT
serving, pretraining and decoder programs use).  ``layer_norm`` routes onto the
hand-written LayerNorm kernels (``fused_layer_norm`` route: forward, and
the backward kernel under autograd); every other op is a plain PyTorch
composition, as the JAX package leaves them to XLA."""

from __future__ import annotations

import torch

from .cuda import fused_ops as cuda_fused
from .registry import cuda_route, register, x


def _rows(a, bna):
    d = 1
    for s in a.shape[bna:]:
        d *= int(s)
    return a.numel() // d, d


def layer_norm_composition(a, scale, bias, eps, bna):
    """The plain layer_norm: float32 mean/variance over dims [bna:]."""
    axes = tuple(range(bna, a.dim()))
    af = a.float()
    mean = af.mean(dim=axes, keepdim=True)
    var = ((af - mean) ** 2).mean(dim=axes, keepdim=True)
    out = (af - mean) * torch.rsqrt(var + eps)
    tail = a.shape[bna:]
    if scale is not None:
        out = out * scale.reshape(tail)
    if bias is not None:
        out = out + bias.reshape(tail)
    lead = a.shape[:bna]
    return out.to(a.dtype), mean.reshape(lead), var.reshape(lead)


def affine_as(a, t, d):
    """Scale or Bias flattened to ``d`` in ``a``'s dtype for a LayerNorm
    kernel: a 16-bit parameter beside float32 ``a`` widens exactly (the
    value the JAX package's promotion computes with; its gradient is cast
    back by autograd, as JAX's transpose of the promotion does)."""
    return t.reshape(d).to(a.dtype)


@register("layer_norm")
def _layer_norm(ctx, ins, attrs):
    """ref: operators/layer_norm_op.cc — normalise over dims
    [begin_norm_axis:]; Scale/Bias are flattened over those dims."""
    a = x(ins, "X")
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    eps = attrs.get("epsilon", 1e-5)
    bna = attrs.get("begin_norm_axis", 1)
    route, _ = cuda_route("layer_norm", ins, attrs)
    if route is not None:
        r, d = _rows(a, bna)
        y = cuda_fused.layer_norm(a.reshape(r, d), affine_as(a, scale, d),
                                  affine_as(a, bias, d),
                                  eps).reshape(a.shape)
        # Mean/Variance are rarely-consumed auxiliaries, computed outside
        # the kernel and non-differentiable, as the JAX package
        # stop-gradients them (the kernel's backward covers Y only)
        af = a.detach().float().reshape(r, d)
        return {"Y": y, "Mean": af.mean(-1).reshape(a.shape[:bna]),
                "Variance": af.var(-1, unbiased=False).reshape(
                    a.shape[:bna])}
    y, mean, var = layer_norm_composition(a, scale, bias, eps, bna)
    return {"Y": y, "Mean": mean, "Variance": var}


@register("softmax")
def _softmax(ctx, ins, attrs):
    return {"Out": torch.softmax(x(ins, "X"), dim=attrs.get("axis", -1))}


def _mask_of(a):
    """The inference-mode dropout mask: all ones, as a zero-copy view."""
    return torch.ones((), dtype=torch.uint8, device=a.device).expand(
        a.shape)


@register("dropout")
def _dropout(ctx, ins, attrs):
    a = x(ins, "X")
    p = attrs.get("dropout_prob", 0.5)
    is_test = attrs.get("is_test", False) or ctx.is_test
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if is_test:
        out = a if impl == "upscale_in_train" else a * (1.0 - p)
        return {"Out": out, "Mask": _mask_of(a)}
    # uniform [0, 1) below the keep probability, as jax.random.bernoulli
    # draws it: at rate 0 every element is kept.  (bernoulli_(1.0) on a
    # CUDA tensor drops an element now and then: its draws include 1.0)
    keep = torch.rand(a.shape, generator=ctx.generator,
                      device=a.device) < (1.0 - p)
    if impl == "upscale_in_train":
        out = torch.where(keep, a / max(1.0 - p, 1e-12),
                          torch.zeros((), dtype=a.dtype, device=a.device))
    else:
        out = torch.where(keep, a,
                          torch.zeros((), dtype=a.dtype, device=a.device))
    return {"Out": out.to(a.dtype), "Mask": keep.to(torch.uint8)}


class _ReplicatedTableLookup(torch.autograd.Function):
    """Rows ``ids`` of a table replicated over the run's tensor-parallel
    ranks, whose gradient is the product one_hot(ids)^T . grad over the
    distinct ids, accumulated in float32 in a fixed order.  On the card
    ``F.embedding``'s backward sums many ids into one row (4,096 ids into
    the sentence embedding's 2 rows) in an order that changes from run to
    run: one ulp apart, which ranks each computing the replicated table's
    gradient themselves must not be."""

    @staticmethod
    def forward(ctx, w, flat):
        ctx.save_for_backward(flat)
        ctx.table_shape = w.shape
        return torch.nn.functional.embedding(flat, w)

    @staticmethod
    def backward(ctx, grad):
        flat, = ctx.saved_tensors
        rows, inv = torch.unique(flat, return_inverse=True)
        one_hot = torch.nn.functional.one_hot(inv, rows.numel()).to(
            torch.float32)
        dw = torch.zeros(ctx.table_shape, dtype=torch.float32,
                         device=grad.device)
        dw[rows] = torch.matmul(one_hot.t(), grad.to(torch.float32))
        return dw.to(grad.dtype), None


def embedding_lookup(w, ids, padding_idx, replicated_over_tp=False):
    """Rows ``ids`` of ``w``.  ``F.embedding`` rather than
    ``index_select``: on the card its backward sums each row's gradient
    in float32, where ``index_select``'s (``index_add_``) adds with
    atomics in the table's dtype (a bf16 table's gradient then keeps few
    of its bits) and in an order that changes from run to run.  A table
    on the card that is ``replicated_over_tp`` takes
    :class:`_ReplicatedTableLookup`, whose gradient is the same on every
    rank."""
    flat = ids.reshape(-1).long()
    if replicated_over_tp and w.device.type != "cpu" and \
            torch.is_grad_enabled() and w.requires_grad:
        out = _ReplicatedTableLookup.apply(w, flat)
    else:
        out = torch.nn.functional.embedding(flat, w)
    if padding_idx is not None and padding_idx >= 0:
        out = out.masked_fill((flat == padding_idx)[:, None], 0.0)
    return out.reshape(tuple(ids.shape) + (w.shape[-1],))


def _replicated_over_tp(ctx) -> bool:
    """Whether the run has a tensor-parallel axis: a ``lookup_table``'s
    table is then replicated over it (a vocab-sharded one is
    ``c_embedding``'s)."""
    from ..framework.mesh_layout import TP_AXIS
    return TP_AXIS in ctx.axis_names


@register("lookup_table")
def _lookup_table(ctx, ins, attrs):
    """ref: lookup_table_op.cc — ids carry a trailing 1 dim."""
    w, ids = x(ins, "W"), x(ins, "Ids")
    if ids.dim() > 1 and ids.shape[-1] == 1:
        ids = ids[..., 0]
    return {"Out": embedding_lookup(w, ids, attrs.get("padding_idx", -1),
                                    _replicated_over_tp(ctx))}


@register("lookup_table_v2")
def _lookup_table_v2(ctx, ins, attrs):
    w, ids = x(ins, "W"), x(ins, "Ids")
    return {"Out": embedding_lookup(w, ids, attrs.get("padding_idx", -1),
                                    _replicated_over_tp(ctx))}


def _gather_label_logp(logp, label, ignore_index=-100):
    lbl = label.reshape(logp.shape[:-1]).long()
    ignored = lbl == ignore_index
    safe = torch.where(ignored, torch.zeros_like(lbl), lbl)
    picked = torch.gather(logp, -1, safe[..., None])[..., 0]
    return torch.where(ignored, torch.zeros((), dtype=picked.dtype,
                                            device=picked.device), picked)


@register("softmax_with_cross_entropy")
def _softmax_with_cross_entropy(ctx, ins, attrs):
    """ref: softmax_with_cross_entropy_op.cc — Softmax and the per-row
    Loss; hard labels are int64 class ids (ignore_index rows give 0)."""
    logits, label = x(ins, "Logits"), x(ins, "Label")
    axis = attrs.get("axis", -1)
    softmax = torch.softmax(logits, dim=axis)
    logp = torch.log_softmax(logits, dim=axis)
    if attrs.get("soft_label", False):
        loss = -(label * logp).sum(dim=axis, keepdim=True)
    else:
        picked = _gather_label_logp(logp.movedim(axis, -1), label,
                                    attrs.get("ignore_index", -100))
        loss = -picked[..., None]
    return {"Softmax": softmax, "Loss": loss}


@register("gather_tokens")
def _gather_tokens(ctx, ins, attrs):
    """Per-sample token positions: (B, S, D) x (B, M) -> (B*M, D), as rows
    of the flattened (B*S, D) table through ``F.embedding``, whose
    backward sums a position drawn twice in a row (masked positions are
    drawn with replacement) in the same order in every run on the card;
    ``torch.gather``'s backward adds such duplicates with atomics in an
    order that changes from run to run."""
    seq, pos = x(ins, "X"), x(ins, "Index").long()
    b, s, d = seq.shape
    rows = (torch.arange(b, device=pos.device)[:, None] * s + pos)
    return {"Out": torch.nn.functional.embedding(rows.reshape(-1),
                                                 seq.reshape(b * s, d))}


@register("arg_max")
def _arg_max(ctx, ins, attrs):
    """Index of the largest entry along ``axis`` (int64); on ties the
    first, as ``jnp.argmax`` and ``torch.argmax`` both take it."""
    a = x(ins, "X")
    out = torch.argmax(a, dim=attrs.get("axis", -1),
                       keepdim=bool(attrs.get("keepdims", False)))
    return {"Out": out.to(torch.int64)}
