"""Dense math ops — the port of paddle_tpu/ops/math_ops.py (the subset the
BERT serving and pretraining programs use, and the modulo, comparison and
logical ops the wrapper optimizers' step masks and ``cond`` predicates are
built from).  Slot names and attribute semantics are the
reference's.  Matrix products are ``torch.matmul`` — plain products the
JAX package leaves to XLA stay library calls; on the card they run in full
float32 (``core.device_for`` turns TF32 off), and in bf16 / fp16 (the
mixed-precision program) with float32 accumulation and a low-precision
output, the JAX package's ``preferred_element_type=float32`` then a cast.

A Python scalar attribute (``scale``'s scale and bias, ``matmul``'s
alpha) meets a bf16 / fp16 tensor as JAX's weak typing has it meet one:
rounded to the tensor's dtype first (:func:`_weak`), so BERT's padding
bias ``mask * 1e4 - 1e4`` gives 0 and -9984 in bf16 on every device."""

from __future__ import annotations

import torch

from .registry import register, x


# ---------------------------------------------------------------------------
# elementwise binary family
# Paddle broadcasting: Y's shape aligns to X starting at `axis`
# (axis == -1 → numpy-style trailing alignment).
# ---------------------------------------------------------------------------

def _bcast(a, b, axis):
    if axis is None or axis == -1 or a.dim() == b.dim():
        return a, b
    new_shape = [1] * a.dim()
    for i, s in enumerate(b.shape):
        new_shape[axis + i] = s
    return a, b.reshape(new_shape)


def _elementwise(fn):
    def impl(ctx, ins, attrs):
        a, b = x(ins, "X"), x(ins, "Y")
        a, b = _bcast(a, b, attrs.get("axis", -1))
        return {"Out": fn(a, b)}
    return impl


register("elementwise_add")(_elementwise(torch.add))
register("elementwise_sub")(_elementwise(torch.sub))
register("elementwise_mul")(_elementwise(torch.mul))
register("elementwise_div")(_elementwise(torch.div))
register("elementwise_max")(_elementwise(torch.maximum))
register("elementwise_min")(_elementwise(torch.minimum))
# floored modulo, the sign of the divisor (jnp.mod)
register("elementwise_mod")(_elementwise(torch.remainder))


@register("sum")
def _sum(ctx, ins, attrs):
    xs = ins["X"]
    out = xs[0]
    for v in xs[1:]:
        out = out + v
    return {"Out": out}


_LOW_PRECISION = (torch.bfloat16, torch.float16)


def _weak(value, t):
    """Python scalar ``value`` as it meets tensor ``t`` in the JAX
    package: rounded to ``t``'s dtype when that is bf16 / fp16 (on the
    host: no device op)."""
    if t.dtype in _LOW_PRECISION:
        return float(torch.tensor(float(value), dtype=t.dtype))
    return value


@register("scale")
def _scale(ctx, ins, attrs):
    a = x(ins, "X")
    s = _weak(attrs.get("scale", 1.0), a)
    b = _weak(attrs.get("bias", 0.0), a)
    if attrs.get("bias_after_scale", True):
        return {"Out": a * s + b}
    return {"Out": (a + b) * s}


# ---------------------------------------------------------------------------
# matmul / mul
# ---------------------------------------------------------------------------


def _flatten2(a, num_col_dims):
    lead = 1
    for s in a.shape[:num_col_dims]:
        lead *= s
    return a.reshape(lead, -1)


@register("mul")
def _mul(ctx, ins, attrs):
    """2-D GEMM with leading-dim flattening (ref: mul_op.cc)."""
    a, b = x(ins, "X"), x(ins, "Y")
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    out_shape = tuple(a.shape[:xn]) + tuple(b.shape[yn:])
    out = torch.matmul(_flatten2(a, xn), _flatten2(b, yn))
    return {"Out": out.reshape(out_shape)}


@register("matmul")
def _matmul(ctx, ins, attrs):
    a, b = x(ins, "X"), x(ins, "Y")
    if attrs.get("transpose_X", False) and a.dim() > 1:
        a = a.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and b.dim() > 1:
        b = b.transpose(-1, -2)
    out = torch.matmul(a, b)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * _weak(alpha, out)
    return {"Out": out}


@register("matmul_v2")
def _matmul_v2(ctx, ins, attrs):
    a, b = x(ins, "X"), x(ins, "Y")
    if attrs.get("trans_x", False):
        a = a.transpose(-1, -2)
    if attrs.get("trans_y", False):
        b = b.transpose(-1, -2)
    return {"Out": torch.matmul(a, b)}


# ---------------------------------------------------------------------------
# activations (ref: operators/activation_op.cc)
# ---------------------------------------------------------------------------

def _unary(fn):
    def impl(ctx, ins, attrs):
        return {"Out": fn(x(ins, "X"))}
    return impl


def gelu(a, approximate=False):
    """Exact-erf GELU (the stock op), or the tanh form when asked —
    written out, as jax.nn.gelu computes it."""
    if approximate:
        c = 0.7978845608028654              # sqrt(2 / pi)
        return 0.5 * a * (1.0 + torch.tanh(c * (a + 0.044715 * a ** 3)))
    return 0.5 * a * (1.0 + torch.erf(a * 0.7071067811865476))


register("relu")(_unary(torch.relu))
register("sigmoid")(_unary(torch.sigmoid))
register("tanh")(_unary(torch.tanh))
register("exp")(_unary(torch.exp))
register("sqrt")(_unary(torch.sqrt))
register("abs")(_unary(torch.abs))
register("erf")(_unary(torch.erf))
register("square")(_unary(torch.square))
register("logical_not")(_unary(torch.logical_not))


# ---------------------------------------------------------------------------
# comparisons and logical ops: numpy broadcasting, the operands promoted
# to their common type first (jnp's rules for same-kind operands), a bool
# result
# ---------------------------------------------------------------------------


def _cmp(fn):
    def impl(ctx, ins, attrs):
        return {"Out": fn(x(ins, "X"), x(ins, "Y"))}
    return impl


register("equal")(_cmp(torch.eq))
register("not_equal")(_cmp(torch.ne))
register("less_than")(_cmp(torch.lt))
register("less_equal")(_cmp(torch.le))
register("greater_than")(_cmp(torch.gt))
register("greater_equal")(_cmp(torch.ge))
register("logical_and")(_cmp(torch.logical_and))
register("logical_or")(_cmp(torch.logical_or))
register("logical_xor")(_cmp(torch.logical_xor))


@register("reduce_sum")
def _reduce_sum(ctx, ins, attrs):
    a = x(ins, "X")
    keep = attrs.get("keep_dim", False)
    dim = attrs.get("dim", [0])
    dim = [dim] if isinstance(dim, int) else list(dim)
    if attrs.get("reduce_all", False) or not dim:      # every axis
        if a.dim() == 0:
            return {"Out": a.clone()}
        dim = range(a.dim())
    dims = tuple(d % a.dim() for d in dim)
    return {"Out": torch.sum(a, dim=dims, keepdim=keep)}


@register("gelu")
def _gelu(ctx, ins, attrs):
    return {"Out": gelu(x(ins, "X"), attrs.get("approximate", False))}


@register("mean")
def _mean(ctx, ins, attrs):
    """The mean of every element, as a 0-d tensor."""
    return {"Out": torch.mean(x(ins, "X"))}


# ---------------------------------------------------------------------------
# gradient clipping (ref: operators/clip_op, clip_by_norm_op,
# squared_l2_norm_op)
# ---------------------------------------------------------------------------


@register("clip")
def _clip(ctx, ins, attrs):
    return {"Out": torch.clamp(x(ins, "X"), attrs.get("min"),
                               attrs.get("max"))}


@register("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs):
    a = x(ins, "X")
    max_norm = attrs["max_norm"]
    norm = torch.sqrt(torch.sum(a * a))
    scale = torch.where(norm > max_norm,
                        max_norm / torch.clamp(norm, min=1e-12),
                        torch.ones_like(norm))
    return {"Out": a * scale.to(a.dtype)}


@register("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs):
    a = x(ins, "X")
    return {"Out": torch.sum(a * a).reshape(1)}
