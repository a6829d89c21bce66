"""Tensor manipulation + initialisation ops — the port of
paddle_tpu/ops/tensor_ops.py (the subset the served BERT programs and
their startup programs use).  Random ops draw from the run's seeded
``torch.Generator`` on the run's device."""

from __future__ import annotations

import numpy as np
import torch

from .registry import register, x
from ..framework.core import convert_dtype

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
}


def torch_dtype(dtype) -> torch.dtype:
    """The torch dtype for any dtype spelling the IR carries."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return _TORCH_DTYPES[convert_dtype(dtype)]


def _dtype(attrs, default="float32"):
    return torch_dtype(attrs.get("dtype", default))


# ---------------------------------------------------------------------------
# initialisation / constants
# ---------------------------------------------------------------------------


@register("fill_constant")
def _fill_constant(ctx, ins, attrs):
    shape = attrs.get("shape", [1])
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=_dtype(attrs), device=ctx.device)}


@register("gaussian_random")
def _gaussian_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs.get("shape", [1])), dtype=torch.float32,
                      device=ctx.device)
    out.normal_(attrs.get("mean", 0.0), attrs.get("std", 1.0),
                generator=ctx.generator)
    return {"Out": out.to(_dtype(attrs))}


@register("uniform_random")
def _uniform_random(ctx, ins, attrs):
    out = torch.empty(tuple(attrs.get("shape", [1])), dtype=torch.float32,
                      device=ctx.device)
    out.uniform_(attrs.get("min", -1.0), attrs.get("max", 1.0),
                 generator=ctx.generator)
    return {"Out": out.to(_dtype(attrs))}


@register("truncated_gaussian_random")
def _truncated_gaussian_random(ctx, ins, attrs):
    """Normal(mean, std) truncated to mean ± 2 std, as the JAX package's
    ``truncated_normal(-2, 2) * std + mean``."""
    mean = float(attrs.get("mean", 0.0))
    std = float(attrs.get("std", 1.0))
    out = torch.empty(tuple(attrs.get("shape", [1])), dtype=torch.float32,
                      device=ctx.device)
    torch.nn.init.trunc_normal_(out, mean, std, mean - 2.0 * std,
                                mean + 2.0 * std, generator=ctx.generator)
    return {"Out": out.to(_dtype(attrs))}


@register("assign")
def _assign(ctx, ins, attrs):
    return {"Out": x(ins, "X")}


@register("assign_value")
def _assign_value(ctx, ins, attrs):
    values = attrs.get("values", attrs.get("fp32_values")
                       or attrs.get("int32_values"))
    arr = np.asarray(values).reshape(attrs.get("shape"))
    return {"Out": torch.as_tensor(arr, device=ctx.device).to(
        _dtype(attrs))}


@register("cast")
def _cast(ctx, ins, attrs):
    """To ``out_dtype``, else ``dtype``, else float32 (the JAX op's
    order)."""
    dtype = attrs.get("out_dtype", attrs.get("dtype", "float32"))
    return {"Out": x(ins, "X").to(torch_dtype(dtype))}


@register("increment")
def _increment(ctx, ins, attrs):
    """X + step in X's dtype (ref: increment_op.h — an int counter stays
    int)."""
    a = x(ins, "X")
    return {"Out": a + torch.as_tensor(attrs.get("step", 1.0),
                                       dtype=a.dtype, device=a.device)}


# ---------------------------------------------------------------------------
# shape manipulation
# ---------------------------------------------------------------------------


def _resolve_shape(shape, a):
    """Handle 0 (copy input dim) and -1 (infer) entries."""
    shape = list(shape)
    for i, s in enumerate(shape):
        if s == 0:
            shape[i] = a.shape[i]
    if -1 in shape:
        known = 1
        for s in shape:
            if s != -1:
                known *= s
        shape[shape.index(-1)] = int(a.numel() // known)
    return shape


def _xshape(a):
    """The reference's XShape output: a zero-size record of the input
    shape (never read; a view costs nothing)."""
    return a.new_empty((0,) + tuple(a.shape))


@register("reshape2")
def _reshape2(ctx, ins, attrs):
    a = x(ins, "X")
    return {"Out": a.reshape(_resolve_shape(attrs["shape"], a)),
            "XShape": _xshape(a)}


@register("transpose2")
def _transpose2(ctx, ins, attrs):
    a = x(ins, "X")
    return {"Out": a.permute(*attrs["axis"]), "XShape": _xshape(a)}


def _unsqueeze(a, axes):
    for ax in sorted(axes):
        a = a.unsqueeze(ax)
    return a


@register("unsqueeze2")
def _unsqueeze2(ctx, ins, attrs):
    a = x(ins, "X")
    return {"Out": _unsqueeze(a, attrs["axes"]), "XShape": _xshape(a)}


@register("squeeze2")
def _squeeze2(ctx, ins, attrs):
    """Drop the size-1 ``axes`` (every size-1 axis when none are given);
    an axis of another size raises ValueError, as ``jnp.squeeze`` does,
    where ``torch.squeeze`` would leave it silently."""
    a = x(ins, "X")
    axes = tuple(ax % a.dim() for ax in attrs.get("axes", []))
    wide = [ax for ax in axes if a.shape[ax] != 1]
    if wide:
        raise ValueError(f"squeeze2: cannot squeeze axes {wide} of shape "
                         f"{tuple(a.shape)}: their size is not 1")
    out = a.squeeze(axes) if axes else a.squeeze()
    return {"Out": out, "XShape": _xshape(a)}


@register("concat")
def _concat(ctx, ins, attrs):
    return {"Out": torch.cat(list(ins["X"]), dim=attrs.get("axis", 0))}


@register("split")
def _split(ctx, ins, attrs):
    a = x(ins, "X")
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if sections:
        # cut where the JAX op cuts: after each section but the last
        outs = torch.tensor_split(a, np.cumsum(sections[:-1]).tolist(),
                                  dim=axis)
    else:
        num = attrs.get("num", 0)
        if a.shape[axis] % num:
            raise ValueError(f"split: num {num} does not divide axis "
                             f"{axis} of size {a.shape[axis]}")
        outs = torch.split(a, a.shape[axis] // num, dim=axis)
    return {"Out": list(outs)}


@register("slice")
def _slice(ctx, ins, attrs):
    a = x(ins, "Input")
    idx = [slice(None)] * a.dim()
    for ax, s, e in zip(attrs["axes"], attrs["starts"], attrs["ends"]):
        dim = a.shape[ax]
        s = max(s + dim, 0) if s < 0 else min(s, dim)
        e = max(e + dim, 0) if e < 0 else min(e, dim)
        idx[ax] = slice(s, e)
    out = a[tuple(idx)]
    for ax in sorted(attrs.get("decrease_axis", []), reverse=True):
        out = out.squeeze(ax)
    return {"Out": out}
