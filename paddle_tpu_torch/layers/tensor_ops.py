"""Tensor manipulation layers — the port of paddle_tpu/layers/tensor_ops.py
(the builders the BERT encoder calls)."""

from __future__ import annotations

import numpy as np

from ..framework.core import convert_dtype
from ..framework.layer_helper import LayerHelper


def cast(x, dtype, name=None):
    helper = LayerHelper("cast", name=name)
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype, x.shape)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"out_dtype": dtype})
    return out


def fill_constant(shape, dtype, value, name=None):
    helper = LayerHelper("fill_constant", name=name)
    dtype = convert_dtype(dtype)
    out = helper.create_variable_for_type_inference(dtype, tuple(shape),
                                                    stop_gradient=True)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": list(shape), "dtype": dtype,
                            "value": float(value)})
    return out


def reshape(x, shape, inplace=False, name=None):
    helper = LayerHelper("reshape2", name=name)
    new_shape = list(shape)
    for i, s in enumerate(new_shape):
        if s == 0:
            new_shape[i] = x.shape[i]
    known = 1
    for s in new_shape:
        if s > 0:
            known *= s
    if -1 in new_shape and all(d >= 0 for d in x.shape):
        new_shape[new_shape.index(-1)] = int(np.prod(x.shape) // known)
    out = helper.create_variable_for_type_inference(x.dtype, tuple(new_shape))
    xshape = helper.create_variable_for_type_inference(
        x.dtype, (0,) + tuple(x.shape))
    helper.append_op(type="reshape2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"shape": list(shape)})
    return out


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose2", name=name)
    shape = tuple(x.shape[p] for p in perm)
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    xshape = helper.create_variable_for_type_inference(
        x.dtype, (0,) + tuple(x.shape))
    helper.append_op(type="transpose2", inputs={"X": [x]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axis": list(perm)})
    return out


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", name=name)
    nd = len(input.shape)
    ax = dim % nd
    total = input.shape[ax]
    if isinstance(num_or_sections, int):
        sections = [total // num_or_sections] * num_or_sections
        attrs = {"num": num_or_sections, "sections": [], "axis": ax}
    else:
        sections = list(num_or_sections)
        attrs = {"num": 0, "sections": sections, "axis": ax}
    outs = []
    for s in sections:
        shape = tuple(s if i == ax else d for i, d in enumerate(input.shape))
        outs.append(helper.create_variable_for_type_inference(input.dtype,
                                                              shape))
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze2", name=name)
    axes = [axes] if isinstance(axes, int) else list(axes)
    shape = list(input.shape)
    for ax in sorted(axes):
        shape.insert(ax if ax >= 0 else ax + len(shape) + 1, 1)
    out = helper.create_variable_for_type_inference(input.dtype, tuple(shape))
    xshape = helper.create_variable_for_type_inference(
        input.dtype, (0,) + tuple(input.shape))
    helper.append_op(type="unsqueeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": axes})
    return out


def squeeze(input, axes=None, name=None):
    helper = LayerHelper("squeeze2", name=name)
    axes = axes or []
    nd = len(input.shape)
    norm = [ax % nd for ax in axes]
    if norm:
        shape = tuple(s for i, s in enumerate(input.shape) if i not in norm)
    else:
        shape = tuple(s for s in input.shape if s != 1)
    out = helper.create_variable_for_type_inference(input.dtype, shape)
    xshape = helper.create_variable_for_type_inference(
        input.dtype, (0,) + tuple(input.shape))
    helper.append_op(type="squeeze2", inputs={"X": [input]},
                     outputs={"Out": [out], "XShape": [xshape]},
                     attrs={"axes": axes})
    return out


def slice(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", name=name)
    shape = list(input.shape)
    for ax, s, e in zip(axes, starts, ends):
        dim = shape[ax]
        if dim == -1:
            continue
        s2 = max(s + dim, 0) if s < 0 else min(s, dim)
        e2 = max(e + dim, 0) if e < 0 else min(e, dim)
        shape[ax] = max(e2 - s2, 0)
    out = helper.create_variable_for_type_inference(input.dtype, tuple(shape))
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": list(axes), "starts": list(starts),
                            "ends": list(ends), "decrease_axis": []})
    return out


def assign(input, output=None, name=None):
    """``output`` (a new variable when None) set to ``input``: a variable,
    or a numpy array / scalar held as an ``assign_value`` constant."""
    helper = LayerHelper("assign", name=name)
    if isinstance(input, np.ndarray) or np.isscalar(input):
        arr = np.asarray(input)
        out = output if output is not None else \
            helper.create_variable_for_type_inference(str(arr.dtype),
                                                      arr.shape)
        helper.append_op(type="assign_value", outputs={"Out": [out]},
                         attrs={"shape": list(arr.shape),
                                "dtype": convert_dtype(arr.dtype),
                                "values": arr.reshape(-1).tolist()})
        return out
    out = output if output is not None else \
        helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="assign", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out
