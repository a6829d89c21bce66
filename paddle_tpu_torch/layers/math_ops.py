"""Math layer functions — the port of paddle_tpu/layers/math_ops.py (the
builders the BERT encoder calls and the Variable operator overloads).
Each appends one op and computes the static output shape, exactly as the
JAX package does, so both packages build the same program."""

from __future__ import annotations

import numpy as np

from ..framework.core import Variable
from ..framework.layer_helper import LayerHelper


def _broadcast_shape(s1, s2):
    out = []
    for a, b in zip(reversed(list(s1)), reversed(list(s2))):
        if a == -1 or b == -1:
            out.append(-1 if max(a, b) <= 1 else max(a, b))
        else:
            out.append(max(a, b))
    longer = s1 if len(s1) >= len(s2) else s2
    return tuple(longer[:len(longer) - len(out)]) + tuple(reversed(out))


def _to_variable(x, like=None, dtype="float32"):
    """Wrap python scalars / numpy arrays as fill_constant vars."""
    if isinstance(x, Variable):
        return x
    helper = LayerHelper("constant")
    if np.isscalar(x):
        dtype = like.dtype if like is not None else dtype
        out = helper.create_variable_for_type_inference(dtype, (1,))
        helper.append_op(type="fill_constant", outputs={"Out": [out]},
                         attrs={"shape": [1], "dtype": dtype,
                                "value": float(x)})
        return out
    arr = np.asarray(x)
    out = helper.create_variable_for_type_inference(str(arr.dtype), arr.shape)
    helper.append_op(type="assign_value", outputs={"Out": [out]},
                     attrs={"shape": list(arr.shape), "dtype": str(arr.dtype),
                            "values": arr.reshape(-1).tolist()})
    return out


def _binary(op_type, x, y, axis=-1, act=None, name=None):
    x = _to_variable(x)
    y = _to_variable(y, like=x)
    helper = LayerHelper(op_type, name=name)
    shape = _broadcast_shape(x.shape, y.shape)
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out, act)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_div", x, y, axis, act, name)


def _unary(op_type, x, name=None, **attrs):
    helper = LayerHelper(op_type, name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def relu(x, name=None):
    return _unary("relu", x, name)


def sigmoid(x, name=None):
    return _unary("sigmoid", x, name)


def tanh(x, name=None):
    return _unary("tanh", x, name)


def gelu(x, approximate=False, name=None):
    return _unary("gelu", x, name, approximate=approximate)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None, name=None):
    helper = LayerHelper("scale", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(type="scale", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out, act)


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", name=name)
    xs = list(x.shape)
    ys = list(y.shape)
    if transpose_x and len(xs) >= 2:
        xs[-1], xs[-2] = xs[-2], xs[-1]
    if transpose_y and len(ys) >= 2:
        ys[-1], ys[-2] = ys[-2], ys[-1]
    if len(xs) >= 2 and len(ys) >= 2:
        batch = xs[:-2] if len(xs) >= len(ys) else ys[:-2]
        shape = tuple(batch) + (xs[-2], ys[-1])
    elif len(ys) == 1:
        shape = tuple(xs[:-1])
    else:
        shape = tuple(ys[1:])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y, "alpha": alpha})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", name=name)
    shape = tuple(x.shape[:x_num_col_dims]) + tuple(y.shape[y_num_col_dims:])
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
    return out


def mean(x, name=None):
    """The mean of every element of ``x``, as a scalar variable."""
    helper = LayerHelper("mean", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, ())
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def sum(x, name=None):
    """The elementwise sum of a list of variables (one ``sum`` op)."""
    xs = x if isinstance(x, (list, tuple)) else [x]
    helper = LayerHelper("sum", name=name)
    out = helper.create_variable_for_type_inference(xs[0].dtype, xs[0].shape)
    helper.append_op(type="sum", inputs={"X": list(xs)},
                     outputs={"Out": [out]})
    return out


def square(x, name=None):
    return _unary("square", x, name)


def elementwise_mod(x, y, axis=-1, act=None, name=None):
    return _binary("elementwise_mod", x, y, axis, act, name)


def _reduce(op_type, x, dim=None, keep_dim=False, name=None):
    helper = LayerHelper(op_type, name=name)
    reduce_all = dim is None
    if dim is None:
        dims = list(range(len(x.shape)))
    elif isinstance(dim, int):
        dims = [dim]
    else:
        dims = list(dim)
    dims_norm = [d % len(x.shape) for d in dims] if x.shape else []
    if keep_dim:
        shape = tuple(1 if i in dims_norm else s
                      for i, s in enumerate(x.shape))
    else:
        shape = tuple(s for i, s in enumerate(x.shape) if i not in dims_norm)
    if reduce_all and not keep_dim:
        shape = ()
    out = helper.create_variable_for_type_inference(x.dtype, shape)
    helper.append_op(type=op_type, inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"dim": dims, "keep_dim": keep_dim,
                            "reduce_all": reduce_all})
    return out


def reduce_sum(x, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", x, dim, keep_dim, name)


def _compare(op_type, x, y, name=None, cond=None):
    """A bool variable of the broadcast shape (``cond``: an existing bool
    variable written in place of a new one)."""
    x = _to_variable(x)
    y = _to_variable(y, like=x)
    helper = LayerHelper(op_type, name=name)
    out = cond if cond is not None else \
        helper.create_variable_for_type_inference(
            "bool", _broadcast_shape(x.shape, y.shape))
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def equal(x, y, cond=None, name=None):
    return _compare("equal", x, y, name, cond)


def not_equal(x, y, cond=None, name=None):
    return _compare("not_equal", x, y, name, cond)


def less_than(x, y, force_cpu=None, cond=None, name=None):
    return _compare("less_than", x, y, name, cond)


def less_equal(x, y, cond=None, name=None):
    return _compare("less_equal", x, y, name, cond)


def greater_than(x, y, cond=None, name=None):
    return _compare("greater_than", x, y, name, cond)


def greater_equal(x, y, cond=None, name=None):
    return _compare("greater_equal", x, y, name, cond)


def logical_and(x, y, name=None):
    return _compare("logical_and", x, y, name)


def logical_or(x, y, name=None):
    return _compare("logical_or", x, y, name)


def logical_not(x, name=None):
    return _unary("logical_not", x, name)
