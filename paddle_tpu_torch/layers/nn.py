"""NN layer functions — the port of paddle_tpu/layers/nn.py (the builders
the BERT encoder and decoder call: data, fc, layer_norm, embedding,
dropout, argmax)."""

from __future__ import annotations

import numpy as np

from ..framework.core import default_main_program
from ..framework.initializer import ConstantInitializer
from ..framework.layer_helper import LayerHelper


def data(name, shape, dtype="float32", lod_level=0, append_batch_size=True):
    """Declare an input.  With ``append_batch_size`` a leading -1 batch
    dim is added, matching the reference's convention."""
    block = default_main_program().global_block()
    if append_batch_size and (not shape or shape[0] != -1):
        shape = [-1] + list(shape)
    return block.create_var(name=name, shape=shape, dtype=dtype,
                            is_data=True, stop_gradient=True)


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, name=None):
    """Fully connected (ref: layers/nn.py fc) — mul + elementwise_add +
    act."""
    helper = LayerHelper("fc", name=name)
    inputs = input if isinstance(input, (list, tuple)) else [input]
    mul_results = []
    for inp in inputs:
        in_features = int(np.prod(inp.shape[num_flatten_dims:]))
        w = helper.create_parameter(param_attr, [in_features, size],
                                    inp.dtype)
        out_shape = tuple(inp.shape[:num_flatten_dims]) + (size,)
        tmp = helper.create_variable_for_type_inference(inp.dtype, out_shape)
        helper.append_op(type="mul", inputs={"X": [inp], "Y": [w]},
                         outputs={"Out": [tmp]},
                         attrs={"x_num_col_dims": num_flatten_dims,
                                "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_variable_for_type_inference(
            mul_results[0].dtype, mul_results[0].shape)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], pre_bias.dtype,
                                    is_bias=True)
        pre_act = helper.create_variable_for_type_inference(
            pre_bias.dtype, pre_bias.shape)
        # axis aligns the bias to the feature dim
        helper.append_op(type="elementwise_add",
                         inputs={"X": [pre_bias], "Y": [b]},
                         outputs={"Out": [pre_act]},
                         attrs={"axis": num_flatten_dims})
    else:
        pre_act = pre_bias
    return helper.append_activation(pre_act, act)


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", name=name)
    norm_shape = [int(np.prod(input.shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            param_attr, norm_shape, input.dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(bias_attr, norm_shape, input.dtype,
                                    is_bias=True)
        inputs["Bias"] = [b]
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    mean = helper.create_variable_for_type_inference(
        input.dtype, input.shape[:begin_norm_axis])
    var = helper.create_variable_for_type_inference(
        input.dtype, input.shape[:begin_norm_axis])
    helper.append_op(type="layer_norm", inputs=inputs,
                     outputs={"Y": [out], "Mean": [mean], "Variance": [var]},
                     attrs={"epsilon": epsilon,
                            "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out, act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32", name=None):
    """ref: layers/nn.py embedding (lookup_table_v2)."""
    helper = LayerHelper("embedding", name=name)
    w = helper.create_parameter(param_attr, list(size), dtype)
    w.is_distributed = is_distributed
    ids_shape = list(input.shape)
    if ids_shape and ids_shape[-1] == 1:
        ids_shape = ids_shape[:-1]
    out = helper.create_variable_for_type_inference(
        dtype, tuple(ids_shape) + (size[1],))
    helper.append_op(type="lookup_table_v2",
                     inputs={"W": [w], "Ids": [input]},
                     outputs={"Out": [out]},
                     attrs={"padding_idx": -1 if padding_idx is None
                            else padding_idx})
    return out


def softmax(input, axis=-1, name=None, use_cudnn=False):
    helper = LayerHelper("softmax", name=name)
    out = helper.create_variable_for_type_inference(input.dtype, input.shape)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def dropout(x, dropout_prob, is_test=False, seed=None, name=None,
            dropout_implementation="downgrade_in_infer"):
    helper = LayerHelper("dropout", name=name)
    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    mask = helper.create_variable_for_type_inference("uint8", x.shape,
                                                     stop_gradient=True)
    helper.append_op(type="dropout", inputs={"X": [x]},
                     outputs={"Out": [out], "Mask": [mask]},
                     attrs={"dropout_prob": dropout_prob, "is_test": is_test,
                            "dropout_implementation": dropout_implementation})
    return out


def argmax(x, axis=-1, keepdims=False, name=None):
    helper = LayerHelper("arg_max", name=name)
    nd = len(x.shape)
    ax = axis % nd
    if keepdims:
        shape = tuple(1 if i == ax else s for i, s in enumerate(x.shape))
    else:
        shape = tuple(s for i, s in enumerate(x.shape) if i != ax)
    out = helper.create_variable_for_type_inference("int64", shape,
                                                    stop_gradient=True)
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": axis, "keepdims": keepdims})
    return out
