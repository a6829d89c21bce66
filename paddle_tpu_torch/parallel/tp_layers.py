"""Tensor-model-parallel layers (Megatron-style column/row parallelism)
— the port of paddle_tpu/parallel/tp_layers.py, emitting the same
program op for op and attr for attr.

Parameters are declared with GLOBAL shapes and a ``dist_attr``
``ShardSpec`` over the tensor axis; the executor holds each rank's block
of them (``collective_ops.block_of``), so the traced local width is
global/tp inside the parallel region.  Activations stay replicated
outside it, sharded on the feature dim inside (column -> row), with the
Megatron f/g ops (ops/tp_ops.py) placing the backward and forward
all-reduces.
"""

from __future__ import annotations

from typing import Optional

from ..framework.layer_helper import LayerHelper, ParamAttr
from ..framework.core import Variable
from ..framework.mesh_layout import ShardSpec


def _append_tp(helper, op_type, x_var, axis_name):
    out = helper.create_variable_for_type_inference(x_var.dtype, x_var.shape)
    helper.append_op(type=op_type, inputs={"X": [x_var]},
                     outputs={"Out": [out]},
                     attrs={"_axis_name": axis_name})
    return out


def column_parallel_fc(x: Variable, size: int, tp_degree: int,
                       axis_name: str = "tp", act: Optional[str] = None,
                       param_attr=None, bias_attr=None, gather_output=False,
                       name: Optional[str] = None) -> Variable:
    """Linear with the weight's OUTPUT dim sharded over `axis_name`.

    y_local = f(x) @ W[:, shard] (+ b[shard]); output feature dim is
    sharded unless gather_output."""
    if size % tp_degree:
        raise ValueError(f"size {size} not divisible by tp degree {tp_degree}")
    helper = LayerHelper(name or "col_parallel_fc", name=name)
    in_dim = int(x.shape[-1])

    # params are declared with GLOBAL shapes + a dist_attr ShardSpec
    # (framework/mesh_layout.py); the executor hands each rank its block
    # (collective_ops.block_of) of the global array the startup program
    # initialises.  Var shape metadata stays GLOBAL throughout; the
    # local shapes are what actually flow.
    x = _append_tp(helper, "mp_copy", x, axis_name)     # f: bwd AllReduce
    w = helper.create_parameter(param_attr, [in_dim, size], x.dtype)
    w.dist_attr = ShardSpec((None, axis_name))
    out = helper.create_variable_for_type_inference(
        x.dtype, tuple(x.shape[:-1]) + (size,))
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [w]},
                     outputs={"Out": [out]}, attrs={})
    if bias_attr is not False:
        b = helper.create_parameter(bias_attr, [size], x.dtype, is_bias=True)
        b.dist_attr = ShardSpec((axis_name,))
        out2 = helper.create_variable_for_type_inference(x.dtype, out.shape)
        helper.append_op(type="elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [out2]}, attrs={"axis": -1})
        out = out2
    out = helper.append_activation(out, act)
    if gather_output:
        gathered = helper.create_variable_for_type_inference(
            out.dtype, tuple(out.shape[:-1]) + (size,))
        helper.append_op(type="c_allgather", inputs={"X": [out]},
                         outputs={"Out": [gathered]},
                         attrs={"_axis_name": axis_name, "gather_dim": -1})
        out = gathered
    return out


def row_parallel_fc(x: Variable, size: int, tp_degree: int,
                    axis_name: str = "tp", act: Optional[str] = None,
                    param_attr=None, bias_attr=None,
                    input_is_parallel: bool = True,
                    name: Optional[str] = None) -> Variable:
    """Linear with the weight's INPUT dim sharded; partial outputs are
    AllReduce-summed (g collective) back to replicated."""
    helper = LayerHelper(name or "row_parallel_fc", name=name)
    in_dim = int(x.shape[-1])        # GLOBAL feature dim (metadata)
    if in_dim % tp_degree:
        raise ValueError(f"input dim {in_dim} not divisible by {tp_degree}")
    w = helper.create_parameter(param_attr, [in_dim, size], x.dtype)
    # input-dim sharded → local [in/tp, size]
    w.dist_attr = ShardSpec((axis_name, None))
    out = helper.create_variable_for_type_inference(
        x.dtype, tuple(x.shape[:-1]) + (size,))
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [w]},
                     outputs={"Out": [out]}, attrs={})
    out = _append_tp(helper, "mp_allreduce_sum", out, axis_name)  # g
    if bias_attr is not False:
        # bias added AFTER the reduce, replicated (added once)
        b = helper.create_parameter(bias_attr, [size], x.dtype, is_bias=True)
        out2 = helper.create_variable_for_type_inference(x.dtype, out.shape)
        helper.append_op(type="elementwise_add", inputs={"X": [out], "Y": [b]},
                         outputs={"Out": [out2]}, attrs={"axis": -1})
        out = out2
    return helper.append_activation(out, act)


def vocab_parallel_embedding(ids: Variable, vocab_size: int, embed_dim: int,
                             tp_degree: int, axis_name: str = "tp",
                             param_attr=None,
                             name: Optional[str] = None) -> Variable:
    """Embedding with the vocab dim sharded (ref: the reference's sharded
    lookup-table path, distributed_lookup_table_op + c_embedding)."""
    if vocab_size % tp_degree:
        raise ValueError(f"vocab {vocab_size} not divisible by {tp_degree}")
    helper = LayerHelper(name or "vocab_parallel_embedding", name=name)
    local_vocab = vocab_size // tp_degree
    w = helper.create_parameter(param_attr, [vocab_size, embed_dim],
                                "float32")
    w.dist_attr = ShardSpec((axis_name, None))   # vocab dim sharded
    out = helper.create_variable_for_type_inference(
        "float32", tuple(ids.shape) + (embed_dim,))
    # c_embedding masks out-of-shard ids and sums the partial lookups over
    # tp; its backward scatter-adds into the local rows only
    helper.append_op(type="c_embedding", inputs={"W": [w], "Ids": [ids]},
                     outputs={"Out": [out]},
                     attrs={"_axis_name": axis_name,
                            "per_shard_rows": local_vocab})
    return out


def parallel_ffn(x: Variable, hidden: int, ffn_hidden: int, tp_degree: int,
                 axis_name: str = "tp", act: str = "gelu",
                 name: Optional[str] = None) -> Variable:
    """Column→row parallel MLP block: one AllReduce per FFN (vs two naive)."""
    h = column_parallel_fc(x, ffn_hidden, tp_degree, axis_name, act=act,
                           name=(name or "ffn") + "_in")
    return row_parallel_fc(h, hidden, tp_degree, axis_name,
                           name=(name or "ffn") + "_out")


def parallel_multihead_attention(x: Variable, hidden: int, num_heads: int,
                                 tp_degree: int, axis_name: str = "tp",
                                 seq_axis: Optional[str] = None,
                                 attn_mask: Optional[Variable] = None,
                                 kv_mask: Optional[Variable] = None,
                                 dropout: float = 0.0,
                                 name: Optional[str] = None) -> Variable:
    """Multi-head self-attention with heads sharded over tp (QKV column
    parallel, output projection row parallel).  With `seq_axis`, attention
    itself runs ring-wise over the sequence-parallel axis
    (parallel/ring_attention.py) — the long-context capability the
    reference lacks (SURVEY §5 Long-context)."""
    if num_heads % tp_degree:
        raise ValueError(f"heads {num_heads} not divisible by {tp_degree}")
    helper = LayerHelper(name or "parallel_attn", name=name)
    local_heads = num_heads // tp_degree
    head_dim = hidden // num_heads
    nm = name or "attn"

    q = column_parallel_fc(x, hidden, tp_degree, axis_name, name=nm + "_q")
    k = column_parallel_fc(x, hidden, tp_degree, axis_name, name=nm + "_k")
    v = column_parallel_fc(x, hidden, tp_degree, axis_name, name=nm + "_v")
    # var metadata stays GLOBAL (hidden); the traced local width is
    # hidden/tp — consistent with the column-parallel convention
    out = helper.create_variable_for_type_inference(
        x.dtype, tuple(x.shape[:-1]) + (hidden,))
    inputs = {"Q": [q], "K": [k], "V": [v]}
    if attn_mask is not None:
        inputs["AttnBias"] = [attn_mask]
    if kv_mask is not None:
        inputs["KVMask"] = [kv_mask]
    # n_head is the GLOBAL head count + head_dim: the op derives the
    # LOCAL head count from the traced q width (hidden/tp on the mesh,
    # full hidden off-mesh where collectives are identity) — baking
    # local_heads in would mis-shape the off-mesh fallback (r5 parity)
    helper.append_op(
        type="fused_attention", inputs=inputs, outputs={"Out": [out]},
        attrs={"n_head": num_heads, "head_dim": head_dim,
               "dropout_rate": dropout, "_seq_axis": seq_axis})
    return row_parallel_fc(out, hidden, tp_degree, axis_name,
                           name=nm + "_proj")
