"""The kernel-route table — the port's counterpart of the ``pallas=``
routes in paddle_tpu/ops/op_specs.py.

Each :class:`~.registry.CudaLowering` below carries a ``supported``
predicate stating exactly what its CUDA kernel rejects (head dims, norm
widths, dtypes), evaluated on the op's input tensors, so
``cuda_route`` reports every hit and every fallback with its reason, and
refuses (raises) on the card what a gate rejects.  :func:`kernel_facts`
gives each kernel's source and the TPU kernel it replaces.

The static channels of the JAX package's op specs ride here too, for the
pipeline's stage-cut planner (``framework/pipe.py``) and the static
estimators (``framework/memory_analysis.py``, ``observability/flops.py``,
``framework/shard_planner.py``): :data:`FLOPS`, the forward GEMM-class
FLOPs of an op from its input and output signatures (``flops(ins, outs,
attrs)``, the JAX ``op_specs.py`` functions for the ops the ported
programs use, the MoE pipeline's included), :data:`COLLECTIVE_OPS`, the
op types the JAX package flags ``collective``, :data:`WIRE_SPECS`, each
collective's ring cost (``wire(ins, attrs, axis_sizes)``), and the byte
channels ``mem_transparent`` / ``mem_backward_extra``.  All of them are
registered as ``registry.OpSpec`` entries (``registry.OP_SPECS``) by
:func:`register_default_specs`."""

from __future__ import annotations

import torch

from .cuda import flash_attention as cuda_flash
from .cuda import fused_ops as cuda_fused
from .cuda import optimizer as cuda_opt
from .cuda import quant_kernels as cuda_quant
from .quantize_wire import CompressionSpec
from .registry import ROUTES, CudaLowering, register_routes, x


def _attn_dims(ins, attrs):
    """(b, h, s, sk, d) from the fused_attention Q/K/V slots, or None."""
    q, k = x(ins, "Q"), x(ins, "K")
    if q is None or k is None or q.dim() != 3 or k.dim() != 3:
        return None
    hd = int(q.shape[-1])
    n_head = attrs.get("n_head", 1)
    head_dim = attrs.get("head_dim")
    if head_dim:
        n_head = max(1, hd // int(head_dim))
    if n_head <= 0 or hd % n_head:
        return None
    return int(q.shape[0]), n_head, int(q.shape[1]), int(k.shape[1]), \
        hd // n_head


def _flash_supported(ins, attrs):
    dims = _attn_dims(ins, attrs)
    if dims is None:
        return False, "shape-unknown"
    _, _, s, sk, d = dims
    rate = 0.0 if attrs.get("is_test") else \
        float(attrs.get("dropout_rate", 0.0))
    return cuda_flash.supported(s, sk, d, x(ins, "Q").dtype,
                                bool(attrs.get("causal")), rate)


def _ring_supported(ins, attrs):
    """The ring's inner step on the flash kernels (the JAX package's
    ``_pl_ring_supported``): an explicit AttnBias is per-source-block
    semantics the kernel step does not take; else the kernels' own gate
    on the local shard (no causal flag: the ring's causal mask rides in
    its bias; no dropout: the ring applies none)."""
    if x(ins, "AttnBias") is not None:
        return False, "ring-explicit-bias"
    dims = _attn_dims(ins, attrs)
    if dims is None:
        return False, "shape-unknown"
    _, _, s, sk, d = dims
    return cuda_flash.supported(s, sk, d, x(ins, "Q").dtype)


def _cached_attn_total(ins):
    """Gathered context length T = max_blocks_per_seq * block_size of the
    cache-read fused_attention variant, or None."""
    pool, table = x(ins, "KPool"), x(ins, "BlockTable")
    if pool is None or table is None or pool.dim() != 3 or table.dim() != 2:
        return None
    return int(table.shape[1]) * int(pool.shape[1])


def _cached_flash_supported(ins, attrs):
    """The cache-read route: the gathered context hands the flash forward
    kernel a (B, H, Sq, T) problem with T the table window, so the gate is
    the kernel's own at Sk = T, no causal flag (QPos rides in the bias)
    and no dropout.  Sq = 1 (a decode step) is accepted: the JAX gate
    (``_pl_cached_supported``) sends it to the gather + einsum composition
    because the TPU kernel's 128-row query tile cannot price a one-token
    query, but this kernel masks the rows past Sq in its 32-row blocks and
    takes any Sq and Sk, as it does any Adam size or quant width the TPU
    tiling refused."""
    q = x(ins, "Q")
    t = _cached_attn_total(ins)
    if x(ins, "KPool") is None:
        return False, "not-cached"
    if q is None or q.dim() != 3 or t is None:
        return False, "shape-unknown"
    hd = int(q.shape[-1])
    n_head = attrs.get("n_head", 1)
    head_dim = attrs.get("head_dim")
    if head_dim:
        n_head = max(1, hd // int(head_dim))
    if n_head <= 0 or hd % n_head:
        return False, "shape-unknown"
    return cuda_flash.supported(int(q.shape[1]), t, hd // n_head, q.dtype,
                                False, 0.0)


def _mhm_supported(ins, attrs):
    q, k = x(ins, "Q"), x(ins, "K")
    if q is None or k is None or q.dim() != 4 or k.dim() != 4:
        return False, "shape-unknown"
    if attrs.get("dropout_rate") and not attrs.get("is_test"):
        # the inference pattern's dropout (downgrade_in_infer by default)
        # does not upscale in training, the kernel's mask does
        return False, "dropout"
    return cuda_flash.supported(int(q.shape[2]), int(k.shape[2]),
                                int(q.shape[3]), q.dtype, False)


def _norm_rows_supported(ins, attrs):
    a = x(ins, "X")
    scale, bias = x(ins, "Scale"), x(ins, "Bias")
    if scale is None or bias is None:
        return False, "no-affine"
    # a 16-bit Scale/Bias beside float32 X (a pure-bf16 program's
    # parameters under a float32 LayerNorm) widens exactly: the op casts it
    for t in (scale, bias):
        if t.dtype != a.dtype and not (
                a.dtype == torch.float32 and
                t.dtype in (torch.bfloat16, torch.float16)):
            return False, f"affine-dtype:{t.dtype}"
    d = 1
    for s in a.shape[attrs.get("begin_norm_axis", 1):]:
        d *= int(s)
    return cuda_fused.ln_supported(d, a.dtype)


def _add_ln_supported(ins, attrs):
    res = x(ins, "Residual")
    if res is None:
        return False, "no-residual"
    if res.shape != x(ins, "X").shape or res.dtype != x(ins, "X").dtype:
        return False, "residual-shape"
    return _norm_rows_supported(ins, attrs)


def _is_bias_gelu(attrs):
    return list(attrs.get("functor_list", ["elementwise_add", "relu"])) == \
        ["elementwise_add", "gelu"]


def _bias_gelu_supported(ins, attrs):
    a, b = x(ins, "X"), x(ins, "Y")
    if a is None or b is None:
        return False, "shape-unknown"
    if b.dim() != 1 or a.shape[-1] != b.shape[0]:
        return False, "bias-not-last-dim"
    axis = attrs.get("axis", -1)
    if axis not in (-1, a.dim() - 1):
        return False, f"axis:{axis}"
    if b.dtype != a.dtype:
        return False, f"bias-dtype:{b.dtype}"
    return cuda_fused.bg_supported(int(a.shape[-1]), a.dtype)


def _is_dense_adam(attrs):
    return not attrs.get("lazy_mode")


def _adam_supported(ins, attrs):
    # no gradient: the op casts it to the first moment's dtype before the
    # launch, as the JAX op does, and the wrapper checks it then
    return cuda_opt.adam_supported(x(ins, "Param"), None,
                                   x(ins, "Moment1"), x(ins, "Moment2"),
                                   x(ins, "Beta1Pow"), x(ins, "Beta2Pow"))


def _dequant_acc_supported(ins, attrs):
    """The receive stage of a quantized all-reduce over ``_n_peers``
    ranks (the collective op adds it): what the CUDA kernels reject."""
    spec = CompressionSpec.from_attr(attrs.get("quant_spec"))
    if spec is None:
        return False, "no-quant-spec"
    n = attrs.get("_n_peers")
    numel = sum(t.numel() for t in ins.get("X", []))
    blocks = -(-numel // (n * spec.block_size)) if n and numel else None
    return cuda_quant.supported(n, blocks, spec)


_CSRC = "paddle_tpu_torch/ops/cuda/csrc/"
# the Pallas kernel each route's CUDA kernel replaces, as file:line
_FLASH_TPU = "paddle_tpu/ops/pallas/flash_attention.py:77"    # _fwd_kernel
_FLASH_DQ_TPU = "paddle_tpu/ops/pallas/flash_attention.py:133"  # _bwd_dq_kernel
_FLASH_DKV_TPU = "paddle_tpu/ops/pallas/flash_attention.py:177"  # _bwd_dkv_kernel
_LN_TPU = "paddle_tpu/ops/pallas/fused_ops.py:58"             # _ln_fwd_kernel
_LN_BWD_TPU = "paddle_tpu/ops/pallas/fused_ops.py:68"         # _ln_bwd_kernel
_ADD_LN_TPU = "paddle_tpu/ops/pallas/fused_ops.py:152"        # _aln_fwd_kernel
_ADD_LN_BWD_TPU = "paddle_tpu/ops/pallas/fused_ops.py:162"    # _aln_bwd_kernel
_BIAS_GELU_TPU = "paddle_tpu/ops/pallas/fused_ops.py:259"     # _bg_fwd_kernel
_BIAS_GELU_BWD_TPU = "paddle_tpu/ops/pallas/fused_ops.py:264"  # _bg_bwd_kernel
_ADAM_TPU = "paddle_tpu/ops/pallas/fused_ops.py:331"          # _adam_kernel
_DQ_ACC_TPU = "paddle_tpu/ops/pallas/quant_kernels.py:91"     # _dq_acc_kernel
_DQ_ACC_RQ_TPU = "paddle_tpu/ops/pallas/quant_kernels.py:111"  # _dq_acc_requant_kernel

# flash forward, dq and dk/dv: two sources, so the facts name each one
ROUTE_FLASH = CudaLowering(
    "flash_attention", flag="use_flash_attention", attr="use_flash",
    match=lambda attrs: not attrs.get("_seq_axis")
    and not attrs.get("_cached"),
    supported=_flash_supported,
    kernels=("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv"),
    replaces=(_FLASH_TPU, _FLASH_DQ_TPU, _FLASH_DKV_TPU),
    source=(_CSRC + "flash_attention.cu", _CSRC + "flash_attention_bwd.cu",
            _CSRC + "flash_attention_bwd.cu"))
# sequence parallelism: each rotated K/V block of the ring on the same
# three kernels, the lse differentiable (the JAX package's _PL_RING)
ROUTE_RING_FLASH = CudaLowering(
    "ring_flash_attention", flag="use_flash_attention", attr="use_flash",
    match=lambda attrs: bool(attrs.get("_seq_axis")),
    supported=_ring_supported,
    kernels=("flash_attention_fwd", "flash_attention_bwd_dq",
             "flash_attention_bwd_dkv"),
    replaces=(_FLASH_TPU, _FLASH_DQ_TPU, _FLASH_DKV_TPU),
    source=(_CSRC + "flash_attention.cu", _CSRC + "flash_attention_bwd.cu",
            _CSRC + "flash_attention_bwd.cu"))
# the paged-cache read (serving/decode.py): the gathered context on the
# same forward kernel; applicability rides the builder-stamped `_cached`
# attr, so a plain fused_attention skips this route silently
ROUTE_CACHED_FLASH = CudaLowering(
    "cached_flash_attention", flag="use_flash_attention", attr="use_flash",
    match=lambda attrs: bool(attrs.get("_cached")),
    supported=_cached_flash_supported, kernels=("flash_attention_fwd",),
    replaces=(_FLASH_TPU,), source=_CSRC + "flash_attention.cu")
ROUTE_MHM = CudaLowering(
    "flash_attention", flag="use_flash_attention",
    supported=_mhm_supported, kernels=("flash_attention_fwd",),
    replaces=(_FLASH_TPU,), source=_CSRC + "flash_attention.cu")
ROUTE_LN = CudaLowering(
    "fused_layer_norm", flag="use_pallas_fused",
    supported=_norm_rows_supported,
    kernels=("layer_norm_fwd", "layer_norm_bwd"),
    replaces=(_LN_TPU, _LN_BWD_TPU), source=_CSRC + "layer_norm.cu")
ROUTE_ADD_LN = CudaLowering(
    "fused_add_layer_norm", flag="use_pallas_fused",
    supported=_add_ln_supported,
    kernels=("add_layer_norm_fwd", "add_layer_norm_bwd"),
    replaces=(_ADD_LN_TPU, _ADD_LN_BWD_TPU), source=_CSRC + "layer_norm.cu")
# only add+gelu has a kernel: other functor pairs (the pooled tanh) are
# not in play for this route, so they are skipped, not counted as
# fallbacks
ROUTE_BIAS_GELU = CudaLowering(
    "fused_bias_gelu", flag="use_pallas_fused",
    match=_is_bias_gelu, supported=_bias_gelu_supported,
    kernels=("bias_gelu_fwd", "bias_gelu_bwd"),
    replaces=(_BIAS_GELU_TPU, _BIAS_GELU_BWD_TPU),
    source=_CSRC + "bias_gelu.cu")

# the lazy (SparseRows) update is a plain composition, as in the JAX
# package: not in play for the kernel, so skipped rather than refused
ROUTE_ADAM = CudaLowering(
    "fused_adam", flag="use_pallas_fused", match=_is_dense_adam,
    supported=_adam_supported, kernels=("adam",), replaces=(_ADAM_TPU,),
    source=_CSRC + "adam.cu")

# the quantized all-reduce's receive stage: the requantizing kernel for
# int8 with round-to-nearest, else the accumulating one and a plain
# requantize (the JAX package's _PL_DEQUANT_ACC_AR)
ROUTE_DEQUANT_ACC = CudaLowering(
    "dequant_accumulate", flag="use_pallas_fused",
    supported=_dequant_acc_supported,
    kernels=("dequant_accumulate", "dequant_accumulate_requant"),
    replaces=(_DQ_ACC_TPU, _DQ_ACC_RQ_TPU),
    source=_CSRC + "quant_accumulate.cu")

# ZeRO-1's quantized gradient scatter: the accumulating receive stage
# only (its float32 shard feeds the sharded update, nothing requantizes;
# the JAX package's _PL_DEQUANT_ACC)
ROUTE_DEQUANT_ACC_RS = CudaLowering(
    "dequant_accumulate", flag="use_pallas_fused",
    supported=_dequant_acc_supported, kernels=("dequant_accumulate",),
    replaces=(_DQ_ACC_TPU,), source=_CSRC + "quant_accumulate.cu")

register_routes("fused_attention", ROUTE_FLASH, ROUTE_RING_FLASH,
                ROUTE_CACHED_FLASH)
register_routes("multihead_matmul", ROUTE_MHM)
register_routes("layer_norm", ROUTE_LN)
register_routes("fused_add_layernorm", ROUTE_ADD_LN)
register_routes("fused_elemwise_activation", ROUTE_BIAS_GELU)
register_routes("adam", ROUTE_ADAM)
register_routes("adamw", ROUTE_ADAM)        # the same update, then decay
register_routes("c_quant_allreduce_sum", ROUTE_DEQUANT_ACC)
register_routes("c_fused_quant_allreduce_sum", ROUTE_DEQUANT_ACC)
register_routes("quant_reduce_scatter", ROUTE_DEQUANT_ACC_RS)


def kernel_facts():
    """``{LAUNCHES key: (CUDA source, "file:line" of the TPU kernel it
    replaces)}``, read from the route table."""
    facts = {}
    for routes in ROUTES.values():
        for route in routes:
            for name, src, tpu in zip(route.kernels, route.sources,
                                      route.replaces):
                facts[name] = (src, tpu)
    return facts


# ---------------------------------------------------------------------------
# the flops and collective channels (the JAX package's op_specs.py)
# ---------------------------------------------------------------------------


class VarSig:
    """(shape, dtype) of a variable: a shape of ints (-1 unknown) or None."""

    __slots__ = ("shape", "dtype")

    def __init__(self, shape, dtype="float32"):
        self.shape = None if shape is None else tuple(int(d) for d in shape)
        self.dtype = str(dtype)

    def __repr__(self):
        return f"VarSig({self.shape}, {self.dtype})"


def _sig(ins, slot, i=0):
    v = ins.get(slot)
    if not v or i >= len(v):
        return None
    return v[i]


def _known(shape) -> bool:
    return shape is not None and all(int(d) >= 0 for d in shape)


def _numel(shape):
    n = 1
    for d in shape:
        n *= int(d)
    return n


def _flops_mul(ins, outs, attrs):
    xv, yv = _sig(ins, "X"), _sig(ins, "Y")
    if xv is None or yv is None or xv.shape is None or yv.shape is None:
        return None
    xn = int(attrs.get("x_num_col_dims", 1))
    yn = int(attrs.get("y_num_col_dims", 1))
    sx, sy = xv.shape, yv.shape
    if not _known(sx) or not _known(sy):
        return None
    return 2.0 * _numel(sx[:xn]) * _numel(sx[xn:]) * _numel(sy[yn:])


def _flops_matmul(ins, outs, attrs):
    xv, yv = _sig(ins, "X"), _sig(ins, "Y")
    if xv is None or yv is None or xv.shape is None or yv.shape is None \
            or len(xv.shape) < 2 or len(yv.shape) < 2:
        return None
    tx = bool(attrs.get("transpose_X", attrs.get("trans_x", False)))
    ty = bool(attrs.get("transpose_Y", attrs.get("trans_y", False)))
    sx, sy = list(xv.shape), list(yv.shape)
    m, k = (sx[-1], sx[-2]) if tx else (sx[-2], sx[-1])
    _, n = (sy[-1], sy[-2]) if ty else (sy[-2], sy[-1])
    batch_x, batch_y = sx[:-2], sy[:-2]
    batch = batch_x if len(batch_x) >= len(batch_y) else batch_y
    if not _known((m, k, n)) or not _known(batch):
        return None
    return 2.0 * _numel(batch) * m * k * n


def _flops_fused_attention(ins, outs, attrs):
    """QK^T and PV: 4·B·Sq·Sk·hidden (the head split cancels); the
    cache-read variant's Sk is its table window."""
    q, k = _sig(ins, "Q"), _sig(ins, "K")
    if q is None or q.shape is None or len(q.shape) < 3:
        return None
    b, sq, hidden = q.shape[0], q.shape[1], q.shape[-1]
    pool, table = _sig(ins, "KPool"), _sig(ins, "BlockTable")
    if pool is not None:
        ps = pool.shape
        ts = table.shape if table is not None else None
        if ps is None or ts is None or len(ps) != 3 or len(ts) != 2 or \
                ps[1] < 0 or ts[1] < 0:
            return None
        sk = ts[1] * ps[1]
    else:
        ksh = k.shape if k is not None and k.shape is not None else q.shape
        sk = ksh[1] if len(ksh) > 1 else sq
    if not _known((b, sq, sk, hidden)):
        return None
    return 4.0 * b * sq * sk * hidden


def _flops_conv2d(ins, outs, attrs):
    xv, wv = _sig(ins, "Input"), _sig(ins, "Filter")
    ov = _sig(outs, "Output") if outs else None
    if xv is None or wv is None or ov is None or xv.shape is None or \
            wv.shape is None or ov.shape is None or len(wv.shape) != 4:
        return None
    if not _known(ov.shape) or not _known(wv.shape):
        return None
    _, cin_g, kh, kw = wv.shape
    return 2.0 * _numel(ov.shape) * cin_g * kh * kw


def _flops_elemwise(k, slot="X"):
    """``k`` FLOPs per element of input ``slot``."""
    def flops(ins, outs, attrs):
        v = _sig(ins, slot)
        if v is None or v.shape is None or not _known(v.shape):
            return None
        return float(k) * _numel(v.shape)
    return flops


def _flops_softmax_ce(ins, outs, attrs):
    v = _sig(ins, "Logits")
    if v is None or v.shape is None or not _known(v.shape):
        return None
    return 10.0 * _numel(v.shape)


def _flops_c_embedding(ins, outs, attrs):
    w, ids = _sig(ins, "W"), _sig(ins, "Ids")
    if w is None or ids is None or w.shape is None or ids.shape is None \
            or not _known(w.shape) or not _known(ids.shape):
        return None
    return 2.0 * _numel(ids.shape) * w.shape[-1]


# -- the MoE pipeline (ops/moe_ops.py): the static dims mirror the
# runtime arithmetic of moe_dispatch (the same _moe_static_dims), so the
# planner prices the capacity-factor geometry the ops run


def _moe_spec_dims(ins, attrs):
    """(n, g, sg, c, e, m) from the X / GateW signatures and the attrs, or
    None."""
    xv, gw = _sig(ins, "X"), _sig(ins, "GateW")
    if xv is None or xv.shape is None or gw is None or gw.shape is None \
            or len(gw.shape) != 2:
        return None
    e = int(attrs.get("num_experts", gw.shape[1]))
    m = xv.shape[-1]
    from .moe_ops import _moe_static_dims
    n, g, sg, c = _moe_static_dims(
        xv.shape, e, attrs.get("top_k", 2),
        attrs.get("capacity_factor", 1.25), attrs.get("group_size", 0))
    return n, g, sg, c, e, m


def _flops_moe_dispatch(ins, outs, attrs):
    """The gate GEMM (2 N m E) + the dispatch one-hot einsum (2 G S E C m
    = 2 N E C m)."""
    dims = _moe_spec_dims(ins, attrs)
    if dims is None:
        return None
    n, g, sg, c, e, m = dims
    if min(n, c, e, m) <= 0:
        return None
    return 2.0 * n * m * e + 2.0 * n * e * c * m


def _flops_moe_expert_ffn(ins, outs, attrs):
    """Two batched GEMMs over the dispatched blocks: 4 E B m h, where
    B = G C carries the capacity factor."""
    xe, w1 = _sig(ins, "Xe"), _sig(ins, "W1")
    if xe is None or xe.shape is None or not _known(xe.shape) \
            or w1 is None or w1.shape is None or not _known(w1.shape):
        return None
    e, b, m = xe.shape
    h = w1.shape[-1]
    return 4.0 * e * b * m * h


def _flops_moe_combine(ins, outs, attrs):
    """The combine einsum gsec,egcm->gsm: 2 G S E C m."""
    comb, xv = _sig(ins, "Combine"), _sig(ins, "X")
    if comb is None or comb.shape is None or not _known(comb.shape) \
            or xv is None or xv.shape is None or xv.shape[-1] <= 0:
        return None
    return 2.0 * _numel(comb.shape) * xv.shape[-1]


#: op type -> ``flops(ins, outs, attrs)`` (``ins`` / ``outs``: slot ->
#: [VarSig]; None or 0 when a shape is unknown)
FLOPS = {
    "mul": _flops_mul, "matmul": _flops_matmul, "matmul_v2": _flops_matmul,
    "fused_attention": _flops_fused_attention,
    "conv2d": _flops_conv2d, "depthwise_conv2d": _flops_conv2d,
    "softmax": _flops_elemwise(5), "log_softmax": _flops_elemwise(5),
    "cross_entropy": _flops_elemwise(3), "cross_entropy2": _flops_elemwise(3),
    "cumsum": _flops_elemwise(1),
    "softmax_with_cross_entropy": _flops_softmax_ce,
    "c_embedding": _flops_c_embedding,
    "moe_dispatch": _flops_moe_dispatch,
    "moe_expert_ffn": _flops_moe_expert_ffn,
    "moe_combine": _flops_moe_combine,
}

#: the op types the JAX package's op specs flag ``collective``
COLLECTIVE_OPS = frozenset({
    "alltoall", "c_allgather", "c_allreduce_max", "c_allreduce_min",
    "c_allreduce_prod", "c_allreduce_sum", "c_broadcast", "c_concat",
    "c_embedding", "c_expert_alltoall", "c_fused_allreduce_sum",
    "c_fused_quant_allreduce_sum", "c_quant_allreduce_sum",
    "c_reducescatter", "c_split", "collective_permute", "fsdp_all_gather",
    "local_sgd_sync", "moe_ffn", "mp_allreduce_sum", "mp_copy",
    "pipe_stage_boundary", "quant_reduce_scatter", "zero_all_gather",
    "zero_reduce_scatter", "zero_shard_slice"})

#: the all-reduce a global-norm clip runs over the axes its gradients are
#: sharded on (``clip.shard_global_norm``): one scalar a group a step.
#: The port's own op: the JAX package clips each rank by its own blocks.
CLIP_NORM_ALLREDUCE = "c_global_norm_allreduce"


# -- the wire channel (the JAX package's ``_wire_width`` / ``_WIRE_SPECS``):
# what a collective moves per step under its ring schedule and its
# compression spec, from its inputs' declared (global) signatures


_WIRE_DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
                     "bfloat16": 2, "float16": 2, "int16": 2, "int8": 1,
                     "uint8": 1, "bool": 1}


def _wire_width(dtype) -> int:
    """On-wire bytes per element (a dtype outside the table prices at its
    true element size, never a silent 4)."""
    width = _WIRE_DTYPE_BYTES.get(str(dtype))
    if width is not None:
        return width
    try:
        from .registry import dtype_nbytes
        return dtype_nbytes(dtype)
    except Exception:
        return 4


def _ring_factor(attrs, axis_sizes, passes):
    """Sum over the op's reduce axes of passes·(n-1)/n; ``passes`` an axis
    when the mesh is unknown (the n → ∞ bound).  With a known mesh an
    axis absent from it (or of size 1) is an identity collective: zero
    wire."""
    axes = attrs.get("_axis_name") or ()
    axes = (axes,) if isinstance(axes, str) else tuple(axes)
    if not axes:
        axes = (None,)
    total = 0.0
    for ax in axes:
        n = (axis_sizes or {}).get(ax) if ax is not None else None
        if n is None and ax is not None and axis_sizes:
            continue                 # known mesh, axis not on it
        total += passes * ((n - 1) / n if n and n > 1 else
                           (0.0 if n == 1 else 1.0))
    return total


def _collective_wire(passes):
    """The ``wire`` fn of a (possibly quantized) reduce collective moving
    its payload ``passes`` times an axis."""
    def wire(ins, attrs, axis_sizes=None):
        from .quantize_wire import quant_spec_of
        numel, width = 0, 4
        for sig in ins.get("X", []):
            if sig is None or sig.shape is None or not _known(sig.shape):
                return None              # dynamic payload: no claim
            numel += _numel(sig.shape)
            width = _wire_width(sig.dtype)
        if not numel:
            return None
        factor = _ring_factor(attrs, axis_sizes, passes)
        logical = int(numel * width * factor)
        spec = quant_spec_of(attrs)
        per_pass = spec.wire_bytes(numel) if spec is not None \
            else numel * width
        return logical, int(per_pass * factor)
    return wire


def _pipe_boundary_wire(ins, attrs, axis_sizes=None):
    """One stage cut a step: the boundary payload crosses once a
    microbatch forward and once backward, and the microbatches sum to the
    batch, so 2 × payload point to point; zero when the mesh is known and
    the pipe axis is absent or of size 1."""
    numel_bytes = 0
    for sig in ins.get("X", []):
        if sig is None or sig.shape is None or not _known(sig.shape):
            return None
        numel_bytes += _numel(sig.shape) * _wire_width(sig.dtype)
    if not numel_bytes:
        return None
    ax = attrs.get("_axis_name")
    if axis_sizes is not None:
        n = (axis_sizes or {}).get(ax, 1)
        if not n or n <= 1:
            return 0, 0
    total = 2 * numel_bytes
    return total, total


def _c_embedding_wire(ins, attrs, axis_sizes=None):
    """Vocab-parallel embedding: the [*, dim] lookup is all-reduced over
    the model axis in the forward: 2·(n-1)/n · ids_numel · dim · width."""
    w, ids = _sig(ins, "W"), _sig(ins, "Ids")
    if w is None or ids is None or w.shape is None or ids.shape is None \
            or not _known(w.shape) or not _known(ids.shape):
        return None
    numel = _numel(ids.shape) * w.shape[-1]
    factor = _ring_factor(attrs, axis_sizes, 2)
    total = int(numel * _wire_width(w.dtype) * factor)
    return total, total


#: collective op type -> its ``wire`` fn (2 payload passes for all-reduce
#: shapes, 1 for a scatter or gather half; an op whose backward is
#: another collective prices both directions)
WIRE_SPECS = {
    "pipe_stage_boundary": _pipe_boundary_wire,
    "alltoall": _collective_wire(2),
    "c_expert_alltoall": _collective_wire(2),
    "c_broadcast": _collective_wire(1),
    "c_embedding": _c_embedding_wire,
    "c_allreduce_sum": _collective_wire(2),
    "c_fused_allreduce_sum": _collective_wire(2),
    "c_quant_allreduce_sum": _collective_wire(2),
    "c_fused_quant_allreduce_sum": _collective_wire(2),
    "zero_reduce_scatter": _collective_wire(1),
    "quant_reduce_scatter": _collective_wire(1),
    "c_reducescatter": _collective_wire(1),
    "zero_all_gather": _collective_wire(1),
    "c_allgather": _collective_wire(2),
    "fsdp_all_gather": _collective_wire(2),
    "mp_allreduce_sum": _collective_wire(2),
    "mp_copy": _collective_wire(2),
    # the port's clip norm all-reduce: one forward ring all-reduce of a
    # float32 scalar, no backward
    CLIP_NORM_ALLREDUCE: _collective_wire(2),
}


# -- the byte channels (the JAX package's mem_transparent /
# mem_backward_extra entries)


def _attention_probs_bytes(ins, outs, attrs):
    """The attention's logits and probabilities [B, n_head, Sq, Sk], kept
    for the backward and named by no variable."""
    from .registry import dtype_nbytes
    q = _sig(ins, "Q")
    k = _sig(ins, "K") or q
    if q is None or q.shape is None or len(q.shape) < 3:
        return 0
    ksh = k.shape if k is not None and k.shape is not None else q.shape
    b, sq = int(q.shape[0]), int(q.shape[1])
    sk = int(ksh[1]) if len(ksh) > 1 else sq
    if min(b, sq, sk) < 0:
        return 0
    n_head = int(attrs.get("n_head", 1) or 1)
    head_dim = attrs.get("head_dim")
    if head_dim and q.shape[-1] > 0:
        n_head = max(1, int(q.shape[-1]) // int(head_dim))
    return 2 * b * n_head * sq * sk * dtype_nbytes(q.dtype)


def _softmax_ce_extra_bytes(ins, outs, attrs):
    """softmax-CE keeps the logit-sized softmax for the backward, and its
    cotangent is logit-sized too: two logit copies."""
    lg = _sig(ins, "Logits")
    if lg is None or lg.shape is None or any(int(d) < 0 for d in lg.shape):
        return 0
    from .registry import dtype_nbytes
    return 2 * _numel(lg.shape) * dtype_nbytes(lg.dtype)


#: the fusible families (views, elementwise arithmetic, activations): the
#: JAX package's ``mem_transparent=True`` entries
MEM_TRANSPARENT_OPS = frozenset({
    "elementwise_add", "elementwise_sub", "elementwise_mul",
    "equal", "not_equal", "less_than", "less_equal", "greater_than",
    "greater_equal", "logical_and", "logical_or", "logical_xor",
    "logical_not", "relu", "relu6", "sigmoid", "tanh", "gelu", "exp",
    "log", "sqrt", "rsqrt", "square", "abs", "floor", "ceil", "round",
    "sign", "softplus", "swish", "hard_swish", "hard_sigmoid",
    "leaky_relu", "scale", "assign", "clip", "pow", "softsign", "erf",
    "sin", "cos", "softmax", "log_softmax", "dropout", "cast", "reshape2",
    "reshape", "unsqueeze2", "squeeze2", "flatten2", "flatten"})

#: op type -> ``mem_backward_extra(ins, outs, attrs)``
MEM_BACKWARD_EXTRA = {
    "softmax_with_cross_entropy": _softmax_ce_extra_bytes,
    "fused_attention": _attention_probs_bytes,
}


def register_default_specs():
    """Fill ``registry.OP_SPECS`` from the channel tables above
    (idempotent)."""
    from .registry import op_spec
    names = (set(FLOPS) | set(COLLECTIVE_OPS) | set(WIRE_SPECS) |
             MEM_TRANSPARENT_OPS | set(MEM_BACKWARD_EXTRA))
    for name in sorted(names):
        op_spec(name,
                collective=name in COLLECTIVE_OPS or
                name == CLIP_NORM_ALLREDUCE,
                mem_transparent=True if name in MEM_TRANSPARENT_OPS
                else None,
                mem_backward_extra=MEM_BACKWARD_EXTRA.get(name),
                wire=WIRE_SPECS.get(name), flops=FLOPS.get(name))


register_default_specs()
