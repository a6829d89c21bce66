"""The kernel-route table — the port's counterpart of the ``pallas=``
routes in paddle_tpu/ops/op_specs.py.

Each :class:`~.registry.CudaLowering` below carries a ``supported``
predicate stating exactly what its CUDA kernel rejects (head dims, norm
widths, dtypes), evaluated on the op's input tensors, so
``cuda_route`` reports every hit and every fallback with its reason, and
refuses (raises) on the card what a gate rejects.  :func:`kernel_facts`
gives each kernel's source and the TPU kernel it replaces."""

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
