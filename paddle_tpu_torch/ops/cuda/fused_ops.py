"""Fused row kernels on Hopper — the counterpart of
``paddle_tpu/ops/pallas/fused_ops.py``.

* :func:`layer_norm` — LN over the last dim of x2 [R, D], differentiable
  through :class:`LayerNorm` (``csrc/layer_norm.cu``: ``layer_norm_fwd``
  replaces ``_ln_fwd_kernel``, ``layer_norm_bwd`` replaces
  ``_ln_bwd_kernel``);
* :func:`add_layer_norm` — LN(a2 + b2), the sum never written to memory,
  differentiable through :class:`AddLayerNorm` (same source, residual
  variants: ``add_layer_norm_fwd`` replaces ``_aln_fwd_kernel``,
  ``add_layer_norm_bwd`` replaces ``_aln_bwd_kernel``);
* :func:`bias_gelu` — exact-erf GELU(x2 + bias), differentiable through
  :class:`BiasGelu` (``csrc/bias_gelu.cu``: ``bias_gelu_fwd`` replaces
  ``_bg_fwd_kernel``, ``bias_gelu_bwd`` replaces ``_bg_bwd_kernel``).

Each kernel has a ``*_plain`` PyTorch twin computing the same function
with the same float32 statistics (the backward twins are the explicit
formulas of the Pallas backward kernels); CPU tensors run the twin, CUDA
tensors launch the kernel or raise.  The backward kernels sum the
affine/bias gradients in two deterministic stages (float32 partials per
block of rows, then a column sum), so a step's gradients are the same
bits every run."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import (check_cuda, count_launch, dtype_code, needs_grad,
               raise_on_error, require_cuda, stream_handle)
from .build import function

_P = ctypes.c_void_p
_I = ctypes.c_int
_LN_ARGTYPES = (_I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                ctypes.c_float, _P)
_LN_BWD_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                    _I, ctypes.c_float, _P)
_BG_ARGTYPES = (_I, _P, _P, _P, _I, _I, _P)
_BG_BWD_ARGTYPES = (_I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P)

LN_MAX_DIM = 8192
BG_MAX_DIM = 16384
BWD_MAX_BLOCKS = 512        # row blocks of bias+GELU backward's partials
LN_CHUNKS = (2, 4, 6)       # 128-column chunks a lane may hold of a row
LN_FWD_BLOCK_WARPS = 8      # warps of an LN forward block (or one row's),
LN_FWD_SMALL_ROWS = 1024    # half as many up to this many rows
LN_BWD_MAX_BLOCKS = 256     # row blocks of the LN backward's partials
LN_BWD_BLOCK_WARPS = 8      # warps of an LN backward block (or one row's)


def ln_supported(d: int, dtype=torch.float32) -> Tuple[bool, str]:
    """What the LayerNorm kernels reject (the TPU kernel's gate)."""
    if d % 128 or d > LN_MAX_DIM or d <= 0:
        return False, f"norm-dim:{d}"
    if dtype not in (torch.float32, torch.bfloat16):
        return False, f"dtype:{dtype}"
    return True, ""


def bg_supported(d: int, dtype=torch.float32) -> Tuple[bool, str]:
    """What the bias+GELU kernel rejects (the TPU kernel's gate)."""
    if d % 128 or d > BG_MAX_DIM or d <= 0:
        return False, f"dim:{d}"
    if dtype not in (torch.float32, torch.bfloat16):
        return False, f"dtype:{dtype}"
    return True, ""


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _norm_rows(u, scale, bias, eps):
    mu = u.mean(dim=-1, keepdim=True)
    uc = u - mu
    rstd = torch.rsqrt((uc * uc).mean(dim=-1, keepdim=True) + eps)
    return uc * rstd * scale.float() + bias.float()


def layer_norm_plain(x2, scale, bias, eps=1e-5):
    return _norm_rows(x2.float(), scale, bias, eps).to(x2.dtype)


def add_layer_norm_plain(a2, b2, scale, bias, eps=1e-5):
    return _norm_rows(a2.float() + b2.float(), scale, bias,
                      eps).to(a2.dtype)


def _norm_rows_bwd(u, scale, dy, eps, dtype):
    dyf = dy.float()
    mu = u.mean(dim=-1, keepdim=True)
    uc = u - mu
    rstd = torch.rsqrt((uc * uc).mean(dim=-1, keepdim=True) + eps)
    uhat = uc * rstd
    dys = dyf * scale.float()
    m1 = dys.mean(dim=-1, keepdim=True)
    m2 = (dys * uhat).mean(dim=-1, keepdim=True)
    dx = rstd * (dys - m1 - uhat * m2)
    return dx.to(dtype), (dyf * uhat).sum(dim=0).to(scale.dtype), \
        dyf.sum(dim=0).to(scale.dtype)


def layer_norm_bwd_plain(x2, scale, dy, eps=1e-5):
    """The explicit backward of :func:`layer_norm_plain`, as
    ``_ln_bwd_kernel`` computes it: statistics recomputed in float32,
    dx = rstd * (dy*s - mean(dy*s) - xhat * mean(dy*s*xhat)), and
    dscale = sum(dy * xhat), dbias = sum(dy) over the rows."""
    return _norm_rows_bwd(x2.float(), scale, dy, eps, x2.dtype)


def add_layer_norm_bwd_plain(a2, b2, scale, dy, eps=1e-5):
    """The explicit backward of :func:`add_layer_norm_plain`, as
    ``_aln_bwd_kernel`` computes it: u = a2 + b2 recomputed in float32,
    then the formulas of :func:`layer_norm_bwd_plain` on u.  Returns
    (dx, dscale, dbias); dx is the gradient of both addends."""
    return _norm_rows_bwd(a2.float() + b2.float(), scale, dy, eps,
                          a2.dtype)


def bias_gelu_plain(x2, bias):
    u = x2.float() + bias.float()
    return (0.5 * u * (1.0 + torch.erf(u * 0.7071067811865476))).to(
        x2.dtype)


def bias_gelu_bwd_plain(x2, bias, dy):
    """The explicit backward of :func:`bias_gelu_plain`, as
    ``_bg_bwd_kernel`` computes it, in float32: u = x2 + bias,
    dx = dy * (Phi(u) + u * phi(u)), db = the column sum of dx taken
    before dx is rounded to x2's dtype.  Returns (dx, db)."""
    u = x2.float() + bias.float()
    cdf = 0.5 * (1.0 + torch.erf(u * 0.7071067811865476))
    pdf = 0.3989422804014327 * torch.exp(-0.5 * u * u)
    dx = dy.float() * (cdf + u * pdf)
    return dx.to(x2.dtype), dx.sum(dim=0).to(bias.dtype)


# ---------------------------------------------------------------------------
# kernel wrappers
# ---------------------------------------------------------------------------


def _ln_launch(what, counter, a2, b2, scale, bias, eps):
    require_cuda(what, a2)
    extra = (b2,) if b2 is not None else ()
    check_cuda(what, a2, *extra, scale, bias)
    if a2.dim() != 2 or (b2 is not None and b2.shape != a2.shape):
        raise ValueError(f"{what}: expected [R, D] operands")
    r, d = a2.shape
    if tuple(scale.shape) != (d,) or tuple(bias.shape) != (d,):
        raise ValueError(f"{what}: scale/bias must be [{d}]")
    ok, why = ln_supported(d, a2.dtype)
    if not ok:
        raise ValueError(f"{what}: unsupported ({why})")
    y = torch.empty_like(a2)
    if r == 0:
        return y
    plan = ln_fwd_plan(r, d)
    fn = function("layer_norm", "pt_layer_norm_fwd", _LN_ARGTYPES)
    rc = fn(dtype_code(a2, what), a2.data_ptr(),
            b2.data_ptr() if b2 is not None else None, scale.data_ptr(),
            bias.data_ptr(), y.data_ptr(), r, d, plan.chunks,
            plan.group_warps, plan.block_warps, plan.blocks, float(eps),
            stream_handle(a2.device))
    raise_on_error(what, rc)
    count_launch(counter, a2.dtype)
    return y


def layer_norm_fwd(x2, scale, bias, eps=1e-5):
    """LayerNorm over the last dim of x2 [R, D]; scale/bias [D] of x2's
    dtype.  No autograd: :func:`layer_norm` is the differentiable entry."""
    if x2.device.type == "cpu":
        return layer_norm_plain(x2, scale, bias, eps)
    return _ln_launch("layer_norm", "layer_norm_fwd", x2, None, scale,
                      bias, eps)


def _row_blocks(r):
    """(rows per block, blocks) of bias+GELU backward's partial sums."""
    rows_per_block = -(-r // BWD_MAX_BLOCKS)
    return rows_per_block, -(-r // rows_per_block)


class LnPlan(NamedTuple):
    """A LayerNorm kernel's launch over x [rows, d]: its row layout
    (:func:`ln_row_layout`) and grid (:func:`ln_fwd_plan`,
    :func:`ln_bwd_plan`)."""
    rows: int
    d: int
    chunks: int          # 4-column slices a lane holds of each row
    group_warps: int     # warps that share one row
    block_warps: int     # warps of a block: block_warps // group_warps groups
    rows_per_block: int
    blocks: int          # blocks of the grid

    @property
    def groups(self) -> int:
        return self.block_warps // self.group_warps

    def group_rows(self, block: int, group: int) -> range:
        """The rows that row group ``group`` of block ``block`` takes, in
        the kernels' order (``ln_fwd_kernel``, ``ln_bwd_rows_kernel``)."""
        r0 = block * self.rows_per_block
        return range(r0 + group, min(self.rows, r0 + self.rows_per_block),
                     self.groups)


def ln_row_layout(d: int) -> Tuple[int, int]:
    """(chunks, group_warps) of ``csrc/layer_norm.cu``'s row layout, both
    directions: a row is split over the fewest warps (a power of two) that
    leaves each lane at most ``LN_CHUNKS[-1]`` 128-column chunks, and a
    lane holds the smallest instantiated count of chunks that covers its
    share."""
    if d < 128 or d % 128:
        raise ValueError(f"ln_row_layout: no layout for width {d}")
    n = d // 128
    group = 1
    while -(-n // group) > LN_CHUNKS[-1]:
        group *= 2
    return min(c for c in LN_CHUNKS if c >= -(-n // group)), group


def ln_fwd_plan(r: int, d: int) -> LnPlan:
    """The grid of ``csrc/layer_norm.cu``'s forward, a function of (r, d)
    alone — never of the device: each row group takes one row, in blocks
    of ``LN_FWD_BLOCK_WARPS`` warps, half as many up to
    ``LN_FWD_SMALL_ROWS`` rows (more blocks on more SMs where latency
    decides), or of the one row group when it has more warps;
    ``ceil(r / groups)`` blocks."""
    if r < 1:
        raise ValueError(f"ln_fwd_plan: no plan for [{r}, {d}]")
    chunks, group = ln_row_layout(d)
    warps = LN_FWD_BLOCK_WARPS // (2 if r <= LN_FWD_SMALL_ROWS else 1)
    block_warps = max(warps, group)
    groups = block_warps // group
    return LnPlan(r, d, chunks, group, block_warps, groups, -(-r // groups))


def ln_bwd_plan(r: int, d: int) -> LnPlan:
    """The grid of ``csrc/layer_norm.cu``'s backward, a function of (r, d)
    alone — never of the device — so dscale/dbias are the same bits on
    every card.  The row layout is :func:`ln_row_layout`'s; blocks hold
    ``LN_BWD_BLOCK_WARPS`` warps (more when one row needs them), take a
    whole number of rows per row group, and number at most
    ``LN_BWD_MAX_BLOCKS``; each writes one float32 partial of [2, d]."""
    if r < 1:
        raise ValueError(f"ln_bwd_plan: no plan for [{r}, {d}]")
    chunks, group = ln_row_layout(d)
    block_warps = max(LN_BWD_BLOCK_WARPS, group)
    groups = block_warps // group
    rows_per_block = groups * -(-r // (LN_BWD_MAX_BLOCKS * groups))
    return LnPlan(r, d, chunks, group, block_warps, rows_per_block,
                  -(-r // rows_per_block))


def _ln_bwd_launch(what, a2, b2, scale, dy, eps):
    require_cuda(what, a2)
    dy = dy.contiguous()
    extra = (b2,) if b2 is not None else ()
    check_cuda(what, a2, *extra, scale, dy)
    if a2.dim() != 2 or dy.shape != a2.shape or \
            (b2 is not None and b2.shape != a2.shape):
        raise ValueError(f"{what}: expected [R, D] operands")
    r, d = a2.shape
    if tuple(scale.shape) != (d,):
        raise ValueError(f"{what}: scale must be [{d}]")
    ok, why = ln_supported(d, a2.dtype)
    if not ok or r < 1:
        raise ValueError(f"{what}: unsupported ({why or 'no rows'})")
    plan = ln_bwd_plan(r, d)
    dx = torch.empty_like(a2)
    dscale, dbias = torch.empty_like(scale), torch.empty_like(scale)
    partial = torch.empty((plan.blocks, 2, d), dtype=torch.float32,
                          device=a2.device)
    fn = function("layer_norm", "pt_layer_norm_bwd", _LN_BWD_ARGTYPES)
    rc = fn(dtype_code(a2, what), a2.data_ptr(),
            b2.data_ptr() if b2 is not None else None, scale.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), dscale.data_ptr(),
            dbias.data_ptr(), partial.data_ptr(), r, d, plan.chunks,
            plan.group_warps, plan.rows_per_block, plan.blocks, float(eps),
            stream_handle(a2.device))
    raise_on_error(what, rc)
    count_launch(what, a2.dtype)
    return dx, dscale, dbias


def layer_norm_bwd(x2, scale, dy, eps=1e-5):
    """(dx, dscale, dbias) of LayerNorm over x2 [R, D] for the output
    gradient dy [R, D].  CPU tensors run :func:`layer_norm_bwd_plain`;
    CUDA tensors launch the backward kernel (row blocks, then the
    column sum of their partials) or raise."""
    if x2.device.type == "cpu":
        return layer_norm_bwd_plain(x2, scale, dy, eps)
    return _ln_bwd_launch("layer_norm_bwd", x2, None, scale, dy, eps)


def add_layer_norm_bwd(a2, b2, scale, dy, eps=1e-5):
    """(dx, dscale, dbias) of LN(a2 + b2) for the output gradient dy; dx
    is the gradient of both addends.  CPU tensors run
    :func:`add_layer_norm_bwd_plain`; CUDA tensors launch the residual
    variant of the LayerNorm backward kernel or raise."""
    if a2.device.type == "cpu":
        return add_layer_norm_bwd_plain(a2, b2, scale, dy, eps)
    return _ln_bwd_launch("add_layer_norm_bwd", a2, b2, scale, dy, eps)


class LayerNorm(torch.autograd.Function):
    """LayerNorm rows through the forward kernel, with the backward
    kernel as its backward (the TPU package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x2, scale, bias, eps):
        ctx.save_for_backward(x2, scale)
        ctx.eps = eps
        return layer_norm_fwd(x2, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        x2, scale = ctx.saved_tensors
        dx, dscale, dbias = layer_norm_bwd(x2, scale, dy, ctx.eps)
        return dx, dscale, dbias, None


def layer_norm(x2, scale, bias, eps=1e-5):
    """LayerNorm over the last dim of x2 [R, D]; scale/bias [D] of x2's
    dtype; differentiable in x2, scale and bias through :class:`LayerNorm`
    when autograd records."""
    if needs_grad(x2, scale, bias):
        return LayerNorm.apply(x2, scale, bias, eps)
    return layer_norm_fwd(x2, scale, bias, eps)


def add_layer_norm_fwd(a2, b2, scale, bias, eps=1e-5):
    """LN(a2 + b2) over the last dim; a2/b2 [R, D], scale/bias [D].  No
    autograd: :func:`add_layer_norm` is the differentiable entry."""
    if a2.device.type == "cpu":
        return add_layer_norm_plain(a2, b2, scale, bias, eps)
    return _ln_launch("add_layer_norm", "add_layer_norm_fwd", a2, b2,
                      scale, bias, eps)


class AddLayerNorm(torch.autograd.Function):
    """LN(a2 + b2) through the residual forward kernel, with the residual
    backward kernel as its backward; both addends get the same dx, as
    ``_aln_bwd`` returns it."""

    @staticmethod
    def forward(ctx, a2, b2, scale, bias, eps):
        ctx.save_for_backward(a2, b2, scale)
        ctx.eps = eps
        return add_layer_norm_fwd(a2, b2, scale, bias, eps)

    @staticmethod
    def backward(ctx, dy):
        a2, b2, scale = ctx.saved_tensors
        dx, dscale, dbias = add_layer_norm_bwd(a2, b2, scale, dy, ctx.eps)
        return dx, dx, dscale, dbias, None


def add_layer_norm(a2, b2, scale, bias, eps=1e-5):
    """LN(a2 + b2) over the last dim; a2/b2 [R, D], scale/bias [D] of
    a2's dtype; differentiable in all four through :class:`AddLayerNorm`
    when autograd records."""
    if needs_grad(a2, b2, scale, bias):
        return AddLayerNorm.apply(a2, b2, scale, bias, eps)
    return add_layer_norm_fwd(a2, b2, scale, bias, eps)


def _bg_check(what, x2, bias, *extra):
    require_cuda(what, x2)
    check_cuda(what, x2, bias, *extra)
    if x2.dim() != 2 or tuple(bias.shape) != (x2.shape[1],) or \
            any(t.shape != x2.shape for t in extra):
        raise ValueError(f"{what}: expected x2 [R, D] and bias [D]")
    ok, why = bg_supported(x2.shape[1], x2.dtype)
    if not ok:
        raise ValueError(f"{what}: unsupported ({why})")
    return x2.shape


def bias_gelu_fwd(x2, bias):
    """gelu(x2 + bias), exact erf; x2 [R, D], bias [D] of x2's dtype.  No
    autograd: :func:`bias_gelu` is the differentiable entry."""
    if x2.device.type == "cpu":
        return bias_gelu_plain(x2, bias)
    what = "bias_gelu"
    r, d = _bg_check(what, x2, bias)
    y = torch.empty_like(x2)
    fn = function("bias_gelu", "pt_bias_gelu_fwd", _BG_ARGTYPES)
    rc = fn(dtype_code(x2, what), x2.data_ptr(), bias.data_ptr(),
            y.data_ptr(), r, d, stream_handle(x2.device))
    raise_on_error(what, rc)
    count_launch("bias_gelu_fwd", x2.dtype)
    return y


def bias_gelu_bwd(x2, bias, dy):
    """(dx, db) of gelu(x2 + bias) for the output gradient dy [R, D].  CPU
    tensors run :func:`bias_gelu_bwd_plain`; CUDA tensors launch the
    backward kernel (row blocks, then the column sum of their float32
    partials) or raise."""
    if x2.device.type == "cpu":
        return bias_gelu_bwd_plain(x2, bias, dy)
    what = "bias_gelu_bwd"
    dy = dy.contiguous()
    r, d = _bg_check(what, x2, bias, dy)
    if r < 1:
        raise ValueError(f"{what}: unsupported (no rows)")
    rows_per_block, nblocks = _row_blocks(r)
    dx, db = torch.empty_like(x2), torch.empty_like(bias)
    partial = torch.empty((nblocks, d), dtype=torch.float32,
                          device=x2.device)
    fn = function("bias_gelu", "pt_bias_gelu_bwd", _BG_BWD_ARGTYPES)
    rc = fn(dtype_code(x2, what), x2.data_ptr(), bias.data_ptr(),
            dy.data_ptr(), dx.data_ptr(), db.data_ptr(), partial.data_ptr(),
            r, d, rows_per_block, nblocks, stream_handle(x2.device))
    raise_on_error(what, rc)
    count_launch("bias_gelu_bwd", x2.dtype)
    return dx, db


class BiasGelu(torch.autograd.Function):
    """gelu(x2 + bias) through the forward kernel, with the backward
    kernel as its backward (the TPU package's ``custom_vjp``)."""

    @staticmethod
    def forward(ctx, x2, bias):
        ctx.save_for_backward(x2, bias)
        return bias_gelu_fwd(x2, bias)

    @staticmethod
    def backward(ctx, dy):
        x2, bias = ctx.saved_tensors
        return bias_gelu_bwd(x2, bias, dy)


def bias_gelu(x2, bias):
    """gelu(x2 + bias), exact erf; x2 [R, D], bias [D] of x2's dtype;
    differentiable in both through :class:`BiasGelu` when autograd
    records."""
    if needs_grad(x2, bias):
        return BiasGelu.apply(x2, bias)
    return bias_gelu_fwd(x2, bias)
