"""The receive stage of the quantized all-reduce on Hopper — the
counterpart of ``paddle_tpu/ops/pallas/quant_kernels.py``.

After the stage-1 ``all_to_all`` every rank holds n peer copies of its
shard at wire width: a ``(n * SB, C)`` int8 payload, peer-major (C =
block_size, or block_size / 2 for int4 packed two per byte), and ``(n *
SB,)`` float32 scales.

* :func:`dequant_accumulate` — the float32 sum over peers of the
  dequantized blocks, ``(SB * block_size,)`` in element order
  (``csrc/quant_accumulate.cu``, replaces ``_dq_acc_kernel``);
* :func:`dequant_accumulate_requant` — int8 with round-to-nearest only:
  the same sum requantized per block, ``(q2 (SB, C) int8, s2 (SB,)
  float32)``, the float32 sum never written to device memory (replaces
  ``_dq_acc_requant_kernel``).

The launch is :func:`quant_plan`'s, a pure function of (n, SB, C, int4,
aligned, requant) — never of the device — whose numbers the wrappers pass
to the C entry points, which re-check them.  A row is taken by a group
of ``group`` lanes (a power of two, at most 32), each loading ``vec``
payload bytes at a time (a chunk): 16 for #12, so a lane loads and stores
16 bytes; for #11 the chunk whose floats are one float4 (4 bytes of int8,
2 of int4), so a warp's stores are contiguous.  Where a row fits one pass
(``chunks`` = 1 or 2 chunks a lane) and n is in :data:`QUANT_PEERS` (the
peer count compiled in), a group takes ``rows`` rows a pass with every
load in flight before the first FMA; a wider row, an odd width, another
peer count or a payload that is not 16-byte aligned takes the loop kernel
(``chunks`` 0, n at run time: a lane walks its row's chunks, #12
twice).  ``blocks`` fills one H100 once (:data:`QUANT_SMS` x
:data:`QUANT_BLOCKS_PER_SM`) or covers the rows in fewer; the blocks
stride over the row groups.  Rows are independent, so no plan changes
a bit.

Each has a ``*_plain`` twin with the kernels' arithmetic: the peers
added in order 0..n-1 onto zeros, each as one fused multiply-add
``acc = fma(q, s, acc)`` (emulated in float64: the int8 x float32 product
is exact there, and so is the sum unless a peer's block is 2^22 times the
running sum, where a float32 tie is then needed to round otherwise), then
for the requantizing one ``quantize_blockwise`` — so the requantized
payload is the same bits.  The fused multiply-add is also what XLA makes
of the JAX package's dequantize-then-sum on the CPU.  CPU tensors run the
twin; any other device launches the kernel or raises.

:func:`supported` states what the kernels reject.  It has no lane-width
or VMEM-tile rule: the TPU gate's ``cols % 128`` and tile-bytes ceiling
were limits of the TPU's tiling and would refuse int4 at block 128 here."""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from ...framework.errors import UnimplementedError
from ..quantize_wire import CompressionSpec, quantize_blockwise, unpack_int4
from . import count_launch, raise_on_error, require_cuda, stream_handle
from .build import function

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_PLAN_ARGTYPES = (_I,) * 6          # vec, group, chunks, rows, peers, blocks
_ACC_ARGTYPES = (_P, _P, _P, _I, _LL, _I, _I) + _PLAN_ARGTYPES + (_P,)
_REQUANT_ARGTYPES = (_P, _P, _P, _P, _I, _LL, _I, ctypes.c_float,
                     ctypes.c_float) + _PLAN_ARGTYPES + (_P,)

#: the widest block the requantizing route takes (its loop kernel walks a
#: row of any width; phase 9 and the tests hold it up to this)
REQUANT_MAX_BLOCK = 12288

#: the launch: warps a block; the card the grid is sized for (one H100
#: SXM: its SMs, and the blocks of QUANT_WARPS warps an SM holds at full
#: occupancy); rows a row group takes per pass in the one-pass kernels
#: (csrc/quant_accumulate.cu kRows); the peer counts compiled into them
QUANT_WARPS = 8
QUANT_SMS = 132
QUANT_BLOCKS_PER_SM = 8
QUANT_ROWS = 2
QUANT_PEERS = (2, 4, 8)


class QuantPlan(NamedTuple):
    vec: int       # payload bytes a lane loads at once (a chunk)
    group: int     # lanes a row: a power of two, at most 32
    chunks: int    # chunks a lane holds in one pass (1, 2); 0: loop kernel
    rows: int      # rows a group takes per pass
    peers: int     # the compiled peer count (n); 0: the loop kernel
    blocks: int    # blocks of QUANT_WARPS warps, striding over the rows


def quant_plan(n: int, sb: int, cols: int, int4: bool, aligned: bool,
               requant: bool = False) -> QuantPlan:
    """The launch of ``csrc/quant_accumulate.cu`` for ``n`` peers of
    ``sb`` rows of ``cols`` payload bytes (``int4``: packed nibbles), the
    payload 16-byte aligned or not, #12 (``requant``) or #11.  A function
    of its arguments alone, never of the device."""
    if n < 1 or sb < 1 or cols < 1 or (requant and int4):
        raise ValueError(f"quant_plan: no plan for n={n} sb={sb} "
                         f"cols={cols} int4={int4} requant={requant}")
    widest = 16 if requant else (2 if int4 else 4)
    vec = 1
    if aligned:
        vec = next(v for v in (16, 8, 4, 2, 1)
                   if v <= widest and cols % v == 0)
    m = cols // vec
    group = 32 if m >= 32 else 1 << (m - 1).bit_length()
    if vec == widest and m <= (1 if requant else 2) * group and \
            n in QUANT_PEERS:
        chunks, rows, peers = -(-m // group), QUANT_ROWS, n
    else:
        chunks, rows, peers = 0, 1, 0
    per_block = QUANT_WARPS * (32 // group) * rows
    blocks = min(-(-sb // per_block), QUANT_SMS * QUANT_BLOCKS_PER_SM)
    return QuantPlan(vec, group, chunks, rows, peers, blocks)


def supported(n_peers: Optional[int], num_blocks: Optional[int],
              spec: CompressionSpec, requant: bool = False
              ) -> Tuple[bool, str]:
    """Can the receive-stage kernel take ``n_peers`` contributions of
    ``num_blocks`` blocks under ``spec``?  ``requant`` asks for the
    requantizing kernel.  Returns (ok, reason)."""
    if spec.dtype not in ("int8", "int4"):
        return False, f"wire-dtype:{spec.dtype}"
    if n_peers is None or n_peers < 2:
        return False, "peers:unknown-or-single"
    if num_blocks is None or num_blocks < 1:
        return False, "blocks:unknown"
    if requant:
        if spec.dtype != "int8":
            return False, f"requant-dtype:{spec.dtype}"
        if spec.stochastic_rounding:
            return False, "requant-stochastic-rounding"
        if spec.block_size > REQUANT_MAX_BLOCK:
            return False, f"block-size:{spec.block_size}>{REQUANT_MAX_BLOCK}"
    return True, ""


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def dequant_accumulate_plain(payload, scales, spec: CompressionSpec,
                             n_peers: int) -> torch.Tensor:
    """The kernel's sum in plain PyTorch: acc = fma(q, s, acc) over the
    peers in order, from zeros, each step rounded once to float32."""
    q = unpack_int4(payload) if spec.dtype == "int4" else payload
    q = q.to(torch.float64).reshape(n_peers, -1, spec.block_size)
    s = scales.to(torch.float64).reshape(n_peers, -1, 1)
    acc = torch.zeros(q.shape[1:], dtype=torch.float32,
                      device=payload.device)
    for p in range(n_peers):
        acc = (acc.to(torch.float64) + q[p] * s[p]).to(torch.float32)
    return acc.reshape(-1)


def dequant_accumulate_requant_plain(payload, scales, spec: CompressionSpec,
                                     n_peers: int):
    """:func:`dequant_accumulate_plain`, then ``quantize_blockwise`` with
    round-to-nearest-even: (q2 (SB, C) int8, s2 (SB,) float32)."""
    if spec.dtype != "int8":
        raise ValueError("fused requantize supports the int8 tier only")
    return quantize_blockwise(
        dequant_accumulate_plain(payload, scales, spec, n_peers), spec)


# ---------------------------------------------------------------------------
# kernels
# ---------------------------------------------------------------------------


def _check(what, payload, scales, spec, n_peers, requant):
    """Shard blocks SB of a valid input; a gate's rejection raises
    UnimplementedError with its reason, a malformed input ValueError."""
    rows = int(payload.shape[0]) if payload.dim() == 2 else 0
    sb = rows // n_peers if n_peers else 0
    ok, why = supported(n_peers, sb, spec, requant)
    if not ok:
        raise UnimplementedError(
            f"{what} on {payload.device}: the CUDA kernel rejects this "
            f"input ({why}), and the port runs no plain fallback on the "
            f"card")
    require_cuda(what, payload)
    if payload.dtype != torch.int8 or payload.dim() != 2 or \
            payload.shape[1] != spec.payload_cols:
        raise ValueError(f"{what}: payload must be (n * SB, "
                         f"{spec.payload_cols}) int8, got "
                         f"{tuple(payload.shape)} {payload.dtype}")
    if rows % n_peers:
        raise ValueError(f"{what}: {rows} payload rows for {n_peers} peers")
    if scales.dtype != torch.float32 or scales.shape != (rows,):
        raise ValueError(f"{what}: scales must be ({rows},) float32, got "
                         f"{tuple(scales.shape)} {scales.dtype}")
    if scales.device != payload.device:
        raise ValueError(f"{what}: tensors on {scales.device} and "
                         f"{payload.device}")
    if not (payload.is_contiguous() and scales.is_contiguous()):
        raise ValueError(f"{what}: the CUDA kernel needs contiguous tensors")
    return sb


def dequant_accumulate(payload, scales, spec: CompressionSpec,
                       n_peers: int) -> torch.Tensor:
    """Sum of ``n_peers`` dequantized contributions, float32
    ``(SB * block_size,)`` in element order."""
    if payload.device.type == "cpu":
        return dequant_accumulate_plain(payload, scales, spec, n_peers)
    what = "dequant_accumulate"
    sb = _check(what, payload, scales, spec, n_peers, requant=False)
    out = torch.empty(sb * spec.block_size, dtype=torch.float32,
                      device=payload.device)
    int4 = spec.dtype == "int4"
    plan = quant_plan(n_peers, sb, spec.payload_cols, int4,
                      payload.data_ptr() % 16 == 0)
    fn = function("quant_accumulate", "pt_dequant_accumulate", _ACC_ARGTYPES)
    rc = fn(payload.data_ptr(), scales.data_ptr(), out.data_ptr(), n_peers,
            sb, spec.payload_cols, int(int4), *plan,
            stream_handle(payload.device))
    raise_on_error(what, rc)
    count_launch("dequant_accumulate", payload.dtype)
    return out


def dequant_accumulate_requant(payload, scales, spec: CompressionSpec,
                               n_peers: int):
    """The int8 receive stage with the requantization fused: (q2 (SB, C)
    int8, s2 (SB,) float32), ready for the stage-2 all_gather."""
    if payload.device.type == "cpu":
        return dequant_accumulate_requant_plain(payload, scales, spec,
                                                n_peers)
    what = "dequant_accumulate_requant"
    sb = _check(what, payload, scales, spec, n_peers, requant=True)
    q2 = torch.empty((sb, spec.payload_cols), dtype=torch.int8,
                     device=payload.device)
    s2 = torch.empty(sb, dtype=torch.float32, device=payload.device)
    plan = quant_plan(n_peers, sb, spec.payload_cols, False,
                      payload.data_ptr() % 16 == 0, requant=True)
    fn = function("quant_accumulate", "pt_dequant_accumulate_requant",
                  _REQUANT_ARGTYPES)
    rc = fn(payload.data_ptr(), scales.data_ptr(), q2.data_ptr(),
            s2.data_ptr(), n_peers, sb, spec.payload_cols, float(spec.qmax),
            1.0 / spec.qmax, *plan, stream_handle(payload.device))
    raise_on_error(what, rc)
    count_launch("dequant_accumulate_requant", payload.dtype)
    return q2, s2
