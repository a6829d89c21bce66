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
from typing import Optional, Tuple

import torch

from ...framework.errors import UnimplementedError
from ..quantize_wire import CompressionSpec, quantize_blockwise, unpack_int4
from . import LAUNCHES, raise_on_error, require_cuda, stream_handle
from .build import function

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ACC_ARGTYPES = (_P, _P, _P, _I, _LL, _I, _I, _P)
_REQUANT_ARGTYPES = (_P, _P, _P, _P, _I, _LL, _I, ctypes.c_float,
                     ctypes.c_float, _P)

#: the requantizing kernel keeps one float32 row per warp in 48 KB of
#: shared memory
REQUANT_MAX_BLOCK = 12288


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
    fn = function("quant_accumulate", "pt_dequant_accumulate", _ACC_ARGTYPES)
    rc = fn(payload.data_ptr(), scales.data_ptr(), out.data_ptr(), n_peers,
            sb, spec.payload_cols, int(spec.dtype == "int4"),
            stream_handle(payload.device))
    raise_on_error(what, rc)
    LAUNCHES["dequant_accumulate"] += 1
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
    fn = function("quant_accumulate", "pt_dequant_accumulate_requant",
                  _REQUANT_ARGTYPES)
    rc = fn(payload.data_ptr(), scales.data_ptr(), q2.data_ptr(),
            s2.data_ptr(), n_peers, sb, spec.payload_cols, float(spec.qmax),
            1.0 / spec.qmax, stream_handle(payload.device))
    raise_on_error(what, rc)
    LAUNCHES["dequant_accumulate_requant"] += 1
    return q2, s2
