"""Blockwise wire quantization for collectives — the port of
paddle_tpu/ops/quantize_wire.py (EQuARX-style, "EQuARX: Efficient
Quantized AllReduce in XLA", arXiv:2506.17615).

A :class:`CompressionSpec` (dtype tier, block size, stochastic rounding)
rides on collective ops as a plain dict attr (``quant_spec``); the static
byte arithmetic is the JAX package's, and the quantize / dequantize steps
are torch tensor ops on the tensor's own device.

Scheme (per reduce group): the flat payload is zero-padded to whole
quantization blocks per rank and quantized blockwise (per-block float32
scales ``amax/qmax``, values rounded and clipped to the symmetric integer
range); an ``all_to_all`` moves each rank's shard j to rank j, which
dequantizes, accumulates in float32 and requantizes
(``ops/cuda/quant_kernels.py``); an ``all_gather`` rebuilds the reduced
tensor on every rank, which dequantizes locally — the same bytes in give
the same floats out, so replicas never diverge.

The arithmetic is the JAX package's as XLA compiles it (its collectives
always run under ``jit``): the scale is ``amax * float32(1 / qmax)`` —
XLA turns the division by the constant qmax into a multiply by its
reciprocal — and the values are divided by their block's scale with an
IEEE division by a tensor (on a GPU PyTorch divides by a Python scalar as
a multiply by its reciprocal, which is not that).  ``torch.round``
rounds half to even like ``jnp.round``.  So for the same input the
int8/int4 payloads and the scales are bit-identical to the JAX
package's and to the requantizing kernel's.
Stochastic rounding draws ``floor(x + u)``, ``u ~ U[0, 1)``, from a
``torch.Generator`` the caller seeds per rank; it matches the JAX
package in distribution only.

int4 packs two's-complement nibbles in an int8 carrier,
``(lo & 0xF) | (hi << 4)``; unpacking sign-extends by arithmetic shifts
(``(q << 4) >> 4`` and ``q >> 4``, which torch computes in int8)."""

from __future__ import annotations

from typing import Optional

import torch

#: dtype tier -> (bits on the wire per element, integer qmax; bf16 rides
#: the cast path and has no integer range)
DTYPE_TIERS = {
    "bfloat16": (16, None),
    "int8": (8, 127),
    "int4": (4, 7),
}

#: bytes of one per-block scale (float32)
SCALE_NBYTES = 4


class CompressionSpec:
    """Wire-compression spec carried on collective ops.

    ``dtype`` in {bfloat16, int8, int4}; ``block_size`` is the number of
    payload elements sharing one float32 scale; ``stochastic_rounding``
    replaces round-to-nearest-even with floor(x + u), u ~ U[0, 1)."""

    __slots__ = ("dtype", "block_size", "stochastic_rounding")

    def __init__(self, dtype: str = "int8", block_size: int = 256,
                 stochastic_rounding: bool = False):
        if dtype not in DTYPE_TIERS:
            raise ValueError(
                f"CompressionSpec: unknown wire dtype {dtype!r} — "
                f"supported tiers: {sorted(DTYPE_TIERS)}")
        block_size = int(block_size)
        if block_size <= 0:
            raise ValueError(
                f"CompressionSpec: block_size must be positive, got "
                f"{block_size}")
        if dtype == "int4" and block_size % 2:
            raise ValueError(
                "CompressionSpec: int4 packs two elements per byte — "
                f"block_size must be even, got {block_size}")
        self.dtype = dtype
        self.block_size = block_size
        self.stochastic_rounding = bool(stochastic_rounding)

    def to_attr(self) -> dict:
        """Plain-dict form carried in ``op.attrs['quant_spec']``."""
        return {"dtype": self.dtype, "block_size": self.block_size,
                "stochastic_rounding": self.stochastic_rounding}

    @classmethod
    def from_attr(cls, attr) -> Optional["CompressionSpec"]:
        if attr is None:
            return None
        if isinstance(attr, CompressionSpec):
            return attr
        if isinstance(attr, str):
            return cls(dtype=attr)
        return cls(dtype=attr.get("dtype", "int8"),
                   block_size=attr.get("block_size", 256),
                   stochastic_rounding=attr.get("stochastic_rounding",
                                                False))

    # -- static byte arithmetic ---------------------------------------------
    @property
    def wire_bits(self) -> int:
        return DTYPE_TIERS[self.dtype][0]

    @property
    def qmax(self) -> Optional[int]:
        return DTYPE_TIERS[self.dtype][1]

    @property
    def payload_cols(self) -> int:
        """Bytes per payload row (one quantization block)."""
        return self.block_size // 2 if self.dtype == "int4" \
            else self.block_size

    def num_blocks(self, numel: int) -> int:
        return -(-int(numel) // self.block_size)

    def payload_bytes(self, numel: int) -> int:
        """Bytes of the quantized payload for ``numel`` elements
        (block-padded; int4 packs two per byte)."""
        padded = self.num_blocks(numel) * self.block_size
        return padded * self.wire_bits // 8

    def wire_bytes(self, numel: int) -> int:
        """Payload + per-block scale bytes — what one direction of the
        collective moves for ``numel`` logical elements."""
        if self.dtype == "bfloat16":
            return int(numel) * 2
        return self.payload_bytes(numel) + \
            self.num_blocks(numel) * SCALE_NBYTES

    def __repr__(self):
        return (f"CompressionSpec(dtype={self.dtype!r}, "
                f"block_size={self.block_size}, "
                f"stochastic_rounding={self.stochastic_rounding})")


def quant_spec_of(attrs) -> Optional[CompressionSpec]:
    """The CompressionSpec an op carries, or None.  ``quant_spec`` wins
    over the legacy ``compress_dtype`` (which maps to the bf16 tier)."""
    if attrs.get("quant_spec") is not None:
        return CompressionSpec.from_attr(attrs["quant_spec"])
    if attrs.get("compress_dtype") in ("bfloat16", "bf16"):
        return CompressionSpec(dtype="bfloat16")
    return None


def pad_to_blocks(flat: torch.Tensor, multiple: int) -> torch.Tensor:
    """Zero-pad a 1-D tensor to a multiple of ``multiple`` elements."""
    pad = (-flat.shape[0]) % multiple
    if pad:
        flat = torch.cat([flat, flat.new_zeros(pad)])
    return flat


def quantize_blockwise(flat: torch.Tensor, spec: CompressionSpec,
                       generator: Optional[torch.Generator] = None):
    """float32 ``[k * block_size]`` -> (payload int8, scales float32
    ``[k]``).  int4 returns a packed carrier of half the elements per
    row.  With ``spec.stochastic_rounding`` and a ``generator`` the
    rounding is floor(x + u)."""
    qmax = spec.qmax
    blocks = flat.reshape(-1, spec.block_size)
    amax = blocks.abs().amax(dim=1)
    scale = torch.where(amax > 0, amax * torch.full_like(amax, 1.0 / qmax),
                        torch.ones_like(amax))
    r = blocks / scale[:, None]            # tensor / tensor: IEEE division
    if generator is not None and spec.stochastic_rounding:
        u = torch.rand(r.shape, generator=generator, device=r.device,
                       dtype=r.dtype)
        r = torch.floor(r + u)
    else:
        r = torch.round(r)
    q = torch.clamp(r, -qmax, qmax).to(torch.int8)
    if spec.dtype == "int4":
        q = (q[:, 0::2] & 0xF) | (q[:, 1::2] << 4)
    return q, scale


def unpack_int4(q: torch.Tensor) -> torch.Tensor:
    """(rows, C) packed int4 -> (rows, 2C) int8 in element order."""
    lo = (q << 4) >> 4
    hi = q >> 4
    return torch.stack([lo, hi], dim=-1).reshape(q.shape[0], -1)


def dequantize_blockwise(payload: torch.Tensor, scales: torch.Tensor,
                         spec: CompressionSpec) -> torch.Tensor:
    """Inverse of :func:`quantize_blockwise` -> float32
    ``[num_blocks * block_size]``."""
    q = unpack_int4(payload) if spec.dtype == "int4" else payload
    return (q.to(torch.float32) * scales[:, None]).reshape(-1)
