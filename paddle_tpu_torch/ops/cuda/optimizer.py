"""The fused Adam update on Hopper — the counterpart of ``adam_update`` in
``paddle_tpu/ops/pallas/fused_ops.py``.

:func:`adam_multi` updates a run of tensors in one launch
(``csrc/adam.cu``, replaces ``_adam_kernel``): for each :class:`AdamTensor`
it computes the bias-corrected step ``lr * sqrt(1 - beta2_pow) /
(1 - beta1_pow)`` from device memory, updates p, m and v in place in one
pass, subtracts AdamW's decoupled decay ``(lr * coeff) * p`` (p as it was
before the update) when ``coeff`` is not 0, and advances both beta powers
once.  The JAX package gets the same effect from XLA, which fuses a step's
updates into one executable; the executor hands this wrapper every run of
Adam ops (``ops/optimizer_ops.py``).  :func:`adam` is a run of one.

Unlike the TPU kernel it takes any element count (the TPU's
``numel % 128 == 0 and numel >= 1024`` was its tiling's limit): BERT-base
has 80 parameters of 768 elements or fewer.  :func:`adam_multi_plain` is
the same update in plain PyTorch, in place too, with the per-op path's
arithmetic in its order (the kernel rounds every step the same way); CPU
tensors run it, CUDA tensors launch the kernel or raise."""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import check_cuda, count_launch, raise_on_error, require_cuda, \
    stream_handle
from .build import function

_P = ctypes.c_void_p
_I = ctypes.c_int
#: a row of the kernel's tensor table (csrc/adam.cu AdamTensor, 88 bytes)
_ROW = np.dtype([("p", "<u8"), ("g", "<u8"), ("m", "<u8"), ("v", "<u8"),
                 ("lr", "<u8"), ("beta1_pow", "<u8"), ("beta2_pow", "<u8"),
                 ("n", "<i8"), ("b1", "<f4"), ("omb1", "<f4"),
                 ("b2", "<f4"), ("omb2", "<f4"), ("eps", "<f4"),
                 ("coeff", "<f4")])
#: the most tensors one launch takes (csrc/adam.cu kMaxTensors: its table
#: rides in the kernel's parameters); a longer run takes several launches
MAX_TENSORS = 256
#: elements a block of the kernel updates
CHUNK = 1 << 14
#: (device index, element counts) -> the device chunk list of that run
_CHUNKS: Dict[Tuple[int, Tuple[int, ...]], torch.Tensor] = {}


class AdamTensor(NamedTuple):
    """One tensor's Adam update: float32 p, g, m, v of one shape, and the
    one-element float32 LR and beta powers (the powers are advanced in
    place).  ``coeff`` is AdamW's decay coefficient, 0 for none."""
    p: torch.Tensor
    g: torch.Tensor
    m: torch.Tensor
    v: torch.Tensor
    lr: torch.Tensor
    beta1_pow: torch.Tensor
    beta2_pow: torch.Tensor
    beta1: float = 0.9
    beta2: float = 0.999
    eps: float = 1e-8
    coeff: float = 0.0


def adam_supported(p, g, m, v, beta1_pow=None, beta2_pow=None
                   ) -> Tuple[bool, str]:
    """What the Adam kernel rejects: operands of different sizes, dtypes
    other than float32, and beta powers that are not one float32 each."""
    if not (p.shape == g.shape == m.shape == v.shape):
        return False, "shape-mismatch"
    for t in (p, g, m, v):
        if t.dtype != torch.float32:
            return False, f"dtype:{t.dtype}"
    if p.numel() == 0:
        return False, "empty"
    for name, t in (("beta1_pow", beta1_pow), ("beta2_pow", beta2_pow)):
        if t is not None and (t.dtype != torch.float32 or t.numel() != 1):
            return False, f"{name}:{t.dtype}x{t.numel()}"
    return True, ""


def adam_plain(p, g, m, v, lr_t, beta1=0.9, beta2=0.999, eps=1e-8):
    """One tensor's update in plain PyTorch, in place on p, m and v:
    m = b1*m + (1-b1)*g; v = b2*v + (1-b2)*g*g;
    p = p - lr_t * m / (sqrt(v) + eps).  Returns (p, m, v)."""
    m.mul_(beta1).add_(g * (1.0 - beta1))
    v.mul_(beta2).add_((g * (1.0 - beta2)) * g)
    p.sub_(lr_t * m / (v.sqrt() + eps))
    return p, m, v


def adam_multi_plain(tensors: Sequence[AdamTensor]) -> None:
    """The kernel's function in plain PyTorch, tensor by tensor in the
    per-op path's order: the step size from the powers, AdamW's decay term
    from p before the update, :func:`adam_plain`, the decay subtracted,
    then both powers advanced, all in place."""
    for e in tensors:
        lr_t = e.lr * torch.sqrt(1 - e.beta2_pow) / (1 - e.beta1_pow)
        decay = e.lr.to(e.p.dtype) * e.coeff * e.p if e.coeff else None
        adam_plain(e.p, e.g, e.m, e.v, lr_t.reshape(1).to(torch.float32),
                   e.beta1, e.beta2, e.eps)
        if decay is not None:
            e.p.sub_(decay)
        e.beta1_pow.mul_(e.beta1)
        e.beta2_pow.mul_(e.beta2)


def _chunks(device, numels, chunk) -> torch.Tensor:
    """The (tensor, chunk) int32 pairs that cover ``numels``, kept on the
    device per run of element counts."""
    key = (device.index, tuple(numels))
    found = _CHUNKS.get(key)
    if found is None:
        pairs = [(i, c) for i, n in enumerate(numels)
                 for c in range(-(-n // chunk))]
        found = torch.tensor(pairs, dtype=torch.int32, device=device)
        _CHUNKS[key] = found
    return found


def _check(what, e: AdamTensor, device):
    check_cuda(what, e.p, e.g, e.m, e.v)
    ok, why = adam_supported(e.p, e.g, e.m, e.v, e.beta1_pow, e.beta2_pow)
    if not ok:
        raise ValueError(f"{what}: unsupported ({why})")
    for name, t in (("lr", e.lr), ("beta1_pow", e.beta1_pow),
                    ("beta2_pow", e.beta2_pow)):
        if t.dtype != torch.float32 or t.numel() != 1 or \
                t.device != device:
            raise ValueError(f"{what}: {name} must be one float32 on "
                             f"{device}")
    if e.p.device != device:
        raise ValueError(f"{what}: tensors on {e.p.device} and {device}")


def adam_multi(tensors: Sequence[AdamTensor]) -> None:
    """One Adam step of every tensor in ``tensors``, in place (p, m, v and
    both beta powers), in one launch (several past the kernel's table of
    256).  No two entries may share a tensor.  CPU tensors run
    :func:`adam_multi_plain`; CUDA tensors launch the kernel or raise."""
    tensors = list(tensors)
    if not tensors:
        return
    device = tensors[0].p.device
    if device.type == "cpu":
        return adam_multi_plain(tensors)
    what = "adam"
    require_cuda(what, tensors[0].p)
    for e in tensors:
        _check(what, e, device)
    fn = function("adam", "pt_adam_multi", (_P, _I, _P, _I, _I, _P))
    stream = stream_handle(device)
    for start in range(0, len(tensors), MAX_TENSORS):
        run = tensors[start:start + MAX_TENSORS]
        table = np.array(
            [(e.p.data_ptr(), e.g.data_ptr(), e.m.data_ptr(),
              e.v.data_ptr(), e.lr.data_ptr(), e.beta1_pow.data_ptr(),
              e.beta2_pow.data_ptr(), e.p.numel(), e.beta1, 1.0 - e.beta1,
              e.beta2, 1.0 - e.beta2, e.eps, e.coeff) for e in run],
            dtype=_ROW)
        chunks = _chunks(device, [e.p.numel() for e in run], CHUNK)
        rc = fn(table.ctypes.data, len(run), chunks.data_ptr(),
                chunks.shape[0], CHUNK, stream)
        raise_on_error(what, rc)
        count_launch("adam", run[0].p.dtype)


def adam(p, g, m, v, lr, beta1_pow, beta2_pow, beta1=0.9, beta2=0.999,
         eps=1e-8, coeff=0.0):
    """One Adam step of one tensor, in place (a run of one of
    :func:`adam_multi`): ``lr`` is the op's LearningRate and the beta
    powers are advanced.  Returns (p, m, v), the same tensors."""
    adam_multi([AdamTensor(p, g, m, v, lr, beta1_pow, beta2_pow, beta1,
                           beta2, eps, coeff)])
    return p, m, v
