"""Hand-written Hopper (sm_90a) CUDA kernels — the port's counterpart of
``paddle_tpu/ops/pallas/``.

Each kernel lives in ``csrc/*.cu`` behind a plain C entry point, is built
with ``nvcc`` into a shared library at first use (``build.py``) and is
called through ``ctypes`` by a Python wrapper that:

* runs the kernel's plain PyTorch version when its tensors lie on the CPU
  (that is how the CPU tests exercise the arithmetic), and otherwise
  launches the kernel on a CUDA tensor or raises — there is no fallback;
* allocates the outputs, checks device, dtype, shape and contiguity, and
  raises on a non-zero return code (a refused launch);
* adds one to its entry in :data:`LAUNCHES` each time it launches.

Every kernel with a backward is called through a
``torch.autograd.Function`` whose backward is a kernel too (flash
attention, LayerNorm, add+LayerNorm, bias+GELU).

Nothing here builds, loads a library or imports anything GPU-specific at
import time."""

from __future__ import annotations

from typing import Dict

import torch

#: launches per kernel wrapper since the last :func:`reset_launch_counts`
#: (plain integers; only a real kernel launch counts, never a plain run)
LAUNCHES: Dict[str, int] = {
    "flash_attention_fwd": 0,
    "flash_attention_bwd_dq": 0,
    "flash_attention_bwd_dkv": 0,
    "layer_norm_fwd": 0,
    "layer_norm_bwd": 0,
    "add_layer_norm_fwd": 0,
    "add_layer_norm_bwd": 0,
    "bias_gelu_fwd": 0,
    "bias_gelu_bwd": 0,
    "adam": 0,
    "dequant_accumulate": 0,
    "dequant_accumulate_requant": 0,
}

#: dtype codes understood by the C entry points (csrc/common.cuh PtDtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def reset_launch_counts():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def launch_counts() -> Dict[str, int]:
    return dict(LAUNCHES)


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported by the "
                        f"CUDA kernel (float32 or bfloat16)")
    return code


def stream_handle(device: torch.device) -> int:
    """The raw cudaStream_t of PyTorch's current stream on ``device``."""
    return torch.cuda.current_stream(device).cuda_stream


def check_cuda(what: str, ref: torch.Tensor, *tensors):
    """Every tensor must be a contiguous CUDA tensor on ``ref``'s device
    with ``ref``'s dtype."""
    for t in (ref,) + tensors:
        if t.device != ref.device:
            raise ValueError(f"{what}: tensors on {t.device} and "
                             f"{ref.device}")
        if t.dtype != ref.dtype:
            raise TypeError(f"{what}: dtypes {t.dtype} and {ref.dtype} "
                            f"differ")
        if not t.is_contiguous():
            raise ValueError(f"{what}: the CUDA kernel needs contiguous "
                             f"tensors")


def raise_on_error(what: str, rc: int):
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def require_cuda(what: str, t: torch.Tensor):
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")


def needs_grad(*tensors) -> bool:
    """True when autograd would record an op on these tensors."""
    return torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors)

