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
* adds one to its entry in :data:`LAUNCHES`, under the dtype of its
  operands, each time it launches (:func:`count_launch`).

Every kernel with a backward is called through a
``torch.autograd.Function`` whose backward is a kernel too (flash
attention, LayerNorm, add+LayerNorm, bias+GELU).

Nothing here builds, loads a library or imports anything GPU-specific at
import time."""

from __future__ import annotations

import threading
from typing import Dict, Tuple

import torch

#: launches per kernel wrapper and dtype of its operands since the last
#: :func:`reset_launch_counts`, e.g. ``LAUNCHES["flash_attention_fwd"]
#: ["bfloat16"]`` (only a real kernel launch counts, never a plain run)
LAUNCHES: Dict[str, Dict[str, int]] = {name: {} for name in (
    "flash_attention_fwd",
    "flash_attention_bwd_dq",
    "flash_attention_bwd_dkv",
    "layer_norm_fwd",
    "layer_norm_bwd",
    "add_layer_norm_fwd",
    "add_layer_norm_bwd",
    "bias_gelu_fwd",
    "bias_gelu_bwd",
    "adam",
    "dequant_accumulate",
    "dequant_accumulate_requant",
)}

#: dtype codes understood by the C entry points (csrc/common.cuh PtDtype)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


#: the counters are bumped from the autograd thread and the gradient-sync
#: workers as well as the caller's
_LAUNCH_LOCK = threading.Lock()


def count_launch(name: str, dtype: torch.dtype):
    """One launch of kernel wrapper ``name`` on operands of ``dtype``."""
    by_dtype = LAUNCHES[name]
    key = str(dtype).replace("torch.", "")
    with _LAUNCH_LOCK:
        by_dtype[key] = by_dtype.get(key, 0) + 1


def reset_launch_counts():
    with _LAUNCH_LOCK:
        for by_dtype in LAUNCHES.values():
            by_dtype.clear()


def launch_counts() -> Dict[str, int]:
    """Launches per kernel wrapper, whatever the dtype."""
    with _LAUNCH_LOCK:
        return {name: sum(by_dtype.values())
                for name, by_dtype in LAUNCHES.items()}


def launch_counts_by_dtype() -> Dict[Tuple[str, str], int]:
    """Launches per (kernel wrapper, dtype of its operands)."""
    with _LAUNCH_LOCK:
        return {(name, dt): n for name, by_dtype in LAUNCHES.items()
                for dt, n in by_dtype.items()}


def dtype_code(t: torch.Tensor, what: str) -> int:
    code = DTYPE_CODES.get(t.dtype)
    if code is None:
        raise TypeError(f"{what}: dtype {t.dtype} is not supported by the "
                        f"CUDA kernels (float32, bfloat16, float16)")
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

