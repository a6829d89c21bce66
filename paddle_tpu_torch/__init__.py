"""paddle_tpu_torch — the PyTorch/CUDA port of paddle_tpu for NVIDIA
Hopper GPUs.

It keeps the JAX package's module paths, names and on-disk formats (the
program desc and ``params.npz``), imports ``torch`` and numpy only, and
replaces every Pallas TPU kernel on its paths with a CUDA kernel written
for ``sm_90a`` (``ops/cuda/``), built with ``nvcc`` at first use.  Entry
points run on the GPU unless the caller asks for the CPU.
"""

from . import ops            # registers the op impls and kernel routes
from . import fluid          # noqa: F401
from . import observability  # noqa: F401 — tracing, telemetry, flight
from .framework.core import CPUPlace, CUDAPlace  # noqa: F401

__version__ = "0.1.0"
