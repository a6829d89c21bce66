"""Device topology / mesh construction — the port of
paddle_tpu/parallel/topology.py.

The JAX package lays named axes over ``jax.devices()`` as a
``jax.sharding.Mesh``.  The port runs one process per rank, so the
topology is the ``torch.distributed`` process group and a mesh is a
:class:`~..framework.mesh_layout.ProcessMesh`: the named axes above size
1, in the JAX package's axis order, each rank at its row-major
coordinates."""

from __future__ import annotations

from typing import Dict, Optional, Sequence

from ..framework.errors import UnimplementedError
from ..framework.mesh_layout import ProcessMesh

_AXIS_ORDER = ("dp", "pp", "tp", "sp", "ep")


def _world() -> int:
    import torch.distributed as dist
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


class DeviceTopology:
    """Named-axis topology over the ranks of the process group (the
    analog of the reference's RoleMaker + NCCLContextMap pair).
    ``devices`` is the JAX package's keyword: one process drives one
    device, so it is the number of ranks (an int) or a list whose length
    is, and defaults to the process group's size."""

    def __init__(self, axes: Dict[str, int], devices=None):
        self.axes = {str(a): int(n) for a, n in dict(axes).items()}
        have = _world() if devices is None else (
            int(devices) if isinstance(devices, int) else len(devices))
        n = 1
        for s in self.axes.values():
            n *= s
        if n > have:
            raise ValueError(
                f"topology {self.axes} needs {n} devices, have {have}")
        self.world_size = n

    def mesh(self) -> Optional[ProcessMesh]:
        """The :class:`ProcessMesh` of the axes above size 1 in the JAX
        package's order (dp, pp, tp, sp, ep, then the rest), or None when
        no axis is.  The process group must have as many ranks."""
        names = [a for a in _AXIS_ORDER if a in self.axes]
        names += [a for a in self.axes if a not in names]
        real = [a for a in names if self.axes[a] > 1]
        if not real:
            return None
        if _world() != self.world_size:
            raise ValueError(
                f"topology {self.axes} needs {self.world_size} ranks, the "
                f"process group has {_world()}")
        return ProcessMesh(tuple(real), tuple(self.axes[a] for a in real))


def build_mesh(axes: Dict[str, int], devices=None) -> Optional[ProcessMesh]:
    """``build_mesh({"dp": 2, "tp": 2})`` → ProcessMesh over (dp, tp)."""
    return DeviceTopology(axes, devices).mesh()


def _factor(n: int, ways: int) -> list:
    """Split n into `ways` factors, largest first (greedy powers of two)."""
    out = []
    for i in range(ways - 1, 0, -1):
        f = 1
        while n % 2 == 0 and f * f * (2 ** i) <= n:
            n //= 2
            f *= 2
        out.append(f)
    out.append(n)
    return sorted(out, reverse=True)


def auto_mesh(n_devices: Optional[int] = None,
              axis_names: Sequence[str] = ("dp", "tp"), devices=None):
    """Factor the rank count over the requested axes, largest factor
    first (the JAX package's rule)."""
    n = _world() if devices is None else (
        int(devices) if isinstance(devices, int) else len(devices))
    if n_devices is not None:
        n = min(n, int(n_devices))
    axes = dict(zip(axis_names, _factor(n, len(axis_names))))
    return build_mesh(axes, n)


def tpu_slice_env() -> Dict[str, str]:
    """The JAX package reads TPU pod-slice metadata from the environment;
    the port runs on GPUs and has no such slice."""
    raise UnimplementedError(
        "tpu_slice_env: TPU pod-slice discovery has no counterpart on the "
        "GPU; the port's ranks come from torch.distributed (RANK, "
        "WORLD_SIZE, MASTER_ADDR from paddle_tpu_torch.distributed.launch)")
