"""Parallelism package — the port of paddle_tpu/parallel/: device
topology, tensor and sequence parallelism.

The JAX package lays every strategy over one ``jax.sharding.Mesh`` with
named axes; the port runs one process per rank over a
``ProcessMesh`` of the same names:

=====  =========================================================
axis   meaning
=====  =========================================================
dp     data parallel — batch dim sharded, grads all-reduced
tp     tensor model parallel — param cols/rows sharded (Megatron)
sp     sequence/context parallel — seq dim sharded, ring attention
pp     pipeline parallel — not ported yet
ep     expert parallel — not ported yet
=====  =========================================================

``gpipe_spmd``, ``PipelineOptimizer``, ``moe_ffn``, ``collect_aux_losses``
and ``apply_expert_sharding`` raise :class:`UnimplementedError` by name
until their slices."""

from ..framework.errors import UnimplementedError
from .ring_attention import ring_attention  # noqa: F401
from .topology import (DeviceTopology, auto_mesh, build_mesh,  # noqa: F401
                       tpu_slice_env)
from .tp_layers import (column_parallel_fc, parallel_ffn,  # noqa: F401
                        parallel_multihead_attention, row_parallel_fc,
                        vocab_parallel_embedding)


def _unported(name, what):
    def refuse(*args, **kwargs):
        raise UnimplementedError(
            f"parallel.{name}: {what} is not ported yet; it waits for its "
            f"slice")
    refuse.__name__ = name
    return refuse


gpipe_spmd = _unported("gpipe_spmd", "pipeline parallelism")
moe_ffn = _unported("moe_ffn", "the routed MoE FFN")
collect_aux_losses = _unported("collect_aux_losses",
                               "the MoE auxiliary losses")
apply_expert_sharding = _unported("apply_expert_sharding",
                                  "expert parallelism")


class PipelineOptimizer:
    """Pipeline parallelism is not ported yet: constructing one raises."""

    def __init__(self, *args, **kwargs):
        raise UnimplementedError(
            "parallel.PipelineOptimizer: pipeline parallelism is not "
            "ported yet; it waits for its slice")
