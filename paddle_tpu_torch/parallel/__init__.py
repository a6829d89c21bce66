"""Parallelism package — the port of paddle_tpu/parallel/: device
topology, tensor, sequence, pipeline and expert parallelism.

The JAX package lays every strategy over one ``jax.sharding.Mesh`` with
named axes; the port runs one process per rank over a
``ProcessMesh`` of the same names:

=====  =========================================================
axis   meaning
=====  =========================================================
dp     data parallel — batch dim sharded, grads all-reduced
tp     tensor model parallel — param cols/rows sharded (Megatron)
sp     sequence/context parallel — seq dim sharded, ring attention
pp     pipeline parallel — layer stages, microbatches hop rank to rank
ep     expert parallel — experts sharded, tokens exchanged all-to-all
=====  =========================================================

``gpipe_spmd`` and ``PipelineOptimizer`` are ``parallel/pipeline.py``;
``moe_ffn``, ``collect_aux_losses`` and ``apply_expert_sharding`` are
``parallel/moe.py``."""

from .moe import (apply_expert_sharding, collect_aux_losses,  # noqa: F401
                  moe_ffn)
from .pipeline import PipelineOptimizer, gpipe_spmd  # noqa: F401
from .ring_attention import ring_attention  # noqa: F401
from .topology import (DeviceTopology, auto_mesh, build_mesh,  # noqa: F401
                       tpu_slice_env)
from .tp_layers import (column_parallel_fc, parallel_ffn,  # noqa: F401
                        parallel_multihead_attention, row_parallel_fc,
                        vocab_parallel_embedding)

