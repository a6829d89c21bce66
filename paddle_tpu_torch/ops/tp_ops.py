"""Tensor-model-parallel collective ops with explicit forward/backward
collective placement (the Megatron f/g pair) — the port of
paddle_tpu/ops/tp_ops.py.

- ``mp_copy`` (Megatron f): identity forward, all-reduce backward —
  placed where a replicated activation enters a column-parallel region.
- ``mp_allreduce_sum`` (Megatron g): all-reduce forward, identity
  backward — placed where row-parallel partial sums merge back to
  replicated.

Each is a ``torch.autograd.Function`` of ``collective_ops``
(``CopyToGroup``, ``SumOverGroup``) over the group of the op's axis in
the run's groups (``ctx.dp.over(axis)``), and the identity when the run
has no such axis (the JAX package's ``_axis``)."""

from __future__ import annotations

from .collective_ops import CopyToGroup, SumOverGroup
from .registry import register, x


def _axis(ctx, attrs):
    name = attrs.get("_axis_name", "tp")
    return name if name in ctx.axis_names else None


@register("mp_copy")
def _mp_copy_op(ctx, ins, attrs):
    a = x(ins, "X")
    axis = _axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    return {"Out": CopyToGroup.apply(a, ctx.dp.over(axis))}


@register("mp_allreduce_sum")
def _mp_allreduce_op(ctx, ins, attrs):
    a = x(ins, "X")
    axis = _axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    return {"Out": SumOverGroup.apply(a, ctx.dp.over(axis))}
