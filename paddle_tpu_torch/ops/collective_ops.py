"""Collective communication ops on ``torch.distributed`` — the port of
paddle_tpu/ops/collective_ops.py (ref: operators/collective/
c_allreduce_op.h, c_broadcast_op.h, c_allgather_op.h,
c_reducescatter_op.h).

The JAX package maps ``ring_id`` onto a mesh axis and lowers the ops to
XLA collectives inside the executor's ``shard_map``.  The port runs one
process per rank: a data-parallel run carries a :class:`DataParallelGroup`
(rank, world size, process group, backend) on its lowering context, whose
one axis, ``"dp"``, is what ``ring_id`` / ``_axis_name`` resolve to
(:func:`_ring_axis`, the JAX package's rules).  Outside a process group of
more than one rank every op is the identity, as in the JAX package.

On the gloo backend a tensor on a GPU is staged through host memory for
the transfer (gloo moves host buffers); computation stays on the tensor's
device.  NCCL moves device buffers directly.  The backend is the one the
process group was created with: nothing here picks another.

The blockwise-quantized all-reduce (``c_quant_allreduce_sum``,
``c_fused_quant_allreduce_sum``): quantize -> ``all_to_all`` of each
rank's shard at wire width -> the receive stage on the CUDA kernels of
``ops/cuda/quant_kernels.py`` (route ``dequant_accumulate``) ->
``all_gather`` -> dequantize.  ZeRO's ``quant_reduce_scatter`` and
``zero_*``, ``fsdp_all_gather``, the tensor-parallel ``c_embedding`` /
``c_split`` / ``c_concat``, ``collective_permute``,
``pipe_stage_boundary`` and ``local_sgd_sync`` are not ported yet and
stay unregistered."""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .cuda import quant_kernels as cuda_quant
from .quantize_wire import (CompressionSpec, dequantize_blockwise,
                            pad_to_blocks, quantize_blockwise)
from .registry import cuda_route, register, x

DP_AXIS = "dp"


class DataParallelGroup:
    """The process group a data-parallel run reduces over — the port's
    counterpart of the JAX package's ``dp`` mesh axis."""

    __slots__ = ("rank", "world", "group", "backend", "axis_name")

    def __init__(self, rank: int, world: int, backend: str, group=None,
                 axis_name: str = DP_AXIS):
        self.rank = int(rank)
        self.world = int(world)
        self.backend = str(backend)
        self.group = group
        self.axis_name = axis_name

    @classmethod
    def current(cls, axis_name: str = DP_AXIS
                ) -> Optional["DataParallelGroup"]:
        """The default process group as a data-parallel group over
        ``axis_name``, or None when ``torch.distributed`` has no group of
        more than one rank."""
        import torch.distributed as dist
        if not (dist.is_available() and dist.is_initialized()):
            return None
        world = dist.get_world_size()
        if world < 2:
            return None
        return cls(dist.get_rank(), world, dist.get_backend(),
                   axis_name=axis_name)

    def __repr__(self):
        return (f"DataParallelGroup(rank={self.rank}, world={self.world}, "
                f"backend={self.backend!r})")


# ---------------------------------------------------------------------------
# transfers (gloo: staged through host memory)
# ---------------------------------------------------------------------------


def _on_wire(dp: DataParallelGroup, t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy of ``t`` in the memory the backend moves."""
    if dp.backend == "gloo" and t.device.type != "cpu":
        return t.detach().to("cpu").contiguous()
    return t.detach().clone(memory_format=torch.contiguous_format)


def all_reduce(dp: DataParallelGroup, t: torch.Tensor, op="sum"):
    """The reduction of ``t`` over the group (a new tensor)."""
    import torch.distributed as dist
    ops = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}
    w = _on_wire(dp, t)
    dist.all_reduce(w, op=ops[op], group=dp.group)
    return w.to(t.device)


def all_gather(dp: DataParallelGroup, t: torch.Tensor, dim: int = 0):
    """Every rank's ``t`` concatenated along ``dim`` in rank order."""
    import torch.distributed as dist
    w = _on_wire(dp, t)
    parts = [torch.empty_like(w) for _ in range(dp.world)]
    dist.all_gather(parts, w, group=dp.group)
    return torch.cat(parts, dim=dim).to(t.device)


def all_to_all(dp: DataParallelGroup, t: torch.Tensor):
    """``t`` with leading dim n = world: rank r sends ``t[j]`` to rank j
    and returns the pieces it received, stacked in peer order (the JAX
    ``all_to_all(split_axis=0, concat_axis=0)``)."""
    import torch.distributed as dist
    if t.shape[0] != dp.world:
        raise ValueError(f"all_to_all: leading dim {t.shape[0]} is not the "
                         f"world size {dp.world}")
    w = _on_wire(dp, t)
    send = list(w.unbind(0))
    recv = [torch.empty_like(p) for p in send]
    # one batch of point-to-point pairs on every backend (NCCL groups it
    # into one launch; gloo's all_to_all is missing from some torch builds)
    recv[dp.rank].copy_(send[dp.rank])
    pairs = []
    for j in range(dp.world):
        if j != dp.rank:
            pairs.append(dist.P2POp(dist.isend, send[j], j, group=dp.group))
            pairs.append(dist.P2POp(dist.irecv, recv[j], j, group=dp.group))
    for req in dist.batch_isend_irecv(pairs):
        req.wait()
    return torch.stack(recv).to(t.device)


def broadcast(dp: DataParallelGroup, t: torch.Tensor, root: int):
    import torch.distributed as dist
    w = _on_wire(dp, t)
    dist.broadcast(w, src=int(root), group=dp.group)
    return w.to(t.device)


def _peer_sum(stacked: torch.Tensor) -> torch.Tensor:
    """Sum over the leading peer dim in peer order."""
    acc = torch.zeros_like(stacked[0])
    for part in stacked.unbind(0):
        acc = acc + part
    return acc


# ---------------------------------------------------------------------------
# ops
# ---------------------------------------------------------------------------


def _ring_axis(ctx, attrs):
    """ring_id -> the group's axis name(s); None when the run has no
    process group (every collective is then the identity).
    ``_axis_name`` may be a tuple, filtered to the axes the run has."""
    names = ctx.axis_names
    if not names:
        return None
    mapping = attrs.get("_axis_name")
    if mapping:
        if isinstance(mapping, (tuple, list)):
            axes = tuple(a for a in mapping if a in names)
            return axes or None
        return mapping if mapping in names else None
    ring_id = attrs.get("ring_id", 0)
    if isinstance(ring_id, int) and ring_id < len(names):
        return names[ring_id]
    return names[0]


def _allreduce(op):
    def impl(ctx, ins, attrs):
        a = x(ins, "X")
        if _ring_axis(ctx, attrs) is None:
            return {"Out": a}
        return {"Out": all_reduce(ctx.dp, a, op)}
    return impl


def _compressed(dp, a, compress_dtype):
    """Cast -> all-reduce -> upcast (the bf16 tier)."""
    wire = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float16": torch.float16}[str(compress_dtype)]
    return all_reduce(dp, a.to(wire)).to(a.dtype)


@register("c_allreduce_sum")
def _c_allreduce_sum(ctx, ins, attrs):
    a = x(ins, "X")
    if _ring_axis(ctx, attrs) is None:
        return {"Out": a}
    comp = attrs.get("compress_dtype")
    if comp and a.is_floating_point():
        return {"Out": _compressed(ctx.dp, a, comp)}
    return {"Out": all_reduce(ctx.dp, a)}


register("c_allreduce_max")(_allreduce("max"))
register("c_allreduce_min")(_allreduce("min"))


@register("c_allreduce_prod")
def _c_allreduce_prod(ctx, ins, attrs):
    """Exact product-allreduce: gather every rank's tensor and multiply
    (no log/exp, so zeros, negatives and integers stay exact)."""
    a = x(ins, "X")
    if _ring_axis(ctx, attrs) is None:
        return {"Out": a}
    gathered = all_gather(ctx.dp, a.unsqueeze(0))
    return {"Out": torch.prod(gathered, dim=0).to(a.dtype)}


def _split_like(flat, like):
    pieces, off = [], 0
    for a in like:
        n = a.numel()
        pieces.append(flat[off:off + n].reshape(a.shape))
        off += n
    return pieces


@register("c_fused_allreduce_sum")
def _c_fused_allreduce_sum(ctx, ins, attrs):
    """Bucketed gradient all-reduce: the bucket's grads flatten into one
    buffer, all-reduced once, and split back.  ``scale`` folds the
    1/nranks mean; ``compress_dtype`` runs the collective in bf16."""
    xs = list(ins.get("X", []))
    if not xs:
        return {"Out": []}
    scale = attrs.get("scale")
    outs = xs if scale is None else [a * scale for a in xs]
    if _ring_axis(ctx, attrs) is None:
        return {"Out": outs}
    flat = torch.cat([a.reshape(-1) for a in outs])
    comp = attrs.get("compress_dtype")
    if comp and flat.is_floating_point():
        flat = _compressed(ctx.dp, flat, comp)
    else:
        flat = all_reduce(ctx.dp, flat)
    return {"Out": _split_like(flat, outs)}


def _quant_route(op_type, ins, attrs, n_peers) -> bool:
    """The receive stage's kernel route (counted in
    ``registry.route_counts()``); on the card a rejected input raises."""
    route, _ = cuda_route(op_type, ins, dict(attrs, _n_peers=n_peers))
    return route is not None


def _quant_allreduce_flat(ctx, flat, spec: CompressionSpec, use_kernel):
    """The two-stage quantized all-reduce of a float32 flat tensor:
    quantize -> all_to_all shards -> receive stage (dequantize,
    accumulate over peers, requantize) -> all_gather -> dequantize.
    Returns (the reduced flat tensor at the input length, the stage-2
    scales)."""
    dp = ctx.dp
    n = dp.world
    numel = flat.shape[0]
    flat = pad_to_blocks(flat, n * spec.block_size)
    sb = flat.shape[0] // (n * spec.block_size)
    gen = ctx.generator if spec.stochastic_rounding else None
    q, s = quantize_blockwise(flat, spec, gen)
    qx = all_to_all(dp, q.reshape(n, sb, -1)).reshape(n * sb, -1)
    sx = all_to_all(dp, s.reshape(n, sb)).reshape(-1)
    if spec.dtype == "int8" and not spec.stochastic_rounding:
        requant = cuda_quant.dequant_accumulate_requant if use_kernel \
            else cuda_quant.dequant_accumulate_requant_plain
        q2, s2 = requant(qx, sx, spec, n)
    else:
        acc = cuda_quant.dequant_accumulate if use_kernel \
            else cuda_quant.dequant_accumulate_plain
        q2, s2 = quantize_blockwise(acc(qx, sx, spec, n), spec, gen)
    # stage 2: the same bytes on every rank, so the local dequantization
    # cannot diverge across replicas
    qf = all_gather(dp, q2.reshape(-1))
    sf = all_gather(dp, s2)
    full = dequantize_blockwise(qf.reshape(n * sb, -1), sf, spec)
    return full[:numel], sf


@register("c_quant_allreduce_sum")
def _c_quant_allreduce_sum(ctx, ins, attrs):
    """Per-leaf blockwise-quantized all-reduce (the int8/int4 tiers).
    attrs: ``quant_spec``, optional ``scale`` (the 1/nranks mean)."""
    a = x(ins, "X")
    scale = attrs.get("scale")
    if scale is not None:
        a = a * scale
    if _ring_axis(ctx, attrs) is None:
        return {"Out": a}
    spec = CompressionSpec.from_attr(attrs["quant_spec"])
    use_kernel = _quant_route("c_quant_allreduce_sum", ins, attrs,
                              ctx.dp.world)
    flat, _ = _quant_allreduce_flat(ctx, a.reshape(-1).float(), spec,
                                    use_kernel)
    return {"Out": flat.reshape(a.shape).to(a.dtype)}


@register("c_fused_quant_allreduce_sum")
def _c_fused_quant_allreduce_sum(ctx, ins, attrs):
    """Bucketed quantized all-reduce: the bucket's grads ride the
    two-stage quantized collective once; the stage-2 scales come out on
    ``QScale``."""
    xs = list(ins.get("X", []))
    if not xs:
        return {"Out": []}
    scale = attrs.get("scale")
    outs = xs if scale is None else [a * scale for a in xs]
    if _ring_axis(ctx, attrs) is None:
        return {"Out": outs}
    spec = CompressionSpec.from_attr(attrs["quant_spec"])
    flat = torch.cat([a.reshape(-1) for a in outs])
    use_kernel = _quant_route("c_fused_quant_allreduce_sum", ins, attrs,
                              ctx.dp.world)
    red, scales = _quant_allreduce_flat(ctx, flat.float(), spec, use_kernel)
    return {"Out": _split_like(red.to(flat.dtype), outs), "QScale": scales}


@register("c_broadcast")
def _c_broadcast(ctx, ins, attrs):
    a = x(ins, "X")
    if _ring_axis(ctx, attrs) is None:
        return {"Out": a}
    return {"Out": broadcast(ctx.dp, a, attrs.get("root", 0))}


@register("c_allgather")
def _c_allgather(ctx, ins, attrs):
    a = x(ins, "X")
    if _ring_axis(ctx, attrs) is None:
        return {"Out": a}
    dim = attrs.get("gather_dim", 0)
    return {"Out": all_gather(ctx.dp, a, dim if dim >= 0 else dim + a.dim())}


@register("c_reducescatter")
def _c_reducescatter(ctx, ins, attrs):
    """Rank r's 1/n slice (dim 0) of the sum: every rank's slice r moves
    to rank r, which adds them in peer order."""
    a = x(ins, "X")
    if _ring_axis(ctx, attrs) is None:
        return {"Out": a}
    n = ctx.dp.world
    parts = a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))
    return {"Out": _peer_sum(all_to_all(ctx.dp, parts))}


@register("alltoall")
def _alltoall(ctx, ins, attrs):
    a = x(ins, "X")
    if _ring_axis(ctx, attrs) is None:
        return {"Out": a}
    n = ctx.dp.world
    parts = a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))
    return {"Out": all_to_all(ctx.dp, parts).reshape(a.shape)}


@register("c_identity")
@register("c_sync_calc_stream")
@register("c_sync_comm_stream")
def _c_identity(ctx, ins, attrs):
    # one stream per rank: collectives and compute are already ordered
    return {"Out": x(ins, "X")}


def _noop(ctx, ins, attrs):
    return {}


for _name in ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id", "barrier"):
    register(_name)(_noop)


def merge_fetch(dp: Optional[DataParallelGroup], value, replicated: bool):
    """A fetched value under data parallelism (ref: the reference's
    FetchOpHandle, the JAX package's ``_merge_fetch``): replicated values
    (persistables, everything written from the backward op on) pass
    through; a float scalar is averaged over ranks, an integer scalar
    summed; any other tensor is batch-sharded and all-gathered along
    dim 0."""
    if dp is None or replicated or not isinstance(value, torch.Tensor):
        return value
    if value.dim() == 0:
        if value.is_floating_point():
            return all_reduce(dp, value) / dp.world
        return all_reduce(dp, value)
    return all_gather(dp, value)


def slice_feed(dp: Optional[DataParallelGroup], name: str, value):
    """This rank's rows of a fed global batch (the JAX feed spec
    ``P(batch_axis)``): dim 0 split into ``world`` equal parts."""
    if dp is None:
        return value
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
    shape = tuple(value.shape)
    if not shape:
        return value
    from ..framework.errors import InvalidArgumentError
    if shape[0] % dp.world:
        raise InvalidArgumentError(
            f"feed {name!r}: the leading dim {shape[0]} does not divide "
            f"into {dp.world} data-parallel ranks")
    rows = shape[0] // dp.world
    return value[dp.rank * rows:(dp.rank + 1) * rows]
