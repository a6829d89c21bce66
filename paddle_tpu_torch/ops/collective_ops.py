"""Collective communication ops on ``torch.distributed`` — the port of
paddle_tpu/ops/collective_ops.py (ref: operators/collective/
c_allreduce_op.h, c_broadcast_op.h, c_allgather_op.h,
c_reducescatter_op.h).

The JAX package maps ``ring_id`` onto a mesh axis and lowers the ops to
XLA collectives inside the executor's ``shard_map``.  The port runs one
process per rank, and a run carries its groups on its lowering context:
a :class:`DataParallelGroup` (rank, world size, process group, backend)
for a run over one axis (``"dp"``, or ``"fsdp"`` for ZeRO-3), or a
:class:`MeshGroups` for a mesh of several (HSDP's ``dp`` x ``fsdp``),
whose :meth:`~MeshGroups.over` gives the group of any set of its axes.
``ring_id`` / ``_axis_name`` resolve to an axis or a tuple of axes
(:func:`_ring_axis`, the JAX package's rules), and each op reduces over
the group of the axes it is given.  Outside a process group of more than
one rank every op is the identity, as in the JAX package.

On the gloo backend a tensor on a GPU is staged through host memory for
the transfer (gloo moves host buffers); computation stays on the tensor's
device.  NCCL moves device buffers directly.  The backend is the one the
process group was created with: nothing here picks another.

The blockwise-quantized all-reduce (``c_quant_allreduce_sum``,
``c_fused_quant_allreduce_sum``): quantize -> ``all_to_all`` of each
rank's shard at wire width -> the receive stage on the CUDA kernels of
``ops/cuda/quant_kernels.py`` (route ``dequant_accumulate``) ->
``all_gather`` -> dequantize.

ZeRO: ``zero_reduce_scatter`` (the flat gradient padded to ``n·align``,
each rank's 1/n slice summed over the group: ``all_to_all`` + a sum in
peer order, as ``c_reducescatter``; given several axes, it scatters over
the first after an all-reduce over the rest, as the JAX op's ``psum``
before its scatter), ``quant_reduce_scatter`` (likewise; quantize ->
``all_to_all`` at wire width -> the receive stage on kernel #11, no
requantize: the reduced float32 shard feeds the sharded update),
``zero_shard_slice`` (the rank's flat slice of a replicated tensor, no
communication), ``zero_all_gather`` (the updated shards gathered, the pad
dropped) and ``fsdp_all_gather`` (ZeRO-3: the full parameter gathered
from the resident shards along ``gather_dim``; its backward sums the
cotangent's slices over the group, so each rank's gradient arrives as
its shard — the JAX op's transpose, ``psum_scatter``; in an HSDP grid
both run on the rank's line of their own axis).  A sum over peers runs
in peer order, so over four ranks or two axes it is not a ``psum`` bit
for bit.

Tensor and sequence parallelism: ``c_embedding`` (the vocab-sharded
lookup: this rank's rows masked in, summed over the group forward, the
cotangent passing through the sum backward), ``c_allgather`` /
``c_concat`` (differentiable: the backward is the rank's slice of the
replicated cotangent — the one-device gradient, where the JAX package's
transpose sums it over the group), ``c_split`` (the rank's slice of dim
0; its backward gathers) and ``collective_permute`` (a ring shift over
the group's point-to-point pairs, :func:`ring_shift`; its backward
shifts the other way).  The Megatron f/g ops (``ops/tp_ops.py``) run
:class:`CopyToGroup` and :class:`SumOverGroup`.
``pipe_stage_boundary`` (a pipeline cut, ``framework/pipe.py``) is the
identity: the executor's pipelined lowering cuts the op list at it and
moves the crossing tensors itself (:func:`isend_to` / :func:`recv_from`).

A run over a sequence axis (``CompiledProgram.with_mesh(seq_axis=...,
feed_specs=...)``) splits each fed array by its spec (:func:`slice_feed`:
dim 0 over the batch axes, dim 1 over the sequence axis) and merges a
fetch over it too (:func:`merge_fetch`).

A persistable whose ``dist_attr`` names an axis of the run is sharded:
each rank holds only its block of the global value, its index in the
group of the axes that shard the dim, replicated over the other axes (an
fsdp-stamped parameter under HSDP: a block by the rank's fsdp
coordinate, the same on both dp rows).  :func:`block_of` (the
rank's block of a global value; the executor applies it to every
persistable it reads from or writes to the scope) and :func:`whole_of`
(the global value of a block: a fetch, a save) are that rule, and the
only code that knows it.

``local_sgd_sync`` (LocalSGD's periodic parameter average) reads its step
counter on the host to decide whether this run syncs: every rank holds
the same counter, so all take the same path, and a step that does not
sync sends nothing (the JAX package's ``lax.cond``)."""

from __future__ import annotations

import contextlib

import itertools
import math
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from ..framework.errors import UnimplementedError
from .cuda import quant_kernels as cuda_quant
from .quantize_wire import (CompressionSpec, dequantize_blockwise,
                            pad_to_blocks, quantize_blockwise)
from .registry import LoweringContext, cuda_route, register, x

DP_AXIS = "dp"


class DataParallelGroup:
    """The process group of one mesh axis — the port's counterpart of a
    JAX mesh axis (``dp``, or ``fsdp`` for ZeRO-3): this rank's index in
    it (``rank``), its size (``world``), the ``torch.distributed`` group
    (None: the default group), the global ranks of its members in group
    order (``ranks``; None: ``0 .. world - 1``) and the axis name.  A run over one axis
    threads its group through the executor as the run's mesh: it answers
    :meth:`over` with itself.  ``batch_sharded`` says whether fed batches
    split over it (the JAX feed spec ``P(axis)``; ``with_mesh`` without a
    batch axis replicates them)."""

    __slots__ = ("rank", "world", "group", "backend", "axis_name",
                 "batch_sharded", "ranks", "seq_axis", "feed_specs")

    def __init__(self, rank: int, world: int, backend: str, group=None,
                 axis_name=DP_AXIS, ranks=None):
        self.rank = int(rank)
        self.world = int(world)
        self.backend = str(backend)
        self.group = group
        self.axis_name = axis_name
        self.batch_sharded = True
        self.ranks = None if ranks is None else [int(r) for r in ranks]
        #: the sequence-parallel axis of the run, or None; the fed arrays'
        #: specs ({name: one entry a dim}, the JAX feed_specs)
        self.seq_axis = None
        self.feed_specs = {}

    def global_rank(self, i: int) -> int:
        """The global rank of the group's member ``i``."""
        return int(i) if self.ranks is None else self.ranks[int(i)]

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

    @property
    def axis_names(self):
        """The run's axes: this group's one."""
        return (self.axis_name,)

    def over(self, axes) -> "DataParallelGroup":
        """The group over ``axes``: this one (its axis is the run's)."""
        return self

    def batch_group(self) -> Optional["DataParallelGroup"]:
        """The group fed batches split over (and fetches merge over), or
        None."""
        return self if self.batch_sharded else None

    def seq_group(self) -> Optional["DataParallelGroup"]:
        """The group of the run's sequence axis, or None."""
        return self.over(self.seq_axis) if self.seq_axis in \
            self.axis_names else None

    def fold_index(self) -> int:
        """This rank's flat index over the batch and sequence axes: the
        shard its random draws are folded with (they differ per data and
        sequence shard and agree across a tensor-parallel line, as the
        JAX step folds only those axes into its key)."""
        return self.rank if self.batch_sharded or \
            self.seq_axis == self.axis_name else 0

    def sync_worker(self, axes, device) -> "SyncWorker":
        """The communication worker (:class:`SyncWorker`) of the group
        over ``axes`` on ``device``: one a set of member ranks and device
        in the process, made the first time it is asked for.  Making one
        creates process groups, a collective: every rank asks for the
        same workers in the same order."""
        import torch.distributed as dist
        g = self.over(axes)
        key = (id(dist.group.WORLD), tuple(g.ranks or range(g.world)),
               str(device))
        w = _SYNC_WORKERS.get(key)
        if w is None:
            w = _SYNC_WORKERS[key] = SyncWorker(self._twin(axes), device)
        return w

    def _twin(self, axes) -> "DataParallelGroup":
        """A group of its own over the same ranks as this one."""
        import torch.distributed as dist
        members = self.ranks or list(range(self.world))
        return DataParallelGroup(self.rank, self.world, self.backend,
                                 dist.new_group(members), self.axis_name,
                                 ranks=self.ranks)

    def __repr__(self):
        return (f"DataParallelGroup(rank={self.rank}, world={self.world}, "
                f"backend={self.backend!r})")


#: (default group, member ranks, device) -> the SyncWorker over them
_SYNC_WORKERS = {}


class MeshGroups(DataParallelGroup):
    """This rank's place in a :class:`~..framework.mesh_layout.ProcessMesh`
    of several axes (HSDP's ``dp`` x ``fsdp``): as a group it is the whole
    mesh (the default group, ``rank`` the global rank), and :meth:`over`
    gives the group of any set of its axes — the line of ranks that share
    this rank's coordinates on the other axes, indexed row-major over the
    set in mesh order.  ``batch_axes`` are the axes fed batches split
    over, by the rank's flat index over them."""

    __slots__ = ("mesh", "coords", "batch_axes", "_groups")

    def __init__(self, mesh, rank: int, backend: str, batch_axes=()):
        super().__init__(rank, mesh.size, backend,
                         axis_name=tuple(mesh.axis_names))
        self.mesh = mesh
        self.coords = mesh.coords(rank)
        self.batch_axes = tuple(a for a in mesh.axis_names
                                if a in tuple(batch_axes))
        self._groups = {}
        for k in range(1, len(mesh.axis_names)):
            # every line group, created in the same order on every rank
            for axes in itertools.combinations(mesh.axis_names, k):
                self.over(axes)

    @classmethod
    def of(cls, mesh, batch_axes=()) -> Optional["MeshGroups"]:
        """This process's place in ``mesh`` (a ``ProcessMesh``; a
        collective the first time a mesh of its shape is asked for: every
        rank calls it), or None outside a process group of more than one
        rank.  The group must have as many ranks as the mesh."""
        import torch.distributed as dist
        if mesh is None or not (dist.is_available() and
                                dist.is_initialized()):
            return None
        world = dist.get_world_size()
        if world < 2:
            return None
        if world != mesh.size:
            raise ValueError(f"{mesh!r} needs {mesh.size} ranks, the "
                             f"process group has {world}")
        from ..framework.mesh_layout import _flat_axes
        return cls(mesh, dist.get_rank(), dist.get_backend(),
                   _flat_axes(batch_axes))

    @property
    def axis_names(self):
        return tuple(self.mesh.axis_names)

    def over(self, axes) -> DataParallelGroup:
        if isinstance(axes, str):
            axes = (axes,)
        axes = tuple(a for a in self.mesh.axis_names if a in tuple(axes))
        if not axes:
            raise ValueError(f"no axis of {self.mesh!r} in {axes!r}")
        if len(axes) == len(self.mesh.axis_names):
            return self
        g = self._groups.get(axes)
        if g is None:
            group, members = self.mesh.line_group(self.rank, axes)
            g = DataParallelGroup(members.index(self.rank), len(members),
                                  self.backend, group,
                                  axes[0] if len(axes) == 1 else axes,
                                  ranks=members)
            self._groups[axes] = g
        return g

    def batch_group(self) -> Optional[DataParallelGroup]:
        return self.over(self.batch_axes) if self.batch_axes else None

    def fold_index(self) -> int:
        axes = self.batch_axes + tuple(
            a for a in (self.seq_axis,) if a in self.mesh.axis_names
            and a not in self.batch_axes)
        return self.over(axes).rank if axes else 0

    def _twin(self, axes) -> DataParallelGroup:
        """A group of its own over the ranks of :meth:`over` ``axes``: a
        line group of the mesh's ``"sync"`` set (every line of every axis
        set made at once, as :meth:`over`'s), or a new group over the
        whole mesh."""
        import torch.distributed as dist
        g = self.over(axes)
        if g is self:
            return DataParallelGroup(self.rank, self.world, self.backend,
                                     dist.new_group(list(range(self.world))),
                                     self.axis_name)
        group, members = self.mesh.line_group(
            self.rank, _axes_tuple(g.axis_name), tag="sync")
        return DataParallelGroup(g.rank, g.world, g.backend, group,
                                 g.axis_name, ranks=members)

    def __repr__(self):
        return (f"MeshGroups(rank={self.rank}, {self.mesh.shape}, "
                f"coords={self.coords}, backend={self.backend!r})")


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
            peer = dp.global_rank(j)
            pairs.append(dist.P2POp(dist.isend, send[j], peer,
                                    group=dp.group))
            pairs.append(dist.P2POp(dist.irecv, recv[j], peer,
                                    group=dp.group))
    for req in dist.batch_isend_irecv(pairs):
        req.wait()
    return torch.stack(recv).to(t.device)


def isend_to(g: DataParallelGroup, tensors, peer: int):
    """Send ``tensors`` (a list, in order) to member ``peer`` of the group:
    one batch of point-to-point sends, returned unwaited as (requests,
    wire buffers) — keep both until :func:`wait_sends`.  On gloo a tensor
    on a GPU is staged through host memory."""
    import torch.distributed as dist
    dst = g.global_rank(peer)
    ws = [_on_wire(g, t) for t in tensors]
    return dist.batch_isend_irecv([dist.P2POp(dist.isend, w, dst,
                                              group=g.group)
                                   for w in ws]), ws


def wait_sends(pending):
    """Wait for the ``(requests, buffers)`` pairs of :func:`isend_to`."""
    for reqs, _ in pending:
        for req in reqs:
            req.wait()


def reduce_scatter(g: DataParallelGroup, t: torch.Tensor, dim: int = 0):
    """This rank's block (its index along ``dim``, cut in ``g.world``
    equal blocks) of the sum of ``t`` over the group, summed in peer
    order."""
    n = g.world
    if t.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(t.shape)} "
                         f"does not divide into {n} ranks")
    blocks = torch.stack([b.contiguous() for b in t.chunk(n, dim)])
    return _peer_sum(all_to_all(g, blocks))


def recv_from(g: DataParallelGroup, likes, peer: int, device):
    """Receive tensors shaped and typed as ``likes`` ([(shape, dtype)]) from
    member ``peer`` of the group, on ``device``: one batch of
    point-to-point receives, waited for."""
    import torch.distributed as dist
    src = g.global_rank(peer)
    wire = torch.device("cpu") if g.backend == "gloo" else device
    bufs = [torch.empty(shape, dtype=dtype, device=wire)
            for shape, dtype in likes]
    reqs = dist.batch_isend_irecv([dist.P2POp(dist.irecv, b, src,
                                              group=g.group) for b in bufs])
    for req in reqs:
        req.wait()
    return [b.to(device) for b in bufs]


def broadcast(dp: DataParallelGroup, t: torch.Tensor, root: int):
    import torch.distributed as dist
    w = _on_wire(dp, t)
    dist.broadcast(w, src=dp.global_rank(root), group=dp.group)
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


def _group(ctx, axis) -> DataParallelGroup:
    """The process group over ``axis`` (a name or a tuple of names, as
    :func:`_ring_axis` returns them) of the run's mesh."""
    return ctx.dp.over(axis)


def _allreduce(op):
    def impl(ctx, ins, attrs):
        a = x(ins, "X")
        axis = _ring_axis(ctx, attrs)
        if axis is None:
            return {"Out": a}
        return {"Out": all_reduce(_group(ctx, axis), a, op)}
    return impl


def _compressed(reduce, a, compress_dtype):
    """Cast -> ``reduce`` (an all-reduce) -> upcast (the bf16 tier)."""
    wire = {"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
            "float16": torch.float16}[str(compress_dtype)]
    return reduce(a.to(wire)).to(a.dtype)


@register("c_allreduce_sum")
def _c_allreduce_sum(ctx, ins, attrs):
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    g = _group(ctx, axis)
    comp = attrs.get("compress_dtype")
    if comp and a.is_floating_point():
        return {"Out": _compressed(lambda t: all_reduce(g, t), a, comp)}
    return {"Out": all_reduce(g, a)}


@register("c_global_norm_allreduce")
def _c_global_norm_allreduce(ctx, ins, attrs):
    """A global-norm clip's partial sum of squares summed over the axes
    its gradients are sharded on (``clip.shard_global_norm``); the
    identity where the run lacks them."""
    return _c_allreduce_sum(ctx, ins, {k: v for k, v in attrs.items()
                                       if k != "compress_dtype"})


register("c_allreduce_max")(_allreduce("max"))
register("c_allreduce_min")(_allreduce("min"))


@register("c_allreduce_prod")
def _c_allreduce_prod(ctx, ins, attrs):
    """Exact product-allreduce: gather every rank's tensor and multiply
    (no log/exp, so zeros, negatives and integers stay exact)."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    gathered = all_gather(_group(ctx, axis), a.unsqueeze(0))
    return {"Out": torch.prod(gathered, dim=0).to(a.dtype)}


def _split_like(flat, shapes):
    """``flat`` cut into consecutive views of ``shapes``."""
    pieces, off = [], 0
    for shape in shapes:
        n = math.prod(shape)
        pieces.append(flat[off:off + n].reshape(shape))
        off += n
    return pieces


def _bucket_flat(xs, attrs):
    """(a bucket's gradients with the 1/nranks mean ``scale`` folded in,
    their flat concatenation)."""
    scale = attrs.get("scale")
    outs = xs if scale is None else [a * scale for a in xs]
    return outs, torch.cat([a.reshape(-1) for a in outs])


def _reduce_bucket(ctx, g, flat, attrs, use_kernel, reduce):
    """A flat bucket summed over the group ``g``: (the sum at ``flat``'s
    dtype, the stage-2 scales or None).  The quantized tiers run
    :func:`_quant_allreduce_flat` (the receive stage on the kernel route
    when ``use_kernel``); ``compress_dtype`` casts around ``reduce``;
    otherwise ``reduce`` (an all-reduce of a tensor over ``g``) alone."""
    spec = attrs.get("quant_spec")
    if spec is not None:
        red, scales = _quant_allreduce_flat(
            ctx, g, flat.float(), CompressionSpec.from_attr(spec),
            use_kernel)
        return red.to(flat.dtype), scales
    comp = attrs.get("compress_dtype")
    if comp and flat.is_floating_point():
        return _compressed(reduce, flat, comp), None
    return reduce(flat), None


@register("c_fused_allreduce_sum")
def _c_fused_allreduce_sum(ctx, ins, attrs):
    """Bucketed gradient all-reduce: the bucket's grads flatten into one
    buffer, all-reduced once, and split back.  ``scale`` folds the
    1/nranks mean; ``compress_dtype`` runs the collective in bf16."""
    xs = list(ins.get("X", []))
    if not xs:
        return {"Out": []}
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": _bucket_flat(xs, attrs)[0]}
    g = _group(ctx, axis)
    outs, flat = _bucket_flat(xs, attrs)
    red, _ = _reduce_bucket(ctx, g, flat, attrs, False,
                            lambda t: all_reduce(g, t))
    return {"Out": _split_like(red, [a.shape for a in outs])}


def _quant_route(op_type, ins, attrs, n_peers) -> bool:
    """The receive stage's kernel route (counted in
    ``registry.route_counts()``); on the card a rejected input raises."""
    route, _ = cuda_route(op_type, ins, dict(attrs, _n_peers=n_peers))
    return route is not None


def _quant_scatter(ctx, g, flat, spec: CompressionSpec, use_kernel,
                   requant: bool = False):
    """The scatter stage of the quantized collectives over the group
    ``g``: ``flat`` (float32) padded to ``n·block_size`` and quantized
    (stochastic rounding draws from the rank's generator), every peer's
    quantized copy of this rank's shard received at wire width by
    ``all_to_all``, then the receive stage on the kernel route
    (``use_kernel``) or its plain twin: the shard summed over the peers in
    float32 (#11), or with ``requant`` that sum requantized to int8 in the
    same pass (#12), as (payload, scales)."""
    n = g.world
    flat = pad_to_blocks(flat, n * spec.block_size)
    sb = flat.shape[0] // (n * spec.block_size)
    gen = ctx.generator if spec.stochastic_rounding else None
    q, s = quantize_blockwise(flat, spec, gen)
    qx = all_to_all(g, q.reshape(n, sb, -1)).reshape(n * sb, -1)
    sx = all_to_all(g, s.reshape(n, sb)).reshape(-1)
    if requant:
        fn = cuda_quant.dequant_accumulate_requant if use_kernel \
            else cuda_quant.dequant_accumulate_requant_plain
    else:
        fn = cuda_quant.dequant_accumulate if use_kernel \
            else cuda_quant.dequant_accumulate_plain
    return fn(qx, sx, spec, n)


def _quant_allreduce_flat(ctx, g, flat, spec: CompressionSpec, use_kernel):
    """The two-stage quantized all-reduce of a float32 flat tensor over
    the group ``g``: the scatter stage (:func:`_quant_scatter`: quantize
    -> all_to_all shards -> dequantize, accumulate over peers, requantize)
    -> all_gather -> dequantize.  Returns (the reduced flat tensor at the
    input length, the stage-2 scales)."""
    requant = spec.dtype == "int8" and not spec.stochastic_rounding
    red = _quant_scatter(ctx, g, flat, spec, use_kernel, requant)
    if requant:
        q2, s2 = red
    else:
        gen = ctx.generator if spec.stochastic_rounding else None
        q2, s2 = quantize_blockwise(red, spec, gen)
    # stage 2: the same bytes on every rank, so the local dequantization
    # cannot diverge across replicas
    qf = all_gather(g, q2.reshape(-1))
    sf = all_gather(g, s2)
    full = dequantize_blockwise(qf.reshape(sf.shape[0], -1), sf, spec)
    return full[:flat.shape[0]], sf


@register("c_quant_allreduce_sum")
def _c_quant_allreduce_sum(ctx, ins, attrs):
    """Per-leaf blockwise-quantized all-reduce (the int8/int4 tiers).
    attrs: ``quant_spec``, optional ``scale`` (the 1/nranks mean)."""
    a = x(ins, "X")
    scale = attrs.get("scale")
    if scale is not None:
        a = a * scale
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    g = _group(ctx, axis)
    spec = CompressionSpec.from_attr(attrs["quant_spec"])
    use_kernel = _quant_route("c_quant_allreduce_sum", ins, attrs, g.world)
    flat, _ = _quant_allreduce_flat(ctx, g, a.reshape(-1).float(), spec,
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
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": _bucket_flat(xs, attrs)[0]}
    g = _group(ctx, axis)
    outs, flat = _bucket_flat(xs, attrs)
    use_kernel = _quant_route("c_fused_quant_allreduce_sum", ins, attrs,
                              g.world)
    red, scales = _reduce_bucket(ctx, g, flat, attrs, use_kernel,
                                 lambda t: all_reduce(g, t))
    return {"Out": _split_like(red, [a.shape for a in outs]),
            "QScale": scales}


# ---------------------------------------------------------------------------
# overlapped gradient buckets (overlap_grad_sync): fired from backward hooks
# ---------------------------------------------------------------------------


class SyncWorker:
    """One communication thread for one process group: it runs the jobs
    handed to it (:meth:`submit`) one at a time in the order they were
    handed over, on a group of its own over the same ranks (gloo pairs
    each rank's collectives on a group by their order, and the backward's
    own collectives — ZeRO-3's gather transposes — run on the run's
    groups in the autograd thread meanwhile) and, on a GPU, on a CUDA
    stream of its own.  :meth:`submit` returns a future whose
    ``result()`` raises the job's failure.

    Over gloo on a GPU a bucket crosses through pinned host buffers, one
    a bucket, kept and reused across steps: the device-to-host copy runs
    on the worker's stream after the bucket's ready event, the thread
    waits for it, gloo reduces the host buffer in place, and the
    host-to-device copy goes back on the worker's stream (its event is
    the bucket's ``done``).  Over NCCL the collective runs on the bucket's
    own flat tensor (``async_op=True``), the worker's stream waiting for
    it."""

    def __init__(self, group: DataParallelGroup, device):
        self.group = group
        self.device = torch.device(device)
        self.stream = torch.cuda.Stream(self.device) \
            if self.device.type == "cuda" else None
        self._staging = {}
        self._pool = ThreadPoolExecutor(
            1, thread_name_prefix=f"grad-sync-rank{group.rank}")

    def submit(self, fn) -> Future:
        return self._pool.submit(self._on_stream, fn)

    def _on_stream(self, fn):
        if self.stream is None:
            return fn()
        with torch.cuda.stream(self.stream):
            return fn()

    def all_reduce(self, key, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` (a tensor of the caller's own) over the
        worker's group, on the worker's thread and stream."""
        import torch.distributed as dist
        g = self.group
        if g.backend == "nccl":
            dist.all_reduce(t, group=g.group, async_op=True).wait()
            return t
        if t.device.type == "cpu":
            dist.all_reduce(t, group=g.group)
            return t
        host = self._staging.get(key)
        if host is None or host.shape != t.shape or host.dtype != t.dtype:
            host = self._staging[key] = torch.empty(
                t.shape, dtype=t.dtype, pin_memory=True)
        host.copy_(t, non_blocking=True)
        copied = torch.cuda.Event()
        copied.record(self.stream)
        copied.synchronize()
        dist.all_reduce(host, group=g.group)
        out = torch.empty_like(t)
        out.copy_(host, non_blocking=True)
        return out


class GradSyncRecord:
    """What one training run's gradient sync did: ``hooked`` (the
    ``_bucket_index`` of each bucket given a backward hook, in the order
    of the hooks in the forward), ``fired`` (those whose hook fired, in
    firing order), ``tail`` (the gradient-sync ops run after the
    backward), and the moments :meth:`exposed_ms` spans: the backward's
    last kernel, and every reduced gradient in hand on the compute stream
    (CUDA events with timing on a GPU, the host clock on the CPU)."""

    __slots__ = ("hooked", "fired", "tail", "backward_end", "synced")

    def __init__(self):
        self.hooked, self.fired = [], []
        self.tail = 0
        self.backward_end = self.synced = None

    @staticmethod
    def _mark(device):
        if device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(device))
        return ev

    def mark_backward_end(self, device):
        self.backward_end = self._mark(device)

    def mark_synced(self, device):
        self.synced = self._mark(device)

    def exposed_ms(self) -> float:
        """Milliseconds from the backward's end to the last reduced
        gradient (waits for the device): the collective time the backward
        did not hide."""
        a, b = self.backward_end, self.synced
        if isinstance(a, float):
            return (b - a) * 1e3
        b.synchronize()
        return a.elapsed_time(b)


class HookedBucket:
    """One ready-order bucket (a ``c_fused_allreduce_sum`` or
    ``c_fused_quant_allreduce_sum`` op with ``_overlap_hook_pos``) of one
    run, fired from the backward: :meth:`fire` (in the autograd thread,
    once every member's cotangent is final) folds the mean scale in,
    concatenates and hands the bucket to the worker of its group;
    :meth:`finish` (after the backward) waits for it and returns the
    op's outputs, the same values the op computes at the tail.  A
    quantized bucket's stochastic rounding draws from a generator of its
    own, seeded ``_bucket_index + 0x0eaf`` (the JAX package's fixed
    per-bucket key: the run's stream cannot be threaded through the
    hook)."""

    def __init__(self, ctx, op, record: GradSyncRecord):
        self.op_type, self.attrs = op.type, op.attrs
        axis = _ring_axis(ctx, op.attrs)
        self.index = int(op.attrs.get("_bucket_index", 0))
        self.worker = ctx.dp.sync_worker(axis, ctx.device)
        self.device = ctx.device
        self.record = record
        self.pending = None
        self.shapes = None
        record.hooked.append(self.index)

    def fire(self, cots):
        with trace_collective(self.op_type, self.attrs, {"X": list(cots)},
                              self.worker.group, path="sync_worker"):
            self._fire(cots)

    def _fire(self, cots):
        self.record.fired.append(self.index)
        outs, flat = _bucket_flat(list(cots), self.attrs)
        self.shapes = [a.shape for a in outs]
        use_kernel = False
        if self.op_type == "c_fused_quant_allreduce_sum":
            use_kernel = _quant_route(self.op_type, {"X": list(cots)},
                                      self.attrs, self.worker.group.world)
        ready = None
        if self.device.type == "cuda":
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(self.device))
            flat.record_stream(self.worker.stream)
        self.pending = self.worker.submit(
            lambda: self._reduce(flat, ready, use_kernel))

    def _reduce(self, flat, ready, use_kernel):
        """On the worker's thread and stream."""
        w = self.worker
        if ready is not None:
            w.stream.wait_event(ready)
        gen = None
        spec = self.attrs.get("quant_spec")
        if spec is not None and \
                CompressionSpec.from_attr(spec).stochastic_rounding:
            gen = torch.Generator(device=self.device)
            gen.manual_seed(self.index + 0x0eaf)
        hctx = LoweringContext(gen, self.device, dp=w.group)
        red, scales = _reduce_bucket(
            hctx, w.group, flat, self.attrs, use_kernel,
            lambda t: w.all_reduce(self.index, t))
        done = None
        if w.stream is not None:
            done = torch.cuda.Event()
            done.record(w.stream)
        return red, scales, done

    def finish(self):
        """The op's outputs, once the worker has the reduced bucket (its
        failure raised here); on a GPU the compute stream waits for it."""
        red, scales, done = self.pending.result()
        if done is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(done)
            for t in (red, scales):
                if t is not None:
                    t.record_stream(cur)
        outs = {"Out": _split_like(red, self.shapes)}
        if scales is not None:
            outs["QScale"] = scales
        return outs


def _axes_tuple(axis):
    return axis if isinstance(axis, tuple) else (axis,)


# ---------------------------------------------------------------------------
# collective spans (observability/tracing.py)
# ---------------------------------------------------------------------------


def _axis_sizes(dp) -> dict:
    if dp is None:
        return {}
    out = {}
    for a in dp.axis_names:
        if isinstance(a, tuple):
            continue
        try:
            out[str(a)] = int(dp.over(a).world)
        except ValueError:
            pass
    return out


def trace_collective(op_type, attrs, ins, dp, path=None):
    """A ``collective::<kind>`` span over one collective's dispatch when
    tracing is on, else a null context: kind, axis, the backend (``gloo``
    or ``nccl``; ``path`` ``"sync_worker"`` for an overlapped bucket fired
    from the backward), a ready-order bucket's ``bucket_index`` /
    ``ready_rank`` / ``overlap`` and, where the op spec's ``wire``
    channel prices it, the logical and wire bytes (also counted on the
    ``collective_traced_wire_bytes{kind}`` counter).  The JAX package
    opens it at trace time, once a compile; the port runs eagerly, so it
    opens once a run.  Host time: the device time of the collective
    lands in whatever waits for it."""
    from ..observability import tracing
    from .registry import OP_SPECS
    spec = OP_SPECS.get(op_type)
    if not tracing.is_enabled() or spec is None or not spec.collective:
        return contextlib.nullcontext()
    from ..observability import metrics
    from .op_specs import VarSig
    a = {"kind": op_type,
         "axis": str(attrs.get("_axis_name") or attrs.get("ring_id", 0))}
    if dp is not None:
        a["backend"] = dp.backend
    if path is not None:
        a["path"] = path
    if "_bucket_index" in attrs:
        a["bucket_index"] = int(attrs["_bucket_index"])
    if "_ready_rank" in attrs:
        a["ready_rank"] = int(attrs["_ready_rank"])
    if "_overlap" in attrs:
        a["overlap"] = bool(attrs["_overlap"])
    wire_fn = getattr(spec, "wire", None)
    if wire_fn is not None:
        try:
            sigs = {slot: [VarSig(tuple(v.shape), str(v.dtype).replace(
                "torch.", "")) if hasattr(v, "shape") else None
                for v in vals] for slot, vals in ins.items()}
            priced = wire_fn(sigs, attrs, _axis_sizes(dp))
        except Exception:       # pricing must not break tracing
            priced = None
        if priced is not None:
            logical, wire = priced
            a["logical_bytes"] = int(logical)
            a["wire_bytes"] = int(wire)
            metrics.counter("collective_traced_wire_bytes",
                            kind=op_type).add(int(wire))
    return tracing.Span(f"collective::{op_type}", a)


def _scatter_groups(ctx, axis):
    """(the group a ZeRO scatter rides: the first of its axes, the group
    of the rest or None) — the JAX ops ``psum`` over the rest before the
    scatter."""
    axes = _axes_tuple(axis)
    rest = axes[1:]
    return _group(ctx, axes[0]), (_group(ctx, rest) if rest else None)


@register("zero_reduce_scatter")
def _zero_reduce_scatter(ctx, ins, attrs):
    """Gradient half of the ZeRO-1 sharded update: this rank's 1/n flat
    shard of the summed gradient (padded to ``n·align``, n the size of
    the first axis; with several axes the rest are all-reduced first).
    ``scale`` folds the mean; ``compress_dtype`` runs the scatter and its
    sum at bf16."""
    g = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    scale = attrs.get("scale")
    if scale is not None:
        g = g * scale
    if axis is None:
        return {"Out": g.reshape(-1)}
    scatter, rest = _scatter_groups(ctx, axis)
    n = scatter.world
    # the flat layout: a multiple of n·align (align > 1 makes every shard
    # whole quantization blocks, matching zero_shard_slice's)
    flat = pad_to_blocks(g.reshape(-1), n * attrs.get("align", 1))
    comp = attrs.get("compress_dtype")
    orig = flat.dtype
    if comp and flat.is_floating_point():
        flat = flat.to({"bfloat16": torch.bfloat16, "bf16": torch.bfloat16,
                        "float16": torch.float16}[str(comp)])
    if rest is not None:
        flat = all_reduce(rest, flat)
    out = _peer_sum(all_to_all(scatter, flat.reshape(n, -1)))
    return {"Out": out.to(orig)}


@register("quant_reduce_scatter")
def _quant_reduce_scatter(ctx, ins, attrs):
    """Quantized gradient half of ZeRO-1: quantize -> ``all_to_all`` (each
    rank receives every peer's quantized copy of its shard, at wire width)
    -> the receive stage (#11: dequantize and accumulate in float32), over
    the first axis, after a float32 all-reduce over the rest.  The output
    is the rank's reduced float32 flat shard; the pad is
    ``n·block_size``, so ``zero_shard_slice`` must get the same
    ``align``.  Stochastic rounding draws from the rank's generator."""
    g = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    scale = attrs.get("scale")
    if scale is not None:
        g = g * scale
    spec = CompressionSpec.from_attr(attrs["quant_spec"])
    if axis is None:
        return {"Out": g.reshape(-1)}
    scatter, rest = _scatter_groups(ctx, axis)
    flat = pad_to_blocks(g.reshape(-1).float(),
                         scatter.world * spec.block_size)
    if rest is not None:
        flat = all_reduce(rest, flat)
    use_kernel = _quant_route("quant_reduce_scatter", ins, attrs,
                              scatter.world)
    return {"Out": _quant_scatter(ctx, scatter, flat, spec,
                                  use_kernel).to(g.dtype)}


@register("zero_shard_slice")
def _zero_shard_slice(ctx, ins, attrs):
    """This rank's flat 1/n shard of a replicated tensor (padded to
    ``n·align``; n and the rank's index from the first axis): the
    parameter slice the sharded update owns.  No communication."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a.reshape(-1)}
    g = _group(ctx, _axes_tuple(axis)[0])
    n = g.world
    flat = pad_to_blocks(a.reshape(-1), n * attrs.get("align", 1))
    shard = flat.shape[0] // n
    # a tensor of its own: the update writes it in place, and must not
    # write through into the replicated parameter it was cut from
    return {"Out": flat[g.rank * shard:(g.rank + 1) * shard].clone()}


@register("zero_all_gather")
def _zero_all_gather(ctx, ins, attrs):
    """The full replicated tensor from every rank's updated shard over the
    first axis, the flat pad dropped (``numel``, ``shape``)."""
    sh = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    shape = tuple(attrs["shape"])
    numel = int(attrs["numel"])
    full = sh if axis is None else \
        all_gather(_group(ctx, _axes_tuple(axis)[0]), sh)
    return {"Out": full[:numel].reshape(shape)}


class _FsdpGather(torch.autograd.Function):
    """all_gather along ``dim`` over the group forward; backward, each
    rank's slice of the cotangent summed over the group (the
    reduce-scatter that is the gather's transpose).  Every rank runs the
    same backward graph, so the collectives of the backward issue in the
    same order on every rank."""

    @staticmethod
    def forward(ctx, a, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(group, a, dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        parts = torch.stack(grad.chunk(g.world, dim=ctx.dim))
        return _peer_sum(all_to_all(g, parts)), None, None


@register("fsdp_all_gather")
def _fsdp_all_gather(ctx, ins, attrs):
    """ZeRO-3's gather at a parameter's first forward use
    (framework/fsdp.py): the full tensor from the resident shards along
    ``gather_dim`` over its axis (``fsdp``; inside an HSDP grid, the
    rank's fsdp line).  Its backward delivers each rank the gradient of
    its shard summed over that line.  The identity without a process
    group."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    dim = attrs.get("gather_dim", 0)
    if dim < 0:
        dim += a.dim()
    return {"Out": _FsdpGather.apply(a, _group(ctx, axis), dim)}


@register("c_broadcast")
def _c_broadcast(ctx, ins, attrs):
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    return {"Out": broadcast(_group(ctx, axis), a, attrs.get("root", 0))}


class _Gather(torch.autograd.Function):
    """all_gather along ``dim`` over the group forward; backward, the
    rank's slice of the cotangent.  The gathered value is replicated over
    the group, so each rank holds the whole cotangent and its slice is the
    one-device gradient of its part (the JAX transpose, ``psum_scatter``
    of a replicated cotangent, sums it over the group instead)."""

    @staticmethod
    def forward(ctx, a, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(group, a, dim)

    @staticmethod
    def backward(ctx, grad):
        g = ctx.group
        return grad.chunk(g.world, dim=ctx.dim)[g.rank].contiguous(), \
            None, None


class _Split(torch.autograd.Function):
    """The rank's slice of dim 0 forward; the slices gathered backward."""

    @staticmethod
    def forward(ctx, a, group):
        ctx.group = group
        piece = a.shape[0] // group.world
        return a[group.rank * piece:(group.rank + 1) * piece].clone()

    @staticmethod
    def backward(ctx, grad):
        return all_gather(ctx.group, grad, 0), None


class SumOverGroup(torch.autograd.Function):
    """Summed over the group forward; the cotangent passes through (the
    Megatron g, ``mp_allreduce_sum``, and the reduce inside
    ``c_embedding``: each rank's partial owns its part of the gradient)."""

    @staticmethod
    def forward(ctx, a, group):
        return all_reduce(group, a)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class CopyToGroup(torch.autograd.Function):
    """Identity forward; the cotangent summed over the group backward (the
    Megatron f, ``mp_copy``)."""

    @staticmethod
    def forward(ctx, a, group):
        ctx.group = group
        return a.view_as(a)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(ctx.group, grad), None


def ring_shift(g: DataParallelGroup, t: torch.Tensor, shift: int = 1
               ) -> torch.Tensor:
    """Member i's ``t`` arrives at member (i + shift) mod n: one batch of
    point-to-point pairs (the send to the member ahead, the receive from
    the one behind) between the group's global ranks."""
    import torch.distributed as dist
    n = g.world
    shift %= n
    if shift == 0:
        return t
    w = _on_wire(g, t)
    out = torch.empty_like(w)
    dst = g.global_rank((g.rank + shift) % n)
    src = g.global_rank((g.rank - shift) % n)
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, w, dst, group=g.group),
        dist.P2POp(dist.irecv, out, src, group=g.group)])
    for req in reqs:
        req.wait()
    return out.to(t.device)


class RingShift(torch.autograd.Function):
    """:func:`ring_shift` with a gradient: the cotangent shifts the other
    way.  Every rank of the group runs the same backward graph, so the
    backward's pairs issue in the same order on every rank."""

    @staticmethod
    def forward(ctx, a, group, shift):
        ctx.group, ctx.shift = group, shift
        return ring_shift(group, a, shift)

    @staticmethod
    def backward(ctx, grad):
        return ring_shift(ctx.group, grad.contiguous(), -ctx.shift), None, \
            None


@register("c_allgather")
@register("c_concat")
def _c_allgather(ctx, ins, attrs):
    """Every rank's X concatenated along ``gather_dim`` (dim 0 unless
    given) over the group, differentiable (:class:`_Gather`); the
    identity without a group."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    dim = attrs.get("gather_dim", 0)
    return {"Out": _Gather.apply(a, _group(ctx, axis),
                                 dim if dim >= 0 else dim + a.dim())}


@register("c_split")
def _c_split(ctx, ins, attrs):
    """This rank's 1/n slice of dim 0 over the group (its gradient
    gathers)."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    return {"Out": _Split.apply(a, _group(ctx, axis))}


@register("c_embedding")
def _c_embedding(ctx, ins, attrs):
    """Vocab-sharded embedding lookup (model parallel): the ids in this
    rank's rows (``per_shard_rows`` from its index in the group, else
    ``start_index``) looked up, the rest zero, summed over the group; the
    gradient of W scatters into this rank's rows only."""
    w, ids = x(ins, "W"), x(ins, "Ids")
    axis = _ring_axis(ctx, attrs)
    g = _group(ctx, axis) if axis is not None else None
    if "per_shard_rows" in attrs and g is not None:
        start = g.rank * int(attrs["per_shard_rows"])
    else:
        start = int(attrs.get("start_index", 0))
    local = ids.to(torch.int64) - start
    valid = (local >= 0) & (local < w.shape[0])
    out = torch.nn.functional.embedding(
        torch.clamp(local, 0, w.shape[0] - 1), w)
    out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                         device=out.device))
    if g is not None:
        out = SumOverGroup.apply(out, g)
    return {"Out": out}


@register("collective_permute")
def _collective_permute(ctx, ins, attrs):
    """Ring shift over the group by ``shift`` (used by sequence
    parallelism), differentiable (:class:`RingShift`)."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    return {"Out": RingShift.apply(a.contiguous(), _group(ctx, axis),
                                   int(attrs.get("shift", 1)))}


@register("c_reducescatter")
def _c_reducescatter(ctx, ins, attrs):
    """Rank r's 1/n slice (dim 0) of the sum: every rank's slice r moves
    to rank r, which adds them in peer order."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    g = _group(ctx, axis)
    n = g.world
    parts = a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))
    return {"Out": _peer_sum(all_to_all(g, parts))}


@register("alltoall")
def _alltoall(ctx, ins, attrs):
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    g = _group(ctx, axis)
    n = g.world
    parts = a.reshape((n, a.shape[0] // n) + tuple(a.shape[1:]))
    return {"Out": all_to_all(g, parts).reshape(a.shape)}


@register("c_identity")
@register("c_sync_calc_stream")
@register("c_sync_comm_stream")
def _c_identity(ctx, ins, attrs):
    # one stream per rank: collectives and compute are already ordered
    return {"Out": x(ins, "X")}


@register("local_sgd_sync")
def _local_sgd_sync(ctx, ins, attrs):
    """k-periodic parameter averaging for LocalSGD (ref:
    transpiler/collective.py:270 LocalSGD, localsgd_optimizer.py): on a
    step where ``Step % k_steps == 0`` and ``Step >= begin_step`` every
    parameter becomes its mean over the group (one flat all-reduce per
    dtype), else it passes through.  The identity without a process
    group.  The step is read on the host (``ctx.read_predicate``), once
    a run.  An ``_axis_name`` the run does not have falls back to its one
    axis, as in the JAX package; with several axes it is refused, since
    guessing could average tensor-parallel shards, not replicas."""
    params = list(ins.get("Params", []))
    axis = _ring_axis(ctx, attrs)
    if axis is None and ctx.axis_names:
        if len(ctx.axis_names) == 1:
            axis = ctx.axis_names[0]
        else:
            raise ValueError(
                f"local_sgd_sync: configured axis "
                f"{attrs.get('_axis_name')!r} is not in the mesh axes "
                f"{ctx.axis_names}; pass axis_name=<your data axis> to "
                f"LocalSGDOptimizer")
    if axis is None or not params:
        return {"Out": params}
    g = _group(ctx, axis)
    step = x(ins, "Step").reshape(()).to(torch.float32)
    k = float(attrs.get("k_steps", 1))
    begin = float(attrs.get("begin_step", 1))
    if not ctx.read_predicate((torch.remainder(step, k) == 0.0) &
                              (step >= begin)):
        return {"Out": params}
    outs = list(params)
    for dtype in dict.fromkeys(p.dtype for p in params):
        idx = [i for i, p in enumerate(params) if p.dtype == dtype]
        group = [params[i] for i in idx]
        flat = all_reduce(g, torch.cat([p.reshape(-1) for p in group]))
        flat = flat / g.world
        for i, avg in zip(idx, _split_like(flat, [p.shape for p in group])):
            if ctx.donate_state:
                outs[i] = params[i].copy_(avg)    # keeps its storage
            else:
                outs[i] = avg
    return {"Out": outs}


def _noop(ctx, ins, attrs):
    return {}


@register("pipe_stage_boundary")
def _pipe_stage_boundary(ctx, ins, attrs):
    """A pipeline stage cut (``framework/pipe.apply_pipeline``): the
    identity on the live tensors crossing it.  Run in program order (one
    pipe rank, or the microbatched lowering) it changes nothing; the
    pipelined lowering partitions the forward at these markers and sends
    the crossing tensors between the pipe ranks itself."""
    return {"Out": list(ins.get("X", []))}


for _name in ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id", "barrier"):
    register(_name)(_noop)


# ---------------------------------------------------------------------------
# sharded persistables: the block-per-rank rule
# ---------------------------------------------------------------------------


def _sharding(dp: Optional[DataParallelGroup], var):
    """(the dim ``var``'s ``dist_attr`` shards over the run's axes, the
    group over that dim's axes), or None (no group, no such var, or
    replicated over every axis of the run).  The rank's block is its
    index in that group; the other axes hold the block replicated."""
    da = getattr(var, "dist_attr", None) if var is not None else None
    if dp is None or not da:
        return None
    from ..framework.mesh_layout import _flat_axes
    names = dp.axis_names
    for d, entry in enumerate(da):
        axes = tuple(a for a in _flat_axes((entry,)) if a in names)
        if axes:
            return d, dp.over(axes)
    return None


def shard_dim(dp: Optional[DataParallelGroup], var) -> Optional[int]:
    """The dim of ``var`` its ``dist_attr`` shards over the run's axes, or
    None (no group, no such var, or replicated over the run's axes)."""
    sh = _sharding(dp, var)
    return None if sh is None else sh[0]


def run_groups(program) -> Optional[DataParallelGroup]:
    """The groups ``program`` runs over: the ones ``CompiledProgram.
    with_mesh`` recorded on it, else those of its mesh layout when that
    has several axes (built here: a collective), else None."""
    groups = getattr(program, "_run_groups", None)
    if groups is not None:
        return groups
    from ..framework.mesh_layout import MeshLayout
    layout = getattr(program, "_mesh_layout", None)
    if isinstance(layout, MeshLayout) and len(layout.mesh_axes) > 1:
        return MeshGroups.of(layout.build_mesh(), layout.batch_axes)
    return None


def sharded_group(program) -> Optional[DataParallelGroup]:
    """The groups ``program``'s sharded persistables live over: the run's
    (:func:`run_groups`) when a persistable's ``dist_attr`` names one of
    their axes, else the group over the first axis a persistable's
    ``dist_attr`` names (an axis of size 1 in the program's mesh layout
    does not count); None when no persistable is sharded or there is no
    group of more than one rank.  A program of replicated persistables
    only (plain data parallelism) has none: each rank holds the whole of
    every value."""
    from ..framework.mesh_layout import MeshLayout, _flat_axes
    sharded = [v for v in program.list_vars()
               if v.persistable and getattr(v, "dist_attr", None)]
    groups = run_groups(program) if sharded else None
    if groups is not None:
        return groups if any(_sharding(groups, v) for v in sharded) \
            else None
    layout = getattr(program, "_mesh_layout", None)
    if not isinstance(layout, MeshLayout):
        layout = None
    for v in sharded:
        for axis in _flat_axes(tuple(v.dist_attr)):
            if layout is not None and layout.size(axis) < 2:
                continue
            return DataParallelGroup.current(axis)
    return None


def _block_rows(g, var, d):
    full = int(var.shape[d])
    if full <= 0 or full % g.world:
        from ..framework.errors import InvalidArgumentError
        raise InvalidArgumentError(
            f"sharded persistable {var.name!r}: dim {d} of {full} does not "
            f"divide into {g.world} ranks")
    return full, full // g.world


def block_of(dp: Optional[DataParallelGroup], var, value):
    """This rank's block of a sharded persistable: the global value (the
    startup program's, a loaded checkpoint's) is cut to the rank's rows of
    its shard dim — its index in the group of that dim's axes — in a
    tensor of its own; a block passes through.  Any other value (a
    replicated var, no group) passes through."""
    sh = _sharding(dp, var)
    if sh is None or not isinstance(value, torch.Tensor):
        return value
    d, g = sh
    full, rows = _block_rows(g, var, d)
    got = int(value.shape[d])
    if got == rows:
        return value
    if got != full:
        from ..framework.errors import InvalidArgumentError
        raise InvalidArgumentError(
            f"sharded persistable {var.name!r}: dim {d} is {got}, neither "
            f"the global {full} nor a block of {rows}")
    return value.narrow(d, g.rank * rows, rows).clone()


def whole_of(dp: Optional[DataParallelGroup], var, value):
    """The global value of a sharded persistable from this rank's block
    (the blocks gathered along the shard dim over the group of its axes,
    a collective: every rank calls it); a global value or a replicated one
    passes through."""
    sh = _sharding(dp, var)
    if sh is None or not isinstance(value, torch.Tensor):
        return value
    d, g = sh
    full, _ = _block_rows(g, var, d)
    if int(value.shape[d]) == full:
        return value
    return all_gather(g, value, d)


def merge_fetch(dp: Optional[DataParallelGroup], value, replicated: bool,
                var=None):
    """A fetched value under data parallelism (ref: the reference's
    FetchOpHandle, the JAX package's ``_merge_fetch``): a sharded
    persistable (``var``) comes back whole (:func:`whole_of`); replicated
    values (persistables, everything written from the backward op on)
    pass through, and so does everything when batches are not split;
    over the group they split over, a float scalar is averaged, an
    integer scalar summed, and any other tensor is batch-sharded and
    all-gathered along dim 0.  Over a sequence axis first: a value of one
    element (a scalar or (1,): a per-shard loss, a count) is averaged if
    a float and summed if an integer, and a tensor of two dims or more
    gathered along dim 1 (the sequence); a 1-D value of more elements
    raises, as nothing says how its shards merge (the JAX package
    returns each shard's own)."""
    if shard_dim(dp, var) is not None:
        return whole_of(dp, var, value)
    if dp is None or replicated or not isinstance(value, torch.Tensor):
        return value
    sg = dp.seq_group()
    if sg is not None:
        if value.dim() >= 2:
            value = all_gather(sg, value, 1)
        elif value.numel() == 1:
            value = all_reduce(sg, value)
            if value.is_floating_point():
                value = value / sg.world
        else:
            raise UnimplementedError(
                f"fetching a value of shape {tuple(value.shape)} over the "
                f"sequence axis {dp.seq_axis!r}: a 1-D value of more than "
                f"one element is neither a per-shard scalar nor [B, S, "
                f"...], and its shards' merge (sum, mean or none) is not "
                f"known; fetch a scalar or a [B, S, ...] tensor")
    g = dp.batch_group()
    if g is None:
        return value
    if value.dim() == 0:
        if value.is_floating_point():
            return all_reduce(g, value) / g.world
        return all_reduce(g, value)
    return all_gather(g, value)


def _feed_spec(dp: DataParallelGroup, name: str):
    """The groups each dim of feed ``name`` splits over: its
    ``feed_specs`` entry (axes the run lacks dropped), else dim 0 over the
    batch axes (the JAX feed spec ``P(batch_axes)``)."""
    spec = dp.feed_specs.get(name)
    if spec is None:
        g = dp.batch_group()
        return [g] if g is not None else []
    from ..framework.mesh_layout import _flat_axes
    out = []
    for entry in tuple(spec):
        axes = tuple(a for a in _flat_axes((entry,)) if a in dp.axis_names)
        out.append(dp.over(axes) if axes else None)
    return out


def slice_feed(dp: Optional[DataParallelGroup], name: str, value):
    """This rank's part of a fed global array: each dim split into as many
    equal parts as the ranks of the axes its spec names, the rank's flat
    index over them picking its part — by default dim 0 over the batch
    axes; ``feed_specs`` (sequence parallelism) adds dim 1 over the
    sequence axis."""
    groups = _feed_spec(dp, name) if dp is not None else []
    if not any(g is not None for g in groups):
        return value
    if not isinstance(value, torch.Tensor):
        value = np.asarray(value)
    shape = tuple(value.shape)
    if not shape:
        return value
    from ..framework.errors import InvalidArgumentError
    for d, g in enumerate(groups[:len(shape)]):
        if g is None:
            continue
        if shape[d] % g.world:
            what = "the leading dim" if d == 0 else f"dim {d} of"
            raise InvalidArgumentError(
                f"feed {name!r}: {what} {shape[d]} does not divide into "
                f"{g.world} ranks of {g.axis_name!r}")
        n = shape[d] // g.world
        index = [slice(None)] * len(shape)
        index[d] = slice(g.rank * n, (g.rank + 1) * n)
        value = value[tuple(index)]
    return value
