"""CompiledProgram — the port of paddle_tpu/framework/compiler.py (ref:
python/paddle/fluid/compiler.py:87 CompiledProgram, :160
with_data_parallel).

Data parallelism is one process per rank (``python -m
paddle_tpu_torch.distributed.launch --nproc N``, then
``distributed.fleet``): inside a ``torch.distributed`` process group of
more than one rank, ``with_data_parallel`` inserts the gradient sync
after the ``backward`` op (:func:`insert_grad_sync`, the JAX package's
rewrite: per-leaf ``scale`` + ``c_allreduce_sum``, or bucketed
``c_fused_allreduce_sum`` with the 1/nranks mean folded in; the bf16 cast
tier or the blockwise-quantized int8/int4 tiers on request) and records
the group, so the executor hands each rank its rows of a fed batch and
merges fetches across ranks.  Outside a group it inserts nothing.

``fuse_elewise_add_act_ops`` defers ``fuse_elemwise_add_act`` to the first
run, where the fetch list is known, so a fetched intermediate is never
fused away.  The passes run on a clone of the program per fetch list
(:meth:`CompiledProgram._variant_for`, an LRU of 8 clones), and the
executor runs the clone against the same scope.

``with_mesh`` takes the port's mesh (``MeshLayout.build_mesh()``: the
named axes over the process group) of the ``dp`` and ``fsdp`` axes —
data parallelism, ZeRO-3 after ``framework.fsdp.apply_fsdp_sharding``,
and HSDP (both) — and of the ``tp`` and ``sp`` axes beside them
(Megatron tensor parallelism from the parameters' ``dist_attr``, ring
attention over ``seq_axis``; fsdp beside any two of dp, tp and sp),
slices the feeds over the batch axes (and by ``feed_specs``: dim 1 over
the sequence axis) and inserts the gradient sync over the batch and
sequence axes (a parameter stamped over an axis is reduced over the
others only: its gradient arrives reduce-scattered over that one, or is
local to its tensor-parallel block).  It takes the
pipe axis ``pp`` beside the data axis too (a program
``framework.pipe.apply_pipeline`` cut into stages: the executor walks
its schedule over the pp group, and ``insert_pipe_grad_sync`` sums the
gradients over pp), and the expert axis ``ep`` beside the data and fsdp
axes (a program ``parallel.apply_expert_sharding`` stamped: ``ep`` is a
batch axis, and an expert weight's gradient, summed over the ranks'
tokens by the exchange's backward, is scaled by 1/n and reduced over the
other batch axes only).  pp beside fsdp, tp or sp, ep beside tp, sp or
pp, and several places in one process raise: one process drives one
device.  With ``overlap_grad_sync``
the buckets are cut in gradient ready order and marked for the
executor's backward hooks (:func:`insert_grad_sync`).  With
``flag("hbm_budget_gb")`` set, ``with_mesh`` holds the program's static
per-rank peak estimate (``memory_analysis.check_hbm_budget``) to the
budget before anything runs.  The JAX package's other static checks of
a variant (``verify_programs``, ``aot_cache_dir``) belong to modules the
port does not have yet, and it has none of those flags."""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from .core import Program, grad_var_name
from .errors import UnimplementedError
from .mesh_layout import _flat_axes
from .passes import apply_pass

_ONE_PROCESS_PER_RANK = (
    "one process drives one device, and data parallelism is one process "
    "per rank: launch the script with `python -m "
    "paddle_tpu_torch.distributed.launch --nproc N` and train through "
    "`paddle_tpu_torch.distributed.fleet`")


class BuildStrategy:
    """ref: details/build_strategy.h — the JAX package's fields.  The
    gradient-sync fields (``fuse_all_reduce_ops``,
    ``fuse_grad_size_in_MB``, ``allreduce_compress_dtype``,
    ``allreduce_quant_spec``, ``gradient_scale_strategy``,
    ``overlap_grad_sync`` with ``overlap_bucket_size_in_MB`` and
    ``overlap_min_buckets``) shape :func:`insert_grad_sync` inside a
    process group."""

    class ReduceStrategy:
        AllReduce = 0
        Reduce = 1

    class GradientScaleStrategy:
        CoeffNumDevice = 0
        One = 1
        Customized = 2

    def __init__(self):
        self.reduce_strategy = BuildStrategy.ReduceStrategy.AllReduce
        self.gradient_scale_strategy = \
            BuildStrategy.GradientScaleStrategy.CoeffNumDevice
        self.fuse_all_reduce_ops = False
        self.fuse_grad_size_in_MB = 32
        self.allreduce_compress_dtype = None
        self.allreduce_quant_spec = None
        self.overlap_grad_sync = False
        self.overlap_bucket_size_in_MB = 4
        self.overlap_min_buckets = 4
        # off by default like the reference (build_strategy.h)
        self.fuse_elewise_add_act_ops = False
        self.enable_inplace = True
        self.memory_optimize = True
        self.num_trainers = 1
        self.trainer_id = 0


class ExecutionStrategy:
    """ref: details/execution_strategy.h — kept for API parity; the port
    runs the ops of a step in program order on one stream."""

    def __init__(self):
        self.num_threads = 1
        self.num_iteration_per_drop_scope = 1
        self.use_experimental_executor = False


class CompiledProgram:
    #: retained pass-variant clones (one per fetch list)
    _VARIANT_CAP = 8

    def __init__(self, program: Program):
        self._program = program
        self._loss_name = None
        self._pending_passes = []
        self._pass_variants: "OrderedDict[tuple, Program]" = OrderedDict()
        # the process group the run reduces over (None: one rank), and the
        # layout the budget gate prices a rank by ({axis: size}, the batch
        # and sequence axes, the feed specs)
        self._dp = None
        self._mesh_axes = {}
        self._batch_axis = None
        self._seq_axis = None
        self._feed_specs = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, mesh=None, axis_name: str = "dp"):
        """Data parallelism over this process's ``torch.distributed``
        group: with more than one rank and a ``loss_name``, the gradient
        sync is inserted for ``nranks`` = the world size.  More than one
        place, or a mesh (``with_mesh`` takes the port's), raises."""
        if mesh is not None:
            raise UnimplementedError(
                f"CompiledProgram.with_data_parallel(mesh=...): pass the "
                f"port's mesh to with_mesh; {_ONE_PROCESS_PER_RANK}")
        if places is not None and len(places) > 1:
            raise UnimplementedError(
                f"CompiledProgram.with_data_parallel over {len(places)} "
                f"places: {_ONE_PROCESS_PER_RANK}")
        strategy = build_strategy or BuildStrategy()
        from ..ops.collective_ops import DataParallelGroup
        dp = DataParallelGroup.current(axis_name)
        if dp is not None and loss_name is not None:
            insert_grad_sync(self._program, strategy, dp.world,
                             (axis_name,), axis_sizes={axis_name: dp.world})
        self._dp = dp
        if dp is not None:
            self._mesh_axes = {axis_name: dp.world}
            self._batch_axis = axis_name
        self._loss_name = loss_name
        if strategy.fuse_elewise_add_act_ops:
            # ref: build_strategy.cc:51 runs fuse_elewise_add_act_pass in
            # the training pipeline
            self._pending_passes.append("fuse_elemwise_add_act")
        return self

    def with_mesh(self, mesh, loss_name: Optional[str] = None,
                  batch_axis="dp", seq_axis: Optional[str] = None,
                  feed_specs=None,
                  build_strategy: Optional[BuildStrategy] = None):
        """Compile for the port's mesh (``MeshLayout.build_mesh()``, a
        ``ProcessMesh`` over the process group) — the JAX package's
        ``with_mesh`` for ``MeshLayout(data=n)``, ``MeshLayout(fsdp=n)``
        after ``apply_fsdp_sharding`` (ZeRO-3), both (HSDP), and tp and
        sp beside them, fsdp beside any two of data, tp and sp (tensor
        parallelism from the parameters' ``dist_attr``, ZeRO-3 over what
        they leave; ``seq_axis`` the axis ring attention runs over),
        data x pp (a
        pipelined program), and data x fsdp x ep (expert parallelism
        after ``parallel.apply_expert_sharding``).  Feeds split on
        dim 0 over ``batch_axis`` (the layout's ``batch_axes``) by the
        rank's flat index over them, or by their entry in ``feed_specs``
        (one entry a dim: ``("dp", "sp")`` splits dim 1 over the sequence
        axis too; axes the mesh lacks are dropped); with a ``loss_name``
        the gradient sync is inserted over the batch and sequence axes of
        size above 1, each parameter's stamped axes left out (an
        fsdp-stamped parameter's gradient is summed over fsdp by the
        gather's transpose and reduced over ``dp`` only; a tp-stamped
        one's is its block's own; an ep-stamped expert weight's is summed
        over ep by the expert exchange's backward, scaled by 1/n and
        reduced over the other batch axes).  A ``seq_axis`` the mesh
        lacks is dropped, as in the JAX package.  The mesh must have as
        many ranks as the process group (``ValueError``); an axis the
        port has not, or one beside an axis it does not run beside
        (``mesh_layout.check_ported_axes``), and any other mesh object
        raise.  A ``pp`` axis runs a pipelined program over its line of
        ranks (not a batch axis: the pipe ranks of a data row see the
        same rows); an ``ep`` axis (``MeshLayout(data=n, expert=m)``,
        ``MeshLayout(fsdp=n, expert=m)``) is a batch axis, over which
        the ``c_expert_alltoall`` ops exchange the routed tokens."""
        if mesh is None:
            self._dp = None
            self._loss_name = loss_name
            return self
        from .mesh_layout import ProcessMesh, check_ported_axes
        if not isinstance(mesh, ProcessMesh):
            raise UnimplementedError(
                f"CompiledProgram.with_mesh: {mesh!r} is not the port's mesh "
                f"(MeshLayout.build_mesh()); {_ONE_PROCESS_PER_RANK}")
        sizes = dict(mesh.shape)
        check_ported_axes(sizes, "CompiledProgram.with_mesh")
        strategy = build_strategy or BuildStrategy()
        from ..ops.collective_ops import DataParallelGroup, MeshGroups
        batch_axes = tuple(a for a in _flat_axes(batch_axis)
                           if a in mesh.axis_names)
        seq_axis = seq_axis if seq_axis and seq_axis in mesh.axis_names \
            else None
        batch_real = tuple(a for a in batch_axes if sizes.get(a, 1) > 1)
        # grads are partial over the batch axes AND the sequence axis (the
        # loss tokens are sharded on both): reduce over every such axis
        reduce_axes = batch_real + tuple(
            a for a in (seq_axis,) if a and sizes.get(a, 1) > 1
            and a not in batch_real)
        real = [a for a in mesh.axis_names if sizes.get(a, 1) > 1]
        if len(real) > 1:
            dp = MeshGroups.of(mesh, batch_real)
        else:
            dp = DataParallelGroup.current(real[0] if real
                                           else mesh.axis_names[0])
            if dp is not None:
                dp.batch_sharded = dp.axis_name in batch_real
        if dp is not None:
            dp.seq_axis = seq_axis
            dp.feed_specs = {str(k): tuple(v) for k, v in
                             dict(feed_specs or {}).items()}
        world = dp.world if dp is not None else 1
        if world != mesh.size:
            raise ValueError(
                f"CompiledProgram.with_mesh: the mesh {sizes} needs "
                f"{mesh.size} ranks, the process group has {world}")
        if loss_name is not None and reduce_axes:
            n = int(np.prod([sizes[a] for a in reduce_axes]))
            insert_grad_sync(self._program, strategy, n, reduce_axes,
                             axis_sizes=sizes)
        self._dp = dp
        self._mesh_axes = dict(sizes)
        self._batch_axis = batch_axes if len(batch_axes) != 1 \
            else batch_axes[0]
        self._seq_axis = seq_axis
        self._feed_specs = {str(k): tuple(v) for k, v in
                            dict(feed_specs or {}).items()} or None
        from ..flags import flag
        if flag("hbm_budget_gb"):
            # the budget gate before any launch: declared feed shapes
            # (−1 read as 1, a lower bound); Executor.prepare / run
            # re-gate at the feeds' shapes
            from .memory_analysis import check_hbm_budget
            check_hbm_budget(
                self._program,
                fetch_names=[loss_name] if loss_name else [],
                mesh_axes=self._mesh_axes, batch_axis=self._batch_axis,
                seq_axis=seq_axis, feed_specs=self._feed_specs)
        # io reads the groups a checkpoint's blocks live over from here
        self._program._run_groups = dp
        self._loss_name = loss_name
        if strategy.fuse_elewise_add_act_ops:
            self._pending_passes.append("fuse_elemwise_add_act")
        return self

    def _variant_for(self, fetch_names) -> Program:
        """The pass-rewritten clone of the program for this fetch list
        (the program itself when no pass is pending).  Fetched
        intermediates survive the passes, and the run order of fetch
        lists does not matter.  A true LRU: a hit moves the variant to
        the back, and the least recently used of more than
        ``_VARIANT_CAP`` is dropped."""
        if not self._pending_passes:
            return self._program
        key = tuple(fetch_names)
        hit = self._pass_variants.get(key)
        if hit is not None:
            self._pass_variants.move_to_end(key)
            return hit
        clone = self._program.clone()
        for name in self._pending_passes:
            apply_pass(clone, name, fetch_names=list(fetch_names))
        if len(self._pass_variants) >= self._VARIANT_CAP:
            self._pass_variants.popitem(last=False)
        self._pass_variants[key] = clone
        return clone

    # pass-through conveniences so CompiledProgram quacks like Program
    def __getattr__(self, item):
        return getattr(self._program, item)


_DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
                "bfloat16": 2, "float16": 2, "int16": 2, "int8": 1,
                "uint8": 1, "bool": 1}
_FLOAT_DTYPES = ("float32", "float64", "float16", "bfloat16")


def _qscale_blocks(numel, p_axes, qspec, axis_sizes):
    """Static length of a quantized bucket's stage-2 scale tensor: the
    op pads the flat payload so every rank of the LAST reduce axis owns
    whole blocks; one float32 scale per block.  -1 when the group size
    (and so the pad) is unknown at insertion time."""
    n = int((axis_sizes or {}).get(p_axes[-1], 0) or 0)
    if n <= 0:
        return -1
    chunk = n * qspec.block_size
    padded = -(-int(numel) // chunk) * chunk
    return padded // qspec.block_size


def _bucketize(group, cap):
    """Split one (dtype, axes) group's leaves ``(grad, nbytes, hook)``
    into contiguous buckets ``(names, nbytes, hook)`` of at most ``cap``
    bytes (a leaf larger than the cap is a bucket of its own), each
    carrying the least hook position of its members (None when a member
    has none: the backward cannot fire that bucket early)."""
    buckets = []
    for g, nbytes, hook in group:
        if buckets and (cap is None or buckets[-1][1] + nbytes <= cap):
            names, size, h = buckets[-1]
            h = None if (h is None or hook is None) else min(h, hook)
            buckets[-1] = (names + [g], size + nbytes, h)
        else:
            buckets.append(([g], nbytes, hook))
    return buckets


def insert_pipe_grad_sync(program: Program, pipe_axis: str = "pp") -> int:
    """Sum every parameter gradient over the pipe axis — the pipeline's
    own gradient sync (``framework/pipe.apply_pipeline`` calls it).

    Each pipe rank accumulates cotangents only for its own stages'
    parameters (the others stay zero), so a plain sum over ``pipe_axis``
    gives every rank the whole gradient; no mean scale (the 1/n lives
    with the data-axis sync, with which this sum commutes).  One fused
    collective per dtype, right after the backward; a pipe-sharded
    parameter's gradient (``dist_attr`` over the pipe axis) is skipped:
    the lowering's reduce-scatter is its sum.  On a run without the pipe
    axis the ops are the identity.  Returns the number of ops
    inserted."""
    block = program.global_block()
    bw_idx = next((i for i, op in enumerate(block.ops)
                   if op.type == "backward"), None)
    if bw_idx is None:
        return 0
    bw = block.ops[bw_idx]
    if bw.attrs.get("_pipe_allreduce_inserted"):
        return 0
    bw.attrs["_pipe_allreduce_inserted"] = True
    groups, order = {}, []
    for pname in bw.attrs["param_names"]:
        pvar = block._find_var_recursive(pname)
        gvar = block._find_var_recursive(grad_var_name(pname))
        gda = getattr(gvar, "dist_attr", None) if gvar is not None \
            else None
        if gda and pipe_axis in _flat_axes(tuple(gda)):
            continue
        dtype = str(getattr(pvar, "dtype", "float32") or "float32")
        if dtype not in groups:
            groups[dtype] = []
            order.append(dtype)
        groups[dtype].append(grad_var_name(pname))
    insert_at = bw_idx + 1
    for dtype in order:
        block._insert_op(
            insert_at, type="c_fused_allreduce_sum",
            inputs={"X": list(groups[dtype])},
            outputs={"Out": list(groups[dtype])},
            attrs={"ring_id": 0, "_axis_name": pipe_axis,
                   "_pipe_grad_sync": True})
        insert_at += 1
    return len(order)


def insert_grad_sync(program: Program, strategy, nranks, reduce_axes,
                     axis_sizes=None):
    """Insert the per-step gradient sync after the backward op — the JAX
    package's rewrite of the reference's GradAllReduce transpiler
    (transpiler/collective.py:190-226), minus the stream-sync ops.

    Two shapes: per-leaf ``scale`` + ``c_allreduce_sum`` (one collective
    per gradient), or — with ``strategy.fuse_all_reduce_ops`` — bucketed
    ``c_fused_allreduce_sum`` ops partitioned by (dtype, reduce axes) and
    capped at ``fuse_grad_size_in_MB`` each, with the mean-loss 1/n scale
    folded in.  ``allreduce_compress_dtype`` rides the bf16 cast path;
    ``allreduce_quant_spec`` (int8/int4) turns float grads' collectives
    into ``c_quant_allreduce_sum`` / ``c_fused_quant_allreduce_sum``, the
    latter declaring its stage-2 scale var (``QScale``).  A param already
    sharded over some axes (``dist_attr``) reduces over the others only;
    a distributed param is skipped.

    With ``strategy.overlap_grad_sync`` the bucketed path cuts the buckets
    in gradient READY order: the leaves sorted by descending first forward
    read (counted over the ops before the backward, feed and fetch left
    out; unread parameters last), the cap min(``fuse_grad_size_in_MB``,
    ``overlap_bucket_size_in_MB``), a (dtype, axes) group re-split to at
    least ``overlap_min_buckets`` buckets, the ops emitted in ready order
    and marked ``_overlap`` / ``_ready_rank`` / ``_bucket_index`` /
    ``_overlap_hook_pos`` (the least first read of the bucket's members).
    The executor fires such a bucket's collective from a backward hook
    placed before that read (:func:`~.executor.run_training_block`)."""
    block = program.global_block()
    bw_idx = next((i for i, op in enumerate(block.ops)
                   if op.type == "backward"), None)
    if bw_idx is None:
        return
    bw = block.ops[bw_idx]
    if bw.attrs.get("_allreduce_inserted"):
        return
    bw.attrs["_allreduce_inserted"] = True
    need_scale = strategy.gradient_scale_strategy == \
        BuildStrategy.GradientScaleStrategy.CoeffNumDevice
    compress = getattr(strategy, "allreduce_compress_dtype", None)
    from ..ops.quantize_wire import CompressionSpec
    qspec = CompressionSpec.from_attr(
        getattr(strategy, "allreduce_quant_spec", None))
    if qspec is not None and qspec.dtype == "bfloat16":
        # the bf16 tier IS the cast path — route it there
        compress, qspec = "bfloat16", None
    insert_at = bw_idx + 1
    all_axes = tuple(reduce_axes) if isinstance(reduce_axes, (tuple, list)) \
        else (reduce_axes or "dp",)

    overlap = bool(getattr(strategy, "overlap_grad_sync", False))
    first_use = {}
    if overlap:
        from .liveness import op_reads_recursive
        want = set(bw.attrs["param_names"])
        pos = 0
        for op in block.ops[:bw_idx]:
            if op.type in ("feed", "fetch"):
                continue
            for n in op_reads_recursive(op) & want:
                first_use.setdefault(n, pos)
            pos += 1

    leaves = []          # (grad_name, p_axes, dtype, nbytes, first use)
    for pname in bw.attrs["param_names"]:
        pvar = block._find_var_recursive(pname)
        if pvar is not None and getattr(pvar, "is_distributed", False):
            continue  # ref: collective.py:226 skips distributed params
        da = _flat_axes(tuple(getattr(pvar, "dist_attr", None) or ()))
        p_axes = tuple(a for a in all_axes if a not in da)
        dtype = str(getattr(pvar, "dtype", "float32") or "float32")
        numel = int(abs(np.prod(pvar.shape))) if pvar is not None and \
            len(tuple(pvar.shape)) else 1
        leaves.append((grad_var_name(pname), p_axes, dtype,
                       numel * _DTYPE_BYTES.get(dtype, 4),
                       first_use.get(pname)))

    def axis_attr(p_axes):
        return {"ring_id": 0,
                "_axis_name": tuple(p_axes) if len(p_axes) > 1
                else p_axes[0]}

    if not getattr(strategy, "fuse_all_reduce_ops", False) and not overlap:
        for g, p_axes, dtype, _, _ in leaves:
            if need_scale:
                block._insert_op(insert_at, type="scale",
                                 inputs={"X": [g]}, outputs={"Out": [g]},
                                 attrs={"scale": 1.0 / nranks})
                insert_at += 1
            if p_axes:
                attrs = axis_attr(p_axes)
                op_type = "c_allreduce_sum"
                if qspec is not None and dtype in _FLOAT_DTYPES:
                    op_type = "c_quant_allreduce_sum"
                    attrs["quant_spec"] = qspec.to_attr()
                elif compress:
                    attrs["compress_dtype"] = compress
                block._insert_op(insert_at, type=op_type,
                                 inputs={"X": [g]}, outputs={"Out": [g]},
                                 attrs=attrs)
                insert_at += 1
        return

    # -- bucketed path ------------------------------------------------
    cap_mb = getattr(strategy, "fuse_grad_size_in_MB", 32) or 0
    if overlap:
        ov_mb = getattr(strategy, "overlap_bucket_size_in_MB", 4) or 0
        cap_mb = min(cap_mb, ov_mb) if cap_mb > 0 and ov_mb > 0 \
            else (cap_mb or ov_mb)
        # a parameter's cotangent is final once the reverse sweep passes
        # its first read, so the later read comes first; unread last
        leaves = sorted(leaves, key=lambda t: -1 if t[4] is None else t[4],
                        reverse=True)
    cap = int(cap_mb * (1 << 20)) if cap_mb > 0 else None
    group_leaves = {}    # (dtype, p_axes) -> [(grad, nbytes, hook), ...]
    order = []
    for g, p_axes, dtype, nbytes, hook in leaves:
        key = (dtype, p_axes)
        if key not in group_leaves:
            group_leaves[key] = []
            order.append(key)
        group_leaves[key].append((g, nbytes, hook))
    if overlap:
        min_buckets = int(getattr(strategy, "overlap_min_buckets", 4) or 0)
        flat = []
        for key in order:
            ls = group_leaves[key]
            gcap = cap
            if min_buckets > 1 and len(ls) >= min_buckets:
                # one giant bucket has nothing to hide behind: shrink the
                # cap until the group splits into min_buckets buckets
                auto = -(-sum(n for _, n, _ in ls) // min_buckets)
                gcap = auto if gcap is None else min(gcap, auto)
            flat.extend((key, b) for b in _bucketize(ls, gcap))
        # emitted in ready order (descending hook position), unhookable
        # buckets last
        flat.sort(key=lambda kb: -1 if kb[1][2] is None else kb[1][2],
                  reverse=True)
        ranked = [(key, names, nbytes, hook, rank)
                  for rank, (key, (names, nbytes, hook)) in enumerate(flat)]
    else:
        ranked = [(key, names, nbytes, None, None) for key in order
                  for names, nbytes, _ in _bucketize(group_leaves[key], cap)]
    for (dtype, p_axes), names, bucket_bytes, hook, rank in ranked:
        if not p_axes:
            # nothing to reduce over (fully sharded param): the
            # mean-scale still applies, per leaf
            if need_scale:
                for g in names:
                    block._insert_op(
                        insert_at, type="scale",
                        inputs={"X": [g]}, outputs={"Out": [g]},
                        attrs={"scale": 1.0 / nranks})
                    insert_at += 1
            continue
        attrs = axis_attr(p_axes)
        if need_scale:
            attrs["scale"] = 1.0 / nranks
        if rank is not None:
            attrs["_overlap"] = True
            attrs["_ready_rank"] = int(rank)
            attrs["_bucket_index"] = int(rank)
            if hook is not None:
                attrs["_overlap_hook_pos"] = int(hook)
        op_type = "c_fused_allreduce_sum"
        outputs = {"Out": list(names)}
        if qspec is not None and dtype in _FLOAT_DTYPES:
            # the bucket's stage-2 scale tensor rides beside the
            # payload: a declared var, so its bytes are on record
            op_type = "c_fused_quant_allreduce_sum"
            attrs["quant_spec"] = qspec.to_attr()
            numel = bucket_bytes // _DTYPE_BYTES.get(dtype, 4)
            sv = block.create_var(
                name=f"{names[0]}@quant_scale",
                shape=(_qscale_blocks(numel, p_axes, qspec, axis_sizes),),
                dtype="float32")
            outputs["QScale"] = [sv.name]
        elif compress:
            attrs["compress_dtype"] = compress
        block._insert_op(insert_at, type=op_type,
                         inputs={"X": list(names)}, outputs=outputs,
                         attrs=attrs)
        insert_at += 1
