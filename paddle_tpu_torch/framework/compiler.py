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

Several places in one process, ``mesh=`` and ``with_mesh`` raise: one
process drives one device, and meshes (ZeRO, tensor parallelism) come
with a later slice.  ``overlap_grad_sync`` is refused by name (it needs
backward hooks in the executor).  The JAX package's static checks of a
variant (``verify_programs``, ``hbm_budget_gb``, ``aot_cache_dir``)
belong to modules the port does not have yet, and it has none of those
flags."""

from __future__ import annotations

from collections import OrderedDict
from typing import Optional

import numpy as np

from .core import Program, grad_var_name
from .errors import UnimplementedError
from .passes import apply_pass

_ONE_PROCESS_PER_RANK = (
    "one process drives one device, and data parallelism is one process "
    "per rank: launch the script with `python -m "
    "paddle_tpu_torch.distributed.launch --nproc N` and train through "
    "`paddle_tpu_torch.distributed.fleet`")
_MESH_SLICE = ("meshes (ZeRO sharding, tensor and pipeline parallelism) "
               "are not ported yet")


class BuildStrategy:
    """ref: details/build_strategy.h — the JAX package's fields.  The
    gradient-sync fields (``fuse_all_reduce_ops``,
    ``fuse_grad_size_in_MB``, ``allreduce_compress_dtype``,
    ``allreduce_quant_spec``, ``gradient_scale_strategy``) shape
    :func:`insert_grad_sync` inside a process group; ``overlap_grad_sync``
    is refused."""

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


def _flat_axes(entries):
    """Flatten axis collections into a flat tuple of axis names (the JAX
    package's mesh_layout._flat_axes)."""
    if entries is None:
        return ()
    if isinstance(entries, str):
        return (entries,)
    out = []
    for e in entries:
        if e is None:
            continue
        if isinstance(e, str):
            out.append(e)
        else:
            out.extend(_flat_axes(e))
    return tuple(out)


class CompiledProgram:
    #: retained pass-variant clones (one per fetch list)
    _VARIANT_CAP = 8

    def __init__(self, program: Program):
        self._program = program
        self._loss_name = None
        self._pending_passes = []
        self._pass_variants: "OrderedDict[tuple, Program]" = OrderedDict()
        # the process group the run reduces over (None: one rank)
        self._dp = None

    def with_data_parallel(self, loss_name: Optional[str] = None,
                           build_strategy: Optional[BuildStrategy] = None,
                           exec_strategy=None, share_vars_from=None,
                           places=None, mesh=None, axis_name: str = "dp"):
        """Data parallelism over this process's ``torch.distributed``
        group: with more than one rank and a ``loss_name``, the gradient
        sync is inserted for ``nranks`` = the world size.  More than one
        place, or a mesh, raises."""
        if mesh is not None:
            raise UnimplementedError(
                f"CompiledProgram.with_data_parallel(mesh=...): "
                f"{_MESH_SLICE}; {_ONE_PROCESS_PER_RANK}")
        if places is not None and len(places) > 1:
            raise UnimplementedError(
                f"CompiledProgram.with_data_parallel over {len(places)} "
                f"places: {_ONE_PROCESS_PER_RANK}")
        strategy = build_strategy or BuildStrategy()
        if strategy.overlap_grad_sync:
            raise UnimplementedError(
                "BuildStrategy.overlap_grad_sync: firing gradient buckets "
                "inside the backward sweep needs backward hooks in the "
                "executor, which are not ported yet")
        from ..ops.collective_ops import DataParallelGroup
        dp = DataParallelGroup.current(axis_name)
        if dp is not None and loss_name is not None:
            insert_grad_sync(self._program, strategy, dp.world,
                             (axis_name,), axis_sizes={axis_name: dp.world})
        self._dp = dp
        self._loss_name = loss_name
        if strategy.fuse_elewise_add_act_ops:
            # ref: build_strategy.cc:51 runs fuse_elewise_add_act_pass in
            # the training pipeline
            self._pending_passes.append("fuse_elemwise_add_act")
        return self

    def with_mesh(self, mesh, loss_name: Optional[str] = None, **_):
        raise UnimplementedError(
            f"CompiledProgram.with_mesh: {_MESH_SLICE}; "
            f"{_ONE_PROCESS_PER_RANK}")

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
    """Split one (dtype, axes) group's leaves ``(grad, nbytes)`` into
    contiguous buckets ``(names, nbytes)`` of at most ``cap`` bytes (a
    leaf larger than the cap is a bucket of its own)."""
    buckets = []
    for g, nbytes in group:
        if buckets and (cap is None or buckets[-1][1] + nbytes <= cap):
            names, size = buckets[-1]
            buckets[-1] = (names + [g], size + nbytes)
        else:
            buckets.append(([g], nbytes))
    return buckets


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
    a distributed param is skipped."""
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

    leaves = []          # (grad_name, p_axes, dtype, nbytes)
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
                       numel * _DTYPE_BYTES.get(dtype, 4)))

    def axis_attr(p_axes):
        return {"ring_id": 0,
                "_axis_name": tuple(p_axes) if len(p_axes) > 1
                else p_axes[0]}

    if not getattr(strategy, "fuse_all_reduce_ops", False):
        for g, p_axes, dtype, _ in leaves:
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
    cap = int(cap_mb * (1 << 20)) if cap_mb > 0 else None
    group_leaves = {}    # (dtype, p_axes) -> [(grad, nbytes), ...]
    order = []
    for g, p_axes, dtype, nbytes in leaves:
        key = (dtype, p_axes)
        if key not in group_leaves:
            group_leaves[key] = []
            order.append(key)
        group_leaves[key].append((g, nbytes))
    for key in order:
        dtype, p_axes = key
        for names, bucket_bytes in _bucketize(group_leaves[key], cap):
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
                    shape=(_qscale_blocks(numel, p_axes, qspec,
                                          axis_sizes),),
                    dtype="float32")
                outputs["QScale"] = [sv.name]
            elif compress:
                attrs["compress_dtype"] = compress
            block._insert_op(insert_at, type=op_type,
                             inputs={"X": list(names)}, outputs=outputs,
                             attrs=attrs)
            insert_at += 1
