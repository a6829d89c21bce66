"""ZeRO-3 parameter sharding over the ``fsdp`` axis — the port of
paddle_tpu/framework/fsdp.py, the same program rewrite.

ZeRO-1 (``ShardedUpdateOptimizer``) shards only the optimizer state;
this pass shards the parameters themselves:

* each trainable parameter's resident value becomes its 1/fsdp shard
  (``dist_attr`` stamped with the fsdp axis on the shard dim): the
  executor keeps each rank's block of it, step over step;
* a ``fsdp_all_gather`` op is inserted at the parameter's first forward
  use (placed with the liveness pass), and every forward read is renamed
  to its ``@fsdp_full`` output; the gathered tensor is freed once its
  last reader (and the backward, which saves it) is done;
* no explicit reduce-scatter: ``fsdp_all_gather``'s backward sums each
  rank's slice of the cotangent over the group, so every rank gets its
  shard's gradient; ``CompiledProgram.with_mesh``'s gradient sync skips
  the fsdp axis for stamped parameters (their gradients are stamped too)
  and only applies the mean scale;
* the optimizer accumulators shaped like the parameter are stamped with
  the same spec, so the moments shard along with it;
* a global-norm clip sums its sharded gradients' squares over the fsdp
  axis before the square root (``clip.shard_global_norm``), so every rank
  clips by the whole gradient's norm.

The batch shards over the fsdp axis, and over ``dp`` x ``fsdp`` under
HSDP (``MeshLayout.batch_axes``), where a stamped parameter is a block by
the rank's fsdp coordinate, replicated over ``dp``.  Beside tensor and
sequence parallelism the pass skips every parameter that already has a
``dist_attr`` (the tp layers stamp theirs at any tp degree), as the JAX
pass does: a tp block stays a block over ``tp`` and its gradient is
reduced over the batch and sequence axes, the rest is sharded over the
rank's fsdp line, replicated over ``dp``, ``tp`` and ``sp``."""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np

from .core import Block, Program, grad_var_name
from .mesh_layout import MeshLayout, ShardSpec

#: params below this element count stay replicated: a [hidden]-sized
#: LayerNorm scale costs more in gather latency than its shard saves
DEFAULT_MIN_SHARD_NUMEL = 2048

GATHER_SUFFIX = "@fsdp_full"

_DTYPE_BYTES = {"float64": 8, "int64": 8, "float32": 4, "int32": 4,
                "bfloat16": 2, "float16": 2, "int16": 2, "int8": 1,
                "uint8": 1, "bool": 1}


def _shard_dim(shape: Tuple[int, ...], fsdp: int) -> Optional[int]:
    """First dim evenly divisible by the fsdp degree (dim 0 preferred)."""
    for d, s in enumerate(shape):
        if int(s) >= fsdp and int(s) % fsdp == 0:
            return d
    return None


def _rename_inputs(op, old: str, new: str):
    """Rewrite every read of ``old`` to ``new`` on ``op``, recursing into
    control-flow sub-blocks (the gather itself stays in the parent block:
    a collective inside divergent control flow would deadlock)."""
    for slot, names in op.inputs.items():
        op.inputs[slot] = [new if n == old else n for n in names]
    for v in op.attrs.values():
        subs = v if isinstance(v, (list, tuple)) else (v,)
        for sub in subs:
            if isinstance(sub, Block):
                for sub_op in sub.ops:
                    _rename_inputs(sub_op, old, new)


def apply_fsdp_sharding(program: Program, layout: MeshLayout,
                        min_shard_numel: int = DEFAULT_MIN_SHARD_NUMEL,
                        prefetch_distance: int = 0) -> Dict[str, Any]:
    """Rewrite ``program`` in place for ZeRO-3 parameter sharding over
    ``layout``'s fsdp axis.  Idempotent per program; call after
    ``optimizer.minimize`` and before ``CompiledProgram.with_mesh``.

    Returns the JAX package's report: per parameter its shard dim, gather
    window ``(first_use, last_use)`` and issue position, and the skip
    census (below-min-shard-numel / no-divisible-dim / already-sharded /
    not-read-in-forward).  ``prefetch_distance`` > 0 issues each gather
    at the first use of the parameter that many gathers earlier (gathers
    ordered by first use); the ``_window`` attr keeps the original
    (first_use, last_use) and ``_issue`` the issue position."""
    from .liveness import block_liveness, op_reads_recursive

    fsdp = layout.fsdp
    axis = layout.fsdp_axis
    report: Dict[str, Any] = {"fsdp_axis": axis, "fsdp_degree": fsdp,
                              "sharded": [], "skipped": []}
    if fsdp <= 1:
        return report
    block = program.global_block()
    if any(op.type == "fsdp_all_gather" for op in block.ops):
        return report                      # already rewritten
    bw_idx = next((i for i, op in enumerate(block.ops)
                   if op.type == "backward"), None)
    if bw_idx is None:
        raise ValueError(
            "apply_fsdp_sharding: program has no backward op — ZeRO-3 "
            "shards TRAINING programs (run optimizer.minimize first)")

    # liveness over the unmodified block: first/last forward use per
    # param (sub-block reads count at the parent op)
    liveness = block_liveness(block)

    def forward_uses(pname):
        return [i for i, op in enumerate(block.ops[:bw_idx])
                if pname in op_reads_recursive(op)]

    plans = []           # (first_use, last_use, param, shard_dim)
    for p in block.all_parameters():
        if not p.trainable:
            continue
        if getattr(p, "dist_attr", None):
            report["skipped"].append((p.name, "already-sharded"))
            continue
        shape = tuple(int(s) for s in p.shape)
        numel = int(np.prod(shape)) if shape else 1
        if numel < max(min_shard_numel, fsdp):
            report["skipped"].append((p.name, "below-min-shard-numel"))
            continue
        dim = _shard_dim(shape, fsdp)
        if dim is None:
            report["skipped"].append((p.name, "no-divisible-dim"))
            continue
        uses = forward_uses(p.name)
        if not uses:
            report["skipped"].append((p.name, "not-read-in-forward"))
            continue
        plans.append((uses[0], uses[-1], p, dim))

    # rename every forward read p -> p@fsdp_full against the unmodified op
    # list, then insert the gathers at their issue positions in
    # descending order, so each insertion leaves the rest valid
    for first, last, p, dim in plans:
        full = block.create_var(name=p.name + GATHER_SUFFIX,
                                shape=tuple(p.shape), dtype=p.dtype)
        for op in block.ops[first:bw_idx]:
            _rename_inputs(op, p.name, full.name)
    d = max(int(prefetch_distance or 0), 0)
    report["prefetch_distance"] = d
    by_first = sorted(plans, key=lambda t: t[0])
    issue_of = {id(t[2]): by_first[max(i - d, 0)][0]
                for i, t in enumerate(by_first)}
    for first, last, p, dim in sorted(plans,
                                      key=lambda t: -issue_of[id(t[2])]):
        spec = ShardSpec(tuple(axis if d2 == dim else None
                               for d2 in range(len(p.shape))) or (axis,))
        full_name = p.name + GATHER_SUFFIX
        issue = issue_of[id(p)]
        block._insert_op(
            issue, type="fsdp_all_gather",
            inputs={"X": [p.name]}, outputs={"Out": [full_name]},
            attrs={"ring_id": 0, "_axis_name": axis, "gather_dim": dim,
                   "_window": (first, last),
                   "_issue": int(issue)})
        p.dist_attr = spec
        # the gradient of the resident shard arrives reduce-scattered
        g = block.vars.get(grad_var_name(p.name))
        if g is not None:
            g.dist_attr = spec
        # every persistable of the update zone shaped like the param
        # (Adam moments, gradient-merge accumulators) shards with it
        coupled = {p.name, grad_var_name(p.name)}
        for op in block.ops[bw_idx:]:
            names = set(op.input_names()) | set(op.output_names())
            if not (names & coupled):
                continue
            for n in names:
                v = block._find_var_recursive(n)
                if v is None or not v.persistable or n == p.name:
                    continue
                if tuple(v.shape) == tuple(p.shape) and \
                        not getattr(v, "dist_attr", None):
                    v.dist_attr = spec
        report["sharded"].append(
            {"param": p.name, "shape": list(p.shape), "shard_dim": dim,
             "window": [int(first), int(last)], "issue": int(issue),
             "bytes_full": int(np.prod(p.shape)) *
             _DTYPE_BYTES.get(str(p.dtype), 4),
             "pinned": bool(liveness.get(p.name) and
                            liveness[p.name].pinned)})
    from ..clip import shard_global_norm
    shard_global_norm(block)
    program._bump_version()
    return report


__all__ = ["apply_fsdp_sharding", "GATHER_SUFFIX",
           "DEFAULT_MIN_SHARD_NUMEL"]
