"""Pipeline parallelism as a program rewrite — the port of
paddle_tpu/framework/pipe.py (its rewrite half).

* **stage cuts** — :func:`plan_stage_cuts` picks the ``S − 1`` cut points
  of the forward minimizing the bytes of the live tensors crossing them
  (the values one stage hands the next, per microbatch) under a
  compute-balance constraint (per-op FLOPs from the ``flops`` channel of
  ``ops/op_specs.py``), skipping positions that would strand a
  collective from its producers.  The JAX package learns the tensors'
  shapes from its op specs' ``infer`` channel; the port runs the forward
  once on ``meta`` tensors (:func:`abstract_env`, the counterpart of
  ``jax.eval_shape``), the feeds at ``feed_shapes`` or their declared
  shapes with −1 read as 1.  The FLOPs are priced where the JAX package's
  shapes reach (so its plans and the port's agree) and through the fusion
  passes' ops, which it infers no shape for (a fused program's encoder is
  unpriced there, its plan a cut after the last op); the boundary bytes
  everywhere.
* **the rewrite** — :func:`apply_pipeline` stamps every forward op with
  ``_pipe_stage``, inserts a ``pipe_stage_boundary`` op (the identity) at
  each cut, stamps the schedule on the ``backward`` op and appends the
  pipe-axis gradient sum (``compiler.insert_pipe_grad_sync``);
  :func:`set_microbatches` stamps the microbatch count alone.
* **the schedules** — :func:`simulate_schedule` simulates one member of
  :data:`SCHEDULE_FAMILIES` (1F1B, interleaved 1F1B, zero-bubble) into
  the static per-tick tables the executor's pipelined lowering walks
  (``executor._lower_pipelined``): pure table math, the JAX package's
  line for line.
* **pipe-sharded weights** — :func:`apply_pipe_weight_sharding` stamps
  pipe-axis ``ShardSpec`` entries on the eligible parameters and their
  optimizer state; the lowering gathers them once before its walk and
  reduce-scatters their gradients once after it.

* **activation rematerialization** — :func:`plan_remat` picks recompute
  checkpoints at the forward's residual minima and prices them with the
  static memory estimate (``framework/memory_analysis.py``);
  :func:`apply_remat` stamps them on the ``backward`` op, whose recompute
  segments the executor runs."""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .core import Program, grad_var_name
from .errors import InvalidArgumentError
from .fsdp import _DTYPE_BYTES
from .mesh_layout import PIPE_AXIS

BOUNDARY_OP = "pipe_stage_boundary"



# ---------------------------------------------------------------------------
# abstract evaluation (the counterpart of jax.eval_shape)
# ---------------------------------------------------------------------------


def _torch_dtype(name: str):
    import torch
    return {"float32": torch.float32, "float64": torch.float64,
            "float16": torch.float16, "bfloat16": torch.bfloat16,
            "int64": torch.int64, "int32": torch.int32, "int16": torch.int16,
            "int8": torch.int8, "uint8": torch.uint8,
            "bool": torch.bool}[str(name)]


def dtype_name(dt) -> str:
    """The port's dtype spelling of a ``torch.dtype``."""
    return str(dt).replace("torch.", "")


def abstract_env(ops, env: Dict[str, Any], generator=None):
    """Run ``ops`` on ``meta`` tensors and return the environment they
    leave: every produced tensor's shape and dtype, no data, no kernel
    (``registry.abstract_eval``: each op takes its plain composition and
    nothing is counted).  ``env`` maps names to tensors on any device (a
    tensor that requires grad keeps doing so, so the result says which
    outputs are differentiable) or to ``(shape, dtype)`` pairs."""
    import torch
    from ..ops.registry import LoweringContext, abstract_eval
    from .executor import run_ops
    meta = torch.device("meta")
    e = {}
    for n, v in env.items():
        if isinstance(v, torch.Tensor):
            t = torch.empty(v.shape, dtype=v.dtype, device=meta)
            e[n] = t.requires_grad_(True) if v.requires_grad else t
        elif isinstance(v, tuple) and len(v) == 2:
            e[n] = torch.empty(tuple(int(d) for d in v[0]),
                               dtype=_torch_dtype(v[1]), device=meta)
        else:
            e[n] = v
    ctx = LoweringContext(generator, meta)
    with abstract_eval(), torch.enable_grad():
        run_ops(list(ops), e, ctx)
    return e


# ---------------------------------------------------------------------------
# forward-region introspection
# ---------------------------------------------------------------------------


def _fwd_region(program: Program):
    """(block, exec_ops, bw_idx): the executor's op space (feed/fetch
    filtered) and the backward meta-op index (None: inference)."""
    block = program.global_block()
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    bw_idx = next((i for i, op in enumerate(ops)
                   if op.type == "backward"), None)
    return block, ops, bw_idx


def _feed_sigs(program: Program, feed_shapes, unknown_dim: int):
    """Concrete (or declared-fallback) (shape, dtype) of the feed roots."""
    block = program.global_block()
    sigs: Dict[str, Tuple[Tuple[int, ...], str]] = {}
    for name, v in (feed_shapes or {}).items():
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            sigs[name] = (tuple(v.shape), dtype_name(v.dtype)
                          if not isinstance(v.dtype, np.dtype)
                          else str(v.dtype))
        else:
            shape, dtype = v
            sigs[name] = (tuple(shape), str(dtype))
    for name, v in block.vars.items():
        if v.is_data and name not in sigs:
            sigs[name] = (tuple(int(d) if int(d) > 0 else unknown_dim
                                for d in v.shape), str(v.dtype))
    return sigs


#: the op types whose output shapes the JAX package's op specs infer
#: (its ``infer`` channel); another op's outputs keep their declared
#: shapes there, −1 dims included
SHAPE_INFERRED_OPS = frozenset({
    "abs", "adagrad", "adam", "adamax", "adamw", "argsort", "assign",
    "batch_norm", "c_allreduce_max", "c_allreduce_min", "c_allreduce_prod",
    "c_allreduce_sum", "c_embedding", "c_expert_alltoall", "c_identity",
    "c_quant_allreduce_sum", "c_sync_calc_stream", "c_sync_comm_stream",
    "cache_write", "cast", "ceil", "clip", "concat", "conv2d", "cos",
    "cross_entropy", "cross_entropy2", "cumsum", "decode_chain",
    "depthwise_conv2d", "dropout", "elementwise_add", "elementwise_div",
    "elementwise_floordiv", "elementwise_max", "elementwise_min",
    "elementwise_mod", "elementwise_mul", "elementwise_pow",
    "elementwise_sub", "equal", "erf", "exp", "fill_constant",
    "fill_zeros_like", "floor", "fsdp_all_gather", "fused_attention",
    "gaussian_random", "gelu", "greater_equal", "greater_than",
    "hard_sigmoid", "hard_swish", "lamb", "lars_momentum", "layer_norm",
    "leaky_relu", "less_equal", "less_than", "log", "log_softmax",
    "logical_and", "logical_not", "logical_or", "logical_xor",
    "lookup_table", "lookup_table_v2", "matmul", "matmul_v2", "mean",
    "moe_combine", "moe_dispatch", "moe_expert_ffn", "momentum",
    "mp_allreduce_sum", "mp_copy", "mul", "not_equal", "one_hot",
    "pipe_stage_boundary", "pool2d", "pow", "reduce_all", "reduce_any",
    "reduce_max", "reduce_mean", "reduce_min", "reduce_prod", "reduce_sum",
    "relu", "relu6", "reshape", "reshape2", "rmsprop", "round", "rsqrt",
    "scale", "sgd", "sigmoid", "sign", "sin", "softmax",
    "softmax_with_cross_entropy", "softplus", "softsign", "split", "sqrt",
    "square", "sum", "swish", "tanh", "top_k", "transpose", "transpose2",
    "truncated_gaussian_random", "uniform_random", "unsqueeze2", "where"})

#: the output slots the JAX package's infer channel covers, for the ops of
#: :data:`SHAPE_INFERRED_OPS` with outputs beyond them (an ``XShape``, an
#: optimizer's moments): the other slots keep their declared signatures
#: there.  Every slot of an op not listed is covered.
INFERRED_SLOTS = {
    "reshape2": ("Out",), "reshape": ("Out",), "transpose2": ("Out",),
    "transpose": ("Out",), "unsqueeze2": ("Out",),
    "cross_entropy": ("Y", "Out"), "cross_entropy2": ("Y", "Out"),
    "batch_norm": ("Y",), "fused_attention": ("Out",),
    "moe_dispatch": ("Xe", "Combine", "AuxLoss"),
    "sgd": ("ParamOut",), "momentum": ("ParamOut",),
    "adamax": ("ParamOut",), "adagrad": ("ParamOut",),
    "rmsprop": ("ParamOut",), "lars_momentum": ("ParamOut",),
    "lamb": ("ParamOut",), "adam": ("ParamOut",), "adamw": ("ParamOut",),
}

#: the fusion passes' ops, whose outputs keep their first input's shape:
#: the JAX package's infer channel has no rule for them, which leaves a
#: fused program's whole encoder unpriced there (and its plan a cut after
#: the last op); the port prices them
FUSED_SHAPE_OPS = frozenset({"fused_add_layernorm",
                             "fused_elemwise_activation",
                             "multihead_matmul"})


def _sig_env(program: Program, fwd_ops, feed_shapes):
    """({name: VarSig} of every forward value, the same as the JAX
    package's static shapes see them, the feed sigs): the forward run on
    ``meta`` tensors, the parameters and other persistables at their
    declared shapes.  In the second map, where the JAX package's static
    shapes stop — the outputs of an op it infers no shape for, declared
    with an unknown (−1) dim, and every value computed from one — a value
    keeps its declared shape: the FLOPs priced from it are the JAX
    package's (the fusion passes' ops, :data:`FUSED_SHAPE_OPS`, priced
    too).  The boundary bytes come from the first map: a cut the JAX
    package cannot price for want of a shape stays open here."""
    from ..ops.op_specs import VarSig
    block = program.global_block()
    feed_sigs = _feed_sigs(program, feed_shapes, 1)
    from .liveness import op_reads_recursive
    env: Dict[str, Any] = dict(feed_sigs)
    for op in fwd_ops:
        for n in op_reads_recursive(op):
            if n in env:
                continue
            v = block._find_var_recursive(n)
            if v is not None and v.persistable and v.shape is not None:
                env[n] = (tuple(int(d) for d in v.shape), str(v.dtype))
    out = abstract_env(fwd_ops, env)
    sigs = {}
    for n, t in out.items():
        if hasattr(t, "shape") and hasattr(t, "dtype"):
            sigs[n] = VarSig(tuple(t.shape), dtype_name(t.dtype))
    static = dict(sigs)
    unknown = set()
    for op in fwd_ops:
        inferred = (op.type in SHAPE_INFERRED_OPS or
                    op.type in FUSED_SHAPE_OPS) and not (
            unknown & set(op.input_names()))
        for n in op.output_names():
            v = block._find_var_recursive(n)
            declared = tuple(v.shape) if v is not None and \
                v.shape is not None else None
            if inferred or declared is None or \
                    all(int(d) >= 0 for d in declared):
                continue
            unknown.add(n)
            if n in static:
                static[n] = VarSig(declared, static[n].dtype)
    return sigs, static, feed_sigs


def _fwd_liveness(block, fwd_ops):
    """(def_idx, last_use) per name over the FORWARD op list only —
    sub-block reads count at the parent op."""
    from .liveness import op_reads_recursive
    def_idx: Dict[str, int] = {}
    last_use: Dict[str, int] = {}
    for i, op in enumerate(fwd_ops):
        for n in op_reads_recursive(op):
            last_use[n] = i
        for n in op.output_names():
            def_idx.setdefault(n, i)
    return def_idx, last_use


def _per_op_flops(block, fwd_ops, env):
    """GEMM-class FLOPs per forward op (0 for unpriced ops) via the
    ``flops`` channel — the stage-balance weight."""
    from ..ops.op_specs import FLOPS, VarSig

    def sig_of(name):
        s = env.get(name)
        if s is not None and s.shape is not None:
            return s
        v = block._find_var_recursive(name)
        if v is None:
            return s
        return VarSig(tuple(v.shape) or None, v.dtype)

    out = []
    for op in fwd_ops:
        fn = FLOPS.get(op.type)
        f = 0.0
        if fn is not None:
            ins = {slot: [sig_of(n) for n in names]
                   for slot, names in op.inputs.items()}
            outs = {slot: [sig_of(n) for n in names]
                    for slot, names in op.outputs.items()}
            try:
                f = float(fn(ins, outs, op.attrs) or 0.0)
            except Exception:
                f = 0.0
        out.append(f)
    return out


def _sig_bytes(sig) -> int:
    n = 1
    for d in sig.shape:
        n *= int(d)
    return n * _DTYPE_BYTES.get(sig.dtype, 4)


def _boundary_at(block, fwd_ops, cut, def_idx, last_use, env, feed_sigs):
    """(names, bytes) of the live set crossing ``cut`` (the cut sits
    between op cut−1 and op cut).  Feeds and persistables are excluded —
    every stage holds them; only produced activations cross.  ``bytes``
    is None when a crossing tensor's shape is unknown."""
    names, total = [], 0
    for n, d in def_idx.items():
        lu = last_use.get(n, -1)
        if not (d < cut <= lu):
            continue
        v = block._find_var_recursive(n)
        if v is not None and (v.persistable or v.is_data):
            continue
        if n in feed_sigs:
            continue
        sig = env.get(n)
        if sig is None or sig.shape is None or \
                any(int(s) < 0 for s in sig.shape):
            return names + [n], None
        names.append(n)
        total += _sig_bytes(sig)
    return sorted(names), total


def _collective_forbidden(block, fwd_ops, def_idx):
    """Cut positions that would strand a forward collective from one of
    its producers: a collective at index i reading a var defined at j
    forbids every cut in (j, i]."""
    from ..ops.op_specs import COLLECTIVE_OPS
    forbidden = set()
    for i, op in enumerate(fwd_ops):
        if op.type not in COLLECTIVE_OPS:
            continue
        for n in op.input_names():
            j = def_idx.get(n)
            if j is not None and j < i:
                forbidden.update(range(j + 1, i + 1))
    return forbidden


def _moe_forbidden(block, fwd_ops, def_idx):
    """Cut positions inside an MoE block's dispatch→combine span (a
    ``moe_combine`` at i reading a Combine tensor defined at j forbids
    every cut in (j, i])."""
    forbidden = set()
    for i, op in enumerate(fwd_ops):
        if op.type != "moe_combine":
            continue
        for n in op.inputs.get("Combine", ()):
            j = def_idx.get(n)
            if j is not None and j < i:
                forbidden.update(range(j + 1, i + 1))
    return forbidden


# ---------------------------------------------------------------------------
# stage-cut planning
# ---------------------------------------------------------------------------


class StageCutPlan:
    """One planned S-way partition of the forward region."""

    def __init__(self, cuts, boundaries, boundary_bytes, stage_flops,
                 stage_ops, num_ops):
        self.cuts = list(cuts)                    # S-1 indices, ascending
        self.boundaries = [list(b) for b in boundaries]
        self.boundary_bytes = [int(b) for b in boundary_bytes]
        self.stage_flops = [float(f) for f in stage_flops]
        self.stage_ops = [int(n) for n in stage_ops]
        self.num_ops = int(num_ops)

    @property
    def num_stages(self) -> int:
        return len(self.cuts) + 1

    @property
    def total_boundary_bytes(self) -> int:
        return sum(self.boundary_bytes)

    def as_dict(self) -> Dict[str, Any]:
        return {"num_stages": self.num_stages,
                "cuts": list(self.cuts),
                "boundaries": [list(b) for b in self.boundaries],
                "boundary_bytes": list(self.boundary_bytes),
                "total_boundary_bytes": self.total_boundary_bytes,
                "stage_flops": list(self.stage_flops),
                "stage_ops": list(self.stage_ops)}


def plan_stage_cuts(program: Program, num_stages: int,
                    feed_shapes=None,
                    balance_tol: float = 0.35) -> StageCutPlan:
    """Choose the ``num_stages − 1`` forward cut points minimizing total
    live-tensor transfer bytes at the boundaries, subject to every
    stage's FLOPs staying within ``(1 + balance_tol)`` of the even share
    (relaxed geometrically when infeasible)."""
    S = int(num_stages)
    block, ops, bw_idx = _fwd_region(program)
    if bw_idx is None:
        raise InvalidArgumentError(
            "plan_stage_cuts: program has no backward op — pipeline "
            "stages partition TRAINING programs (run minimize first)")
    fwd_ops = ops[:bw_idx]
    F = len(fwd_ops)
    if S < 2:
        raise InvalidArgumentError(f"plan_stage_cuts: num_stages={S} < 2")
    if F < S:
        raise InvalidArgumentError(
            f"plan_stage_cuts: {F} forward op(s) cannot split into "
            f"{S} stages")
    env, static, feed_sigs = _sig_env(program, fwd_ops, feed_shapes)
    def_idx, last_use = _fwd_liveness(block, fwd_ops)
    flops = _per_op_flops(block, fwd_ops, static)
    # every op carries a floor weight so FLOPs-free stretches (embedding
    # lookups, masks) still spread across stages
    w = [f + 1.0 for f in flops]
    prefix = np.concatenate([[0.0], np.cumsum(w)])
    total = float(prefix[-1])

    forbidden = _collective_forbidden(block, fwd_ops, def_idx)
    forbidden |= _moe_forbidden(block, fwd_ops, def_idx)
    cost: Dict[int, Tuple[List[str], int]] = {}
    for c in range(1, F):
        if c in forbidden:
            continue
        names, b = _boundary_at(block, fwd_ops, c, def_idx, last_use,
                                env, feed_sigs)
        if b is None:
            continue                    # unknown-shape crossing tensor
        cost[c] = (names, b)
    if len(cost) < S - 1:
        raise InvalidArgumentError(
            f"plan_stage_cuts: only {len(cost)} legal cut position(s) "
            f"for {S} stages (collective-producer spans and "
            f"unknown-shape boundaries excluded)")

    positions = sorted(cost)
    tol = float(balance_tol)
    for _ in range(8):
        cap = (1.0 + tol) * total / S
        # dp[k][c]: min boundary bytes splitting ops[0:c] into k stages
        # with the k-th stage ending at cut c
        INF = float("inf")
        dp = [{0: 0.0}]
        back: List[Dict[int, int]] = [{}]
        for k in range(1, S):
            row: Dict[int, float] = {}
            brow: Dict[int, int] = {}
            for c in positions:
                best, arg = INF, None
                for p, v in dp[k - 1].items():
                    if p >= c:
                        continue
                    if prefix[c] - prefix[p] > cap:
                        continue
                    cand = v + cost[c][1]
                    if cand < best:
                        best, arg = cand, p
                if arg is not None:
                    row[c] = best
                    brow[c] = arg
            dp.append(row)
            back.append(brow)
        best, last = INF, None
        for c, v in dp[S - 1].items():
            if total - prefix[c] > cap:
                continue
            if v < best:
                best, last = v, c
        if last is not None:
            cuts = [last]
            k = S - 1
            while k > 1:
                last = back[k][last]
                cuts.append(last)
                k -= 1
            cuts = sorted(cuts)
            edges = [0] + cuts + [F]
            return StageCutPlan(
                cuts,
                [cost[c][0] for c in cuts],
                [cost[c][1] for c in cuts],
                [float(prefix[b] - prefix[a] - (b - a))
                 for a, b in zip(edges, edges[1:])],
                [b - a for a, b in zip(edges, edges[1:])], F)
        tol *= 1.8                       # relax the balance cap and retry
    raise InvalidArgumentError(
        f"plan_stage_cuts: no feasible {S}-stage partition of {F} "
        f"forward ops (legal cuts at {positions[:16]}...)")


# ---------------------------------------------------------------------------
# the schedule family (static tables)
# ---------------------------------------------------------------------------

#: the static schedules: ``1f1b`` (non-interleaved 1F1B), ``interleaved``
#: (virtual-stage 1F1B with ``chunks`` chunks a rank) and ``zero_bubble``
#: (each backward split into an activation-grad unit B and a deferrable
#: weight-grad unit W)
SCHEDULE_FAMILIES = ("1f1b", "interleaved", "zero_bubble")

# unit kinds in the per-tick ``kind`` table
KIND_IDLE, KIND_F, KIND_B, KIND_W = 0, 1, 2, 3


def _interleaved_orders(S: int, M: int, v: int, r: int):
    """Megatron-style unit orders for rank ``r``: microbatch waves of
    size ``S``, chunks round-robin within a wave (forward ascending,
    backward descending)."""
    def waves(rev):
        out = []
        for w in range(0, M, S):
            cs = reversed(range(v)) if rev else range(v)
            for c in cs:
                for j in range(w, min(w + S, M)):
                    out.append((c * S + r, j))
        return out
    f_units, b_units = waves(False), waves(True)
    warm = min(len(f_units), (S - r - 1) * 2 + (v - 1) * S)
    seq = [("F",) + u for u in f_units[:warm]]
    fi, bi = warm, 0
    while fi < len(f_units) or bi < len(b_units):
        if fi < len(f_units):
            seq.append(("F",) + f_units[fi])
            fi += 1
        if bi < len(b_units):
            seq.append(("B",) + b_units[bi])
            bi += 1
    return seq


def simulate_schedule(family: str, num_stages: int, num_microbatches: int,
                      chunks: int = 1) -> Dict[str, Any]:
    """Simulate one member of the schedule family into the static
    per-tick tables the executor walks.

    ``S`` pipe ranks, ``V = S·chunks`` virtual stages, virtual stage ``k``
    on rank ``k % S`` as chunk ``k // S``; one unit a rank a tick; a hop
    takes one tick.  ``idle_slots`` is the raw count of idle (tick, rank)
    cells; ``bubble_ticks = work_rate·T·S − 2·M·S`` normalizes capacity
    to base-stage work (``work_rate`` 1 for 1f1b, 1/v interleaved, 2/3
    zero-bubble) and ``bubble_frac`` is its share of capacity."""
    S, M, v = int(num_stages), int(num_microbatches), int(chunks)
    if family not in SCHEDULE_FAMILIES:
        raise InvalidArgumentError(
            f"simulate_schedule: unknown family {family!r} "
            f"(one of {SCHEDULE_FAMILIES})")
    if family != "interleaved":
        v = 1
    if S < 1 or M < 1 or v < 1:
        raise InvalidArgumentError(
            f"simulate_schedule: S={S}, M={M}, chunks={v} invalid")
    V = S * v
    has_w = family == "zero_bubble"
    fwd_tick = [[None] * M for _ in range(V)]
    bwd_tick = [[None] * M for _ in range(V)]
    w_tick = [[None] * M for _ in range(V)]
    fwd_n = [0] * V
    bwd_n = [0] * V
    w_n = [0] * V
    seqs = [_interleaved_orders(S, M, v, r) for r in range(S)] \
        if family == "interleaved" else None
    ptr = [0] * S

    def units_left():
        if seqs is not None:
            return any(ptr[r] < len(seqs[r]) for r in range(S))
        if has_w:
            return any(w_n[k] < M for k in range(V)) \
                or any(bwd_n[k] < M for k in range(1, V))
        return any(b < M for b in bwd_n)

    rows = []            # rows[t][r] = (kind, vstage, mb) or None
    t = 0
    limit = 8 * (M * v * 3 + V) + 32
    while units_left() and t < limit:
        row = [None] * S
        for r in range(S):
            if seqs is not None:
                # sequence-driven (interleaved): execute the fixed unit
                # order, stalling on unmet hop dependencies
                if ptr[r] >= len(seqs[r]):
                    continue
                ph, k, j = seqs[r][ptr[r]]
                if ph == "F":
                    if k == 0 or (fwd_tick[k - 1][j] is not None
                                  and fwd_tick[k - 1][j] < t):
                        row[r] = (KIND_F, k, j)
                        fwd_tick[k][j] = t
                        fwd_n[k] += 1
                        ptr[r] += 1
                else:
                    f_ok = fwd_tick[k][j] is not None \
                        and fwd_tick[k][j] < t
                    up_ok = (k == V - 1) or (
                        bwd_tick[k + 1][j] is not None
                        and bwd_tick[k + 1][j] < t)
                    if f_ok and up_ok:
                        row[r] = (KIND_B, k, j)
                        bwd_tick[k][j] = t
                        bwd_n[k] += 1
                        ptr[r] += 1
                continue
            # greedy families (1f1b / zero_bubble): priority B > F > W
            k = r
            j = bwd_n[k]
            if j < M and not (has_w and k == 0):
                bwd_ready = (
                    (k == V - 1 and fwd_tick[k][j] is not None
                     and fwd_tick[k][j] < t) or
                    (k < V - 1 and bwd_tick[k + 1][j] is not None
                     and bwd_tick[k + 1][j] < t))
                if bwd_ready:
                    row[r] = (KIND_B, k, j)
                    bwd_tick[k][j] = t
                    bwd_n[k] += 1
                    continue
            # zero_bubble relaxes the warm-up cap (ZB-H2 style)
            cap = min(M, 2 * (S - r)) if has_w else (S - r)
            i = fwd_n[k]
            if i < M and (fwd_n[k] - bwd_n[k]) < cap and (
                    k == 0 or (fwd_tick[k - 1][i] is not None
                               and fwd_tick[k - 1][i] < t)):
                row[r] = (KIND_F, k, i)
                fwd_tick[k][i] = t
                fwd_n[k] += 1
                continue
            if has_w:
                j = w_n[k]
                if j < M:
                    if k == 0:
                        w_ready = (
                            (V == 1 and fwd_tick[0][j] is not None
                             and fwd_tick[0][j] < t) or
                            (V > 1 and bwd_tick[1][j] is not None
                             and bwd_tick[1][j] < t))
                    else:
                        w_ready = bwd_tick[k][j] is not None \
                            and bwd_tick[k][j] < t
                    if w_ready:
                        row[r] = (KIND_W, k, j)
                        w_tick[k][j] = t
                        w_n[k] += 1
                        if k == 0:
                            bwd_n[k] += 1   # the merged stage-0 backward
        rows.append(row)
        t += 1
    if units_left():
        raise AssertionError(
            f"simulate_schedule: simulation did not converge "
            f"(family={family}, S={S}, M={M}, chunks={v})")
    T = t

    # per-tick tables (kind / virtual stage / microbatch per rank)
    kind_rows = [[KIND_IDLE] * S for _ in range(T)]
    vstage_rows = [[0] * S for _ in range(T)]
    mb_rows = [[-1] * S for _ in range(T)]
    for tick, row in enumerate(rows):
        for r, u in enumerate(row):
            if u is not None:
                kind_rows[tick][r] = u[0]
                vstage_rows[tick][r] = u[1]
                mb_rows[tick][r] = u[2]

    # arrivals: virtual stage k's input for microbatch j lands on rank
    # k % S one tick after stage k−1 produced it; the grad of stage k's
    # output lands one tick after B(k+1, j) ran downstream
    arr_c = [[-1] * S for _ in range(T)]
    arr_mb = [[-1] * S for _ in range(T)]
    ct_c = [[-1] * S for _ in range(T)]
    ct_mb = [[-1] * S for _ in range(T)]
    for k in range(1, V):
        r = k % S
        for j in range(M):
            ta = fwd_tick[k - 1][j] + 1
            if ta < T:
                arr_c[ta][r] = k // S
                arr_mb[ta][r] = j
    for k in range(V - 1):
        r = k % S
        for j in range(M):
            if bwd_tick[k + 1][j] is None:
                continue
            ta = bwd_tick[k + 1][j] + 1
            if ta < T:
                ct_c[ta][r] = k // S
                ct_mb[ta][r] = j

    def _ring(arrive_of, release_of, ks):
        # slot j % W must be free when microbatch j + W arrives
        need = 1
        for k in ks:
            for j in range(M):
                a = arrive_of(k, j)
                if a is None:
                    continue
                for p in range(j):
                    rel = release_of(k, p)
                    if rel is not None and rel >= a:
                        need = max(need, j - p + 1)
        return min(max(need, 1), M) if M else 1

    def _release(k, p):
        rel = bwd_tick[k][p]
        if has_w and w_tick[k][p] is not None:
            rel = w_tick[k][p] if rel is None else max(rel, w_tick[k][p])
        return rel

    slots = _ring(lambda k, j: (fwd_tick[k - 1][j] + 1)
                  if fwd_tick[k - 1][j] is not None else None,
                  _release, range(1, V))
    ct_slots = _ring(lambda k, j: (bwd_tick[k + 1][j] + 1)
                     if bwd_tick[k + 1][j] is not None else None,
                     _release, range(V - 1))

    order = []
    phase_of = {KIND_F: "F", KIND_B: "B", KIND_W: "W"}
    for tick, row in enumerate(rows):
        for r, u in enumerate(row):
            if u is not None:
                order.append((tick, u[1], phase_of[u[0]], u[2]))

    busy = sum(1 for row in rows for u in row if u is not None)
    idle_slots = T * S - busy
    work_rate = (1.0 / v) if family == "interleaved" else (
        2.0 / 3.0 if has_w else 1.0)
    bubble_ticks = work_rate * T * S - 2.0 * M * S
    capacity = work_rate * T * S
    sch = {"family": family, "num_stages": V, "num_ranks": S,
           "chunks": v, "num_microbatches": M, "ticks": T,
           "kind": kind_rows, "vstage": vstage_rows, "mb": mb_rows,
           "arr_c": arr_c, "arr_mb": arr_mb,
           "ct_arr_c": ct_c, "ct_arr_mb": ct_mb,
           "slots": slots, "ct_slots": ct_slots,
           "order": order, "idle_slots": idle_slots,
           "work_rate": work_rate,
           "bubble_ticks": bubble_ticks,
           "bubble_frac": (bubble_ticks / capacity) if capacity else 0.0}
    if v == 1:
        # per-stage tables (the non-interleaved census format)
        fwd_rows = [[-1] * S for _ in range(T)]
        bwd_rows = [[-1] * S for _ in range(T)]
        for tick, row in enumerate(rows):
            for r, u in enumerate(row):
                if u is None:
                    continue
                if u[0] == KIND_F:
                    fwd_rows[tick][r] = u[2]
                elif u[0] == KIND_B:
                    bwd_rows[tick][r] = u[2]
        sch["fwd"] = fwd_rows
        sch["bwd"] = bwd_rows
        sch["arrive"] = [[arr_mb[tk][s] if arr_c[tk][s] == 0 else -1
                          for s in range(S)] for tk in range(T)]
    return sch


def schedule_1f1b(num_stages: int, num_microbatches: int) -> Dict[str, Any]:
    """The canonical non-interleaved 1F1B schedule (one row of
    :func:`simulate_schedule`)."""
    return simulate_schedule("1f1b", num_stages, num_microbatches)


def enumerate_schedules(num_stages: int, num_microbatches: int,
                        max_chunks: int = 2) -> List[Dict[str, Any]]:
    """Every schedule-family candidate for ``(S, M)`` sorted by exact
    ``bubble_ticks`` (ties toward the simpler family, 1f1b first)."""
    S, M = int(num_stages), int(num_microbatches)
    cands = [simulate_schedule("1f1b", S, M)]
    for v in range(2, int(max_chunks) + 1):
        cands.append(simulate_schedule("interleaved", S, M, chunks=v))
    cands.append(simulate_schedule("zero_bubble", S, M))
    rank = {f: i for i, f in enumerate(SCHEDULE_FAMILIES)}
    cands.sort(key=lambda c: (c["bubble_ticks"], rank[c["family"]]))
    return cands


# ---------------------------------------------------------------------------
# the pipeline rewrite
# ---------------------------------------------------------------------------


def set_microbatches(program: Program, num_microbatches: int):
    """Stamp the per-step microbatch accumulation WITHOUT stage cuts: the
    executor runs the feeds in ``num_microbatches`` slices, accumulating
    ``(1/M) Σ grads`` — the arithmetic of ``GradientMergeOptimizer`` over
    the same microbatch stream (bit for bit at M = 2)."""
    block, ops, bw_idx = _fwd_region(program)
    if bw_idx is None:
        raise InvalidArgumentError(
            "set_microbatches: program has no backward op")
    M = int(num_microbatches)
    if M < 1:
        raise InvalidArgumentError(f"num_microbatches={M} < 1")
    bw = ops[bw_idx]
    bw.attrs["pipe_microbatches"] = M
    bw.attrs["pipe_feed_names"] = sorted(
        v.name for v in block.vars.values() if v.is_data)
    program._bump_version()
    return bw


def apply_pipeline(program: Program, num_stages: int,
                   num_microbatches: int, pipe_axis: str = PIPE_AXIS,
                   feed_shapes=None,
                   plan: Optional[StageCutPlan] = None,
                   schedule: str = "1f1b", chunks: int = 1,
                   shard_weights: bool = False,
                   min_shard_numel: Optional[int] = None) -> Dict[str, Any]:
    """Rewrite ``program`` in place for ``num_stages``-way pipeline
    parallelism over ``pipe_axis`` under one of the
    :data:`SCHEDULE_FAMILIES` (``chunks``: the virtual stages a rank for
    ``interleaved``).  Call after ``optimizer.minimize`` and before
    ``CompiledProgram.with_mesh``.  Idempotent per program.

    The rewrite is metadata and boundary ops only: the same program runs
    unpipelined (its microbatches accumulated) on a mesh without the pipe
    axis — the pipe = 1 run the pipelined one is held to.
    ``shard_weights=True`` also stamps pipe-axis ``ShardSpec`` entries
    (:func:`apply_pipe_weight_sharding`)."""
    S = int(num_stages)
    M = int(num_microbatches)
    v = int(chunks)
    if M < 1:
        raise InvalidArgumentError(f"num_microbatches={M} < 1")
    if schedule not in SCHEDULE_FAMILIES:
        raise InvalidArgumentError(
            f"apply_pipeline: unknown schedule {schedule!r} "
            f"(one of {SCHEDULE_FAMILIES})")
    if schedule != "interleaved":
        v = 1
    if v < 1:
        raise InvalidArgumentError(f"chunks={v} < 1")
    block, ops, bw_idx = _fwd_region(program)
    if bw_idx is None:
        raise InvalidArgumentError(
            "apply_pipeline: program has no backward op — pipeline "
            "partitions TRAINING programs (run minimize first)")
    bw = ops[bw_idx]
    if bw.attrs.get("pipe_stages"):
        return {"already_pipelined": True,
                "num_stages": bw.attrs["pipe_stages"]}
    if S < 2:
        set_microbatches(program, M)
        return {"num_stages": 1, "num_microbatches": M, "cuts": [],
                "boundaries": [], "boundary_bytes": []}
    if bw.attrs.get("loss_scale_var"):
        raise InvalidArgumentError(
            "apply_pipeline: dynamic loss scaling (AMP fp16) does not "
            "compose with the scheduled pipeline lowering — use "
            "pure-bf16 AMP or static loss_scale")
    # the PROGRAM is cut into V = S·chunks virtual stages; rank k % S
    # owns virtual stage k as chunk k // S
    V = S * v
    plan = plan or plan_stage_cuts(program, V, feed_shapes=feed_shapes)

    fwd_ops = ops[:bw_idx]
    edges = [0] + list(plan.cuts) + [len(fwd_ops)]
    for s, (a, b) in enumerate(zip(edges, edges[1:])):
        for op in fwd_ops[a:b]:
            op.attrs["_pipe_stage"] = s

    # boundary ops (descending cut order keeps earlier indices valid):
    # the in-place identity on the crossing names
    for i in reversed(range(len(plan.cuts))):
        c = plan.cuts[i]
        names = plan.boundaries[i]
        pos = block.ops.index(fwd_ops[c])
        block._insert_op(
            pos, type=BOUNDARY_OP,
            inputs={"X": list(names)}, outputs={"Out": list(names)},
            attrs={"_axis_name": pipe_axis, "_pipe_cut": int(i),
                   "_pipe_stage": int(i),
                   "boundary_bytes": int(plan.boundary_bytes[i])})

    sch = simulate_schedule(schedule, S, M, chunks=v)
    bw.attrs["pipe_stages"] = V
    bw.attrs["pipe_chunks"] = v
    bw.attrs["pipe_schedule"] = schedule
    bw.attrs["pipe_microbatches"] = M
    bw.attrs["pipe_axis"] = pipe_axis
    bw.attrs["pipe_boundaries"] = [list(b) for b in plan.boundaries]
    bw.attrs["pipe_cuts"] = list(plan.cuts)
    bw.attrs["pipe_ring_slots"] = [int(sch["slots"]),
                                   int(sch["ct_slots"])]
    bw.attrs["pipe_schedule_order"] = [list(u) for u in sch["order"]]
    bw.attrs["pipe_feed_names"] = sorted(
        v2.name for v2 in block.vars.values() if v2.is_data)

    shard_report = None
    if shard_weights:
        shard_report = apply_pipe_weight_sharding(
            program, pipe_axis=pipe_axis, pipe_degree=S,
            min_shard_numel=min_shard_numel)

    from .compiler import insert_pipe_grad_sync
    sync_ops = insert_pipe_grad_sync(program, pipe_axis)
    program._bump_version()
    report = plan.as_dict()
    report.update({"num_microbatches": M, "pipe_axis": pipe_axis,
                   "num_ranks": S, "chunks": v,
                   "grad_sync_ops": sync_ops,
                   "schedule": sch})
    if shard_report is not None:
        report["weight_sharding"] = shard_report
    return report


def apply_pipe_weight_sharding(program: Program,
                               pipe_axis: str = PIPE_AXIS,
                               pipe_degree: int = 1,
                               min_shard_numel: Optional[int] = None
                               ) -> Dict[str, Any]:
    """Stamp pipe-axis ``ShardSpec`` entries so each pipe rank holds a
    1/``pipe_degree`` block of every eligible parameter, its gradient
    and its same-shaped optimizer accumulators.  The pipelined lowering
    all-gathers the blocks once before its walk and reduce-scatters the
    accumulated gradients once after it (the scatter is their
    cross-stage sum, so ``compiler.insert_pipe_grad_sync`` skips them).
    On a mesh without the pipe axis the stamps are inert."""
    from .fsdp import DEFAULT_MIN_SHARD_NUMEL, _shard_dim
    from .mesh_layout import ShardSpec
    degree = int(pipe_degree)
    if degree < 2:
        return {"sharded": {}, "skipped": {}, "pipe_degree": degree}
    if min_shard_numel is None:
        min_shard_numel = DEFAULT_MIN_SHARD_NUMEL
    block, ops, bw_idx = _fwd_region(program)
    read_in_fwd = set()
    for op in ops[:bw_idx if bw_idx is not None else len(ops)]:
        read_in_fwd.update(op.input_names())
    sharded: Dict[str, Any] = {}
    skipped: Dict[str, str] = {}
    for p in program.all_parameters():
        if getattr(p, "dist_attr", None):
            skipped[p.name] = "already-sharded"
            continue
        numel = int(np.prod(p.shape)) if p.shape else 0
        if numel < int(min_shard_numel):
            skipped[p.name] = "below-min-shard-numel"
            continue
        dim = _shard_dim(p.shape, degree)
        if dim is None:
            skipped[p.name] = "no-divisible-dim"
            continue
        if p.name not in read_in_fwd:
            skipped[p.name] = "not-read-in-forward"
            continue
        spec = ShardSpec(tuple(pipe_axis if d == dim else None
                               for d in range(len(p.shape)))
                         or (pipe_axis,))
        p.dist_attr = spec
        g = block.vars.get(grad_var_name(p.name))
        if g is not None:
            g.dist_attr = spec
        # the optimizer state: any same-shaped persistable an update op
        # touching this param / grad reads or writes shards along
        if bw_idx is not None:
            coupled = {p.name, grad_var_name(p.name)}
            for op in ops[bw_idx:]:
                names = set(op.input_names()) | set(op.output_names())
                if not (names & coupled):
                    continue
                for n in names:
                    var = block.vars.get(n)
                    if (var is not None and var.persistable
                            and tuple(var.shape) == tuple(p.shape)
                            and not getattr(var, "dist_attr", None)):
                        var.dist_attr = spec
        sharded[p.name] = {"dim": int(dim), "numel": numel,
                           "shard_numel": numel // degree}
    if bw_idx is not None:
        normed = sorted({n for op in ops[bw_idx:]
                         if op.type == "squared_l2_norm"
                         for n in op.input_names()}
                        & {grad_var_name(n) for n in sharded})
        if normed:
            raise InvalidArgumentError(
                f"apply_pipe_weight_sharding: a global-norm clip reads the "
                f"gradients {normed[:3]}..., which the pipelined lowering "
                f"reduce-scatters over {pipe_axis!r}: each rank would clip "
                f"by its own blocks' norm; drop the clip or shard_weights")
        ops[bw_idx].attrs["pipe_sharded_params"] = {
            n: int(info["dim"]) for n, info in sharded.items()}
    program._bump_version()
    return {"sharded": sharded, "skipped": skipped,
            "pipe_degree": degree, "pipe_axis": pipe_axis}


# ---------------------------------------------------------------------------
# activation rematerialization
# ---------------------------------------------------------------------------

#: the random ops whose draws a recompute segment replays
RNG_OP_TYPES = frozenset({
    "dropout", "uniform_random", "gaussian_random",
    "truncated_gaussian_random", "uniform_random_batch_size_like", "seed",
})


class RematPlan:
    """A candidate recompute insertion: segment boundaries + pricing."""

    def __init__(self, checkpoints, positions, num_segments, est_before,
                 est_after, flops_delta, fits):
        self.checkpoints = list(checkpoints)
        self.positions = list(positions)
        self.num_segments = int(num_segments)
        self.est_before = est_before
        self.est_after = est_after
        self.flops_delta = float(flops_delta)
        self.fits = bool(fits)

    def as_dict(self) -> Dict[str, Any]:
        return {"checkpoints": list(self.checkpoints),
                "positions": list(self.positions),
                "num_segments": self.num_segments,
                "peak_bytes_before": int(self.est_before.peak_bytes),
                "peak_bytes_after": int(self.est_after.peak_bytes),
                "recompute_flops_delta": self.flops_delta,
                "fits": self.fits}


def plan_remat(program: Program, feed_shapes=None,
               fetch_names=(), mesh_axes: Optional[Dict[str, int]] = None,
               batch_axis=None, seq_axis=None,
               budget_gb: Optional[float] = None,
               donate_state: bool = True,
               max_segments: int = 16) -> Optional[RematPlan]:
    """Pick recompute ``checkpoints`` at the liveness-identified residual
    minima and price the trade (the JAX package's search): the retained
    per-rank peak after (``memory_analysis.analyze_memory``) against the
    forward FLOPs of re-running every non-final segment once in the
    backward.  Segment counts are tried smallest first (2, 4, 8, ...):
    the cheapest plan that fits ``budget_gb`` wins; with no budget, or
    nothing fitting, the deepest plan evaluated is returned (``fits``
    says which).  The shapes are the static estimate's
    (``memory_analysis.shape_env``).  None when the program has no
    backward op or already carries checkpoints."""
    from .memory_analysis import _feed_sigs as _ma_feed_sigs
    from .memory_analysis import analyze_memory, shape_env
    block, ops, bw_idx = _fwd_region(program)
    if bw_idx is None:
        return None
    bw = ops[bw_idx]
    if bw.attrs.get("checkpoints"):
        return None
    fwd_ops = ops[:bw_idx]
    F = len(fwd_ops)
    if F < 4:
        return None
    feed_sigs = _ma_feed_sigs(program, feed_shapes, 1)
    env = shape_env(program, feed_sigs)
    def_idx, last_use = _fwd_liveness(block, fwd_ops)
    flops = _per_op_flops(block, fwd_ops, env)
    fprefix = np.concatenate([[0.0], np.cumsum(flops)])

    cost: Dict[int, int] = {}
    for c in range(1, F):
        # the checkpoint marker is an output of op c-1
        if not fwd_ops[c - 1].output_names():
            continue
        names, b = _boundary_at(block, fwd_ops, c, def_idx, last_use,
                                env, feed_sigs)
        if b is None:
            continue
        cost[c] = b
    if not cost:
        return None
    positions = sorted(cost)

    kw = dict(feed_shapes=feed_shapes, fetch_names=list(fetch_names),
              mesh_axes=mesh_axes, batch_axis=batch_axis,
              seq_axis=seq_axis, donate_state=donate_state)
    est_before = analyze_memory(program, **kw)

    def pick(K):
        """K-1 cut positions: the least-boundary candidate inside each
        even-spacing window."""
        chosen = []
        for k in range(1, K):
            center = k * F / K
            half = max(F / (2 * K), 1.0)
            window = [c for c in positions
                      if center - half <= c <= center + half
                      and c not in chosen]
            if not window:
                window = [c for c in positions if c not in chosen]
                if not window:
                    return None
                window = [min(window, key=lambda c: abs(c - center))]
            chosen.append(min(window, key=lambda c: (cost[c], c)))
        return sorted(chosen)

    best: Optional[RematPlan] = None
    K = 2
    while K <= min(int(max_segments), F):
        cuts = pick(K)
        if cuts is None:
            break
        markers = [fwd_ops[c - 1].output_names()[0] for c in cuts]
        clone = program.clone()
        _, cops, cbw = _fwd_region(clone)
        cops[cbw].attrs["checkpoints"] = list(markers)
        est_after = analyze_memory(clone, **kw)
        # every non-final segment's forward re-runs once in the backward
        delta = float(fprefix[cuts[-1]])
        fits = budget_gb is not None and \
            est_after.peak_gb <= float(budget_gb)
        cand = RematPlan(markers, cuts, K, est_before, est_after,
                         delta, fits)
        if fits:
            return cand
        if best is None or est_after.peak_bytes < \
                best.est_after.peak_bytes:
            best = cand
        K *= 2
    return best


def apply_remat(program: Program, plan: RematPlan):
    """Apply a :class:`RematPlan` to the program: set the backward op's
    ``checkpoints``, which the executor's recompute segments run
    (``executor.run_forward``: each segment but the last under
    ``torch.utils.checkpoint``, its random ops replayed from the run
    generator's state at the segment's entry), and stamp ``_folded_key``
    on the random ops inside the recompute regions, as the JAX package
    does.  Returns the backward op."""
    block, ops, bw_idx = _fwd_region(program)
    if bw_idx is None:
        raise InvalidArgumentError("apply_remat: no backward op")
    bw = ops[bw_idx]
    bw.attrs["checkpoints"] = list(plan.checkpoints)
    last_cut = max(plan.positions) if plan.positions else 0
    for op in ops[:last_cut]:
        if op.type in RNG_OP_TYPES:
            op.attrs["_folded_key"] = True
    program._bump_version()
    return bw
