"""Static liveness and per-rank peak-memory analysis of a Program — the
port of paddle_tpu/framework/memory_analysis.py.

Everything is computed from the Program IR, with no launch and no device
allocation:

* **shapes** — the JAX package walks its op specs' ``infer`` channel
  (``analysis.infer_shapes``).  The port runs the program once on
  ``meta`` tensors instead (``registry.abstract_eval``, as the stage-cut
  planner of ``framework/pipe.py`` does), the ``backward`` op giving
  every parameter's gradient its parameter's signature.  So that both
  packages price the same program alike, :func:`shape_env` keeps the
  JAX package's view: an op whose shapes the JAX package does not infer
  (``pipe.SHAPE_INFERRED_OPS``), or one reading a value of unknown
  extent, leaves its outputs at their declared signatures (−1 dims
  priced at ``unknown_dim``);
* **liveness** — per-block def / last-use intervals
  (``framework/liveness.py``, the one copy of them in the port);
* **the per-rank peak estimate** — every variable priced at the width
  the card holds it (:data:`~..ops.registry.DTYPE_BYTES`: int64 ids stay
  8 bytes, where the JAX package, its x64 off, prices 4) and divided by
  its mesh sharding: persistables by their ``dist_attr`` axes, feeds by
  their feed spec (default the batch axis on dim 0), activations by the
  batch x sequence axes; donated state counted once;
* **the lint profile** — donation gaps, fetch-induced retention and
  gradient-accumulation doubling;
* **the wire and exposed-communication model** — each collective's ring
  cost through the ``wire`` channel of ``ops/op_specs.py``
  (:func:`collective_wire_summary`), and the step-time roofline the
  auto-shard planner ranks layouts by (:func:`exposed_comm_model`, its
  link bandwidth ``flag("link_gbps")`` and peak
  ``observability.flops.device_peak_flops``).

The transient model is the JAX package's, as it was fitted there to
XLA's buffer assignment::

    transient = RESIDUAL_FACTOR x sum of residual classes
              + op-internal backward extras (the mem channel)
              + grads (programs with grad-sync collectives)

The port's executor allocates differently (it keeps every value of a run
until the run ends), so the estimate orders layouts as the JAX planner
does but need not match ``torch.cuda.max_memory_allocated``.

Wired in three places: ``flag("hbm_budget_gb")`` makes
``Executor.prepare``, ``Executor.run`` and ``CompiledProgram.with_mesh``
raise ``InvalidArgumentError`` before any launch when the estimate
exceeds the budget (:func:`check_hbm_budget`); the auto-shard planner
(``framework/shard_planner.py``) prices layouts with it; the paged decode
engine sizes its pool with :func:`plan_cache_pool`."""

from __future__ import annotations

from collections import OrderedDict
from typing import Any, Dict, Iterable, List, Optional, Tuple

from .core import Block, Program, grad_var_name
from .errors import InvalidArgumentError
from .liveness import (Interval, _iter_sub_blocks, block_liveness,
                       op_reads_recursive, program_liveness)

# lint codes (warning severity: retention smells, not malformed programs)
DONATION_GAP = "donation-gap"
FETCH_RETENTION = "fetch-retention"
GRAD_ACCUM_DOUBLING = "grad-accum-doubling"

#: forward residual + in-flight cotangents during the reverse sweep, per
#: residual class (the JAX package's figure, fitted to XLA)
RESIDUAL_FACTOR = 1.5

#: op types with no shape opinion and no memory opinion
META_OPS = frozenset({"feed", "fetch", "backward", "pipeline"})

_GIB = float(1 << 30)


# ---------------------------------------------------------------------------
# byte pricing
# ---------------------------------------------------------------------------


def sig_bytes(sig, unknown_dim: int = 1) -> int:
    """Bytes one VarSig takes on the card, unknown dims priced at
    ``unknown_dim``."""
    if sig is None or sig.shape is None:
        return 0
    from ..ops.registry import dtype_nbytes
    n = 1
    for d in sig.shape:
        d = int(d)
        n *= d if d > 0 else unknown_dim
    return n * dtype_nbytes(sig.dtype)


def _axis_divisor(axes, mesh_axes: Dict[str, int]) -> int:
    """Product of mesh-axis sizes over ``axes`` (names, None, or nested
    tuples of names)."""
    from .mesh_layout import _flat_axes
    div = 1
    for a in _flat_axes(axes):
        div *= int(mesh_axes.get(a, 1))
    return div


def _var_sig(v):
    """Declared VarSig of a Variable (None-safe)."""
    if v is None:
        return None
    from ..ops.op_specs import VarSig
    return VarSig(tuple(v.shape) or None, v.dtype)


def _declared_sig(block: Block, name: str):
    """A variable's declared signature; a declared () counts as unknown."""
    from ..ops.op_specs import VarSig
    v = block._find_var_recursive(name)
    if v is None:
        return None
    shape = tuple(v.shape)
    return VarSig(shape if shape else None, v.dtype)


def _dtype_str(dtype) -> str:
    return str(dtype).replace("torch.", "")


# ---------------------------------------------------------------------------
# shapes: a forward on meta tensors, kept to the JAX package's view
# ---------------------------------------------------------------------------


def _feed_sigs(program: Program, feed_shapes, unknown_dim: int):
    """Concrete (or declared-fallback) VarSigs of the feed roots:
    ``feed_shapes`` maps names to arrays, tensors or ``(shape, dtype)``
    pairs; every other data var takes its declared shape, −1 read as
    ``unknown_dim``."""
    from ..ops.op_specs import VarSig
    block = program.global_block()
    sigs: Dict[str, Any] = {}
    for name, v in (feed_shapes or {}).items():
        if hasattr(v, "shape") and hasattr(v, "dtype"):
            sigs[name] = VarSig(tuple(v.shape), _dtype_str(v.dtype))
        else:
            shape, dtype = v
            sigs[name] = VarSig(tuple(shape), _dtype_str(dtype))
    for name, v in block.vars.items():
        if v.is_data and name not in sigs:
            shape = tuple(int(d) if int(d) > 0 else unknown_dim
                          for d in v.shape)
            sigs[name] = VarSig(shape, v.dtype)
    return sigs


def _unknown(sig) -> bool:
    return sig is None or sig.shape is None or \
        any(int(d) < 0 for d in sig.shape)


_ENV_CACHE: "OrderedDict[tuple, Dict[str, Any]]" = OrderedDict()
_ENV_CACHE_CAP = 32


def shape_env(program: Program, feed_sigs: Dict[str, Any]
              ) -> Dict[str, Any]:
    """``{name: VarSig}`` of every value the global block produces, as
    the JAX package's static shapes see it: each op run on ``meta``
    tensors of its inputs' signatures (no kernel, no launch, nothing
    counted), the ``backward`` op giving each parameter's gradient the
    parameter's signature.  An input dim of unknown extent (−1) is run at
    two sizes, and an output dim that follows it stays −1; the result is
    merged into the declared signature as the JAX package merges its
    inferred one.  An op the JAX package infers no shape for (not in
    ``pipe.SHAPE_INFERRED_OPS``), or one that cannot run on meta tensors,
    leaves its outputs at their declared signatures.  Cached per
    (program, version, feeds)."""
    block = program.global_block()
    key = (program._uid, program._version, len(block.ops),
           len(block.vars),
           tuple(sorted((n, s.shape, s.dtype) for n, s in feed_sigs.items())))
    hit = _ENV_CACHE.get(key)
    if hit is not None:
        _ENV_CACHE.move_to_end(key)
        return hit
    env = _shape_env(program, feed_sigs)
    _ENV_CACHE[key] = env
    if len(_ENV_CACHE) > _ENV_CACHE_CAP:
        _ENV_CACHE.popitem(last=False)
    return env


def _merge_sig(declared, inferred):
    """The JAX package's merge of an inferred signature into the declared
    one: the inferred dims where known, the declared ones elsewhere."""
    from ..ops.op_specs import VarSig
    if declared is None or declared.shape is None:
        return inferred
    if inferred.shape is None:
        return VarSig(declared.shape, inferred.dtype)
    if len(declared.shape) != len(inferred.shape):
        return inferred
    return VarSig(tuple(d if i < 0 else i for d, i in
                        zip(declared.shape, inferred.shape)),
                  inferred.dtype)


#: sizes an unknown (−1) dim takes in the two meta runs of an op: a dim
#: of the outputs that differs between them is unknown too
_PROBE_DIMS = (1, 7)


def _run_meta(op, sigs, probe: int):
    """Run ``op`` once on meta tensors of ``sigs`` (−1 dims at ``probe``);
    ``{name: (shape, dtype)}`` of its outputs, or None if it cannot run
    there."""
    import torch
    from ..ops.registry import LoweringContext, abstract_eval
    from .executor import run_ops
    from .pipe import _torch_dtype
    meta = torch.device("meta")
    env = {}
    try:
        for n, sig in sigs.items():
            env[n] = torch.empty(
                tuple(int(d) if int(d) >= 0 else probe for d in sig.shape),
                dtype=_torch_dtype(sig.dtype), device=meta)
        with abstract_eval(), torch.no_grad():
            run_ops([op], env, LoweringContext(None, meta))
    except Exception:
        return None
    out = {}
    for n in op.output_names():
        t = env.get(n)
        if t is not None and hasattr(t, "shape"):
            out[n] = (tuple(t.shape), _dtype_str(t.dtype))
    return out


def _shape_env(program: Program, feed_sigs: Dict[str, Any]):
    from ..ops.op_specs import VarSig
    from .pipe import INFERRED_SLOTS, SHAPE_INFERRED_OPS

    block = program.global_block()
    env: Dict[str, Any] = dict(feed_sigs)

    def sig_of(name):
        if name in env:
            return env[name]
        return _declared_sig(block, name)

    for op in block.ops:
        if op.type in META_OPS:
            if op.type == "backward":
                # the gradients take their parameters' signatures
                for pname in op.attrs.get("param_names", ()):
                    psig = sig_of(pname)
                    if psig is not None:
                        env[grad_var_name(pname)] = psig
            continue
        outs = None
        if op.type in SHAPE_INFERRED_OPS:
            sigs = {n: sig_of(n) for n in op_reads_recursive(op)}
            if all(s is not None and s.shape is not None
                   for s in sigs.values()):
                runs = [_run_meta(op, sigs, p) for p in
                        (_PROBE_DIMS if any(_unknown(s) for s in
                                            sigs.values())
                         else _PROBE_DIMS[:1])]
                if all(r is not None for r in runs):
                    outs = {}
                    for n, (shape, dtype) in runs[0].items():
                        other = runs[-1].get(n, (shape, dtype))[0]
                        outs[n] = VarSig(
                            tuple(a if a == b else -1
                                  for a, b in zip(shape, other))
                            if len(shape) == len(other) else shape, dtype)
        slots = INFERRED_SLOTS.get(op.type)
        covered = {n for slot, names in op.outputs.items()
                   if slots is None or slot in slots for n in names}
        for n in op.output_names():
            declared = _declared_sig(block, n)
            if outs is not None and n in outs and n in covered:
                env[n] = _merge_sig(declared, outs[n])
            elif declared is not None:
                env[n] = declared
    return env


def _sig_lookup(block: Block, env: Dict[str, Any]):
    """``sig_of(name)``: the env's signature when it has a shape, else the
    declared one (the JAX package's lookup)."""
    from ..ops.op_specs import VarSig

    def sig_of(name):
        s = env.get(name)
        if s is not None and s.shape is not None:
            return s
        v = block._find_var_recursive(name)
        if v is None:
            return s
        return VarSig(tuple(v.shape) or None, v.dtype)
    return sig_of


# ---------------------------------------------------------------------------
# the per-rank peak estimate
# ---------------------------------------------------------------------------


class LiveTensor:
    """One entry of the top-k live set at the peak point."""

    __slots__ = ("name", "nbytes", "kind", "op_type", "callstack")

    def __init__(self, name, nbytes, kind, op_type=None, callstack=()):
        self.name = name
        self.nbytes = int(nbytes)
        self.kind = kind               # param|opt-state|feed|activation
        self.op_type = op_type
        self.callstack = list(callstack or ())

    def format(self) -> str:
        loc = f" (op {self.op_type!r})" if self.op_type else ""
        line = f"{self.nbytes / (1 << 20):9.3f} MiB  {self.kind:<10s} " \
               f"{self.name}{loc}"
        if self.callstack:
            line += "\n" + "\n".join(f"        {f}"
                                     for f in self.callstack[-2:])
        return line


class MemoryEstimate:
    """Per-rank peak estimate and its components: ``peak_bytes =
    args_bytes + transient_bytes`` (donated outputs alias their inputs;
    non-aliased outputs are reported in ``output_bytes``)."""

    def __init__(self):
        self.feed_bytes = 0
        self.param_bytes = 0           # trainable persistables
        self.opt_state_bytes = 0       # non-trainable persistables
        self.rng_bytes = 8
        self.residual_bytes = 0        # sum of residual classes
        self.internal_bytes = 0        # op-internal backward extras
        self.grad_bytes = 0            # counted when collectives force it
        self.output_bytes = 0          # non-aliased outputs
        self.transient_bytes = 0
        # the grad-sync zone's wire accounting (the wire channel):
        # logical payload against the bytes the ring schedule moves;
        # reported, not part of the peak
        self.wire_logical_bytes = 0
        self.wire_bytes = 0
        self.peak_op_idx = None
        self.top_live: List[LiveTensor] = []
        self.mesh_axes: Dict[str, int] = {}
        self.notes: List[str] = []

    @property
    def args_bytes(self) -> int:
        return (self.feed_bytes + self.param_bytes + self.opt_state_bytes
                + self.rng_bytes)

    @property
    def state_bytes(self) -> int:
        return self.param_bytes + self.opt_state_bytes

    @property
    def peak_bytes(self) -> int:
        return self.args_bytes + self.transient_bytes

    @property
    def peak_gb(self) -> float:
        return self.peak_bytes / _GIB

    def as_dict(self) -> Dict[str, Any]:
        return {
            "peak_bytes": self.peak_bytes,
            "peak_gb": round(self.peak_gb, 6),
            "args_bytes": self.args_bytes,
            "feed_bytes": self.feed_bytes,
            "param_bytes": self.param_bytes,
            "opt_state_bytes": self.opt_state_bytes,
            "transient_bytes": self.transient_bytes,
            "residual_bytes": self.residual_bytes,
            "internal_bytes": self.internal_bytes,
            "grad_bytes": self.grad_bytes,
            "output_bytes": self.output_bytes,
            "wire_logical_bytes": self.wire_logical_bytes,
            "wire_bytes": self.wire_bytes,
            "wire_compression_ratio": round(
                self.wire_logical_bytes / self.wire_bytes, 3)
            if self.wire_bytes else 1.0,
            "mesh_axes": dict(self.mesh_axes),
            "peak_op_idx": self.peak_op_idx,
            "top_live": [{"name": t.name, "bytes": t.nbytes,
                          "kind": t.kind, "op_type": t.op_type}
                         for t in self.top_live],
            "notes": list(self.notes),
        }

    def report(self) -> str:
        mb = 1 << 20
        lines = [
            f"static per-rank peak memory estimate: "
            f"{self.peak_bytes / mb:.2f} MiB ({self.peak_gb:.4f} GiB)"
            + (f"  [mesh {self.mesh_axes}]" if self.mesh_axes else ""),
            f"  arguments  {self.args_bytes / mb:10.2f} MiB  "
            f"(feeds {self.feed_bytes / mb:.2f}, params "
            f"{self.param_bytes / mb:.2f}, opt state "
            f"{self.opt_state_bytes / mb:.2f})",
            f"  transient  {self.transient_bytes / mb:10.2f} MiB  "
            f"(residuals {self.residual_bytes / mb:.2f} x"
            f"{RESIDUAL_FACTOR}, op-internal "
            f"{self.internal_bytes / mb:.2f}, grads "
            f"{self.grad_bytes / mb:.2f})",
            f"  outputs    {self.output_bytes / mb:10.2f} MiB  "
            f"(non-aliased)",
        ]
        if self.wire_logical_bytes:
            ratio = (self.wire_logical_bytes / self.wire_bytes
                     if self.wire_bytes else 1.0)
            lines.append(
                f"  grad-sync wire {self.wire_bytes / mb:6.2f} MiB "
                f"(logical {self.wire_logical_bytes / mb:.2f} MiB, "
                f"compression {ratio:.2f}x)")
        if self.top_live:
            lines.append(f"  top live tensors at the peak point"
                         + (f" (op #{self.peak_op_idx})"
                            if self.peak_op_idx is not None else "") + ":")
            lines.extend("    " + t.format() for t in self.top_live)
        for n in self.notes:
            lines.append(f"  note: {n}")
        return "\n".join(lines)


def _state_names(program: Program, fetch_names) -> Tuple[List[str],
                                                         List[str]]:
    """(state_in, written_state): persistables read before being written
    (and fetched never-written ones), and persistables any op writes."""
    block = program.global_block()
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    written: set = set()
    state_in: List[str] = []
    for op in ops:
        for n in op.input_names():
            if n in written or n in state_in:
                continue
            var = block._find_var_recursive(n)
            if var is not None and var.persistable:
                state_in.append(n)
        written |= set(op.output_names())
    for n in fetch_names:
        var = block._find_var_recursive(n)
        if var is not None and var.persistable and n not in written and \
                n not in state_in:
            state_in.append(n)
    written_state = []
    for op in ops:
        for n in op.output_names():
            var = block._find_var_recursive(n)
            if var is not None and var.persistable and \
                    n not in written_state:
                written_state.append(n)
    return state_in, written_state


#: fusible op families without a spec opinion: their outputs join their
#: largest input's residual class
_TRANSPARENT_FALLBACK = frozenset({
    "reshape2", "reshape", "squeeze2", "unsqueeze2", "flatten2", "flatten",
    "scale", "assign", "cast", "clip", "relu", "gelu", "tanh", "sigmoid",
    "dropout", "softmax", "elementwise_add", "elementwise_sub",
    "elementwise_mul",
})


def _op_transparent(op_type: str) -> bool:
    from ..ops.registry import OP_SPECS
    spec = OP_SPECS.get(op_type)
    if spec is not None and spec.mem_transparent is not None:
        return bool(spec.mem_transparent)
    return op_type in _TRANSPARENT_FALLBACK


def _op_backward_extra(op, env) -> int:
    """Op-internal bytes kept for the backward beyond named variables
    (the mem channel)."""
    from ..ops.registry import OP_SPECS
    spec = OP_SPECS.get(op.type)
    fn = spec.mem_backward_extra if spec is not None else None
    if fn is None:
        return 0
    ins = {slot: [env.get(n) for n in names]
           for slot, names in op.inputs.items()}
    outs = {slot: [env.get(n) for n in names]
            for slot, names in op.outputs.items()}
    try:
        return int(fn(ins, outs, op.attrs) or 0)
    except Exception:       # an accounting bug must not kill the analyzer
        return 0


def mem_uncovered_suspects(program: Program) -> list:
    """Op types in ``program`` with no memory opinion: neither a spec
    ``mem_transparent`` / ``mem_backward_extra`` channel nor membership in
    the transparent fallback set."""
    from ..ops.registry import OP_SPECS
    out = set()
    for op in program.global_block().ops:
        if op.type in META_OPS or op.type in _TRANSPARENT_FALLBACK:
            continue
        spec = OP_SPECS.get(op.type)
        if spec is not None and (spec.mem_transparent is not None
                                 or spec.mem_backward_extra is not None):
            continue
        out.add(op.type)
    return sorted(out)


class _AliasSets:
    """Union-find over var names for residual-class collapse."""

    def __init__(self):
        self._parent: Dict[str, str] = {}

    def find(self, x: str) -> str:
        p = self._parent
        while p.get(x, x) != x:
            p[x] = p.get(p[x], p[x])
            x = p[x]
        return x

    def union(self, root: str, member: str):
        self._parent[self.find(member)] = self.find(root)


def analyze_memory(program: Program, feed_shapes=None,
                   fetch_names: Iterable[str] = (),
                   mesh_axes: Optional[Dict[str, int]] = None,
                   batch_axis: Optional[str] = None,
                   seq_axis: Optional[str] = None,
                   feed_specs: Optional[Dict[str, Any]] = None,
                   donate_state: bool = True, unknown_dim: int = 1,
                   top_k: int = 8) -> MemoryEstimate:
    """Static per-rank peak estimate for one step of ``program``.

    ``feed_shapes`` maps feed names to arrays, tensors or ``(shape,
    dtype)`` pairs; absent feeds fall back to declared metadata with
    unknown dims priced at ``unknown_dim``.  ``mesh_axes`` maps axis name
    to size; persistables divide by their ``dist_attr`` axes, feeds by
    their ``feed_specs`` entry (default: batch axis on dim 0),
    activations by the batch x sequence axes."""
    from ..ops.registry import OP_SPECS

    mesh_axes = dict(mesh_axes or {})
    fetch_names = list(fetch_names)
    block = program.global_block()
    est = MemoryEstimate()
    est.mesh_axes = mesh_axes

    feed_sigs = _feed_sigs(program, feed_shapes, unknown_dim)
    env = shape_env(program, feed_sigs)
    sig_of = _sig_lookup(block, env)

    act_div = _axis_divisor((batch_axis, seq_axis), mesh_axes)

    def var_bytes(name, activation=False):
        v = block._find_var_recursive(name)
        b = sig_bytes(sig_of(name), unknown_dim)
        if not mesh_axes:
            return b
        if v is not None and getattr(v, "dist_attr", None):
            return b // _axis_divisor(v.dist_attr, mesh_axes)
        if name in feed_sigs:
            spec = (feed_specs or {}).get(name)
            axes = tuple(spec) if spec is not None else (batch_axis,)
            return b // _axis_divisor(axes, mesh_axes)
        if activation:
            return b // act_div
        return b

    # -- arguments (per rank) ----------------------------------------------
    state_in, written_state = _state_names(program, fetch_names)
    for n in feed_sigs:
        est.feed_bytes += var_bytes(n)
    for n in state_in:
        v = block._find_var_recursive(n)
        b = var_bytes(n)
        if v is not None and getattr(v, "trainable", False):
            est.param_bytes += b
        else:
            est.opt_state_bytes += b

    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    bw_idx = next((i for i, op in enumerate(ops)
                   if op.type == "backward"), None)
    liveness = block_liveness(block, feed_names=list(feed_sigs),
                              fetch_names=fetch_names)

    top: List[LiveTensor] = []

    def anchor(name):
        iv = liveness.get(name)
        op = iv.def_op if iv is not None else None
        return ((op.type if op is not None else None),
                getattr(op, "callstack", None) or ())

    if bw_idx is not None:
        # ---- training step: the peak sits at the backward sweep ----------
        bw_attrs = ops[bw_idx].attrs
        checkpoints = set(bw_attrs.get("checkpoints") or ())
        pipe_S = int(bw_attrs.get("pipe_stages") or 1)
        pipe_M = int(bw_attrs.get("pipe_microbatches") or 1)
        aliases = _AliasSets()
        fwd_names: Dict[str, int] = {}
        def_pos: Dict[str, int] = {}
        last_read: Dict[str, int] = {}
        internal_per_op: List[int] = []
        internal = 0
        for idx, op in enumerate(ops[:bw_idx]):
            outs = op.output_names()
            for n in op_reads_recursive(op):
                last_read[n] = idx
            # a ZeRO-3 gather rebuilds the full parameter, replicated
            # across the batch axes: never divided by the activation split
            is_gather = op.type == "fsdp_all_gather"
            for n in outs:
                def_pos.setdefault(n, idx)
                v = block._find_var_recursive(n)
                if v is not None and v.persistable:
                    continue
                fwd_names.setdefault(
                    n, var_bytes(n, activation=not is_gather))
            extra = _op_backward_extra(op, env) // act_div
            internal_per_op.append(extra)
            internal += extra
            ins = op.input_names()
            if outs and ins and _op_transparent(op.type):
                # all outputs join the input's class (a dropout's Out AND
                # Mask)
                big = max(ins, key=lambda n: fwd_names.get(
                    n, var_bytes(n, activation=True)))
                for o in outs:
                    aliases.union(big, o)
        classes: Dict[str, Tuple[int, str]] = {}
        for n, b in fwd_names.items():
            r = aliases.find(n)
            cur = classes.get(r)
            if cur is None or b > cur[0]:
                classes[r] = (b, n)
        if checkpoints:
            # recompute segments: what survives to the backward sweep is
            # each segment's input live set plus the checkpoint markers
            cuts = sorted({def_pos[c] + 1 for c in checkpoints
                           if c in def_pos})
            kept_roots = set()
            for n in fwd_names:
                d = def_pos.get(n)
                lu = last_read.get(n, -1)
                if n in checkpoints or (
                        d is not None and
                        any(d < c <= lu for c in cuts)):
                    kept_roots.add(aliases.find(n))
            kept = {r: v for r, v in classes.items() if r in kept_roots}
            dropped = sum(b for r, (b, n) in classes.items()
                          if r not in kept)
            est.notes.append(
                f"recompute checkpoints: {len(checkpoints)} boundaries, "
                f"{dropped / (1 << 20):.2f} MiB of residuals not retained")
            classes = kept or classes
            if cuts:
                # one segment's op-internal extras are live at a time
                edges = [0] + cuts + [len(internal_per_op)]
                internal = max(
                    sum(internal_per_op[a:b])
                    for a, b in zip(edges, edges[1:])) if internal_per_op \
                    else 0
        est.residual_bytes = sum(b for b, _ in classes.values())
        est.internal_bytes = internal
        pipe_inflight = 0
        if pipe_S > 1 and pipe_M >= 1:
            # the pipelined lowering: a rank's residual state is its
            # virtual stages' classes at one microbatch, plus the saved
            # input / cotangent rings and the two carries in transit
            pipe_v = int(bw_attrs.get("pipe_chunks") or 1)
            ranks = max(pipe_S // max(pipe_v, 1), 1)
            stage_bytes: Dict[int, int] = {}
            for r, (b, n) in classes.items():
                iv = liveness.get(n)
                op = iv.def_op if iv is not None else None
                s = int(op.attrs.get("_pipe_stage", 0)) \
                    if op is not None else 0
                stage_bytes[s] = stage_bytes.get(s, 0) + b
            rank_bytes = [0] * ranks
            for s, b in stage_bytes.items():
                rank_bytes[s % ranks] += b
            est.residual_bytes = max(rank_bytes) // pipe_M \
                if stage_bytes else 0
            est.internal_bytes = internal // pipe_M
            bnd = 0
            for names in bw_attrs.get("pipe_boundaries") or ():
                for n in names:
                    bnd += var_bytes(n, activation=True)
            ring = bw_attrs.get("pipe_ring_slots")
            slots = (int(ring[0]) + int(ring[1])) if ring else ranks
            pipe_inflight = (slots + 2) * bnd // max(pipe_M, 1)
            sched = bw_attrs.get("pipe_schedule") or "1f1b"
            est.notes.append(
                f"pipeline {sched} on {ranks} ranks x {pipe_v} chunks "
                f"x {pipe_M} microbatches: max-rank residual "
                f"{est.residual_bytes / (1 << 20):.2f} MiB per "
                f"microbatch + {pipe_inflight / (1 << 20):.2f} MiB "
                f"in-flight ring/boundary state")
        # grad-sync collectives after the backward keep their source and
        # result buffers live; each buffer counts once as a source and
        # once as a result across the zone
        scatter_ops = {"zero_reduce_scatter", "quant_reduce_scatter",
                       "c_reducescatter", "reduce_scatter"}
        seen_in: set = set()
        seen_out: set = set()
        for op in ops[bw_idx + 1:]:
            spec = OP_SPECS.get(op.type)
            if spec is None or not spec.collective:
                continue
            axes = op.attrs.get("_axis_name")
            axes = (axes,) if isinstance(axes, str) else tuple(axes or ())
            for n in op.input_names():
                if n in seen_in:
                    continue
                seen_in.add(n)
                v = block._find_var_recursive(n)
                if v is None or not v.persistable:
                    est.grad_bytes += var_bytes(n)
            for n in op.output_names():
                if n in seen_out:
                    continue
                seen_out.add(n)
                v = block._find_var_recursive(n)
                if v is None or not v.persistable:
                    b = var_bytes(n)
                    if op.type in scatter_ops:
                        # a reduce-scatter's result is the 1/n shard of a
                        # var declared at the full flat shape
                        b //= _axis_divisor(axes, mesh_axes)
                    est.grad_bytes += b
            wb = None
            if getattr(spec, "wire", None) is not None:
                ins = {slot: [sig_of(n) for n in names]
                       for slot, names in op.inputs.items()}
                try:
                    wb = spec.wire(ins, op.attrs, mesh_axes)
                except Exception:   # accounting must not kill the analyzer
                    wb = None
            if wb is not None:
                logical, wire = wb
                est.wire_logical_bytes += logical
                est.wire_bytes += wire
        est.transient_bytes = int(RESIDUAL_FACTOR * est.residual_bytes
                                  + est.internal_bytes + est.grad_bytes
                                  + pipe_inflight)
        est.peak_op_idx = bw_idx
        for n in state_in:
            t, cs = anchor(n)
            v = block._find_var_recursive(n)
            kind = "param" if (v is not None and
                               getattr(v, "trainable", False)) \
                else "opt-state"
            top.append(LiveTensor(n, var_bytes(n), kind, t, cs))
        for r, (b, n) in classes.items():
            t, cs = anchor(n)
            top.append(LiveTensor(n, int(b * RESIDUAL_FACTOR),
                                  "activation", t, cs))
        for n in feed_sigs:
            top.append(LiveTensor(n, var_bytes(n), "feed"))
    else:
        # ---- forward-only program: scan the live set over the op list ----
        names = set(liveness)
        peak, peak_idx, peak_set = 0, 0, []
        end = len(block.ops) - 1
        cache: Dict[str, int] = {}

        def nb(n):
            if n not in cache:
                cache[n] = var_bytes(n, activation=True)
            return cache[n]

        sub_extra: Dict[int, int] = {}
        for idx, op in enumerate(block.ops):
            extra = 0
            for sub in _iter_sub_blocks(op):
                sl = block_liveness(sub)
                extra += sum(sig_bytes(sig_of(n), unknown_dim) // act_div
                             for n in sl
                             if block._find_var_recursive(n) is None
                             or not block._find_var_recursive(n).persistable)
            sub_extra[idx] = extra
        for idx, op in enumerate(block.ops):
            if op.type in ("feed", "fetch"):
                continue
            live = [n for n in names
                    if liveness[n].live_at(idx, end)
                    and not liveness[n].pinned]
            total = sum(nb(n) for n in live) + sub_extra.get(idx, 0)
            if total > peak:
                peak, peak_idx, peak_set = total, idx, live
        est.residual_bytes = peak
        est.transient_bytes = peak
        est.peak_op_idx = peak_idx
        for n in sorted(peak_set, key=nb, reverse=True)[:top_k]:
            t, cs = anchor(n)
            top.append(LiveTensor(n, nb(n), "activation", t, cs))
        for n in state_in:
            t, cs = anchor(n)
            top.append(LiveTensor(n, var_bytes(n), "param", t, cs))
        for n in feed_sigs:
            top.append(LiveTensor(n, var_bytes(n), "feed"))

    # -- outputs -----------------------------------------------------------
    for n in fetch_names:
        v = block._find_var_recursive(n)
        if v is None or not v.persistable:
            est.output_bytes += sig_bytes(sig_of(n), unknown_dim)
    if not donate_state:
        # written persistables come back as fresh buffers: live twice
        dbl = sum(var_bytes(n) for n in written_state)
        est.output_bytes += dbl
        est.transient_bytes += dbl
        if dbl:
            est.notes.append(
                f"donate_state=False: {len(written_state)} written "
                f"persistable(s) counted twice "
                f"(+{dbl / (1 << 20):.2f} MiB — no buffer aliasing)")

    top.sort(key=lambda t: -t.nbytes)
    est.top_live = top[:top_k]
    return est


# ---------------------------------------------------------------------------
# the memory lint profile
# ---------------------------------------------------------------------------


def lint_memory(program: Program, fetch_names: Iterable[str] = (),
                result=None):
    """Memory-retention lints over one program (warning severity):

    * ``donation-gap`` — a trainable persistable receives a gradient but
      no op writes it: the stale parameter stays pinned beside the new
      value;
    * ``fetch-retention`` — a fetched non-persistable whose last consumer
      runs before the peak point (the backward op);
    * ``grad-accum-doubling`` — a parameter-shaped persistable
      accumulator summed from a gradient.

    Returns ``result`` (an ``analysis.VerifyResult``, a new one by
    default) with the diagnostics added."""
    from .analysis import VerifyResult
    from .core import GRAD_SUFFIX

    result = result if result is not None else VerifyResult(program)
    block = program.global_block()
    ops = [op for op in block.ops if op.type not in ("feed", "fetch")]
    bw_idx = next((i for i, op in enumerate(ops)
                   if op.type == "backward"), None)
    fetch = list(fetch_names)
    liveness = block_liveness(block, fetch_names=fetch)
    written: Dict[str, int] = {}
    for idx, op in enumerate(ops):
        for n in op.output_names():
            written.setdefault(n, idx)

    # (a) donation gap
    if bw_idx is not None:
        for pname in ops[bw_idx].attrs.get("param_names", ()):
            if pname in written:
                continue
            v = block._find_var_recursive(pname)
            if v is None or not v.persistable:
                continue
            reader_idx, reader = next(
                ((i, op) for i, op in enumerate(ops)
                 if pname in op.input_names()), (-1, None))
            b = sig_bytes(_var_sig(v))
            result.add(
                "warning", DONATION_GAP,
                f"trainable persistable {pname!r} receives a gradient but "
                f"is never updated in place — the update (if any) lives in "
                f"a separate buffer while the stale param stays pinned "
                f"(+{b / (1 << 20):.2f} MiB live-set growth); write the "
                f"optimizer output back to {pname!r} so its donated "
                f"buffer is reused",
                reader, block.idx, reader_idx)

    # (b) fetch-induced retention
    peak_idx = bw_idx if bw_idx is not None else len(ops) - 1
    for n in fetch:
        v = block._find_var_recursive(n)
        if v is not None and (v.persistable or v.is_data):
            continue
        iv = liveness.get(n)
        if iv is None or iv.def_idx is None:
            continue
        last_real = max((i for i, op in enumerate(ops)
                         if n in op.input_names()), default=-1)
        if last_real < peak_idx and iv.def_idx < peak_idx:
            b = sig_bytes(_var_sig(v))
            result.add(
                "warning", FETCH_RETENTION,
                f"fetch target {n!r} is produced at op #{iv.def_idx} and "
                f"last consumed at op #{last_real}, but the fetch pins it "
                f"across the peak point (op #{peak_idx})"
                + (f" — +{b / (1 << 20):.2f} MiB held through the "
                   f"backward sweep" if b else "")
                + "; fetch a reduced copy or move the fetch off the hot "
                  "step",
                iv.def_op, block.idx, iv.def_idx)

    # (c) gradient-accumulation doubling
    for idx, op in enumerate(ops):
        if op.type not in ("sum", "elementwise_add"):
            continue
        ins = op.input_names()
        outs = op.output_names()
        if not outs:
            continue
        acc = outs[0]
        if acc not in ins:
            continue
        v = block._find_var_recursive(acc)
        if v is None or not v.persistable:
            continue
        if not any(n.endswith(GRAD_SUFFIX) for n in ins if n != acc):
            continue
        b = sig_bytes(_var_sig(v))
        result.add(
            "warning", GRAD_ACCUM_DOUBLING,
            f"persistable gradient accumulator {acc!r} doubles the "
            f"per-device gradient live set (+{b / (1 << 20):.2f} MiB "
            f"pinned across every micro-step); shard it with ZeRO-1 "
            f"(strategy.sharded_update) or accumulate in bf16",
            op, block.idx, idx)
    return result


# ---------------------------------------------------------------------------
# the budget gate (flag("hbm_budget_gb"))
# ---------------------------------------------------------------------------


def check_hbm_budget(program: Program, feed_shapes=None,
                     fetch_names: Iterable[str] = (),
                     mesh_axes: Optional[Dict[str, int]] = None,
                     batch_axis: Optional[str] = None,
                     seq_axis: Optional[str] = None,
                     feed_specs: Optional[Dict[str, Any]] = None,
                     donate_state: bool = True,
                     budget_gb: Optional[float] = None
                     ) -> Optional[MemoryEstimate]:
    """Raise ``InvalidArgumentError`` before any launch when the static
    per-rank estimate exceeds ``flag("hbm_budget_gb")`` (0 = gate off).
    With ``flag("remat_on_reject")`` an over-budget training program first
    gets recompute checkpoints (``pipe.plan_remat``) and raises only when
    even those do not fit."""
    from ..flags import flag
    if budget_gb is None:
        budget_gb = float(flag("hbm_budget_gb") or 0.0)
    if not budget_gb or budget_gb <= 0:
        return None
    est = analyze_memory(program, feed_shapes=feed_shapes,
                         fetch_names=fetch_names, mesh_axes=mesh_axes,
                         batch_axis=batch_axis, seq_axis=seq_axis,
                         feed_specs=feed_specs, donate_state=donate_state)
    if est.peak_gb > budget_gb and flag("remat_on_reject"):
        from .pipe import apply_remat, plan_remat
        plan = plan_remat(program, feed_shapes=feed_shapes,
                          fetch_names=fetch_names, mesh_axes=mesh_axes,
                          batch_axis=batch_axis, seq_axis=seq_axis,
                          budget_gb=budget_gb, donate_state=donate_state)
        if plan is not None and plan.fits:
            apply_remat(program, plan)
            est = analyze_memory(program, feed_shapes=feed_shapes,
                                 fetch_names=fetch_names,
                                 mesh_axes=mesh_axes,
                                 batch_axis=batch_axis, seq_axis=seq_axis,
                                 feed_specs=feed_specs,
                                 donate_state=donate_state)
            est.notes.append(
                f"remat_on_reject: inserted {len(plan.checkpoints)} "
                f"recompute checkpoint(s) "
                f"(+{plan.flops_delta / 1e9:.3f} GFLOP recompute) to fit "
                f"hbm_budget_gb={budget_gb:g}")
    if est.peak_gb > budget_gb:
        raise InvalidArgumentError(
            f"program exceeds hbm_budget_gb={budget_gb:g}: static "
            f"per-rank peak estimate {est.peak_gb:.4f} GiB "
            f"({est.peak_bytes} bytes) — rejected before any launch.\n"
            + est.report())
    return est


def estimate(program: Program, feed_shapes=None,
             fetch_names: Iterable[str] = (),
             mesh_axes: Optional[Dict[str, int]] = None,
             batch_axis: Optional[str] = None,
             seq_axis: Optional[str] = None,
             feed_specs: Optional[Dict[str, Any]] = None,
             donate_state: bool = True, unknown_dim: int = 1,
             top_k: int = 8) -> MemoryEstimate:
    """One program's static per-rank peak estimate at concrete feed
    shapes (:func:`analyze_memory` under the name the serving tier
    uses): ``state_bytes`` is the resident weights, ``peak_bytes -
    state_bytes`` the working set."""
    return analyze_memory(program, feed_shapes=feed_shapes,
                          fetch_names=fetch_names, mesh_axes=mesh_axes,
                          batch_axis=batch_axis, seq_axis=seq_axis,
                          feed_specs=feed_specs, donate_state=donate_state,
                          unknown_dim=unknown_dim, top_k=top_k)


def plan_cache_pool(program: Program, feed_shapes=None,
                    fetch_names: Iterable[str] = (),
                    cache_vars: Iterable[str] = (),
                    block_bytes: int = 0,
                    budget_gb: Optional[float] = None,
                    min_blocks: int = 1,
                    reserve_blocks: int = 0) -> Dict[str, Any]:
    """Size a paged KV-cache pool at decode-engine start.  ``program`` is
    the decode-step program built with a probe pool at its largest batch
    bucket's ``feed_shapes``; the estimate splits into the pool
    persistables (``cache_vars``) and everything else, and the blocks the
    budget affords follow statically:

        blocks = (budget - (peak - probe_pool)) // block_bytes

    Returns ``{"blocks", "fixed_bytes", "block_bytes", "budget_bytes",
    "reserve_blocks", "estimate"}``; ``blocks`` is None without a budget.
    Raises ``InvalidArgumentError`` when fewer than ``min_blocks`` +
    ``reserve_blocks`` fit."""
    from ..flags import flag
    from ..ops.registry import dtype_nbytes
    if budget_gb is None:
        budget_gb = float(flag("hbm_budget_gb") or 0.0)
    reserve_blocks = max(0, int(reserve_blocks))
    est = estimate(program, feed_shapes=feed_shapes,
                   fetch_names=fetch_names, donate_state=True)
    cache_vars = set(cache_vars)
    probe_pool = 0
    block = program.global_block()
    for name in sorted(cache_vars):
        v = block.vars.get(name)
        if v is None or not v.shape:
            continue
        n = 1
        for d in v.shape:
            n *= int(d)
        probe_pool += n * dtype_nbytes(v.dtype)
    fixed = max(0, est.peak_bytes - probe_pool)
    out = {"blocks": None, "fixed_bytes": int(fixed),
           "block_bytes": int(block_bytes), "budget_bytes": None,
           "reserve_blocks": reserve_blocks, "estimate": est}
    if not budget_gb or budget_gb <= 0:
        return out
    budget = int(budget_gb * _GIB)
    out["budget_bytes"] = budget
    blocks = (budget - fixed) // max(1, int(block_bytes))
    if blocks < min_blocks + reserve_blocks:
        raise InvalidArgumentError(
            f"decode cache admission: hbm_budget_gb={budget_gb:g} leaves "
            f"{max(0, budget - fixed)} bytes for the KV-cache pool — "
            f"fewer than min_blocks={min_blocks} blocks (+ "
            f"reserve_blocks={reserve_blocks} prefix-cache headroom) of "
            f"{block_bytes} bytes (weights + decode working set cost "
            f"{fixed} bytes).  Rejected at engine start, before any "
            f"launch.\n" + est.report())
    out["blocks"] = int(blocks)
    return out


# ---------------------------------------------------------------------------
# wire bytes and the exposed-communication model
# ---------------------------------------------------------------------------


def collective_wire_summary(program: Program, feed_shapes=None,
                            fetch_names: Iterable[str] = (),
                            mesh_axes: Optional[Dict[str, int]] = None,
                            batch_axis=None,
                            seq_axis: Optional[str] = None,
                            feed_specs: Optional[Dict[str, Any]] = None,
                            unknown_dim: int = 1) -> Dict[str, Any]:
    """Whole-program per-step wire bytes over the ``wire`` channel —
    forward collectives included (the Megatron pair, ZeRO-3's
    ``fsdp_all_gather``), the cost channel the shard planner ranks
    layouts with.  Each op is priced from its inputs' declared (global)
    signatures and divided by the payload's sharding over the axes the op
    does not communicate over."""
    from ..ops.registry import OP_SPECS
    from .mesh_layout import _flat_axes

    mesh_axes = dict(mesh_axes or {})
    block = program.global_block()
    feed_sigs = _feed_sigs(program, feed_shapes, unknown_dim)
    sig_of = _sig_lookup(block, shape_env(program, feed_sigs))

    batch_axes = _flat_axes(batch_axis) + tuple(
        a for a in (seq_axis,) if a)

    totals = {"wire_bytes": 0, "logical_bytes": 0,
              "grad_sync_wire_bytes": 0, "forward_wire_bytes": 0}
    bw_idx = next((i for i, op in enumerate(block.ops)
                   if op.type == "backward"), None)
    by_op: Dict[str, Dict[str, int]] = {}
    unpriced: List[str] = []
    for op_idx, op in enumerate(block.ops):
        spec = OP_SPECS.get(op.type)
        if spec is None or not spec.collective:
            continue
        fn = getattr(spec, "wire", None)
        if fn is None:
            if op.type not in ("zero_shard_slice", "mp_copy", "c_identity"):
                unpriced.append(op.type)
            continue
        ins = {slot: [sig_of(n) for n in names]
               for slot, names in op.inputs.items()}
        try:
            wb = fn(ins, op.attrs, mesh_axes)
        except Exception:       # accounting must not kill the planner
            wb = None
        if wb is None:
            unpriced.append(op.type)
            continue
        logical, wire = wb
        op_axes = op.attrs.get("_axis_name") or ()
        op_axes = set(_flat_axes(op_axes))
        div = None
        for n in op.input_names():
            v = block._find_var_recursive(n)
            da = tuple(getattr(v, "dist_attr", None) or ()) \
                if v is not None else ()
            if da:
                axes = tuple(a for a in _flat_axes(da) if a not in op_axes)
            elif n in feed_sigs:
                fspec = (feed_specs or {}).get(n)
                axes = tuple(a for a in _flat_axes(
                    tuple(fspec) if fspec is not None else batch_axes)
                    if a not in op_axes)
            elif v is not None and v.persistable:
                axes = ()
            else:           # activation: batch / sequence sharded
                axes = tuple(a for a in batch_axes if a not in op_axes)
            d = _axis_divisor(axes, mesh_axes)
            div = d if div is None else min(div, d)
        div = div or 1
        logical, wire = int(logical // div), int(wire // div)
        row = by_op.setdefault(op.type, {"count": 0, "wire_bytes": 0,
                                         "logical_bytes": 0})
        row["count"] += 1
        row["wire_bytes"] += wire
        row["logical_bytes"] += logical
        totals["wire_bytes"] += wire
        totals["logical_bytes"] += logical
        # collectives after the backward are grad sync (hideable under
        # the backward's compute when overlapped); half an fsdp gather's
        # wire is its backward transpose, and mp_copy's is all backward
        if bw_idx is not None and op_idx > bw_idx:
            totals["grad_sync_wire_bytes"] += wire
        elif op.type == "fsdp_all_gather":
            totals["grad_sync_wire_bytes"] += wire // 2
            totals["forward_wire_bytes"] += wire - wire // 2
        elif op.type == "mp_copy":
            totals["grad_sync_wire_bytes"] += wire
        else:
            totals["forward_wire_bytes"] += wire
    return {"wire_bytes": totals["wire_bytes"],
            "logical_bytes": totals["logical_bytes"],
            "grad_sync_wire_bytes": totals["grad_sync_wire_bytes"],
            "forward_wire_bytes": totals["forward_wire_bytes"],
            "by_op": by_op,
            "unpriced_collectives": sorted(set(unpriced))}


def exposed_comm_model(wire_summary, flops_total, num_devices=1,
                       overlap=False, has_backward=True,
                       ici_gbps=None, peak_flops=None,
                       bubble_frac=0.0, link_gbps=None) -> Dict[str, Any]:
    """Static step-time roofline for one program and layout: how much
    collective wire time is exposed (not hidden under compute):

        exposed = forward_wire_time
                + max(0, grad_sync_wire_time - overlappable_compute)

    ``overlappable_compute`` is ``flag("overlap_compute_frac")`` of the
    step's compute time when the gradient sync is overlapped, else 0.
    Wire time = bytes / (link GB/s · 1e9): ``link_gbps`` (or the JAX
    package's keyword ``ici_gbps``, read as the same link figure), else
    ``flag("link_gbps")``; the peak is ``peak_flops`` or
    ``observability.flops.device_peak_flops()``.  ``bubble_frac`` charges
    a pipeline schedule's idle share on top: ``cost_s = exposed +
    bubble_frac x (compute + exposed)``.  Only the ranking between
    layouts reads this model."""
    from ..flags import flag
    from ..observability import flops as _flops
    gbps = link_gbps if link_gbps is not None else ici_gbps
    bw = float(gbps if gbps is not None else flag("link_gbps")) * 1e9
    peak = float(peak_flops) if peak_flops else _flops.device_peak_flops()
    per_dev = float(flops_total or 0.0) / max(int(num_devices or 1), 1)
    compute_s = per_dev / peak if peak > 0 else 0.0
    frac = float(flag("overlap_compute_frac"))
    bwd_compute_s = compute_s * frac if has_backward else 0.0
    grad_wire_s = wire_summary.get("grad_sync_wire_bytes", 0) / bw
    fwd_wire_s = wire_summary.get("forward_wire_bytes", 0) / bw
    hidden_s = min(grad_wire_s, bwd_compute_s) if overlap else 0.0
    exposed_s = fwd_wire_s + grad_wire_s - hidden_s
    bubble_s = float(bubble_frac or 0.0) * (compute_s + exposed_s)
    return {
        "link_gbps": bw / 1e9,
        "peak_flops": peak,
        "compute_s": compute_s,
        "overlap_compute_frac": frac,
        "overlappable_compute_s": bwd_compute_s if overlap else 0.0,
        "wire_time_s": fwd_wire_s + grad_wire_s,
        "grad_sync_wire_s": grad_wire_s,
        "forward_wire_s": fwd_wire_s,
        "hidden_s": hidden_s,
        "exposed_comm_s": exposed_s,
        "bubble_frac": float(bubble_frac or 0.0),
        "pipe_bubble_s": bubble_s,
        "cost_s": exposed_s + bubble_s,
    }


def mesh_axes_of(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of the port's ``ProcessMesh`` (None gives
    {})."""
    if mesh is None:
        return {}
    return {str(k): int(v) for k, v in dict(mesh.shape).items()}


__all__ = [
    "DONATION_GAP", "FETCH_RETENTION", "GRAD_ACCUM_DOUBLING",
    "RESIDUAL_FACTOR", "Interval", "LiveTensor", "MemoryEstimate",
    "block_liveness", "program_liveness", "analyze_memory",
    "estimate", "lint_memory", "check_hbm_budget", "mesh_axes_of",
    "sig_bytes", "shape_env", "collective_wire_summary",
    "exposed_comm_model", "mem_uncovered_suspects", "plan_cache_pool",
]
