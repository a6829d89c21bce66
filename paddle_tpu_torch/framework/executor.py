"""Executor — the port of paddle_tpu/framework/executor.py.

The JAX package traces a whole block into one XLA executable; PyTorch
runs eagerly, so this executor interprets the program op by op on the
place's ``torch.device`` (ref: the reference's own op-by-op interpreter,
executor.cc).  On a CUDA device every op enqueues its kernels on the
current stream and returns at once: a run costs host time per op, and
results are only waited for when read.

* ``Executor.run`` — startup and main programs; persistables written by
  the program (the startup program's parameters) land in the scope.
* ``Executor.prepare(..., donate_state=False)`` → :class:`PreparedStep`:
  the read-only-state serving mode.  Weights are pulled from the scope
  onto the device once and stay resident; ``run`` returns lazy
  :class:`FetchHandle`\\ s that synchronise only on ``.numpy()``.
* ``Executor.prepare(..., donate_state=True)``: the training mode.  The
  state stays on the device and the optimizer ops update parameters,
  moments and beta powers in place, so they keep their storage across
  steps; :func:`sync_prepared_state` hands the current tensors to the
  scope by reference (``Executor.run`` and ``io.save_persistables`` call
  it first).

Both take a :class:`~.compiler.CompiledProgram` too: ``run`` resolves its
pass variant for the fetch list on every call, ``prepare`` once.  One
compiled inside a ``torch.distributed`` group of more than one rank runs
data-parallel, like the JAX package's ``shard_map`` over a ``dp`` axis:
each rank keeps its ``1/world`` rows of every fed batch, the collectives
reduce over the group, and fetches are merged across ranks (a float
scalar averaged, an integer scalar summed, a batch-sharded tensor
all-gathered; persistables and whatever the ``backward`` op or the ops
after it write pass through).

A program with a ``backward`` meta-op (``append_backward``) runs through
:func:`run_training_block`, the counterpart of the JAX package's
``lower_block_with_backward``: the forward ops under autograd with the
parameters as leaves, ``torch.autograd.grad`` at the ``backward`` op, and
the optimizer ops after it without autograd.

Random ops draw from a ``torch.Generator`` on the run's device, seeded
from ``program.random_seed`` and kept in the scope so successive runs
continue one stream; a data-parallel run draws from its own stream, the
seed folded with the rank, so dropout masks differ across ranks."""

from __future__ import annotations

import contextlib
import threading
import weakref
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .compiler import CompiledProgram
from .core import (CUDAPlace, Place, Program, Variable, default_main_program,
                   device_for, grad_var_name)
from .errors import EnforceNotMet, UnimplementedError
from ..ops.collective_ops import merge_fetch, slice_feed
from ..ops.registry import LoweringContext, get_op

_RNG_VAR = "@RNG_STATE@"


class Scope:
    """Name → tensor store (ref: framework/scope.h).  ``_version`` counts
    writes so a PreparedStep holding device-resident state notices an
    external write (load_persistables, a startup run, ``set_var``) and
    pulls the state again."""

    def __init__(self):
        self.vars: Dict[str, Any] = {}
        self._version = 0

    def var_names(self):
        return list(self.vars)

    def find_var(self, name):
        return self.vars.get(name)

    def set_var(self, name, value):
        self.vars[name] = value
        self._version += 1

    def drop_all(self):
        self.vars.clear()
        self._version += 1


def sync_prepared_state(scope: Scope):
    """Hand every live donated PreparedStep's device state to ``scope`` by
    reference (no copy, no device sync), so direct scope readers — a plain
    ``Executor.run``, ``io.save_persistables`` — see current values."""
    for ps in list(getattr(scope, "_prepared", ())):
        ps.sync_scope()


_global_scope = Scope()


def global_scope() -> Scope:
    return _global_scope


@contextlib.contextmanager
def scope_guard(scope: Scope):
    global _global_scope
    old, _global_scope = _global_scope, scope
    try:
        yield
    finally:
        _global_scope = old


# ---------------------------------------------------------------------------
# op-by-op interpretation
# ---------------------------------------------------------------------------


def _gather_inputs(op, env):
    ins = {}
    for slot, names in op.inputs.items():
        vals = []
        for n in names:
            if n not in env:
                raise KeyError(
                    f"op {op.type!r} input {slot}={n!r} not computed/fed; "
                    f"known vars: {sorted(list(env))[:20]}...")
            vals.append(env[n])
        ins[slot] = vals
    return ins


def _scatter_outputs(op, outs, env):
    for slot, names in op.outputs.items():
        if slot not in outs:
            continue
        vals = outs[slot]
        if not isinstance(vals, (list, tuple)):
            vals = [vals]
        for n, v in zip(names, vals):
            env[n] = v


def run_ops(ops, env, ctx):
    """Interpret a straight-line op list.  A failing op raises
    EnforceNotMet carrying the op type and the user call site that
    created it."""
    for op in ops:
        if op.type in ("feed", "fetch"):
            continue
        try:
            outs = get_op(op.type)(ctx, _gather_inputs(op, env), op.attrs)
        except EnforceNotMet:
            raise
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            raise EnforceNotMet(op.type, e,
                                getattr(op, "callstack", None)) from e
        _scatter_outputs(op, outs, env)
    return env


def backward_index(ops) -> Optional[int]:
    """Position of the ``backward`` meta-op in an op list, or None."""
    for i, op in enumerate(ops):
        if op.type == "backward":
            return i
    return None


def _refuse_unported(bw_op):
    """What the JAX package's lowering does at the backward op and this
    port does not yet: say so rather than train differently."""
    attrs = bw_op.attrs
    if attrs.get("checkpoints"):
        raise UnimplementedError(
            "backward: recompute checkpoints (activation rematerialization) "
            "are not ported yet")
    pipe = {k: v for k, v in attrs.items()
            if k.startswith("pipe_") and v not in (None, 0, 1, "", False)}
    if pipe:
        raise UnimplementedError(
            f"backward: pipeline attrs {sorted(pipe)} — pipeline "
            f"parallelism comes with the multi-GPU slice")
    if attrs.get("loss_scale_var"):
        raise UnimplementedError(
            "backward: dynamic loss scaling (loss_scale_var, AMP) is not "
            "ported yet")
    if attrs.get("guard_scale") or "@GUARD_SCALE@" in \
            bw_op.block.program.global_block().vars:
        raise UnimplementedError(
            "backward: guardrail loss scaling is not ported yet")


def run_training_block(ops, env, ctx, bw_idx):
    """[forward ops][backward meta-op][update ops]: the forward under
    autograd with the parameters as leaf tensors, ``param@GRAD`` from
    ``torch.autograd.grad`` of ``loss.sum() * loss_scale`` (zeros for a
    parameter the loss does not reach), ``loss@GRAD`` = ones, then the
    update ops without autograd on the original parameter tensors."""
    bw_op = ops[bw_idx]
    _refuse_unported(bw_op)
    param_names = list(bw_op.attrs["param_names"])
    loss_name = bw_op.attrs["loss_name"]
    loss_scale = float(bw_op.attrs.get("loss_scale", 1.0))
    originals = {n: env[n] for n in param_names}
    leaves = [env[n].detach().requires_grad_(True) for n in param_names]
    env.update(zip(param_names, leaves))
    with torch.enable_grad():
        run_ops(ops[:bw_idx], env, ctx)
        total = env[loss_name].sum() * loss_scale
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    for k, v in env.items():
        if isinstance(v, torch.Tensor) and v.requires_grad:
            env[k] = v.detach()
    env.update(originals)
    for n, leaf, g in zip(param_names, leaves, grads):
        env[grad_var_name(n)] = torch.zeros_like(leaf) if g is None else g
    env[grad_var_name(loss_name)] = torch.ones_like(env[loss_name])
    with torch.no_grad():
        run_ops(ops[bw_idx + 1:], env, ctx)
    return env


def run_block(ops, env, ctx):
    """Interpret a global block: through :func:`run_training_block` when
    it has a ``backward`` op, else every op without autograd."""
    bw_idx = backward_index(ops)
    if bw_idx is not None:
        return run_training_block(ops, env, ctx, bw_idx)
    with torch.no_grad():
        return run_ops(ops, env, ctx)


def external_inputs(program: Program) -> List[str]:
    """Names the global block reads before any op of it writes them — the
    feeds and the persistable state a run needs from outside."""
    written, needed = set(), []
    for op in program.global_block().ops:
        for n in op.input_names():
            if n not in written and n not in needed:
                needed.append(n)
        written.update(op.output_names())
    return needed


def to_device(value, device: torch.device) -> torch.Tensor:
    """A feed or scope value as a tensor on ``device`` (numpy arrays keep
    their dtype, int64 included)."""
    if isinstance(value, torch.Tensor):
        return value if value.device == device else value.to(device)
    arr = np.asarray(value)
    return torch.from_numpy(np.ascontiguousarray(arr)).to(device)


def _fetch_names(fetch_list) -> List[str]:
    return [f.name if isinstance(f, Variable) else str(f)
            for f in (fetch_list or [])]


def _generator(scope: Scope, program: Program, device: torch.device,
               dp=None):
    """The scope's random stream on ``device``; a data-parallel run's is
    its own, seeded from ``program.random_seed`` folded with the rank."""
    key, seed = _RNG_VAR, int(program.random_seed)
    if dp is not None:
        key = f"{_RNG_VAR}/rank{dp.rank}"
        seed = (seed * 0x9E3779B1 + dp.rank + 1) % (1 << 63)
    g = scope.find_var(key)
    if not isinstance(g, torch.Generator) or g.device != device:
        g = torch.Generator(device=device)
        g.manual_seed(seed)
        # not a state write: prepared steps need not re-pull their weights
        scope.vars[key] = g
    return g


def _replicated_names(program: Program, ops) -> set:
    """Fetchable names that are the same on every data-parallel rank: the
    persistables, and everything the backward op or the ops after it
    write (synced grads, the LR and optimizer zone)."""
    names = {v.name for v in program.list_vars() if v.persistable}
    bw_idx = backward_index(ops)
    if bw_idx is not None:
        for op in ops[bw_idx:]:
            names.update(op.output_names())
    return names


def _is_persistable(program: Program, name: str) -> bool:
    v = program.global_block()._find_var_recursive(name)
    return v is not None and v.persistable


class FetchHandle:
    """Lazy fetch result: holds the tensor a prepared step produced and
    synchronises only on the first host read (``numpy()``/``__array__``).
    The host value is cached, so repeated reads sync once."""

    __slots__ = ("name", "_value", "_host", "_event")

    def __init__(self, value, name=None, event=None):
        self.name = name
        self._value = value
        self._host = None
        self._event = event

    @property
    def value(self):
        """The device tensor — no sync."""
        return self._value

    def is_ready(self):
        """True when the producing step has completed on the device."""
        return self._event is None or self._event.query()

    def numpy(self):
        if self._host is None:
            self._host = self._value.detach().cpu().numpy()
        return self._host

    def __array__(self, dtype=None, copy=None):
        a = self.numpy()
        if dtype is not None:
            return a.astype(dtype)
        return np.array(a) if copy else a

    def __float__(self):
        return float(self.numpy().reshape(()))

    def __repr__(self):
        state = "host" if self._host is not None else (
            "ready" if self.is_ready() else "in-flight")
        return f"FetchHandle({self.name!r}, {state})"


class PreparedStep:
    """Steady-state fast path (ref: Executor::Prepare / RunPreparedContext):
    the program's persistable inputs are resolved and moved to the device
    once and stay resident across runs (re-pulled only if the scope is
    written), feeds go straight to the device, and fetches return as lazy
    :class:`FetchHandle`\\ s.  ``signatures`` counts the distinct feed
    shape signatures served — the port's analog of the JAX package's
    compiled-executable count.

    With ``donate_state`` (training) the step owns its state: the
    optimizer ops update it in place, nothing is written to the scope per
    step, and :meth:`sync_scope` (through :func:`sync_prepared_state`)
    hands the current tensors over by reference."""

    def __init__(self, executor: "Executor", program: Program, feed_names,
                 fetch_list, scope: Scope, feed=None,
                 donate_state: bool = False, dp=None):
        self._exe = executor
        self._program = program
        self._scope = scope
        self._fetch_names = _fetch_names(fetch_list)
        self._declared_feed_names = list(feed_names or [])
        self._ops = list(program.global_block().ops)
        inputs = external_inputs(program)
        self._state_names = [n for n in inputs
                             if _is_persistable(program, n)]
        self._feed_inputs = [n for n in inputs
                             if n not in self._state_names]
        self._state: Optional[Dict[str, torch.Tensor]] = None
        self._scope_version = None
        self._steps: Dict[Any, int] = {}
        self._lock = threading.Lock()
        self._donate = donate_state
        self._dp = dp
        self._replicated = _replicated_names(program, self._ops)
        # every persistable the program writes, read first (parameters,
        # moments) or not (an LR schedule's current value)
        self._written = [n for n in dict.fromkeys(
            n for op in self._ops for n in op.output_names())
            if _is_persistable(program, n)]
        self.stats = {"steps": 0}
        if donate_state:
            if not hasattr(scope, "_prepared"):
                scope._prepared = weakref.WeakSet()
            scope._prepared.add(self)
        if feed is not None:
            self.run(dict(feed))

    @property
    def signatures(self) -> int:
        return len(self._steps)

    def _pull_state(self):
        device = self._exe.device
        state = {}
        for n in self._state_names:
            v = self._scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"persistable var {n!r} not initialised in scope — run "
                    f"the startup program (or load the model) first")
            state[n] = to_device(v, device)
        self._state = state
        self._scope_version = self._scope._version

    def sync_scope(self):
        """Write the current state tensors into the scope by reference."""
        with self._lock:
            if self._state is None or \
                    self._scope_version != self._scope._version:
                return          # the scope was written since: it is newer
            changed = False
            for n in self._written:
                v = self._state.get(n)
                if v is not None and self._scope.vars.get(n) is not v:
                    self._scope.vars[n] = v
                    changed = True
            if changed:
                self._scope._version += 1
                self._scope_version = self._scope._version

    def run(self, feed=None, return_numpy=False):
        """One run.  Returns ``FetchHandle``s (device-resident; sync on
        first read) unless ``return_numpy=True``."""
        feed = feed or {}
        missing = [n for n in self._feed_inputs if n not in feed]
        if missing:
            raise KeyError(f"prepared step needs feeds {missing}")
        device = self._exe.device
        with self._lock:
            if self._state is None or \
                    self._scope_version != self._scope._version:
                self._pull_state()
            sig = tuple(sorted((k, tuple(np.shape(v)), str(getattr(
                v, "dtype", ""))) for k, v in feed.items()))
            self._steps[sig] = self._steps.get(sig, 0) + 1
            env = dict(self._state)
            for k, v in feed.items():
                env[k] = to_device(slice_feed(self._dp, k, v), device)
            ctx = LoweringContext(
                _generator(self._scope, self._program, device, self._dp),
                device, is_test=self._program._is_test,
                donate_state=self._donate, dp=self._dp)
            run_block(self._ops, env, ctx)
            for n in self._written:
                if env[n] is self._state.get(n):
                    continue                # updated in place
                if self._donate:
                    self._state[n] = env[n]   # handed over by sync_scope
                else:
                    # a served program writes no persistable; keep the
                    # scope the owner if one ever does
                    self._scope.set_var(n, env[n])
            self.stats["steps"] += 1
        event = None
        if device.type == "cuda":
            event = torch.cuda.Event()
            event.record(torch.cuda.current_stream(device))
        handles = [FetchHandle(merge_fetch(self._dp, env[n],
                                           n in self._replicated), n, event)
                   for n in self._fetch_names]
        if return_numpy:
            return [h.numpy() for h in handles]
        return handles


class Executor:
    """User-facing executor (ref: python executor.py Executor.run).  With
    no place it runs on ``CUDAPlace(0)`` and raises when no GPU is
    present; ``Executor(CPUPlace())`` is the only way onto the CPU."""

    def __init__(self, place: Optional[Place] = None):
        self.place = place if place is not None else CUDAPlace(0)
        self.device = device_for(self.place)

    def run(self, program: Optional[Program] = None, feed=None,
            fetch_list=None, scope: Optional[Scope] = None,
            return_numpy: bool = True):
        program = program or default_main_program()
        scope = scope or global_scope()
        sync_prepared_state(scope)
        feed = feed or {}
        fetch_names = _fetch_names(fetch_list)
        dp = None
        if isinstance(program, CompiledProgram):
            dp = program._dp
            program = program._variant_for(fetch_names)
        env: Dict[str, Any] = {}
        for n in external_inputs(program):
            if n in feed:
                env[n] = to_device(slice_feed(dp, n, feed[n]), self.device)
                continue
            v = scope.find_var(n)
            if v is None:
                raise RuntimeError(
                    f"var {n!r} is neither fed nor initialised in scope — "
                    f"feed it, or run the startup program first")
            env[n] = to_device(v, self.device)
        ctx = LoweringContext(_generator(scope, program, self.device, dp),
                              self.device, is_test=program._is_test, dp=dp)
        ops = program.global_block().ops
        run_block(ops, env, ctx)
        for op in ops:
            for n in op.output_names():
                if _is_persistable(program, n) and n in env:
                    scope.set_var(n, env[n])
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not computed")
        replicated = _replicated_names(program, ops) if dp else ()
        outs = [merge_fetch(dp, env[n], n in replicated)
                for n in fetch_names]
        if return_numpy:
            return [o.detach().cpu().numpy() for o in outs]
        return outs

    def prepare(self, program: Optional[Program] = None, feed_names=None,
                fetch_list=None, scope: Optional[Scope] = None, feed=None,
                donate_state: bool = False):
        """Resolve ``program`` + ``fetch_list`` into a
        :class:`PreparedStep` with device-resident state: read-only for
        serving, or owned and updated in place with ``donate_state=True``
        (training).  Pass an example ``feed`` to run it once eagerly.  A
        :class:`~.compiler.CompiledProgram`'s pass variant for the fetch
        list is pinned here, once."""
        program = program or default_main_program()
        scope = scope or global_scope()
        dp = None
        if isinstance(program, CompiledProgram):
            dp = program._dp
            program = program._variant_for(_fetch_names(fetch_list))
        return PreparedStep(self, program, feed_names, fetch_list or [],
                            scope, feed=feed, donate_state=donate_state,
                            dp=dp)

    def close(self):
        pass
