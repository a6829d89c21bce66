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
over the groups it was compiled for (``dp`` below: a one-axis
``DataParallelGroup`` or HSDP's ``MeshGroups``), like the JAX package's
``shard_map`` over its mesh: each rank keeps its rows of every fed batch
(dim 0 split over the batch axes by its flat index over them), the
collectives reduce over the groups of their axes, and fetches are merged
over the batch axes (a float scalar averaged, an integer scalar summed, a
batch-sharded tensor all-gathered; persistables and whatever the
``backward`` op or the ops after it write pass through).  A persistable
whose ``dist_attr`` names an axis of the run (ZeRO's optimizer-state
shards, ZeRO-3's and HSDP's parameters) is held as the rank's block under
its own axes: the startup program builds the global value on every rank,
and the first run that reads it keeps the rank's block, in its state and
in the scope (``collective_ops.block_of``); a fetch of it returns the
global value.  :func:`_resident` is the one place the executor applies
that rule.

A program with a ``decode_chain`` marker (serving/decode.py) runs its
body ``chain_length`` times on the device through
:func:`lower_decode_chain`, the JAX package's ``lax.scan`` as a Python
loop with every per-step quantity a device tensor.

A program with a ``backward`` meta-op (``append_backward``) runs through
:func:`run_training_block`, the counterpart of the JAX package's
``lower_block_with_backward``: the forward ops under autograd with the
parameters as leaves, ``torch.autograd.grad`` at the ``backward`` op, and
the optimizer ops after it without autograd; a program with
``pipe_microbatches`` or pipeline stages (``framework.pipe``) runs through
``pipeline_lowering`` instead (:func:`last_pipeline_report` gives the last
pipelined run's census).  The backward's recompute
``checkpoints`` split the forward into segments, each but the last run
under ``torch.utils.checkpoint`` and recomputed in the backward with the
same random draws (:func:`run_forward`).  A ``conditional_block`` op
(``layers.cond``; GradientMerge's apply) runs its taken branch through
:func:`run_ops`, the predicate read on the host once per run of the op.

Random ops draw from a ``torch.Generator`` on the run's device, seeded
from ``program.random_seed`` and kept in the scope so successive runs
continue one stream; a data-parallel run draws from its own stream, the
seed folded with the rank's index over the batch and sequence axes, so
dropout masks differ across data and sequence shards and agree across
tensor-parallel ranks.  A run over a sequence axis splits each feed by
its spec (dim 1 over the sequence axis) and averages a one-element float
fetch (a per-shard loss) over it."""

from __future__ import annotations

import contextlib
import threading
import time
import weakref
from collections import OrderedDict
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from .compiler import CompiledProgram
from .core import (CUDAPlace, Place, Program, Variable, default_main_program,
                   device_for, grad_var_name)
from .errors import EnforceNotMet, UnimplementedError
from ..ops.collective_ops import block_of, merge_fetch, slice_feed
from ..ops.registry import LoweringContext, get_group, get_op
from .pipeline_lowering import last_pipeline_report  # noqa: F401

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


def _call(op, fn):
    """``fn()``, a failure raised as EnforceNotMet carrying ``op``'s type
    and the user call site that created it."""
    try:
        return fn()
    except EnforceNotMet:
        raise
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        raise EnforceNotMet(op.type, e, getattr(op, "callstack", None)) from e


def _run_end(ops, i, group):
    """The end of the run of ops from ``i`` that ``group`` takes together
    (at once, so in no order): consecutive ops it is registered for, none
    reading a variable an earlier op of the run writes (a shared beta power
    ends the run) or writing one an earlier op reads or writes."""
    read, written = set(), set()
    j = i
    while j < len(ops) and get_group(ops[j].type) is group:
        ins, outs = set(ops[j].input_names()), set(ops[j].output_names())
        if not (written.isdisjoint(ins) and written.isdisjoint(outs) and
                read.isdisjoint(outs)):
            break
        read.update(ins)
        written.update(outs)
        j += 1
    return j


def run_ops(ops, env, ctx):
    """Interpret a straight-line op list.  A run of ops with a group impl
    (``registry.register_group``: Adam's multi-tensor update) is handed to
    it at once.  A failing op raises EnforceNotMet carrying the op type
    and the user call site that created it."""
    i = 0
    while i < len(ops):
        op = ops[i]
        if op.type in ("feed", "fetch"):
            i += 1
            continue
        group = get_group(op.type)
        if group is None:
            outs = _call(op, lambda: get_op(op.type)(
                ctx, _gather_inputs(op, env), op.attrs))
            _scatter_outputs(op, outs, env)
            i += 1
            continue
        run = ops[i:_run_end(ops, i, group)]
        outs = _call(op, lambda: group(ctx, [
            (o.type, _gather_inputs(o, env), o.attrs) for o in run]))
        for o, out in zip(run, outs):
            _scatter_outputs(o, out, env)
        i += len(run)
    return env


def backward_index(ops) -> Optional[int]:
    """Position of the ``backward`` meta-op in an op list, or None."""
    for i, op in enumerate(ops):
        if op.type == "backward":
            return i
    return None


def _refuse_unported(bw_op):
    """What the JAX package's lowering does at the backward op and this
    port does not yet: say so rather than train differently.  Under the
    microbatched or pipelined lowering a dynamic loss scale and recompute
    checkpoints are refused (the JAX lowerings leave both unapplied: the
    pipelined backward recomputes each stage already)."""
    attrs = bw_op.attrs
    if _pipe_microbatches(bw_op) > 1 or _pipe_stages(bw_op) > 1:
        for key, what in (("loss_scale_var", "dynamic loss scaling"),
                          ("checkpoints", "recompute checkpoints")):
            if attrs.get(key):
                raise UnimplementedError(
                    f"backward: {what} under the microbatched / pipelined "
                    f"lowering is not ported (the JAX package's pipeline "
                    f"lowerings do not apply it either); drop one")
    if attrs.get("guard_scale") or "@GUARD_SCALE@" in \
            bw_op.block.program.global_block().vars:
        raise UnimplementedError(
            "backward: guardrail loss scaling is not ported yet")


def _pipe_stages(bw_op) -> int:
    return int(bw_op.attrs.get("pipe_stages") or 1)


def _pipe_microbatches(bw_op) -> int:
    return int(bw_op.attrs.get("pipe_microbatches") or 1)


def _segment_at_checkpoints(ops, checkpoint_names):
    """Split ops into segments ending right after each checkpoint var is
    produced (ref: backward.py:629 recompute segments)."""
    if not checkpoint_names:
        return [list(ops)]
    remaining = set(checkpoint_names)
    segments, cur = [], []
    for op in ops:
        cur.append(op)
        produced = set(op.output_names()) & remaining
        if produced:
            remaining -= produced
            segments.append(cur)
            cur = []
    if cur:
        segments.append(cur)
    return segments


def _live_names_after(segments, seg_idx, always_live):
    live = set(always_live)
    for seg in segments[seg_idx + 1:]:
        for op in seg:
            live |= set(op.input_names())
    return live


def _run_recomputed(seg, env, ctx, live):
    """Run forward segment ``seg`` under ``torch.utils.checkpoint`` (the
    non-reentrant form, which takes the env dict as it is): autograd keeps
    none of its intermediates and runs it again in the backward.  Only
    the names in ``live`` that it writes join ``env``.

    The segment's random ops (dropout masks, the flash kernels' seeds)
    draw from a generator set to the run generator's state at the
    segment's entry, as the JAX package passes the key into each
    segment: the recompute in the backward replays the same draws, and
    the first run's end state is handed back to the run generator, so
    the stream advances exactly as it does without recompute.
    (``preserve_rng_state`` keeps only PyTorch's default generators, which
    the port's ops do not draw from.)"""
    from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop
    gen = ctx.generator
    start = gen.get_state() if gen is not None else None
    end = []

    def seg_fn(e_in):
        g = None
        if start is not None:
            g = torch.Generator(device=gen.device)
            g.set_state(start)
        sub = LoweringContext(g, ctx.device, ctx.is_test, ctx.donate_state,
                              ctx.dp)
        e_out = run_ops(seg, dict(e_in), sub)
        if g is not None and not end:
            end.append(g.get_state())
        return {k: v for k, v in e_out.items()
                if k in live and (k not in e_in or v is not e_in[k])}

    # a copy: the recompute must see the env as it is now, not as later
    # segments leave it.  The recompute runs the whole segment: stopping
    # early would raise through the ops' error wrapping (``_call``), and
    # the segment's last op saves tensors anyway
    with set_checkpoint_early_stop(False):
        out = checkpoint(seg_fn, dict(env), use_reentrant=False,
                         preserve_rng_state=False)
    env.update(out)
    if end:
        gen.set_state(end[0])


def run_forward(fwd_ops, env, ctx, checkpoints, always_live):
    """The forward ops of a training block: all at once, or with recompute
    ``checkpoints`` one segment at a time, each segment but the last
    recomputed in the backward (:func:`_run_recomputed`).  A segment keeps
    what later segments read and ``always_live``."""
    segments = _segment_at_checkpoints(fwd_ops, checkpoints)
    for i, seg in enumerate(segments):
        if i < len(segments) - 1:
            _run_recomputed(seg, env, ctx,
                            _live_names_after(segments, i, always_live))
        else:
            run_ops(seg, env, ctx)
    return env


#: the ops insert_grad_sync places after the backward
GRAD_SYNC_OPS = ("c_allreduce_sum", "c_quant_allreduce_sum",
                 "c_fused_allreduce_sum", "c_fused_quant_allreduce_sum")


class _BucketHook(torch.autograd.Function):
    """Identity over one ready-order bucket's parameters: its backward
    runs once every member's cotangent is final, hands the cotangents to
    the bucket's collective (``HookedBucket.fire``) and returns them
    unchanged."""

    @staticmethod
    def forward(fctx, bucket, *params):
        fctx.bucket = bucket
        return tuple(p.view_as(p) for p in params)

    @staticmethod
    def backward(fctx, *cots):
        fctx.bucket.fire(cots)
        return (None,) + cots


def _overlap_schedule(fwd_ops, tail_ops, param_names, ctx):
    """The backward hooks of this run: for each ready-order bucket op
    (``_overlap`` with an ``_overlap_hook_pos``) in the tail whose axes
    the run has, (the position in ``fwd_ops`` of the first read of any of
    its parameters, their names, the op), sorted by position.  The
    positions are counted here, on the ops this run executes, so a pass
    that rewrote the forward cannot leave one stale; a bucket with a
    parameter the forward does not read stays at the tail."""
    from ..ops.collective_ops import _ring_axis
    from .liveness import op_reads_recursive
    hookable = [op for op in tail_ops if op.attrs.get("_overlap")
                and op.attrs.get("_overlap_hook_pos") is not None
                and _ring_axis(ctx, op.attrs) is not None]
    if not hookable:
        return []
    grad_to_param = {grad_var_name(n): n for n in param_names}
    want = set(param_names)
    first_use: Dict[str, int] = {}
    for i, op in enumerate(fwd_ops):
        for n in op_reads_recursive(op) & want:
            first_use.setdefault(n, i)
    hooks = []
    for op in hookable:
        pnames = [grad_to_param.get(g) for g in op.input("X")]
        if pnames and all(p in first_use for p in pnames):
            hooks.append((min(first_use[p] for p in pnames), pnames, op))
    hooks.sort(key=lambda t: t[0])
    return hooks


def _run_hooked(fwd_ops, env, ctx, hooks, record):
    """The forward ops with each bucket's :class:`_BucketHook` applied to
    its parameters right before their first read; returns the
    (op, ``HookedBucket``) pairs."""
    from ..ops.collective_ops import HookedBucket
    buckets, cur = [], 0
    for pos, pnames, op in hooks:
        run_ops(fwd_ops[cur:pos], env, ctx)
        bucket = HookedBucket(ctx, op, record)
        env.update(zip(pnames, _BucketHook.apply(
            bucket, *[env[n] for n in pnames])))
        buckets.append((op, bucket))
        cur = pos
    run_ops(fwd_ops[cur:], env, ctx)
    return buckets


def run_training_block(ops, env, ctx, bw_idx, keep=()):
    """[forward ops][backward meta-op][update ops]: the forward under
    autograd with the parameters as leaf tensors, ``param@GRAD`` from
    ``torch.autograd.grad`` of ``loss.sum() * loss_scale`` (zeros for a
    parameter the loss does not reach), ``loss@GRAD`` = ones, then the
    update ops without autograd on the original parameter tensors.

    With the backward's recompute ``checkpoints`` (``RecomputeOptimizer``,
    fleet's ``strategy.recompute``) the forward runs in segments that end
    at each checkpoint, all but the last recomputed in the backward
    (:func:`run_forward`); a forward intermediate stays readable after the
    block only if it is in ``keep`` (the fetches), persistable, or read by
    the backward op or the ops after it.

    A ``loss_scale_var`` (the AMP decorator's dynamic loss scale) also
    multiplies the summed loss, detached, as the JAX package's
    ``stop_gradient`` does: the gradients come back scaled, and the
    ``check_finite_and_unscale`` op after the backward unscales them.
    The backward reaches a parameter through its cast ops whatever their
    ``stop_gradient`` flag (autograd never reads it), so an AMP program's
    float32 master weights get float32 gradients.

    Under ``overlap_grad_sync`` (with ``flags.overlap_lowering`` on and
    the run over a group) each ready-order gradient bucket is fired from
    the backward: an identity :class:`_BucketHook` over its parameters
    sits right before their first read, its backward hands the bucket to
    the asynchronous collective of its group (``collective_ops.
    HookedBucket``) as soon as every member's cotangent is final, and the
    backward goes on.  After ``torch.autograd.grad`` every bucket is
    waited for and writes the outputs of its op, which the tail then
    skips; the values are those of the op run at the tail.  With recompute
    checkpoints (more than one segment) the buckets stay at the tail, as
    in the JAX package.  ``ctx.grad_sync`` records the run's gradient
    sync (``collective_ops.GradSyncRecord``)."""
    from ..flags import flag
    from ..ops.collective_ops import GradSyncRecord
    bw_op = ops[bw_idx]
    _refuse_unported(bw_op)
    pipe_axis = bw_op.attrs.get("pipe_axis") or "pp"
    if _pipe_stages(bw_op) > 1 and pipe_axis in ctx.axis_names:
        from .pipeline_lowering import lower_pipelined
        return lower_pipelined(ops, env, ctx, bw_idx, keep)
    if _pipe_microbatches(bw_op) > 1:
        # a pipelined program on a run without the pipe axis (the pipe = 1
        # degenerate), or the bare microbatch accumulation
        from .pipeline_lowering import lower_microbatched
        return lower_microbatched(ops, env, ctx, bw_idx, keep)
    param_names = list(bw_op.attrs["param_names"])
    loss_name = bw_op.attrs["loss_name"]
    loss_scale = float(bw_op.attrs.get("loss_scale", 1.0))
    scale_var = bw_op.attrs.get("loss_scale_var")
    checkpoints = list(bw_op.attrs.get("checkpoints") or ())
    tail = ops[bw_idx + 1:]
    record = GradSyncRecord() if ctx.dp is not None and any(
        op.type in GRAD_SYNC_OPS for op in tail) else None
    ctx.grad_sync = record
    hooks = []
    if record is not None and not checkpoints and flag("overlap_lowering"):
        hooks = _overlap_schedule(ops[:bw_idx], tail, param_names, ctx)
    always_live = set(keep) | {loss_name}
    if checkpoints:
        program = bw_op.block.program
        always_live |= {v.name for v in program.list_vars()
                        if v.persistable}
        for op in ops[bw_idx:]:
            always_live.update(_reads(op))
    originals = {n: env[n] for n in param_names}
    leaves = [env[n].detach().requires_grad_(True) for n in param_names]
    env.update(zip(param_names, leaves))
    with torch.enable_grad():
        if hooks:
            buckets = _run_hooked(ops[:bw_idx], env, ctx, hooks, record)
        else:
            buckets = []
            run_forward(ops[:bw_idx], env, ctx, checkpoints, always_live)
        total = env[loss_name].sum() * loss_scale
        if scale_var:
            total = total * env[scale_var].reshape(()).detach().to(
                total.dtype)
        grads = torch.autograd.grad(total, leaves, allow_unused=True)
    if record is not None:
        record.mark_backward_end(ctx.device)
    for k, v in env.items():
        if isinstance(v, torch.Tensor) and v.requires_grad:
            env[k] = v.detach()
    env.update(originals)
    for n, leaf, g in zip(param_names, leaves, grads):
        env[grad_var_name(n)] = torch.zeros_like(leaf) if g is None else g
    env[grad_var_name(loss_name)] = torch.ones_like(env[loss_name])
    done = set()
    for op, bucket in buckets:
        # a bucket whose parameters the loss does not reach never fired:
        # its op runs at the tail
        if bucket.pending is not None:
            _scatter_outputs(op, bucket.finish(), env)
            done.add(id(op))
    tail = [op for op in tail if id(op) not in done]
    with torch.no_grad():
        if record is None:
            run_ops(tail, env, ctx)
            return env
        last = max((i for i, op in enumerate(tail)
                    if op.type in GRAD_SYNC_OPS), default=-1)
        record.tail = sum(op.type in GRAD_SYNC_OPS for op in tail)
        run_ops(tail[:last + 1], env, ctx)
        record.mark_synced(ctx.device)
        run_ops(tail[last + 1:], env, ctx)
    return env


def lower_decode_chain(ops, chain_idx, env, ctx):
    """Device-chained decode (serving/decode.py): run the program body
    ``chain_length`` times on the device, the counterpart of the JAX
    package's ``lax.scan``.

    The ``decode_chain`` marker op sits last in its program; its input
    slots name the per-step vars the chain drives (the token, position,
    slot and context-length feeds are overwritten each iteration; the
    body's ``next_tokens`` / ``next_logits`` close the loop) and its
    ``Out`` is the packed ``[chain_length, B]`` token matrix: one host
    fetch per chain instead of one per token.  Everything the single
    decode step did on the host stays on the device as tensors, with no
    host sync inside the chain:

    * slots — ``table[pos // bs] * bs + pos % bs``, the engine's host
      arithmetic, so a chain of L steps writes exactly the slots L single
      steps would;
    * the next-token feedback — greedy rows take the body's own argmax;
      sampling rows draw again from ``next_logits`` (ops/sampling_ops.py);
    * per-row EOS / length masks — a finished row freezes (its position
      and token stop advancing), writes nothing (slot -1, cache_write's
      drop lane) and emits -1, which the host reads as "already done".

    The pools are the env's tensors: under a donated prepared step
    ``cache_write`` writes them in place every iteration."""
    from ..ops.sampling_ops import sample_chain_tokens
    chain_op = ops[chain_idx]
    body = ops[:chain_idx] + ops[chain_idx + 1:]
    attrs = chain_op.attrs
    length = int(attrs["chain_length"])
    bs = int(attrs["block_size"])

    def in0(slot):
        return chain_op.input(slot)[0]

    tok_v, pos_v = in0("TokenIds"), in0("PosIds")
    slot_v, ctxl_v = in0("SlotIds"), in0("CtxLen")
    logits_v, tokens_v = in0("Logits"), in0("Tokens")
    table = env[in0("BlockTable")].to(torch.int64)
    eos = env[in0("EosIds")].to(torch.int64)
    policy = None
    if attrs.get("with_sampling"):
        policy = [env[in0(n)] for n in ("Temperature", "TopK", "TopP",
                                        "Seeds")]
    tok = env[tok_v].to(torch.int64)
    pos = env[pos_v].to(torch.int64)
    left = env[in0("StepsLeft")].to(torch.int64)
    done = left <= 0
    minus1 = torch.full_like(tok, -1)
    last_block = table.shape[1] - 1
    emitted = []
    for _ in range(length):
        # a frozen row's position may sit one past its last block
        blk_idx = torch.clamp(pos // bs, 0, last_block)
        blk = table.gather(1, blk_idx[:, None])[:, 0]
        slot = torch.where(done, minus1, blk * bs + pos % bs)
        env[tok_v] = tok
        env[pos_v] = pos
        env[slot_v] = slot.to(torch.int32)[:, None]
        env[ctxl_v] = (pos + 1).to(torch.int32)
        run_ops(body, env, ctx)
        nxt = env[tokens_v].reshape(-1).to(torch.int64)
        if policy is not None:
            nxt = sample_chain_tokens(env[logits_v], nxt, *policy, pos)
        emitted.append(torch.where(done, minus1, nxt))
        left2 = torch.where(done, left, left - 1)
        done2 = done | (left2 <= 0) | ((eos >= 0) & (nxt == eos))
        tok = torch.where(done, tok, nxt)
        pos = torch.where(done, pos, pos + 1)
        left, done = left2, done2
    env[chain_op.output("Out")[0]] = torch.stack(emitted)
    return env


def run_block(ops, env, ctx, keep=()):
    """Interpret a global block: through :func:`run_training_block` when
    it has a ``backward`` op (``keep``: the names fetched after it),
    through :func:`lower_decode_chain` when it has a ``decode_chain``
    marker, else every op without autograd."""
    bw_idx = backward_index(ops)
    if bw_idx is not None:
        return run_training_block(ops, env, ctx, bw_idx, keep)
    chain_idx = next((i for i, op in enumerate(ops)
                      if op.type == "decode_chain"), None)
    with torch.no_grad():
        if chain_idx is not None:
            return lower_decode_chain(ops, chain_idx, env, ctx)
        return run_ops(ops, env, ctx)


def _reads(op) -> List[str]:
    """The names ``op`` reads: its inputs, and a ``backward`` op's
    ``loss_scale_var`` attr."""
    names = op.input_names()
    if op.type == "backward" and op.attrs.get("loss_scale_var"):
        names = names + [op.attrs["loss_scale_var"]]
    return names


def external_inputs(program: Program) -> List[str]:
    """Names the global block reads before any op of it writes them — the
    feeds and the persistable state a run needs from outside."""
    written, needed = set(), []
    for op in program.global_block().ops:
        for n in _reads(op):
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
    """The scope's random stream on ``device``; a run over a group has
    its own, seeded from ``program.random_seed`` folded with the rank's
    index over the batch and sequence axes (``fold_index``): the draws
    differ per data and sequence shard and agree across a tensor-parallel
    line, whose activations are replicated."""
    key, seed = _RNG_VAR, int(program.random_seed)
    if dp is not None:
        key = f"{_RNG_VAR}/rank{dp.rank}"
        seed = (seed * 0x9E3779B1 + dp.fold_index() + 1) % (1 << 63)
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


def _var(program: Program, name: str):
    return program.global_block()._find_var_recursive(name)


def _resident(scope: Scope, program: Program, dp, name: str,
              device: torch.device):
    """The scope's value of ``name`` on ``device``, as this rank holds it:
    a sharded persistable's global value is cut to the rank's block, and
    the block replaces the global value in the scope (the same value, held
    sharded: not a write, so no prepared step re-pulls for it)."""
    v = to_device(scope.find_var(name), device)
    held = block_of(dp, _var(program, name), v)
    if held is not v:
        scope.vars[name] = held
    return held


class FetchHandle:
    """Lazy fetch result: holds the tensor a prepared step produced and
    synchronises only on the first host read (``numpy()``/``__array__``).
    The host value is cached, so repeated reads sync once; with a
    ``stats`` dict that read's wait is added to its ``fetch_wait_ns``."""

    __slots__ = ("name", "_value", "_host", "_stats", "_event")

    def __init__(self, value, name=None, stats=None, event=None):
        self.name = name
        self._value = value
        self._host = None
        self._stats = stats
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
            t0 = time.perf_counter_ns()
            self._host = self._value.detach().cpu().numpy()
            if self._stats is not None:
                self._stats["fetch_wait_ns"] += time.perf_counter_ns() - t0
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


#: (program, feeds, fetches, layout, donation, budget) the budget gate
#: already admitted: the static estimate runs once per such key (the
#: newest _ADMITTED_CAP kept)
_ADMITTED: "OrderedDict[tuple, None]" = OrderedDict()
_ADMITTED_CAP = 64


def _budget_gate(program: Program, compiled, feed, fetch_names,
                 donate_state: bool):
    """``flag("hbm_budget_gb")``'s gate: raise ``InvalidArgumentError``
    before any launch when the program's static per-rank peak estimate
    (``memory_analysis.check_hbm_budget``, at the feeds' shapes and the
    run's layout) exceeds the budget.  Once per program version, feed
    signature, fetch list and layout."""
    from ..flags import flag
    budget = float(flag("hbm_budget_gb") or 0.0)
    if budget <= 0:
        return
    mesh = getattr(compiled, "_mesh_axes", None) or {}
    feed = dict(feed or {})
    key = (program._uid, program._version,
           tuple(sorted((k, tuple(np.shape(v)), str(getattr(v, "dtype", "")))
                        for k, v in feed.items())),
           tuple(fetch_names), tuple(sorted(mesh.items())),
           bool(donate_state), budget)
    if key in _ADMITTED:
        _ADMITTED.move_to_end(key)
        return
    from .memory_analysis import check_hbm_budget
    check_hbm_budget(program, feed_shapes=feed or None,
                     fetch_names=list(fetch_names), mesh_axes=mesh,
                     batch_axis=getattr(compiled, "_batch_axis", None),
                     seq_axis=getattr(compiled, "_seq_axis", None),
                     feed_specs=getattr(compiled, "_feed_specs", None),
                     donate_state=donate_state, budget_gb=budget)
    _ADMITTED[key] = None
    if len(_ADMITTED) > _ADMITTED_CAP:
        _ADMITTED.popitem(last=False)


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
        # predicate_reads: device values read on the host to pick a path
        # (a conditional_block's predicate, a LocalSGD sync step)
        self.stats = {"steps": 0, "fetch_wait_ns": 0, "predicate_reads": 0}
        #: the last run's ``collective_ops.GradSyncRecord`` (None when it
        #: synced no gradients over a group)
        self.grad_sync = None
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
            state[n] = _resident(self._scope, self._program, self._dp, n,
                                 device)
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
            run_block(self._ops, env, ctx, self._fetch_names)
            self.stats["predicate_reads"] += ctx.predicate_reads
            self.grad_sync = ctx.grad_sync
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
                                           n in self._replicated,
                                           _var(self._program, n)), n,
                               self.stats, event)
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
            return_numpy: bool = True, use_prune: bool = False):
        """Run ``program`` once and return the fetches.  ``use_prune`` is
        the JAX package's keyword: there it prunes a program that drains
        py_readers to its fetch targets, and changes nothing for any
        other program.  The port has no py_readers yet, so it changes
        nothing here."""
        program = program or default_main_program()
        scope = scope or global_scope()
        sync_prepared_state(scope)
        feed = feed or {}
        fetch_names = _fetch_names(fetch_list)
        dp = None
        compiled = None
        if isinstance(program, CompiledProgram):
            compiled = program
            dp = program._dp
            program = program._variant_for(fetch_names)
        _budget_gate(program, compiled, feed, fetch_names, False)
        env: Dict[str, Any] = {}
        for n in external_inputs(program):
            if n in feed:
                env[n] = to_device(slice_feed(dp, n, feed[n]), self.device)
                continue
            if scope.find_var(n) is None:
                raise RuntimeError(
                    f"var {n!r} is neither fed nor initialised in scope — "
                    f"feed it, or run the startup program first")
            env[n] = _resident(scope, program, dp, n, self.device)
        ctx = LoweringContext(_generator(scope, program, self.device, dp),
                              self.device, is_test=program._is_test, dp=dp)
        ops = program.global_block().ops
        run_block(ops, env, ctx, fetch_names)
        for op in ops:
            for n in op.output_names():
                if _is_persistable(program, n) and n in env:
                    scope.set_var(n, block_of(dp, _var(program, n), env[n]))
        missing = [n for n in fetch_names if n not in env]
        if missing:
            raise KeyError(f"fetch targets {missing} were not computed")
        replicated = _replicated_names(program, ops) if dp else ()
        outs = [merge_fetch(dp, env[n], n in replicated, _var(program, n))
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
        compiled = None
        if isinstance(program, CompiledProgram):
            compiled = program
            dp = program._dp
            program = program._variant_for(_fetch_names(fetch_list))
        _budget_gate(program, compiled, feed, _fetch_names(fetch_list),
                     donate_state)
        return PreparedStep(self, program, feed_names, fetch_list or [],
                            scope, feed=feed, donate_state=donate_state,
                            dp=dp)

    def close(self):
        pass
