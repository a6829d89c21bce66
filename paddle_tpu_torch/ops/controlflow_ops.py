"""Control-flow ops — the port of ``conditional_block`` from
paddle_tpu/ops/controlflow_ops.py (ref: operators/controlflow/
conditional_block_op.cc).

A branch is a sub-block of the program (``layers.cond`` builds it); the
op's ``Closure`` input lists the outer variables the branches read, so
the executor's read and write sets see them.  The JAX package traces
both branches into one ``lax.cond`` region that selects on the device.
PyTorch runs eagerly, so the port reads the predicate on the host, once
per run of the op, and interprets the taken branch alone through the
executor's own ``run_ops``: a run of Adam ops inside it is still one
launch of the multi-tensor kernel, and under ``donate_state`` its
updates stay in place.  Computing both branches and selecting would cost
no host wait, but a gradient-merge step's true branch updates every
parameter and moment in place: a select would first have to copy all of
that state.

``while_loop``, ``switch_case`` and ``static_rnn`` are not ported."""

from __future__ import annotations

from .registry import LoweringContext, register


def _block_ops(block):
    return [op for op in block.ops if op.type not in ("feed", "fetch")]


def _run_block(block, env, ctx):
    from ..framework.executor import run_ops
    return run_ops(_block_ops(block), env, ctx)


def _sub_ctx(ctx):
    """The branch's context: the run's generator (one random stream),
    device, test mode, ``donate_state``, process group and guard
    verdict."""
    sub = LoweringContext(ctx.generator, ctx.device, ctx.is_test,
                          ctx.donate_state, ctx.dp)
    sub.guard_skip = ctx.guard_skip
    return sub


@register("conditional_block")
def _conditional_block_op(ctx, ins, attrs):
    """Run ``true_block`` when the one-element ``Cond`` holds, else
    ``false_block``, on the closure's values; ``Out`` are the taken
    branch's outputs.  The predicate is read on the host: one wait for
    the device per run of the op, counted in ``ctx.predicate_reads``."""
    taken = ctx.read_predicate(ins["Cond"][0])
    closure = list(ins.get("Closure") or [])
    env = dict(zip(attrs["closure_names"], closure))
    if taken:
        block, names = attrs["true_block"], attrs["true_out_names"]
    else:
        block, names = attrs["false_block"], attrs["false_out_names"]
    sub = _sub_ctx(ctx)
    env = _run_block(block, env, sub)
    ctx.predicate_reads += sub.predicate_reads
    return {"Out": [env[n] for n in names]}
