"""The ``pipeline`` meta-op — the port of paddle_tpu/ops/pipeline_op.py
(``parallel.PipelineOptimizer`` collapses a ``device_guard``-annotated
forward into it).

GPipe over the ``pp`` axis in lock step: one process a stage, M + S − 1
ticks; at each tick every rank runs its own stage's ops on its input
(rank 0 the tick's microbatch of the feeds, the others the boundary the
rank before it produced one tick earlier; the last stage also reads the
feeds of the microbatch it finishes), then one differentiable wrapping
shift over pp (``collective_ops.RingShift``) hands every rank's output to
the next rank — the last rank sends zeros on the wrap link, and rank 0
ignores what arrives there.  Autograd gives the backward: each shift's
backward shifts the cotangents the other way.  Every rank's graph holds
all T shifts in one chain (rank 0's ignored input and the last rank's
zeros are tied in with :class:`_Tie`, which passes no gradient), so the
backward's shifts issue in the same order on every rank.  The loss of
the last stage's valid ticks is summed over pp with the g-collective
(``SumOverGroup``: sum forward, identity backward — a raw all-reduce
would count every stage's gradients S times) and divided by M.

Without a ``pp`` axis in the run the op runs the stages in sequence for
each microbatch and returns the mean of the microbatches' losses."""

from __future__ import annotations

import torch

from .registry import register


class _Tie(torch.autograd.Function):
    """``a`` forward; backward: ``a``'s cotangent to ``a`` and zeros to
    ``b`` — puts ``b`` on the graph path of ``a`` without touching its
    values."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.b_meta = (b.shape, b.dtype, b.device)
        return a.view_as(a)

    @staticmethod
    def backward(ctx, grad):
        shape, dtype, device = ctx.b_meta
        return grad, torch.zeros(shape, dtype=dtype, device=device)


def tie(a, b):
    """:class:`_Tie` when ``b`` is on a graph, else ``a``."""
    if isinstance(b, torch.Tensor) and b.requires_grad:
        return _Tie.apply(a, b)
    return a


def _run_segment(seg_ops, env, ctx):
    from ..framework.executor import run_ops
    return run_ops(seg_ops, env, ctx)


@register("pipeline")
def _pipeline_op(ctx, ins, attrs):
    from ..framework.pipeline_lowering import microbatch_feeds
    from .collective_ops import RingShift, SumOverGroup
    feeds = dict(zip(attrs["feed_names"], ins.get("Feeds") or []))
    closure = dict(zip(attrs["closure_names"], ins.get("Closure") or []))
    stages = attrs["stage_blocks"]          # list of op-lists
    boundaries = attrs["boundary_names"]    # len S-1
    loss_name = attrs["loss_name"]
    M = int(attrs["num_microbatches"])
    axis = attrs.get("_axis_name", "pp")
    S = len(stages)
    mbs = microbatch_feeds(feeds, M)

    if axis not in ctx.axis_names:
        # one process: every stage in turn, microbatch by microbatch
        losses = []
        for mb in mbs:
            env = dict(closure)
            env.update(mb)
            for seg in stages:
                env = _run_segment(seg, env, ctx)
            losses.append(env[loss_name].mean())
        return {"Loss": torch.stack(losses).mean()}

    g = ctx.dp.over(axis)
    idx = g.rank
    if g.world != S:
        raise ValueError(f"pipeline has {S} stages but pp axis size "
                         f"{g.world}")
    # the boundary buffer: the microbatch's rows, the rest from the
    # declared boundary var (uniform across cuts — the GPipe contract)
    mb_size = next(iter(mbs[0].values())).shape[0]
    bshape = (mb_size,) + tuple(attrs["boundary_shape"])[1:]
    from ..framework.pipe import _torch_dtype
    bdtype = _torch_dtype(attrs.get("boundary_dtype", "float32"))
    device = ctx.device
    state = torch.zeros(bshape, dtype=bdtype, device=device)
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    T = M + S - 1
    for t in range(T):
        t0 = min(max(t, 0), M - 1)              # stage 0's microbatch
        tl = min(max(t - (S - 1), 0), M - 1)    # the last stage's
        env = dict(closure)
        if idx == 0:
            env.update(mbs[t0])
        else:
            if idx == S - 1:
                env.update(mbs[tl])
            env[boundaries[idx - 1]] = state
        env = _run_segment(stages[idx], env, ctx)
        if idx == S - 1:
            loss = env[loss_name].mean().to(torch.float32)
            if 0 <= t - (S - 1) < M:
                loss_sum = loss_sum + loss
            out = tie(torch.zeros(bshape, dtype=bdtype, device=device),
                      loss)
        else:
            out = env[boundaries[idx]].to(bdtype)
        if idx == 0:
            out = tie(out, state)
        state = RingShift.apply(out, g, 1)
    loss_sum = tie(loss_sum, state)
    return {"Loss": SumOverGroup.apply(loss_sum, g) / M}
