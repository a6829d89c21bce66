"""Pipeline parallelism by hand-placed stages — the port of
paddle_tpu/parallel/pipeline.py: the program-level
``PipelineOptimizer`` (``device_guard`` stage annotations, ref:
optimizer.py:3628) and the functional GPipe ``gpipe_spmd`` for
homogeneous stages.

Both run one process a stage over the ``pp`` group in lock step, each
tick one differentiable wrapping shift (``collective_ops.RingShift``)
carrying every rank's output to the next rank, so autograd gives the
backward (``ops/pipeline_op.py``).  The automatic stage cuts and the
1F1B / interleaved / zero-bubble schedules are ``framework/pipe.py``."""

from __future__ import annotations

from typing import Callable

import torch

from ..framework import core as _core
from ..framework.core import Variable
from ..optimizer import Optimizer


# ---------------------------------------------------------------------------
# functional GPipe (homogeneous stages, each rank its stage's params)
# ---------------------------------------------------------------------------


def gpipe_spmd(stage_fn: Callable, stage_params, microbatches,
               axis_name="pp", group=None):
    """``y_m = stage_{S-1}(... stage_0(x_m))`` for the M microbatches,
    GPipe-scheduled over the pipe ranks: this rank runs ``stage_fn``
    with its own stage's ``stage_params`` each of the M + S − 1 ticks.

    Args:
      stage_fn: (params, x) -> y, x and y of the SAME shape.
      stage_params: THIS rank's stage parameters.
      microbatches: [M, mb, ...] — the whole input stream (only rank 0
        reads it).
      axis_name: the pipe axis (its group is ``group``); a
        ``DataParallelGroup`` may stand in for both.
      group: the ``DataParallelGroup`` of the pipe ranks, this rank at its
        stage's index (None: one rank, every stage ``stage_fn`` itself).
    Returns [M, mb, ...] outputs, the same on every rank (summed over the
    pipe ranks forward, the cotangent passed through backward)."""
    from ..ops.collective_ops import (DataParallelGroup, RingShift,
                                      SumOverGroup)
    from ..ops.pipeline_op import tie
    g = group if group is not None else (
        axis_name if isinstance(axis_name, DataParallelGroup) else None)
    if g is None:
        return torch.stack([stage_fn(stage_params, x) for x in microbatches])
    S, idx = g.world, g.rank
    M = microbatches.shape[0]
    T = M + S - 1
    state = torch.zeros_like(microbatches[0])
    outs = [None] * M
    for t in range(T):
        inp = tie(microbatches[min(max(t, 0), M - 1)], state) \
            if idx == 0 else state
        y = stage_fn(stage_params, inp)
        tl = t - (S - 1)
        if idx == S - 1 and 0 <= tl < M:
            outs[tl] = y
        state = RingShift.apply(y, g, 1)
    zero = torch.zeros_like(microbatches[0])
    stacked = tie(torch.stack([o if o is not None else zero
                               for o in outs]), state)
    return SumOverGroup.apply(stacked, g)


# ---------------------------------------------------------------------------
# program-level PipelineOptimizer
# ---------------------------------------------------------------------------


def _stage_of(op) -> int:
    dev = op.attrs.get("op_device") or ""
    if ":" in str(dev):
        try:
            return int(str(dev).rsplit(":", 1)[1])
        except ValueError:
            return 0
    return 0


class PipelineOptimizer:
    """ref: optimizer.py:3628 — wraps an optimizer; ``minimize`` splits the
    forward by its ``device_guard`` stage annotations into the
    ``pipeline`` meta-op (``ops/pipeline_op.py``), then hands backward and
    update to the inner optimizer and sums every gradient over ``pp``.
    Run it with ``CompiledProgram.with_mesh`` over a mesh whose ``pp``
    axis has one rank a stage."""

    def __init__(self, optimizer: Optimizer, num_microbatches: int = 1,
                 start_cpu_core_id: int = 0):
        self._inner = optimizer
        self.num_microbatches = num_microbatches

    def minimize(self, loss: Variable, startup_program=None,
                 parameter_list=None, no_grad_set=None):
        main = loss.block.program
        block = main.global_block()
        ops = [op for op in block.ops if op.type not in ("feed", "fetch")]

        n_stages = max(_stage_of(op) for op in ops) + 1
        if n_stages < 2:
            raise ValueError(
                "PipelineOptimizer needs >=2 device_guard stages "
                "(with fluid.device_guard('gpu:k'):)")
        stages = [[] for _ in range(n_stages)]
        for op in ops:
            stages[_stage_of(op)].append(op)

        # the one var each stage hands the next (the reference's section
        # in/out queues)
        boundaries = []
        for i in range(n_stages - 1):
            produced = set()
            for op in stages[i]:
                produced |= set(op.output_names())
            consumed = set()
            for op in stages[i + 1]:
                consumed |= set(op.input_names())
                produced -= set(op.output_names())
            cross = [n for n in produced if n in consumed
                     and block._find_var_recursive(n) is not None]
            if len(cross) != 1:
                raise ValueError(
                    f"stage {i}->{i + 1} must hand off exactly one var, "
                    f"got {cross}")
            boundaries.append(cross[0])
        bvar = block._find_var_recursive(boundaries[0])

        # feeds: non-persistable vars nobody produces; the rest (params)
        # ride in as the closure
        produced_all = set()
        for op in ops:
            produced_all |= set(op.output_names())
        feed_names, closure_names = [], []
        for op in ops:
            for n in op.input_names():
                if n in produced_all or n in feed_names or \
                        n in closure_names:
                    continue
                v = block._find_var_recursive(n)
                if v is not None and not v.persistable and \
                        not isinstance(v, _core.Parameter):
                    feed_names.append(n)
                else:
                    closure_names.append(n)

        loss_out = block.create_var(name=loss.name + "@pipeline",
                                    shape=(), dtype="float32")
        pipe_op = _core.Operator(
            block, "pipeline",
            {"Feeds": feed_names, "Closure": closure_names},
            {"Loss": [loss_out.name]},
            {"feed_names": feed_names, "closure_names": closure_names,
             "stage_blocks": stages, "boundary_names": boundaries,
             "boundary_shape": tuple(bvar.shape),
             "boundary_dtype": bvar.dtype,
             "loss_name": loss.name,
             "num_microbatches": self.num_microbatches,
             "_axis_name": "pp"})
        block.ops = [pipe_op]
        main._bump_version()

        result = self._inner.minimize(loss_out,
                                      startup_program=startup_program,
                                      parameter_list=parameter_list,
                                      no_grad_set=no_grad_set)
        self._insert_pp_grad_allreduce(block)
        return result

    def _insert_pp_grad_allreduce(self, block):
        """Each rank produced gradients for its own stage's parameters
        only (the others are zero): their sum over pp is the whole
        gradient on every rank (ref: pipeline_trainer.cc's section param
        sync)."""
        from ..framework.core import grad_var_name
        bw_idx = next((i for i, op in enumerate(block.ops)
                       if op.type == "backward"), None)
        if bw_idx is None:
            return
        bw = block.ops[bw_idx]
        at = bw_idx + 1
        for pname in bw.attrs["param_names"]:
            g = grad_var_name(pname)
            block._insert_op(at, type="c_allreduce_sum",
                             inputs={"X": [g]}, outputs={"Out": [g]},
                             attrs={"_axis_name": "pp"})
            at += 1
        block.program._bump_version()

    def __getattr__(self, item):
        return getattr(self._inner, item)
