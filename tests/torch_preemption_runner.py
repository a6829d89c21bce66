"""Trainer for ``tests/test_torch_preemption.py``: a deterministic MLP
under a ``PreemptionHandler``; a SIGTERM mid-run gives a checkpoint and
exit 42, and a relaunch resumes and finishes, printing its parameters'
digest and losses.  Imports the port only.

    python tests/torch_preemption_runner.py CKPT STEPS LAYOUT [WAIT_AT [SELF]]

``LAYOUT``: ``one`` (a single process: the MLP with Adam, ``Executor.run``
a step) or ``fsdp2`` (one rank of two started by ``python -m
paddle_tpu_torch.distributed.launch``: the MLP rewritten by
``apply_fsdp_sharding(main, MeshLayout(fsdp=2))`` and compiled with
``with_mesh``, a prepared step a batch, an ``AsyncCheckpointer`` save of
every step under ``CKPT/async``) or ``shrink`` (a single process that
restores a ``fsdp2`` checkpoint onto the plain program, layout
``MeshLayout()``).  Each step's batch comes from its own seed.  With
``WAIT_AT`` the process prints ``STEP <k>`` after each step and, after
step WAIT_AT, waits for its own preemption flag (a signal from outside),
or with ``SELF`` = a rank sends itself SIGTERM there, the other ranks
going straight on.  The last line is ``RESULT {json}``."""

from __future__ import annotations

import hashlib
import json
import os
import signal
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from paddle_tpu_torch import fluid, io  # noqa: E402
from paddle_tpu_torch.distributed.preemption import (  # noqa: E402
    PreemptionHandler)
from paddle_tpu_torch.framework import unique_name  # noqa: E402
from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding  # noqa
from paddle_tpu_torch.framework.mesh_layout import MeshLayout  # noqa: E402
from paddle_tpu_torch.ops.collective_ops import whole_of  # noqa: E402


def build():
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        y = fluid.layers.data("y", shape=[1])
        h = fluid.layers.fc(x, 16, act="tanh",
                            param_attr=fluid.ParamAttr(name="pw1"))
        p = fluid.layers.fc(h, 1, param_attr=fluid.ParamAttr(name="pw2"))
        d = fluid.layers.elementwise_sub(p, y)
        loss = fluid.layers.mean(fluid.layers.elementwise_mul(d, d))
        fluid.optimizer.Adam(1e-2).minimize(loss)
    return main, startup, loss


def say(line):
    """One line in one write: the ranks share the launcher's stdout."""
    os.write(1, (line + "\n").encode())


def batch(step):
    rng = np.random.RandomState(step)
    xs = rng.randn(32, 8).astype(np.float32)
    return {"x": xs, "y": xs.sum(1, keepdims=True).astype(np.float32)}


def main(ckpt_dir, steps, layout_name, wait_at=None, self_rank=None):
    torch.set_num_threads(1)
    main_p, startup, loss = build()
    layout, dp, program = None, None, main_p
    if layout_name == "fsdp2":
        from paddle_tpu_torch.distributed import fleet
        from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
        fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
        layout = MeshLayout(fsdp=2)
        apply_fsdp_sharding(main_p, layout, min_shard_numel=8)
        main_p._mesh_layout = layout
        program = fluid.CompiledProgram(main_p).with_mesh(
            layout.build_mesh(), loss_name=loss.name,
            batch_axis=layout.batch_axes)
        dp = program._dp
    elif layout_name == "shrink":
        layout = MeshLayout()
    rank = dp.rank if dp is not None else 0
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    ck = io.AsyncCheckpointer() if dp is not None else None
    handler = PreemptionHandler(exe, ckpt_dir, main_p, scope=scope,
                                checkpointer=ck, layout=layout)
    status = handler.restore()
    step_fn = None
    if dp is not None:
        step_fn = exe.prepare(program, fetch_list=[loss], scope=scope,
                              donate_state=True)
    losses = []
    for step in range(status.step + 1, steps):
        if step_fn is not None:
            got = float(step_fn.run(batch(step))[0])
            ck.save(exe, os.path.join(ckpt_dir, "async"),
                    io.TrainStatus(step), main_p, scope=scope)
        else:
            got = float(exe.run(program, feed=batch(step),
                                fetch_list=[loss], scope=scope)[0])
        losses.append(got)
        if wait_at is not None:
            say(f"STEP {step}")
            if step == wait_at:
                if self_rank is None:
                    deadline = time.monotonic() + 120
                    while not handler.preempted and \
                            time.monotonic() < deadline:
                        time.sleep(0.01)
                elif rank == self_rank:
                    os.kill(os.getpid(), signal.SIGTERM)
        handler.step_done(step)
    handler.finish(steps - 1)
    fluid.sync_prepared_state(scope)
    h = hashlib.sha256()
    for name in ("pw1", "pw2"):
        var = main_p.global_block().var(name)
        h.update(np.ascontiguousarray(io._to_numpy(
            whole_of(dp, var, scope.find_var(name)))).tobytes())
    say("RESULT " + json.dumps({
        "rank": rank, "digest": h.hexdigest(),
        "first_step": status.step + 1, "losses": losses,
        "resharded": getattr(status, "reshard", None) is not None}))
    return 0


if __name__ == "__main__":
    a = sys.argv[1:]
    sys.exit(main(a[0], int(a[1]), a[2],
                  int(a[3]) if len(a) > 3 else None,
                  int(a[4]) if len(a) > 4 else None))
