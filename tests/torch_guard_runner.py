"""Rank program for the guarded-step tests, started by
``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo:

    launch --nproc 2 --backend gloo --timeout T tests/torch_guard_runner.py \\
        LEGS OUT_DIR

``LEGS`` is a comma-separated list of:

* ``zero1`` — the MLP of ``tests/test_guardrails.py`` (``w1``, ``w2``)
  under ZeRO-1 (``ShardedUpdateOptimizer`` over ``data 2``), Adam;
* ``pp2`` — the pipeline test's MLP at ``pipe 2`` (1F1B, 2 microbatches),
  Adam;

each run for STEPS steps through ``Executor.run`` with
``flag("guard_nonfinite")`` on and ``grad_nonfinite`` armed on rank 1
only, at guard step POISON.  Saved per leg: the losses, the guard's skip
total after each step, whether every persistable this rank holds came out
of the poisoned step bit for bit and moved on the next, and a digest of
the parameters after the run (ZeRO-1's replicas agree).

Each rank writes ``OUT_DIR/rank<r>.npz``.  Ranks run one intra-op
thread.  Imports the port only."""

from __future__ import annotations

import hashlib
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from paddle_tpu_torch import fluid  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker  # noqa
from paddle_tpu_torch.flags import set_flags  # noqa: E402
from paddle_tpu_torch.framework import guardrails, unique_name  # noqa
from paddle_tpu_torch.framework.mesh_layout import MeshLayout  # noqa
from paddle_tpu_torch.framework.pipe import apply_pipeline  # noqa: E402
from paddle_tpu_torch.optimizer import ShardedUpdateOptimizer  # noqa
from paddle_tpu_torch.testing import faultline  # noqa: E402

STEPS = 4
POISON = 1


def build(leg):
    unique_name.reset()
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 5
    with fluid.program_guard(main, startup):
        x = L.data("x", shape=[-1, 16], append_batch_size=False)
        y = L.data("label", shape=[-1, 1], dtype="float32",
                   append_batch_size=False)
        h = L.fc(x, 32, act="relu", param_attr=fluid.ParamAttr(name="w1"))
        h = L.fc(h, 32, act="relu", param_attr=fluid.ParamAttr(name="w2"))
        p = L.fc(h, 1, param_attr=fluid.ParamAttr(name="w3"))
        loss = L.mean(L.square(p - y))
        opt = fluid.optimizer.Adam(5e-3)
        if leg == "zero1":
            opt = ShardedUpdateOptimizer(opt, nranks=2, axis_name="dp")
        opt.minimize(loss)
    if leg == "zero1":
        layout = MeshLayout(data=2)
    else:
        apply_pipeline(main, num_stages=2, num_microbatches=2)
        layout = MeshLayout(pipe=2)
    main._mesh_layout = layout
    prog = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=None if leg == "zero1" else loss.name,
        batch_axis="dp")
    return prog, main, startup, loss


def _held(scope):
    return {n: v.detach().numpy().copy() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor) and not n.startswith("@")}


def _same(a, b):
    return set(a) == set(b) and all(np.array_equal(a[n], b[n]) for n in a)


def run_leg(leg, rank, out):
    prog, main, startup, loss = build(leg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    rng = np.random.RandomState(0)
    feeds = [{"x": rng.randn(8, 16).astype("float32"),
              "label": rng.randn(8, 1).astype("float32")}
             for _ in range(STEPS)]
    if rank == 1:
        faultline.arm("grad_nonfinite", action="nan", step=POISON, times=1)
    losses, totals, snaps = [], [], []
    try:
        for i, feed in enumerate(feeds):
            snaps.append(_held(scope))
            losses.append(float(np.asarray(exe.run(
                prog, feed=feed, fetch_list=[loss],
                scope=scope)[0]).reshape(-1)[0]))
            totals.append(int(scope.find_var(
                guardrails.GUARD_SKIP_TOTAL)))
    finally:
        faultline.disarm()
    snaps.append(_held(scope))
    out[f"{leg}/losses"] = np.array(losses)
    out[f"{leg}/skipped_total"] = np.array(totals)
    out[f"{leg}/kept"] = np.array(_same(snaps[POISON], snaps[POISON + 1]))
    out[f"{leg}/moved"] = np.array(
        not _same(snaps[POISON + 1], snaps[POISON + 2]))
    h = hashlib.sha256()
    params = {p.name for p in main.all_parameters()}
    for n, a in sorted(snaps[-1].items()):
        if n not in params:
            continue
        h.update(n.encode())
        h.update(np.ascontiguousarray(a).tobytes())
    out[f"{leg}/digest"] = np.array(h.hexdigest())


def main_(legs, out_dir):
    torch.set_num_threads(1)
    set_flags({"guard_nonfinite": True,
               "flight_dump_dir": os.path.join(out_dir, "flight")})
    fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
    rank = fleet.worker_index()
    out = {}
    for leg in legs.split(","):
        run_leg(leg, rank, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main_(*sys.argv[1:3])
