"""Rank program for the port's pipeline tests, started by
``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo.

    launch --nproc N --backend gloo --timeout T tests/torch_pipe_runner.py \\
        LEGS IN.npz OUT_DIR

``LEGS`` is a comma-separated list of the legs of :data:`MLP_LEGS`,
``bert``, ``bert_drop``, ``ckpt``, ``pipeopt`` and ``gpipe``, run in
turn in one launch on the N ranks:

* an MLP leg: the two-hidden-layer MLP of ``tests/test_pipeline.py``
  built in the port, rewritten as :data:`MLP_LEGS` says, compiled
  ``with_mesh`` over its layout, its parameters set to ``IN.npz``'s
  ``mlp/init/*`` and trained STEPS Adam steps on the global batches
  ``mlp/x<i>`` / ``mlp/y<i>``; saved: the losses, every parameter's
  global value and the last step's ``last_pipeline_report()``;
* ``bert``: BERT-tiny (``build_pretrain_network_parallel``, dropout 0)
  through ``fleet`` with ``strategy.pipeline`` (2 stages, 4 microbatches)
  from ``bert/init/*``, STEPS Adam steps on ``bert/b<i>/*``;
* ``bert_drop``: the same program at dropout 0.1 through
  ``apply_pipeline`` and ``with_mesh``, two steps with the
  ``pipe_replay_check`` flag on (every B unit's recomputed boundary held
  to its F unit's bit for bit);
* ``ckpt``: the MLP at dp 2 x pp 2 with pipe-sharded weights, three
  steps, a sharded ``save_checkpoint``, a restore into a fresh scope
  (every persistable as each rank holds it, bit for bit), two more steps
  in both scopes, and a restore onto another pp layout (refused);
* ``pipeopt``: ``PipelineOptimizer`` over two ``device_guard`` stages
  (``tests/test_parallel.py::test_pipeline_optimizer_program_level``);
* ``gpipe``: ``gpipe_spmd`` of ``IN.npz``'s ``gpipe/ws`` (rank r its
  stage's) on ``gpipe/xs``, and the gradient of the outputs' sum.

Each rank writes ``OUT_DIR/rank<r>.npz``.  Ranks run one intra-op
thread.  Imports the port only."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from paddle_tpu_torch import fluid, io, parallel  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import (  # noqa: E402
    DistributedStrategy, PaddleCloudRoleMaker)
from paddle_tpu_torch.framework import unique_name  # noqa: E402
from paddle_tpu_torch.framework.executor import (  # noqa: E402
    last_pipeline_report)
from paddle_tpu_torch.framework.mesh_layout import MeshLayout  # noqa
from paddle_tpu_torch.framework.pipe import apply_pipeline  # noqa: E402
from paddle_tpu_torch.models import bert  # noqa: E402
from paddle_tpu_torch.ops.collective_ops import (  # noqa: E402
    DataParallelGroup, whole_of)

STEPS = 5
MLP_LR = 5e-3
BERT_LR = 1e-4
#: leg -> (layout sizes, the rewrite, ZeRO-1)
MLP_LEGS = {
    "pp2": ({"pipe": 2}, dict(num_stages=2, num_microbatches=2), False),
    "pp2_interleaved": ({"pipe": 2}, dict(num_stages=2, num_microbatches=4,
                                          schedule="interleaved", chunks=2),
                        False),
    "pp2_shard": ({"pipe": 2}, dict(num_stages=2, num_microbatches=4,
                                    shard_weights=True, min_shard_numel=1),
                  False),
    "pp4": ({"pipe": 4}, dict(num_stages=4, num_microbatches=4), False),
    "pp4_zero_bubble": ({"pipe": 4}, dict(num_stages=4, num_microbatches=4,
                                          schedule="zero_bubble"), False),
    "dp2pp2": ({"data": 2, "pipe": 2},
               dict(num_stages=2, num_microbatches=4), False),
    "dp2pp2_zero1": ({"data": 2, "pipe": 2},
                     dict(num_stages=2, num_microbatches=2), True),
}


def mlp_model():
    """``tests/test_pipeline.py::_model`` in the port."""
    L = fluid.layers
    x = L.data("x", shape=[-1, 16], append_batch_size=False)
    y = L.data("label", shape=[-1, 1], dtype="float32",
               append_batch_size=False)
    h = L.fc(x, 32, act="relu", param_attr=fluid.ParamAttr(name="w1"))
    h = L.fc(h, 32, act="relu", param_attr=fluid.ParamAttr(name="w2"))
    p = L.fc(h, 1, param_attr=fluid.ParamAttr(name="w3"))
    return L.mean(L.square(p - y))


def _fill(scope, main, inp, prefix):
    for p in main.all_parameters():
        scope.set_var(p.name, torch.from_numpy(
            np.array(inp[f"{prefix}/init/{p.name}"])))


def _globals(dp, scope, main):
    return {p.name: whole_of(dp, p, scope.find_var(p.name)).detach().numpy()
            .copy() for p in main.all_parameters()}


def _report():
    rep = last_pipeline_report()
    return np.array(json.dumps(rep))


def build_mlp(leg):
    sizes, rewrite, zero1 = MLP_LEGS[leg]
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss = mlp_model()
        opt = fluid.optimizer.Adam(MLP_LR)
        if zero1:
            from paddle_tpu_torch.optimizer import ShardedUpdateOptimizer
            opt = ShardedUpdateOptimizer(opt, nranks=sizes["data"],
                                         axis_name="dp")
        opt.minimize(loss)
    apply_pipeline(main, **rewrite)
    layout = MeshLayout(**sizes)
    main._mesh_layout = layout
    bs = fluid.BuildStrategy()
    bs.fuse_all_reduce_ops = True
    prog = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=None if zero1 else loss.name,
        batch_axis="dp", build_strategy=bs)
    return prog, main, startup, loss


def mlp_leg(leg, inp, out):
    prog, main, startup, loss = build_mlp(leg)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    _fill(scope, main, inp, "mlp")
    losses = []
    for i in range(STEPS):
        losses.append(float(np.asarray(exe.run(
            prog, feed={"x": inp[f"mlp/x{i}"], "label": inp[f"mlp/y{i}"]},
            fetch_list=[loss], scope=scope)[0]).reshape(-1)[0]))
    out[f"{leg}/losses"] = np.array(losses)
    out[f"{leg}/report"] = _report()
    for n, v in _globals(prog._dp, scope, main).items():
        out[f"{leg}/p/{n}"] = v


def bert_cfg(dropout=0.0):
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = dropout
    cfg.attention_probs_dropout_prob = dropout
    return cfg


def bert_feeds(inp, i):
    pre = f"bert/b{i}/"
    return {k[len(pre):]: inp[k] for k in inp if k.startswith(pre)}


def bert_leg(inp, out):
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.program_guard(main, startup):
        _, loss = bert.build_pretrain_network_parallel(bert_cfg())
        s = DistributedStrategy()
        s.pipeline = True
        s.pipeline_configs = {"accumulate_steps": 4, "num_stages": 2}
        fleet.distributed_optimizer(fluid.optimizer.Adam(BERT_LR),
                                    s).minimize(loss)
    prog = fleet.main_program
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    _fill(scope, main, inp, "bert")
    losses = [float(np.asarray(exe.run(
        prog, feed=bert_feeds(inp, i), fetch_list=[loss],
        scope=scope)[0]).reshape(-1)[0]) for i in range(STEPS)]
    out["bert/losses"] = np.array(losses)
    out["bert/report"] = _report()
    for n, v in _globals(prog._dp, scope, main).items():
        out[f"bert/p/{n}"] = v


def bert_drop_leg(inp, out):
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = main.random_seed = 3
    with fluid.program_guard(main, startup):
        _, loss = bert.build_pretrain_network_parallel(bert_cfg(0.1))
        fluid.optimizer.Adam(BERT_LR).minimize(loss)
    apply_pipeline(main, 2, 4)
    layout = MeshLayout(pipe=2)
    prog = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name, batch_axis="dp")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    fluid.set_flags({"pipe_replay_check": True})
    try:
        losses, checked, mismatched = [], 0, 0
        for i in range(2):
            losses.append(float(np.asarray(exe.run(
                prog, feed=bert_feeds(inp, i), fetch_list=[loss],
                scope=scope)[0]).reshape(-1)[0]))
            rep = last_pipeline_report()
            checked += rep["replay_checked"]
            mismatched += rep["replay_mismatched"]
    finally:
        fluid.set_flags({"pipe_replay_check": False})
    out["bert_drop/losses"] = np.array(losses)
    out["bert_drop/replay"] = np.array([checked, mismatched])


def _held(scope, main):
    return {v.name: scope.find_var(v.name).detach().numpy().copy()
            for v in main.list_vars()
            if v.persistable and torch.is_tensor(scope.find_var(v.name))}


def ckpt_leg(inp, out, tmp):
    from paddle_tpu_torch.framework.errors import UnimplementedError
    sizes = {"data": 2, "pipe": 2}
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        loss = mlp_model()
        fluid.optimizer.Adam(MLP_LR).minimize(loss)
    apply_pipeline(main, 2, 2, shard_weights=True, min_shard_numel=1)
    layout = MeshLayout(**sizes)
    main._mesh_layout = layout
    prog = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name, batch_axis="dp")
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    _fill(scope, main, inp, "mlp")

    def step(sc, i):
        return float(np.asarray(exe.run(
            prog, feed={"x": inp[f"mlp/x{i}"], "label": inp[f"mlp/y{i}"]},
            fetch_list=[loss], scope=sc)[0]).reshape(-1)[0])

    for i in range(3):
        step(scope, i)
    path = os.path.join(tmp, "ckpt")
    io.save_checkpoint(exe, path, io.TrainStatus(3), main, scope=scope,
                       sharded=True)
    saved = _held(scope, main)
    scope2 = fluid.Scope()
    st = io.load_checkpoint(exe, path, main_program=main, scope=scope2)
    fluid.sync_prepared_state(scope2)
    got = _held(scope2, main)
    differ = sorted(n for n in saved
                    if n not in got or saved[n].shape != got[n].shape
                    or not np.array_equal(saved[n], got[n]))
    out["ckpt/epoch"] = np.array(st.epoch_no)
    out["ckpt/differ"] = np.array(json.dumps(differ))
    out["ckpt/held_bytes"] = np.array(sum(a.nbytes for a in saved.values()))
    out["ckpt/losses_a"] = np.array([step(scope, i) for i in (3, 4)])
    out["ckpt/losses_b"] = np.array([step(scope2, i) for i in (3, 4)])
    try:
        io.load_checkpoint(exe, path, main_program=main,
                           scope=fluid.Scope(), dst_layout=MeshLayout(data=4))
        out["ckpt/refused"] = np.array("")
    except UnimplementedError as e:
        out["ckpt/refused"] = np.array(str(e))


def pipeopt_leg(inp, out):
    L = fluid.layers
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = L.data("x", shape=[6])
        with fluid.device_guard("gpu:0"):
            h = L.fc(x, 8, act="relu", bias_attr=False,
                     param_attr=fluid.ParamAttr(
                         name="pw1",
                         initializer=fluid.initializer.Constant(0.05)))
        with fluid.device_guard("gpu:1"):
            y = L.fc(h, 8, bias_attr=False, param_attr=fluid.ParamAttr(
                name="pw2", initializer=fluid.initializer.Constant(0.05)))
            loss = L.mean(L.square(y))
        parallel.PipelineOptimizer(fluid.optimizer.SGD(0.1),
                                   num_microbatches=4).minimize(loss)
        pipe_loss = main.global_block().var(loss.name + "@pipeline")
    layout = MeshLayout(pipe=2)
    prog = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=None, batch_axis=None)
    exe = fluid.Executor(fluid.CPUPlace())
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    out["pipeopt/losses"] = np.array([float(np.asarray(exe.run(
        prog, feed={"x": inp[f"pipeopt/b{i}"]}, fetch_list=[pipe_loss],
        scope=scope)[0]).reshape(-1)[0]) for i in range(3)])


def gpipe_leg(inp, out):
    g = DataParallelGroup.current("pp")
    w = torch.from_numpy(np.array(inp["gpipe/ws"][g.rank])) \
        .requires_grad_(True)
    xs = torch.from_numpy(np.array(inp["gpipe/xs"]))
    ys = parallel.gpipe_spmd(lambda p, v: torch.tanh(v @ p), w, xs, "pp",
                             group=g)
    ys.sum().backward()
    out["gpipe/out"] = ys.detach().numpy()
    out["gpipe/grad"] = w.grad.numpy()


def main_(legs, in_path, out_dir):
    torch.set_num_threads(1)
    fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
    rank = fleet.worker_index()
    inp = dict(np.load(in_path))
    out = {}
    for leg in legs.split(","):
        if leg in MLP_LEGS:
            mlp_leg(leg, inp, out)
        elif leg == "bert":
            bert_leg(inp, out)
        elif leg == "bert_drop":
            bert_drop_leg(inp, out)
        elif leg == "ckpt":
            ckpt_leg(inp, out, out_dir)
        elif leg == "pipeopt":
            pipeopt_leg(inp, out)
        elif leg == "gpipe":
            gpipe_leg(inp, out)
        else:
            raise SystemExit(f"unknown leg {leg!r}")
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    main_(*sys.argv[1:4])
