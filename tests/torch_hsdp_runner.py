"""Rank program for the port's HSDP and sharded-checkpoint tests, started
by ``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo.

    launch --nproc 4 --backend gloo --timeout T tests/torch_hsdp_runner.py \\
        mesh2d IN.npz OUT_DIR
    launch --nproc 4 ... hsdp IN.npz OUT_DIR
    launch --nproc N ... mlp LAYOUT IN.npz [CKPT] OUT_DIR

``mesh2d``: the collective ops over the axes of a 2 x 2 ``dp`` x ``fsdp``
mesh (:data:`MESH2D_CASES`) on this rank's inputs (``IN.npz`` holds
``r<rank>/<slot>`` arrays), and ``fsdp_all_gather``'s gradient over the
fsdp line for the cotangent ``G``.
``hsdp``: BERT-tiny pretraining (``fuse_add_layernorm``, AdamW 0.01 with
warmup and decay, dropout 0) rewritten by ``apply_fsdp_sharding(main,
MeshLayout(data=2, fsdp=2))`` and compiled with ``with_mesh`` (bucketed
gradient sync), from the startup parameters and batches in ``IN.npz``,
through ``Executor.run`` and then ``prepare(donate_state=True)``; after
step 3 of the prepared run it saves ``save_checkpoint(sharded=True)``
under ``OUT_DIR/ckpt`` and the same state through ``AsyncCheckpointer``
under ``OUT_DIR/async``.
``mlp``: a three-layer MLP with Adam under LAYOUT — ``d2f2`` (HSDP),
``f4``, ``d2`` (plain data parallelism over ``with_mesh``) or ``zero1d2``
(``strategy.sharding`` through fleet on two ranks) — from the parameters
in ``IN.npz`` or, with CKPT, from ``load_checkpoint(CKPT)``; it runs the
batches ``b<i>`` of ``IN.npz`` and, when ``IN.npz`` has ``save_at``,
saves a sharded checkpoint under ``OUT_DIR/ckpt`` after that step, and
the same state through ``AsyncCheckpointer`` under ``OUT_DIR/async``,
joined after the last step.  Every mode writes ``OUT_DIR/rank<r>.npz``.
Imports the port only."""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from paddle_tpu_torch import fluid, io  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import (  # noqa: E402
    DistributedStrategy, PaddleCloudRoleMaker)
from paddle_tpu_torch.framework import unique_name  # noqa: E402
from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding  # noqa
from paddle_tpu_torch.framework.mesh_layout import (  # noqa: E402
    MeshLayout, ProcessMesh)
from paddle_tpu_torch.framework.passes import apply_pass  # noqa: E402
from paddle_tpu_torch.framework.serialization import (  # noqa: E402
    program_to_desc)
from paddle_tpu_torch.models import bert  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402
from paddle_tpu_torch.ops.collective_ops import (  # noqa: E402
    MeshGroups, whole_of)

#: (case, op type, attrs) of the mesh2d mode, each on input slot X (Q
#: for the quantized and ZeRO scatters)
MESH2D_CASES = [
    ("allreduce_dp", "c_allreduce_sum", {"_axis_name": "dp"}, "X"),
    ("allreduce_fsdp", "c_allreduce_sum", {"_axis_name": "fsdp"}, "X"),
    ("allreduce_both", "c_allreduce_sum", {"_axis_name": ("dp", "fsdp")},
     "X"),
    ("zero_reduce_scatter_dp_fsdp", "zero_reduce_scatter",
     {"_axis_name": ("dp", "fsdp"), "scale": 0.25, "align": 128}, "Q"),
    ("zero_reduce_scatter_fsdp_dp", "zero_reduce_scatter",
     {"_axis_name": ("fsdp", "dp"), "align": 128}, "Q"),
    ("zero_reduce_scatter_fsdp", "zero_reduce_scatter",
     {"_axis_name": "fsdp"}, "X"),
    ("quant_reduce_scatter_int8", "quant_reduce_scatter",
     {"_axis_name": ("dp", "fsdp"),
      "quant_spec": {"dtype": "int8", "block_size": 256}, "scale": 0.25},
     "Q"),
    ("quant_reduce_scatter_int4", "quant_reduce_scatter",
     {"_axis_name": ("fsdp", "dp"),
      "quant_spec": {"dtype": "int4", "block_size": 128}}, "Q"),
    ("zero_shard_slice_fsdp", "zero_shard_slice",
     {"_axis_name": "fsdp", "align": 128}, "Q"),
    ("zero_shard_slice_dp_fsdp", "zero_shard_slice",
     {"_axis_name": ("dp", "fsdp")}, "X"),
    ("zero_all_gather_fsdp", "zero_all_gather",
     {"_axis_name": "fsdp", "numel": 60, "shape": [6, 10]}, "S"),
    ("zero_all_gather_dp", "zero_all_gather",
     {"_axis_name": "dp", "numel": 50, "shape": [5, 10]}, "S"),
    ("fsdp_all_gather", "fsdp_all_gather",
     {"_axis_name": "fsdp", "gather_dim": 1}, "X"),
]

#: the MLP's layouts: (MeshLayout sizes, or None for ZeRO-1 over fleet)
MLP_LAYOUTS = {"d2f2": {"data": 2, "fsdp": 2}, "f4": {"fsdp": 4},
               "d2": {"data": 2}, "zero1d2": None}
MLP_MIN_SHARD_NUMEL = 64


def _init(rank):
    torch.set_num_threads(2)
    fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
    assert fleet.worker_index() == rank
    return fleet.worker_num()


def _cfg():
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def mesh2d(inputs, out_dir):
    rank = int(os.environ["RANK"])
    assert _init(rank) == 4
    data = np.load(inputs)
    groups = MeshGroups.of(ProcessMesh(("dp", "fsdp"), (2, 2)))
    assert groups.coords == {"dp": rank // 2, "fsdp": rank % 2}
    ctx = registry.LoweringContext(torch.Generator(), torch.device("cpu"),
                                   dp=groups)
    assert ctx.axis_names == ("dp", "fsdp")
    out = {}
    for case, op, attrs, slot in MESH2D_CASES:
        xin = torch.from_numpy(data[f"r{rank}/{slot}"])
        out[case] = registry.get_op(op)(ctx, {"X": [xin]},
                                        dict(attrs))["Out"].numpy()
    xg = torch.from_numpy(data[f"r{rank}/X"]).requires_grad_(True)
    full = registry.get_op("fsdp_all_gather")(
        ctx, {"X": [xg]}, {"_axis_name": "fsdp", "gather_dim": 1})["Out"]
    torch.autograd.backward(full, torch.from_numpy(data[f"r{rank}/G"]))
    out["fsdp_grad"] = xg.grad.numpy()
    out["routes"] = np.array(sorted(
        f"{k[0]}:{k[2]}" for k in registry.route_counts()))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def hsdp_optimizer():
    """AdamW 0.01 with warmup into linear decay (no norm clip)."""
    lr = fluid.layers.linear_lr_warmup(
        fluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2, 0.0,
        1e-3)
    return fluid.optimizer.AdamW(lr, weight_decay=0.01)


def build_hsdp():
    """The user's HSDP program: BERT-tiny, the fusion passes, the
    optimizer of :func:`hsdp_optimizer`, ``apply_fsdp_sharding`` over
    ``MeshLayout(data=2, fsdp=2)`` and ``with_mesh`` with bucketed
    gradient sync.  Returns (compiled, main, loss)."""
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg())
        hsdp_optimizer().minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    layout = MeshLayout(data=2, fsdp=2)
    apply_fsdp_sharding(main, layout)
    main._mesh_layout = layout
    build = fluid.BuildStrategy()
    build.fuse_elewise_add_act_ops = True
    build.fuse_all_reduce_ops = True
    compiled = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name,
        batch_axis=layout.batch_axes, build_strategy=build)
    return compiled, main, total


def _global_state(groups, main, scope):
    """Every persistable's global value (every rank calls this in the
    same order: the gathers are collectives)."""
    out = {}
    for v in sorted(main.list_vars(), key=lambda v: v.name):
        if v.persistable and scope.find_var(v.name) is not None:
            out[v.name] = io._to_numpy(
                whole_of(groups, v, scope.find_var(v.name))).copy()
    return out


def _load(inputs):
    data = np.load(inputs)
    init = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    steps = len({k.split("/", 1)[0] for k in data.files
                 if k.startswith("b")})
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(steps)]
    return data, init, batches


def _fill(scope, main, init):
    dtypes = {v.name: v.dtype for v in main.list_vars()}
    names = [v.name for v in main.list_vars()
             if v.persistable and v.name in init]
    for n, t in io.convert_params({n: init[n] for n in names}, "cpu",
                                  dtypes).items():
        scope.set_var(n, t)


def hsdp(inputs, out_dir):
    rank = int(os.environ["RANK"])
    assert _init(rank) == 4
    _, init, batches = _load(inputs)
    out = {}
    for entry in ("run", "prepare"):
        registry.reset_route_counts()
        compiled, main, total = build_hsdp()
        groups = compiled._dp
        scope = fluid.Scope()
        _fill(scope, main, init)
        exe = fluid.Executor(fleet.place)
        if entry == "run":
            losses = [float(exe.run(compiled, feed=b, fetch_list=[total],
                                    scope=scope)[0]) for b in batches]
        else:
            step = exe.prepare(compiled, fetch_list=[total], scope=scope,
                               donate_state=True)
            losses = []
            for i, b in enumerate(batches):
                losses.append(float(step.run(b)[0]))
                if i == 2:
                    io.save_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                                       io.TrainStatus(3), main, scope=scope,
                                       sharded=True)
                    ck = io.AsyncCheckpointer()
                    ck.save(exe, os.path.join(out_dir, "async"),
                            io.TrainStatus(3), main, scope=scope)
                    ck.wait()
                    for n, a in _global_state(groups, main, scope).items():
                        out[f"saved/{n}"] = a
            fluid.sync_prepared_state(scope)
        out[f"{entry}/losses"] = np.array(losses)
        for n in sorted(v.name for v in main.list_vars() if v.persistable):
            t = scope.find_var(n)
            if t is not None:
                out[f"{entry}/held/{n}"] = np.array(t.numel() *
                                                    t.element_size())
        for n, a in _global_state(groups, main, scope).items():
            out[f"{entry}/p/{n}"] = a
        out[f"{entry}/routes"] = np.array(sorted(
            f"{k[0]}:{k[2]}:{v // len(batches)}"
            for k, v in registry.route_counts().items()))
    out["coords"] = np.array([groups.coords["dp"], groups.coords["fsdp"]])
    out["desc"] = np.array(json.dumps(program_to_desc(main)))
    out.update(clip_leg(init, batches))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def clip_leg(init, batches):
    """HSDP (data 2 x fsdp 2) of the unfused program with AdamW and a
    global-norm clip of 0.05, which binds: the clip's squares of the
    fsdp-sharded gradients are summed over fsdp (``clip/...``)."""
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg())
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2,
            0.0, 1e-3)
        fluid.optimizer.AdamW(
            lr, weight_decay=0.01,
            grad_clip=fluid.clip.GradientClipByGlobalNorm(0.05)
        ).minimize(total)
    layout = MeshLayout(data=2, fsdp=2)
    apply_fsdp_sharding(main, layout)
    build = fluid.BuildStrategy()
    build.fuse_all_reduce_ops = True
    compiled = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name,
        batch_axis=layout.batch_axes, build_strategy=build)
    scope = fluid.Scope()
    _fill(scope, main, init)
    exe = fluid.Executor(fleet.place)
    out = {"clip/losses": np.array([
        float(exe.run(compiled, feed=b, fetch_list=[total],
                      scope=scope)[0]) for b in batches])}
    for n, a in _global_state(compiled._dp, main, scope).items():
        out[f"clip/p/{n}"] = a
    out["clip/types"] = np.array([op.type for op in main.global_block().ops])
    return out


def mlp_model():
    """x[16] -> fc 32 relu -> fc 32 relu -> fc 4, softmax cross-entropy;
    the weights are w1, w2, w3 (no biases)."""
    x = fluid.layers.data("x", shape=[16])
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    h = x
    for name, width, act in (("w1", 32, "relu"), ("w2", 32, "relu"),
                             ("w3", 4, None)):
        h = fluid.layers.fc(h, width, act=act,
                            param_attr=fluid.ParamAttr(name=name),
                            bias_attr=False)
    return fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(h, label))


def build_mlp(layout_name):
    """The MLP under ``layout_name`` (:data:`MLP_LAYOUTS`) with Adam 5e-3.
    Returns (the program to run, main, loss)."""
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    sizes = MLP_LAYOUTS[layout_name]
    with fluid.program_guard(main, startup):
        loss = mlp_model()
        if sizes is None:
            s = DistributedStrategy()
            s.sharding = True
            fleet.distributed_optimizer(fluid.optimizer.Adam(5e-3),
                                        s).minimize(loss)
        else:
            fluid.optimizer.Adam(5e-3).minimize(loss)
    if sizes is None:
        main._mesh_layout = MeshLayout(data=fleet.worker_num())
        return fleet.main_program, main, loss
    layout = MeshLayout(**sizes)
    apply_fsdp_sharding(main, layout, min_shard_numel=MLP_MIN_SHARD_NUMEL)
    main._mesh_layout = layout
    build = fluid.BuildStrategy()
    build.fuse_all_reduce_ops = True
    compiled = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name,
        batch_axis=layout.batch_axes, build_strategy=build)
    return compiled, main, loss


def mlp(layout_name, inputs, *rest):
    ckpt, out_dir = (None, rest[0]) if len(rest) == 1 else rest
    rank = int(os.environ["RANK"])
    _init(rank)
    data, init, batches = _load(inputs)
    program, main, loss = build_mlp(layout_name)
    groups = io._group(main) or getattr(program, "_dp", None)
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    out = {}
    if ckpt is None:
        _fill(scope, main, init)
    else:
        t0 = time.perf_counter()
        st = io.load_checkpoint(exe, ckpt, main_program=main, scope=scope)
        out["load_s"] = np.array(time.perf_counter() - t0)
        out["epoch"] = np.array(st.epoch_no)
        out["bytes_read"] = np.array(st.read_stats["bytes_read"])
        out["planned_bytes"] = np.array(st.read_stats["planned_bytes"])
        out["wire_bytes"] = np.array(
            st.reshard["wire_bytes"] if st.reshard else 0)
        for n, a in _global_state(groups, main, scope).items():
            out[f"loaded/{n}"] = a
    save_at = int(data["save_at"]) if "save_at" in data.files else None
    step = exe.prepare(program, fetch_list=[loss], scope=scope,
                       donate_state=True)
    losses = []
    ck = io.AsyncCheckpointer()
    for i, b in enumerate(batches):
        losses.append(float(step.run(b)[0]))
        if save_at is not None and i + 1 == save_at:
            io.save_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                               io.TrainStatus(save_at), main, scope=scope,
                               sharded=True)
            for n, a in _global_state(groups, main, scope).items():
                out[f"saved/{n}"] = a
            # the same state in the background, joined a step later
            ck.save(exe, os.path.join(out_dir, "async"),
                    io.TrainStatus(save_at), main, scope=scope)
    ck.wait()
    out["losses"] = np.array(losses)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "mesh2d":
        mesh2d(sys.argv[2], sys.argv[3])
    elif mode == "hsdp":
        hsdp(sys.argv[2], sys.argv[3])
    elif mode == "mlp":
        mlp(*sys.argv[2:])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
