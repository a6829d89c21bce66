"""Rank program for the port's ``overlap_grad_sync`` tests, started by
``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo.

    launch --nproc 2 --backend gloo --timeout T \\
        tests/torch_overlap_runner.py legs IN.npz OUT_DIR
    launch --nproc 4 ... hsdp IN.npz OUT_DIR

``legs``: BERT-tiny pretraining (dropout 0, ``fuse_add_layernorm`` and
``fuse_elewise_add_act_ops``) through ``fleet`` in each leg of
:data:`LEGS` in turn, from the startup parameters and batches in
``IN.npz``, one ``prepare(donate_state=True)`` step a batch.  The recipe
is AdamW 0.01 with warmup into linear decay and a global-norm clip of 1.0
(no clip in the ZeRO-1 legs, which refuse one).
``hsdp``: the same network rewritten by ``apply_fsdp_sharding(main,
MeshLayout(data=2, fsdp=2))`` and compiled with ``with_mesh`` and a
``BuildStrategy`` with ``overlap_grad_sync``, with ``overlap_lowering``
on and off, and fleet with ``strategy.mesh = MeshLayout(data=2,
fsdp=2).build_mesh()`` (four-rank data parallelism over ``with_mesh``).

Each leg saves its losses, every parameter's global value, the op types
of its program, and what the gradient sync of its last step did (the
hooked buckets by ``_bucket_index``, the order their hooks fired, the
gradient-sync ops run at the tail, the exposed milliseconds).  Each rank
writes ``OUT_DIR/rank<r>.npz``.  Imports the port only."""

from __future__ import annotations

import json
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from paddle_tpu_torch import flags, fluid, io  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import (  # noqa: E402
    DistributedStrategy, PaddleCloudRoleMaker)
from paddle_tpu_torch.framework import unique_name  # noqa: E402
from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding  # noqa
from paddle_tpu_torch.framework.mesh_layout import MeshLayout  # noqa: E402
from paddle_tpu_torch.framework.passes import apply_pass  # noqa: E402
from paddle_tpu_torch.framework.serialization import (  # noqa: E402
    program_to_desc)
from paddle_tpu_torch.models import bert  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402
from paddle_tpu_torch.ops.collective_ops import whole_of  # noqa: E402

#: leg -> the strategy it sets: ``overlap`` (overlap_grad_sync at
#: bucket_mb 4, min_buckets 4), ``quant`` (the int8 tier, block 256),
#: ``sharding`` (ZeRO-1), ``amp``, ``gm`` (gradient_merge k_steps),
#: ``recompute`` (one checkpoint a layer), ``mesh`` (strategy.mesh =
#: MeshLayout(data=2).build_mesh()),
#: ``nccl`` (nccl_comm_num 2 and use_hierarchical_allreduce), ``fsdp``
#: (ZeRO-3 outside fleet: apply_fsdp_sharding over MeshLayout(fsdp=2) and
#: with_mesh, no clip; the replicated parameters' buckets share their
#: ranks with the gathers).  A leg named ``*off`` runs with
#: flags.overlap_lowering off
LEGS = {
    "classic": {},
    "on": {"overlap": True},
    "off": {"overlap": True},
    "mesh_on": {"overlap": True, "mesh": True},
    "nccl": {"nccl": True},
    "int8_on": {"overlap": True, "quant": "int8"},
    "int8_off": {"overlap": True, "quant": "int8"},
    "zero1": {"sharding": True},
    "zero1_on": {"sharding": True, "overlap": True},
    "amp_gm_on": {"overlap": True, "amp": True, "gm": 2},
    "amp_gm_off": {"overlap": True, "amp": True, "gm": 2},
    "recompute_on": {"overlap": True, "recompute": True},
    "zero3_on": {"overlap": True, "fsdp": True},
    "zero3_off": {"overlap": True, "fsdp": True},
}


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


def _optimizer(clip=True):
    lr = fluid.layers.linear_lr_warmup(
        fluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2, 0.0,
        1e-3)
    return fluid.optimizer.AdamW(
        lr, weight_decay=0.01,
        grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0) if clip
        else None)


def _checkpoints(main):
    """Each encoder layer's last LayerNorm output."""
    return [op.output("Y")[0] for op in main.global_block().ops
            if op.type == "layer_norm"
            and op.input("Scale")[0].endswith("_ln2_scale")]


def build_leg(leg):
    """The leg's program through fleet.  Returns (the program to run,
    main, startup, loss)."""
    conf = LEGS[leg]
    if conf.get("fsdp"):
        return build_zero3()
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg())
        s = DistributedStrategy()
        s.build_strategy = fluid.BuildStrategy()
        s.build_strategy.fuse_elewise_add_act_ops = True
        if conf.get("overlap"):
            s.overlap_grad_sync = True
            s.overlap_configs = {"bucket_mb": 4, "min_buckets": 4}
        if conf.get("quant"):
            s.quant_allreduce = True
            s.quant_configs = {"dtype": conf["quant"], "block_size": 256,
                               "stochastic_rounding": False}
        s.sharding = bool(conf.get("sharding"))
        s.amp = bool(conf.get("amp"))
        if conf.get("gm"):
            s.gradient_merge = True
            s.gradient_merge_configs = {"k_steps": conf["gm"], "avg": True}
        if conf.get("recompute"):
            s.recompute = True
            s.recompute_configs = {"checkpoints": _checkpoints(main)}
        if conf.get("mesh"):
            s.mesh = MeshLayout(data=2).build_mesh()
        if conf.get("nccl"):
            s.nccl_comm_num = 2
            s.use_hierarchical_allreduce = True
        fleet.distributed_optimizer(_optimizer(not s.sharding),
                                    s).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    return fleet.main_program, main, startup, total


def build_zero3():
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg())
        _optimizer(False).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    layout = MeshLayout(fsdp=2)
    apply_fsdp_sharding(main, layout)
    build = fluid.BuildStrategy()
    build.fuse_all_reduce_ops = True
    build.overlap_grad_sync = True
    compiled = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name,
        batch_axis=layout.batch_axes, build_strategy=build)
    return compiled, main, startup, total


def build_hsdp(leg):
    """HSDP 2 x 2: ``on`` / ``off`` (apply_fsdp_sharding + with_mesh,
    overlap_grad_sync), or ``fleet_mesh`` (fleet over a data x fsdp
    strategy.mesh, no parameter sharded)."""
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    layout = MeshLayout(data=2, fsdp=2)
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg())
        if leg == "fleet_mesh":
            s = DistributedStrategy()
            s.mesh = layout.build_mesh()
            s.overlap_grad_sync = True
            fleet.distributed_optimizer(_optimizer(False),
                                        s).minimize(total)
        else:
            _optimizer(False).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    if leg == "fleet_mesh":
        return fleet.main_program, main, startup, total
    apply_fsdp_sharding(main, layout)
    main._mesh_layout = layout
    build = fluid.BuildStrategy()
    build.fuse_all_reduce_ops = True
    build.overlap_grad_sync = True
    build.overlap_min_buckets = 4
    compiled = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name,
        batch_axis=layout.batch_axes, build_strategy=build)
    return compiled, main, startup, total


def _load(inputs):
    data = np.load(inputs)
    init = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    steps = len({k.split("/", 1)[0] for k in data.files
                 if k.startswith("b")})
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(steps)]
    return init, batches


def run_leg(leg, compiled, main, startup, total, init, batches, out):
    """The leg's steps after its startup, the values in ``init`` set over
    it by name; its results into ``out``."""
    flags.set_flags({"overlap_lowering": not leg.endswith("off")})
    registry.reset_route_counts()
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    exe.run(startup, scope=scope)
    dtypes = {v.name: v.dtype for v in main.list_vars()}
    names = [v.name for v in main.list_vars()
             if v.persistable and v.name in init]
    for n, t in io.convert_params({n: init[n] for n in names}, "cpu",
                                  dtypes).items():
        scope.set_var(n, t)
    step = exe.prepare(compiled, fetch_list=[total], scope=scope,
                       donate_state=True)
    out[f"{leg}/losses"] = np.array([float(step.run(b)[0])
                                     for b in batches])
    fluid.sync_prepared_state(scope)
    groups = compiled._dp
    for p in sorted(main.all_parameters(), key=lambda p: p.name):
        out[f"{leg}/p/{p.name}"] = io._to_numpy(
            whole_of(groups, p, scope.find_var(p.name))).copy()
    rec = step.grad_sync
    if rec is not None:
        out[f"{leg}/hooked"] = np.array(rec.hooked, dtype=np.int64)
        out[f"{leg}/fired"] = np.array(rec.fired, dtype=np.int64)
        out[f"{leg}/tail"] = np.array(rec.tail)
        out[f"{leg}/exposed_ms"] = np.array(rec.exposed_ms())
    out[f"{leg}/ops"] = np.array(
        [op.type for op in main.global_block().ops])
    out[f"{leg}/desc"] = np.array(json.dumps(program_to_desc(main)))
    out[f"{leg}/fallbacks"] = np.array(
        sum(registry.route_counts("fallback").values()))
    flags.set_flags({"overlap_lowering": True})


def main_legs(inputs, out_dir, build, legs):
    rank = int(os.environ["RANK"])
    _init(rank)
    init, batches = _load(inputs)
    out = {}
    for leg in legs:
        run_leg(leg, *build(leg), init, batches, out)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "legs":
        main_legs(sys.argv[2], sys.argv[3], build_leg, list(LEGS))
    elif mode == "hsdp":
        main_legs(sys.argv[2], sys.argv[3], build_hsdp,
                  ["on", "off", "fleet_mesh"])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
