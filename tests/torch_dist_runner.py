"""Rank program for the port's multi-rank tests, started by
``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo.

    launch --nproc N --backend gloo --timeout T tests/torch_dist_runner.py \\
        collectives IN.npz OUT_DIR
    launch --nproc 2 --backend gloo --timeout T tests/torch_dist_runner.py \\
        dp IN.npz TIER OUT_DIR
    launch --nproc 2 --backend gloo --timeout T tests/torch_dist_runner.py \\
        localsgd IN.npz K OUT_DIR

``collectives``: every ported collective op on this rank's inputs
(``IN.npz`` holds ``r<rank>/<case>`` arrays), outputs saved per case, and
``fsdp_all_gather``'s gradient for the cotangent ``G``.
``zero1``: BERT-tiny pretraining through ``fleet`` with
``strategy.sharding`` (ZeRO-1) in the TIER ``fp32`` / ``bf16`` (the
scatter in bf16) / ``int8`` / ``int4`` (the quantized scatter) /
``amp`` (``strategy.amp``), with AdamW (0.01, warmup and decay, no norm
clip), or ``sgd`` / ``momentum``; ``zero3``: the AdamW program rewritten
by ``apply_fsdp_sharding(main, MeshLayout(fsdp=2))`` and compiled with
``CompiledProgram.with_mesh``.  Both run like ``dp`` and save every
persistable's global value (the blocks gathered) and the program desc.
``zero3`` then runs the auto-shard legs (:func:`auto_legs`, saved under
``auto/``): the unfused AdamW program with a global-norm clip of 0.05
(which binds) and of 1e9 (which never does) hand-built at fsdp 2, the
0.05 one hand-built at dp 2 through fleet, and through fleet's
``auto_shard`` without a budget, with a budget halfway between the free
plan's peaks, and with one nothing fits.
``zero1ckpt IN.npz CKPT OUT_DIR``: the fp32 ZeRO-1 program loads the
checkpoint under CKPT (the JAX package's), saves each rank's blocks
right after, trains 2 steps and saves a checkpoint of its own under
``OUT_DIR/ckpt``.
``localsgd``: a small regression MLP through ``fleet`` with
``strategy.localsgd`` (SGD 0.2, ``k_steps`` K), each rank on its own rows
of the global batches in ``IN.npz`` (one ``prepare(donate_state=True)``
step a batch); it saves its parameters after every step, the program's
op types and the step's predicate reads.
``dp``: BERT-tiny pretraining through ``fleet`` with the fused AdamW
recipe, from the startup parameters and batches in ``IN.npz`` (one step
a batch), for the fp32 / int8 / int4 tier of the gradient all-reduce or
``amp`` (``strategy.amp``: bf16 compute, fp32 gradient sync), through
``Executor.run`` and then ``Executor.prepare(donate_state=True)``; then
rank 0 alone saves its persistables and a checkpoint, and both ranks
take one more step.  Each rank writes ``OUT_DIR/rank<r>.npz``.  Imports the port only."""

from __future__ import annotations

import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import torch  # noqa: E402

from paddle_tpu_torch import fluid, io  # noqa: E402
from paddle_tpu_torch.distributed import fleet  # noqa: E402
from paddle_tpu_torch.distributed.fleet import (  # noqa: E402
    DistributedStrategy, PaddleCloudRoleMaker)
from paddle_tpu_torch.framework import unique_name  # noqa: E402
from paddle_tpu_torch.framework.passes import apply_pass  # noqa: E402
from paddle_tpu_torch.framework.serialization import (  # noqa: E402
    program_to_desc)
from paddle_tpu_torch.models import bert  # noqa: E402
from paddle_tpu_torch.ops import registry  # noqa: E402
from paddle_tpu_torch.ops.collective_ops import (  # noqa: E402
    DataParallelGroup)

#: (case, op type, attrs, input slots) for the collectives mode
COLLECTIVE_CASES = [
    ("allreduce_sum", "c_allreduce_sum", {}, ("X",)),
    ("allreduce_sum_bf16", "c_allreduce_sum",
     {"compress_dtype": "bfloat16"}, ("X",)),
    ("allreduce_max", "c_allreduce_max", {}, ("X",)),
    ("allreduce_min", "c_allreduce_min", {}, ("X",)),
    ("allreduce_prod", "c_allreduce_prod", {}, ("X",)),
    ("fused_allreduce_sum", "c_fused_allreduce_sum", {"scale": 0.5},
     ("X", "X2")),
    ("fused_allreduce_sum_bf16", "c_fused_allreduce_sum",
     {"compress_dtype": "bfloat16"}, ("X", "X2")),
    ("quant_allreduce_int8", "c_quant_allreduce_sum",
     {"quant_spec": {"dtype": "int8", "block_size": 256}}, ("Q",)),
    ("quant_allreduce_int4", "c_quant_allreduce_sum",
     {"quant_spec": {"dtype": "int4", "block_size": 128}}, ("Q",)),
    ("fused_quant_int8", "c_fused_quant_allreduce_sum",
     {"quant_spec": {"dtype": "int8", "block_size": 256}, "scale": 0.5},
     ("Q", "X2")),
    ("fused_quant_int4", "c_fused_quant_allreduce_sum",
     {"quant_spec": {"dtype": "int4", "block_size": 256}}, ("Q", "X2")),
    ("broadcast", "c_broadcast", {"root": 1}, ("X",)),
    ("allgather", "c_allgather", {}, ("X",)),
    ("allgather_dim1", "c_allgather", {"gather_dim": 1}, ("X",)),
    ("reducescatter", "c_reducescatter", {}, ("R",)),
    ("alltoall", "alltoall", {}, ("R",)),
    ("zero_reduce_scatter", "zero_reduce_scatter",
     {"scale": 0.5, "align": 128}, ("Q",)),
    ("zero_reduce_scatter_bf16", "zero_reduce_scatter",
     {"compress_dtype": "bfloat16"}, ("X",)),
    ("quant_reduce_scatter_int8", "quant_reduce_scatter",
     {"quant_spec": {"dtype": "int8", "block_size": 256}, "scale": 0.5},
     ("Q",)),
    ("quant_reduce_scatter_int4", "quant_reduce_scatter",
     {"quant_spec": {"dtype": "int4", "block_size": 128}}, ("Q",)),
    ("zero_shard_slice", "zero_shard_slice", {"align": 128}, ("Q",)),
    ("zero_shard_slice_unaligned", "zero_shard_slice", {}, ("X",)),
    ("zero_all_gather", "zero_all_gather", {"numel": 60, "shape": [6, 10]},
     ("S",)),
    ("fsdp_all_gather", "fsdp_all_gather", {"gather_dim": 1}, ("X",)),
    ("identity", "c_identity", {}, ("X",)),
    ("sync_calc", "c_sync_calc_stream", {}, ("X",)),
    ("sync_comm", "c_sync_comm_stream", {}, ("X",)),
]
NOOP_OPS = ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id", "barrier")



def _cfg():
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _init(rank):
    torch.set_num_threads(2)
    fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
    assert fleet.worker_index() == rank
    return fleet.worker_num()


def collectives(inputs, out_dir):
    rank = int(os.environ["RANK"])
    world = _init(rank)
    data = np.load(inputs)
    dp = DataParallelGroup.current()
    assert dp is not None and dp.world == world and dp.backend == "gloo"
    ctx = registry.LoweringContext(torch.Generator(), torch.device("cpu"),
                                   dp=dp)
    out = {}
    for case, op, attrs, slots in COLLECTIVE_CASES:
        xs = [torch.from_numpy(data[f"r{rank}/{s}"]) for s in slots]
        ins = {"X": xs} if op.startswith("c_fused") else {"X": xs[:1]}
        res = registry.get_op(op)(ctx, ins, dict(attrs))
        outs = res["Out"] if isinstance(res["Out"], list) else [res["Out"]]
        for i, t in enumerate(outs):
            out[f"{case}/{i}"] = t.numpy()
        if "QScale" in res:
            out[f"{case}/qscale"] = res["QScale"].numpy()
    # fsdp_all_gather's backward: this rank's cotangent G of the gathered
    # tensor comes back as the summed gradient of its shard
    xg = torch.from_numpy(data[f"r{rank}/X"]).requires_grad_(True)
    full = registry.get_op("fsdp_all_gather")(ctx, {"X": [xg]},
                                              {"gather_dim": 1})["Out"]
    torch.autograd.backward(full, torch.from_numpy(data[f"r{rank}/G"]))
    out["fsdp_grad"] = xg.grad.numpy()
    for op in NOOP_OPS:
        assert registry.get_op(op)(ctx, {}, {}) == {}
    out["routes"] = np.array(sorted(
        f"{k[0]}:{k[2]}" for k in registry.route_counts()))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def build_dp(tier):
    """The user's program: BERT-tiny pretraining, the strategy's tier,
    both fusion passes, AdamW 0.01 with warmup and decay, clip 1.0."""
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg())
        s = DistributedStrategy()
        if tier == "amp":
            s.amp = True
        elif tier != "fp32":
            s.quant_allreduce = True
            s.quant_configs = {"dtype": tier, "block_size": 256,
                               "stochastic_rounding": False}
        s.build_strategy = fluid.BuildStrategy()
        s.build_strategy.fuse_elewise_add_act_ops = True
        lr = fluid.layers.linear_lr_warmup(
            fluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2, 0.0,
            1e-3)
        opt = fleet.distributed_optimizer(
            fluid.optimizer.AdamW(
                lr, weight_decay=0.01,
                grad_clip=fluid.clip.GradientClipByGlobalNorm(1.0)), s)
        opt.minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    return main, total


def dp(inputs, tier, out_dir):
    rank = int(os.environ["RANK"])
    _init(rank)
    data = np.load(inputs)
    init = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    steps = len({k.split("/", 1)[0] for k in data.files
                 if k.startswith("b")})
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(steps)]
    out = {}
    for entry in ("run", "prepare"):
        registry.reset_route_counts()
        main, total = build_dp(tier)
        compiled = fleet.main_program
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope = fluid.Scope()
        for n, t in io.convert_params({n: init[n] for n in names},
                                      "cpu").items():
            scope.set_var(n, t)
        exe = fluid.Executor(fleet.place)
        if entry == "run":
            losses = [float(exe.run(compiled, feed=b, fetch_list=[total],
                                    scope=scope)[0]) for b in batches]
        else:
            step = exe.prepare(compiled, fetch_list=[total], scope=scope,
                               donate_state=True)
            losses = [float(step.run(b)[0]) for b in batches]
            fluid.sync_prepared_state(scope)
        out[f"{entry}/losses"] = np.array(losses)
        for n in names:
            out[f"{entry}/p/{n}"] = np.array(scope.find_var(n))
        out[f"{entry}/routes"] = np.array(sorted(
            f"{k[0]}:{k[2]}:{v // steps}"
            for k, v in registry.route_counts().items()))
    # the usual fleet save: rank 0 alone saves the replicated state while
    # rank 1 goes on to the next step's gradient sync; a save that waited
    # on the other rank would hang or cross that collective
    if rank == 0:
        d = os.path.join(out_dir, "rank0_save")
        io.save_persistables(exe, d, main, scope=scope)
        with np.load(os.path.join(d, "params.npz")) as f:
            for n in f.files:
                out[f"rank0_save/{n}"] = f[n]
        ck = io.save_checkpoint(exe, os.path.join(out_dir, "rank0_ckpt"),
                                io.TrainStatus(0), main, scope=scope)
        out["rank0_ckpt_ok"] = np.array(io.validate_checkpoint_dir(ck)[0])
    out["after_save/loss"] = np.array(float(step.run(batches[0])[0]))
    out["desc"] = np.array(__import__("json").dumps(program_to_desc(main)))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


#: ZeRO tiers: (strategy flags, inner optimizer)
ZERO_TIERS = {
    "fp32": ({}, "adamw"),
    "bf16": ({"bf16_allreduce": True}, "adamw"),
    "int8": ({"quant_allreduce": True, "quant_configs": {
        "dtype": "int8", "block_size": 256, "stochastic_rounding": False}},
        "adamw"),
    "int4": ({"quant_allreduce": True, "quant_configs": {
        "dtype": "int4", "block_size": 128, "stochastic_rounding": False}},
        "adamw"),
    "amp": ({"amp": True}, "adamw"),
    "sgd": ({}, "sgd"),
    "momentum": ({}, "momentum"),
}


def zero_optimizer(fluid, kind):
    """The inner optimizer of a ZeRO run: AdamW 0.01 with warmup into
    linear decay (the recipe without its global-norm clip, which ZeRO-1
    refuses), SGD or Momentum."""
    lr = fluid.layers.linear_lr_warmup(
        fluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2, 0.0,
        1e-3)
    if kind == "sgd":
        return fluid.optimizer.SGD(0.05)
    if kind == "momentum":
        return fluid.optimizer.Momentum(0.02, 0.9)
    return fluid.optimizer.AdamW(lr, weight_decay=0.01)


def build_zero(mode, tier):
    """The user's ZeRO program: ``zero1`` through fleet's
    ``strategy.sharding``, ``zero3`` through ``apply_fsdp_sharding`` and
    ``with_mesh``.  Returns (the program to run, the program, the loss)."""
    from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    flags, kind = ZERO_TIERS[tier]
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg())
        build = fluid.BuildStrategy()
        build.fuse_elewise_add_act_ops = True
        if mode == "zero1":
            s = DistributedStrategy()
            s.sharding = True
            for k, v in flags.items():
                setattr(s, k, v)
            s.build_strategy = build
            fleet.distributed_optimizer(zero_optimizer(fluid, kind),
                                        s).minimize(total)
        else:
            zero_optimizer(fluid, kind).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    if mode == "zero1":
        return fleet.main_program, main, total
    layout = MeshLayout(fsdp=2)
    apply_fsdp_sharding(main, layout)
    compiled = fluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name,
        batch_axis=layout.batch_axes, build_strategy=build)
    return compiled, main, total


def _global_state(compiled, main, scope):
    """Every persistable's global value (a sharded one's blocks
    gathered; every rank calls this in the same order)."""
    from paddle_tpu_torch.ops.collective_ops import whole_of
    out = {}
    for v in sorted(main.list_vars(), key=lambda v: v.name):
        if v.persistable and scope.find_var(v.name) is not None:
            t = whole_of(compiled._dp, v, scope.find_var(v.name))
            out[v.name] = io._to_numpy(t)
    return out


def zero(mode, inputs, tier, out_dir):
    rank = int(os.environ["RANK"])
    _init(rank)
    data = np.load(inputs)
    init = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    steps = len({k.split("/", 1)[0] for k in data.files
                 if k.startswith("b")})
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(steps)]
    out = {}
    for entry in ("run", "prepare"):
        registry.reset_route_counts()
        compiled, main, total = build_zero(mode, tier)
        names = sorted(v.name for v in main.list_vars() if v.persistable)
        scope = fluid.Scope()
        dtypes = {v.name: v.dtype for v in main.list_vars()}
        for n, t in io.convert_params({n: init[n] for n in names},
                                      "cpu", dtypes).items():
            scope.set_var(n, t)
        exe = fluid.Executor(fleet.place)
        if entry == "run":
            losses = [float(exe.run(compiled, feed=b, fetch_list=[total],
                                    scope=scope)[0]) for b in batches]
        else:
            step = exe.prepare(compiled, fetch_list=[total], scope=scope,
                               donate_state=True)
            losses = [float(step.run(b)[0]) for b in batches]
            fluid.sync_prepared_state(scope)
        out[f"{entry}/losses"] = np.array(losses)
        # the bytes this rank holds of each persistable
        for n in names:
            t = scope.find_var(n)
            out[f"{entry}/held/{n}"] = np.array(t.numel() *
                                                t.element_size())
        for n, a in _global_state(compiled, main, scope).items():
            out[f"{entry}/p/{n}"] = a
        out[f"{entry}/routes"] = np.array(sorted(
            f"{k[0]}:{k[2]}:{v // steps}"
            for k, v in registry.route_counts().items()))
    out["desc"] = np.array(__import__("json").dumps(program_to_desc(main)))
    if mode == "zero3":
        out.update(auto_legs(init, batches))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def clip_program(clip):
    """BERT-tiny pretraining (unfused) minimized with AdamW 0.01 (warmup
    into linear decay) and a global-norm clip of ``clip``: (main, loss)."""
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 7
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg())
    return main, startup, total


def clip_optimizer(clip):
    lr = fluid.layers.linear_lr_warmup(
        fluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2, 0.0,
        1e-3)
    return fluid.optimizer.AdamW(
        lr, weight_decay=0.01,
        grad_clip=fluid.clip.GradientClipByGlobalNorm(clip))


def _fleet_build():
    """The BuildStrategy fleet compiles a default DistributedStrategy
    with (the gradient buckets on, 32 MB)."""
    build = fluid.BuildStrategy()
    build.fuse_all_reduce_ops = True
    build.fuse_grad_size_in_MB = 32
    return build


def _train_leg(compiled, main, total, init, batches):
    """Losses and every persistable's global value after the batches."""
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    scope = fluid.Scope()
    dtypes = {v.name: v.dtype for v in main.list_vars()}
    for n, t in io.convert_params({n: init[n] for n in names if n in init},
                                  "cpu", dtypes).items():
        scope.set_var(n, t)
    exe = fluid.Executor(fleet.place)
    losses = [float(exe.run(compiled, feed=b, fetch_list=[total],
                            scope=scope)[0]) for b in batches]
    return losses, _global_state(compiled, main, scope)


def auto_legs(init, batches):
    """The clip repair and fleet's auto_shard on two ranks."""
    import hashlib
    import json
    from paddle_tpu_torch.framework.errors import InvalidArgumentError
    from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    out = {}

    def save(tag, losses, state):
        out[f"auto/{tag}/losses"] = np.array(losses)
        for n, a in state.items():
            out[f"auto/{tag}/p/{n}"] = a

    for tag, clip in (("fsdp2_clip", 0.05), ("fsdp2_noclip", 1e9)):
        main, startup, total = clip_program(clip)
        with fluid.program_guard(main, startup):
            clip_optimizer(clip).minimize(total)
        layout = MeshLayout(fsdp=2)
        apply_fsdp_sharding(main, layout)
        compiled = fluid.CompiledProgram(main).with_mesh(
            layout.build_mesh(), loss_name=total.name,
            batch_axis=layout.batch_axes, build_strategy=_fleet_build())
        save(tag, *_train_leg(compiled, main, total, init, batches))
        out[f"auto/{tag}/types"] = np.array(
            [op.type for op in main.global_block().ops])
    main, startup, total = clip_program(0.05)
    with fluid.program_guard(main, startup):
        fleet.distributed_optimizer(clip_optimizer(0.05),
                                    DistributedStrategy()).minimize(total)
    save("dp2_clip", *_train_leg(fleet.main_program, main, total, init,
                                 batches))

    def auto(tag, budget):
        main, startup, total = clip_program(0.05)
        s = DistributedStrategy()
        s.auto_shard = True
        s.auto_shard_configs["hbm_budget_gb"] = budget
        with fluid.program_guard(main, startup):
            fleet.distributed_optimizer(clip_optimizer(0.05),
                                        s).minimize(total)
        plan = fleet.plan
        out[f"auto/{tag}/plan"] = np.array(json.dumps(plan.as_dict(),
                                                      sort_keys=True))
        out[f"auto/{tag}/hashes"] = np.array(fleet._plan_hashes)
        out[f"auto/{tag}/winner"] = np.array(
            json.dumps(plan.winner.layout.sizes))
        save(tag, *_train_leg(fleet.main_program, main, total, init,
                              batches))
        return plan

    free = auto("auto_free", None)
    peaks = sorted(c.peak_bytes for c in free.configs)
    budget = (peaks[0] + peaks[-1]) / 2 / float(1 << 30)
    out["auto/budget_gb"] = np.array(budget)
    auto("auto_budget", budget)
    try:
        auto("auto_over", 1e-9)
        out["auto/over_error"] = np.array("")
    except InvalidArgumentError as e:
        out["auto/over_error"] = np.array(str(e))
    out["auto/hash"] = np.array(hashlib.sha256(
        str(out["auto/auto_budget/plan"]).encode()).hexdigest())
    return out


def zero1ckpt(inputs, ckpt, out_dir):
    rank = int(os.environ["RANK"])
    _init(rank)
    data = np.load(inputs)
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(2)]
    compiled, main, total = build_zero("zero1", "fp32")
    scope = fluid.Scope()
    exe = fluid.Executor(fleet.place)
    st = io.load_checkpoint(exe, ckpt, main_program=main, scope=scope)
    out = {"epoch": np.array(st.epoch_no)}
    for v in main.list_vars():
        if v.persistable and scope.find_var(v.name) is not None:
            # a copy: the donated steps below update the blocks in place
            out[f"loaded/{v.name}"] = io._to_numpy(
                scope.find_var(v.name)).copy()
    step = exe.prepare(compiled, fetch_list=[total], scope=scope,
                       donate_state=True)
    out["losses"] = np.array([float(step.run(b)[0]) for b in batches])
    io.save_checkpoint(exe, os.path.join(out_dir, "ckpt"),
                       io.TrainStatus(st.epoch_no + 1), main, scope=scope)
    for n, a in _global_state(compiled, main, scope).items():
        out[f"saved/{n}"] = a
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


def localsgd(inputs, k_steps, out_dir):
    rank = int(os.environ["RANK"])
    _init(rank)
    data = np.load(inputs)
    init = {k[2:]: data[k] for k in data.files if k.startswith("p/")}
    steps = len({k.split("/", 1)[0] for k in data.files
                 if k.startswith("b")})
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(steps)]
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    startup.random_seed = 3
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[8])
        y = fluid.layers.data("y", shape=[1])
        h = fluid.layers.fc(x, 8, act="tanh")
        loss = fluid.layers.mean(
            fluid.layers.square(fluid.layers.fc(h, 1) - y))
        s = DistributedStrategy()
        s.localsgd = True
        s.localsgd_configs = {"k_steps": int(k_steps)}
        fleet.distributed_optimizer(fluid.optimizer.SGD(0.2),
                                    s).minimize(loss)
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    scope = fluid.Scope()
    for n, t in io.convert_params({n: init[n] for n in names},
                                  "cpu").items():
        scope.set_var(n, t)
    exe = fluid.Executor(fleet.place)
    step = exe.prepare(fleet.main_program, fetch_list=[loss], scope=scope,
                       donate_state=True)
    out = {"ops": np.array([op.type for op in main.global_block().ops])}
    for i, b in enumerate(batches):
        step.run(b)[0].numpy()
        fluid.sync_prepared_state(scope)
        for p in main.all_parameters():
            out[f"s{i}/{p.name}"] = scope.find_var(p.name).numpy().copy()
    out["predicate_reads"] = np.array([step.stats["predicate_reads"]])
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "collectives":
        collectives(sys.argv[2], sys.argv[3])
    elif mode == "dp":
        dp(sys.argv[2], sys.argv[3], sys.argv[4])
    elif mode == "localsgd":
        localsgd(sys.argv[2], sys.argv[3], sys.argv[4])
    elif mode in ("zero1", "zero3"):
        zero(mode, sys.argv[2], sys.argv[3], sys.argv[4])
    elif mode == "zero1ckpt":
        zero1ckpt(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
