"""Rank program for the port's multi-rank tests, started by
``python -m paddle_tpu_torch.distributed.launch`` on the CPU over gloo.

    launch --nproc N --backend gloo --timeout T tests/torch_dist_runner.py \\
        collectives IN.npz OUT_DIR
    launch --nproc 2 --backend gloo --timeout T tests/torch_dist_runner.py \\
        dp IN.npz TIER OUT_DIR

``collectives``: every ported collective op on this rank's inputs
(``IN.npz`` holds ``r<rank>/<case>`` arrays), outputs saved per case.
``dp``: BERT-tiny pretraining through ``fleet`` with the fused AdamW
recipe, from the startup parameters and batches in ``IN.npz``, for the
fp32 / int8 / int4 tier, through ``Executor.run`` and then
``Executor.prepare(donate_state=True)``.  Each rank writes
``OUT_DIR/rank<r>.npz``.  Imports the port only."""

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
    ("identity", "c_identity", {}, ("X",)),
    ("sync_calc", "c_sync_calc_stream", {}, ("X",)),
    ("sync_comm", "c_sync_comm_stream", {}, ("X",)),
]
NOOP_OPS = ("c_comm_init", "c_comm_init_all", "c_gen_nccl_id", "barrier")

#: the dp mode's model, recipe and steps
DP_STEPS = 5


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
        if tier != "fp32":
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
    batches = [{k.split("/", 1)[1]: data[k] for k in data.files
                if k.startswith(f"b{i}/")} for i in range(DP_STEPS)]
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
            out[f"{entry}/p/{n}"] = np.asarray(scope.find_var(n))
        out[f"{entry}/routes"] = np.array(sorted(
            f"{k[0]}:{k[2]}:{v // DP_STEPS}"
            for k, v in registry.route_counts().items()))
    out["desc"] = np.array(__import__("json").dumps(program_to_desc(main)))
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)


if __name__ == "__main__":
    mode = sys.argv[1]
    if mode == "collectives":
        collectives(sys.argv[2], sys.argv[3])
    elif mode == "dp":
        dp(sys.argv[2], sys.argv[3], sys.argv[4])
    else:
        raise SystemExit(f"unknown mode {mode!r}")
