"""Data-parallel training through the port's ``fleet`` against the JAX
package's: BERT-tiny pretraining with both fusion passes and the AdamW
recipe (weight decay 0.01, linear warmup into linear decay, global-norm
clip 1.0), dropout 0, on two ranks — the port as two processes over gloo
on the CPU (``paddle_tpu_torch.distributed.launch``,
``tests/torch_dist_runner.py``), the JAX package on a 2-device mesh — from
the same startup parameters and the same global batches, 5 steps, in the
fp32, int8 and int4 tiers of the gradient all-reduce, through
``Executor.run`` and ``Executor.prepare(donate_state=True)``.

The JAX program is built without ``fuse_elewise_add_act_ops``: off the
TPU its fused op falls back to tanh-GELU, the port computes the exact erf
(the ROADMAP's reference caveat).  Tolerances: fp32 losses and every
persistable within 1e-5.  The quantized tiers: losses within 1e-4
relative (measured: int8 2.5e-7, int4 4.4e-6).  Their persistables do
not hold 1e-4: the two packages' float32 gradients differ in the last
bits, so now and then an element sits on a rounding edge and lands one
quantum apart, and Adam turns that into up to a step's worth of change
(the peak LR is 1e-3).  Measured: int8 at most 2.0e-4 on 194 of ~0.5 M
elements, int4 at most 1.2e-3 on 9,052; held to 1e-3 and 3e-3 with at
most 0.5 % and 5 % of the elements off by more than 1e-5, far inside the
tiers' own bounds against fp32 (5e-2 and 2.5e-1, also checked).  The
parameters are bit-identical across the port's ranks.  Each launch has
its own timeout, so a hung collective fails its test."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

import paddle_tpu.fluid as jfluid
from paddle_tpu.distributed.fleet import (
    DistributedStrategy as JStrategy, distributed_optimizer as jdistributed,
    fleet as jfleet, UserDefinedRoleMaker as JRoleMaker)
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.passes import apply_pass as japply
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import (CollectiveOptimizer,
                                                DistributedStrategy,
                                                UserDefinedRoleMaker)
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_dist_runner.py")
STEPS = 5
LAUNCH_TIMEOUT_S = 180
TOL = {"fp32": 1e-5, "int8": 1e-4, "int4": 1e-4}        # losses
TOL_PARAM = {"fp32": 1e-5, "int8": 1e-3, "int4": 3e-3}  # persistables
OFF_SHARE = {"fp32": 0.0, "int8": 5e-3, "int4": 5e-2}   # elements > 1e-5
TIER_BOUND = {"int8": 5e-2, "int4": 2.5e-1}   # tests/test_grad_comm.py
AMP_STEPS = 3
TOL_AMP = 1e-2            # bf16 losses vs the JAX package's (relative)


def _cfg():
    cfg = jbert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _jax_run(tier):
    """The JAX package's fleet on a 2-device mesh: the same program, its
    startup parameters, 5 steps (3 for ``amp``)."""
    rng = np.random.RandomState(0)
    batches = [jbert.make_fake_batch(rng, _cfg(), batch_size=4,
                                     seq_len=128, num_masks=5)
               for _ in range(AMP_STEPS if tier == "amp" else STEPS)]
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 7
    with jfluid.program_guard(main, startup):
        _, total, _, _ = jbert.build_pretrain_network(_cfg())
        jfleet.init(JRoleMaker(0, 1))
        s = JStrategy()
        s.mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        if tier == "amp":
            s.amp = True
        elif tier != "fp32":
            s.quant_allreduce = True
            s.quant_configs = {"dtype": tier, "block_size": 256,
                               "stochastic_rounding": False}
        lr = jfluid.layers.linear_lr_warmup(
            jfluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2,
            0.0, 1e-3)
        jdistributed(jfluid.optimizer.AdamW(
            lr, weight_decay=0.01,
            grad_clip=jfluid.clip.GradientClipByGlobalNorm(1.0)),
            s).minimize(total)
    japply(main, "fuse_add_layernorm", fetch_names=[total.name])
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
                if scope.find_var(n) is not None}
        losses = [float(np.asarray(exe.run(jfleet.main_program, feed=b,
                                           fetch_list=[total])[0]))
                  for b in batches]
        final = {n: np.asarray(scope.find_var(n)) for n in init}
    return {"batches": batches, "init": init, "losses": losses,
            "final": final, "desc": json.dumps(jdesc(main))}


def launch(tmp_path, nproc, *args):
    """Run the rank program on ``nproc`` gloo ranks; returns each rank's
    saved arrays."""
    out_dir = tmp_path / "out"
    out_dir.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, *args, str(out_dir)]
    env = dict(os.environ, OMP_NUM_THREADS="2")
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=LAUNCH_TIMEOUT_S + 60)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(nproc)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Per tier: the JAX reference and the port's two ranks, made when
    first asked."""
    cache = {}

    def get(tier):
        if tier not in cache:
            ref = _jax_run(tier)
            tmp = tmp_path_factory.mktemp(f"dp-{tier}")
            arrays = {f"p/{n}": a for n, a in ref["init"].items()}
            for i, b in enumerate(ref["batches"]):
                arrays.update({f"b{i}/{k}": v for k, v in b.items()})
            np.savez(tmp / "in.npz", **arrays)
            cache[tier] = ref, launch(tmp, 2, "dp", str(tmp / "in.npz"),
                                      tier)
        return cache[tier]
    return get


@pytest.mark.parametrize("entry", ["run", "prepare"])
@pytest.mark.parametrize("tier", ["fp32", "int8", "int4"])
def test_two_ranks_train_like_the_jax_package(runs, tier, entry):
    ref, ranks = runs(tier)
    tol = TOL[tier]
    for r, out in enumerate(ranks):
        losses = out[f"{entry}/losses"]
        if tier == "fp32":
            np.testing.assert_allclose(losses, ref["losses"], rtol=0,
                                       atol=tol, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(losses, ref["losses"], rtol=tol,
                                       err_msg=f"rank {r}")
        names = [k[len(entry) + 3:] for k in out
                 if k.startswith(f"{entry}/p/")]
        assert names and set(names) <= set(ref["final"])
        off = total = 0
        for n in names:
            got, want = out[f"{entry}/p/{n}"], ref["final"][n]
            np.testing.assert_allclose(got, want, rtol=TOL_PARAM[tier],
                                       atol=TOL_PARAM[tier],
                                       err_msg=f"rank {r} {n}")
            off += int((np.abs(got - want) > 1e-5).sum())
            total += got.size
        assert off <= OFF_SHARE[tier] * total, (off, total)
    # same bytes in, same floats out: the replicas do not diverge
    for k in ranks[0]:
        if k.startswith(f"{entry}/p/"):
            assert np.array_equal(ranks[0][k], ranks[1][k]), k
    # every bucket's receive stage went through the kernel route (its
    # plain twin on the CPU), one hit per bucket and step; nothing fell
    # back
    routes = list(ranks[0][f"{entry}/routes"])
    assert not [x for x in routes if ":fallback:" in x], routes
    quant = [x for x in routes if x.startswith("c_fused_quant")]
    if tier == "fp32":
        assert not quant
    else:
        assert quant == ["c_fused_quant_allreduce_sum:hit:1"], routes


@pytest.mark.parametrize("tier", ["int8", "int4"])
def test_quantized_tiers_stay_inside_their_bound_of_fp32(runs, tier):
    fp32, _ = runs("fp32")
    _, ranks = runs(tier)
    np.testing.assert_allclose(ranks[0]["prepare/losses"], fp32["losses"],
                               rtol=TIER_BOUND[tier])


@pytest.mark.parametrize("tier", ["fp32", "int8"])
def test_fleet_program_has_the_jax_packages_desc(runs, tier):
    """The inserted grad sync — op types, bucket members, attrs and the
    declared QScale vars — serializes to the JAX package's desc."""
    ref, ranks = runs(tier)
    assert str(ranks[0]["desc"]) == ref["desc"]
    desc = json.loads(ref["desc"])
    ops = [op for b in desc["blocks"] for op in b["ops"]]
    types = [op["type"] for op in ops]
    want = "c_fused_quant_allreduce_sum" if tier != "fp32" \
        else "c_fused_allreduce_sum"
    assert types.count(want) == 1 and "c_allreduce_sum" not in types


def test_rank0_alone_saves_under_plain_data_parallelism(runs):
    """The usual fleet save, ``if rank == 0: save(...)``: with replicated
    persistables only, the save is no collective.  Rank 0 writes every
    persistable as it holds it and a checkpoint whose manifest verifies,
    while rank 1 goes on; both ranks then take the same next step."""
    _, ranks = runs("fp32")
    saved = {k[len("rank0_save/"):]: v for k, v in ranks[0].items()
             if k.startswith("rank0_save/")}
    held = {k[len("prepare/p/"):]: v for k, v in ranks[0].items()
            if k.startswith("prepare/p/")}
    assert saved and set(saved) == set(held)
    for n, a in saved.items():
        assert np.array_equal(a, held[n]), n
    assert bool(ranks[0]["rank0_ckpt_ok"])
    assert not [k for k in ranks[1] if k.startswith("rank0_")]
    loss = [float(r["after_save/loss"]) for r in ranks]
    assert np.isfinite(loss[0]) and loss[0] == loss[1]


# ---------------------------------------------------------------------------
# fleet's refusals and rules (no process group needed)
# ---------------------------------------------------------------------------


def test_validate_refuses_bf16_with_quant():
    s = DistributedStrategy()
    s.bf16_allreduce = True
    s.quant_allreduce = True
    with pytest.raises(InvalidArgumentError) as ei:
        CollectiveOptimizer._validate(s)
    assert "bf16_allreduce" in str(ei.value) and \
        "quant_allreduce" in str(ei.value)


def test_validate_refuses_a_bad_quant_config():
    s = DistributedStrategy()
    s.quant_allreduce = True
    s.quant_configs = {"dtype": "int4", "block_size": 255}
    with pytest.raises(ValueError, match="block_size must be even"):
        CollectiveOptimizer._validate(s)


def test_two_ranks_train_in_bf16_amp(runs):
    """``strategy.amp`` (bf16) on two ranks, 3 steps through both entries:
    the ranks' parameters bit-identical, float32 master weights, the
    losses within the bf16 parity tolerance of the JAX package's fleet on
    a 2-device mesh, and the program that fleet's desc."""
    ref, ranks = runs("amp")
    for entry in ("run", "prepare"):
        for r, out in enumerate(ranks):
            losses = out[f"{entry}/losses"]
            assert len(losses) == AMP_STEPS
            np.testing.assert_allclose(losses, ref["losses"], rtol=TOL_AMP,
                                       err_msg=f"{entry} rank {r}")
        params = [k for k in ranks[0] if k.startswith(f"{entry}/p/")]
        assert params
        for k in params:
            assert np.array_equal(ranks[0][k], ranks[1][k]), k
            if k.endswith(("_w", "_b", "_scale", "_bias", "_embedding")):
                assert ranks[0][k].dtype == np.float32, k
        routes = list(ranks[0][f"{entry}/routes"])
        assert not [x for x in routes if ":fallback:" in x], routes
    ops = [op["type"] for b in json.loads(str(ranks[0]["desc"]))["blocks"]
           for op in b["ops"]]
    assert "cast" in ops and "check_finite_and_unscale" not in ops
    assert str(ranks[0]["desc"]) == ref["desc"]


def test_strategy_amp_runs_on_one_worker():
    """fp16 ``strategy.amp`` on one worker: the program minimize leaves,
    with the loss-scaling ops after the backward, trains."""
    tcore.reset_default_programs()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(
            tfluid.layers.fc(x, 8, act="relu"), 2))
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        s = DistributedStrategy()
        s.amp = True
        s.amp_configs = dict(s.amp_configs, use_pure_bf16=False)
        tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1),
                                     s).minimize(loss)
    ops = [op.type for op in main.global_block().ops]
    bw = ops.index("backward")
    assert ops[bw + 1:bw + 3] == ["check_finite_and_unscale",
                                  "update_loss_scaling"]
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfleet.place)
    exe.run(startup, scope=scope)
    feed = {"x": np.random.RandomState(0).randn(6, 4).astype(np.float32)}
    losses = [float(exe.run(tfleet.main_program, feed=feed,
                            fetch_list=[loss], scope=scope)[0])
              for _ in range(3)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("flag", [
    "tensor_parallel", "pipeline", "auto_shard", "mesh"])
def test_unported_strategy_flags_are_refused_by_name(flag):
    """A mesh of another kind raises naming the flag, and nothing is
    appended.  ``auto_shard`` is taken now: on one worker the planner's
    one layout is the single device, and minimize leaves the plain
    update.  ``tensor_parallel`` is taken now, as in the
    JAX package (the layout comes from ``dist_attr`` and the mesh): on one
    worker minimize leaves the plain update; so is ``pipeline``: on one
    worker it is one stage, the update plain and the microbatch count
    stamped (``tests/test_torch_pipeline.py`` runs it on more)."""
    tcore.reset_default_programs()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        s = DistributedStrategy()
        setattr(s, flag, object() if flag == "mesh" else True)
        opt = tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1), s)
        before = [op.type for op in main.global_block().ops]
        if flag == "tensor_parallel":
            opt.minimize(loss)
            after = [op.type for op in main.global_block().ops]
            assert after[len(before):][-1] == "sgd" and \
                tfleet.main_program is main
            return
        if flag == "auto_shard":
            opt.minimize(loss)
            after = [op.type for op in main.global_block().ops]
            assert after[len(before):][-1] == "sgd"
            assert tfleet._plan.winner.layout.num_devices == 1
            assert tfleet.main_program is main
            return
        if flag == "pipeline":
            opt.minimize(loss)
            ops = main.global_block().ops
            assert [op.type for op in ops][len(before):][-1] == "sgd"
            bw = next(op for op in ops if op.type == "backward")
            assert bw.attrs["pipe_microbatches"] == 1
            assert not bw.attrs.get("pipe_stages")
            assert tfleet.main_program._program is main
            return
        with pytest.raises(UnimplementedError, match=flag):
            opt.minimize(loss)
    assert [op.type for op in main.global_block().ops] == before, \
        "nothing was appended"


def test_one_worker_runs_the_program_as_minimize_left_it():
    tcore.reset_default_programs()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        s = DistributedStrategy()
        s.quant_allreduce = True
        tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1),
                                     s).minimize(loss)
    assert tfleet.main_program is main
    assert tfleet.place == tfluid.CPUPlace()
    assert tfleet.backend == "gloo"
    types = [op.type for op in main.global_block().ops]
    assert not [t for t in types if t.startswith("c_")]


def test_backend_follows_the_place_and_never_switches():
    assert tcore.backend_for(tfluid.CUDAPlace(0)) == "nccl"
    assert tcore.backend_for(tfluid.CUDAPlace(0), "gloo") == "gloo"
    assert tcore.backend_for(tfluid.CPUPlace()) == "gloo"
    with pytest.raises(InvalidArgumentError, match="gloo"):
        tcore.backend_for(tfluid.CPUPlace(), "nccl")


# ---------------------------------------------------------------------------
# the grad-sync rewrite in one process, against the JAX package's
# ---------------------------------------------------------------------------


def _small_programs():
    """The same small trained program in both packages: two fc layers,
    the first weight (0.84 MB) above a 0.5 MB bucket cap."""
    progs = []
    for fl, core_mod in ((jfluid, None), (tfluid, tcore)):
        if core_mod is not None:
            core_mod.reset_default_programs()
        jun.reset()
        from paddle_tpu_torch.framework import unique_name as tun
        tun.reset()
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            x = fl.layers.data("x", shape=[300])
            h = fl.layers.fc(x, 700, act="relu")
            loss = fl.layers.mean(fl.layers.fc(h, 3))
            fl.optimizer.SGD(0.1).minimize(loss)
        progs.append(main)
    return progs


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("tier", ["fp32", "bf16", "int8", "int4",
                                  "quant-bf16"])
def test_insert_grad_sync_matches_the_jax_package(fused, tier):
    """Per-leaf and bucketed shapes (a 0.5 MB cap splits the fc stack
    into buckets), the mean-scale fold, the bf16 cast tier and the
    quantized tiers with their QScale vars: the same desc."""
    from paddle_tpu.framework import compiler as jcompiler
    from paddle_tpu_torch.framework import compiler as tcompiler
    from paddle_tpu_torch.framework.serialization import (
        program_to_desc as tdesc)
    jmain, tmain = _small_programs()
    for mod, main, to_desc in ((jcompiler, jmain, jdesc),
                               (tcompiler, tmain, tdesc)):
        bs = mod.BuildStrategy()
        bs.fuse_all_reduce_ops = fused
        bs.fuse_grad_size_in_MB = 0.5
        if tier == "bf16":
            bs.allreduce_compress_dtype = "bfloat16"
        elif tier == "quant-bf16":
            bs.allreduce_quant_spec = {"dtype": "bfloat16"}
        elif tier != "fp32":
            bs.allreduce_quant_spec = {"dtype": tier, "block_size": 128}
        mod.insert_grad_sync(main, bs, 2, ("dp",), axis_sizes={"dp": 2})
        mod.insert_grad_sync(main, bs, 2, ("dp",), axis_sizes={"dp": 2})
    assert json.dumps(tdesc(tmain)) == json.dumps(jdesc(jmain))
    types = [op.type for op in tmain.global_block().ops]
    synced = [t for t in types if t.startswith("c_")]
    assert synced, types
    if fused:
        assert len(synced) == 2      # the 0.84 MB fc weight, the rest


@pytest.mark.parametrize("axes", [("dp", "cp"), ("pp", "sp"),
                                  ("dp", "ep")])
def test_mesh_axes_the_port_has_not_are_refused_by_name(axes):
    """A ``ProcessMesh`` strategy.mesh with an expert or unknown axis, or
    the pipe axis beside a sequence axis, raises naming the axis; nothing
    is appended.  (The tensor and sequence axes are ported:
    ``tests/test_torch_tp_sp_bert.py``; the pipe axis beside the data
    axis: ``tests/test_torch_pipeline.py``.)"""
    from paddle_tpu_torch.framework.mesh_layout import ProcessMesh
    tcore.reset_default_programs()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        s = DistributedStrategy()
        s.mesh = ProcessMesh(axes, (2,) * len(axes))
        opt = tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1), s)
        before = [op.type for op in main.global_block().ops]
        with pytest.raises(UnimplementedError, match=axes[-1]):
            opt.minimize(loss)
    assert [op.type for op in main.global_block().ops] == before


def test_a_mesh_of_another_size_than_the_job_raises():
    from paddle_tpu_torch.framework.mesh_layout import ProcessMesh
    tcore.reset_default_programs()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        s = DistributedStrategy()
        s.mesh = ProcessMesh(("dp",), (2,))
        with pytest.raises(ValueError, match="needs 2 ranks"):
            tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1),
                                         s).minimize(loss)


@pytest.mark.parametrize("knob", ["nccl_comm_num", "hierarchical"])
def test_the_nccl_knobs_leave_the_program_unchanged(knob):
    """``nccl_comm_num=2`` and ``use_hierarchical_allreduce`` are taken
    and change nothing: the program fleet builds is op for op and attr
    for attr the one built without them (the grad sync itself on two
    ranks: ``tests/test_torch_overlap.py``)."""
    descs = []
    for on in (False, True):
        tcore.reset_default_programs()
        from paddle_tpu_torch.framework import unique_name as tun
        from paddle_tpu_torch.framework.serialization import (
            program_to_desc as tdesc)
        tun.reset()
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[4])
            loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
            tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
            s = DistributedStrategy()
            if on and knob == "nccl_comm_num":
                s.nccl_comm_num = 2
            elif on:
                s.use_hierarchical_allreduce = True
            tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1),
                                         s).minimize(loss)
        descs.append(json.dumps(tdesc(main)))
    assert descs[0] == descs[1]
