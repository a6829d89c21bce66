"""Pipeline parallelism through the port against the JAX package.

Pure functions: ``simulate_schedule`` equals the JAX package's tables on
a grid of families, stage counts, microbatch counts and chunks;
``plan_stage_cuts`` equals its plan on ``tests/test_pipeline.py``'s MLP
and on BERT-tiny at 8 x 64 (2 and 4 stages); ``apply_pipeline``'s desc
equals its desc (1F1B, interleaved, ``shard_weights=True``).

Numerical legs, on gloo ranks of ``tests/torch_pipe_runner.py`` (one
launch of two ranks and one of four run every leg), each held to the
JAX package's ONE-DEVICE ``set_microbatches`` run of the same program
from the same initial weights and batches, over 5 Adam steps: losses
and parameters within ``TOL`` = 1e-6 for the MLP (1F1B at pp 2 and pp
4, interleaved pp 2 x chunks 2, zero-bubble pp 4, dp 2 x pp 2, dp 2 x pp
2 with ZeRO-1, pipe-sharded weights) and ``TOL_BERT`` = 1e-5 for
BERT-tiny at dropout 0 through ``fleet``'s ``strategy.pipeline`` (pp 2, 4
microbatches).  Adam turns the exactly-zero gradient of
``*_attn_k.b_*`` into ±LR noise, so those are left out of BERT's
parameter check (as in ``tests/test_torch_tp_sp_bert.py``).

Also: the port's ``set_microbatches(p, 2)`` equals its own
``GradientMergeOptimizer`` stream bit for bit; every pipelined run's
census (idle slots equal to the simulator's, no launch on an idle tick,
in-flight state within the ring slots); the dropout replay at dropout
0.1 (every recomputed boundary bit for bit the sent one); a fetch of a
per-microbatch intermediate, dynamic loss scaling, pp beside tp / sp /
fsdp and a restore across pp layouts refused by name; the (dp, pp)
sharded save and restore; ``PipelineOptimizer`` with ``device_guard``
and ``gpipe_spmd`` against the JAX package's tests of them."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu.fluid as jfluid
from paddle_tpu import parallel as jparallel
from paddle_tpu.framework import pipe as jpipe
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.errors import (
    InvalidArgumentError as JInvalidArgumentError)
from paddle_tpu.framework.jax_compat import shard_map
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert

import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework import pipe as tpipe
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.framework.serialization import (
    program_to_desc as tdesc)
from paddle_tpu_torch.models import bert as tbert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_pipe_runner.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_pipe_runner import (BERT_LR, MLP_LEGS, MLP_LR,  # noqa: E402
                               STEPS)

TOL = 1e-6          # MLP losses and parameters
TOL_BERT = 1e-5     # BERT-tiny losses and parameters (dropout 0)
ZERO_GRAD = "_attn_k.b_"
LAUNCH_TIMEOUT_S = 300
LEGS2 = ("pp2", "pp2_interleaved", "pp2_shard", "pipeopt", "bert",
         "bert_drop")
LEGS4 = ("pp4", "pp4_zero_bubble", "dp2pp2", "dp2pp2_zero1", "ckpt",
         "gpipe")
BERT_M = 4


# ---------------------------------------------------------------------------
# the JAX references and the runner's inputs
# ---------------------------------------------------------------------------


def _jax_mlp():
    L = jfluid.layers
    x = L.data("x", shape=[-1, 16], append_batch_size=False)
    y = L.data("label", shape=[-1, 1], dtype="float32",
               append_batch_size=False)
    h = L.fc(x, 32, act="relu", param_attr=jfluid.ParamAttr(name="w1"))
    h = L.fc(h, 32, act="relu", param_attr=jfluid.ParamAttr(name="w2"))
    p = L.fc(h, 1, param_attr=jfluid.ParamAttr(name="w3"))
    return L.mean(L.square(p - y)), h


def _bert_cfg(model, dropout=0.0):
    cfg = model.BertConfig.tiny()
    cfg.hidden_dropout_prob = dropout
    cfg.attention_probs_dropout_prob = dropout
    return cfg


def _jax_run(build, feeds, M, init=None, seed=None):
    """The JAX package's one-device ``set_microbatches(p, M)`` run:
    (losses, initial parameters, final parameters)."""
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    if seed is not None:
        startup.random_seed = seed
    with jfluid.program_guard(main, startup):
        loss, lr = build()
        jfluid.optimizer.Adam(lr).minimize(loss)
    jpipe.set_microbatches(main, M)
    exe = jfluid.Executor(jfluid.CPUPlace())
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
        names = [p.name for p in main.all_parameters()]
        if init is not None:
            for n in names:
                scope.set_var(n, np.array(init[n]))
        start = {n: np.asarray(scope.find_var(n)).copy() for n in names}
        losses = [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0])
                        .reshape(-1)[0]) for f in feeds]
        final = {n: np.asarray(scope.find_var(n)).copy() for n in names}
    return np.array(losses), start, final


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.RandomState(0)
    xs = rng.randn(STEPS, 8, 16).astype(np.float32)
    ys = rng.randn(STEPS, 8, 1).astype(np.float32)
    mlp_feeds = [{"x": xs[i], "label": ys[i]} for i in range(STEPS)]
    arrays, out = {}, {}
    for i in range(STEPS):
        arrays[f"mlp/x{i}"], arrays[f"mlp/y{i}"] = xs[i], ys[i]

    def mlp():
        return _jax_mlp()[0], MLP_LR

    init = None
    for M in (2, 4):
        losses, start, final = _jax_run(mlp, mlp_feeds, M, init)
        init = start
        out[f"mlp{M}"] = (losses, final)
    arrays.update({f"mlp/init/{n}": v for n, v in init.items()})

    cfg = _bert_cfg(jbert)
    batches = [jbert.make_fake_parallel_batch(rng, cfg, batch_size=8,
                                              seq_len=64)
               for _ in range(STEPS)]
    for i, b in enumerate(batches):
        arrays.update({f"bert/b{i}/{k}": v for k, v in b.items()})

    def bert():
        return jbert.build_pretrain_network_parallel(cfg)[1], BERT_LR

    losses, start, final = _jax_run(bert, batches, BERT_M, seed=3)
    out["bert"] = (losses, final)
    arrays.update({f"bert/init/{n}": v for n, v in start.items()})

    # PipelineOptimizer's program and gpipe_spmd's stages
    out["pipeopt_batches"] = [rng.rand(8, 6).astype(np.float32)
                              for _ in range(3)]
    for i, b in enumerate(out["pipeopt_batches"]):
        arrays[f"pipeopt/b{i}"] = b
    arrays["gpipe/ws"] = (rng.randn(4, 8, 8) * 0.3).astype(np.float32)
    arrays["gpipe/xs"] = rng.randn(4, 2, 8).astype(np.float32)
    out["arrays"] = arrays
    tmp = tmp_path_factory.mktemp("pipe")
    np.savez(tmp / "in.npz", **arrays)
    out["in"], out["tmp"] = tmp / "in.npz", tmp
    return out


def _launch(ref, nproc, legs):
    out_dir = ref["tmp"] / f"out{nproc}"
    out_dir.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, ",".join(legs),
           str(ref["in"]), str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S + 60,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(nproc)], \
        out_dir


_RUNS = {}


@pytest.fixture(scope="module")
def ranks(ref):
    def get(leg):
        n = 2 if leg in LEGS2 else 4
        if n not in _RUNS:
            _RUNS[n] = _launch(ref, n, LEGS2 if n == 2 else LEGS4)
        return _RUNS[n]
    return get


# ---------------------------------------------------------------------------
# pure functions
# ---------------------------------------------------------------------------


GRID = [(f, s, m, c) for f in jpipe.SCHEDULE_FAMILIES for s in (2, 3, 4)
        for m in (1, 2, 4, 6) for c in (1, 2)]


@pytest.mark.parametrize("family,S,M,chunks", GRID,
                         ids=[f"{f}-S{s}-M{m}-c{c}" for f, s, m, c in GRID])
def test_simulate_schedule_is_the_jax_packages(family, S, M, chunks):
    def run(mod):
        try:
            return mod.simulate_schedule(family, S, M, chunks=chunks)
        except AssertionError as e:
            return ("AssertionError", str(e))
    assert run(tpipe) == run(jpipe)


@pytest.mark.parametrize("S,M", [(2, 4), (3, 6), (4, 4)])
def test_enumerate_schedules_and_schedule_1f1b_are_the_jax_packages(S, M):
    assert tpipe.enumerate_schedules(S, M) == jpipe.enumerate_schedules(S, M)
    assert tpipe.schedule_1f1b(S, M) == jpipe.schedule_1f1b(S, M)


def _build_mlp(fl, un):
    un.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        if fl is jfluid:
            loss = _jax_mlp()[0]
        else:
            from torch_pipe_runner import mlp_model
            loss = mlp_model()
        fl.optimizer.Adam(MLP_LR).minimize(loss)
    return main


def _build_bert(fl, un, model):
    un.reset()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        _, loss = model.build_pretrain_network_parallel(_bert_cfg(model))
        fl.optimizer.Adam(BERT_LR).minimize(loss)
    return main


MLP_SHAPES = {"x": ((8, 16), "float32"), "label": ((8, 1), "float32")}


def _bert_shapes():
    b = jbert.make_fake_parallel_batch(np.random.RandomState(0),
                                       _bert_cfg(jbert), batch_size=8,
                                       seq_len=64)
    return {k: (tuple(v.shape), str(v.dtype)) for k, v in b.items()}


@pytest.mark.parametrize("model,stages", [("mlp", 2), ("mlp", 3),
                                          ("bert", 2), ("bert", 4)])
def test_plan_stage_cuts_is_the_jax_packages(model, stages):
    if model == "mlp":
        progs = _build_mlp(jfluid, jun), _build_mlp(tfluid, tun)
        shapes = MLP_SHAPES
    else:
        progs = (_build_bert(jfluid, jun, jbert),
                 _build_bert(tfluid, tun, tbert))
        shapes = _bert_shapes()
    j = jpipe.plan_stage_cuts(progs[0], stages, feed_shapes=shapes)
    t = tpipe.plan_stage_cuts(progs[1], stages, feed_shapes=shapes)
    assert t.as_dict() == j.as_dict()
    assert t.num_ops == j.num_ops
    assert len(t.cuts) == stages - 1 and all(t.boundary_bytes)


@pytest.mark.parametrize("kw", [
    dict(num_stages=2, num_microbatches=4),
    dict(num_stages=2, num_microbatches=4, schedule="interleaved",
         chunks=2),
    dict(num_stages=2, num_microbatches=4, shard_weights=True,
         min_shard_numel=1),
    dict(num_stages=4, num_microbatches=4, schedule="zero_bubble")],
    ids=["1f1b", "interleaved", "shard_weights", "zero_bubble"])
@pytest.mark.parametrize("model", ["mlp", "bert"])
def test_apply_pipeline_desc_is_the_jax_packages(model, kw):
    descs, reports = [], []
    for fl, un, mod, pipe, to_desc in (
            (jfluid, jun, jbert, jpipe, jdesc),
            (tfluid, tun, tbert, tpipe, tdesc)):
        main = _build_mlp(fl, un) if model == "mlp" else \
            _build_bert(fl, un, mod)
        shapes = MLP_SHAPES if model == "mlp" else _bert_shapes()
        rep = pipe.apply_pipeline(main, feed_shapes=shapes, **kw)
        descs.append(json.dumps(to_desc(main), sort_keys=True))
        reports.append(rep)
    assert descs[0] == descs[1]
    assert reports[1]["schedule"] == reports[0]["schedule"]
    assert reports[1]["grad_sync_ops"] == reports[0]["grad_sync_ops"]


def test_apply_pipeline_is_idempotent_and_refuses_what_the_jax_package_does():
    main = _build_mlp(tfluid, tun)
    rep = tpipe.apply_pipeline(main, 2, 2)
    assert rep["num_stages"] == 2 and rep["grad_sync_ops"] == 1
    assert tpipe.apply_pipeline(main, 4, 8)["already_pipelined"]
    with pytest.raises(InvalidArgumentError, match="unknown schedule"):
        tpipe.apply_pipeline(_build_mlp(tfluid, tun), 2, 2, schedule="x")
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        from torch_pipe_runner import mlp_model
        mlp_model()
    with pytest.raises(InvalidArgumentError, match="backward"):
        tpipe.plan_stage_cuts(main, 2)
    # no backward op: no recompute plan (the JAX package's None)
    assert tpipe.plan_remat(main) is None


# ---------------------------------------------------------------------------
# one process
# ---------------------------------------------------------------------------


def _port_run(mutate, feeds, gm_k=0):
    from torch_pipe_runner import mlp_model
    from paddle_tpu_torch.optimizer import GradientMergeOptimizer
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        loss = mlp_model()
        opt = tfluid.optimizer.Adam(MLP_LR)
        if gm_k:
            opt = GradientMergeOptimizer(opt, k_steps=gm_k, avg=True)
        opt.minimize(loss)
    mutate(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    losses = [np.asarray(exe.run(main, feed=f, fetch_list=[loss],
                                 scope=scope)[0]).reshape(())
              for f in feeds]
    return losses, scope.find_var("w1").numpy().copy(), (main, exe, scope)


def test_microbatches_are_gradient_merge_bit_for_bit(ref):
    """pipe = 1, M = 2: the microbatch accumulation equals the port's own
    GradientMergeOptimizer over the same microbatch stream, bit for bit
    (two-term sums commute; the 1/2 scale is exact)."""
    a = ref["arrays"]
    feeds = [{"x": a[f"mlp/x{i}"], "label": a[f"mlp/y{i}"]}
             for i in range(STEPS)]
    lm, wm, _ = _port_run(lambda p: tpipe.set_microbatches(p, 2), feeds)
    halves = [{k: v[m * 4:(m + 1) * 4] for k, v in f.items()}
              for f in feeds for m in range(2)]
    lg, wg, _ = _port_run(lambda p: None, halves, gm_k=2)
    merged = [(lg[2 * i] + lg[2 * i + 1]) / np.float32(2)
              for i in range(STEPS)]
    assert np.array_equal(np.asarray(lm), np.asarray(merged))
    assert np.array_equal(wm, wg)


def test_the_pipe1_run_of_a_pipelined_program_is_the_microbatched_one(ref):
    a = ref["arrays"]
    feeds = [{"x": a[f"mlp/x{i}"], "label": a[f"mlp/y{i}"]}
             for i in range(STEPS)]
    lm, wm, _ = _port_run(lambda p: tpipe.set_microbatches(p, 2), feeds)
    lp, wp, _ = _port_run(lambda p: tpipe.apply_pipeline(p, 2, 2), feeds)
    assert np.array_equal(np.asarray(lm), np.asarray(lp))
    assert np.array_equal(wm, wp)


def test_a_fetch_of_a_per_microbatch_intermediate_raises(ref):
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        L = tfluid.layers
        x = L.data("x", shape=[-1, 16], append_batch_size=False)
        y = L.data("label", shape=[-1, 1], dtype="float32",
                   append_batch_size=False)
        h = L.fc(x, 32, act="relu", param_attr=tfluid.ParamAttr(name="w1"))
        p = L.fc(h, 1, param_attr=tfluid.ParamAttr(name="w3"))
        loss = L.mean(L.square(p - y))
        tfluid.optimizer.Adam(MLP_LR).minimize(loss)
    tpipe.set_microbatches(main, 2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    a = ref["arrays"]
    with pytest.raises(InvalidArgumentError, match="per-microbatch"):
        exe.run(main, feed={"x": a["mlp/x0"], "label": a["mlp/y0"]},
                fetch_list=[h.name], scope=scope)


def test_dynamic_loss_scaling_is_refused_as_the_jax_package_refuses_it():
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    from torch_pipe_runner import mlp_model
    for fl, un, pipe, dec in ((jfluid, jun, jpipe, None),
                              (tfluid, tun, tpipe, decorate)):
        if dec is None:
            from paddle_tpu.contrib.mixed_precision import decorate as dec
        un.reset()
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            loss = _jax_mlp()[0] if fl is jfluid else mlp_model()
            dec(fl.optimizer.Adam(MLP_LR), use_pure_bf16=False,
                use_dynamic_loss_scaling=True).minimize(loss)
        with pytest.raises(JInvalidArgumentError if fl is jfluid else
                           InvalidArgumentError,
                           match="dynamic loss scaling"):
            pipe.apply_pipeline(main, 2, 2, feed_shapes=MLP_SHAPES)
    # the microbatched lowering refuses it too (the JAX package's would
    # leave the gradients scaled)
    tpipe.set_microbatches(main, 2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(UnimplementedError, match="dynamic loss scaling"):
        exe.run(main, feed={"x": np.ones((4, 16), np.float32),
                            "label": np.ones((4, 1), np.float32)},
                fetch_list=[loss], scope=scope)


@pytest.mark.parametrize("sizes,beside", [
    ({"pipe": 2, "tp": 2}, "tp"), ({"pipe": 2, "fsdp": 2}, "fsdp"),
    ({"pipe": 2, "extra_axes": {"sp": 2}}, "sp"),
    ({"data": 2, "pipe": 2, "tp": 2}, "tp")],
    ids=["tp", "fsdp", "sp", "dp_tp"])
def test_pp_beside_tp_sp_fsdp_is_refused_by_name(sizes, beside):
    from paddle_tpu_torch.framework.mesh_layout import (MeshLayout,
                                                        ProcessMesh)
    with pytest.raises(UnimplementedError, match=f"pipe axis beside.*"
                       f"{beside}"):
        MeshLayout(**sizes).check_ported()
    mesh = ProcessMesh(("pp", beside), (2, 2))
    with pytest.raises(UnimplementedError, match="pipe axis beside"):
        tfluid.CompiledProgram(_build_mlp(tfluid, tun)).with_mesh(mesh,
                                                                  "loss")


def test_dp_x_pp_layouts_pass_the_check():
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    for sizes in ({"pipe": 2}, {"data": 2, "pipe": 2}):
        MeshLayout(**sizes).check_ported()
        with pytest.raises(ValueError, match="ranks"):
            MeshLayout(**sizes).build_mesh()


# ---------------------------------------------------------------------------
# the pipelined runs on gloo ranks
# ---------------------------------------------------------------------------


def _gap(a, b):
    return float(np.abs(np.asarray(a, np.float64) -
                        np.asarray(b, np.float64)).max())


@pytest.mark.parametrize("leg", sorted(MLP_LEGS))
def test_the_pipelined_mlp_trains_like_the_one_device_jax_run(ref, ranks,
                                                              leg):
    outs, _ = ranks(leg)
    M = MLP_LEGS[leg][1]["num_microbatches"]
    losses, final = ref[f"mlp{M}"]
    for r, o in enumerate(outs):
        assert _gap(o[f"{leg}/losses"], losses) <= TOL, (r, leg)
        for n, v in final.items():
            assert _gap(o[f"{leg}/p/{n}"], v) <= TOL, (r, leg, n)


@pytest.mark.parametrize("leg", sorted(MLP_LEGS) + ["bert"])
def test_the_census_is_the_simulators(ranks, leg):
    """Idle slots summed over the pipe ranks equal the simulator's, no
    kernel launched on an idle tick, the units each rank ran are its
    column of the tables, and the in-flight saved inputs and cotangents
    stay within the ring slots (a rank holds ``chunks`` rings)."""
    outs, _ = ranks(leg)
    for r, o in enumerate(outs):
        rep = json.loads(str(o[f"{leg}/report"]))
        sch = tpipe.simulate_schedule(rep["family"], rep["num_ranks"],
                                      rep["num_microbatches"],
                                      chunks=rep["chunks"])
        col = rep["rank"]
        assert rep["census_idle_slots"] == rep["sim_idle_slots"] == \
            sch["idle_slots"]
        assert rep["idle_launches"] == 0
        assert rep["rank_idle_ticks"] == sum(
            row[col] == tpipe.KIND_IDLE for row in sch["kind"])
        for kind, name in ((tpipe.KIND_F, "F"), (tpipe.KIND_B, "B"),
                           (tpipe.KIND_W, "W")):
            assert rep["units"][name] == sum(row[col] == kind
                                             for row in sch["kind"])
        assert rep["ring_peak"][0] <= rep["ring_slots"][0] * rep["chunks"]
        assert rep["ring_peak"][1] <= rep["ring_slots"][1] * rep["chunks"]


def test_pipe_sharded_weights_hold_a_block_and_report_it(ranks):
    outs, _ = ranks("pp2_shard")
    for o in outs:
        rep = json.loads(str(o["pp2_shard/report"]))
        assert rep["sharded_params"] == {"w1": 0, "fc_0.b_0": 0, "w2": 0,
                                         "fc_1.b_0": 0, "w3": 0}


def test_bert_tiny_through_fleet_pipeline_trains_like_the_one_device_run(
        ref, ranks):
    outs, _ = ranks("bert")
    losses, final = ref["bert"]
    for r, o in enumerate(outs):
        assert _gap(o["bert/losses"], losses) <= TOL_BERT, r
        for n, v in final.items():
            if ZERO_GRAD in n:
                continue
            assert _gap(o[f"bert/p/{n}"], v) <= TOL_BERT, (r, n)


def test_the_recompute_replays_the_forward_units_dropout(ranks):
    """BERT-tiny at dropout 0.1, pp 2, 4 microbatches, two steps: every B
    unit's recomputed boundary equals the boundary its F unit sent, bit
    for bit (rank 0 holds the only cut: 8 checks)."""
    outs, _ = ranks("bert_drop")
    assert [o["bert_drop/replay"].tolist() for o in outs] == [[8, 0],
                                                              [0, 0]]
    for o in outs:
        assert np.isfinite(o["bert_drop/losses"]).all()
    assert outs[0]["bert_drop/losses"].tolist() == \
        outs[1]["bert_drop/losses"].tolist()


def test_the_dp_pp_sharded_save_restores_bit_for_bit(ranks):
    """dp 2 x pp 2 with pipe-sharded weights: a sharded save after step 3
    writes every block once (replicated values once, each pipe block
    once), restores into a fresh scope bit for bit on every rank, steps
    4-5 from it equal the uninterrupted run's, and a restore onto another
    pp layout is refused by name."""
    outs, out_dir = ranks("ckpt")
    for o in outs:
        assert json.loads(str(o["ckpt/differ"])) == []
        assert int(o["ckpt/epoch"]) == 3
        assert o["ckpt/losses_a"].tolist() == o["ckpt/losses_b"].tolist()
        assert "pipe layout" in str(o["ckpt/refused"]) and \
            "not ported" in str(o["ckpt/refused"])
    ckpt = out_dir / "ckpt" / "checkpoint_3"
    covered, total, seen = {}, {}, set()
    for r in range(4):
        with open(ckpt / f"shard_manifest_{r}.json") as f:
            for name, rec in json.load(f)["vars"].items():
                total[name] = int(np.prod(rec["shape"]))
                for e in rec["shards"]:
                    key = (name, json.dumps(e["index"]))
                    assert key not in seen, key
                    seen.add(key)
                    covered[name] = covered.get(name, 0) + (
                        total[name] if e["index"] is None else
                        int(np.prod([b - a for a, b in e["index"]])))
    assert covered == total
    # the pipe-sharded parameters and their moments are saved by block
    blocked = {n for n, index in seen if json.loads(index) is not None}
    assert {f"{w}{m}" for w in ("w1", "w2")
            for m in ("", "_moment1_0", "_moment2_0")} <= blocked


def test_pipeline_optimizer_with_device_guard_is_the_jax_packages_run(
        ref, ranks):
    """``tests/test_parallel.py::test_pipeline_optimizer_program_level``:
    two ``device_guard`` stages, 4 microbatches over pp 2, SGD 0.1 — the
    losses of the JAX package's one-device run of the same program."""
    outs, _ = ranks("pipeopt")
    L = jfluid.layers
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = L.data("x", shape=[6])
        h = L.fc(x, 8, act="relu", bias_attr=False,
                 param_attr=jfluid.ParamAttr(
                     name="pw1", initializer=jfluid.initializer.Constant(
                         0.05)))
        y = L.fc(h, 8, bias_attr=False, param_attr=jfluid.ParamAttr(
            name="pw2", initializer=jfluid.initializer.Constant(0.05)))
        loss = L.mean(L.square(y))
        jfluid.optimizer.SGD(0.1).minimize(loss)
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jfluid.Scope()):
        exe.run(startup)
        want = [float(np.asarray(exe.run(main, feed={"x": b},
                                         fetch_list=[loss])[0]).reshape(()))
                for b in ref["pipeopt_batches"]]
    for o in outs:
        np.testing.assert_allclose(o["pipeopt/losses"], want, rtol=1e-5,
                                   atol=0)


def test_pipeline_optimizer_stamps_device_guard_stages():
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[6])
        with tfluid.device_guard("gpu:1"):
            tfluid.layers.fc(x, 8)
    assert {op.attrs.get("op_device") for op in main.global_block().ops} \
        == {"gpu:1"}


def test_gpipe_spmd_is_the_jax_packages_and_the_sequential_one(ref, ranks):
    """``tests/test_parallel.py::test_gpipe_spmd_matches_sequential``'s
    four tanh stages on four ranks: the outputs the JAX package's
    ``gpipe_spmd`` gives under ``shard_map`` on a pp 4 mesh, and the
    gradient of their sum w.r.t. each rank's stage weight that autograd
    gives the sequential stages."""
    outs, _ = ranks("gpipe")
    ws, xs = ref["arrays"]["gpipe/ws"], ref["arrays"]["gpipe/xs"]
    mesh = Mesh(np.array(jax.devices()[:4]), ("pp",))
    want = np.asarray(jax.jit(shard_map(
        lambda w, v: jparallel.gpipe_spmd(
            lambda p, a: jax.numpy.tanh(a @ p[0]), w, v, "pp"),
        mesh=mesh, in_specs=(P("pp"), P()), out_specs=P(),
        check_vma=False))(ws, xs))
    wt = [torch.tensor(w, requires_grad=True) for w in ws]
    seq = torch.tensor(xs)
    for w in wt:
        seq = torch.tanh(seq @ w)
    seq.sum().backward()
    for r, o in enumerate(outs):
        np.testing.assert_allclose(o["gpipe/out"], want, rtol=1e-5,
                                   atol=1e-6)
        np.testing.assert_allclose(o["gpipe/grad"], wt[r].grad.numpy(),
                                   rtol=1e-5, atol=1e-6)
