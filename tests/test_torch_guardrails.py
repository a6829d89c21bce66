"""The guarded training step and the drills of the port
(``framework/guardrails.py``, ``testing/faultline.py``,
``observability/watchdog.py``), held against the JAX package:

* the seam registry and the ``at`` / ``times`` / ``match`` windows;
* the CHAOS_r18 drill: BERT-tiny, 8 Adam steps, a NaN gradient at guard
  step 2 — the same skip trace, the same loss-scale trace under
  ``guard_loss_scale`` (exactly), losses within 1e-5, and parameters and
  moments after the skipped step bit for bit the ones before it;
* composition with AMP's dynamic scaling and the microbatched (gradient
  merge) lowering in one process, and with ZeRO-1 and 1F1B on two gloo
  ranks (one launch of ``tests/torch_guard_runner.py``), the NaN on rank 1
  only and both ranks skipping;
* the skip-budget abort, the Adam kernel's skip flag on its plain twin,
  the watchdog, the serving worker's fatal path, the checkpoint writer's
  corruption retry, the ``collective_impl`` seam and ``reshard_execute``
  during a restore.

No wall-clock assertion: the watchdog drills only count trips."""

import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import guardrails as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.errors import InvalidArgumentError as JInvalid
from paddle_tpu.models import bert as jbert
from paddle_tpu.testing import faultline as jfl

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import guardrails as tguard
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.errors import (EnforceNotMet,
                                               GuardrailViolation,
                                               InvalidArgumentError,
                                               UnavailableError)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.observability import flight, metrics, watchdog
from paddle_tpu_torch.ops.cuda import optimizer as tadam
from paddle_tpu_torch.testing import faultline as tfl

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_guard_runner.py")

_FLAGS = ["guard_nonfinite", "guard_loss_scale", "guard_loss_scale_init",
          "guard_incr_every_n_steps", "max_skipped_steps",
          "step_deadline_s", "watchdog_abort", "flight_dump_dir",
          "checkpoint_retries", "checkpoint_retry_backoff_s"]

CHAOS_STEPS = 8
CHAOS_POISON = 2
TOL = 1e-5


@pytest.fixture(autouse=True)
def hygiene(tmp_path):
    """Flags restored, seams disarmed, bundles into tmp — per test, in
    both packages."""
    keep = (jflags.get_flags(_FLAGS), tflags.get_flags(_FLAGS))
    for f in (jflags, tflags):
        f.set_flags({"flight_dump_dir": str(tmp_path / "flight")})
    jfl.disarm()
    tfl.disarm()
    metrics.reset_metrics()
    yield
    jfl.disarm()
    tfl.disarm()
    jflags.set_flags(keep[0])
    tflags.set_flags(keep[1])


def _both(**flags):
    jflags.set_flags(flags)
    tflags.set_flags(flags)


# ---------------------------------------------------------------------------
# the seam registry
# ---------------------------------------------------------------------------


def test_seams_are_the_jax_packages_less_rank_divergence():
    want = jfl.seams()
    del want["rank_divergence"]
    assert sorted(tfl.seams()) == sorted(want)
    with pytest.raises(KeyError):
        tfl.arm("rank_divergence")
    tfl.arm("step_stall", action="stall", seconds=0)
    with pytest.raises(KeyError):
        tfl.crossing("no_such_seam")
    tfl.disarm()
    assert tfl.crossing("step_stall") is None
    e0 = tfl.epoch()
    tfl.arm("step_stall", action="stall", seconds=0)
    tfl.disarm("step_stall")
    assert tfl.epoch() == e0 + 2


WINDOWS = [
    # (arm kwargs, crossing contexts)
    (dict(at=1, times=1, match={"stage": "params"}),
     [{"stage": "rng"}, {"stage": "params"}, {"stage": "params"},
      {"stage": "params"}]),
    (dict(at=0, times=2), [{}, {}, {}, {"stage": "x"}]),
    (dict(at=2, times=None), [{}, {}, {}, {}, {}]),
    (dict(at=0, times=1, match={"stage": "a", "path": "p"}),
     [{"stage": "a"}, {"stage": "a", "path": "p"},
      {"stage": "a", "path": "p"}]),
]


@pytest.mark.parametrize("kw,ctxs", WINDOWS,
                         ids=[f"w{i}" for i in range(len(WINDOWS))])
def test_faultline_windows_are_the_jax_packages(kw, ctxs):
    traces = []
    for fl in (jfl, tfl):
        spec = fl.arm("checkpoint_write", action="raise", **kw)
        fired = []
        for ctx in ctxs:
            try:
                fired.append(fl.crossing("checkpoint_write", **ctx)
                             is not None)
            except fl.FaultlineError:
                fired.append("raised")
        traces.append((fired, spec.hits, spec.fired, fl.armed()))
        fl.disarm()
    assert traces[0] == traces[1]


# ---------------------------------------------------------------------------
# the CHAOS_r18 drill on BERT-tiny
# ---------------------------------------------------------------------------


def _bert_cfg(mod):
    cfg = mod.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _bert(mod, core, un, fluid):
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 7
    with core.program_guard(main, startup):
        _, total, _, _ = mod.build_pretrain_network(_bert_cfg(mod))
        fluid.optimizer.Adam(1e-3).minimize(total)
    return main, startup, total


def _jax_state(scope, names):
    return {n: np.asarray(scope.find_var(n)).copy() for n in names}


def _port_state(scope, names):
    return {n: scope.find_var(n).detach().numpy().copy() for n in names}


def _equal(a, b):
    return all(np.array_equal(a[n], b[n]) for n in a)


def _chaos_jax(batches):
    main, startup, total = _bert(jbert, jcore, jun, jfluid)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)).copy()
                for n in scope.var_names()
                if scope.find_var(n) is not None and not n.startswith("@")}
        names = [v.name for v in main.list_vars() if v.persistable]
        prepared = exe.prepare(main, fetch_list=[total], scope=scope)
        jfl.arm("grad_nonfinite", action="nan", step=CHAOS_POISON, times=1)
        out = {"losses": [], "skipped": [], "scales": [], "states": []}
        for b in batches:
            prepared.sync_scope()
            out["states"].append(_jax_state(scope, names))
            h, = prepared.run(b)
            out["losses"].append(float(np.asarray(h.numpy())))
            gi = prepared.guard_info(sync=True)
            out["skipped"].append(gi["last_skipped"])
            out["scales"].append(gi["loss_scale"])
        prepared.sync_scope()
        out["states"].append(_jax_state(scope, names))
        prepared.close()
    jfl.disarm()
    return init, names, out


def _chaos_port(batches, init, names):
    main, _, total = _bert(tbert, tcore, tun, tfluid)
    scope = tfluid.Scope()
    for n, t in tio.convert_params({n: init[n] for n in names},
                                   "cpu").items():
        scope.set_var(n, t)
    exe = tfluid.Executor(tfluid.CPUPlace())
    prepared = exe.prepare(main, fetch_list=[total], scope=scope,
                           donate_state=True)
    tfl.arm("grad_nonfinite", action="nan", step=CHAOS_POISON, times=1)
    out = {"losses": [], "skipped": [], "scales": [], "states": []}
    for b in batches:
        prepared.sync_scope()
        out["states"].append(_port_state(scope, names))
        h, = prepared.run(b)
        out["losses"].append(float(h))
        gi = prepared.guard_info(sync=True)
        out["skipped"].append(gi["last_skipped"])
        out["scales"].append(gi["loss_scale"])
    prepared.sync_scope()
    out["states"].append(_port_state(scope, names))
    tfl.disarm()
    return out


@pytest.mark.parametrize("loss_scale", [False, True],
                         ids=["guard", "guard_loss_scale"])
def test_chaos_drill_matches_the_jax_package(loss_scale):
    _both(guard_nonfinite=True, guard_loss_scale=loss_scale)
    rng = np.random.RandomState(0)
    batches = [jbert.make_fake_batch(rng, _bert_cfg(jbert), batch_size=2,
                                     seq_len=32, num_masks=3)
               for _ in range(CHAOS_STEPS)]
    init, names, want = _chaos_jax(batches)
    got = _chaos_port(batches, init, names)
    skipped = [i == CHAOS_POISON for i in range(CHAOS_STEPS)]
    assert want["skipped"] == skipped
    assert got["skipped"] == want["skipped"]
    assert got["scales"] == want["scales"]
    if loss_scale:
        assert got["scales"][CHAOS_POISON] == \
            got["scales"][CHAOS_POISON - 1] / 2
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=0,
                               atol=TOL)
    # the skipped step left every parameter and Adam moment bit for bit
    moments = [n for n in names if "moment" in n]
    assert moments
    before, after = got["states"][CHAOS_POISON], \
        got["states"][CHAOS_POISON + 1]
    assert _equal(before, after)
    assert _equal(want["states"][CHAOS_POISON],
                  want["states"][CHAOS_POISON + 1])
    assert not _equal(after, got["states"][CHAOS_POISON + 2])


# ---------------------------------------------------------------------------
# composition
# ---------------------------------------------------------------------------


def _fc(fluid, core, un, opt=None, width=6):
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 3
    with core.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[width])
        h = fluid.layers.fc(x, 8)
        loss = fluid.layers.mean(fluid.layers.fc(h, 3))
        (opt or fluid.optimizer.Adam(0.1)).minimize(loss)
    return main, startup, loss


def _feed(i=0, rows=4):
    rng = np.random.RandomState(7 + i)
    return {"x": rng.randn(rows, 6).astype(np.float32)}


def _snap(scope):
    return {n: v.detach().numpy().copy() for n, v in scope.vars.items()
            if isinstance(v, torch.Tensor) and not n.startswith("@")}


def test_guard_composes_with_amp_dynamic_scaling():
    """fp16 AMP: the poisoned step leaves every persistable bit for bit
    but AMP's own scale state, which backs off 64 -> 32, as in the JAX
    package."""
    from paddle_tpu.contrib.mixed_precision import decorate as jdecorate
    from paddle_tpu_torch.contrib.mixed_precision import decorate
    _both(guard_nonfinite=True)
    scales = []
    for fluid, core, un, dec, fl in (
            (jfluid, jcore, jun, jdecorate, jfl),
            (tfluid, tcore, tun, decorate, tfl)):
        opt = dec(fluid.optimizer.SGD(0.1), use_pure_bf16=False,
                  init_loss_scaling=64.0, decr_every_n_nan_or_inf=1,
                  decr_ratio=0.5)
        main, startup, loss = _fc(fluid, core, un, opt)
        scale_var = opt._loss_scale_var.name
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        if fluid is jfluid:
            with jfluid.scope_guard(scope):
                exe.run(startup)
                exe.run(main, feed=_feed(), fetch_list=[loss])
                jfl.arm("grad_nonfinite", action="nan", times=1)
                exe.run(main, feed=_feed(1), fetch_list=[loss])
            scales.append(float(np.asarray(scope.find_var(scale_var))))
            continue
        exe.run(startup, scope=scope)
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
        snap = _snap(scope)
        fl.arm("grad_nonfinite", action="nan", times=1)
        exe.run(main, feed=_feed(1), fetch_list=[loss], scope=scope)
        fl.disarm()
        post = _snap(scope)
        scales.append(float(post[scale_var].reshape(())))
        for n in snap:
            if n == scale_var or "good_steps" in n or "bad_steps" in n:
                continue
            assert np.array_equal(snap[n], post[n]), n
        assert int(scope.find_var(tguard.GUARD_SKIP_TOTAL)) == 1
    assert scales == [32.0, 32.0]


def test_guard_composes_with_microbatched_gradient_merge():
    from paddle_tpu_torch.framework.pipe import set_microbatches
    _both(guard_nonfinite=True)
    main, startup, loss = _fc(tfluid, tcore, tun)
    set_microbatches(main, 2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(0, rows=8), fetch_list=[loss], scope=scope)
    snap = _snap(scope)
    tfl.arm("grad_nonfinite", action="nan", times=1)
    exe.run(main, feed=_feed(1, rows=8), fetch_list=[loss], scope=scope)
    tfl.disarm()
    assert _equal(snap, _snap(scope))
    assert int(scope.find_var(tguard.GUARD_SKIP_TOTAL)) == 1
    exe.run(main, feed=_feed(2, rows=8), fetch_list=[loss], scope=scope)
    assert not _equal(snap, _snap(scope))


def test_guard_loss_scale_rejected_on_pipelined_program():
    from paddle_tpu.framework.pipe import set_microbatches as jset
    from paddle_tpu_torch.framework.pipe import set_microbatches as tset
    _both(guard_nonfinite=True, guard_loss_scale=True)
    for fluid, core, un, setm, err in ((jfluid, jcore, jun, jset, JInvalid),
                                       (tfluid, tcore, tun, tset,
                                        InvalidArgumentError)):
        main, startup, loss = _fc(fluid, core, un)
        setm(main, 2)
        exe = fluid.Executor(fluid.CPUPlace())
        scope = fluid.Scope()
        with fluid.scope_guard(scope):
            exe.run(startup)
            with pytest.raises(err, match="guard_loss_scale"):
                exe.run(main, feed=_feed(0, rows=8), fetch_list=[loss])


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """One launch of two gloo ranks running the ZeRO-1 and the 1F1B legs
    of tests/torch_guard_runner.py."""
    out = tmp_path_factory.mktemp("guard_ranks")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", "2", "--backend", "gloo", "--timeout", "180", RUNNER,
           "zero1,pp2", str(out)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]


@pytest.mark.parametrize("leg", ["zero1", "pp2"])
def test_both_ranks_skip_the_step_one_rank_poisons(two_ranks, leg):
    """NaN on rank 1 only: the probe's sum over the ranks makes both skip
    the same step, leaving what each holds bit for bit, as the JAX
    package's psum does (tests/test_guardrails.py's ZeRO-1 and 1F1B
    legs); the replicas stay equal."""
    r0, r1 = two_ranks
    for r in (r0, r1):
        assert r[f"{leg}/skipped_total"].tolist() == [0, 1, 1, 1]
        assert bool(r[f"{leg}/kept"]) and bool(r[f"{leg}/moved"])
        assert np.isfinite(r[f"{leg}/losses"]).all()
    np.testing.assert_array_equal(r0[f"{leg}/losses"], r1[f"{leg}/losses"])
    assert str(r0[f"{leg}/digest"]) == str(r1[f"{leg}/digest"])


# ---------------------------------------------------------------------------
# the skip budget, kernel #10's flag
# ---------------------------------------------------------------------------


def test_skip_budget_controlled_abort_with_replayable_bundle():
    _both(guard_nonfinite=True, max_skipped_steps=2)
    main, startup, loss = _fc(tfluid, tcore, tun)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    prepared = exe.prepare(main, fetch_list=[loss], scope=scope,
                           donate_state=True)
    prepared.run(_feed())
    tfl.arm("grad_nonfinite", action="nan", times=None)
    with pytest.raises(GuardrailViolation):
        for _ in range(40):
            prepared.run(_feed(1))
        prepared.wait()
    b = flight.validate_bundle(flight.last_dumps()[-1])
    assert b["reason"] == "guardrail_skip_budget_exhausted"
    g = b["extra"]["guard"]
    assert g["consecutive_skipped"] > 2 and g["loss_scale"] == 1.0
    assert g["probe_bits"] == jguard.probe_bits(np.float32("nan"))
    side = np.load(g["feed_file"])
    assert set(side.files) >= {"x", "__rng_key__", "__step_counter__",
                               "__loss_scale__"}
    from paddle_tpu_torch.framework.serialization import desc_to_program
    prog = desc_to_program(json.load(open(g["program_file"])))
    assert any(op.type == "backward" for op in prog.global_block().ops)
    assert b["extra"]["faultline"][0]["seam"] == "grad_nonfinite"


@pytest.mark.parametrize("dtypes", [(torch.float32,) * 3,
                                    (torch.bfloat16, torch.float32,
                                     torch.float32)],
                         ids=["f32", "bf16_p"])
def test_adam_twin_skip_flag_leaves_state_bit_for_bit(dtypes):
    g = torch.Generator().manual_seed(0)

    def entry(n, coeff):
        p = torch.randn(n, generator=g).to(dtypes[0])
        m = torch.randn(n, generator=g).to(dtypes[1])
        v = torch.rand(n, generator=g).to(dtypes[2])
        return tadam.AdamTensor(
            p, torch.randn(n, generator=g).to(dtypes[1]), m, v,
            torch.tensor([1e-3]), torch.tensor([0.9 ** 3]),
            torch.tensor([0.999 ** 3]), coeff=coeff)

    run = [entry(37, 0.0), entry(1000, 0.01)]
    before = [[t.clone() for t in e[:4] + e[5:7]] for e in run]
    tadam.adam_multi_plain(run, skip=torch.tensor([1], dtype=torch.int32))
    for e, b in zip(run, before):
        for t, t0 in zip(e[:4] + e[5:7], b):
            assert torch.equal(t, t0)
    # flag 0: the twin's update, bit for bit the unflagged one's
    twin = [e._replace(p=e.p.clone(), m=e.m.clone(), v=e.v.clone(),
                       beta1_pow=e.beta1_pow.clone(),
                       beta2_pow=e.beta2_pow.clone()) for e in run]
    tadam.adam_multi_plain(run, skip=torch.tensor([0], dtype=torch.int32))
    tadam.adam_multi_plain(twin)
    for e, t in zip(run, twin):
        for a, b in zip(e[:4] + e[5:7], t[:4] + t[5:7]):
            assert torch.equal(a, b)
    assert not torch.equal(run[0].p, before[0][0])


# ---------------------------------------------------------------------------
# the other drills
# ---------------------------------------------------------------------------


class _StubStep:
    """A stand-in for a training step: a watchdog beacon around a
    ``step_stall`` crossing, as ``PreparedStep.run`` brackets its step."""

    def run(self):
        watchdog.begin("prepared")
        try:
            tfl.crossing("step_stall")
        finally:
            watchdog.end("prepared")


@pytest.mark.parametrize("stall,deadline,trips", [(0.9, 0.3, 1),
                                                  (0.08, 2.0, 0)],
                         ids=["stalled", "slow_but_healthy"])
def test_watchdog_on_a_stub_step(stall, deadline, trips):
    tflags.set_flags({"step_deadline_s": deadline})
    watchdog.ensure_started()
    base = len(watchdog.trips())
    tfl.arm("step_stall", action="stall", seconds=stall,
            times=1 if trips else None)
    step = _StubStep()
    for _ in range(1 if trips else 5):
        step.run()
    tfl.disarm()
    if not trips:
        time.sleep(0.4)
    tflags.set_flags({"step_deadline_s": 0.0})
    new = watchdog.trips()[base:]
    assert len(new) == trips
    if trips:
        assert new[0]["beacon"] == "prepared"
        b = flight.validate_bundle(new[0]["bundle"])
        stacks = b["extra"]["thread_stacks"]
        assert any("crossing" in "".join(fr) for fr in stacks.values())
        snap = metrics.metrics_snapshot(include_serving=False)
        assert sum(int(m.get("value", 0)) for m in snap["metrics"]
                   if m["name"] == "watchdog::trip") == 1


class _StubPredictor:
    compiled_executables = 0

    def get_input_names(self):
        return ["x"]

    def get_output_names(self):
        return ["y"]

    def prepare(self):
        return self

    def run_feed_async(self, feed):
        return [np.asarray(feed["x"]) * 2.0]


class _Handle(np.ndarray):
    def numpy(self):
        return np.asarray(self)


def test_serving_worker_fatal_fails_every_future():
    from paddle_tpu_torch.serving import ServingConfig, ServingEngine
    pred = _StubPredictor()
    pred.run_feed_async = lambda feed: [
        (np.asarray(feed["x"]) * 2.0).view(_Handle)]
    eng = ServingEngine(pred, ServingConfig(max_batch_size=4,
                                            max_wait_ms=1.0))
    ok = eng.submit({"x": np.ones((1, 3), np.float32)})
    assert np.allclose(ok.result(timeout=10)[0], 2.0)
    tfl.arm("serving_worker", action="raise", times=1)
    futs = [eng.submit({"x": np.ones((1, 3), np.float32)})
            for _ in range(3)]
    for f in futs:
        with pytest.raises(UnavailableError, match="worker died"):
            f.result(timeout=10)
    tfl.disarm()
    assert eng.stats()["unhealthy"] is True
    with pytest.raises(UnavailableError, match="unhealthy"):
        eng.submit({"x": np.ones((1, 3), np.float32)})
    assert any(json.load(open(p))["reason"] == "serving_worker_fatal"
               for p in flight.last_dumps())
    assert eng.drain(timeout=5)


@pytest.mark.parametrize("times", [1, None], ids=["retried", "exhausted"])
def test_checkpoint_write_corruption(tmp_path, times):
    from paddle_tpu_torch.monitor import stat
    tflags.set_flags({"checkpoint_retries": 1,
                      "checkpoint_retry_backoff_s": 0.0})
    main, startup, loss = _fc(tfluid, tcore, tun)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    base = stat("checkpoint_retry_total").get()
    tfl.arm("checkpoint_write", action="corrupt_file",
            match={"stage": "params"}, times=times)
    if times is None:
        with pytest.raises(tio.ChecksumMismatchError):
            tio.save_checkpoint(exe, str(tmp_path / "c"), tio.TrainStatus(0),
                                main, scope=scope)
        return
    d = tio.save_checkpoint(exe, str(tmp_path / "c"), tio.TrainStatus(0),
                            main, scope=scope)
    tfl.disarm()
    assert stat("checkpoint_retry_total").get() - base == 1
    assert tio.validate_checkpoint_dir(d) == (True, "ok")
    snap = metrics.metrics_snapshot(include_serving=False)
    assert [m["value"] for m in snap["metrics"]
            if m["name"] == "checkpoint::retry"
            and m["labels"] == {"stage": "params"}] == [1.0]
    fresh = tfluid.Scope()
    exe.run(startup, scope=fresh)
    tio.load_checkpoint(exe, str(tmp_path / "c"), main_program=main,
                        scope=fresh)
    assert _equal(_snap(scope), _snap(fresh))


def test_collective_impl_seam_raises_as_enforce_not_met():
    main, startup, loss = _fc(tfluid, tcore, tun)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tfl.arm("collective_impl", action="raise", match={"op": "mean"},
            times=1)
    with pytest.raises(EnforceNotMet, match="mean"):
        exe.run(main, feed=_feed(), fetch_list=[loss], scope=scope)
    assert json.load(open(flight.last_dumps()[-1]))["reason"] == \
        "executor_run_exception"


def test_reshard_execute_during_a_restore(tmp_path):
    """A fault between two per-var transfers of a restore that reshards
    (fsdp 8 -> fsdp 4) raises out of ``load_checkpoint`` with a flight
    bundle; the next restore is bit for bit."""
    from paddle_tpu_torch.framework import reshard
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    main, startup, loss = _fc(tfluid, tcore, tun, width=8)
    for p in main.all_parameters():
        if len(p.shape) == 2:
            p.dist_attr = ("fsdp", None)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    path = str(tmp_path / "c")
    tio.save_checkpoint(exe, path, tio.TrainStatus(0), main, scope=scope,
                        layout=MeshLayout(fsdp=8))
    spec = reshard.arm_fault(action="raise", at=1)
    fresh = tfluid.Scope()
    exe.run(startup, scope=fresh)
    with pytest.raises(tfl.FaultlineError, match="reshard_execute"):
        tio.load_checkpoint(exe, path, main_program=main, scope=fresh,
                            dst_layout=MeshLayout(fsdp=4))
    assert spec.fired == 1
    assert json.load(open(flight.last_dumps()[-1]))["reason"] == \
        "checkpoint_restore_failed"
    tfl.disarm()
    st = tio.load_checkpoint(exe, path, main_program=main, scope=fresh,
                             dst_layout=MeshLayout(fsdp=4))
    assert st.reshard["vars_moved"] == 2
    assert _equal(_snap(scope), _snap(fresh))
