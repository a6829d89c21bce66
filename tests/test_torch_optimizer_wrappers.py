"""The wrapper optimizers of the PyTorch port against the JAX package, on
the CPU: GradientMerge, DGCMomentum, ModelAverage, ExponentialMovingAverage,
Lookahead and LocalSGD, and fleet's ``gradient_merge``, ``use_dgc``,
``localsgd`` and ``recompute`` flags.

* Each wrapper builds the JAX package's program, desc for desc (main and
  startup: ops, attrs, the step counters, accumulators and their
  ``fill_constant``\\ s), and from the JAX startup's state the port's
  steps give the JAX package's losses and persistables after every step:
  float32 within 1e-5 (abs + rel, Adam's parity), counters bit for bit
  (the cases of the JAX package's ``tests/test_optimizers_extra.py``:
  DGC before and after its ramp, Lookahead, LocalSGD on one rank,
  ModelAverage's window shift, EMA with and without ``thres_steps``).
  ``apply()`` / ``restore()`` of ModelAverage and EMA give the JAX
  package's averaged weights within 1e-5 and the parameters back bit for
  bit; EMA's applied weight is ``ema / (1 - prod decay)`` to the ulp.
* GradientMerge k = 4 with Adam and AdamW on BERT-tiny (dropout 0), 8
  steps through ``Executor.run`` and ``prepare(donate_state=True)``: the
  JAX package's losses, merged gradients and state within 1e-5; on the
  three steps of four that do not apply, every parameter and moment bit
  for bit unchanged; the accumulators zero after an apply; Adam #10's one
  launch (its twin here) once per apply, inside the conditional block.
* DGC's threshold (:func:`optimizer_ops.quantile_linear`, a sort) is
  ``np.quantile`` in float64, rounded once, within one float32 ulp, also
  on more than 2^24 elements, where ``torch.quantile`` refuses; and
  ``jnp.quantile`` within what its float32 rank position moves it.
* ``fleet``'s programs are the JAX package's ``_compose``'s, desc for
  desc; its conflict checks raise the JAX package's errors.
* LocalSGD on two gloo ranks (``tests/torch_dist_runner.py``): no
  gradient all-reduce in the program, the ranks' parameters differ after
  a step that does not sync and are bit-identical after one that does,
  where they equal the JAX package's on a two-device mesh within 1e-5."""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu.fluid as jfluid
from paddle_tpu.distributed.fleet import (CollectiveOptimizer as JColl,
                                          DistributedStrategy as JStrategy)
from paddle_tpu.distributed.fleet import fleet as jfleet
from paddle_tpu.distributed.fleet import UserDefinedRoleMaker as JRoleMaker
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                UserDefinedRoleMaker)
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.serialization import \
    program_to_desc as tdesc
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import optimizer_ops, registry
from paddle_tpu_torch.ops.cuda import optimizer as topt

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_dist_runner.py")
LAUNCH_TIMEOUT_S = 180
TOL = 1e-5
PACKAGES = {"jax": (jfluid, jcore, jun, jbert),
            "port": (tfluid, tcore, tun, tbert)}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    tcore.reset_default_programs()


def _desc(pkg, program):
    return json.dumps((jdesc if pkg == "jax" else tdesc)(program),
                      sort_keys=True)


def _is_int(a):
    return np.issubdtype(np.asarray(a).dtype, np.integer)


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    if _is_int(want) or want.dtype == np.bool_:
        np.testing.assert_array_equal(got, want, err_msg=what)
    else:
        np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                   err_msg=what)


# ---------------------------------------------------------------------------
# one program in both packages, trained from the JAX startup's state
# ---------------------------------------------------------------------------


def _mlp(fluid):
    x = fluid.layers.data("x", shape=[8])
    y = fluid.layers.data("y", shape=[1])
    h = fluid.layers.fc(x, 8, act="tanh")
    pred = fluid.layers.fc(h, 1)
    return fluid.layers.mean(fluid.layers.square(pred - y))


def _build(pkg, make_opt, post=None, model=_mlp):
    """``model`` + ``make_opt(fluid).minimize`` (+ ``post(fluid)``, built
    after it in the same programs); returns (main, startup, loss, post's
    result)."""
    fluid, core, un, _ = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 3
    with core.program_guard(main, startup):
        loss = model(fluid)
        make_opt(fluid).minimize(loss)
        extra = post(fluid) if post is not None else None
    return main, startup, loss, extra


def _feeds(steps, seed=0):
    rng = np.random.RandomState(seed)
    w = rng.randn(8, 1).astype(np.float32)
    out = []
    for _ in range(steps):
        x = rng.randn(16, 8).astype(np.float32)
        out.append({"x": x, "y": np.tanh(x @ w)})
    return out


def _persistables(program):
    return sorted(v.name for v in program.list_vars() if v.persistable)


def _jax_train(main, startup, loss, feeds, fetch=()):
    """(scope, init state, per step: loss, state, fetched values)."""
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    names = _persistables(main)
    steps = []
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        for f in feeds:
            out = exe.run(main, feed=f, fetch_list=[loss] + list(fetch))
            steps.append((float(np.asarray(out[0])),
                          {n: np.asarray(scope.find_var(n)) for n in names},
                          [np.asarray(o) for o in out[1:]]))
    return scope, init, steps


def _port_train(main, loss, init, feeds, fetch=(), prepared=False):
    names = _persistables(main)
    scope = tfluid.Scope()
    for n, t in tio.convert_params({n: init[n] for n in names},
                                   "cpu").items():
        scope.set_var(n, t)
    exe = tfluid.Executor(tfluid.CPUPlace())
    step = exe.prepare(main, fetch_list=[loss] + list(fetch), scope=scope,
                       donate_state=True) if prepared else None
    steps = []
    for f in feeds:
        if prepared:
            out = [h.numpy() for h in step.run(f)]
            tfluid.sync_prepared_state(scope)
        else:
            out = exe.run(main, feed=f, fetch_list=[loss] + list(fetch),
                          scope=scope)
        steps.append((float(out[0]),
                      {n: scope.find_var(n).detach().numpy().copy()
                       for n in names}, list(out[1:])))
    return scope, exe, steps, step


def _check_steps(port, ref, skip=()):
    for i, ((pl, ps, pf), (jl, js, jf)) in enumerate(zip(port, ref)):
        assert abs(pl - jl) <= TOL * max(1.0, abs(jl)), (i, pl, jl)
        for n, want in js.items():
            if n not in skip:
                _close(ps[n], want, f"step {i + 1}: {n}")
        for k, (a, b) in enumerate(zip(pf, jf)):
            _close(a, b, f"step {i + 1}: fetch {k}")


WRAPPERS = {
    "dgc-before-ramp": lambda f: f.optimizer.DGCMomentumOptimizer(
        learning_rate=0.05, momentum=0.9, rampup_begin_step=1000),
    "dgc-ramped": lambda f: f.optimizer.DGCMomentumOptimizer(
        learning_rate=0.05, momentum=0.9, rampup_begin_step=2,
        rampup_step=4, sparsity=[0.5, 0.75]),
    "dgc-nesterov": lambda f: f.optimizer.DGCMomentumOptimizer(
        learning_rate=0.05, momentum=0.9, rampup_begin_step=0,
        sparsity=[0.9], use_nesterov=True),
    "lookahead-sgd": lambda f: f.optimizer.LookaheadOptimizer(
        f.optimizer.SGD(0.1), alpha=0.5, k=3),
    "lookahead-adam": lambda f: f.optimizer.LookaheadOptimizer(
        f.optimizer.Adam(0.01), alpha=0.8, k=2),
    "localsgd-one-rank": lambda f: f.optimizer.LocalSGDOptimizer(
        f.optimizer.SGD(0.1), k_steps=4),
    "gradient-merge-sgd": lambda f: f.optimizer.GradientMergeOptimizer(
        f.optimizer.SGD(0.1), k_steps=3, avg=False),
    "gradient-merge-adam": lambda f: f.optimizer.GradientMergeOptimizer(
        f.optimizer.Adam(0.01), k_steps=2),
    "recompute-momentum": lambda f: f.optimizer.RecomputeOptimizer(
        f.optimizer.Momentum(0.05, 0.9)),
}


@pytest.mark.parametrize("prepared", [False, True], ids=["run", "prepare"])
@pytest.mark.parametrize("wrapper", sorted(WRAPPERS))
def test_wrappers_build_and_train_like_the_jax_package(wrapper, prepared):
    make = WRAPPERS[wrapper]
    jmain, jstart, jloss, _ = _build("jax", make)
    tmain, tstart, tloss, _ = _build("port", make)
    assert _desc("port", tmain) == _desc("jax", jmain)
    assert _desc("port", tstart) == _desc("jax", jstart)
    feeds = _feeds(8)
    _, init, ref = _jax_train(jmain, jstart, jloss, feeds)
    _, _, port, _ = _port_train(tmain, tloss, init, feeds, prepared=prepared)
    _check_steps(port, ref)


def test_dgc_before_its_ramp_is_momentum():
    """ref: the dgc op's docs — plain momentum before rampup_begin_step
    (the JAX package's ``test_dgc_momentum_matches_momentum_before_rampup``,
    in the port)."""
    feeds = _feeds(5, seed=3)
    runs = []
    for make in (WRAPPERS["dgc-before-ramp"],
                 lambda f: f.optimizer.Momentum(0.05, momentum=0.9)):
        jmain, jstart, jloss, _ = _build("jax", make)
        _, init, _ = _jax_train(jmain, jstart, jloss, feeds[:0])
        tmain, _, tloss, _ = _build("port", make)
        runs.append([s[0] for s in _port_train(tmain, tloss, init,
                                               feeds)[2]])
    np.testing.assert_allclose(runs[0], runs[1], rtol=TOL)


def _np_quantile(vals, q):
    """``np.quantile`` in float64 at the float32 ``q``, rounded once."""
    return np.float32(np.quantile(vals.astype(np.float64),
                                  float(np.float32(q))))


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.7, 0.999, 1.0])
@pytest.mark.parametrize("n", [1, 7, 1000, 12345])
def test_the_dgc_threshold_is_the_linear_quantile(n, q):
    rng = np.random.RandomState(n)
    vals = np.abs(rng.randn(n)).astype(np.float32)
    got = optimizer_ops.quantile_linear(torch.from_numpy(vals),
                                        torch.tensor(q, dtype=torch.float32))
    assert got.dtype == torch.float32 and got.dim() == 0
    want = _np_quantile(vals, q)
    assert abs(float(got) - want) <= np.spacing(want), (float(got), want)
    # jnp.quantile forms the rank position q (n - 1) in float32: its weight
    # is off by up to an ulp of the position, of the neighbours' gap
    jq = np.asarray(jnp.quantile(jnp.asarray(vals), jnp.float32(q)))
    srt = np.sort(vals)
    pos = q * (n - 1)
    gap = float(srt[int(np.ceil(pos))] - srt[int(np.floor(pos))])
    slack = gap * float(np.spacing(np.float32(max(pos, 1.0)))) + \
        float(np.spacing(want))
    assert abs(float(got) - float(jq)) <= slack, (float(got), float(jq))


def test_the_dgc_threshold_past_torch_quantiles_limit():
    """More than 2^24 elements (BERT-base's word embedding has 23.4 M),
    where ``torch.quantile`` refuses: within one float32 ulp of
    ``np.quantile`` in float64, rounded once."""
    n = 2 ** 24 + 4099
    vals = np.abs(np.random.RandomState(0).randn(n)).astype(np.float32)
    t = torch.from_numpy(vals)
    with pytest.raises(RuntimeError, match="too large"):
        torch.quantile(t, 0.5)
    for q in (0.999, 0.9):
        got = float(optimizer_ops.quantile_linear(
            t, torch.tensor(q, dtype=torch.float32)))
        want = _np_quantile(vals, q)
        assert abs(got - want) <= np.spacing(want), (q, got, want)


def _average_post(fluid):
    return fluid.optimizer.ModelAverage(0.15, min_average_window=2,
                                        max_average_window=4)


def _ema_post(thres):
    def post(fluid):
        t = None
        if thres:
            t = fluid.layers.fill_constant([1], "float32", 5.0)
        ema = fluid.optimizer.ExponentialMovingAverage(0.9, thres_steps=t)
        ema.update()
        return ema
    return post


AVERAGES = {"model-average": _average_post, "ema": _ema_post(False),
            "ema-thres-steps": _ema_post(True)}


def _scope_value(pkg, scope, name):
    v = scope.find_var(name)
    return np.asarray(v) if pkg == "jax" else v.detach().numpy().copy()


@pytest.mark.parametrize("average", sorted(AVERAGES))
def test_averages_apply_and_restore_like_the_jax_package(average):
    post = AVERAGES[average]
    sgd = lambda f: f.optimizer.SGD(0.1)      # noqa: E731
    jmain, jstart, jloss, javg = _build("jax", sgd, post)
    tmain, tstart, tloss, tavg = _build("port", sgd, post)
    assert _desc("port", tmain) == _desc("jax", jmain)
    assert _desc("port", tstart) == _desc("jax", jstart)
    assert _desc("port", tavg._apply_program) == \
        _desc("jax", javg._apply_program)
    assert _desc("port", tavg._restore_program) == \
        _desc("jax", javg._restore_program)
    feeds = _feeds(7)
    jscope, init, ref = _jax_train(jmain, jstart, jloss, feeds)
    tscope, texe, port, _ = _port_train(tmain, tloss, init, feeds)
    # the window shifts and the counters are the JAX package's, bit for bit
    _check_steps(port, ref)
    params = [p.name for p in tmain.all_parameters()]
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        with javg.apply(jexe):
            japplied = {n: _scope_value("jax", jscope, n) for n in params}
    before = {n: _scope_value("port", tscope, n) for n in params}
    with tfluid.scope_guard(tscope):
        with tavg.apply(texe):
            applied = {n: _scope_value("port", tscope, n) for n in params}
        after = {n: _scope_value("port", tscope, n) for n in params}
    for n in params:
        _close(applied[n], japplied[n], n)
        assert not np.array_equal(applied[n], before[n]), n
        assert np.array_equal(after[n], before[n]), n
    if average.startswith("ema"):
        prod = _scope_value("port", tscope, tavg._decay_prod.name)
        factor = np.float32(1.0) - prod.astype(np.float32)
        for n in params:
            ema = _scope_value("port", tscope, tavg._ema_vars[n].name)
            want = ema / factor
            np.testing.assert_array_max_ulp(applied[n], want, maxulp=1)


def test_ema_of_frozen_parameters_is_the_parameters():
    """The JAX package's ``test_ema_tracks_params`` and
    ``test_ema_with_thres_steps_bias_correction``: with the LR at 0 the
    bias-corrected EMA is the parameter, ramped decay or not."""
    for post in (_ema_post(False), _ema_post(True)):
        main, startup, loss, ema = _build(
            "port", lambda f: f.optimizer.SGD(0.0), post)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        with tfluid.scope_guard(scope):
            exe.run(startup)
            w0 = {p.name: _scope_value("port", scope, p.name)
                  for p in main.all_parameters()}
            for f in _feeds(12):
                exe.run(main, feed=f, fetch_list=[loss])
            with ema.apply(exe):
                for n, w in w0.items():
                    np.testing.assert_allclose(
                        _scope_value("port", scope, n), w, rtol=1e-4)


def test_lookahead_syncs_fast_to_slow_every_k_steps():
    make = WRAPPERS["lookahead-sgd"]
    jmain, jstart, jloss, _ = _build("jax", make)
    _, init, _ = _jax_train(jmain, jstart, jloss, [])
    tmain, _, tloss, _ = _build("port", make)
    _, _, port, _ = _port_train(tmain, tloss, init, _feeds(6),
                                prepared=True)
    params = [p.name for p in tmain.all_parameters()]
    slow = {n: [v for v in port[0][1] if v.startswith(f"{n}_slow")][0]
            for n in params}
    for i, (_, state, _) in enumerate(port):
        synced = (i + 1) % 3 == 0
        for n in params:
            same = np.array_equal(state[n], state[slow[n]])
            assert same == synced, (i + 1, n)


# ---------------------------------------------------------------------------
# GradientMerge on BERT-tiny
# ---------------------------------------------------------------------------

GM_STEPS = 8
GM_K = 4


def _bert_model(fluid):
    bert = tbert if fluid is tfluid else jbert
    cfg = bert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    _, total, _, _ = bert.build_pretrain_network(cfg)
    return total


GM_INNER = {
    "adam": lambda f: f.optimizer.Adam(1e-3),
    "adamw": lambda f: f.optimizer.AdamW(
        1e-3, weight_decay=0.01,
        grad_clip=f.clip.GradientClipByGlobalNorm(1.0)),
}


@pytest.fixture(scope="module")
def gm_batches():
    rng = np.random.RandomState(0)
    return [jbert.make_fake_batch(rng, jbert.BertConfig.tiny(), batch_size=2,
                                  seq_len=64, num_masks=5)
            for _ in range(GM_STEPS)]


@pytest.mark.parametrize("prepared", [False, True], ids=["run", "prepare"])
@pytest.mark.parametrize("inner", sorted(GM_INNER))
def test_gradient_merge_on_bert_tiny(inner, prepared, gm_batches,
                                     monkeypatch):
    def make(f):
        return f.optimizer.GradientMergeOptimizer(GM_INNER[inner](f),
                                                  k_steps=GM_K, avg=True)
    jmain, jstart, jloss, _ = _build("jax", make, model=_bert_model)
    tmain, tstart, tloss, _ = _build("port", make, model=_bert_model)
    assert _desc("port", tmain) == _desc("jax", jmain)
    assert _desc("port", tstart) == _desc("jax", jstart)
    eff = [v.name for v in tmain.global_block().vars.values()
           if "_gm_eff" in v.name][:3]
    _, init, ref = _jax_train(jmain, jstart, jloss, gm_batches, fetch=eff)
    calls = []
    real = topt.adam_multi
    monkeypatch.setattr(topt, "adam_multi",
                        lambda entries: (calls.append(len(entries)),
                                         real(entries))[1])
    _, _, port, step = _port_train(tmain, tloss, init, gm_batches,
                                   fetch=eff, prepared=prepared)
    _check_steps(port, ref)
    names = _persistables(tmain)
    gb = tmain.global_block()
    params = [p.name for p in tmain.all_parameters()]
    moments = [n for n in names if "_moment" in n or "_pow_acc" in n]
    accs = [n for n in names if "_gm_acc" in n]
    assert len(accs) == len(params) == 38 and len(moments) == 4 * 38
    # the whole inner apply sits in the true branch of one cond
    cb, = [op for op in gb.ops if op.type == "conditional_block"]
    true_ops = {op.type for op in cb.attrs["true_block"].ops}
    assert inner in true_ops and not {"adam", "adamw"} & \
        {op.type for op in gb.ops}
    prev = init
    for i, (_, state, _) in enumerate(port):
        applied = (i + 1) % GM_K == 0
        for n in params + moments:
            same = np.array_equal(state[n], prev[n])
            assert same != applied, (i + 1, n)
        if applied:
            for n in accs:
                assert not state[n].any(), (i + 1, n)
        prev = state
    # #10's twin: one launch per apply step (38 ops in one run)
    assert calls == [38] * (GM_STEPS // GM_K)
    if prepared:
        assert step.stats["predicate_reads"] == GM_STEPS


# ---------------------------------------------------------------------------
# fleet
# ---------------------------------------------------------------------------


def _fleet_program(pkg, configure, inner):
    fluid, core, un, _ = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 11
    with core.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16])
        h = fluid.layers.fc(x, 16, act="tanh")
        loss = fluid.layers.mean(fluid.layers.fc(h, 3))
        if pkg == "jax":
            s = JStrategy()
            configure(s, h)
            JColl(inner(fluid), s)._compose(inner(fluid)).minimize(loss)
        else:
            tfleet.init(UserDefinedRoleMaker(0, 1, place=fluid.CPUPlace()))
            s = DistributedStrategy()
            configure(s, h)
            tfleet.distributed_optimizer(inner(fluid), s).minimize(loss)
            assert tfleet.main_program is main
    return main, startup


def _set(**flags):
    def configure(s, h):
        for k, v in flags.items():
            setattr(s, k, v)
    return configure


def _recompute(**flags):
    def configure(s, h):
        s.recompute = True
        s.recompute_configs = {"checkpoints": [h.name]}
        _set(**flags)(s, h)
    return configure


FLEET = {
    "gradient_merge": (_set(gradient_merge=True, gradient_merge_configs={
        "k_steps": 4, "avg": True}), "adam"),
    "gradient_merge-sum": (_set(gradient_merge=True, gradient_merge_configs={
        "k_steps": 2, "avg": False}), "sgd"),
    "localsgd": (_set(localsgd=True, localsgd_configs={"k_steps": 2}),
                 "sgd"),
    "localsgd-begin": (_set(localsgd=True, localsgd_configs={
        "k_steps": 3, "begin_step": 4}), "momentum"),
    "use_dgc": (_set(use_dgc=True), "momentum"),
    "use_dgc-not-momentum": (_set(use_dgc=True), "adam"),
    "recompute": (_recompute(), "adam"),
    "recompute-gradient_merge": (_recompute(
        gradient_merge=True, gradient_merge_configs={"k_steps": 2,
                                                      "avg": True}),
        "adamw"),
    "amp-recompute-gradient_merge": (_recompute(
        amp=True, gradient_merge=True, gradient_merge_configs={
            "k_steps": 2, "avg": True}), "adam"),
    "lamb-gradient_merge": (_set(lamb=True, gradient_merge=True,
                                 gradient_merge_configs={"k_steps": 2,
                                                         "avg": True}),
                            "sgd"),
    "use_dgc-amp": (_set(use_dgc=True, amp=True), "momentum"),
}
INNER = {
    "sgd": lambda f: f.optimizer.SGD(0.1),
    "adam": lambda f: f.optimizer.Adam(
        0.01, grad_clip=f.clip.GradientClipByGlobalNorm(1.0)),
    "adamw": lambda f: f.optimizer.AdamW(0.01),
    "momentum": lambda f: f.optimizer.Momentum(
        0.05, momentum=0.9, regularization=f.regularizer.L2Decay(1e-4)),
}


@pytest.mark.parametrize("case", sorted(FLEET))
def test_fleet_strategies_emit_the_jax_program(case):
    configure, inner = FLEET[case]
    jmain, jstart = _fleet_program("jax", configure, INNER[inner])
    tmain, tstart = _fleet_program("port", configure, INNER[inner])
    assert _desc("port", tmain) == _desc("jax", jmain)
    assert _desc("port", tstart) == _desc("jax", jstart)
    ops = [op.type for op in tmain.global_block().ops]
    bw = next(op for op in tmain.global_block().ops
              if op.type == "backward")
    assert bool(bw.attrs.get("checkpoints")) == case.startswith(
        ("recompute", "amp-recompute"))
    assert ("conditional_block" in ops) == ("gradient_merge" in case)
    assert ("local_sgd_sync" in ops) == case.startswith("localsgd")
    assert ("dgc_momentum" in ops) == (case.startswith("use_dgc") and
                                       inner == "momentum")
    # one rank: the program runs as minimize left it, and it trains
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    feed = {"x": np.random.RandomState(1).randn(8, 16).astype(np.float32)}
    loss = [op for op in tmain.global_block().ops
            if op.type == "backward"][0].attrs["loss_name"]
    vals = [float(exe.run(tmain, feed=feed, fetch_list=[loss],
                          scope=scope)[0]) for _ in range(4)]
    assert np.isfinite(vals).all()


#: conflicting strategies: each raises the JAX package's error first,
#: whether or not every flag of it is ported
CONFLICTS = [
    {"localsgd": True, "gradient_merge": True},
    {"localsgd": True, "use_dgc": True},
    {"lamb": True, "use_dgc": True},
    {"pipeline": True, "localsgd": True},
    {"pipeline": True, "recompute": True},
    {"overlap_grad_sync": True, "localsgd": True},
    {"auto_shard": True, "localsgd": True},
    {"auto_shard": True, "sharded_update": True},
    {"sharded_update": True, "localsgd": True},
    {"sharding": True, "use_dgc": True},
    {"sharding": True, "lamb": True},
    {"bf16_allreduce": True, "quant_allreduce": True},
]


@pytest.mark.parametrize("flags", CONFLICTS,
                         ids=lambda f: "+".join(sorted(f)))
def test_strategy_conflicts_raise_the_jax_error(flags):
    s = JStrategy()
    for k, v in flags.items():
        setattr(s, k, v)
    with pytest.raises(Exception) as jerr:
        JColl._validate(s)
    tcore.reset_default_programs()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        t = DistributedStrategy()
        for k, v in flags.items():
            setattr(t, k, v)
        before = len(main.global_block().ops)
        with pytest.raises(Exception) as terr:
            tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1),
                                         t).minimize(loss)
        assert len(main.global_block().ops) == before
    assert type(terr.value).__name__ == type(jerr.value).__name__
    assert str(terr.value) == str(jerr.value)


# ---------------------------------------------------------------------------
# LocalSGD on two gloo ranks
# ---------------------------------------------------------------------------

LOCALSGD_STEPS = 4
LOCALSGD_K = 2


def _localsgd_model(fluid):
    x = fluid.layers.data("x", shape=[8])
    y = fluid.layers.data("y", shape=[1])
    h = fluid.layers.fc(x, 8, act="tanh")
    return fluid.layers.mean(fluid.layers.square(fluid.layers.fc(h, 1) - y))


def _jax_localsgd(feeds):
    """The JAX package's fleet on a two-device mesh, its state after each
    step."""
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 3
    with jfluid.program_guard(main, startup):
        loss = _localsgd_model(jfluid)
        jfleet.init(JRoleMaker(0, 1))
        s = JStrategy()
        s.localsgd = True
        s.localsgd_configs = {"k_steps": LOCALSGD_K}
        s.mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        from paddle_tpu.distributed.fleet import distributed_optimizer
        distributed_optimizer(jfluid.optimizer.SGD(0.2), s).minimize(loss)
    names = _persistables(main)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    states = []
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        for f in feeds:
            exe.run(jfleet.main_program, feed=f, fetch_list=[loss])
            states.append({n: np.asarray(scope.find_var(n)) for n in names})
    return init, states


def test_localsgd_on_two_gloo_ranks(tmp_path):
    feeds = _feeds(LOCALSGD_STEPS, seed=5)
    init, jstates = _jax_localsgd(feeds)
    arrays = {f"p/{n}": a for n, a in init.items()}
    for i, b in enumerate(feeds):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    np.savez(tmp_path / "in.npz", **arrays)
    out_dir = tmp_path / "out"
    out_dir.mkdir()
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", "2", "--backend", "gloo", "--timeout",
           str(LAUNCH_TIMEOUT_S), RUNNER, "localsgd",
           str(tmp_path / "in.npz"), str(LOCALSGD_K), str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, OMP_NUM_THREADS="2"),
                          timeout=LAUNCH_TIMEOUT_S + 60)
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    ranks = [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2)]
    ops = list(ranks[0]["ops"])
    assert "local_sgd_sync" in ops
    assert not [o for o in ops if o.startswith("c_") and "allreduce" in o]
    params = sorted({k.split("/", 1)[1] for k in ranks[0]
                     if k.startswith("s0/")})
    assert params
    for i in range(LOCALSGD_STEPS):
        synced = (i + 1) % LOCALSGD_K == 0
        for n in params:
            a, b = ranks[0][f"s{i}/{n}"], ranks[1][f"s{i}/{n}"]
            assert np.array_equal(a, b) == synced, (i + 1, n)
            if synced:
                np.testing.assert_allclose(a, jstates[i][n], rtol=TOL,
                                           atol=TOL, err_msg=f"{i + 1} {n}")
    assert list(ranks[0]["predicate_reads"]) == [LOCALSGD_STEPS]
