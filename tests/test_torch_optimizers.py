"""The optimizers of the PyTorch port against the JAX package, on the CPU.

* Momentum (and Nesterov), LarsMomentum, Lamb (and with an
  ``exclude_from_weight_decay_fn``), Adagrad, DecayedAdagrad, RMSProp
  (and centered with momentum), Adadelta, Adamax, Ftrl and Dpsgd build
  the JAX package's program for a small MLP, desc for desc (ops, attrs,
  accumulator names, dtypes and their startup ``fill_constant``\\ s), and
  from the same numpy weights 5 steps through ``Executor.run`` give the
  JAX package's losses and persistables within 1e-5 (abs + rel, the
  tolerance ``tests/test_torch_training.py`` holds Adam to).  Dpsgd runs
  at ``sigma=0`` there (its noise comes from another generator); at
  ``sigma > 0`` its noise is held to its mean and standard deviation.
* Lamb trains BERT-tiny (dropout 0) with the BERT recipe's exclusions
  (LayerNorm parameters and biases) through ``Executor.run`` and
  ``prepare(donate_state=True)``: the program is the JAX package's, the
  losses and persistables after 5 steps within 1e-5.  A run of ``lamb``
  ops (``lamb_group``, ``torch._foreach_*``) gives each op's outputs bit
  for bit as the op alone gives them.
* ``fleet`` with ``strategy.lamb`` swaps the optimizer for
  ``LambOptimizer`` and emits the JAX package's program; lamb with DGC or
  ZeRO raises the JAX package's ``ValueError``.
* Adam #10's plain twin on bf16 and fp16 parameters (moments float32 or
  the parameter's dtype), with and without AdamW's decay, agrees with the
  JAX op on its Pallas route (the kernel in interpret mode, the decay in
  the parameter's dtype) to one rounding in each output's type.
* Pure bf16: BERT-tiny under ``decorate(Adam(1e-3), use_pure_bf16=True)``
  with its parameters cast to bf16 (``cast_parameters_to_bf16``), 3 steps
  in both packages: the losses within 2.6e-5 (relative; the bf16 losses'
  distance ``tests/test_torch_amp.py`` records).  The forward alone
  differs by ~1.8e-5 (bf16 products summed in other orders), and the
  update rounds each bf16 parameter once in the port, as the TPU kernel
  does, where the JAX package's CPU composition rounds three times
  (measured: 2.05e-5 at the worst step)."""

import functools
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib.mixed_precision import decorate as jdecorate
from paddle_tpu.contrib.mixed_precision.fp16_utils import \
    cast_parameters_to_bf16 as jcast_bf16
from paddle_tpu.distributed.fleet import (CollectiveOptimizer as JColl,
                                          DistributedStrategy as JStrategy)
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.ops.pallas import fused_ops as jpallas

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.contrib.mixed_precision import decorate as tdecorate
from paddle_tpu_torch.contrib.mixed_precision.fp16_utils import \
    cast_parameters_to_bf16 as tcast_bf16
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
from paddle_tpu_torch.ops.registry import LoweringContext

STEPS = 5
TOL = 1e-5
TOL_PURE_BF16 = 2.6e-5     # pure-bf16 BERT-tiny losses (relative)
PURE_BF16_STEPS = 3

PACKAGES = {"jax": (jfluid, jcore, jun, jbert),
            "port": (tfluid, tcore, tun, tbert)}


def _no_decay(param):
    """The BERT recipe's exclusions: LayerNorm parameters and biases."""
    return "layer_norm" in param.name or "_ln_" in param.name or \
        param.name.endswith("b_0") or "bias" in param.name


#: each optimizer and variant; DecayedAdagrad's first step moves a weight
#: by lr / sqrt(1 - decay) (4.5 lr), so it takes a fifth of Adagrad's LR
OPTIMIZERS = {
    "momentum": lambda f: f.optimizer.Momentum(0.1, 0.9),
    "momentum-nesterov": lambda f: f.optimizer.MomentumOptimizer(
        0.1, 0.9, use_nesterov=True),
    "lars-momentum": lambda f: f.optimizer.LarsMomentum(0.1, 0.9),
    "lamb": lambda f: f.optimizer.Lamb(0.01),
    "lamb-exclude": lambda f: f.optimizer.LambOptimizer(
        0.01, exclude_from_weight_decay_fn=_no_decay),
    "adagrad": lambda f: f.optimizer.Adagrad(0.1),
    "decayed-adagrad": lambda f: f.optimizer.DecayedAdagrad(0.02),
    "rmsprop": lambda f: f.optimizer.RMSProp(0.01),
    "rmsprop-centered-momentum": lambda f: f.optimizer.RMSPropOptimizer(
        0.01, momentum=0.9, centered=True),
    "adadelta": lambda f: f.optimizer.Adadelta(1.0),
    "adamax": lambda f: f.optimizer.Adamax(0.01),
    "ftrl": lambda f: f.optimizer.Ftrl(0.1, l1=0.01, l2=0.01),
    "ftrl-lr-power": lambda f: f.optimizer.FtrlOptimizer(0.1, lr_power=-0.6),
    "dpsgd-sigma-0": lambda f: f.optimizer.Dpsgd(0.1, sigma=0.0),
}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    assert sum(port_cuda.launch_counts().values()) == 0
    tcore.reset_default_programs()


def _desc(pkg, program):
    return json.dumps((jdesc if pkg == "jax" else tdesc)(program),
                      sort_keys=True)


def _mlp(pkg, make_opt):
    fluid, core, un, _ = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 11
    with core.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16])
        h = fluid.layers.fc(x, 16, act="tanh")
        loss = fluid.layers.mean(fluid.layers.fc(h, 3))
        make_opt(fluid).minimize(loss)
    return main, startup, loss


def _bert_cfg(bert):
    cfg = bert.BertConfig.tiny()          # hidden 128, 2 heads of 64
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _bert(pkg, make_opt):
    fluid, core, un, bert = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 7
    with core.program_guard(main, startup):
        loss = bert.build_pretrain_network(_bert_cfg(bert))[1]
        make_opt(fluid).minimize(loss)
    return main, startup, loss


def _jax_run(main, startup, loss, feeds, cast_bf16=False):
    """(startup state, per-step losses, final state) of the JAX run."""
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
                if scope.find_var(n) is not None}
        if cast_bf16:
            jcast_bf16(main, scope)
        losses = [float(np.asarray(exe.run(main, feed=f,
                                           fetch_list=[loss])[0]))
                  for f in feeds]
        final = {n: np.asarray(scope.find_var(n)) for n in init}
    return init, losses, final


def _port_scope(init, main):
    scope = tfluid.Scope()
    names = [v.name for v in main.list_vars() if v.persistable]
    assert set(names) <= set(init), "the programs declare other state"
    for n, t in tio.convert_params({n: init[n] for n in names},
                                   "cpu").items():
        scope.set_var(n, t)
    return scope, names


def _mlp_feeds():
    g = np.random.RandomState(5)
    return [{"x": g.randn(3, 16).astype("float32")} for _ in range(STEPS)]


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_the_program_is_the_jax_packages(opt):
    jmain, jstart, _ = _mlp("jax", OPTIMIZERS[opt])
    tmain, tstart, _ = _mlp("port", OPTIMIZERS[opt])
    assert _desc("port", tmain) == _desc("jax", jmain)
    assert _desc("port", tstart) == _desc("jax", jstart)


@pytest.mark.parametrize("opt", list(OPTIMIZERS))
def test_five_steps_match_the_jax_package(opt):
    feeds = _mlp_feeds()
    jmain, jstart, jloss = _mlp("jax", OPTIMIZERS[opt])
    init, jlosses, jfinal = _jax_run(jmain, jstart, jloss, feeds)
    main, _, loss = _mlp("port", OPTIMIZERS[opt])
    scope, names = _port_scope(init, main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                            scope=scope)[0]) for f in feeds]
    np.testing.assert_allclose(losses, jlosses, rtol=TOL, atol=TOL)
    for n in names:
        np.testing.assert_allclose(scope.find_var(n).numpy(), jfinal[n],
                                   rtol=TOL, atol=TOL, err_msg=n)
    assert not registry.route_counts("fallback")


def _lamb_recipe(fluid):
    return fluid.optimizer.Lamb(1e-3, lamb_weight_decay=0.01, epsilon=1e-6,
                                exclude_from_weight_decay_fn=_no_decay)


@pytest.fixture(scope="module")
def lamb_reference():
    rng = np.random.RandomState(0)
    feeds = [jbert.make_fake_batch(rng, _bert_cfg(jbert), batch_size=2,
                                   seq_len=128, num_masks=5)
             for _ in range(STEPS)]
    main, startup, loss = _bert("jax", _lamb_recipe)
    init, losses, final = _jax_run(main, startup, loss, feeds)
    return {"feeds": feeds, "init": init, "losses": losses, "final": final,
            "main": _desc("jax", main), "startup": _desc("jax", startup)}


@pytest.mark.parametrize("entry", ["run", "prepare"])
def test_lamb_trains_bert_tiny_like_the_jax_package(lamb_reference, entry):
    ref = lamb_reference
    main, startup, loss = _bert("port", _lamb_recipe)
    assert _desc("port", main) == ref["main"]
    assert _desc("port", startup) == ref["startup"]
    lamb_ops = [op for op in main.global_block().ops if op.type == "lamb"]
    decays = {op.inputs["Param"][0]: op.attrs["weight_decay"]
              for op in lamb_ops}
    assert len(lamb_ops) == 38 and 0 < sum(
        d == 0.0 for d in decays.values()) < len(decays)
    scope, names = _port_scope(ref["init"], main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    if entry == "run":
        losses = [float(exe.run(main, feed=f, fetch_list=[loss],
                                scope=scope)[0]) for f in ref["feeds"]]
    else:
        step = exe.prepare(main, fetch_list=[loss], scope=scope,
                           donate_state=True)
        losses = [float(step.run(f)[0]) for f in ref["feeds"]]
        tfluid.sync_prepared_state(scope)
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=TOL)
    for n in names:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   ref["final"][n], rtol=TOL, atol=TOL,
                                   err_msg=n)


def _lamb_items(seed, sizes=(1, 7, 768, 3000)):
    rng = np.random.RandomState(seed)
    t = lambda *s: torch.from_numpy(rng.randn(*s).astype(np.float32))  # noqa
    items = []
    for i, n in enumerate(sizes):
        ins = {"Param": [t(n)], "Grad": [t(n)], "Moment1": [t(n) * 0.1],
               "Moment2": [t(n).abs() * 0.01],
               "LearningRate": [torch.tensor([1e-3 * (i + 1)])],
               "Beta1Pow": [torch.tensor([0.9 ** (i + 1)])],
               "Beta2Pow": [torch.tensor([0.999 ** (i + 1)])]}
        if i == 1:
            ins["Param"] = [torch.zeros(n)]       # ratio 1: |p| = 0
        attrs = {"beta1": 0.9, "beta2": 0.999 - 0.001 * i,
                 "epsilon": 1e-6, "weight_decay": 0.01 * (i % 2)}
        items.append(("lamb", ins, attrs))
    return items


def _clone_items(items):
    return [(t, {k: [v.clone() for v in vs] for k, vs in ins.items()},
             dict(attrs)) for t, ins, attrs in items]


@pytest.mark.parametrize("donate", [False, True])
def test_a_run_of_lamb_ops_gives_each_ops_bits(donate):
    items = _lamb_items(3)
    alone = [optimizer_ops._lamb(LoweringContext(donate_state=donate),
                                 ins, attrs)
             for _, ins, attrs in _clone_items(items)]
    run_items = _clone_items(items)
    run = optimizer_ops.lamb_group(LoweringContext(donate_state=donate),
                                   run_items)
    for a, b, (_, ins, _) in zip(alone, run, run_items):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
        if donate:                        # updated in place
            assert b["ParamOut"] is ins["Param"][0]
            assert b["Beta1PowOut"] is ins["Beta1Pow"][0]
    # the JAX op, op by op
    from paddle_tpu.ops.registry import LoweringContext as JContext
    from paddle_tpu.ops.registry import get_op as jget_op
    for (_, ins, attrs), got in zip(items, run):
        want = jget_op("lamb")(JContext(None), {
            k: [jnp.asarray(v.numpy()) for v in vs]
            for k, vs in ins.items()}, attrs)
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=TOL, atol=1e-7, err_msg=k)


def test_dpsgd_noise_has_its_mean_and_deviation():
    """A zero gradient leaves only the noise: p - p_out = lr * noise with
    noise ~ N(0, (sigma * clip / batch_size)^2), drawn from the run's
    generator (same seed, same draw)."""
    n, sigma, clip, batch = 200_000, 1.5, 2.0, 8.0
    attrs = {"clip": clip, "batch_size": batch, "sigma": sigma}

    def draw(seed):
        ins = {"Param": [torch.zeros(n)], "Grad": [torch.zeros(n)],
               "LearningRate": [torch.tensor([0.5])]}
        ctx = LoweringContext(torch.Generator().manual_seed(seed))
        out = registry.get_op("dpsgd")(ctx, ins, attrs)["ParamOut"]
        return -out.double().numpy() / 0.5
    noise = draw(1)
    std = sigma * clip / batch
    assert abs(noise.mean()) < 5 * std / np.sqrt(n)
    assert abs(noise.std() / std - 1) < 5 / np.sqrt(2 * n)
    np.testing.assert_array_equal(noise, draw(1))
    assert not np.array_equal(noise, draw(2))


def _fleet_program(pkg, strategy_flags, inner):
    main, startup, _ = None, None, None
    fluid, core, un, _ = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 11
    with core.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[16])
        loss = fluid.layers.mean(fluid.layers.fc(
            fluid.layers.fc(x, 16, act="tanh"), 3))
        if pkg == "jax":
            s = JStrategy()
            for k, v in strategy_flags.items():
                setattr(s, k, v)
            JColl(inner(fluid), s)._compose(inner(fluid)).minimize(loss)
        else:
            tfleet.init(UserDefinedRoleMaker(0, 1, place=fluid.CPUPlace()))
            s = DistributedStrategy()
            for k, v in strategy_flags.items():
                setattr(s, k, v)
            tfleet.distributed_optimizer(inner(fluid), s).minimize(loss)
            assert tfleet.main_program is main
    return main, startup


@pytest.mark.parametrize("inner", ["sgd", "adam", "lamb"])
def test_fleet_strategy_lamb_emits_the_jax_program(inner):
    make = {"sgd": lambda f: f.optimizer.SGD(0.1),
            "adam": lambda f: f.optimizer.Adam(
                0.01, grad_clip=f.clip.GradientClipByGlobalNorm(1.0)),
            "lamb": lambda f: f.optimizer.Lamb(
                0.02, exclude_from_weight_decay_fn=_no_decay)}[inner]
    flags = {"lamb": True, "lamb_configs": {"lamb_weight_decay": 0.05}}
    jmain, jstart = _fleet_program("jax", flags, make)
    tmain, tstart = _fleet_program("port", flags, make)
    assert _desc("port", tmain) == _desc("jax", jmain)
    assert _desc("port", tstart) == _desc("jax", jstart)
    types = {op.type for op in tmain.global_block().ops}
    assert "lamb" in types and not types & {"sgd", "adam"}


@pytest.mark.parametrize("other", ["use_dgc", "sharding", "sharded_update"])
def test_lamb_conflicts_raise_as_in_the_jax_package(other):
    s = JStrategy()
    s.lamb = True
    setattr(s, other, True)
    with pytest.raises(ValueError, match="lamb") as jerr:
        JColl._validate(s)
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        t = DistributedStrategy()
        t.lamb = True
        setattr(t, other, True)
        with pytest.raises(ValueError) as terr:
            tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1),
                                         t).minimize(loss)
    assert str(terr.value) == str(jerr.value)


def _ulps(a: np.ndarray, dtype) -> np.ndarray:
    """One unit in the last place of each of ``a``'s values in ``dtype``."""
    mant = {"float32": 23, "bfloat16": 7, "float16": 10}[dtype]
    exp = np.floor(np.log2(np.maximum(np.abs(a), 2.0 ** -14)))
    return 2.0 ** (exp - mant)


@pytest.mark.parametrize("coeff", [0.0, 0.5])
@pytest.mark.parametrize("p_dtype,moment_dtype", [
    ("bfloat16", "float32"), ("bfloat16", "bfloat16"),
    ("float16", "float32"), ("float16", "float16")])
def test_adam_twin_on_16_bit_parameters_matches_the_pallas_kernel(
        p_dtype, moment_dtype, coeff, monkeypatch):
    """#10's twin against the JAX ``adam`` / ``adamw`` op on its Pallas
    route (``adam_update(..., interpret=True)``, then AdamW's decay in p's
    dtype) on the same 16-bit inputs: every p, m, v within one rounding in
    its own type at the magnitude of the terms it sums (the two compute in
    float32, and XLA may fuse a multiply-add where the twin rounds the
    product).  With ``coeff`` the decay moves most parameters by more than
    their rounding, and the JAX op's decay applied to the twin's own Adam
    update gives the twin's p bit for bit."""
    rng = np.random.RandomState(12)
    n = 5120                     # the Pallas kernel's rows of 128
    tp, tm = getattr(torch, p_dtype), getattr(torch, moment_dtype)
    p = torch.from_numpy(rng.randn(n).astype(np.float32)).to(tp)
    g = torch.from_numpy(rng.randn(n).astype(np.float32)).to(tm)
    m = torch.from_numpy(rng.randn(n).astype(np.float32) * 0.1).to(tm)
    v = torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32)
                         * 0.01).to(tm)
    lr = torch.tensor([0.01])
    b1p, b2p = torch.tensor([0.9 ** 3]), torch.tensor([0.999 ** 3])
    lr_t = float(lr * torch.sqrt(1 - b2p) / (1 - b1p))

    def jx(t):
        return jnp.asarray(t.float().numpy()).astype(
            getattr(jnp, str(t.dtype).replace("torch.", "")))
    # the JAX op on the Pallas route, which it takes on the TPU only
    monkeypatch.setattr(jregistry, "pallas_route",
                        lambda *a, **k: (object(), None))
    monkeypatch.setattr(jpallas, "adam_update", functools.partial(
        jpallas.adam_update, interpret=True))
    op = "adamw" if coeff else "adam"
    ins = {"Param": [jx(p)], "Grad": [jx(g)], "Moment1": [jx(m)],
           "Moment2": [jx(v)], "LearningRate": [jnp.asarray(lr.numpy())],
           "Beta1Pow": [jnp.asarray(b1p.numpy())],
           "Beta2Pow": [jnp.asarray(b2p.numpy())]}
    out = jregistry.get_op(op)(None, ins, {"beta1": 0.9, "beta2": 0.999,
                                           "epsilon": 1e-8, "coeff": coeff})
    ref = [out[k] for k in ("ParamOut", "Moment1Out", "Moment2Out")]
    f64 = [t.double().numpy() for t in (p, g, m, v)]
    p0, g0, m0, v0 = f64
    m1 = 0.9 * m0 + 0.1 * g0
    v1 = 0.999 * v0 + 0.001 * g0 * g0
    terms = {"p": np.maximum.reduce([
                 np.abs(p0), np.abs(lr_t * m1 / (np.sqrt(v1) + 1e-8)),
                 np.abs(0.01 * coeff * p0)]),
             "m": np.maximum(np.abs(0.9 * m0), np.abs(0.1 * g0)),
             "v": np.maximum(np.abs(0.999 * v0), np.abs(0.001 * g0 * g0))}
    plain = topt.adam(p.clone(), g, m.clone(), v.clone(), lr, b1p.clone(),
                      b2p.clone())
    got = topt.adam(p, g, m, v, lr, b1p, b2p, coeff=coeff)
    for name, a, r in zip("pmv", got, ref):
        want_dtype = str(r.dtype)
        assert str(a.dtype).replace("torch.", "") == want_dtype, name
        r64 = np.asarray(r.astype(jnp.float32)).astype(np.float64)
        a64 = a.float().numpy().astype(np.float64)
        tol = _ulps(np.maximum(np.abs(r64), terms[name]), want_dtype)
        assert (np.abs(a64 - r64) <= tol).all(), name
    if coeff:
        assert (got[0] != plain[0]).float().mean() > 0.5
        # the decay alone, bit for bit: the JAX op applies its decay to the
        # twin's own Adam update
        monkeypatch.setattr(jpallas, "adam_update",
                            lambda *a, **k: tuple(jx(t) for t in plain))
        out = jregistry.get_op(op)(None, ins, {"coeff": coeff})
        assert np.array_equal(np.asarray(out["ParamOut"].astype(jnp.float32)),
                              got[0].float().numpy())


def test_adam_gate_takes_16_bit_parameters():
    z, one = torch.zeros(4), torch.zeros(1)
    bf, hf = z.bfloat16(), z.half()
    for p, m, v in ((bf, z, z), (bf, bf, bf), (bf, z, bf), (hf, z, z),
                    (hf, hf, z), (z, z, z)):
        g = torch.zeros(4, dtype=m.dtype)
        assert topt.adam_supported(p, g, m, v, one, one) == (True, "")
    # a moment in the other 16-bit type, a gradient not of m's dtype
    assert topt.adam_supported(bf, hf, hf, z)[1] == "dtype:torch.float16"
    assert topt.adam_supported(bf, bf, z, z)[1] == "dtype:torch.bfloat16"
    # the op's route passes no gradient: it casts it to m's dtype first
    assert topt.adam_supported(bf, None, z, z) == (True, "")
    assert topt.adam_supported(z.double(), z, z, z)[1] == \
        "dtype:torch.float64"
    # the op's route gates on the gradient it casts: a bf16 gradient of a
    # bf16 parameter beside float32 moments takes the kernel
    meta = lambda dt: torch.empty(768, device="meta", dtype=dt)  # noqa
    ins = {"Param": [meta(torch.bfloat16)], "Grad": [meta(torch.bfloat16)],
           "Moment1": [meta(torch.float32)],
           "Moment2": [meta(torch.float32)],
           "LearningRate": [torch.empty(1, device="meta")],
           "Beta1Pow": [torch.empty(1, device="meta")],
           "Beta2Pow": [torch.empty(1, device="meta")]}
    route, _ = registry.cuda_route("adam", ins, {})
    assert route is not None and route.kernel == "fused_adam"


def test_a_mixed_run_of_adam_ops_splits_by_dtype_on_the_cpu_twin():
    """The twin takes a run mixing float32 and 16-bit entries and gives
    each entry what it gives alone (the kernel launches once per dtype
    combination)."""
    rng = np.random.RandomState(4)

    def entry(pdt, mdt, n):
        t = lambda s=1.0: torch.from_numpy(  # noqa: E731
            rng.randn(n).astype(np.float32) * s)
        return topt.AdamTensor(t().to(pdt), t().to(mdt), (t(0.1)).to(mdt),
                               t(0.01).abs().to(mdt), torch.tensor([1e-3]),
                               torch.tensor([0.81]), torch.tensor([0.998]),
                               0.9, 0.999, 1e-8, 0.01)
    run = [entry(torch.float32, torch.float32, 33),
           entry(torch.bfloat16, torch.float32, 40),
           entry(torch.float16, torch.float16, 7),
           entry(torch.bfloat16, torch.float32, 9)]
    alone = [topt.AdamTensor(*[t.clone() if torch.is_tensor(t) else t
                               for t in e]) for e in run]
    topt.adam_multi(run)
    for e in alone:
        topt.adam_multi([e])
    for a, b in zip(run, alone):
        for i in range(7):
            assert torch.equal(a[i], b[i])
    assert [str(k) for k, _ in topt._by_dtypes(run)] == [
        str((torch.float32,) * 3),
        str((torch.bfloat16, torch.float32, torch.float32)),
        str((torch.float16,) * 3)]


def _pure_bf16_adam(fluid):
    return fluid.optimizer.Adam(1e-3)


def test_pure_bf16_bert_tiny_adam_steps_match_the_jax_package():
    rng = np.random.RandomState(0)
    feeds = [jbert.make_fake_batch(rng, _bert_cfg(jbert), batch_size=2,
                                   seq_len=128, num_masks=5)
             for _ in range(PURE_BF16_STEPS)]

    def build(pkg):
        fluid, core, un, bert = PACKAGES[pkg]
        decorate = jdecorate if pkg == "jax" else tdecorate
        return _bert(pkg, lambda f: decorate(_pure_bf16_adam(f),
                                             use_pure_bf16=True))
    jmain, jstart, jloss = build("jax")
    init, jlosses, _ = _jax_run(jmain, jstart, jloss, feeds,
                                cast_bf16=True)
    main, _, loss = build("port")
    scope, _ = _port_scope(init, main)
    tcast_bf16(main, scope)
    exe = tfluid.Executor(tfluid.CPUPlace())
    step = exe.prepare(main, fetch_list=[loss], scope=scope,
                       donate_state=True)
    losses = [float(step.run(f)[0]) for f in feeds]
    tfluid.sync_prepared_state(scope)
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, jlosses)]
    assert max(rel) <= TOL_PURE_BF16, rel
    params = main.all_parameters()
    assert {scope.find_var(p.name).dtype for p in params} == \
        {torch.bfloat16}
    # the moments stay float32; every Adam op took the kernel's route
    assert {scope.find_var(n).dtype for n in scope.var_names()
            if "moment" in n} == {torch.float32}
    hits = registry.route_counts("hit")
    assert hits[("adam", "fused_adam", "hit", "supported")] == \
        len(params) * PURE_BF16_STEPS
    assert not registry.route_counts("fallback")
