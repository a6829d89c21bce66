"""Mixed-precision training in the PyTorch port against the JAX package:
``contrib.mixed_precision.decorate`` (bf16, and fp16 with dynamic loss
scaling), the loss-scaling ops, the backward's ``loss_scale_var`` and
fleet's ``strategy.amp``, on the CPU.

* The rewritten programs are the JAX package's, desc for desc (op types,
  cast names, inputs, outputs and ``out_dtype``, every var's dtype, the
  backward's ``loss_scale_var``, the scale-state vars and their startup
  ``fill_constant``s), for ``tests/test_amp.py``'s MLP and BERT-tiny, bf16
  and fp16, with the default lists and a custom white/black list; and
  fleet with ``strategy.amp`` writes what ``decorate`` writes.
* ``check_finite_and_unscale`` and ``update_loss_scaling`` match the JAX
  ops bit for bit (finite gradients, one inf, one nan), and a 20-step
  pattern of overflow verdicts drives both scale policies alike.
* BERT-tiny in bf16, dropout 0, 3 Adam steps through ``Executor.run`` and
  ``prepare(donate_state=True)``: the first loss within 5e-3 of the JAX
  package's (relative), every loss within 1e-2, the step-1 float32
  parameter gradients within 3e-2 as a relative L2 norm.  A bf16 product
  of torch and of XLA on the CPU may differ by one bf16 ulp in a few
  elements (their float32 sums run in different orders); those
  tolerances leave room for that over a 2-layer model.  Measured on the
  CPU: losses within 2.6e-5, gradients within 3.8e-3 (worst parameter).
* BERT-tiny in fp16 with dynamic loss scaling, 3 Adam steps: every loss
  within 1e-2 of the JAX package's, the flash route taken in float16.
* The MLP in fp16, 5 steps: losses within 1e-2, the scale state equal;
  with an ``inf`` fed at steps 4 and 5 the port zeroes those steps'
  gradients, backs the scale off once and regrows it as a host replay of
  the policy says.
* The ops the bf16 program meets, each on the same bf16 inputs as the
  JAX op: ``cast``, ``scale`` and ``unsqueeze2`` bit for bit, ``mul`` and
  ``matmul`` to one bf16 ulp of the output's magnitude on fewer than
  0.1 % of the elements, ``fused_attention`` to two bf16 ulps."""

import json

import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.contrib.mixed_precision import (
    AutoMixedPrecisionLists as JLists, decorate as jdecorate)
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import guardrails as jguard
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.registry import LoweringContext as JContext
from paddle_tpu.ops.registry import get_op as jget_op

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.contrib.mixed_precision import (
    AutoMixedPrecisionLists as TLists, decorate as tdecorate)
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                UserDefinedRoleMaker)
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import guardrails as tguard
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.serialization import (
    program_to_desc as tdesc)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry

TOL_FIRST_LOSS = 5e-3      # bf16 BERT-tiny, step 1 (relative)
TOL_LOSS = 1e-2            # bf16 BERT-tiny and fp16 MLP, every step
TOL_GRAD_L2 = 3e-2         # step-1 parameter gradients (relative L2)
BF16_ULP = 2.0 ** -7       # one bf16 ulp, relative to the magnitude
MAX_ULP_SHARE = 1e-3       # share of product elements allowed one ulp off
BERT_STEPS = 3
MLP_STEPS = 5
SCALE_STATE = ("loss_scaling", "good_steps", "bad_steps")

PACKAGES = {
    "jax": (jfluid, jcore, jun, jbert, jdecorate, JLists),
    "port": (tfluid, tcore, tun, tbert, tdecorate, TLists),
}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    tcore.reset_default_programs()


# ---------------------------------------------------------------------------
# program builders, the same for both packages
# ---------------------------------------------------------------------------


def _mlp(fluid):
    """tests/test_amp.py's two-layer MLP; returns the loss."""
    x = fluid.layers.data("x", shape=[16])
    label = fluid.layers.data("label", shape=[1], dtype="int64")
    h = fluid.layers.fc(x, 32, act="relu",
                        param_attr=fluid.ParamAttr(
                            name="w1",
                            initializer=fluid.initializer.Constant(0.02)),
                        bias_attr=False)
    logits = fluid.layers.fc(h, 4,
                             param_attr=fluid.ParamAttr(
                                 name="w2",
                                 initializer=fluid.initializer.Constant(0.02)),
                             bias_attr=False)
    return fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))


def _bert_cfg(bert):
    cfg = bert.BertConfig.tiny()          # hidden 128, 2 heads of 64
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _bert(fluid, bert):
    return bert.build_pretrain_network(_bert_cfg(bert))[1]


def _lists(pkg, custom):
    if not custom:
        return None
    # layer_norm moves to the white list, attention and relu to the black
    return PACKAGES[pkg][5](custom_white_list=["layer_norm", "tanh"],
                            custom_black_list=["fused_attention", "relu"])


def _build(pkg, model, dtype, custom=False, optimizer=None, **amp):
    """(main, startup, loss) of ``model`` under ``decorate``."""
    fluid, core, un, bert, decorate, _ = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 7
    with core.program_guard(main, startup):
        loss = _mlp(fluid) if model == "mlp" else _bert(fluid, bert)
        opt = optimizer(fluid) if optimizer else fluid.optimizer.SGD(0.1)
        decorate(opt, amp_lists=_lists(pkg, custom),
                 use_pure_bf16=dtype == "bf16", **amp).minimize(loss)
    return main, startup, loss


def _desc(pkg, program):
    return json.dumps((jdesc if pkg == "jax" else tdesc)(program),
                      sort_keys=True)


# ---------------------------------------------------------------------------
# the rewritten program
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("custom", [False, True], ids=["default", "custom"])
@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
@pytest.mark.parametrize("model", ["mlp", "bert-tiny"])
def test_the_rewritten_program_is_the_jax_packages(model, dtype, custom):
    jmain, jstart, _ = _build("jax", model, dtype, custom)
    tmain, tstart, _ = _build("port", model, dtype, custom)
    jops, tops = jmain.global_block().ops, tmain.global_block().ops
    assert [op.type for op in tops] == [op.type for op in jops]
    for jop, top in zip(jops, tops):
        if top.type == "cast":
            assert (top.inputs, top.outputs, top.attrs["out_dtype"]) == \
                (jop.inputs, jop.outputs, jop.attrs["out_dtype"])
    assert {n: v.dtype for n, v in tmain.global_block().vars.items()} == \
        {n: v.dtype for n, v in jmain.global_block().vars.items()}
    jbw = next(op for op in jops if op.type == "backward")
    tbw = next(op for op in tops if op.type == "backward")
    assert tbw.attrs.get("loss_scale_var") == jbw.attrs.get("loss_scale_var")
    state = sorted(n for n in tmain.global_block().vars
                   if n.startswith(SCALE_STATE))
    if dtype == "bf16":
        assert not state and "loss_scale_var" not in tbw.attrs
    else:
        assert state == ["bad_steps_0", "good_steps_0", "loss_scaling_0"]
        assert tbw.attrs["loss_scale_var"] == "loss_scaling_0"
        fills = {op.outputs["Out"][0]: (op.attrs["dtype"], op.attrs["value"])
                 for op in tstart.global_block().ops
                 if op.type == "fill_constant"}
        assert [fills[n] for n in state] == [
            ("int32", 0), ("int32", 0), ("float32", 2.0 ** 15)]
        assert all(tmain.global_block().vars[n].persistable for n in state)
    # everything else too: the descs serialize alike
    assert _desc("port", tmain) == _desc("jax", jmain)
    assert _desc("port", tstart) == _desc("jax", jstart)


def test_bert_base_program_has_the_expected_casts():
    """BERT-base pretraining under ``decorate(Adam(1e-4))``: 573 ops, 181
    casts (129 to bf16, 52 back; 52 of a parameter), the attention's Q, K,
    V and bias in bf16, layer_norm in float32, master weights float32."""
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        total = tbert.build_pretrain_network(tbert.BertConfig.base())[1]
        tdecorate(tfluid.optimizer.Adam(1e-4)).minimize(total)
    block = main.global_block()
    ops = block.ops
    casts = [op for op in ops if op.type == "cast"]
    assert len(ops) == 573 and len(casts) == 181
    assert sum(op.attrs["out_dtype"] == "bfloat16" for op in casts) == 129
    assert sum(block.var(op.inputs["X"][0]).persistable
               for op in casts) == 52
    for op in ops:
        if op.type == "fused_attention":
            assert {block.var(n).dtype for n in op.input_names()} == \
                {"bfloat16"}
        if op.type == "layer_norm":
            assert {block.var(n).dtype for n in op.input_names()} == \
                {"float32"}
    assert {p.dtype for p in main.all_parameters()} == {"float32"}


@pytest.mark.parametrize("dtype", ["bf16", "fp16"])
def test_fleet_strategy_amp_writes_what_decorate_writes(dtype):
    direct, dstart, _ = _build("port", "mlp", dtype)
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    startup.random_seed = 7
    with tcore.program_guard(main, startup):
        loss = _mlp(tfluid)
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        s = DistributedStrategy()
        s.amp = True
        s.amp_configs = dict(s.amp_configs, use_pure_bf16=dtype == "bf16")
        tfleet.distributed_optimizer(tfluid.optimizer.SGD(0.1),
                                     s).minimize(loss)
    assert tfleet.main_program is main
    assert _desc("port", main) == _desc("port", direct)
    assert _desc("port", startup) == _desc("port", dstart)


@pytest.mark.parametrize("fused", [False, True])
def test_grad_sync_goes_ahead_of_the_unscale_op(fused):
    """Two ranks' gradient sync on an fp16 program lands right after the
    backward op, ahead of ``check_finite_and_unscale``, so every rank
    reads the same overflow verdict; the desc is the JAX package's."""
    from paddle_tpu.framework import compiler as jcompiler
    from paddle_tpu_torch.framework import compiler as tcompiler
    progs = {}
    for pkg, mod in (("jax", jcompiler), ("port", tcompiler)):
        main, _, _ = _build(pkg, "mlp", "fp16")
        bs = mod.BuildStrategy()
        bs.fuse_all_reduce_ops = fused
        mod.insert_grad_sync(main, bs, 2, ("dp",), axis_sizes={"dp": 2})
        progs[pkg] = main
    assert _desc("port", progs["port"]) == _desc("jax", progs["jax"])
    types = [op.type for op in progs["port"].global_block().ops]
    bw = types.index("backward")
    synced = types[bw + 1:types.index("check_finite_and_unscale")]
    assert synced == (["c_fused_allreduce_sum"] if fused else
                      ["scale", "c_allreduce_sum"] * 2)


# ---------------------------------------------------------------------------
# the loss-scaling ops, bit for bit
# ---------------------------------------------------------------------------


def _grads(case):
    rng = np.random.RandomState(3)
    gs = [rng.randn(3, 4).astype(np.float32) * 1e3,
          rng.randn(5).astype(np.float32),
          rng.randn(2, 2, 2).astype(np.float32) * 1e-3]
    if case != "finite":
        gs[1][2] = np.inf if case == "inf" else np.nan
    return gs


def _bits(a):
    return np.asarray(a, dtype=np.float32).view(np.uint32)


def _both(op, ins, attrs):
    """``op`` through the JAX package and the port on the same inputs."""
    ref = jget_op(op)(None, {k: [jax.numpy.asarray(v) for v in vs]
                             for k, vs in ins.items()}, dict(attrs))
    got = registry.get_op(op)(registry.LoweringContext(), {
        k: [torch.from_numpy(np.asarray(v)) for v in vs]
        for k, vs in ins.items()}, dict(attrs))
    return ref, got


@pytest.mark.parametrize("scale", [1024.0, 3000.0])
@pytest.mark.parametrize("case", ["finite", "inf", "nan"])
def test_check_finite_and_unscale_matches_bit_for_bit(case, scale):
    ins = {"X": _grads(case), "Scale": [np.array([scale], np.float32)]}
    for op in ("check_finite_and_unscale", "amp_check_finite_and_scale"):
        ref, got = _both(op, ins, {})
        assert bool(got["FoundInfinite"]) == bool(ref["FoundInfinite"]) \
            == (case != "finite")
        assert got["FoundInfinite"].dtype == torch.bool
        for g, r in zip(got["Out"], ref["Out"]):
            assert g.dtype == torch.float32 and tuple(g.shape) == r.shape
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))
        if case != "finite":
            assert not any(g.any() for g in got["Out"])


@pytest.mark.parametrize("attrs", [
    {}, {"incr_every_n_steps": 1, "decr_every_n_nan_or_inf": 1,
         "incr_ratio": 3.0, "decr_ratio": 0.8}], ids=["defaults", "decorator"])
@pytest.mark.parametrize("case", ["finite", "inf", "nan"])
def test_update_loss_scaling_matches_bit_for_bit(case, attrs):
    gs = _grads(case)
    found = np.array(case != "finite")
    for scale, good, bad in ((2.0 ** 15, 999, 0), (3.0, 0, 1), (1.1, 5, 1)):
        ins = {"X": gs, "FoundInfinite": [found],
               "PrevLossScaling": [np.array([scale], np.float32)],
               "InGoodSteps": [np.array([good], np.int32)],
               "InBadSteps": [np.array([bad], np.int32)]}
        ref, got = _both("update_loss_scaling", ins, attrs)
        np.testing.assert_array_equal(_bits(got["LossScaling"].numpy()),
                                      _bits(ref["LossScaling"]))
        for slot in ("OutGoodSteps", "OutBadSteps"):
            assert got[slot].dtype == torch.int32
            np.testing.assert_array_equal(got[slot].numpy(),
                                          np.asarray(ref[slot]))
        for g, r in zip(got["Out"], ref["Out"]):
            np.testing.assert_array_equal(_bits(g.numpy()), _bits(r))


FLAGS_20 = [0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 1, 0, 0, 0, 1, 0, 0]


@pytest.mark.parametrize("max_scale", [None, 40.0])
def test_scale_policy_follows_the_jax_policy_step_by_step(max_scale):
    kw = dict(incr_every_n_steps=3, decr_every_n_nan_or_inf=2,
              incr_ratio=2.0, decr_ratio=0.8, max_scale=max_scale)
    js, jg, jb = (jax.numpy.asarray(np.array([5.0], np.float32)),
                  jax.numpy.asarray(np.array([0], np.int32)),
                  jax.numpy.asarray(np.array([0], np.int32)))
    ts, tg, tb = (torch.tensor([5.0]), torch.tensor([0], dtype=torch.int32),
                  torch.tensor([0], dtype=torch.int32))
    scales = set()
    for flag in FLAGS_20:
        js, jg, jb = jguard.scale_policy_update(
            jax.numpy.asarray(bool(flag)), js, jg, jb, **kw)
        ts, tg, tb = tguard.scale_policy_update(
            torch.tensor(bool(flag)), ts, tg, tb, **kw)
        np.testing.assert_array_equal(_bits(ts.numpy()), _bits(js))
        np.testing.assert_array_equal(tg.numpy(), np.asarray(jg))
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
        assert tg.dtype == tb.dtype == torch.int32
        scales.add(float(ts[0]))
    assert len(scales) > 3                  # it grew and backed off


# ---------------------------------------------------------------------------
# training against the JAX package
# ---------------------------------------------------------------------------


def _jax_train(main, startup, loss, feeds, fetch_first=()):
    """Run the JAX package's program: (startup state, per-step fetches)."""
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
                if scope.find_var(n) is not None}
        outs = [[np.asarray(v) for v in exe.run(
            main, feed=f, fetch_list=[loss] + list(
                fetch_first if i == 0 else ()))]
                for i, f in enumerate(feeds)]
    return init, outs


def _port_scope(init, main):
    scope = tfluid.Scope()
    names = [v.name for v in main.list_vars() if v.persistable]
    assert set(names) <= set(init), "the programs declare other state"
    for n, t in tio.convert_params({n: init[n] for n in names},
                                   "cpu").items():
        scope.set_var(n, t)
    return scope


def _adam(fluid):
    return fluid.optimizer.Adam(1e-3)


def _bert_reference(dtype):
    rng = np.random.RandomState(0)
    feeds = [jbert.make_fake_batch(rng, _bert_cfg(jbert), batch_size=2,
                                   seq_len=128, num_masks=5)
             for _ in range(BERT_STEPS)]
    main, startup, loss = _build("jax", "bert-tiny", dtype, optimizer=_adam)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    init, outs = _jax_train(main, startup, loss, feeds, grads)
    return {"feeds": feeds, "init": init, "grads": grads,
            "losses": [float(o[0]) for o in outs], "grad_values": outs[0][1:]}


@pytest.fixture(scope="module")
def bert_reference():
    return _bert_reference("bf16")


def _check_losses(losses, ref):
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref)]
    assert rel[0] <= TOL_FIRST_LOSS and max(rel) <= TOL_LOSS, rel


@pytest.mark.parametrize("entry", ["run", "prepare"])
def test_bf16_bert_tiny_trains_like_the_jax_package(bert_reference, entry):
    ref = bert_reference
    main, _, loss = _build("port", "bert-tiny", "bf16", optimizer=_adam)
    scope = _port_scope(ref["init"], main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    if entry == "run":
        outs = [exe.run(main, feed=f, fetch_list=[loss] + (
            ref["grads"] if i == 0 else []), scope=scope)
            for i, f in enumerate(ref["feeds"])]
        num = den = 0.0
        for g, r in zip(outs[0][1:], ref["grad_values"]):
            assert g.dtype == np.float32
            num += float(((g.astype(np.float64) - r) ** 2).sum())
            den += float((r.astype(np.float64) ** 2).sum())
        assert np.sqrt(num / den) <= TOL_GRAD_L2
    else:
        step = exe.prepare(main, fetch_list=[loss], scope=scope,
                           donate_state=True)
        outs = [step.run(f, return_numpy=True) for f in ref["feeds"]]
        tfluid.sync_prepared_state(scope)
    _check_losses([float(o[0]) for o in outs], ref["losses"])
    # master weights stay float32; the attention ran on the flash route
    # (its plain twin on the CPU) in bf16, nothing fell back
    assert {scope.find_var(p.name).dtype
            for p in main.all_parameters()} == {torch.float32}
    hits = registry.route_counts("hit")
    assert hits[("fused_attention", "flash_attention", "hit",
                 "supported")] == 2 * BERT_STEPS
    assert not registry.route_counts("fallback")


def test_fp16_bert_tiny_trains_like_the_jax_package():
    """BERT-tiny under fp16 ``decorate`` with dynamic loss scaling, 3 Adam
    steps through ``Executor.run``: every loss within TOL_LOSS of the JAX
    package's, the scale state that of three steps without overflow, the
    attention on the flash route in float16 (its plain twin on the CPU),
    the master weights float32."""
    ref = _bert_reference("fp16")
    main, _, loss = _build("port", "bert-tiny", "fp16", optimizer=_adam)
    scope = _port_scope(ref["init"], main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    state = ["loss_scaling_0", "good_steps_0", "bad_steps_0"]
    outs = [exe.run(main, feed=f, fetch_list=[loss] + state, scope=scope)
            for f in ref["feeds"]]
    losses = [float(o[0]) for o in outs]
    assert all(np.isfinite(losses)), losses
    rel = [abs(a - b) / abs(b) for a, b in zip(losses, ref["losses"])]
    print(f"fp16 BERT-tiny losses {losses}, JAX {ref['losses']}: relative "
          f"{rel} (TOL_LOSS {TOL_LOSS})")
    assert max(rel) <= TOL_LOSS, rel
    assert [int(o[2][0]) for o in outs] == list(range(1, BERT_STEPS + 1))
    assert {float(o[1][0]) for o in outs} == {2.0 ** 15}
    assert {scope.find_var(p.name).dtype
            for p in main.all_parameters()} == {torch.float32}
    hits = registry.route_counts("hit")
    assert hits[("fused_attention", "flash_attention", "hit",
                 "supported")] == 2 * BERT_STEPS
    assert not registry.route_counts("fallback")


def _mlp_feeds(steps, inf_steps=()):
    rng = np.random.RandomState(0)
    xs = rng.randn(16, 16).astype(np.float32)
    ys = rng.randint(0, 4, (16, 1)).astype(np.int64)
    feeds = []
    for i in range(steps):
        x = xs.copy()
        if i + 1 in inf_steps:
            x[3, 5] = np.inf
        feeds.append({"x": x, "label": ys})
    return feeds


def test_fp16_mlp_trains_like_the_jax_package():
    feeds = _mlp_feeds(MLP_STEPS)
    state = ["loss_scaling_0", "good_steps_0", "bad_steps_0"]
    jmain, jstart, jloss = _build("jax", "mlp", "fp16")
    tmain, tstart, tloss = _build("port", "mlp", "fp16")
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        for f in feeds:
            got = exe.run(tmain, feed=f, fetch_list=[tloss] + state,
                          scope=scope)
            ref = jexe.run(jmain, feed=f, fetch_list=[jloss] + state)
            assert abs(float(got[0]) - float(ref[0])) <= \
                TOL_LOSS * abs(float(ref[0]))
            for g, r in zip(got[1:], ref[1:]):
                assert g.dtype == np.asarray(r).dtype
                np.testing.assert_array_equal(g, np.asarray(r))


def _replay(flags, scale, incr_every, decr_every):
    """The scale policy on the host, one step at a time."""
    good = bad = 0
    out = []
    for bad_step in flags:
        good, bad = (0, bad + 1) if bad_step else (good + 1, 0)
        if good >= incr_every:
            scale, good = scale * 2.0, 0
        elif bad >= decr_every:
            scale, bad = max(scale * np.float32(0.8), 1.0), 0
        out.append((np.float32(scale), good, bad))
    return out


@pytest.mark.parametrize("entry", ["run", "prepare"])
def test_fp16_overflow_zeroes_the_step_and_backs_the_scale_off(entry):
    """Steps 4 and 5 carry an inf: their gradients are zeroed (the SGD
    update leaves the weights as they were), the scale backs off once by
    0.8 after step 5 and grows by 2 after each 3 good steps; scale and
    counters equal a host replay at every step, in both packages."""
    steps, bad_steps = 9, (4, 5)
    feeds = _mlp_feeds(steps, bad_steps)
    amp = dict(incr_every_n_steps=3, decr_every_n_nan_or_inf=2)
    tmain, tstart, tloss = _build("port", "mlp", "fp16", **amp)
    jmain, jstart, jloss = _build("jax", "mlp", "fp16", **amp)
    state = ["loss_scaling_0", "good_steps_0", "bad_steps_0"]
    fetch = [tloss, "w2@GRAD", "w2"] + state
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    w_before = scope.find_var("w2").numpy().copy()
    step = exe.prepare(tmain, fetch_list=fetch, scope=scope,
                       donate_state=True) if entry == "prepare" else None
    replay = _replay([i + 1 in bad_steps for i in range(steps)], 2.0 ** 15,
                     3, 2)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        for i, f in enumerate(feeds):
            out = step.run(f, return_numpy=True) if step else exe.run(
                tmain, feed=f, fetch_list=fetch, scope=scope)
            jout = jexe.run(jmain, feed=f, fetch_list=[jloss] + state)
            loss, grad, w_after = out[:3]
            got = (float(out[3][0]), int(out[4][0]), int(out[5][0]))
            assert got == (float(replay[i][0]),) + replay[i][1:], i
            assert got == (float(jout[1][0]), int(jout[2][0]),
                           int(jout[3][0]))
            if i + 1 in bad_steps:
                assert not np.isfinite(loss).all() and not grad.any()
                np.testing.assert_array_equal(w_after, w_before)
            else:
                assert np.isfinite(loss).all() and grad.any()
                assert not np.array_equal(w_after, w_before)
            w_before = w_after.copy()
    assert replay[4][0] == np.float32(2.0 ** 16) * np.float32(0.8)


# ---------------------------------------------------------------------------
# the ops of the bf16 program, on the same bf16 inputs as the JAX ops
# ---------------------------------------------------------------------------


def _bf16(rng, *shape, scale=1.0):
    """bf16 values as float32 numpy (exactly representable in bf16)."""
    a = torch.from_numpy(rng.randn(*shape).astype(np.float32) * scale)
    return a.to(torch.bfloat16).float().numpy()


def _run_bf16(op, ins, attrs, jctx=None, port_attrs=None):
    """``op`` on the same bf16 inputs (float32 numpy ``ins`` cast) in the
    JAX package and the port (``port_attrs`` added there): the outputs as
    float32 numpy, port first."""
    ref = jget_op(op)(jctx, {k: [jax.numpy.asarray(v, jax.numpy.bfloat16)
                                 if v.dtype == np.float32 else
                                 jax.numpy.asarray(v) for v in vs]
                             for k, vs in ins.items()}, dict(attrs))
    got = registry.get_op(op)(registry.LoweringContext(), {
        k: [torch.from_numpy(v).to(torch.bfloat16)
            if v.dtype == np.float32 else torch.from_numpy(v) for v in vs]
        for k, vs in ins.items()}, dict(attrs, **(port_attrs or {})))
    r = np.asarray(ref["Out"])
    g = got["Out"]
    assert g.dtype == torch.bfloat16 and str(r.dtype) == "bfloat16"
    assert tuple(g.shape) == r.shape
    return g.float().numpy(), r.astype(np.float32)


@pytest.mark.parametrize("op,attrs", [
    ("mul", {"x_num_col_dims": 1, "y_num_col_dims": 1}),
    ("matmul", {"transpose_Y": True}),
    ("matmul", {"alpha": 0.3})])
def test_bf16_products_agree_to_one_ulp(op, attrs):
    rng = np.random.RandomState(1)
    a = _bf16(rng, 256, 768)
    b = _bf16(rng, 3072, 768) if attrs.get("transpose_Y") else \
        _bf16(rng, 768, 3072)
    got, ref = _run_bf16(op, {"X": [a], "Y": [b]}, attrs)
    mag = np.abs(ref).max()
    diff = np.abs(got - ref)
    assert diff.max() <= BF16_ULP * mag
    assert (diff > 0).mean() < MAX_ULP_SHARE


def test_bf16_cast_scale_and_unsqueeze_are_bitwise():
    rng = np.random.RandomState(2)
    mask = (rng.rand(2, 8, 8) > 0.3).astype(np.float32)
    # BERT's padding bias: mask * 1e4 - 1e4 in bf16 gives 0 and -9984
    got, ref = _run_bf16("scale", {"X": [mask]},
                         {"scale": 1e4, "bias": -1e4})
    np.testing.assert_array_equal(got, ref)
    assert set(np.unique(got)) == {0.0, -9984.0}
    v = _bf16(rng, 4, 6)
    for attrs in ({"scale": 0.3, "bias": 0.7},
                  {"scale": 1.7, "bias": -0.2, "bias_after_scale": False}):
        got, ref = _run_bf16("scale", {"X": [v]}, attrs)
        np.testing.assert_array_equal(got, ref)
    got, ref = _run_bf16("unsqueeze2", {"X": [mask]}, {"axes": [1]})
    np.testing.assert_array_equal(got, ref)
    x32 = rng.randn(5, 7).astype(np.float32)
    for dtype in ("bfloat16", "float32"):
        ref = jget_op("cast")(None, {"X": [jax.numpy.asarray(x32)]},
                              {"out_dtype": dtype})["Out"]
        got = registry.get_op("cast")(
            registry.LoweringContext(), {"X": [torch.from_numpy(x32)]},
            {"out_dtype": dtype})["Out"]
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(ref).astype(np.float32))


def test_bf16_fused_attention_agrees_with_the_jax_op():
    """Q, K, V and the padding bias in bf16 (the bias -9984, added in
    float32 by both): the port's flash route (its plain twin here) and its
    plain composition against the JAX op, within two bf16 ulps."""
    rng = np.random.RandomState(4)
    b, s, heads, d = 2, 64, 2, 64
    q, k, v = (_bf16(rng, b, s, heads * d) for _ in range(3))
    keep = np.ones((b, s), np.float32)
    keep[0, 40:] = 0.0
    bias = ((keep[:, :, None] * keep[:, None, :]) * 1e4 - 1e4)[:, None]
    bias = torch.from_numpy(bias).to(torch.bfloat16).float().numpy()
    ins = {"Q": [q], "K": [k], "V": [v], "AttnBias": [bias]}
    attrs = {"n_head": heads, "dropout_rate": 0.0, "is_test": True}
    jctx = JContext(jax.random.PRNGKey(0), is_test=True)
    for use_flash in (True, False):
        got, ref = _run_bf16("fused_attention", ins, attrs, jctx,
                             {"use_flash": use_flash})
        assert np.abs(got - ref).max() <= 2 * BF16_ULP * np.abs(ref).max()
    assert registry.route_counts() == {
        ("fused_attention", "flash_attention", "hit", "supported"): 1,
        ("fused_attention", "flash_attention", "fallback",
         "flag:use_flash_attention=off"): 1}
