"""The fused-training slice of the PyTorch port as a whole: BERT-tiny
pretraining with both fusion passes (``fuse_add_layernorm`` applied to
the program, ``fuse_elemwise_add_act`` through
``CompiledProgram(...).with_data_parallel(build_strategy=...)``) and the
published optimizer recipe (AdamW with decoupled weight decay 0.01, a
linear warmup into a linear decay, gradients clipped to global norm 1.0),
against the JAX package.

The JAX program gets ``fuse_add_layernorm`` but not
``fuse_elemwise_add_act``: off the TPU the JAX package's fused op falls
back to tanh-GELU, its unfused ``gelu`` op is the exact erf the port's
kernel computes.  Both run 5 steps on ``make_fake_batch`` feeds from one
numpy seed with dropout 0, from the same startup parameters (crossed
through ``io.convert_params``).  Tolerances: per-step loss 1e-5 (abs);
every persistable after step 5 within 1e-5 (abs and rel).  On the CPU the
kernel wrappers run their plain twins: every route is hit and nothing is
launched.  Also here: the fetch rules of the pass variants, the LRU of
variants, the refusal of more than one place, each LR schedule against
the JAX package's formula, and the AdamW update order."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import lr_scheduler as jlr
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.passes import apply_pass as japply
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.registry import get_op as jget_op

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import lr_scheduler as tlr
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.errors import UnimplementedError
from paddle_tpu_torch.framework.passes import apply_pass as tapply
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.registry import LoweringContext, get_op

STEPS = 5
TOL = 1e-5


def _schedule(f):
    """Linear warmup over 2 steps into a linear decay to 0 over 10."""
    return f.layers.linear_lr_warmup(
        f.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2, 0.0, 1e-3)


RECIPES = {
    "adam": lambda f: f.optimizer.Adam(1e-3),
    "adamw-warmup-decay-clip": lambda f: f.optimizer.AdamW(
        _schedule(f), weight_decay=0.01,
        grad_clip=f.clip.GradientClipByGlobalNorm(1.0)),
    "adam-l2decay-warmup-decay-clip": lambda f: f.optimizer.Adam(
        _schedule(f), regularization=f.regularizer.L2Decay(0.01),
        grad_clip=f.clip.GradientClipByGlobalNorm(1.0)),
}


def _cfg(mod):
    cfg = mod.BertConfig.tiny()           # hidden 128, 2 heads of 64
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _build(mod, core, un, fluid, apply_pass, recipe):
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 7
    with core.program_guard(main, startup):
        _, total, _, _ = mod.build_pretrain_network(_cfg(mod))
        RECIPES[recipe](fluid).minimize(total)
    apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    return main, startup, total


def _jax_run(recipe):
    rng = np.random.RandomState(0)
    batches = [jbert.make_fake_batch(rng, _cfg(jbert), batch_size=2,
                                     seq_len=128, num_masks=5)
               for _ in range(STEPS)]
    main, startup, total = _build(jbert, jcore, jun, jfluid, japply, recipe)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
                if scope.find_var(n) is not None}
        losses = [float(np.asarray(exe.run(main, feed=b,
                                           fetch_list=[total])[0]))
                  for b in batches]
        final = {n: np.asarray(scope.find_var(n)) for n in init}
    return {"batches": batches, "init": init, "losses": losses,
            "final": final}


@pytest.fixture(scope="module")
def references():
    """The JAX package's runs, one per recipe, made when first asked."""
    cache = {}

    def get(recipe):
        if recipe not in cache:
            cache[recipe] = _jax_run(recipe)
        return cache[recipe]
    return get


@pytest.fixture(autouse=True)
def _fresh_port_state():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    tcore.reset_default_programs()


def _compiled(main, loss_name):
    bs = tfluid.BuildStrategy()
    bs.fuse_elewise_add_act_ops = True
    return tfluid.CompiledProgram(main).with_data_parallel(
        loss_name=loss_name, build_strategy=bs)


@pytest.mark.parametrize("entry", ["run", "prepare"])
@pytest.mark.parametrize("recipe", list(RECIPES))
def test_fused_program_trains_like_the_jax_package(references, recipe,
                                                   entry):
    ref = references(recipe)
    main, _, total = _build(tbert, tcore, tun, tfluid, tapply, recipe)
    names = [v.name for v in main.list_vars() if v.persistable]
    assert set(names) <= set(ref["init"]), "the programs declare other state"
    scope = tfluid.Scope()
    for n, t in tio.convert_params({n: ref["init"][n] for n in names},
                                   "cpu").items():
        scope.set_var(n, t)
    compiled = _compiled(main, total.name)
    exe = tfluid.Executor(tfluid.CPUPlace())
    if entry == "run":
        losses = [float(exe.run(compiled, feed=b, fetch_list=[total],
                                scope=scope)[0]) for b in ref["batches"]]
    else:
        prepared = exe.prepare(compiled, fetch_list=[total], scope=scope,
                               donate_state=True)
        losses = [float(prepared.run(b)[0]) for b in ref["batches"]]
        tfluid.sync_prepared_state(scope)
    np.testing.assert_allclose(losses, ref["losses"], rtol=0, atol=TOL)
    for n in names:
        np.testing.assert_allclose(np.asarray(scope.find_var(n)),
                                   ref["final"][n], rtol=TOL, atol=TOL,
                                   err_msg=n)
    # the variant ran: 5 add+LN, 3 bias+GELU (2 FFN, the masked-LM
    # transform; the pooled tanh is fused too but is not the kernel's)
    variant = compiled._variant_for([total.name])
    types = [op.type for op in variant.global_block().ops]
    assert types.count("fused_add_layernorm") == 5
    assert types.count("fused_elemwise_activation") == 4
    assert "gelu" not in types and "fused_elemwise_activation" not in \
        [op.type for op in main.global_block().ops]
    hits = {k[0]: v // STEPS for k, v in registry.route_counts("hit").items()}
    update = "adam" if recipe.startswith("adam-") or recipe == "adam" \
        else "adamw"
    assert hits == {"fused_add_layernorm": 5, "fused_elemwise_activation": 3,
                    "layer_norm": 1, "fused_attention": 2, update: 38}
    assert not registry.route_counts("fallback")
    assert sum(port_cuda.launch_counts().values()) == 0


# ---------------------------------------------------------------------------
# the pass variants (ports of tests/test_passes.py's strategy-fusion tests)
# ---------------------------------------------------------------------------


def _fetch_program():
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    L = tfluid.layers
    with tcore.program_guard(main, startup):
        a = L.data("a", shape=[8])
        w = L.fc(a, 8, bias_attr=False)
        s = L.elementwise_add(a, w)
        loss = L.mean(L.relu(s))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return main, exe, scope, s, loss


def _expected_s(scope, main, feed):
    w = [p for p in main.all_parameters()][0]
    a = feed["a"]
    return a + a @ scope.find_var(w.name).numpy()


@pytest.mark.parametrize("order", ["intermediate-first", "loss-first"])
def test_strategy_fusion_keeps_a_fetched_intermediate(order):
    """A fetched intermediate is never fused away, whichever fetch list
    runs first: each fetch list gets its own pass-applied clone."""
    main, exe, scope, s, loss = _fetch_program()
    cp = _compiled(main, loss.name)
    feed = {"a": np.random.RandomState(1).rand(4, 8).astype(np.float32)}
    if order == "loss-first":
        exe.run(cp, feed=feed, fetch_list=[loss], scope=scope)
    want = _expected_s(scope, main, feed)
    sv, _ = exe.run(cp, feed=feed, fetch_list=[s, loss], scope=scope)
    np.testing.assert_allclose(sv, want, rtol=1e-6, atol=1e-6)
    assert "elementwise_add" in [op.type for op in main.global_block().ops]
    fused = [op.type for op in cp._variant_for([loss.name])
             .global_block().ops]
    assert "fused_elemwise_activation" in fused and "relu" not in fused
    kept = [op.type for op in cp._variant_for([s.name, loss.name])
            .global_block().ops]
    assert "fused_elemwise_activation" not in kept


def test_pass_variants_are_a_true_lru_of_eight():
    main, _, _, s, loss = _fetch_program()
    cp = _compiled(main, loss.name)
    lists = [[loss.name] + [s.name] * i for i in range(9)]
    first = cp._variant_for(lists[0])
    assert cp._variant_for(lists[0]) is first          # a hit
    for fl in lists[1:8]:
        cp._variant_for(fl)
    assert cp._variant_for(lists[0]) is first          # promoted
    cp._variant_for(lists[8])                          # evicts lists[1]
    assert len(cp._pass_variants) == 8
    assert tuple(lists[1]) not in cp._pass_variants
    assert cp._variant_for(lists[0]) is first
    # no pending pass: the program itself
    plain = tfluid.CompiledProgram(main).with_data_parallel(loss.name)
    assert plain._variant_for([loss.name]) is main


@pytest.mark.parametrize("how", ["two-cpu-places", "two-cuda-places", "mesh",
                                 "with_mesh"])
def test_more_than_one_place_is_refused(how):
    main, _, _, _, loss = _fetch_program()
    cp = tfluid.CompiledProgram(main)
    with pytest.raises(UnimplementedError, match="multi-GPU"):
        if how == "two-cpu-places":
            cp.with_data_parallel(loss.name, places=tfluid.cpu_places(2))
        elif how == "two-cuda-places":
            cp.with_data_parallel(loss.name, places=[tfluid.CUDAPlace(0),
                                                     tfluid.CUDAPlace(1)])
        elif how == "mesh":
            cp.with_data_parallel(loss.name, mesh=object())
        else:
            cp.with_mesh(object(), loss_name=loss.name)
    # one place inserts no gradient sync: the op list is untouched
    before = [op.type for op in main.global_block().ops]
    tfluid.CompiledProgram(main).with_data_parallel(
        loss.name, places=[tfluid.CPUPlace()])
    assert [op.type for op in main.global_block().ops] == before


# ---------------------------------------------------------------------------
# LR schedules and the AdamW update against the JAX package
# ---------------------------------------------------------------------------


SCHEDULES = {
    "noam": lambda m: m.noam_decay(128, 4, 2.0),
    "exponential": lambda m: m.exponential_decay(0.1, 3, 0.5, True),
    "natural_exp": lambda m: m.natural_exp_decay(0.1, 3, 0.5),
    "inverse_time": lambda m: m.inverse_time_decay(0.1, 3, 0.5, True),
    "polynomial": lambda m: m.polynomial_decay(0.1, 6, 0.001, 2.0),
    "polynomial-cycle": lambda m: m.polynomial_decay(0.1, 4, 0.0, 1.0,
                                                     cycle=True),
    "piecewise": lambda m: m.piecewise_decay([2, 5], [0.1, 0.05, 0.01]),
    "cosine": lambda m: m.cosine_decay(0.1, 2, 5),
    "constant-warmup": lambda m: m.linear_lr_warmup(0.1, 3, 0.0, 0.1),
    "polynomial-warmup": lambda m: m.linear_lr_warmup(
        m.polynomial_decay(1e-4, 10, 0.0, power=1.0), 3, 0.0, 1e-4),
}


@pytest.mark.parametrize("kind", list(SCHEDULES))
def test_lr_schedule_matches_the_jax_package(kind):
    jsched, tsched = SCHEDULES[kind](jlr), SCHEDULES[kind](tlr)
    attrs = {"kind": jsched.kind, **jsched.attrs}
    assert tsched.kind == jsched.kind and tsched.attrs == jsched.attrs
    for step in range(12):
        want = jlr._lr_schedule_op(None, {"Step": [jnp.asarray([step])]},
                                   attrs)["Out"]
        got = tlr._lr_schedule_op(None, {"Step": [torch.tensor([step])]},
                                  attrs)["Out"]
        assert got.dtype == torch.float32 and got.shape == (1,)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=1e-6, atol=1e-12, err_msg=str(step))


@pytest.mark.parametrize("donate", [False, True])
def test_adamw_decays_the_parameter_as_it_was_before_the_update(donate):
    """``ParamOut = adam(p) - lr * coeff * p`` with p read before the
    update, even when the update writes p in place (``donate_state``).
    At lr 0.5 and coeff 0.5 the decay of the updated p would miss by
    ~0.1 per element."""
    rng = np.random.RandomState(3)
    arrays = {"Param": rng.randn(300), "Grad": rng.randn(300),
              "Moment1": rng.randn(300), "Moment2": rng.rand(300),
              "LearningRate": [0.5], "Beta1Pow": [0.9], "Beta2Pow": [0.999]}
    arrays = {k: np.asarray(v, np.float32) for k, v in arrays.items()}
    attrs = {"beta1": 0.9, "beta2": 0.999, "epsilon": 1e-8, "coeff": 0.5}
    want = jget_op("adamw")(None, {k: [jnp.asarray(v)]
                                   for k, v in arrays.items()}, attrs)
    ins = {k: [torch.from_numpy(v.copy())] for k, v in arrays.items()}
    got = get_op("adamw")(LoweringContext(donate_state=donate), ins, attrs)
    for slot in ("ParamOut", "Moment1Out", "Moment2Out", "Beta1PowOut",
                 "Beta2PowOut"):
        np.testing.assert_allclose(got[slot].numpy(), np.asarray(want[slot]),
                                   rtol=1e-6, atol=1e-6, err_msg=slot)
    assert (got["ParamOut"] is ins["Param"][0]) == donate
    assert registry.route_counts("hit") == {
        ("adamw", "fused_adam", "hit", "supported"): 1}
