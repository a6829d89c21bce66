"""The training slice of the PyTorch port as a whole: BERT-tiny
pretraining with Adam through ``Executor.run`` and through
``Executor.prepare(donate_state=True)``, against the JAX package.

Both packages build the same program (``build_pretrain_network`` +
``Adam.minimize``) with dropout 0 (their masks come from different
generators), the JAX startup's parameters cross into the port through
``io.convert_params``, and 5 steps run on ``make_fake_batch`` feeds made
from one numpy seed.  Tolerances: per-step loss 1e-5 (abs); every
persistable after step 5 and a fetched ``param@GRAD`` after step 1 within
1e-5 (abs + rel).  On the CPU the kernel wrappers run their plain twins:
the routes must be hit and nothing launched.  The no-fallback rule for
training is checked with ``device="meta"`` tensors."""

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import flags
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.errors import UnimplementedError
from paddle_tpu_torch.framework.executor import backward_index
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.registry import LoweringContext, get_op

STEPS = 5
TOL = 1e-5
GRAD_PROBE = "encoder_layer_0_qkv_w"


def _cfg(mod):
    cfg = mod.BertConfig.tiny()           # hidden 128, 2 heads of 64
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _build(mod, core, un, fluid):
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 7
    with core.program_guard(main, startup):
        _, total, _, _ = mod.build_pretrain_network(_cfg(mod))
        fluid.optimizer.Adam(1e-3).minimize(total)
    return main, startup, total


@pytest.fixture(scope="module")
def reference():
    """The JAX package's run: the startup's parameters, the batches, the
    per-step losses, the step-1 grad probe and the state after step 5."""
    rng = np.random.RandomState(0)
    batches = [jbert.make_fake_batch(rng, _cfg(jbert), batch_size=2,
                                     seq_len=128, num_masks=5)
               for _ in range(STEPS)]
    main, startup, total = _build(jbert, jcore, jun, jfluid)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
                if scope.find_var(n) is not None}
        losses, grad = [], None
        for i, b in enumerate(batches):
            fetch = [total, GRAD_PROBE + "@GRAD"] if i == 0 else [total]
            out = exe.run(main, feed=b, fetch_list=fetch)
            losses.append(float(np.asarray(out[0])))
            if i == 0:
                grad = np.asarray(out[1])
        final = {n: np.asarray(scope.find_var(n)) for n in init}
    return {"batches": batches, "init": init, "losses": losses,
            "grad": grad, "final": final}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    tcore.reset_default_programs()


def _port_scope(ref, main):
    scope = tfluid.Scope()
    names = [v.name for v in main.list_vars() if v.persistable]
    assert set(names) <= set(ref["init"]), "the programs declare other state"
    for n, t in tio.convert_params({n: ref["init"][n] for n in names},
                                   "cpu").items():
        scope.set_var(n, t)
    return scope, names


def _check_final(ref, scope, names):
    for n in names:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   ref["final"][n], rtol=TOL, atol=TOL,
                                   err_msg=n)


def _check_routes():
    hits = registry.route_counts("hit")
    per_step = {k[0]: v // STEPS for k, v in hits.items()}
    # BERT-tiny: 6 layer_norm (1 + 2 per layer + the LM head), 2 attention
    # layers, 38 parameters
    assert per_step == {"layer_norm": 6, "fused_attention": 2, "adam": 38}
    assert not registry.route_counts("fallback")
    assert sum(port_cuda.launch_counts().values()) == 0


def test_executor_run_trains_like_the_jax_package(reference):
    main, _, total = _build(tbert, tcore, tun, tfluid)
    scope, names = _port_scope(reference, main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    losses = []
    for i, b in enumerate(reference["batches"]):
        fetch = [total, GRAD_PROBE + "@GRAD"] if i == 0 else [total]
        out = exe.run(main, feed=b, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        if i == 0:
            np.testing.assert_allclose(out[1], reference["grad"], rtol=TOL,
                                       atol=TOL)
    np.testing.assert_allclose(losses, reference["losses"], rtol=0,
                               atol=TOL)
    _check_final(reference, scope, names)
    _check_routes()


def test_prepared_donated_training_matches_and_updates_in_place(reference):
    main, _, total = _build(tbert, tcore, tun, tfluid)
    scope, names = _port_scope(reference, main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    prepared = exe.prepare(main, fetch_list=[total], scope=scope,
                           donate_state=True)
    w = GRAD_PROBE
    before = scope.find_var(w)
    storage = before.data_ptr()
    losses = [float(prepared.run(b)[0]) for b in reference["batches"]]
    np.testing.assert_allclose(losses, reference["losses"], rtol=0,
                               atol=TOL)
    # the state kept its storage: the scope's tensor was updated in place
    assert scope.find_var(w) is before and before.data_ptr() == storage
    tfluid.sync_prepared_state(scope)
    _check_final(reference, scope, names)
    _check_routes()


def test_eval_clone_and_save_read_the_prepared_weights(reference, tmp_path):
    """After prepared training, a ``clone(for_test=True)`` run and
    ``save_persistables`` see the current weights, not the startup's."""
    main, _, total = _build(tbert, tcore, tun, tfluid)
    scope, _ = _port_scope(reference, main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    test_prog = main.clone(for_test=True)
    feed = reference["batches"][0]
    prepared = exe.prepare(main, fetch_list=[total], scope=scope,
                           donate_state=True)
    for b in reference["batches"]:
        prepared.run(b)
    # the eval clone still holds the backward and Adam ops; fetch only the
    # loss of a program pruned to it
    evalp = test_prog._prune([total.name])
    got, = exe.run(evalp, feed=feed, fetch_list=[total], scope=scope)
    fresh, _ = _port_scope(reference, main)
    start, = exe.run(evalp, feed=feed, fetch_list=[total], scope=fresh)
    assert abs(float(got) - float(start)) > 1e-3
    tio.save_persistables(exe, str(tmp_path), main, scope=scope)
    with np.load(tmp_path / "params.npz") as data:
        np.testing.assert_allclose(data[GRAD_PROBE],
                                   reference["final"][GRAD_PROBE],
                                   rtol=TOL, atol=TOL)


def test_training_dropout_draws_a_seed_per_op_and_trains():
    """dropout 0.1 as published: the flash route takes it (the kernels'
    Philox mask, here its plain twin), the loss is finite and two runs from
    one program seed agree exactly."""
    def run():
        tun.reset()
        main, startup = tcore.Program(), tcore.Program()
        startup.random_seed = main.random_seed = 3
        cfg = tbert.BertConfig.tiny()
        with tcore.program_guard(main, startup):
            _, total, _, _ = tbert.build_pretrain_network(cfg)
            tfluid.optimizer.Adam(1e-3).minimize(total)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        feed = tbert.make_fake_batch(np.random.RandomState(1), cfg, 2, 128,
                                     5)
        prepared = exe.prepare(main, fetch_list=[total], scope=scope,
                               donate_state=True)
        return [float(prepared.run(feed)[0]) for _ in range(3)]
    a = run()
    assert np.isfinite(a).all()
    assert registry.route_counts("hit")[
        ("fused_attention", "flash_attention", "hit", "supported")] == 6
    assert a == run()


def _small_program(fluid, core, un, make_opt):
    """Embedding + fc over ids and a dense feature, mean loss; ``make_opt``
    gives the optimizer (None: ``gradients`` of the loss w.r.t. the dense
    feed instead)."""
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 11
    with core.program_guard(main, startup):
        ids = fluid.layers.data("ids", shape=[-1, 4], dtype="int64",
                                append_batch_size=False)
        x = fluid.layers.data("x", shape=[16])
        emb = fluid.layers.embedding(ids, size=[50, 16])
        h = fluid.layers.fc(x, 16, act="tanh")
        loss = fluid.layers.mean(fluid.layers.fc(emb, 3, num_flatten_dims=2)) \
            + fluid.layers.mean(fluid.layers.fc(h, 3))
        if make_opt is None:
            fetch = fluid.gradients(loss, [x])
        else:
            make_opt(fluid).minimize(loss)
            fetch = []
    return main, startup, [loss] + fetch


def _small_feeds(steps):
    """Step 1 reads embedding rows 0-9, later steps rows 10-19: a lazy
    update then leaves rows 0-9 alone, a dense one keeps moving them."""
    g = np.random.RandomState(5)
    return [{"ids": g.randint(0, 10, (3, 4)).astype("int64") + 10 * (i > 0),
             "x": g.randn(3, 16).astype("float32")} for i in range(steps)]


_SMALL_OPTS = {
    "sgd": lambda f: f.optimizer.SGD(0.1),
    "adam": lambda f: f.optimizer.Adam(0.01),
    "adam-lazy": lambda f: f.optimizer.Adam(0.01, lazy_mode=True),
    "gradients": None,
    "adamw": lambda f: f.optimizer.AdamW(0.05, weight_decay=0.5),
    "sgd-l1decay": lambda f: f.optimizer.SGD(
        0.1, regularization=f.regularizer.L1Decay(0.05)),
    "sgd-clip-by-value": lambda f: f.optimizer.SGD(
        0.1, grad_clip=f.clip.GradientClipByValue(0.02)),
    "sgd-clip-by-norm": lambda f: f.optimizer.SGD(
        0.1, grad_clip=f.clip.GradientClipByNorm(0.05)),
    "adam-exponential-l2-global-norm": lambda f: f.optimizer.Adam(
        f.layers.exponential_decay(0.05, 1, 0.5),
        regularization=f.regularizer.L2Decay(0.1),
        grad_clip=f.clip.GradientClipByGlobalNorm(0.05)),
}


@pytest.mark.parametrize("opt", list(_SMALL_OPTS))
def test_small_programs_match_the_jax_package(opt):
    """SGD, dense Adam, lazy Adam (rows the batch never touched keep their
    parameters and moments), ``gradients`` w.r.t. a feed, AdamW, the
    regularizers, the three gradient clips and an LR schedule, 3 steps
    through ``Executor.run`` of both packages from one startup."""
    make_opt = _SMALL_OPTS[opt]
    feeds = _small_feeds(3)
    jmain, jstart, jfetch = _small_program(jfluid, jcore, jun, make_opt)
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        init = {n: np.asarray(jscope.find_var(n))
                for n in jscope.var_names()
                if jscope.find_var(n) is not None}
        jouts = [jexe.run(jmain, feed=f, fetch_list=jfetch) for f in feeds]
        jfinal = {n: np.asarray(jscope.find_var(n)) for n in init}
    main, _, fetch = _small_program(tfluid, tcore, tun, make_opt)
    names = [v.name for v in main.list_vars() if v.persistable]
    assert set(names) <= set(init)
    scope = tfluid.Scope()
    for n, t in tio.convert_params({n: init[n] for n in names},
                                   "cpu").items():
        scope.set_var(n, t)
    exe = tfluid.Executor(tfluid.CPUPlace())
    emb = [n for n in names if n.startswith("embedding")][0]
    for i, (f, jout) in enumerate(zip(feeds, jouts)):
        out = exe.run(main, feed=f, fetch_list=fetch, scope=scope)
        for got, want in zip(out, jout):
            np.testing.assert_allclose(got, np.asarray(want), rtol=TOL,
                                       atol=TOL)
        if i == 0:
            rows_after_step1 = scope.find_var(emb).numpy()[:10].copy()
    for n in names:
        np.testing.assert_allclose(scope.find_var(n).numpy(), jfinal[n],
                                   rtol=TOL, atol=TOL, err_msg=n)
    if opt in ("adam", "adam-lazy"):
        moved = not np.array_equal(scope.find_var(emb).numpy()[:10],
                                   rows_after_step1)
        assert moved == (opt == "adam")


def test_unported_backward_features_are_refused():
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        h = tfluid.layers.fc(x, 4)
        loss = tfluid.layers.mean(tfluid.layers.fc(h, 2))
        tfluid.optimizer.SGD(0.1).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((3, 4), np.float32)}
    first, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    second, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert second < first                        # SGD trains
    bw = [op for op in main.global_block().ops if op.type == "backward"][0]
    # the microbatched / pipelined lowering is ported
    # (tests/test_torch_pipeline.py); recompute checkpoints under it are
    # refused by name
    bw.attrs["pipe_microbatches"] = 3
    bw.attrs["checkpoints"] = [h.name]
    with pytest.raises(UnimplementedError, match="pipelined"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    bw.attrs.pop("pipe_microbatches")
    bw.attrs["checkpoints"] = None
    # recompute checkpoints are ported: the step runs, segmented at h
    bw.attrs["checkpoints"] = [h.name]
    third, = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert third < second
    bw.attrs["checkpoints"] = None
    # regularization is ported: L2Decay adds coeff * p to each gradient
    # before the update reads it
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2))
        tfluid.optimizer.Adam(
            1e-3, regularization=tfluid.regularizer.L2Decay(0.5)
        ).minimize(loss)
    ops = main.global_block().ops
    tail = [op.type for op in ops[backward_index(ops) + 1:]]
    assert tail == ["scale", "sum"] * 2 + ["adam"] * 2
    sums = [op for op in ops if op.type == "sum"]
    assert all(op.output_names()[0] in adam.inputs["Grad"]
               for op, adam in zip(sums, [o for o in ops
                                           if o.type == "adam"]))


@pytest.mark.parametrize("scale", [2.0 ** -3, 2.0 ** 10, 2.0 ** 15])
def test_loss_scale_var_scales_the_gradients_exactly(scale):
    """The backward's ``loss_scale_var`` (AMP's dynamic loss scale)
    multiplies the summed loss: with a power-of-two scale every gradient
    comes back scaled exactly, and ``check_finite_and_unscale`` gives bit
    for bit the gradients of the unscaled program."""
    def build(with_scale):
        tun.reset()
        main, startup = tcore.Program(), tcore.Program()
        startup.random_seed = 5
        with tcore.program_guard(main, startup):
            x = tfluid.layers.data("x", shape=[8])
            h = tfluid.layers.fc(x, 16, act="tanh")
            loss = tfluid.layers.mean(tfluid.layers.fc(h, 3))
            _, pgs = tfluid.optimizer.SGD(0.0).minimize(loss)
        grads = [g.name for _, g in pgs]
        if with_scale:
            block = main.global_block()
            ops = block.ops
            bw = backward_index(ops)
            block.create_var(name="scale", shape=(1,), persistable=True)
            ops[bw].attrs["loss_scale_var"] = "scale"
            found = block.create_var(name="found_inf", shape=(1,),
                                     dtype="bool")
            block._insert_op(bw + 1, type="check_finite_and_unscale",
                             inputs={"X": grads, "Scale": ["scale"]},
                             outputs={"Out": grads,
                                      "FoundInfinite": [found]})
        return main, startup, loss, grads

    feed = {"x": np.random.RandomState(2).randn(6, 8).astype(np.float32)}
    outs = []
    for with_scale in (False, True):
        main, startup, loss, grads = build(with_scale)
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        exe.run(startup, scope=scope)
        scope.set_var("scale", torch.tensor([scale]))
        raw = None
        if with_scale:
            # the raw scaled gradients, before the unscale op
            ops = main.global_block().ops
            bw = backward_index(ops)
            keep = ops[bw + 1]
            del ops[bw + 1]
            raw = exe.run(main, feed=feed, fetch_list=grads, scope=scope)
            ops.insert(bw + 1, keep)
        outs.append((exe.run(main, feed=feed, fetch_list=[loss] + grads,
                             scope=scope), raw))
    (plain, _), (unscaled, raw) = outs
    for a, b in zip(plain, unscaled):
        np.testing.assert_array_equal(a.view(np.uint32), b.view(np.uint32))
    for g, r in zip(plain[1:], raw):
        np.testing.assert_array_equal((g * scale).view(np.uint32),
                                      r.view(np.uint32))


# ---------------------------------------------------------------------------
# the no-fallback rule for training, with device="meta" tensors
# ---------------------------------------------------------------------------


def _meta(*shape, grad=False):
    return torch.empty(*shape, device="meta").requires_grad_(grad)


_GRAD_ROUTES = {
    "layer_norm": lambda: ({"X": [_meta(4, 3, 768, grad=True)],
                            "Scale": [_meta(768)], "Bias": [_meta(768)]},
                           {"begin_norm_axis": 2}, "fused_layer_norm"),
    "fused_attention": lambda: (
        {"Q": [_meta(2, 128, 128, grad=True)],
         "K": [_meta(2, 128, 128, grad=True)],
         "V": [_meta(2, 128, 128, grad=True)]},
        {"n_head": 2, "dropout_rate": 0.1, "is_test": False},
        "flash_attention"),
    "fused_add_layernorm": lambda: (
        {"X": [_meta(4, 3, 256, grad=True)], "Residual": [_meta(4, 3, 256)],
         "Scale": [_meta(256, grad=True)], "Bias": [_meta(256)]},
        {"begin_norm_axis": 2}, "fused_add_layer_norm"),
    "fused_elemwise_activation": lambda: (
        {"X": [_meta(4, 256, grad=True)], "Y": [_meta(256, grad=True)]},
        {"functor_list": ["elementwise_add", "gelu"]}, "fused_bias_gelu"),
}


@pytest.mark.parametrize("op_type", list(_GRAD_ROUTES))
def test_kernels_with_a_backward_take_inputs_that_need_a_gradient(op_type):
    """Every kernel route of the training programs has a backward kernel,
    so an input that needs a gradient is a hit on the card and on the
    CPU alike, never a refusal or a fallback."""
    ins, attrs, kernel = _GRAD_ROUTES[op_type]()
    route, _ = registry.cuda_route(op_type, ins, attrs)
    assert route is not None and route.kernel == kernel
    cpu = {k: [torch.zeros(t.shape).requires_grad_(t.requires_grad)
               for t in v] for k, v in ins.items()}
    route, _ = registry.cuda_route(op_type, cpu, attrs)
    assert route is not None
    assert not registry.route_counts("fallback")


def test_layer_norm_route_detaches_mean_and_variance():
    """The route's Mean/Variance are computed outside the kernel and carry
    no gradient, as the JAX package stop-gradients them; Y does."""
    g = np.random.RandomState(4)
    a = torch.tensor(g.randn(6, 256).astype(np.float32), requires_grad=True)
    scale = torch.ones(256, requires_grad=True)
    bias = torch.zeros(256, requires_grad=True)
    ins = {"X": [a], "Scale": [scale], "Bias": [bias]}
    out = get_op("layer_norm")(LoweringContext(), ins, {"begin_norm_axis": 1})
    assert registry.route_counts("hit") == {
        ("layer_norm", "fused_layer_norm", "hit", "supported"): 1}
    assert out["Y"].requires_grad
    assert not out["Mean"].requires_grad
    assert not out["Variance"].requires_grad
    np.testing.assert_allclose(out["Mean"].numpy(),
                               a.detach().numpy().mean(-1), atol=1e-6)


@pytest.mark.parametrize("numel", [768, 2, 30522, 2359296])
def test_adam_route_takes_any_numel_on_the_card(numel):
    z = _meta(numel)
    ins = {"Param": [z], "Grad": [z], "Moment1": [z], "Moment2": [z],
           "LearningRate": [_meta(1)], "Beta1Pow": [_meta(1)],
           "Beta2Pow": [_meta(1)]}
    route, _ = registry.cuda_route("adam", ins, {})
    assert route is not None and route.kernel == "fused_adam"
    bad = dict(ins, Moment2=[_meta(numel + 1)])
    with pytest.raises(UnimplementedError, match="shape-mismatch"):
        registry.cuda_route("adam", bad, {})
    # the lazy (SparseRows) update is not the kernel's: skipped, not refused
    route, why = registry.cuda_route("adam", ins, {"lazy_mode": True})
    assert route is None and why == "no-matching-route"
    flags.set_flags({"use_pallas_fused": False})
    try:
        route, why = registry.cuda_route("adam", bad, {})
    finally:
        flags.set_flags({"use_pallas_fused": True})
    assert route is None and why == "flag:use_pallas_fused=off"
