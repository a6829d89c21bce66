"""Activation recompute in the PyTorch port, on the CPU: the backward's
``checkpoints`` (``RecomputeOptimizer``, fleet's ``strategy.recompute``)
run the forward in segments under ``torch.utils.checkpoint``.

* The JAX package's ``test_backward_with_checkpoints_matches_plain`` in
  both packages: recompute changes no loss, and the port's losses are the
  JAX package's within 1e-5.
* BERT-tiny with one checkpoint a layer (each encoder layer's last
  LayerNorm output, picked from the program) against the JAX package's
  recompute at dropout 0, through ``Executor.run`` and
  ``prepare(donate_state=True)``: the tolerances of
  ``tests/test_torch_training.py`` (losses 1e-5 abs, every persistable
  after 5 steps and a step-1 gradient within 1e-5).
* The port with recompute against the port without, at dropout 0.1: the
  losses, every step-1 gradient, every persistable after 3 steps and the
  run generator's state bit for bit, through both entry points and on
  the fused program (both fusion passes).  Dropout masks and the flash
  kernels' seeds are drawn again in the backward's recompute from the
  generator state each segment began with; without that replay the
  gradients differ.
* The bytes autograd keeps for the backward (counted with
  ``torch.autograd.graph.saved_tensors_hooks``) fall by more than half
  at BERT-tiny.
* ``fleet``'s ``strategy.recompute`` sets the backward's ``checkpoints``.
* A dropout op at rate 0 keeps every element (its mask is drawn as
  ``jax.random.bernoulli`` draws one)."""

import dataclasses

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.distributed import fleet as tfleet
from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                UserDefinedRoleMaker)
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import executor as texecutor
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.passes import apply_pass
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry

STEPS = 5
TOL = 1e-5
GRAD_PROBE = "encoder_layer_0_qkv_w"
PACKAGES = {"jax": (jfluid, jcore, jun, jbert),
            "port": (tfluid, tcore, tun, tbert)}


@pytest.fixture(autouse=True)
def _fresh_port_state():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    tcore.reset_default_programs()


def layer_checkpoints(program):
    """Each encoder layer's last LayerNorm output: the ``Y`` of the
    ``layer_norm`` ops whose scale is an ``_ln2_scale`` parameter."""
    return [op.output("Y")[0] for op in program.global_block().ops
            if op.type in ("layer_norm", "fused_add_layernorm")
            and op.input("Scale")[0].endswith("_ln2_scale")]


def _two_fc(pkg, use_ckpt):
    fluid, core, un, _ = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        const = fluid.initializer.Constant(0.1)
        h1 = fluid.layers.fc(x, 8, act="tanh", bias_attr=False,
                             param_attr=fluid.ParamAttr(name="w1",
                                                        initializer=const))
        h2 = fluid.layers.fc(h1, 8, act="tanh", bias_attr=False,
                             param_attr=fluid.ParamAttr(name="w2",
                                                        initializer=const))
        loss = fluid.layers.mean(h2)
        opt = fluid.optimizer.SGD(0.1)
        if use_ckpt:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints([h1])
        opt.minimize(loss)
    return main, startup, loss


def test_backward_with_checkpoints_matches_plain():
    x = np.linspace(-1, 1, 8).reshape(2, 4).astype(np.float32)
    losses = {}
    for pkg in PACKAGES:
        fluid = PACKAGES[pkg][0]
        for use_ckpt in (False, True):
            main, startup, loss = _two_fc(pkg, use_ckpt)
            bw = [op for op in main.global_block().ops
                  if op.type == "backward"][0]
            assert bool(bw.attrs["checkpoints"]) == use_ckpt
            exe = fluid.Executor(fluid.CPUPlace())
            scope = fluid.Scope()
            with fluid.scope_guard(scope):
                exe.run(startup)
                for _ in range(3):
                    out, = exe.run(main, feed={"x": x}, fetch_list=[loss])
            losses[pkg, use_ckpt] = float(np.asarray(out))
    assert losses["port", True] == losses["port", False]
    assert np.isclose(losses["jax", True], losses["jax", False], rtol=1e-5)
    assert abs(losses["port", True] - losses["jax", True]) <= TOL


def _cfg(bert, dropout):
    return dataclasses.replace(bert.BertConfig.tiny(),
                               hidden_dropout_prob=dropout,
                               attention_probs_dropout_prob=dropout)


def _bert(pkg, recompute, dropout=0.0, fused=False):
    fluid, core, un, bert = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = main.random_seed = 7
    with core.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(_cfg(bert, dropout))
        ckpts = layer_checkpoints(main)
        opt = fluid.optimizer.Adam(1e-3)
        if recompute:
            opt = fluid.optimizer.RecomputeOptimizer(opt)
            opt._set_checkpoints(ckpts)
        opt.minimize(total)
    assert len(ckpts) == 2                   # BERT-tiny: two layers
    program = main
    if fused:
        apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
        bs = tfluid.BuildStrategy()
        bs.fuse_elewise_add_act_ops = True
        program = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=total.name, build_strategy=bs)
    return program, main, startup, total


@pytest.fixture(scope="module")
def reference():
    """The JAX package's recompute run: its startup state, the batches,
    losses, the step-1 gradient probe and the state after each step."""
    rng = np.random.RandomState(0)
    batches = [jbert.make_fake_batch(rng, _cfg(jbert, 0.0), batch_size=2,
                                     seq_len=64, num_masks=5)
               for _ in range(STEPS)]
    _, main, startup, total = _bert("jax", True)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in names}
        losses, grad = [], None
        for i, b in enumerate(batches):
            fetch = [total, GRAD_PROBE + "@GRAD"] if i == 0 else [total]
            out = exe.run(main, feed=b, fetch_list=fetch)
            losses.append(float(np.asarray(out[0])))
            if i == 0:
                grad = np.asarray(out[1])
        final = {n: np.asarray(scope.find_var(n)) for n in names}
    return {"batches": batches, "init": init, "losses": losses,
            "grad": grad, "final": final}


def _port_scope(init, main):
    scope = tfluid.Scope()
    names = sorted(v.name for v in main.list_vars() if v.persistable)
    for n, t in tio.convert_params({n: init[n] for n in names},
                                   "cpu").items():
        scope.set_var(n, t)
    return scope, names


@pytest.mark.parametrize("entry", ["run", "prepare"])
def test_bert_tiny_recompute_trains_like_the_jax_package(reference, entry):
    program, main, _, total = _bert("port", True)
    scope, names = _port_scope(reference["init"], main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    fetch = [total, GRAD_PROBE + "@GRAD"]
    step = exe.prepare(program, fetch_list=fetch, scope=scope,
                       donate_state=True) if entry == "prepare" else None
    losses = []
    for i, b in enumerate(reference["batches"]):
        if step is not None:
            out = [h.numpy() for h in step.run(b)]
        else:
            out = exe.run(program, feed=b, fetch_list=fetch, scope=scope)
        losses.append(float(out[0]))
        if i == 0:
            np.testing.assert_allclose(out[1], reference["grad"], rtol=TOL,
                                       atol=TOL)
    np.testing.assert_allclose(losses, reference["losses"], rtol=0,
                               atol=TOL)
    tfluid.sync_prepared_state(scope)
    for n in names:
        np.testing.assert_allclose(scope.find_var(n).numpy(),
                                   reference["final"][n], rtol=TOL,
                                   atol=TOL, err_msg=n)
    # the recomputed segments launch the kernel routes again: both
    # layers' attention and LayerNorms twice, the head's LayerNorm once
    hits = registry.route_counts("hit")
    per_step = {k[0]: v // STEPS for k, v in hits.items()}
    assert per_step == {"layer_norm": 1 + 2 * 5, "fused_attention": 2 * 2,
                        "adam": 38}
    assert not registry.route_counts("fallback")


def _port_run(recompute, entry, fused, batches, steps=3):
    """Steps of the port's BERT-tiny at dropout 0.1: losses, step-1 grads,
    the final state and the generator's state after each step."""
    program, main, startup, total = _bert("port", recompute, dropout=0.1,
                                          fused=fused)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    grads = [p.name + "@GRAD" for p in main.all_parameters()]
    step = exe.prepare(program, fetch_list=[total] + grads, scope=scope,
                       donate_state=True) if entry == "prepare" else None
    losses, first, gens = [], None, []
    for b in batches[:steps]:
        if step is not None:
            out = [h.numpy() for h in step.run(b)]
        else:
            out = exe.run(program, feed=b, fetch_list=[total] + grads,
                          scope=scope)
        losses.append(out[0])
        first = out[1:] if first is None else first
        gens.append(scope.find_var(texecutor._RNG_VAR).get_state().numpy())
    tfluid.sync_prepared_state(scope)
    state = {n: scope.find_var(n).numpy()
             for n in sorted(v.name for v in main.list_vars()
                             if v.persistable)}
    return losses, first, state, gens


@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("entry", ["run", "prepare"])
def test_recompute_at_dropout_is_bit_for_bit_the_plain_step(entry, fused):
    rng = np.random.RandomState(1)
    batches = [tbert.make_fake_batch(rng, _cfg(tbert, 0.1), batch_size=2,
                                     seq_len=64, num_masks=5)
               for _ in range(3)]
    plain = _port_run(False, entry, fused, batches)
    recomputed = _port_run(True, entry, fused, batches)
    for what, a, b in zip(("losses", "step-1 grads", "state", "generator"),
                          plain, recomputed):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            a, b = list(a.values()), list(b.values())
        for i, (x, y) in enumerate(zip(a, b)):
            assert np.array_equal(x, y), (what, i)


def _saved_bytes(recompute):
    _, main, startup, total = _bert("port", recompute, dropout=0.1)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    batch = tbert.make_fake_batch(np.random.RandomState(2),
                                  _cfg(tbert, 0.1), batch_size=4,
                                  seq_len=128, num_masks=5)
    storages = {}

    def pack(t):
        s = t.untyped_storage()
        storages[s.data_ptr()] = s.nbytes()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        exe.run(main, feed=batch, fetch_list=[total], scope=scope)
    params = {scope.find_var(p.name).untyped_storage().data_ptr()
              for p in main.all_parameters()}
    return sum(n for p, n in storages.items() if p not in params)


def test_recompute_halves_what_autograd_keeps():
    plain, recomputed = _saved_bytes(False), _saved_bytes(True)
    assert plain > 0 and recomputed <= plain / 2, (plain, recomputed)


def test_fleet_strategy_recompute_sets_the_backward_checkpoints():
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        _, total, _, _ = tbert.build_pretrain_network(_cfg(tbert, 0.0))
        ckpts = layer_checkpoints(main)
        tfleet.init(UserDefinedRoleMaker(0, 1, place=tfluid.CPUPlace()))
        s = DistributedStrategy()
        s.recompute = True
        s.recompute_configs = {"checkpoints": ckpts}
        tfleet.distributed_optimizer(tfluid.optimizer.Adam(1e-3),
                                     s).minimize(total)
    bw, = [op for op in main.global_block().ops if op.type == "backward"]
    assert bw.attrs["checkpoints"] == ckpts
    segments = texecutor._segment_at_checkpoints(
        main.global_block().ops[:texecutor.backward_index(
            main.global_block().ops)], ckpts)
    assert len(segments) == len(ckpts) + 1
    assert [seg[-1].output("Y")[0] for seg in segments[:-1]] == ckpts
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    batch = tbert.make_fake_batch(np.random.RandomState(0),
                                  _cfg(tbert, 0.0), batch_size=2,
                                  seq_len=32, num_masks=3)
    out = [float(exe.run(main, feed=batch, fetch_list=[total],
                         scope=scope)[0]) for _ in range(3)]
    assert np.isfinite(out).all() and out[-1] < out[0]


@pytest.mark.parametrize("impl", ["upscale_in_train", "downgrade_in_infer"])
def test_dropout_at_rate_0_keeps_every_element(impl):
    """A dropout op at rate 0 is the identity and its mask all ones: the
    keep mask is a uniform [0, 1) draw below the keep probability, as
    ``jax.random.bernoulli`` draws it (``bernoulli_(1.0)`` on a CUDA
    tensor drops an element now and then, which put BERT-base gradient
    merge's micro-batches ~2 % of max|grad| off one whole-batch step on
    an H100).  At rate 0.1 about a tenth is dropped, the same elements for
    the same generator state."""
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op
    a = torch.randn(64, 1024, generator=torch.Generator().manual_seed(0))
    op = get_op("dropout")

    def run(p, seed):
        ctx = LoweringContext(torch.Generator().manual_seed(seed))
        return op(ctx, {"X": [a]}, {"dropout_prob": p,
                                    "dropout_implementation": impl})

    out = run(0.0, 1)
    assert torch.equal(out["Out"], a) and bool(out["Mask"].all())
    first, again = run(0.1, 2), run(0.1, 2)
    assert torch.equal(first["Mask"], again["Mask"])
    dropped = 1.0 - first["Mask"].float().mean().item()
    assert abs(dropped - 0.1) < 0.01
