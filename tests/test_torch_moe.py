"""Mixture-of-Experts through the port against the JAX package.

Ops: ``moe_dispatch`` -> ``moe_expert_ffn`` -> ``moe_combine``, the fused
``moe_ffn`` and ``c_expert_alltoall`` (the identity without its axis)
against the JAX ops on the same numpy inputs, at top-k 1 and 2, routing
groups auto and pinned, capacity factors 8.0 and 0.125 (an overflowing
group) and each activation: Xe, Combine, AuxLoss and Out within
:data:`TOL_OP`, and the gradients of x, GateW, W1, W2, B1 and B2 (torch
autograd against ``jax.grad`` of one scalar) within :data:`TOL_GRAD`.
The dense semantics of ``tests/test_moe.py`` (trains at top-1 and top-2,
aux 1 at uniform gates, capacity drops) hold in the port.

BERT-tiny MoE (hidden 64, 2 layers, 4 experts, top-2, capacity factor
2.0, dropout 0): the desc is the JAX package's, also after
``apply_expert_sharding``; 3 Adam steps on one rank through
``Executor.run`` and ``prepare(donate_state=True)`` (aux weight 0: the
one-device run the expert layouts are held to) and the fused program at
aux weight 0.01 (against the JAX program with ``fuse_add_layernorm``
only) hold to the JAX package's one-device run within :data:`TOL_RUN`.

Expert parallelism on gloo ranks of ``tests/torch_moe_runner.py`` (one
launch of two ranks and one of four, started before the JAX references
are computed): ``data 1 x expert 2``, ``data 2 x expert 2`` and ``fsdp 2
x expert 2`` at aux weight 0 against the JAX package's ONE-DEVICE run,
losses within :data:`TOL_EP` and parameters within :data:`TOL_RUN` (Adam
divides a near-zero gradient by its own root mean square, so a word
embedding row the batch barely touches moves by more).  The balance
statistics are each rank's own, so with the aux term on a layout is held
to the JAX run on the SAME layout over the virtual mesh, within
:data:`TOL_RUN`.  ZeRO-3 beside ``ep``
skips every expert weight as already sharded; the manual
``moe_ffn(ep_degree=2, axis_name="dp")`` under plain data parallelism
at top-k 1 and 2; the bf16 and int8 exchanges against the JAX runs on
the same layout and within the JAX test's loose bound of the dense run;
capacity drops bit-equal across two runs; a sharded checkpoint at
``expert 4`` restored onto ``data 2 x expert 2`` (the continuation
within :data:`TOL_EP` of the uninterrupted run) and onto one rank.
Adam turns the exactly-zero gradient of the key third of ``*_qkv_b``
into +-LR noise, so that third is left out of BERT's parameter checks.

Also: ``plan_stage_cuts`` never cuts inside a dispatch -> combine span;
the MoE decoder serves the JAX engine's greedy tokens, its logits within
:data:`TOL_RUN` of max|logit| of the JAX package's; ``ep`` beside
``tp``, ``sp`` or ``pp`` and the tensor/sequence-parallel builder with
``moe_experts`` are refused by name."""

import json
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import parallel as jparallel
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import pipe as jpipe
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.compiler import BuildStrategy as JBuildStrategy
from paddle_tpu.framework.compiler import CompiledProgram as JCompiled
from paddle_tpu.framework.mesh_layout import MeshLayout as JMeshLayout
from paddle_tpu.framework.passes import apply_pass as japply
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops import moe_ops as jmoe

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch import parallel as tparallel
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import pipe as tpipe
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.errors import UnimplementedError
from paddle_tpu_torch.framework.mesh_layout import MeshLayout, ProcessMesh
from paddle_tpu_torch.framework.passes import apply_pass as tapply
from paddle_tpu_torch.framework.serialization import (
    program_to_desc as tdesc)
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.registry import LoweringContext, get_op

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_moe_runner.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_moe_runner import (BERT_LR, CLIPPED, FFN, GROUP, SGD_LR,  # noqa
                              STEPS, TOY_LR, E, M)

TOL_OP = 1e-6        # op outputs
TOL_GRAD = 1e-5      # op gradients
TOL_RUN = 1e-5       # one rank, and a layout against the JAX layout
TOL_EP = 1e-6        # expert layouts against one device (aux 0)
LAUNCH_TIMEOUT_S = 300
LEGS2 = ("ep2", "toy_ep2_aux", "toy_ep2_bf16", "toy_ep2_int8",
         "manual_k1", "manual_k2", "drops", "ep2_clip", "manual_k2_clip")
LEGS4 = ("dp2ep2", "dp2ep2_aux", "fsdp2ep2", "ckpt", "fsdp2ep2_clip")
BERT_BATCH, BERT_SEQ, BERT_MASKS = 8, 32, 5


# ---------------------------------------------------------------------------
# the ops
# ---------------------------------------------------------------------------

OP_CASES = {
    "k1-g0-cf8-gelu": (1, 0, 8.0, "gelu"),
    "k2-g8-cf8-relu": (2, 8, 8.0, "relu"),
    "k1-g8-cf0.125-silu": (1, 8, 0.125, "silu"),
    "k2-g0-cf0.125-gelu": (2, 0, 0.125, "gelu"),
}
OP_E, OP_M, OP_H = 8, 8, 16
WEIGHT_NAMES = ("x", "GateW", "W1", "W2", "B1", "B2")


def _op_inputs(seed):
    rng = np.random.RandomState(seed)
    return [rng.randn(*s).astype(np.float32) * sc for s, sc in (
        ((4, 8, OP_M), 1.0), ((OP_M, OP_E), 1.0),
        ((OP_E, OP_M, OP_H), 0.3), ((OP_E, OP_H, OP_M), 0.3),
        ((OP_E, OP_H), 0.1), ((OP_E, OP_M), 0.1))], \
        rng.randn(4, 8, OP_M).astype(np.float32)


def _attrs(top_k, group, cf):
    return {"num_experts": OP_E, "top_k": top_k, "capacity_factor": cf,
            "group_size": group}


def _jax_pipeline(args, attrs, act):
    xa, gw, w1, w2, b1, b2 = args
    d = jmoe._moe_dispatch(None, {"X": [xa], "GateW": [gw]}, attrs)
    ye = jmoe._moe_expert_ffn(None, {"Xe": [d["Xe"]], "W1": [w1],
                                     "W2": [w2], "B1": [b1], "B2": [b2]},
                              {"act": act})["Out"]
    out = jmoe._moe_combine(None, {"Ye": [ye], "Combine": [d["Combine"]],
                                   "X": [xa]}, {})["Out"]
    return d, out


def _port_pipeline(args, attrs, act):
    xa, gw, w1, w2, b1, b2 = args
    ctx = LoweringContext()
    d = get_op("moe_dispatch")(ctx, {"X": [xa], "GateW": [gw]}, attrs)
    ye = get_op("moe_expert_ffn")(ctx, {"Xe": [d["Xe"]], "W1": [w1],
                                        "W2": [w2], "B1": [b1], "B2": [b2]},
                                  {"act": act})["Out"]
    out = get_op("moe_combine")(ctx, {"Ye": [ye], "Combine": [d["Combine"]],
                                      "X": [xa]}, {})["Out"]
    return d, out


@pytest.mark.parametrize("case", list(OP_CASES))
def test_moe_ops_match_the_jax_ops(case):
    top_k, group, cf, act = OP_CASES[case]
    arrays, probe = _op_inputs(list(OP_CASES).index(case))
    attrs = _attrs(top_k, group, cf)

    def jloss(*args):
        d, out = _jax_pipeline(args, attrs, act)
        return jnp.sum(out * probe) + 0.5 * d["AuxLoss"]

    jd, jout = jax.jit(lambda *a: _jax_pipeline(a, attrs, act))(
        *[jnp.asarray(a) for a in arrays])
    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *[jnp.asarray(a) for a in arrays])
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    td, tout = _port_pipeline(targs, attrs, act)
    for slot, got in (("Xe", td["Xe"]), ("Combine", td["Combine"]),
                      ("AuxLoss", td["AuxLoss"])):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(jd[slot]),
                                   rtol=0, atol=TOL_OP, err_msg=slot)
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=0, atol=TOL_OP)
    loss = (tout * torch.from_numpy(probe)).sum() + 0.5 * td["AuxLoss"]
    tgrads = torch.autograd.grad(loss, targs)
    for name, g, jg in zip(WEIGHT_NAMES, tgrads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=name)
    # the overflowing cases drop: fewer dispatched slots than choices
    slots = float(td["Combine"].detach().ne(0).sum())
    assert (slots < 32 * top_k) == (cf < 1.0), (case, slots)


@pytest.mark.parametrize("case", ["k2-g8-cf8-relu", "k1-g8-cf0.125-silu"])
def test_fused_moe_ffn_matches_the_jax_function(case):
    top_k, group, cf, act = OP_CASES[case]
    arrays, probe = _op_inputs(7)
    kw = dict(top_k=top_k, capacity_factor=cf, act=act, group_size=group)
    flat = probe.reshape(-1, OP_M)

    def jloss(*args):
        out, aux = jmoe.moe_ffn_fn(args[0].reshape(-1, OP_M), *args[1:],
                                   **kw)
        return jnp.sum(out * flat) + 0.5 * aux

    jargs = [jnp.asarray(a) for a in arrays]
    jout, jaux = jax.jit(lambda *a: jmoe.moe_ffn_fn(
        a[0].reshape(-1, OP_M), *a[1:], **kw))(*jargs)
    jgrads = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(*jargs)
    targs = [torch.from_numpy(a.copy()).requires_grad_(True) for a in arrays]
    out = get_op("moe_ffn")(LoweringContext(), {
        "X": [targs[0]], "GateW": [targs[1]], "W1": [targs[2]],
        "W2": [targs[3]], "B1": [targs[4]], "B2": [targs[5]]},
        dict(kw, num_experts=OP_E))
    np.testing.assert_allclose(out["Out"].detach().numpy().reshape(-1, OP_M),
                               np.asarray(jout), rtol=0, atol=TOL_OP)
    np.testing.assert_allclose(float(out["AuxLoss"].detach()), float(jaux),
                               rtol=0,
                               atol=TOL_OP)
    loss = (out["Out"].reshape(-1, OP_M) * torch.from_numpy(flat)).sum() + \
        0.5 * out["AuxLoss"]
    for name, g, jg in zip(WEIGHT_NAMES, torch.autograd.grad(loss, targs),
                           jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=TOL_GRAD,
                                   atol=TOL_GRAD, err_msg=name)


def test_expert_alltoall_is_the_identity_without_its_axis():
    """Off mesh, or over an axis the run lacks, the exchange passes its
    input through in both packages (the one-rank restore of an ep
    checkpoint runs the stamped program so); the dispatch runs on
    ``meta`` tensors, as the stage-cut planner runs it."""
    a = np.random.RandomState(0).randn(8, 12, 4).astype(np.float32)
    attrs = {"ring_id": 0, "_axis_name": "ep", "direction": "dispatch",
             "quant_spec": {"dtype": "int8", "block_size": 256,
                            "stochastic_rounding": False}}
    jctx = types.SimpleNamespace(axis_names=(), mesh=None)
    jout = jmoe._c_expert_alltoall(jctx, {"X": [jnp.asarray(a)]}, attrs)
    tout = get_op("c_expert_alltoall")(LoweringContext(),
                                       {"X": [torch.from_numpy(a)]}, attrs)
    np.testing.assert_array_equal(tout["Out"].numpy(), np.asarray(jout["Out"]))
    np.testing.assert_array_equal(tout["Out"].numpy(), a)
    meta = get_op("moe_dispatch")(LoweringContext(), {
        "X": [torch.empty(4, 8, OP_M, device="meta")],
        "GateW": [torch.empty(OP_M, OP_E, device="meta")]},
        _attrs(2, 8, 0.125))
    assert tuple(meta["Xe"].shape) == (OP_E, 4 * 1, OP_M)
    assert tuple(meta["Combine"].shape) == (4, 8, OP_E, 1)


# ---------------------------------------------------------------------------
# the dense semantics of tests/test_moe.py, in the port
# ---------------------------------------------------------------------------


def _toy_run(steps, top_k=2, cf=8.0, batch=8, seed=0):
    from torch_moe_runner import toy_model
    tcore.reset_default_programs()
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        loss, aux, _ = toy_model(top_k=top_k, cf=cf)
        tfluid.optimizer.SGD(SGD_LR).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    rng = np.random.RandomState(seed)
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    losses, auxes = [], []
    for _ in range(steps):
        f = rng.uniform(-1, 1, (batch, 4, M)).astype(np.float32)
        lo, a = exe.run(main, feed={"x": f}, fetch_list=[loss, aux],
                        scope=scope)
        losses.append(float(lo))
        auxes.append(float(a))
    return losses, auxes


def test_moe_dense_trains():
    losses, auxes = _toy_run(4)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert all(a >= 0.99 for a in auxes)


def test_moe_top1_trains():
    losses, _ = _toy_run(4, top_k=1)
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]


def _single_block(top_k, cf, init, num_experts=E):
    tcore.reset_default_programs()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4, M])
        out, aux = tparallel.moe_ffn(
            x, num_experts=num_experts, ffn_hidden=FFN, top_k=top_k,
            capacity_factor=cf, param_attr=tfluid.ParamAttr(
                initializer=init))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    return main, exe, scope, out, aux


def test_moe_aux_balanced_at_uniform_gates():
    """A zero gate weight gives a uniform softmax: the aux loss is E *
    (1/E * 1) = 1 (all top-1 traffic ties to expert 0)."""
    main, exe, scope, _, aux = _single_block(
        1, 50.0, tfluid.initializer.ConstantInitializer(0.0))
    xb = np.random.RandomState(0).rand(8, 4, M).astype(np.float32)
    a, = exe.run(main, feed={"x": xb}, fetch_list=[aux], scope=scope)
    assert abs(float(a) - 1.0) < 1e-5


def test_moe_capacity_drops_tokens():
    """A tiny capacity: overflowing tokens get a zero output (they pass
    through the surrounding residual)."""
    main, exe, scope, out, _ = _single_block(
        1, 0.125, tfluid.initializer.UniformInitializer(-0.5, 0.5, seed=3),
        num_experts=2)
    xb = np.random.RandomState(1).uniform(-1, 1, (8, 4, M)).astype(
        np.float32)
    o, = exe.run(main, feed={"x": xb}, fetch_list=[out], scope=scope)
    zero = np.all(np.asarray(o).reshape(-1, M) == 0.0, axis=-1)
    assert zero.any() and (~zero).any()


# ---------------------------------------------------------------------------
# BERT-tiny MoE on one rank
# ---------------------------------------------------------------------------


def _bert_cfg(mod, aux=0.01):
    return mod.BertConfig(
        vocab_size=1024, hidden_size=64, num_hidden_layers=2,
        num_attention_heads=2, intermediate_size=128,
        max_position_embeddings=64, hidden_dropout_prob=0.0,
        attention_probs_dropout_prob=0.0, moe_experts=4,
        moe_aux_weight=aux)


def _build_bert(mod, core, un, fluid, aux=0.01, apply_pass=None,
                clip=None):
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = 7
    with core.program_guard(main, startup):
        _, total, _, _ = mod.build_pretrain_network(_bert_cfg(mod, aux))
        fluid.optimizer.Adam(
            BERT_LR, grad_clip=fluid.clip.GradientClipByGlobalNorm(clip)
            if clip else None).minimize(total)
    if apply_pass is not None:
        apply_pass(main, "fuse_add_layernorm", fetch_names=[total.name])
    return main, startup, total


def _bert_batches():
    rng = np.random.RandomState(0)
    return [jbert.make_fake_batch(rng, _bert_cfg(jbert), BERT_BATCH,
                                  BERT_SEQ, BERT_MASKS)
            for _ in range(STEPS)]


def _jax_train(main, startup, loss, feeds, layout=None, quant=None,
               init=None):
    """The JAX package's run of ``main`` (over ``layout``'s virtual mesh
    after ``apply_expert_sharding``): (losses, the parameters it starts
    from, the final state)."""
    prog = main
    if layout is not None:
        jparallel.apply_expert_sharding(main, layout, quant_spec=quant)
        main._mesh_layout = layout
        bs = JBuildStrategy()
        bs.fuse_all_reduce_ops = True
        prog = JCompiled(main).with_mesh(
            layout.build_mesh(), loss_name=loss.name,
            batch_axis=layout.batch_axes, build_strategy=bs)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        if init is not None:
            for n, v in init.items():
                scope.set_var(n, np.array(v))
        start = {p.name: np.asarray(scope.find_var(p.name)).copy()
                 for p in main.all_parameters()}
        losses = [float(np.asarray(exe.run(prog, feed=f,
                                           fetch_list=[loss])[0]).reshape(-1)
                        [0]) for f in feeds]
        final = {n: np.asarray(scope.find_var(n)).copy()
                 for n in scope.var_names()
                 if scope.find_var(n) is not None}
    return np.array(losses), start, final


def _toy_jax(sizes=None, aux=0.0, quant=None, init=None, feeds=None,
             top_k=2, opt="adam", ep=None, group=GROUP, clip=None):
    L = jfluid.layers
    jun.reset()
    jcore.reset_default_programs()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = L.data("x", shape=[4, M])
        out, a = jparallel.moe_ffn(
            x, num_experts=E, ffn_hidden=FFN, top_k=top_k,
            capacity_factor=8.0, ep_degree=ep, axis_name="dp",
            group_size=group, param_attr=jfluid.ParamAttr(
                initializer=jfluid.initializer.UniformInitializer(
                    -0.5, 0.5, seed=7)))
        loss = L.mean(L.square(out))
        if aux:
            loss = L.elementwise_add(loss, L.scale(a, scale=aux))
        gc = jfluid.clip.GradientClipByGlobalNorm(clip) if clip else None
        (jfluid.optimizer.Adam(TOY_LR, grad_clip=gc) if opt == "adam"
         else jfluid.optimizer.SGD(SGD_LR, grad_clip=gc)).minimize(loss)
    layout = JMeshLayout(**sizes) if sizes else None
    return _jax_train(main, startup, loss, feeds, layout, quant, init)


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The inputs the ranks run (written to IN.npz, the two launches
    started at once), then the JAX package's runs, each made when first
    asked for."""
    arrays = {}
    batches = _bert_batches()
    for i, b in enumerate(batches):
        arrays.update({f"bert/b{i}/{k}": v for k, v in b.items()})
    main, startup, _ = _build_bert(jbert, jcore, jun, jfluid)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        bert_init = {p.name: np.asarray(scope.find_var(p.name)).copy()
                     for p in main.all_parameters()}
    arrays.update({f"bert/init/{n}": v for n, v in bert_init.items()})
    rng = np.random.RandomState(0)
    toy_feeds = [{"x": rng.uniform(-1, 1, (8, 4, M)).astype(np.float32)}
                 for _ in range(2 * STEPS)]
    for i, f in enumerate(toy_feeds):
        arrays[f"toy/x{i}"] = f["x"]
    arrays["drops/x"] = np.random.RandomState(1).uniform(
        -1, 1, (8, 4, M)).astype(np.float32)
    # the toy's parameters (every build of it declares the same names)
    _, toy_init, _ = _toy_jax(feeds=[])
    arrays.update({f"toy/init/{n}": v for n, v in toy_init.items()})
    tmp = tmp_path_factory.mktemp("moe")
    np.savez(tmp / "in.npz", **arrays)
    procs = {n: _start(tmp, n, legs) for n, legs in ((2, LEGS2),
                                                     (4, LEGS4))}
    cache = {"batches": batches, "bert_init": bert_init,
             "toy_feeds": toy_feeds, "toy_init": toy_init, "tmp": tmp}

    def get(key):
        if key not in cache:
            cache[key] = _REFS[key](cache)
        return cache[key]

    get.procs = procs
    get.ranks = {}
    yield get
    for p, _ in procs.values():
        if p.poll() is None:
            p.kill()


@pytest.fixture(scope="module", autouse=True)
def _launched(refs):
    """The ranks start before the first test, beside the JAX runs."""
    yield


def _start(tmp, nproc, legs):
    out_dir = tmp / f"out{nproc}"
    out_dir.mkdir(exist_ok=True)
    log = open(tmp / f"log{nproc}.txt", "w")
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, ",".join(legs),
           str(tmp / "in.npz"), str(out_dir)]
    proc = subprocess.Popen(cmd, cwd=REPO, stdout=log,
                            stderr=subprocess.STDOUT,
                            env=dict(os.environ, OMP_NUM_THREADS="1"))
    return proc, out_dir


def _ranks(refs, leg):
    n = 2 if leg in LEGS2 else 4
    if n not in refs.ranks:
        proc, out_dir = refs.procs[n]
        rc = proc.wait(timeout=LAUNCH_TIMEOUT_S + 60)
        log = (out_dir.parent / f"log{n}.txt").read_text()
        assert rc == 0, log[-6000:]
        refs.ranks[n] = [dict(np.load(out_dir / f"rank{r}.npz"))
                         for r in range(n)]
    return refs.ranks[n]


def _bert_ref(cache, aux, fused=False, layout=None, clip=None):
    main, startup, total = _build_bert(
        jbert, jcore, jun, jfluid, aux, japply if fused else None, clip)
    return _jax_train(main, startup, total, cache["batches"], layout,
                      init=cache["bert_init"])


_REFS = {
    "bert_fused": lambda c: _bert_ref(c, 0.01, fused=True),
    "bert_aux0": lambda c: _bert_ref(c, 0.0),
    "bert_dp2ep2_aux": lambda c: _bert_ref(
        c, 0.01, layout=JMeshLayout(data=2, expert=2)),
    "toy": lambda c: _toy_jax(init=c["toy_init"],
                              feeds=c["toy_feeds"][:STEPS]),
    "toy_ep2_aux": lambda c: _toy_jax(
        {"expert": 2}, aux=0.01, init=c["toy_init"],
        feeds=c["toy_feeds"][:STEPS]),
    "toy_ep2_bf16": lambda c: _toy_jax(
        {"expert": 2}, quant="bfloat16", init=c["toy_init"],
        feeds=c["toy_feeds"][:STEPS]),
    "toy_ep2_int8": lambda c: _toy_jax(
        {"expert": 2}, quant="int8", init=c["toy_init"],
        feeds=c["toy_feeds"][:STEPS]),
    "manual_k1": lambda c: _toy_jax(
        init=c["toy_init"], feeds=c["toy_feeds"][:STEPS],
        top_k=1, opt="sgd", group=0),
    "manual_k2": lambda c: _toy_jax(
        init=c["toy_init"], feeds=c["toy_feeds"][:STEPS],
        opt="sgd", group=0),
    "bert_aux0_clip": lambda c: _bert_ref(c, 0.0, clip=CLIPPED["ep2_clip"]),
    "manual_k2_clip": lambda c: _toy_jax(
        init=c["toy_init"], feeds=c["toy_feeds"][:STEPS],
        opt="sgd", group=0, clip=CLIPPED["manual_k2_clip"]),
}


def _zero_grad_third(name, value):
    """BERT's ``*_qkv_b`` without its key third (its gradient is exactly
    zero and Adam turns it into +-LR noise); other values whole."""
    if not name.endswith("_qkv_b"):
        return value
    d = value.shape[-1] // 3
    return np.concatenate([value[..., :d], value[..., 2 * d:]], -1)


def _check_params(got, want, names, tol):
    for n in names:
        np.testing.assert_allclose(_zero_grad_third(n, got[n]),
                                   _zero_grad_third(n, want[n]), rtol=tol,
                                   atol=tol, err_msg=n)


def _port_bert_scope(ref_init, main):
    scope = tfluid.Scope()
    for n, t in tio.convert_params(
            {n: ref_init[n] for n in (p.name for p in
                                      main.all_parameters())},
            "cpu").items():
        scope.set_var(n, t)
    return scope


@pytest.fixture(autouse=True)
def _fresh_port_state():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    tcore.reset_default_programs()


@pytest.mark.parametrize("sharded", [False, True])
def test_moe_bert_desc_is_the_jax_packages(sharded):
    jmain, _, _ = _build_bert(jbert, jcore, jun, jfluid)
    tmain, _, _ = _build_bert(tbert, tcore, tun, tfluid)
    if sharded:
        jrep = jparallel.apply_expert_sharding(jmain,
                                               JMeshLayout(data=2, expert=2))
        trep = tparallel.apply_expert_sharding(tmain,
                                               MeshLayout(data=2, expert=2))
        assert trep["stamped"] == jrep["stamped"] and trep["stamped"]
        assert len(trep["rewritten"]) == 2
    assert json.dumps(tdesc(tmain), sort_keys=True, default=str) == \
        json.dumps(jdesc(jmain), sort_keys=True, default=str)


def _port_bert_run(refs, entry, fused=False):
    main, startup, total = _build_bert(tbert, tcore, tun, tfluid,
                                       0.01 if fused else 0.0,
                                       tapply if fused else None)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, t in tio.convert_params(
            {p.name: refs("bert_init")[p.name]
             for p in main.all_parameters()}, "cpu").items():
        scope.set_var(n, t)
    prog = main
    if fused:
        bs = tfluid.BuildStrategy()
        bs.fuse_elewise_add_act_ops = True
        prog = tfluid.CompiledProgram(main).with_data_parallel(
            loss_name=total.name, build_strategy=bs)
    if entry == "run":
        losses = [float(exe.run(prog, feed=b, fetch_list=[total],
                                scope=scope)[0])
                  for b in refs("batches")]
    else:
        prepared = exe.prepare(prog, fetch_list=[total], scope=scope,
                               donate_state=True)
        losses = [float(prepared.run(b)[0]) for b in refs("batches")]
        tfluid.sync_prepared_state(scope)
    return main, np.array(losses), {p.name: scope.find_var(p.name).numpy()
                                    for p in main.all_parameters()}


@pytest.mark.parametrize("entry", ["run", "prepare"])
def test_moe_bert_trains_like_the_jax_package(refs, entry):
    _, losses, params = _port_bert_run(refs, entry)
    jl, _, jfinal = refs("bert_aux0")
    np.testing.assert_allclose(losses, jl, rtol=0, atol=TOL_RUN)
    _check_params(params, jfinal, params, TOL_RUN)
    # on the CPU the routes run their plain versions: nothing launches
    assert registry.route_counts("hit")
    assert not any(port_cuda.launch_counts().values())


def test_moe_bert_fused_program_trains_like_the_jax_package(refs):
    _, losses, params = _port_bert_run(refs, "run", fused=True)
    jl, _, jfinal = refs("bert_fused")
    np.testing.assert_allclose(losses, jl, rtol=0, atol=TOL_RUN)
    _check_params(params, jfinal, params, TOL_RUN)


# ---------------------------------------------------------------------------
# expert parallelism on gloo ranks
# ---------------------------------------------------------------------------


def _leg_params(rank_out, leg):
    pre = f"{leg}/p/"
    return {k[len(pre):]: v for k, v in rank_out.items()
            if k.startswith(pre)}


def _same_on_every_rank(ranks, leg):
    for r in ranks[1:]:
        np.testing.assert_array_equal(r[f"{leg}/losses"],
                                      ranks[0][f"{leg}/losses"])


@pytest.mark.parametrize("leg", ["ep2", "dp2ep2", "fsdp2ep2"])
def test_expert_parallel_bert_matches_one_device(refs, leg):
    ranks = _ranks(refs, leg)
    _same_on_every_rank(ranks, leg)
    jl, _, jfinal = refs("bert_aux0")
    np.testing.assert_allclose(ranks[0][f"{leg}/losses"], jl, rtol=0,
                               atol=TOL_EP)
    params = _leg_params(ranks[0], leg)
    _check_params(params, jfinal, params, TOL_RUN)
    stamped = json.loads(str(ranks[0][f"{leg}/stamped"]))
    assert len(stamped) == 8          # W1, W2, B1, B2 of both layers
    assert int(ranks[0][f"{leg}/exchanges"]) == 4


def test_zero3_beside_ep_skips_every_expert_weight(refs):
    ranks = _ranks(refs, "fsdp2ep2")
    stamped = set(json.loads(str(ranks[0]["fsdp2ep2/stamped"])))
    sharded = set(json.loads(str(ranks[0]["fsdp2ep2/fsdp_sharded"])))
    skipped = {n for n, why in json.loads(
        str(ranks[0]["fsdp2ep2/fsdp_skipped"])) if why == "already-sharded"}
    assert sharded and not (stamped & sharded)
    assert skipped >= stamped


def test_expert_parallel_bert_with_aux_matches_the_jax_layout(refs):
    """aux weight 0.01 over data 2 x expert 2: each rank's balance
    statistics are its own tokens', as on the JAX mesh."""
    ranks = _ranks(refs, "dp2ep2_aux")
    _same_on_every_rank(ranks, "dp2ep2_aux")
    jl, _, jfinal = refs("bert_dp2ep2_aux")
    np.testing.assert_allclose(ranks[0]["dp2ep2_aux/losses"], jl, rtol=0,
                               atol=TOL_RUN)
    params = _leg_params(ranks[0], "dp2ep2_aux")
    _check_params(params, jfinal, params, TOL_RUN)


def test_toy_expert_parallel_with_aux_matches_the_jax_layout(refs):
    ranks = _ranks(refs, "toy_ep2_aux")
    jl, _, jfinal = refs("toy_ep2_aux")
    np.testing.assert_allclose(ranks[0]["toy_ep2_aux/losses"], jl, rtol=0,
                               atol=TOL_RUN)
    params = _leg_params(ranks[0], "toy_ep2_aux")
    _check_params(params, jfinal, params, TOL_RUN)


@pytest.mark.parametrize("tier", ["bf16", "int8"])
def test_quantized_exchange_matches_the_jax_layout(refs, tier):
    leg = f"toy_ep2_{tier}"
    ranks = _ranks(refs, leg)
    _same_on_every_rank(ranks, leg)
    losses = ranks[0][f"{leg}/losses"]
    jl, _, jfinal = refs(leg)
    np.testing.assert_allclose(losses, jl, rtol=0, atol=TOL_RUN)
    params = _leg_params(ranks[0], leg)
    _check_params(params, jfinal, params, TOL_RUN)
    dense, _, _ = refs("toy")
    assert losses[-1] < losses[0] * 1.05
    np.testing.assert_allclose(dense, losses, rtol=0.05, atol=0.01)


@pytest.mark.parametrize("top_k", [1, 2])
def test_manual_ep_degree_under_data_parallelism(refs, top_k):
    leg = f"manual_k{top_k}"
    ranks = _ranks(refs, leg)
    _same_on_every_rank(ranks, leg)
    jl, _, jfinal = refs(leg)
    np.testing.assert_allclose(ranks[0][f"{leg}/losses"], jl, rtol=0,
                               atol=TOL_EP)
    params = _leg_params(ranks[0], leg)
    _check_params(params, jfinal, params, TOL_RUN)


@pytest.mark.parametrize("leg,ref,free,groups", [
    ("ep2_clip", "bert_aux0_clip", "bert_aux0", 1),
    ("fsdp2ep2_clip", "bert_aux0_clip", "bert_aux0", 2),
    ("manual_k2_clip", "manual_k2_clip", "manual_k2", 1)])
def test_global_norm_clip_under_ep_is_the_one_device_clip(refs, leg, ref,
                                                          free, groups):
    """A global-norm clip that binds beside expert parallelism, through
    ``apply_expert_sharding`` (then ZeRO-3 under fsdp 2 x expert 2) and
    through a manual ``moe_ffn(ep_degree=2)`` build: the squares of the
    expert gradients (each rank's blocks) are all-reduced over the expert
    axis, and those of the ZeRO-3 blocks over fsdp, before the root, so
    every rank lands within 1e-6 of the JAX package's one-device run."""
    ranks = _ranks(refs, leg)
    _same_on_every_rank(ranks, leg)
    jl, _, jfinal = refs(ref)
    np.testing.assert_allclose(ranks[0][f"{leg}/losses"], jl, rtol=0,
                               atol=1e-6)
    params = _leg_params(ranks[0], leg)
    _check_params(params, jfinal, params, TOL_RUN)
    assert list(ranks[0][f"{leg}/types"]).count(
        "c_global_norm_allreduce") == groups
    unclipped, _, _ = refs(free)
    assert np.abs(np.asarray(jl) - unclipped).max() > 1e-6


def test_capacity_drops_are_deterministic(refs):
    r = _ranks(refs, "drops")[0]
    a, b = r["drops/a"], r["drops/b"]
    zero = np.all(a.reshape(-1, M) == 0.0, axis=-1)
    assert zero.any() and (~zero).any(), "want a mixed drop pattern"
    np.testing.assert_array_equal(a, b)


def test_ep4_checkpoint_restores_onto_dp2ep2(refs):
    ranks = _ranks(refs, "ckpt")
    r = ranks[0]
    np.testing.assert_array_equal(r["ckpt/before"], r["ckpt/ref"][:STEPS])
    man = json.loads(str(r["ckpt/manifest"]))
    assert dict(man["mesh_layout"]["axes"]).get("ep") == 4
    assert any("ep" in str(s) for s in man["shard_specs"].values())
    rs = json.loads(str(r["ckpt/reshard"]))
    assert rs["src"]["ep"] == 4 and rs["dst"]["ep"] == 2
    for rank in ranks:
        np.testing.assert_allclose(rank["ckpt/after"], r["ckpt/ref"][STEPS:],
                                   rtol=TOL_EP, atol=TOL_EP)


def test_ep_checkpoint_writes_each_expert_block_once(refs):
    """Over the four ranks' shard manifests: every expert-stamped
    persistable (the expert weights and biases, their Adam moments) is
    written as its four dim-0 blocks, each once; every other persistable
    whole, once."""
    r = _ranks(refs, "ckpt")[0]
    d = str(r["ckpt/dir"])
    rows = {}
    for fn in sorted(os.listdir(d)):
        if fn.startswith("shard_manifest_"):
            with open(os.path.join(d, fn)) as f:
                m = json.load(f)
            for name, rec in m["vars"].items():
                for sh in rec["shards"]:
                    idx = sh["index"]
                    rows.setdefault(name, []).append(
                        tuple(idx[0]) if idx else None)
    stamped = {n for n, spec in json.loads(str(r["ckpt/manifest"]))
               ["shard_specs"].items() if "ep" in str(spec)}
    assert {"moe_ffn_0.w_1", "moe_ffn_0.w_2", "moe_ffn_0.b_0",
            "moe_ffn_0.b_1"} <= stamped
    for n, blocks in rows.items():
        if n in stamped:
            assert sorted(blocks) == [(2 * i, 2 * i + 2) for i in range(4)], n
        else:
            assert blocks == [None], n


def test_ep_checkpoint_restores_onto_one_rank(refs):
    """The expert-4 checkpoint loads whole into a one-rank program (the
    exchange is then the identity) and takes step 4 as the ranks did."""
    r = _ranks(refs, "ckpt")[0]
    from torch_moe_runner import toy_model
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        loss, _, _ = toy_model(group_size=GROUP)
        tfluid.optimizer.Adam(TOY_LR).minimize(loss)
    tparallel.apply_expert_sharding(main, MeshLayout(expert=4))
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    tio.load_checkpoint(exe, os.path.dirname(str(r["ckpt/dir"])),
                        main_program=main, scope=scope)
    for p in main.all_parameters():
        np.testing.assert_array_equal(scope.find_var(p.name).numpy(),
                                      r[f"ckpt/saved/{p.name}"], p.name)
    lo = float(exe.run(main, feed=refs("toy_feeds")[STEPS],
                       fetch_list=[loss], scope=scope)[0])
    np.testing.assert_allclose(lo, r["ckpt/ref"][STEPS], rtol=TOL_EP,
                               atol=TOL_EP)


# ---------------------------------------------------------------------------
# the stage-cut rule, the decoder, the refusals
# ---------------------------------------------------------------------------


def _two_moe_blocks(fluid, par, core, un):
    L = fluid.layers
    un.reset()
    main, startup = core.Program(), core.Program()

    def attr(seed):
        return fluid.ParamAttr(initializer=fluid.initializer.
                               UniformInitializer(-0.5, 0.5, seed=seed))

    with core.program_guard(main, startup):
        x = L.data("x", shape=[4, M])
        h = L.fc(x, M, act="relu", param_attr=attr(11))
        h, a1 = par.moe_ffn(h, num_experts=4, ffn_hidden=FFN, top_k=2,
                            capacity_factor=8.0, param_attr=attr(12),
                            name="moe_a")
        h = L.fc(h, M, act="relu", param_attr=attr(13))
        h, a2 = par.moe_ffn(h, num_experts=4, ffn_hidden=FFN, top_k=2,
                            capacity_factor=8.0, param_attr=attr(14),
                            name="moe_b")
        loss = L.mean(L.square(h))
        loss = L.elementwise_add(loss, L.scale(L.elementwise_add(a1, a2),
                                               scale=0.01))
        fluid.optimizer.Adam(5e-3).minimize(loss)
    return main


def test_plan_stage_cuts_respects_moe_span():
    """Two MoE blocks cut into two stages: no cut lands inside a dispatch
    -> combine span, and the plan is the JAX package's."""
    main = _two_moe_blocks(tfluid, tparallel, tcore, tun)
    shapes = {"x": ((8, 4, M), "float32")}
    plan = tpipe.plan_stage_cuts(main, 2, feed_shapes=shapes)
    assert len(plan.cuts) == 1
    block, ops, bw_idx = tpipe._fwd_region(main)
    fwd_ops = ops[:bw_idx]
    def_idx, _ = tpipe._fwd_liveness(block, fwd_ops)
    spans = tpipe._moe_forbidden(block, fwd_ops, def_idx)
    assert spans
    assert len([op for op in fwd_ops if op.type == "moe_combine"]) == 2
    assert not (set(plan.cuts) & spans)
    jmain = _two_moe_blocks(jfluid, jparallel, jcore, jun)
    jplan = jpipe.plan_stage_cuts(jmain, 2, feed_shapes=shapes)
    assert list(plan.cuts) == list(jplan.cuts)
    assert plan.stage_flops == pytest.approx(jplan.stage_flops)


DEC_WIDTHS = dict(vocab_size=512, hidden_size=64, num_hidden_layers=2,
                  num_attention_heads=2, intermediate_size=128,
                  max_position_embeddings=64, type_vocab_size=2,
                  initializer_range=0.5, moe_experts=4)
DEC_CONFIG = dict(block_size=4, max_seq_len=32, max_batch_size=2,
                  prefill_seq_buckets=(8,), prefill_batch_buckets=(1,),
                  pack_max_segments=1, max_new_tokens=6)


def test_moe_decoder_serves_the_jax_engines_tokens():
    from paddle_tpu.models.decoder import BertDecoder as JDecoder
    from paddle_tpu.serving import DecodeConfig as JDecodeConfig
    from paddle_tpu.serving import DecodeEngine as JDecodeEngine
    from paddle_tpu_torch import CPUPlace
    from paddle_tpu_torch.models import BertDecoder
    from paddle_tpu_torch.serving import DecodeConfig, DecodeEngine
    rng = np.random.RandomState(17)
    prompts = [rng.randint(0, 512, (n,)).astype(np.int64) for n in (5, 7)]
    jcfg = jbert.BertConfig(**DEC_WIDTHS)
    build = dict(num_blocks=32, block_size=4, max_blocks_per_seq=8)
    assert json.dumps(jdesc(JDecoder(jcfg, seed=3).build(**build).decode),
                      sort_keys=True, default=str) == json.dumps(tdesc(
                          BertDecoder(tbert.BertConfig(**DEC_WIDTHS),
                                      seed=3).build(**build).decode),
                          sort_keys=True, default=str)
    jeng = JDecodeEngine(JDecoder(jcfg, seed=3), JDecodeConfig(**DEC_CONFIG))
    try:
        jtok = [jeng.generate({"src_ids": p}, max_new_tokens=6)
                .result(timeout=300).tokens.tolist() for p in prompts]
        params = {n: np.asarray(jeng._ref_scope.find_var(n))
                  for n in jeng._ref_scope.var_names()
                  if jeng._programs.startup.global_block().has_var(n)}
        jlogits = [_score_logits(jeng, np.concatenate([p, t[:-1]]))
                   for p, t in zip(prompts, jtok)]
    finally:
        jeng.shutdown()
    model = BertDecoder(tbert.BertConfig(**DEC_WIDTHS), seed=3)
    assert model.cache_layout_key(4) == JDecoder(jcfg, seed=3) \
        .cache_layout_key(4)
    eng = DecodeEngine(model, DecodeConfig(**DEC_CONFIG), place=CPUPlace(),
                       auto_start=False)
    eng.set_params(params)
    eng.start()
    try:
        for p, want, jl in zip(prompts, jtok, jlogits):
            res = eng.generate({"src_ids": p}, max_new_tokens=6) \
                .result(timeout=300)
            assert res.tokens.tolist() == want
            ref = eng.greedy_reference({"src_ids": p}, max_new_tokens=6)
            assert ref.tokens.tolist() == want
            got = _score_logits(eng, np.concatenate([p, res.tokens[:-1]]))
            # of max|logit| (~10 at initializer_range 0.5; the dense
            # decoder's logits lie as far from the JAX package's)
            np.testing.assert_allclose(
                got, jl, rtol=0, atol=TOL_RUN * max(1.0, np.abs(jl).max()))
    finally:
        eng.shutdown()
    assert not any(port_cuda.launch_counts().values())


def _score_logits(engine, tokens):
    """The next-token logits after each prefix of ``tokens`` past the
    prompt's first, through the engine's cache-free scoring program (the
    greedy reference's) on its weights."""
    engine.greedy_reference({"src_ids": tokens[:1]}, max_new_tokens=1)
    n = len(tokens)
    sb = next(b for b in engine._score_buckets() if b >= n)
    feed = {"src_ids": np.zeros((1, sb), np.int64),
            "pos_ids": np.zeros((1, sb), np.int64),
            "input_mask": np.zeros((1, sb, 1), np.float32),
            "last_pos": np.array([[n - 1]], np.int64)}
    feed["src_ids"][0, :n] = tokens
    feed["pos_ids"][0, :n] = np.arange(n)
    feed["input_mask"][0, :n, 0] = 1.0
    out = engine._score.run(feed)[0]
    return np.asarray(out.numpy() if hasattr(out, "numpy") else out)[0]


@pytest.mark.parametrize("sizes,beside", [
    ({"expert": 2, "tp": 2}, "tp"),
    ({"expert": 2, "extra_axes": {"sp": 2}}, "sp"),
    ({"expert": 2, "pipe": 2}, "pp"),
    ({"data": 2, "expert": 2, "tp": 2}, "tp")],
    ids=["tp", "sp", "pp", "dp_tp"])
def test_ep_beside_tp_sp_pp_is_refused_by_name(sizes, beside):
    with pytest.raises(UnimplementedError,
                       match=f"expert axis beside.*{beside}"):
        MeshLayout(**sizes).check_ported()
    mesh = ProcessMesh((beside, "ep"), (2, 2))
    main = _two_moe_blocks(tfluid, tparallel, tcore, tun)
    with pytest.raises(UnimplementedError, match="expert axis beside"):
        tfluid.CompiledProgram(main).with_mesh(mesh, "loss")


@pytest.mark.parametrize("sizes", [
    {"expert": 2}, {"data": 2, "expert": 2}, {"fsdp": 2, "expert": 2},
    {"data": 2, "fsdp": 2, "expert": 2}],
    ids=["ep", "dp_ep", "fsdp_ep", "dp_fsdp_ep"])
def test_ep_layouts_pass_the_check(sizes):
    layout = MeshLayout(**sizes)
    layout.check_ported()
    with pytest.raises(ValueError, match=f"needs {layout.num_devices} "
                                         f"ranks"):
        layout.build_mesh()


def test_global_norm_clip_beside_ep_is_refused_by_name():
    """Each rank holds its experts' gradient blocks: a global-norm clip is
    no longer refused; its squares of the expert gradients are summed
    over the expert axis before the root, the others added locally."""
    tcore.reset_default_programs()
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        from torch_moe_runner import toy_model
        loss, _, _ = toy_model()
        tfluid.optimizer.Adam(
            TOY_LR, grad_clip=tfluid.clip.GradientClipByGlobalNorm(1.0)
        ).minimize(loss)
    report = tparallel.apply_expert_sharding(main, MeshLayout(expert=2))
    ops = main.global_block().ops
    ar = [op for op in ops if op.type == "c_global_norm_allreduce"]
    assert len(ar) == 1 and ar[0].attrs["_axis_name"] == "ep"
    part = [op for op in ops if ar[0].input_names()[0] in op.output_names()]
    sq = {op.output_names()[0]: op.input_names()[0] for op in ops
          if op.type == "squared_l2_norm"}
    assert sorted(sq[n] for n in part[0].input_names()) == sorted(
        n + "@GRAD" for n in report["stamped"])


@pytest.mark.parametrize("manual", [False, True], ids=["rewrite", "manual"])
def test_zero3_after_ep_groups_the_clip_per_axis(manual):
    """``apply_expert_sharding`` (or a manual ``moe_ffn(ep_degree=2)``
    build) and then ``apply_fsdp_sharding`` under a global-norm clip: one
    all-reduce over each axis, the expert gradients' squares in the expert
    axis's group, the ZeRO-3 blocks' in fsdp's, every square read once; a
    further rewrite inserts nothing."""
    from paddle_tpu_torch.clip import shard_global_norm
    from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding
    from torch_moe_runner import toy_model
    tcore.reset_default_programs()
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        loss, _, _ = toy_model(ep=2 if manual else None)
        tfluid.optimizer.Adam(
            TOY_LR, grad_clip=tfluid.clip.GradientClipByGlobalNorm(1.0)
        ).minimize(loss)
    layout = MeshLayout(fsdp=2, expert=2)
    if manual:
        ep_axis = "dp"
        expert = [p.name for p in main.all_parameters()
                  if getattr(p, "dist_attr", None)]
    else:
        ep_axis = layout.expert_axis
        expert = tparallel.apply_expert_sharding(main, layout)["stamped"]
    rep = apply_fsdp_sharding(main, layout, min_shard_numel=16)
    block = main.global_block()
    ops = block.ops
    sq = {op.output_names()[0]: op.input_names()[0] for op in ops
          if op.type == "squared_l2_norm"}
    groups = {}
    for ar in (op for op in ops if op.type == "c_global_norm_allreduce"):
        part = next(op for op in ops
                    if ar.input_names()[0] in op.output_names())
        groups[ar.attrs["_axis_name"]] = sorted(
            sq[n] for n in part.input_names())
    assert expert and rep["sharded"]
    assert groups == {
        ep_axis: sorted(n + "@GRAD" for n in expert),
        layout.fsdp_axis: sorted(p["param"] + "@GRAD"
                                 for p in rep["sharded"])}
    reads = [n for op in ops if op.type == "sum"
             for n in op.input_names() if n in sq]
    assert sorted(reads) == sorted(sq)
    assert shard_global_norm(block) == 0


def test_parallel_builder_refuses_moe_by_name():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        with pytest.raises(UnimplementedError, match="no MoE branch"):
            tbert.build_pretrain_network_parallel(
                tbert.BertConfig(moe_experts=2), 1)
