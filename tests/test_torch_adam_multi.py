"""The multi-tensor Adam update of the port (``ops/cuda/optimizer.py``
``adam_multi``, kernel ``csrc/adam.cu``) and the executor's grouping of a
run of ``adam`` / ``adamw`` ops into one call of it.

On the CPU the wrapper runs its plain twin ``adam_multi_plain``; it must
give, bit for bit, what the per-op path gives: each op's step size
``lr * sqrt(1 - beta2_pow) / (1 - beta1_pow)``, AdamW's decay term
``lr * coeff * p`` taken before the update, ``adam_plain``, the decay
subtracted, and each beta power advanced once.  The grouping is checked on
built programs (BERT-tiny with Adam; AdamW with global-norm clip and an LR
schedule; L2 regularization, whose ``scale`` and ``sum`` ops sit before the
update; a lazy-mode op, which stays out of the kernel's runs; a shared
``Beta1Pow``, which ends a run) by recording every ``adam_multi`` call.
The 5-step BERT-tiny parity tests against the JAX package
(tests/test_torch_training.py, test_torch_fused_training.py,
test_torch_data_parallel.py) run through the grouped path."""

import numpy as np
import pytest
import torch

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import executor as texec
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.models import bert as tbert
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import optimizer_ops, registry
from paddle_tpu_torch.ops.cuda import optimizer as topt
from paddle_tpu_torch.ops.registry import LoweringContext

SIZES = (1, 2, 767, 768, 3 * 768 * 768, 1001)


@pytest.fixture(autouse=True)
def _fresh_port_state():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    assert sum(port_cuda.launch_counts().values()) == 0
    tcore.reset_default_programs()


def _entries(coeff, seed=3):
    rng = np.random.RandomState(seed)
    out = []
    for i, n in enumerate(SIZES):
        p, g, m = (torch.from_numpy(rng.randn(n).astype(np.float32))
                   for _ in range(3))
        v = torch.from_numpy(np.abs(rng.randn(n)).astype(np.float32) * 0.01)
        out.append(topt.AdamTensor(
            p, g, m, v, torch.tensor([1e-3 * (i + 1)]),
            torch.tensor([0.9 ** (i + 1)]), torch.tensor([0.999 ** (i + 1)]),
            0.9, 0.999, 1e-8, coeff))
    return out


def _clone(entries):
    return [topt.AdamTensor(*[t.clone() if torch.is_tensor(t) else t
                              for t in e]) for e in entries]


def _per_op(e):
    """One op of the per-op path, as the executor ran it one op at a time:
    the step size and the decay term from tensor ops, the one-tensor
    update, the decay, then the powers."""
    lr_t = e.lr * torch.sqrt(1 - e.beta2_pow) / (1 - e.beta1_pow)
    decay = e.lr.to(e.p.dtype) * e.coeff * e.p if e.coeff else None
    topt.adam_plain(e.p, e.g, e.m, e.v, lr_t.reshape(1).to(torch.float32),
                    e.beta1, e.beta2, e.eps)
    if decay is not None:
        e.p.sub_(decay)
    e.beta1_pow.mul_(e.beta1)
    e.beta2_pow.mul_(e.beta2)


@pytest.mark.parametrize("kind,coeff", [("adam", 0.0), ("adamw", 0.01),
                                        ("adamw-decay-off", 0.0)])
def test_multi_twin_is_the_per_op_path_bit_for_bit(kind, coeff):
    group = _entries(coeff)
    ref = _clone(group)
    powers = [(float(e.beta1_pow), float(e.beta2_pow)) for e in group]
    topt.adam_multi(group)
    for e in ref:
        _per_op(e)
    for a, b in zip(group, ref):
        for x, y in zip(a[:7], b[:7]):
            assert torch.equal(x, y)
    # each beta power advanced exactly once
    for e, (b1, b2) in zip(group, powers):
        assert float(e.beta1_pow) == np.float32(np.float32(b1) *
                                                np.float32(0.9))
        assert float(e.beta2_pow) == np.float32(np.float32(b2) *
                                                np.float32(0.999))


def test_adamw_decay_in_a_run_reads_the_parameter_before_the_update():
    e = _entries(0.5)[3]
    e = e._replace(lr=torch.tensor([0.5]))
    p0 = e.p.clone()
    ref = _clone([e])[0]
    ref = ref._replace(coeff=0.0)
    topt.adam_multi([e])
    _per_op(ref)                  # the same update without the decay
    np.testing.assert_array_equal(e.p.numpy(),
                                  (ref.p - 0.5 * 0.5 * p0).numpy())


def test_gate_refuses_what_the_kernel_does_not_take():
    z = torch.zeros(4)
    one = torch.zeros(1)
    assert topt.adam_supported(z, z, z, z, one, one) == (True, "")
    assert topt.adam_supported(z, z, z, z, one.double(), one)[1] \
        .startswith("beta1_pow:")
    assert topt.adam_supported(z, z, z, z, one, torch.zeros(2))[1] \
        .startswith("beta2_pow:")
    meta = torch.empty(4, device="meta")
    one_meta = torch.empty(1, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        topt.adam_multi([topt.AdamTensor(meta, meta, meta, meta, one_meta,
                                         one_meta, one_meta)])


def test_chunk_list_covers_every_element_once():
    numels = [1, 65536, 65537, 3 * 65536 - 5, 768]
    pairs = topt._chunks(torch.device("cpu"), numels, 65536).tolist()
    got = [(i, c) for i, c in pairs]
    want = [(i, c) for i, n in enumerate(numels)
            for c in range(-(-n // 65536))]
    assert got == want
    assert topt._chunks(torch.device("cpu"), numels, 65536) is \
        topt._chunks(torch.device("cpu"), list(numels), 65536)


# ---------------------------------------------------------------------------
# the executor's runs
# ---------------------------------------------------------------------------


@pytest.fixture
def calls(monkeypatch):
    """The sizes of every adam_multi call."""
    sizes = []
    real = topt.adam_multi

    def record(tensors):
        tensors = list(tensors)
        sizes.append(len(tensors))
        return real(tensors)
    monkeypatch.setattr(topt, "adam_multi", record)
    return sizes


def _bert(make_opt):
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    startup.random_seed = main.random_seed = 5
    cfg = tbert.BertConfig.tiny()
    cfg.hidden_dropout_prob = cfg.attention_probs_dropout_prob = 0.0
    with tcore.program_guard(main, startup):
        _, total, _, _ = tbert.build_pretrain_network(cfg)
        make_opt(tfluid).minimize(total)
    feed = tbert.make_fake_batch(np.random.RandomState(1), cfg, 2, 64, 4)
    return main, startup, total, feed


def _update_tail(main):
    ops = main.global_block().ops
    return [op.type for op in ops[texec.backward_index(ops) + 1:]]


@pytest.mark.parametrize("name,make_opt", [
    ("adam", lambda f: f.optimizer.Adam(1e-3)),
    ("adamw-clip-schedule", lambda f: f.optimizer.AdamW(
        f.layers.linear_lr_warmup(f.layers.polynomial_decay(
            1e-3, 100, 0.0, power=1.0), 3, 0.0, 1e-3),
        weight_decay=0.01,
        grad_clip=f.clip.GradientClipByGlobalNorm(1.0))),
    ("adam-l2", lambda f: f.optimizer.Adam(
        1e-3, regularization=f.regularizer.L2Decay(0.01))),
])
def test_bert_tiny_update_is_one_run(name, make_opt, calls):
    main, startup, total, feed = _bert(make_opt)
    tail = _update_tail(main)
    kind = "adamw" if name.startswith("adamw") else "adam"
    n = tail.count(kind)
    assert n == 38
    # everything else of the update sits before the Adam ops
    assert tail[-n:] == [kind] * n
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    del calls[:]
    prepared = exe.prepare(main, fetch_list=[total], scope=scope,
                           donate_state=True)
    for _ in range(2):
        prepared.run(feed)
    assert calls == [n, n]
    hits = registry.route_counts("hit")
    assert hits[(kind, "fused_adam", "hit", "supported")] == 2 * n
    assert not registry.route_counts("fallback")


def _small(lazy):
    tun.reset()
    main, startup = tcore.Program(), tcore.Program()
    startup.random_seed = 11
    with tcore.program_guard(main, startup):
        ids = tfluid.layers.data("ids", shape=[-1, 4], dtype="int64",
                                 append_batch_size=False)
        x = tfluid.layers.data("x", shape=[16])
        emb = tfluid.layers.embedding(ids, size=[50, 16])
        h = tfluid.layers.fc(x, 16, act="tanh")
        loss = tfluid.layers.mean(
            tfluid.layers.fc(emb, 3, num_flatten_dims=2)) + \
            tfluid.layers.mean(tfluid.layers.fc(h, 3))
        tfluid.optimizer.Adam(0.01, lazy_mode=lazy).minimize(loss)
    feed = {"ids": np.random.RandomState(2).randint(0, 10, (3, 4)),
            "x": np.random.RandomState(3).randn(3, 16).astype(np.float32)}
    return main, startup, loss, feed


def _expected_runs(ops, grouped):
    """Sizes of the maximal runs of consecutive ops that ``grouped`` takes."""
    runs, n = [], 0
    for op in ops:
        if grouped(op):
            n += 1
        elif n:
            runs.append(n)
            n = 0
    return runs + ([n] if n else [])


def test_a_lazy_op_stays_out_of_the_kernel_runs(calls):
    main, startup, loss, feed = _small(lazy=True)
    ops = [op for op in main.global_block().ops if op.type == "adam"]
    lazy = [op for op in ops if op.inputs.get("SparseRows")]
    assert len(lazy) == 1 and len(ops) == 7
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    del calls[:]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert calls == _expected_runs(ops, lambda op: op not in lazy)
    assert sum(calls) == 6
    hits = registry.route_counts("hit")
    assert hits[("adam", "fused_adam", "hit", "supported")] == 6
    assert not registry.route_counts("fallback")


def test_a_shared_beta_power_ends_the_run(calls):
    main, startup, loss, feed = _small(lazy=False)
    ops = [op for op in main.global_block().ops if op.type == "adam"]
    assert len(ops) == 7
    # the fourth op shares the third's Beta1Pow: it reads what the third
    # writes, so the run ends before it
    ops[3].inputs["Beta1Pow"] = list(ops[2].inputs["Beta1Pow"])
    ops[3].outputs["Beta1PowOut"] = list(ops[2].outputs["Beta1PowOut"])
    block = main.global_block().ops
    group = registry.get_group("adam")
    assert texec._run_end(block, block.index(ops[0]), group) == \
        block.index(ops[3])
    # an op that writes what an earlier op of the run reads ends it too
    # (write after read), and so does one writing what an earlier writes
    start = block.index(ops[3])
    saved = dict(ops[5].outputs)
    ops[5].outputs["Moment1Out"] = list(ops[4].inputs["Grad"])
    assert texec._run_end(block, start, group) == block.index(ops[5])
    ops[5].outputs["Moment1Out"] = list(ops[4].outputs["Moment2Out"])
    assert texec._run_end(block, start, group) == block.index(ops[5])
    ops[5].outputs.update(saved)
    assert texec._run_end(block, start, group) == block.index(ops[6]) + 1
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    b1 = ops[2].inputs["Beta1Pow"][0]
    start = float(scope.find_var(b1).numpy()[0])
    del calls[:]
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert calls == [3, 4]
    # advanced by both ops, one after the other
    got = float(scope.find_var(b1).numpy()[0])
    assert got == np.float32(np.float32(np.float32(start) * np.float32(0.9))
                             * np.float32(0.9))


def test_executor_run_leaves_its_inputs_intact():
    """Without ``donate_state`` the grouped update runs on copies: the
    tensors the scope held before the run keep their values."""
    main, startup, loss, feed = _small(lazy=False)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    names = [v.name for v in main.list_vars() if v.persistable]
    before = {n: scope.find_var(n) for n in names}
    copies = {n: t.clone() for n, t in before.items()}
    exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    for n, t in before.items():
        assert torch.equal(t, copies[n]), n
    moved = [n for n in names
             if not torch.equal(scope.find_var(n), copies[n])]
    assert any("beta1_pow" in n for n in moved)
    assert any(n.startswith("fc") for n in moved)


def test_a_run_of_one_is_the_op_impl():
    """``get_op("adam")`` on one op is the group impl on a run of one."""
    e = _entries(0.0)[2]
    ins = {"Param": [e.p], "Grad": [e.g], "Moment1": [e.m],
           "Moment2": [e.v], "LearningRate": [e.lr], "Beta1Pow":
           [e.beta1_pow], "Beta2Pow": [e.beta2_pow]}
    ctx = LoweringContext(None, torch.device("cpu"), donate_state=True)
    ref = _clone([e])[0]
    out = registry.get_op("adam")(ctx, ins, {})
    _per_op(ref)
    assert out["ParamOut"] is e.p and torch.equal(e.p, ref.p)
    assert optimizer_ops.adam_group(ctx, []) == []
