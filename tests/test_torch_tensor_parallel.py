"""Megatron tensor parallelism through the port against the JAX package:
a two-layer MLP of ``column_parallel_fc`` -> ``row_parallel_fc`` (the
shape of ``tests/test_parallel.py``'s) plus a ``vocab_parallel_embedding``
term, 3 SGD steps at tp 2 (two gloo ranks) and dp 2 x tp 2 (four), held
to the JAX package's one-device run of the same program from the same
random global weights: losses and parameters within ``TOL`` = 1e-5.  With
SGD a gradient scaled over tp would show as a parameter off by that
factor.

The collective ops over the tp group (``c_embedding``, the differentiable
``c_allgather`` / ``c_concat``, ``c_split``, ``collective_permute`` and
the Megatron f/g pair ``mp_copy`` / ``mp_allreduce_sum``): forward within
``TOL_OP`` = 1e-6 of the JAX ops under ``shard_map`` on the same per-rank
inputs, gradients within ``TOL_OP`` of the one-device gradient written
out in numpy (the gather's gradient is the rank's slice of the replicated
cotangent, where the JAX transpose sums it over tp).

Plus the pieces outside a process group: ``parallel.topology`` on the
port's ``ProcessMesh``, the refusals of what is not ported,
``MeshLayout.check_ported``, and the card's lookup of a table replicated
over the tp ranks (its gradient in one fixed order, so the ranks agree
on it) against ``F.embedding``."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu.fluid as jfluid
from paddle_tpu import parallel as jparallel
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.jax_compat import shard_map
from paddle_tpu.ops.registry import (LoweringContext as JCtx,
                                     get_op as jget_op)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_tp_runner.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_tp_runner import COMM_CASES, MLP_LR, VOCAB  # noqa: E402

LAYOUTS = {"tp2": 2, "dp2tp2": 4}
STEPS = 3
LAUNCH_TIMEOUT_S = 300
TOL = 1e-5          # MLP losses and parameters (float32)
TOL_OP = 1e-6       # the collective ops
ROWS, COLS, IDS = 4, 6, 5


def _jax_mlp():
    """The runner's MLP in the JAX package, one device."""
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", shape=[6])
        ids = jfluid.layers.data("ids", shape=[3], dtype="int64")
        h = jparallel.column_parallel_fc(
            x, 16, 2, act="relu", param_attr=jfluid.ParamAttr(name="w1"),
            bias_attr=jfluid.ParamAttr(name="b1"))
        y = jparallel.row_parallel_fc(
            h, 4, 2, param_attr=jfluid.ParamAttr(name="w2"),
            bias_attr=jfluid.ParamAttr(name="b2"))
        emb = jparallel.vocab_parallel_embedding(
            ids, VOCAB, 4, 2, param_attr=jfluid.ParamAttr(name="emb_w"))
        loss = jfluid.layers.mean(jfluid.layers.square(y)) + \
            jfluid.layers.mean(jfluid.layers.square(emb))
        jfluid.optimizer.SGD(MLP_LR).minimize(loss)
    return main, startup, loss


def _comm_inputs():
    rng = np.random.RandomState(5)
    out = {"ids": rng.randint(0, 2 * ROWS, (IDS,)).astype(np.int64)}
    shared = {"c_allgather": rng.randn(ROWS, 2 * COLS),
              "c_concat": rng.randn(ROWS, 2 * COLS),
              "mp_allreduce_sum": rng.randn(ROWS, COLS),
              "c_embedding": rng.randn(IDS, COLS)}
    for r in range(4):
        out[f"r{r}/X"] = rng.randn(ROWS, COLS).astype(np.float32)
        for case, *_ in COMM_CASES:
            g = shared.get(case)
            if g is None:
                shape = (ROWS // 2, COLS) if case == "c_split" else \
                    (ROWS, COLS)
                g = rng.randn(*shape)
            out[f"r{r}/G_{case}"] = np.asarray(g, np.float32)
    return out


def launch(tmp, nproc, *args):
    out_dir = tmp / "out"
    out_dir.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, *args, str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S + 60,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(nproc)]


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    rng = np.random.RandomState(0)
    init = {"w1": rng.randn(6, 16) * 0.5, "b1": rng.randn(16) * 0.1,
            "w2": rng.randn(16, 4) * 0.5, "b2": rng.randn(4) * 0.1,
            "emb_w": rng.randn(VOCAB, 4)}
    init = {n: a.astype(np.float32) for n, a in init.items()}
    batches = [{"x": rng.randn(8, 6).astype(np.float32),
                "ids": rng.randint(0, VOCAB, (8, 3)).astype(np.int64)}
               for _ in range(STEPS)]
    main, startup, loss = _jax_mlp()
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for n, a in init.items():
            scope.set_var(n, a)
        losses = [float(np.asarray(exe.run(main, feed=b,
                                           fetch_list=[loss])[0]))
                  for b in batches]
        final = {n: np.asarray(scope.find_var(n)) for n in init}
    tmp = tmp_path_factory.mktemp("tp_mlp")
    arrays = {f"p/{n}": a for n, a in init.items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    comm = _comm_inputs()
    arrays.update(comm)
    np.savez(tmp / "in.npz", **arrays)
    return {"losses": losses, "init": init, "final": final, "comm": comm,
            "in": tmp / "in.npz", "tmp": tmp_path_factory}


_RUNS = {}


@pytest.fixture
def ranks(ref):
    def get(layout):
        if layout not in _RUNS:
            tmp = ref["tmp"].mktemp(layout)
            _RUNS[layout] = launch(tmp, LAYOUTS[layout], "mlp", layout,
                                   str(ref["in"]))
        return _RUNS[layout]
    return get


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_tp_mlp_trains_like_the_one_device_jax_run(ref, ranks, layout):
    outs = ranks(layout)
    for r, out in enumerate(outs):
        np.testing.assert_allclose(out["losses"], ref["losses"], rtol=0,
                                   atol=TOL, err_msg=f"rank {r}")
        for n, w in ref["final"].items():
            np.testing.assert_allclose(out[f"p/{n}"], w, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {n}")
        # the tp blocks: w1 and b1 by columns, w2 and emb_w by rows
        tp = r % 2
        for n, d in (("w1", 1), ("b1", 0), ("w2", 0), ("emb_w", 0)):
            np.testing.assert_array_equal(
                out[f"held/{n}"], np.split(out[f"p/{n}"], 2, axis=d)[tp])
        assert out["held/b2"].shape == (4,)
    routes = [str(x) for x in outs[0]["routes"]]
    assert not [x for x in routes if ":fallback:" in x], routes


def _line(layout, r):
    """The global ranks of rank r's tp line (tp is the last mesh axis)."""
    base = r - r % 2
    return [base, base + 1]


def _comm_expected(comm, case, r, line):
    """(forward, gradient) of ``case`` on rank r written out in numpy:
    the one-device math."""
    t = line.index(r)
    xs = [comm[f"r{m}/X"].astype(np.float64) for m in line]
    g = comm[f"r{r}/G_{case}"].astype(np.float64)
    gs = [comm[f"r{m}/G_{case}"].astype(np.float64) for m in line]
    if case == "c_embedding":
        table = np.concatenate(xs, 0)
        ids = comm["ids"]
        grad = np.zeros_like(xs[t])
        for i, v in enumerate(ids):
            if t * ROWS <= v < (t + 1) * ROWS:
                grad[v - t * ROWS] += g[i]
        return table[ids], grad
    if case in ("c_allgather", "c_concat"):
        return np.concatenate(xs, 1), g[:, t * COLS:(t + 1) * COLS]
    if case == "c_split":
        half = ROWS // 2
        return xs[t][t * half:(t + 1) * half], np.concatenate(gs, 0)
    if case == "permute":
        return xs[(t - 1) % 2], gs[(t + 1) % 2]
    if case == "mp_copy":
        return xs[t], sum(gs)
    if case == "mp_allreduce_sum":
        return sum(xs), g
    raise KeyError(case)


def _jax_forward(comm, op, attrs, line):
    """The JAX op under ``shard_map`` on a 2-device tp mesh, each device
    on its member's input: the outputs in member order."""
    mesh = Mesh(np.array(jax.devices()[:2]), ("tp",))
    xs = np.stack([comm[f"r{m}/X"] for m in line])

    def body(v):
        ctx = JCtx(jax.random.PRNGKey(0), mesh, ("tp",))
        if op == "c_embedding":
            ins = {"W": [v[0]], "Ids": [comm["ids"]]}
        else:
            ins = {"X": [v[0]]}
        return jget_op(op)(ctx, ins, dict(attrs))["Out"][None]

    fn = shard_map(body, mesh=mesh, in_specs=(P("tp"),), out_specs=P("tp"),
                   check_vma=False)
    return np.asarray(jax.jit(fn)(xs))


@pytest.mark.parametrize("layout", sorted(LAYOUTS))
@pytest.mark.parametrize("case,op,attrs", COMM_CASES,
                         ids=[c[0] for c in COMM_CASES])
def test_collective_op_over_tp_matches_the_one_device_math(
        ref, ranks, layout, case, op, attrs):
    outs = ranks(layout)
    comm = ref["comm"]
    for r, out in enumerate(outs):
        line = _line(layout, r)
        want, grad = _comm_expected(comm, case, r, line)
        np.testing.assert_allclose(out[f"{case}/out"], want, rtol=TOL_OP,
                                   atol=TOL_OP, err_msg=f"rank {r}")
        np.testing.assert_allclose(out[f"{case}/grad"], grad, rtol=TOL_OP,
                                   atol=TOL_OP, err_msg=f"rank {r}")
        if r in (0, 1) and op != "mp_copy":
            # the JAX op's forward on the same inputs (mp_copy is the
            # identity in both)
            jax_out = _jax_forward(comm, op, attrs, line)[line.index(r)]
            np.testing.assert_allclose(out[f"{case}/out"], jax_out,
                                       rtol=TOL_OP, atol=TOL_OP)


# ---------------------------------------------------------------------------
# outside a process group
# ---------------------------------------------------------------------------


def test_topology_lays_the_jax_axis_order_over_the_ranks():
    from paddle_tpu_torch.parallel import topology
    t = topology.DeviceTopology({"tp": 2, "dp": 2, "sp": 2}, devices=8)
    assert t.world_size == 8
    # one process here: the mesh of the eight ranks is refused on the count
    with pytest.raises(ValueError, match="needs 8 ranks"):
        t.mesh()
    with pytest.raises(ValueError, match="needs 16 devices"):
        topology.DeviceTopology({"dp": 16}, devices=8)
    assert topology.build_mesh({"dp": 1, "tp": 1}) is None
    assert topology._factor(8, 2) == [4, 2]
    assert topology._factor(8, 3) == [2, 2, 2]
    from paddle_tpu.parallel.topology import _factor as jfactor
    assert all(topology._factor(n, k) == jfactor(n, k)
               for n in (1, 2, 4, 6, 8, 12, 16) for k in (1, 2, 3))


def test_what_is_not_ported_is_refused_by_name():
    from paddle_tpu_torch import parallel
    from paddle_tpu_torch.framework.errors import UnimplementedError
    from paddle_tpu_torch.models import bert
    for fn, name in ((parallel.gpipe_spmd, "gpipe_spmd"),
                     (parallel.moe_ffn, "moe_ffn"),
                     (parallel.collect_aux_losses, "collect_aux_losses"),
                     (parallel.apply_expert_sharding,
                      "apply_expert_sharding"),
                     (parallel.tpu_slice_env, "tpu_slice_env")):
        with pytest.raises(UnimplementedError, match=name):
            fn()
    with pytest.raises(UnimplementedError, match="PipelineOptimizer"):
        parallel.PipelineOptimizer(None)
    from paddle_tpu_torch import fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        with pytest.raises(UnimplementedError, match="moe_experts=2"):
            bert.build_pretrain_network_parallel(
                bert.BertConfig(moe_experts=2), 1)


@pytest.mark.parametrize("sizes,ok", [
    ({"tp": 2}, True), ({"data": 2, "tp": 2}, True),
    ({"tp": 2, "extra_axes": {"sp": 2}}, True),
    ({"data": 2, "tp": 2, "extra_axes": {"sp": 2}}, True),
    ({"pipe": 2}, False), ({"expert": 2}, False),
    ({"extra_axes": {"cp": 2}}, False), ({"fsdp": 2, "tp": 2}, False),
    ({"fsdp": 2, "extra_axes": {"sp": 2}}, False)],
    ids=lambda v: str(v).replace(" ", ""))
def test_check_ported_takes_tensor_and_sequence_axes(sizes, ok):
    from paddle_tpu_torch.framework.errors import UnimplementedError
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    layout = MeshLayout(**sizes)
    if ok:
        layout.check_ported()
    else:
        with pytest.raises(UnimplementedError, match="not ported"):
            layout.check_ported()


def _replicated_lookup_against_embedding(rows, n_ids, id_range, seed):
    import torch
    from paddle_tpu_torch.ops import nn_ops
    gen = torch.Generator().manual_seed(seed)
    w = torch.randn(rows, 16, generator=gen)
    ids = torch.randint(0, id_range, (n_ids,), generator=gen)
    g = torch.randn(n_ids, 16, generator=gen)
    a = w.clone().requires_grad_(True)
    out = nn_ops._ReplicatedTableLookup.apply(a, ids)
    out.backward(g)
    b = w.clone().requires_grad_(True)
    ref = torch.nn.functional.embedding(ids, b)
    ref.backward(g)
    assert torch.equal(out, ref)
    np.testing.assert_allclose(a.grad.numpy(), b.grad.numpy(), rtol=0,
                               atol=1e-4)
    again = w.clone().requires_grad_(True)
    nn_ops._ReplicatedTableLookup.apply(again, ids).backward(g)
    assert torch.equal(again.grad, a.grad)


def test_the_small_table_lookup_gradient_is_the_embeddings():
    """The card's lookup for a table replicated over the tp ranks
    (``_ReplicatedTableLookup``: the gradient as one_hot(ids)^T . grad
    over the distinct ids, one fixed order, so the ranks computing the
    table's gradient each agree bit for bit) gives ``F.embedding``'s
    output and gradient, here on the CPU: 4,096 ids into 3 rows, as the
    sentence embedding's many ids into few rows."""
    _replicated_lookup_against_embedding(512, 4096, 3, 4)


def test_the_replicated_lookup_takes_a_table_of_any_size():
    """The same for a vocabulary-sized table (30,522 rows, ids spread
    over all of it): the product runs over the distinct ids, so no row
    count bounds the lookup."""
    _replicated_lookup_against_embedding(30522, 512, 30522, 5)


@pytest.mark.parametrize("axes,taken", [
    ((), False), (("dp",), False), (("dp", "fsdp"), False),
    (("tp",), True), (("dp", "tp"), True), (("tp", "sp"), True)])
def test_the_replicated_lookup_is_chosen_by_the_tp_axis(axes, taken):
    """``lookup_table`` takes the replicated-table lookup where the run
    has a tensor-parallel axis (its table is then replicated over the tp
    ranks), and ``F.embedding`` on every other run."""
    from paddle_tpu_torch.ops import nn_ops

    class Ctx:
        axis_names = axes
    assert nn_ops._replicated_over_tp(Ctx()) is taken


def test_a_1d_fetch_over_the_sequence_axis_is_refused():
    """``merge_fetch`` under a sequence axis: a 1-D value of more than one
    element (per-row sums of shape [B], say) has no known merge over the
    sequence shards, so it raises rather than returning this shard's
    partial values."""
    import torch
    from paddle_tpu_torch.framework.errors import UnimplementedError
    from paddle_tpu_torch.ops.collective_ops import (DataParallelGroup,
                                                     merge_fetch)
    sp = DataParallelGroup(0, 2, "gloo", axis_name="sp")
    sp.seq_axis = "sp"
    for value in (torch.ones(4), torch.ones(4, dtype=torch.int64)):
        with pytest.raises(UnimplementedError, match=r"shape \(4,\)"):
            merge_fetch(sp, value, replicated=False)
    kept = torch.ones(4)
    assert merge_fetch(sp, kept, replicated=True) is kept
