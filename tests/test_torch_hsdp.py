"""HSDP (data x fsdp) through the port against the JAX package: BERT-tiny
pretraining with ``fuse_add_layernorm`` and AdamW 0.01 (warmup into
linear decay, no norm clip), dropout 0, rewritten by
``apply_fsdp_sharding(main, MeshLayout(data=2, fsdp=2))`` and compiled
with ``CompiledProgram.with_mesh(layout.build_mesh(), loss,
batch_axis=layout.batch_axes)`` with bucketed gradient sync — the port as
four processes over gloo on the CPU (``paddle_tpu_torch.distributed.
launch``, ``tests/torch_hsdp_runner.py``), the JAX package on the 2 x 2
mesh of four virtual devices — from the same startup parameters and
global batches, 5 steps, through ``Executor.run`` and
``Executor.prepare(donate_state=True)``.

* The losses and every persistable (the ranks' blocks gathered) within
  1e-5 of the JAX package (fp32 ZeRO's tolerance in
  ``tests/test_torch_zero.py``; the port sums a collective in peer order,
  so over four ranks or two axes it is not a ``psum`` bit for bit);
* the program is the JAX package's desc, with the fsdp-stamped
  parameters' gradient buckets reducing over ``dp`` only and the
  replicated ones' over ``("dp", "fsdp")``;
* each rank holds its block of every fsdp-stamped persistable (half of
  it) and the rest whole, at its coordinates (rank = 2 dp + fsdp).

The collective ops over the axes of a 2 x 2 mesh (one axis of two, both,
a scatter over the first axis after an all-reduce over the rest, the
fsdp gather and its gradient) are held against the JAX ops under
``shard_map`` on the same per-rank inputs: within 1e-6, the quantized
scatter within 1e-6 of each element's magnitude.  Each launch has its own
timeout, so a hung collective fails its test."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.fsdp import apply_fsdp_sharding as japply_fsdp
from paddle_tpu.framework.jax_compat import shard_map
from paddle_tpu.framework.mesh_layout import MeshLayout as JLayout
from paddle_tpu.framework.passes import apply_pass as japply
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert
from paddle_tpu.ops.registry import (LoweringContext as JCtx,
                                     get_op as jget_op)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_hsdp_runner.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_hsdp_runner import MESH2D_CASES  # noqa: E402

STEPS = 5
LAUNCH_TIMEOUT_S = 300
TOL = 1e-5          # losses and persistables (fp32)
TOL_OP = 1e-6       # the collective ops


def _cfg():
    cfg = jbert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _jax_program():
    """The JAX package's HSDP program and what runs it on the 2 x 2
    mesh."""
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 7
    with jfluid.program_guard(main, startup):
        _, total, _, _ = jbert.build_pretrain_network(_cfg())
        lr = jfluid.layers.linear_lr_warmup(
            jfluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2,
            0.0, 1e-3)
        jfluid.optimizer.AdamW(lr, weight_decay=0.01).minimize(total)
    japply(main, "fuse_add_layernorm", fetch_names=[total.name])
    layout = JLayout(data=2, fsdp=2)
    japply_fsdp(main, layout)
    main._mesh_layout = layout
    bs = jfluid.BuildStrategy()
    bs.fuse_all_reduce_ops = True
    compiled = jfluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=total.name,
        batch_axis=layout.batch_axes, build_strategy=bs)
    return compiled, main, startup, total


def launch(tmp, nproc, *args):
    """Run the rank program on ``nproc`` gloo ranks; returns each rank's
    saved arrays."""
    out_dir = tmp / "out"
    out_dir.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, *args, str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S + 60,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(nproc)]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """The JAX reference and the port's four ranks."""
    compiled, main, startup, total = _jax_program()
    rng = np.random.RandomState(0)
    batches = [jbert.make_fake_batch(rng, _cfg(), batch_size=8, seq_len=128,
                                     num_masks=5) for _ in range(STEPS)]
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
                if scope.find_var(n) is not None}
        losses = [float(np.asarray(exe.run(compiled, feed=b,
                                           fetch_list=[total])[0]))
                  for b in batches]
        final = {n: np.asarray(scope.find_var(n)) for n in init
                 if n != "@RNG_STATE@"}
    tmp = tmp_path_factory.mktemp("hsdp")
    arrays = {f"p/{n}": a for n, a in init.items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    np.savez(tmp / "in.npz", **arrays)
    ref = {"losses": losses, "final": final, "main": main,
           "desc": json.dumps(jdesc(main)), "init": init,
           "batches": batches}
    return ref, launch(tmp, 4, "hsdp", str(tmp / "in.npz"))


@pytest.mark.parametrize("entry", ["run", "prepare"])
def test_hsdp_trains_like_the_jax_package(run, entry):
    ref, ranks = run
    for r, out in enumerate(ranks):
        np.testing.assert_allclose(out[f"{entry}/losses"], ref["losses"],
                                   rtol=0, atol=TOL, err_msg=f"rank {r}")
        names = {k[len(entry) + 3:] for k in out
                 if k.startswith(f"{entry}/p/")}
        assert names == set(ref["final"])
        for n in names:
            got = out[f"{entry}/p/{n}"]
            want = ref["final"][n]
            assert got.shape == want.shape, n
            np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {n}")
    for out in ranks[1:]:
        for k in ranks[0]:
            if k.startswith(f"{entry}/p/"):
                assert np.array_equal(ranks[0][k], out[k]), k
    routes = list(ranks[0][f"{entry}/routes"])
    assert not [x for x in routes if ":fallback:" in x], routes


def test_global_norm_clip_under_hsdp_is_the_one_device_clip(run):
    """HSDP with a global-norm clip of 0.05 (it binds): the squares of the
    fsdp-sharded gradients are all-reduced over fsdp before the root, the
    replicated ones added once, so the four ranks land within 1e-6 of the
    JAX package's one-device run from the same parameters and batches."""
    ref, ranks = run
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 7
    with jfluid.program_guard(main, startup):
        _, total, _, _ = jbert.build_pretrain_network(_cfg())
        lr = jfluid.layers.linear_lr_warmup(
            jfluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2,
            0.0, 1e-3)
        jfluid.optimizer.AdamW(
            lr, weight_decay=0.01,
            grad_clip=jfluid.clip.GradientClipByGlobalNorm(0.05)
        ).minimize(total)
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for n, a in ref["init"].items():
            if scope.find_var(n) is not None:
                scope.set_var(n, a)
        losses = [float(np.asarray(exe.run(main, feed=b,
                                           fetch_list=[total])[0]))
                  for b in ref["batches"]]
        final = {n: np.asarray(scope.find_var(n)) for n in ref["final"]
                 if scope.find_var(n) is not None}
    for out in ranks:
        np.testing.assert_allclose(out["clip/losses"], losses, rtol=0,
                                   atol=1e-6)
        for n, a in final.items():
            np.testing.assert_allclose(out[f"clip/p/{n}"], a, rtol=0,
                                       atol=1e-5, err_msg=n)
        types = list(out["clip/types"])
        assert types.count("c_global_norm_allreduce") == 1
    assert np.abs(np.array(losses) - ref["losses"]).max() > 1e-4


def test_the_program_is_the_jax_packages_desc(run):
    ref, ranks = run
    for out in ranks:
        assert str(out["desc"]) == ref["desc"]
    main = ref["main"]
    block = main.global_block()
    stamped = {p.name for p in main.all_parameters()
               if getattr(p, "dist_attr", None)}
    replicated = {p.name for p in main.all_parameters()} - stamped
    assert stamped and replicated
    assert all(tuple(block.vars[p].dist_attr.axes) == ("fsdp",)
               for p in stamped)
    over = {}
    for op in block.ops:
        if op.type == "c_fused_allreduce_sum":
            axes = op.attrs["_axis_name"]
            for g in op.inputs["X"]:
                over[g[:-len("@GRAD")]] = axes
    # fsdp-stamped gradients are summed over fsdp by the gather's
    # transpose and reduced over dp only; the replicated over both
    assert {p: over.get(p) for p in stamped} == {p: "dp" for p in stamped}
    assert {p: over.get(p) for p in replicated} == \
        {p: ("dp", "fsdp") for p in replicated}
    types = [op.type for op in block.ops]
    assert types.count("fsdp_all_gather") == len(stamped)


def test_each_rank_holds_its_block_of_the_state(run):
    """A rank's bytes: every fsdp-stamped persistable at 1/2 (its block
    at its fsdp coordinate), every other whole; the layout's count."""
    ref, ranks = run
    main = ref["main"]
    stamped = {v.name for v in main.list_vars()
               if v.persistable and getattr(v, "dist_attr", None)}
    for r, out in enumerate(ranks):
        assert list(out["coords"]) == [r // 2, r % 2]
        for entry in ("run", "prepare"):
            held = {k[len(entry) + 6:]: int(v) for k, v in out.items()
                    if k.startswith(f"{entry}/held/")}
            assert set(held) == set(ref["final"])
            predicted = 0
            for n, nbytes in held.items():
                whole = out[f"{entry}/p/{n}"].nbytes
                want = whole // 2 if n in stamped else whole
                assert nbytes == want, n
                predicted += want
            assert sum(held.values()) == predicted


# ---------------------------------------------------------------------------
# the collective ops over the axes of a 2 x 2 mesh
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.RandomState(7)
    return [{"X": (rng.randn(5, 7) + 0.1).astype(np.float32),
             "Q": (rng.randn(37, 29) * rng.choice([0.01, 1.0, 20.0],
                                                  (37, 1))).astype(
                 np.float32),
             "S": rng.randn(32).astype(np.float32),
             "G": rng.randn(5, 14).astype(np.float32)} for _ in range(4)]


def _mesh():
    return Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dp", "fsdp"))


def _jax_op(op, attrs, slot, inputs):
    """The JAX op under ``shard_map`` on the 2 x 2 mesh: each device's
    output, in rank order (dp major)."""
    mesh = _mesh()
    stacked = np.stack([inputs[r][slot] for r in range(4)])

    def body(v):
        ctx = JCtx(jax.random.PRNGKey(0), mesh, ("dp", "fsdp"))
        return jget_op(op)(ctx, {"X": [v[0]]}, dict(attrs))["Out"][None]

    fn = shard_map(body, mesh=mesh, in_specs=(P(("dp", "fsdp")),),
                   out_specs=P(("dp", "fsdp")), check_vma=False)
    return np.asarray(jax.jit(fn)(stacked))


@pytest.fixture(scope="module")
def mesh_ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("mesh2d")
    arrays = {f"r{r}/{k}": v for r, d in enumerate(_inputs())
              for k, v in d.items()}
    np.savez(tmp / "in.npz", **arrays)
    return launch(tmp, 4, "mesh2d", str(tmp / "in.npz"))


@pytest.mark.parametrize("case,op,attrs,slot", MESH2D_CASES,
                         ids=[c[0] for c in MESH2D_CASES])
def test_collective_over_mesh_axes_matches_the_jax_package(
        mesh_ranks, case, op, attrs, slot):
    inputs = _inputs()
    want = _jax_op(op, attrs, slot, inputs)
    for r, out in enumerate(mesh_ranks):
        got, w = out[case], want[r]
        assert got.shape == w.shape and got.dtype == w.dtype, case
        if op == "quant_reduce_scatter":
            np.testing.assert_allclose(got, w, rtol=TOL_OP, atol=1e-7,
                                       err_msg=f"{case} rank {r}")
        else:
            np.testing.assert_allclose(got, w, rtol=TOL_OP, atol=TOL_OP,
                                       err_msg=f"{case} rank {r}")
    routes = set(mesh_ranks[0]["routes"])
    assert not [x for x in routes if x.endswith(":fallback")], routes
    if op == "quant_reduce_scatter":
        assert "quant_reduce_scatter:hit" in routes


def test_fsdp_gather_gradient_over_the_fsdp_line(mesh_ranks):
    """``fsdp_all_gather``'s backward inside the grid: each rank's
    gradient is its slice of the cotangent summed over its fsdp line (the
    JAX op's transpose, ``psum_scatter`` over fsdp)."""
    inputs = _inputs()
    mesh = _mesh()
    xs = np.stack([inputs[r]["X"] for r in range(4)])
    gs = np.stack([inputs[r]["G"] for r in range(4)])

    def body(x, g):
        ctx = JCtx(jax.random.PRNGKey(0), mesh, ("dp", "fsdp"))

        def gather(a):
            return jget_op("fsdp_all_gather")(
                ctx, {"X": [a]}, {"_axis_name": "fsdp",
                                  "gather_dim": 1})["Out"]
        _, vjp = jax.vjp(gather, x[0])
        return vjp(g[0])[0][None]

    fn = shard_map(body, mesh=mesh, in_specs=(P(("dp", "fsdp")),) * 2,
                   out_specs=P(("dp", "fsdp")), check_vma=False)
    want = np.asarray(jax.jit(fn)(xs, gs))
    for r, out in enumerate(mesh_ranks):
        np.testing.assert_allclose(out["fsdp_grad"], want[r], rtol=TOL_OP,
                                   atol=TOL_OP, err_msg=f"rank {r}")


# ---------------------------------------------------------------------------
# ZeRO-1 over an axis tuple, and fleet's refusal of a hybrid grid
# ---------------------------------------------------------------------------


def _tiny(pkg):
    from paddle_tpu_torch import fluid as tfluid
    from paddle_tpu_torch.framework import core as tcore
    from paddle_tpu_torch.framework import unique_name as tun
    fl = jfluid if pkg == "jax" else tfluid
    (jun if pkg == "jax" else tun).reset()
    if pkg == "port":
        tcore.reset_default_programs()
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        x = fl.layers.data("x", shape=[4])
        loss = fl.layers.mean(fl.layers.fc(x, 2))
    return fl, main, startup, loss


@pytest.mark.parametrize("axes", [("dp", "fsdp"), ("fsdp", "dp")],
                         ids=lambda a: "x".join(a))
def test_sharded_update_over_an_axis_tuple_is_the_jax_packages(axes):
    """``ShardedUpdateOptimizer(axis_name=(first, rest))``: the scatter,
    slice and gather ride the first axis, the scatter's ``_axis_name``
    carries the tuple (its rest all-reduced first) — desc for desc."""
    import paddle_tpu.optimizer as jopt
    from paddle_tpu_torch import optimizer as topt
    from paddle_tpu_torch.framework.serialization import (
        program_to_desc as tdesc)
    descs = []
    for pkg, mod, to_desc in (("jax", jopt, jdesc), ("port", topt, tdesc)):
        fl, main, startup, loss = _tiny(pkg)
        with fl.program_guard(main, startup):
            mod.ShardedUpdateOptimizer(fl.optimizer.Adam(0.01), nranks=2,
                                       axis_name=axes).minimize(loss)
        descs.append(json.dumps(to_desc(main)))
    assert descs[0] == descs[1]
    ops = json.loads(descs[1])["blocks"][0]["ops"]
    scatter = [op for op in ops if op["type"] == "zero_reduce_scatter"]
    assert scatter and all(op["attrs"]["_axis_name"]["items"] == list(axes)
                           for op in scatter)


def test_fleet_sharding_refuses_a_hybrid_grid_with_the_jax_message():
    from paddle_tpu.distributed.fleet import (
        DistributedStrategy as JStrategy, distributed_optimizer as jdist,
        fleet as jfleet, UserDefinedRoleMaker as JRoleMaker)
    from paddle_tpu_torch.distributed import fleet as tfleet
    from paddle_tpu_torch.distributed.fleet import (DistributedStrategy,
                                                    UserDefinedRoleMaker)
    from paddle_tpu_torch.framework.mesh_layout import ProcessMesh
    errs = []
    fl, main, startup, loss = _tiny("jax")
    with fl.program_guard(main, startup):
        jfleet.init(JRoleMaker(0, 1))
        s = JStrategy()
        s.sharding = True
        s.mesh = _mesh()
        with pytest.raises(ValueError) as e:
            jdist(fl.optimizer.Adam(0.1), s).minimize(loss)
        errs.append(str(e.value))
    fl, main, startup, loss = _tiny("port")
    with fl.program_guard(main, startup):
        tfleet.init(UserDefinedRoleMaker(0, 1, place=fl.CPUPlace()))
        s = DistributedStrategy()
        s.sharding = True
        s.mesh = ProcessMesh(("dp", "fsdp"), (2, 2))
        with pytest.raises(ValueError) as e:
            tfleet.distributed_optimizer(fl.optimizer.Adam(0.1),
                                         s).minimize(loss)
        errs.append(str(e.value))
    assert errs[0] == errs[1] and "hybrid grids" in errs[1]
