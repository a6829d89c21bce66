"""The port's collective ops (``paddle_tpu_torch/ops/collective_ops.py``)
on 2 and 3 gloo ranks on the CPU (``paddle_tpu_torch.distributed.launch``
running ``tests/torch_dist_runner.py``) against the JAX package's ops
under ``shard_map`` on a 2- and 3-device virtual mesh, with the same
per-rank inputs made with numpy from a seed.

Tolerances: the float32 ops within 1e-6; the bf16 cast path within bf16
rounding (2^-7 of the largest magnitude, times the rank count); the
blockwise-quantized all-reduce's ``Out`` and ``QScale`` bit-identical at
n = 2 (int8 and int4), and at n = 3 within one quantization step of each
block (the sums of three peers may round in another order).  ZeRO's ops:
``zero_reduce_scatter`` (with a 128 ``align`` pad, and in bf16),
``zero_shard_slice`` (aligned and not), ``zero_all_gather`` (the pad
dropped) and ``fsdp_all_gather`` within 1e-6, its gradient (the summed
reduce-scatter of each rank's cotangent) within 1e-6;
``quant_reduce_scatter`` (int8 at block 256, int4 at block 128, the pad
to n·block) within 1e-6 of each element's magnitude (the receive stage's
kernel twin accumulates with one rounding a peer, the JAX package's plain
path rounds each product first).  Every op is the identity outside a
process group (the ZeRO ops up to their flat layout)."""

import os
import subprocess
import sys

import jax
import numpy as np
import pytest
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.framework.jax_compat import shard_map
from paddle_tpu.ops.registry import (LoweringContext as JCtx,
                                     get_op as jget_op)

import torch

from paddle_tpu_torch.ops import registry as tregistry

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from torch_dist_runner import COLLECTIVE_CASES, NOOP_OPS  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_dist_runner.py")
LAUNCH_TIMEOUT_S = 180
TOL = 1e-6


def _inputs(n):
    """Per rank: X (5, 7), X2 (11,), Q (37, 29) — 1,073 elements, ragged
    against n x 256 — R (3n, 4), S (32,) and G (5, 7n), the cotangent of
    X gathered along dim 1."""
    rng = np.random.RandomState(100 + n)
    out = []
    for _ in range(n):
        out.append({
            "X": (rng.randn(5, 7) + 0.1).astype(np.float32),
            "X2": rng.randn(11).astype(np.float32),
            "Q": (rng.randn(37, 29) * rng.choice([0.01, 1.0, 20.0],
                                                 (37, 1))).astype(
                np.float32),
            "R": rng.randn(3 * n, 4).astype(np.float32),
            "S": rng.randn(32).astype(np.float32),
            "G": rng.randn(5, 7 * n).astype(np.float32),
        })
    return out


def _jax_case(n, op, attrs, slots, inputs):
    """The JAX op on an n-device mesh: one output array per slot entry,
    stacked over ranks."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    stacked = [np.stack([inputs[r][s] for r in range(n)]) for s in slots]

    def body(*xs):
        xs = [v[0] for v in xs]
        ctx = JCtx(jax.random.PRNGKey(0), mesh, ("dp",))
        ins = {"X": xs} if op.startswith("c_fused") else {"X": xs[:1]}
        res = jget_op(op)(ctx, ins, dict(attrs))
        outs = res["Out"] if isinstance(res["Out"], list) else [res["Out"]]
        outs = [o[None] for o in outs]
        if "QScale" in res:
            outs.append(res["QScale"][None])
        return tuple(outs)

    fn = shard_map(body, mesh=mesh, in_specs=tuple(P("dp") for _ in slots),
                   out_specs=P("dp"), check_vma=False)
    return [np.asarray(o) for o in jax.jit(fn)(*stacked)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Per world size: the port's outputs on every rank."""
    cache = {}

    def get(n):
        if n not in cache:
            tmp = tmp_path_factory.mktemp(f"coll-{n}")
            arrays = {f"r{r}/{k}": v for r, d in enumerate(_inputs(n))
                      for k, v in d.items()}
            np.savez(tmp / "in.npz", **arrays)
            out_dir = tmp / "out"
            out_dir.mkdir()
            cmd = [sys.executable, "-m",
                   "paddle_tpu_torch.distributed.launch", "--nproc", str(n),
                   "--backend", "gloo", "--timeout", str(LAUNCH_TIMEOUT_S),
                   RUNNER, "collectives", str(tmp / "in.npz"), str(out_dir)]
            proc = subprocess.run(cmd, cwd=REPO, capture_output=True,
                                  text=True, timeout=LAUNCH_TIMEOUT_S + 60,
                                  env=dict(os.environ, OMP_NUM_THREADS="1"))
            assert proc.returncode == 0, proc.stdout[-3000:] + \
                proc.stderr[-3000:]
            cache[n] = [dict(np.load(out_dir / f"rank{r}.npz"))
                        for r in range(n)]
        return cache[n]
    return get


def _quant_step(spec_attr, qscale):
    """One quantization step of each element's block (the stage-2
    scale), flat, for a quantized op's output."""
    return np.repeat(qscale, spec_attr["block_size"])


@pytest.mark.parametrize("n", [2, 3])
@pytest.mark.parametrize("case,op,attrs,slots", COLLECTIVE_CASES,
                         ids=[c[0] for c in COLLECTIVE_CASES])
def test_collective_matches_the_jax_package(ranks, n, case, op, attrs,
                                            slots):
    inputs = _inputs(n)
    want = _jax_case(n, op, attrs, slots, inputs)
    port = ranks(n)
    quant = "quant_spec" in attrs and op != "quant_reduce_scatter"
    for r in range(n):
        got = [port[r][f"{case}/{i}"] for i in range(len(want))
               if f"{case}/{i}" in port[r]]
        if "QScale" in op or op == "c_fused_quant_allreduce_sum":
            got.append(port[r][f"{case}/qscale"])
        assert len(got) == len(want), case
        for i, (g, w) in enumerate(zip(got, want)):
            w = w[r]
            assert g.shape == w.shape and g.dtype == w.dtype, (case, i)
            if quant and n == 2:
                assert np.array_equal(g, w), (case, r, i)
            elif quant:
                if op == "c_fused_quant_allreduce_sum" and i == len(got) - 1:
                    np.testing.assert_allclose(g, w, rtol=1e-6)   # QScale
                    continue
                qscale = port[r][f"{case}/qscale"] if \
                    f"{case}/qscale" in port[r] else None
                if qscale is None:
                    # the per-leaf op: its own stage-2 scales are internal;
                    # bound by the largest block's step
                    step = np.abs(w).max() / {"int8": 127, "int4": 7}[
                        attrs["quant_spec"]["dtype"]]
                    assert np.abs(g - w).max() <= step * (1 + 1e-6), case
                else:
                    flat = np.concatenate([port[r][f"{case}/{j}"].reshape(-1)
                                           for j in range(len(got) - 1)])
                    steps = _quant_step(attrs["quant_spec"], qscale)[
                        :flat.size]
                    off = 0
                    for j in range(i):
                        off += port[r][f"{case}/{j}"].size
                    seg = steps[off:off + g.size].reshape(g.shape)
                    assert np.all(np.abs(g - w) <= seg * (1 + 1e-6)), case
            elif "bf16" in case:
                bound = n * 2.0 ** -7 * float(np.abs(w).max())
                assert np.abs(g - w).max() <= bound, case
            elif op == "quant_reduce_scatter":
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7,
                                           err_msg=f"{case} rank {r}")
            else:
                np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                           err_msg=f"{case} rank {r}")
    # the quantized ops' receive stage took the kernel route (its twin on
    # the CPU); nothing fell back
    routes = set(port[0]["routes"])
    assert "c_quant_allreduce_sum:hit" in routes
    assert "c_fused_quant_allreduce_sum:hit" in routes
    assert "quant_reduce_scatter:hit" in routes
    assert not [x for x in routes if x.endswith(":fallback")]


def _jax_fsdp_grad(n, inputs):
    """The JAX op's transpose: each rank's gradient of X for its
    cotangent G of the gather along dim 1."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    xs = np.stack([inputs[r]["X"] for r in range(n)])
    gs = np.stack([inputs[r]["G"] for r in range(n)])

    def body(x, g):
        ctx = JCtx(jax.random.PRNGKey(0), mesh, ("dp",))

        def gather(a):
            return jget_op("fsdp_all_gather")(ctx, {"X": [a]},
                                              {"gather_dim": 1})["Out"]
        _, vjp = jax.vjp(gather, x[0])
        return vjp(g[0])[0][None]

    fn = shard_map(body, mesh=mesh, in_specs=(P("dp"), P("dp")),
                   out_specs=P("dp"), check_vma=False)
    return np.asarray(jax.jit(fn)(xs, gs))


@pytest.mark.parametrize("n", [2, 3])
def test_fsdp_all_gather_gradient_matches_the_jax_transpose(ranks, n):
    inputs = _inputs(n)
    want = _jax_fsdp_grad(n, inputs)
    port = ranks(n)
    for r in range(n):
        got = port[r]["fsdp_grad"]
        assert got.shape == inputs[r]["X"].shape
        np.testing.assert_allclose(got, want[r], rtol=TOL, atol=TOL,
                                   err_msg=f"rank {r}")


@pytest.mark.parametrize("op", sorted(
    {c[1] for c in COLLECTIVE_CASES} | set(NOOP_OPS)))
def test_every_collective_is_the_identity_outside_a_group(op):
    ctx = tregistry.LoweringContext(torch.Generator(), torch.device("cpu"))
    assert ctx.axis_names == ()
    a, b = torch.randn(4, 3), torch.randn(5)
    attrs = {"quant_spec": {"dtype": "int8"}} if "quant" in op else {}
    if op in NOOP_OPS:
        assert tregistry.get_op(op)(ctx, {}, attrs) == {}
        return
    if op.startswith("c_fused"):
        out = tregistry.get_op(op)(ctx, {"X": [a, b]}, attrs)["Out"]
        assert torch.equal(out[0], a) and torch.equal(out[1], b)
    elif op in ("zero_reduce_scatter", "quant_reduce_scatter",
                "zero_shard_slice"):
        # ZeRO's flat layout: the tensor flattened
        out = tregistry.get_op(op)(ctx, {"X": [a]}, attrs)["Out"]
        assert torch.equal(out, a.reshape(-1))
    elif op == "zero_all_gather":
        out = tregistry.get_op(op)(ctx, {"X": [a.reshape(-1)]},
                                   {"numel": 12, "shape": [4, 3]})["Out"]
        assert torch.equal(out, a)
    else:
        out = tregistry.get_op(op)(ctx, {"X": [a]}, attrs)["Out"]
        assert torch.equal(out, a)
    assert not tregistry.route_counts("hit").get(
        (op, "dequant_accumulate", "hit", "supported"))
