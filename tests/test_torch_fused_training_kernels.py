"""The fused-training kernels' plain versions against the JAX package's
Pallas kernels: add+LayerNorm backward (``_aln_bwd_kernel``) and bias+GELU
backward (``_bg_bwd_kernel``).

Each twin in ``paddle_tpu_torch/ops/cuda/fused_ops.py`` (the explicit
formula its CUDA kernel computes) is held against ``jax.vjp`` of the
Pallas forward, whose ``custom_vjp`` backward is the Pallas backward
kernel, run in interpret mode on the CPU.  Row counts 7 and 300 leave a
ragged last block of the Pallas kernels' 128 rows (their ``_row_mask``).
Inputs come from numpy with a fixed seed, float32.  Tolerances: dx 1e-5
(abs and rel); the column sums (dscale, dbias, db) 2e-5 of
max(1, max|ref|).  The CUDA kernels themselves run only on a GPU
(chip_smoke.py holds them against these twins there)."""

import jax
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import fused_ops as F

from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda import fused_ops as tF

TOL_DX = 1e-5
TOL_SUM = 2e-5
SHAPES = [(r, d) for r in (7, 128, 300) for d in (128, 768)]


@pytest.fixture(autouse=True)
def _no_launches():
    """Nothing here may launch a CUDA kernel: the wrappers run their
    plain versions on CPU tensors."""
    port_cuda.reset_launch_counts()
    yield
    assert sum(port_cuda.launch_counts().values()) == 0


def _inputs(rows, d, *names):
    rng = np.random.RandomState(rows * 7 + d)
    out = {}
    for n in names:
        if n == "scale":
            out[n] = (1.0 + 0.1 * rng.randn(d)).astype(np.float32)
        elif n in ("bias", "lnbias"):
            out[n] = (0.1 * rng.randn(d)).astype(np.float32)
        else:
            out[n] = rng.randn(rows, d).astype(np.float32)
    return out


def _close_dx(got, ref):
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=TOL_DX,
                               atol=TOL_DX)


def _close_sum(got, ref):
    ref = np.asarray(ref)
    limit = TOL_SUM * max(1.0, float(np.abs(ref).max()))
    assert float(np.abs(got.numpy() - ref).max()) <= limit


@pytest.mark.parametrize("rows,d", SHAPES)
def test_add_layer_norm_bwd_plain_matches_pallas_interpret(rows, d):
    v = _inputs(rows, d, "a", "b", "scale", "lnbias", "dy")
    _, vjp = jax.vjp(
        lambda a, b, s, bb: F.add_layer_norm(a, b, s, bb, 1e-5, True),
        v["a"], v["b"], v["scale"], v["lnbias"])
    da, db, ds, dbias = vjp(v["dy"])
    t = {k: torch.from_numpy(a) for k, a in v.items()}
    dx, dscale, dbias_p = tF.add_layer_norm_bwd_plain(
        t["a"], t["b"], t["scale"], t["dy"], 1e-5)
    _close_dx(dx, da)
    _close_dx(dx, db)               # one dx for both addends
    _close_sum(dscale, ds)
    _close_sum(dbias_p, dbias)


@pytest.mark.parametrize("rows,d", SHAPES)
def test_bias_gelu_bwd_plain_matches_pallas_interpret(rows, d):
    v = _inputs(rows, d, "x", "bias", "dy")
    _, vjp = jax.vjp(lambda x, b: F.bias_gelu(x, b, True), v["x"], v["bias"])
    dx_ref, db_ref = vjp(v["dy"])
    dx, db = tF.bias_gelu_bwd_plain(*(torch.from_numpy(v[k])
                                      for k in ("x", "bias", "dy")))
    _close_dx(dx, dx_ref)
    _close_sum(db, db_ref)


@pytest.mark.parametrize("op", ["add_layer_norm", "bias_gelu"])
def test_autograd_functions_run_the_backward_twins_on_cpu(op):
    """``add_layer_norm``/``bias_gelu`` on inputs that need a gradient go
    through ``AddLayerNorm``/``BiasGelu``; on CPU tensors their backward
    is the twin, bit for bit."""
    if op == "add_layer_norm":
        v = _inputs(40, 256, "a", "b", "scale", "lnbias", "dy")
        t = [torch.from_numpy(v[k]) for k in ("a", "b", "scale", "lnbias")]
        fn, cls = tF.add_layer_norm, tF.AddLayerNorm
        dx, ds, dbias = tF.add_layer_norm_bwd_plain(
            t[0], t[1], t[2], torch.from_numpy(v["dy"]))
        want = (dx, dx, ds, dbias)
    else:
        v = _inputs(40, 256, "x", "bias", "dy")
        t = [torch.from_numpy(v[k]) for k in ("x", "bias")]
        fn, cls = tF.bias_gelu, tF.BiasGelu
        want = tF.bias_gelu_bwd_plain(t[0], t[1], torch.from_numpy(v["dy"]))
    leaves = [a.clone().requires_grad_(True) for a in t]
    y = fn(*leaves)
    assert type(y.grad_fn).__name__ == f"{cls.__name__}Backward"
    got = torch.autograd.grad(y, leaves, torch.from_numpy(v["dy"]))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    with torch.no_grad():           # no autograd: the forward alone
        assert fn(*leaves).grad_fn is None
