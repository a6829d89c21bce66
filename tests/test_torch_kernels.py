"""The port's kernel modules against the JAX package's Pallas kernels.

Each plain PyTorch version in ``paddle_tpu_torch/ops/cuda`` (the function
its CUDA kernel computes, and what a wrapper runs on CPU tensors) is held
against the TPU kernel it replaces, run in Pallas interpret mode on the
CPU as tests/test_flash_attention.py and tests/test_pallas_fused.py run
them.  Inputs come from numpy with a fixed seed.  Tolerances: 2e-5 (abs
and rel) for outputs, 1e-4 for the flash log-sum-exp; flash outputs in
bf16 and float16 within two ulps of the type of their largest value.
The CUDA kernels themselves run only on a GPU (chip_smoke.py holds them
against these plain versions there)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.pallas import fused_ops as F

from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import fused_ops as tF

TOL = 2e-5
TOL_LSE = 1e-4
#: 16-bit outputs: two ulps of the type relative to max|ref| (bf16's is
#: chip_smoke.py's BF16_REL)
REL16 = {"bfloat16": 2.0 ** -6, "float16": 2.0 ** -9}


def _close(got, ref, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _no_launches():
    """Nothing here may launch a CUDA kernel: the wrappers run their
    plain versions on CPU tensors."""
    port_cuda.reset_launch_counts()
    yield
    assert sum(port_cuda.launch_counts().values()) == 0


def _bias(rng, mode, b, h, s, sk):
    if mode == "none":
        return None
    if mode == "shared":            # BERT's padding bias, head-shared
        mask = (rng.rand(b, 1, sk) > 0.25).astype(np.float32)
        mask[:, :, 0] = 1.0
        return np.broadcast_to((mask - 1.0) * 1e4, (b, s, sk)).copy()
    return rng.randn(b * h, s, sk).astype(np.float32)   # per head


def cases16(f32, cases):
    """Parameters: the ``f32`` cases in float32 under the ids they had
    before the dtype was a parameter, and ``cases`` in bf16 and float16
    (ids ending in the dtype)."""
    return [pytest.param(*c, "float32", id="-".join(map(str, c)))
            for c in f32] + [
        pytest.param(*c, dt, id="-".join(map(str, c + (dt,))))
        for dt in ("bfloat16", "float16") for c in cases]


def close16(got, ref, dtype):
    """16-bit outputs: within REL16[dtype] of max|ref| (two ulps of the
    type, relative to the largest output)."""
    got = np.asarray(torch.as_tensor(got).float())
    ref = np.asarray(jnp.asarray(ref, jnp.float32))
    limit = REL16[dtype] * float(np.abs(ref).max())
    assert float(np.abs(got - ref).max()) <= limit


@pytest.mark.parametrize("mode,causal,s,d,dtype", cases16(
    [("none", False, 128, 64), ("shared", False, 256, 64),
     ("perhead", False, 128, 64), ("none", True, 256, 64),
     ("shared", False, 128, 128)],
    [("shared", False, 128, 64), ("none", True, 256, 64),
     ("perhead", False, 128, 128)]))
def test_flash_plain_matches_pallas_interpret(mode, causal, s, d, dtype):
    """Float32, and the same numpy inputs cast to bf16 / float16 in both
    packages (the bias stays float32): o within two ulps of the type of
    max|o| there, lse (float32) within TOL_LSE."""
    rng = np.random.RandomState(0)
    b, h = 2, 2
    q, k, v = (rng.randn(b * h, s, d).astype(np.float32) for _ in range(3))
    bias = _bias(rng, mode, b, h, s, s)
    seed = jnp.zeros((1,), jnp.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    ref_o, ref_lse = fa._flash_fwd(
        *(jnp.asarray(a).astype(jdt) for a in (q, k, v)),
        None if bias is None else jnp.asarray(bias), seed, 0.0, causal,
        True)
    o, lse = tfa.flash_fwd(*(torch.from_numpy(a).to(tdt) for a in (q, k, v)),
                           None if bias is None else torch.from_numpy(bias),
                           causal=causal)
    assert o.shape == (b * h, s, d) and lse.shape == (b * h, s, 1)
    assert o.dtype == tdt and lse.dtype == torch.float32
    if dtype == "float32":
        _close(o, ref_o)
    else:
        close16(o, ref_o, dtype)
    _close(lse, ref_lse, TOL_LSE)


def test_flash_bshd_broadcasts_a_key_mask_like_the_tpu_wrapper():
    """(B, 1, 1, Sk) masks broadcast over queries and heads exactly as
    flash_attention_bshd does."""
    rng = np.random.RandomState(1)
    b, h, s, d = 2, 3, 128, 64
    q, k, v = (rng.randn(b, h, s, d).astype(np.float32) for _ in range(3))
    mask = (rng.rand(b, 1, 1, s) > 0.3).astype(np.float32)
    mask[..., 0] = 1.0
    bias = (1.0 - mask) * -1e9
    ref = fa.flash_attention_bshd(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), jnp.asarray(bias),
                                  interpret=True)
    got = tfa.flash_attention_bshd(torch.from_numpy(q), torch.from_numpy(k),
                                   torch.from_numpy(v),
                                   torch.from_numpy(bias))
    _close(got, ref)


def test_flash_fully_masked_rows_give_inf_lse_and_zero_output():
    """A row whose every key is -inf has l == 0: o is 0 and lse +inf, the
    TPU kernel's contract for the backward's exp(s - lse)."""
    q = torch.randn(1, 4, 64)
    bias = torch.zeros(1, 4, 4)
    bias[0, 2, :] = -float("inf")
    o, lse = tfa.flash_fwd(q, q, q, bias)
    assert torch.isinf(lse[0, 2, 0]) and lse[0, 2, 0] > 0
    assert torch.count_nonzero(o[0, 2]) == 0
    assert torch.isfinite(lse[0, [0, 1, 3]]).all()


@pytest.mark.parametrize("rows,d", [(200, 256), (40, 768)])
def test_layer_norm_plain_matches_pallas_interpret(rows, d):
    rng = np.random.RandomState(2)
    x = (rng.randn(rows, d) * 3 + 1).astype(np.float32)   # edge block
    s = (rng.rand(d) + 0.5).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    ref = F.layer_norm(jnp.asarray(x), jnp.asarray(s), jnp.asarray(b),
                       1e-5, True)
    got = tF.layer_norm(torch.from_numpy(x), torch.from_numpy(s),
                        torch.from_numpy(b), 1e-5)
    _close(got, ref)


@pytest.mark.parametrize("rows,d", [(200, 256), (40, 768)])
def test_add_layer_norm_plain_matches_pallas_interpret(rows, d):
    rng = np.random.RandomState(3)
    a = rng.randn(rows, d).astype(np.float32)
    r = rng.randn(rows, d).astype(np.float32)
    s = (rng.rand(d) + 0.5).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    ref = F.add_layer_norm(jnp.asarray(a), jnp.asarray(r), jnp.asarray(s),
                           jnp.asarray(b), 1e-5, True)
    got = tF.add_layer_norm(torch.from_numpy(a), torch.from_numpy(r),
                            torch.from_numpy(s), torch.from_numpy(b), 1e-5)
    _close(got, ref)


@pytest.mark.parametrize("rows,d", [(200, 384), (40, 3072)])
def test_bias_gelu_plain_matches_pallas_interpret(rows, d):
    rng = np.random.RandomState(4)
    x = (rng.randn(rows, d) * 2).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    ref = F.bias_gelu(jnp.asarray(x), jnp.asarray(b), True)
    got = tF.bias_gelu(torch.from_numpy(x), torch.from_numpy(b))
    _close(got, ref)


def test_bf16_plain_versions_round_like_the_kernels():
    """bfloat16 inputs: statistics in float32, one rounding at the end —
    within two bf16 ulps of the float32 computation."""
    rng = np.random.RandomState(5)
    x = torch.from_numpy(rng.randn(64, 256).astype(np.float32))
    s, b = torch.ones(256), torch.zeros(256)
    y16 = tF.layer_norm(x.bfloat16(), s.bfloat16(), b.bfloat16())
    assert y16.dtype == torch.bfloat16
    y32 = tF.layer_norm(x.bfloat16().float(), s, b)
    assert float((y16.float() - y32).abs().max()) <= \
        2.0 ** -6 * float(y32.abs().max())
    g16 = tF.bias_gelu(x.bfloat16(), b.bfloat16())
    assert g16.dtype == torch.bfloat16


def test_gates_state_what_the_kernels_reject():
    assert tfa.supported(128, 128, 64) == (True, "")
    assert tfa.supported(77, 100, 64)[0]            # any lengths
    assert tfa.supported(128, 128, 80) == (False, "head-dim:80")
    assert tfa.supported(128, 256, 64, causal=True) == \
        (False, "causal-rectangular")
    assert tfa.supported(128, 128, 64, dropout_rate=0.1) == (True, "")
    assert tfa.supported(128, 128, 64, dropout_rate=1.0) == \
        (False, "dropout-rate:1.0")
    assert tfa.supported(128, 128, 64, torch.float16) == (True, "")
    assert tfa.supported(128, 128, 64, torch.float64)[1].startswith(
        "dtype:")
    assert tF.ln_supported(768) == (True, "")
    assert tF.ln_supported(8320) == (False, "norm-dim:8320")
    assert tF.ln_supported(200) == (False, "norm-dim:200")
    assert tF.bg_supported(3072) == (True, "")
    assert tF.bg_supported(16512) == (False, "dim:16512")
    with pytest.raises(ValueError, match="dropout"):
        tfa.flash_fwd(torch.zeros(1, 4, 64), torch.zeros(1, 4, 64),
                      torch.zeros(1, 4, 64), dropout_rate=0.1)
