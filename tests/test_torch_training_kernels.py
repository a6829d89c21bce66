"""The port's training kernels' plain versions against the JAX package's
Pallas kernels, and the port's dropout against itself.

Each backward twin in ``paddle_tpu_torch/ops/cuda`` (the function its CUDA
kernel computes, written out as explicit formulas) is held against the TPU
kernel it replaces, run in Pallas interpret mode on the CPU as
tests/test_flash_attention.py and tests/test_pallas_fused.py run them.
Inputs come from numpy with a fixed seed.  Tolerances
(KERNEL_CENSUS_r15.json ``parity``): flash gradients 2e-4, LayerNorm
gradients 2e-5, Adam 1e-5, abs and rel; flash gradients in bf16 and
float16 within two ulps of the type of their largest value.

The Pallas flash kernel refuses dropout in interpret mode (its hardware
generator has no interpreter), so the port's dropout is tested on its
own: the keep fraction, the mask's dependence on the seed alone, and the
explicit backward against autograd of a dense masked softmax with the
same mask.  The CUDA kernels themselves run only on a GPU (chip_smoke.py
holds them against these plain versions there)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import flash_attention as fa
from paddle_tpu.ops.pallas import fused_ops as F

from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import fused_ops as tF
from paddle_tpu_torch.ops.cuda import optimizer as topt
from test_torch_kernels import cases16, close16

TOL_FLASH_GRAD = 2e-4
TOL_LN_GRAD = 2e-5
TOL_ADAM = 1e-5


def _close(got, ref, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref),
                               rtol=tol, atol=tol)


@pytest.fixture(autouse=True)
def _no_launches():
    """Nothing here may launch a CUDA kernel: the wrappers run their
    plain versions on CPU tensors."""
    port_cuda.reset_launch_counts()
    yield
    assert sum(port_cuda.launch_counts().values()) == 0


def _bias(rng, mode, b, h, s):
    if mode == "none":
        return None
    if mode == "shared":            # BERT's padding bias, head-shared
        mask = (rng.rand(b, 1, s) > 0.25).astype(np.float32)
        mask[:, :, 0] = 1.0
        return np.broadcast_to((mask - 1.0) * 1e4, (b, s, s)).copy()
    return rng.randn(b * h, s, s).astype(np.float32)    # per head


def _t(a):
    return None if a is None else torch.from_numpy(a)


@pytest.mark.parametrize("mode,causal,s,d,dtype", cases16(
    [("none", False, 128, 64), ("shared", False, 128, 64),
     ("perhead", False, 128, 64), ("none", True, 256, 64),
     ("shared", False, 256, 128), ("perhead", True, 128, 128)],
    [("shared", False, 128, 64), ("none", True, 256, 64),
     ("perhead", True, 128, 128)]))
def test_flash_bwd_plain_matches_pallas_interpret(mode, causal, s, d, dtype):
    """Float32, and the same numpy inputs cast to bf16 / float16 in both
    packages (the bias stays float32): each gradient within two ulps of
    the type of its largest value there."""
    rng = np.random.RandomState(10)
    b, h = 2, 2
    q, k, v, do = (rng.randn(b * h, s, d).astype(np.float32)
                   for _ in range(4))
    bias = _bias(rng, mode, b, h, s)
    seed = jnp.zeros((1,), jnp.int32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    fn = fa._make_flash(0.0, bias is not None, causal, True)
    jb = None if bias is None else jnp.asarray(bias)
    _, vjp = jax.vjp(lambda q_, k_, v_: fn(q_, k_, v_, jb, seed),
                     *(jnp.asarray(a).astype(jdt) for a in (q, k, v)))
    ref = vjp(jnp.asarray(do).astype(jdt))
    q16, k16, v16, do16 = (_t(a).to(tdt) for a in (q, k, v, do))
    o, lse = tfa.flash_fwd(q16, k16, v16, _t(bias), causal)
    got = tfa.flash_bwd_plain(q16, k16, v16, _t(bias), o, lse, do16, causal)
    for g, r in zip(got, ref):
        assert g.dtype == tdt
        if dtype == "float32":
            _close(g, r, TOL_FLASH_GRAD)
        else:
            close16(g, r, dtype)


@pytest.mark.parametrize("rows,d", [(200, 256), (40, 768), (128, 128)])
def test_layer_norm_bwd_plain_matches_pallas_interpret(rows, d):
    """rows 200 and 40 leave a partial 128-row block in the TPU kernel."""
    rng = np.random.RandomState(11)
    x = (rng.randn(rows, d) * 3 + 1).astype(np.float32)
    s = (rng.rand(d) + 0.5).astype(np.float32)
    b = rng.randn(d).astype(np.float32)
    dy = rng.randn(rows, d).astype(np.float32)
    _, vjp = jax.vjp(lambda x_, s_, b_: F.layer_norm(x_, s_, b_, 1e-5, True),
                     jnp.asarray(x), jnp.asarray(s), jnp.asarray(b))
    ref = vjp(jnp.asarray(dy))
    got = tF.layer_norm_bwd_plain(_t(x), _t(s), _t(dy), 1e-5)
    for g, r in zip(got, ref):
        _close(g, r, TOL_LN_GRAD)


@pytest.mark.parametrize("n", [8 * 1024, 3 * 128])
def test_adam_plain_matches_pallas_interpret(n):
    """The port's Adam takes the op's LR and beta powers and forms the
    bias-corrected step itself; the Pallas kernel is given that step."""
    rng = np.random.RandomState(12)
    p = rng.randn(n).astype(np.float32)
    g = rng.randn(n).astype(np.float32)
    m = rng.randn(n).astype(np.float32) * 0.1
    v = np.abs(rng.randn(n)).astype(np.float32) * 0.01
    lr = torch.tensor([0.01])
    b1p, b2p = torch.tensor([0.9 ** 3]), torch.tensor([0.999 ** 3])
    lr_t = float(lr * torch.sqrt(1 - b2p) / (1 - b1p))
    ref = F.adam_update(jnp.asarray(p), jnp.asarray(g), jnp.asarray(m),
                        jnp.asarray(v), lr_t, beta1=0.9, beta2=0.999,
                        eps=1e-8, interpret=True)
    tp, tm, tv = (torch.from_numpy(a.copy()) for a in (p, m, v))
    got = topt.adam(tp, torch.from_numpy(g), tm, tv, lr, b1p, b2p)
    assert got[0] is tp and got[1] is tm and got[2] is tv    # in place
    for a, r in zip(got, ref):
        _close(a, r, TOL_ADAM)
    assert float(b1p) == np.float32(np.float32(0.9 ** 3) * np.float32(0.9))
    assert float(b2p) == np.float32(np.float32(0.999 ** 3) *
                                    np.float32(0.999))


def test_adam_takes_any_numel_and_refuses_mismatched_operands():
    """Unlike the TPU gate (numel % 128 == 0, >= 1024): BERT-base's LN
    scales and biases (768) and next_sent_fc.b_0 (2) take the kernel."""
    for n in (768, 2, 30522):
        z = torch.zeros(n)
        assert topt.adam_supported(z, z, z, z) == (True, "")
    z = torch.zeros(4)
    assert topt.adam_supported(z, torch.zeros(5), z, z) == \
        (False, "shape-mismatch")
    assert topt.adam_supported(z.double(), z, z, z)[1].startswith("dtype:")


def test_functions_backward_run_the_explicit_twins_on_cpu():
    """autograd through flash_attention_bshd and layer_norm on CPU tensors
    gives exactly the twins' explicit backward (the Functions call the
    backward wrappers, which run the twins here)."""
    rng = np.random.RandomState(13)
    b, h, s, d = 2, 2, 128, 64
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, s, d).astype(
        np.float32)) for _ in range(4))
    mask = torch.from_numpy((rng.rand(b, 1, 1, s) > 0.2).astype(np.float32))
    bias = (mask - 1.0) * 1e4
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    out = tfa.flash_attention_bshd(qg, kg, vg, bias)
    grads = torch.autograd.grad(out, (qg, kg, vg), do)
    flat = [t.reshape(b * h, s, d) for t in (q, k, v, do)]
    bf = bias.expand(b, 1, s, s).reshape(b, s, s).contiguous()
    o, lse = tfa.flash_fwd_plain(flat[0], flat[1], flat[2], bf)
    ref = tfa.flash_bwd_plain(flat[0], flat[1], flat[2], bf, o, lse,
                              flat[3])
    for g, r in zip(grads, ref):
        assert torch.equal(g.reshape(b * h, s, d), r)

    x = torch.from_numpy(rng.randn(40, 256).astype(np.float32))
    sc = torch.from_numpy((rng.rand(256) + 0.5).astype(np.float32))
    bb = torch.from_numpy(rng.randn(256).astype(np.float32))
    dy = torch.from_numpy(rng.randn(40, 256).astype(np.float32))
    leaves = [t.clone().requires_grad_(True) for t in (x, sc, bb)]
    y = tF.layer_norm(*leaves)
    got = torch.autograd.grad(y, leaves, dy)
    for g, r in zip(got, tF.layer_norm_bwd_plain(x, sc, dy)):
        assert torch.equal(g, r)


# ---------------------------------------------------------------------------
# dropout: the port's own consistency
# ---------------------------------------------------------------------------


def test_philox_matches_the_published_known_answer():
    """Philox-4x32-10 of counter 0, key 0 is 6627e8d5 in its first word
    (the Random123 known-answer vectors)."""
    bits = tfa.philox_bits(torch.tensor([0], dtype=torch.int32), 1, 1, 1)
    assert int(bits[0, 0, 0]) == 0x6627E8D5


def test_philox_four_words_match_the_published_known_answer():
    """All four words of counter 0, key 0 (Random123's kat_vectors:
    6627e8d5 e169c58d bc57ac4c 9b00dbd8), and where the mask takes them:
    elements (row, col) (0, 0), (0, 1), (8, 0) and (8, 1) of one draw."""
    zero = torch.tensor([0], dtype=torch.int32)
    c = torch.tensor(0)
    words = tfa.philox_words(zero, c, c, c)
    assert [int(w) for w in words] == [0x6627E8D5, 0xE169C58D, 0xBC57AC4C,
                                       0x9B00DBD8]
    bits = tfa.philox_bits(zero, 1, 16, 2)
    assert [int(bits[0, r, col]) for r, col in ((0, 0), (0, 1), (8, 0),
                                                (8, 1))] == \
        [int(w) for w in words]


def test_dropout_mapping_is_a_bijection_and_matches_its_definition():
    """(bh, row, col) -> counter (col >> 1, row & ~8, bh), word
    2 * ((row >> 3) & 1) + (col & 1) is one-to-one, and philox_bits gives
    that word of that draw for every element of a ragged grid."""
    bh, sq, sk = 3, 41, 13
    seen = set()
    for b in range(bh):
        for r in range(sq):
            for c in range(sk):
                seen.add((c >> 1, r & ~8, b, 2 * ((r >> 3) & 1) + (c & 1)))
    assert len(seen) == bh * sq * sk
    seed = torch.tensor([1234], dtype=torch.int32)
    bits = tfa.philox_bits(seed, bh, sq, sk)
    b = torch.arange(bh).view(-1, 1, 1)
    r = torch.arange(sq).view(1, -1, 1)
    c = torch.arange(sk).view(1, 1, -1)
    words = torch.stack(torch.broadcast_tensors(
        *tfa.philox_words(seed, c >> 1, r & ~8, b)), dim=-1)
    pick = (2 * ((r >> 3) & 1) + (c & 1)).expand(bh, sq, sk)
    assert torch.equal(bits, words.gather(-1, pick[..., None])[..., 0])


@pytest.mark.parametrize("rate", [0.1, 0.5])
def test_dropout_words_of_one_draw_are_independent(rate):
    """The pairs of elements that share a draw -- adjacent columns c, c + 1
    (c even) and rows r, r + 8 -- are both dropped as often as two
    independent elements, rate^2, within 1e-3 over more than 5e5 pairs
    each (about 7 standard deviations at rate 0.1); the keep fraction is
    1 - rate within 0.003."""
    seed = torch.tensor([97], dtype=torch.int32)
    drop = ~tfa.dropout_keep(seed, rate, 16, 256, 256)       # 1,048,576
    assert abs(float(drop.float().mean()) - rate) <= 0.003
    cols = (drop[:, :, 0::2] & drop[:, :, 1::2]).float()
    rows = (drop.view(16, 16, 2, 8, 256)[:, :, 0] &
            drop.view(16, 16, 2, 8, 256)[:, :, 1]).float()
    for pairs in (cols, rows):
        assert pairs.numel() >= 5 * 10 ** 5
        assert abs(float(pairs.mean()) - rate ** 2) <= 1e-3, \
            float(pairs.mean())


def test_dropout_keep_fraction_and_seed_dependence():
    seed = torch.tensor([20240], dtype=torch.int32)
    keep = tfa.dropout_keep(seed, 0.1, 16, 256, 256)       # 1,048,576
    assert keep.numel() >= 10 ** 6
    frac = float(keep.float().mean())
    assert abs(frac - 0.9) <= 0.003, frac
    again = tfa.dropout_keep(seed.clone(), 0.1, 16, 256, 256)
    assert torch.equal(keep, again)
    other = tfa.dropout_keep(torch.tensor([20241], dtype=torch.int32), 0.1,
                             16, 256, 256)
    assert 0.1 < float((keep != other).float().mean()) < 0.3
    # keyed on the element: a sub-problem sees the same bits
    sub = tfa.dropout_keep(seed, 0.1, 4, 100, 77)
    assert torch.equal(sub, keep[:4, :100, :77])


@pytest.mark.parametrize("causal,bias_mode", [(False, "shared"),
                                              (True, "none")])
def test_flash_dropout_twins_match_autograd_of_a_dense_composition(
        causal, bias_mode):
    """With the mask the kernels draw, the forward twin equals
    dropout(softmax(s)) @ v and the explicit backward twin equals autograd
    of that dense composition."""
    rng = np.random.RandomState(14)
    b, h, s, d, rate = 2, 2, 96, 64, 0.1
    q, k, v, do = (torch.from_numpy(rng.randn(b * h, s, d).astype(
        np.float32)) for _ in range(4))
    bias = _t(_bias(rng, bias_mode, b, h, s))
    seed = torch.tensor([777], dtype=torch.int32)
    keep = tfa.dropout_keep(seed, rate, b * h, s, s)

    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    scores = torch.matmul(leaves[0], leaves[1].transpose(1, 2)) / d ** 0.5
    if bias is not None:
        scores = scores + bias.repeat_interleave(h, dim=0)
    if causal:
        tri = torch.ones(s, s, dtype=torch.bool).tril()
        scores = scores.masked_fill(~tri, -1e30)
    probs = torch.softmax(scores, dim=-1)
    dense = torch.matmul(torch.where(keep, probs / (1 - rate),
                                     torch.zeros(())), leaves[2])
    ref_grads = torch.autograd.grad(dense, leaves, do)

    o, lse = tfa.flash_fwd(q, k, v, bias, causal, rate, seed)
    _close(o, dense.detach(), 2e-5)
    got = tfa.flash_bwd(q, k, v, bias, o, lse, do, causal, rate, seed)
    for g, r in zip(got, ref_grads):
        _close(g, r, 2e-5)
    # a different seed gives different gradients
    other = tfa.flash_bwd(q, k, v, bias, o, lse, do, causal, rate,
                          torch.tensor([778], dtype=torch.int32))
    assert not torch.allclose(other[2], got[2])


def test_dropout_needs_a_seed():
    z = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError, match="seed"):
        tfa.flash_fwd(z, z, z, dropout_rate=0.1)
