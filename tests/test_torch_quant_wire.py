"""The port's blockwise wire quantization (``paddle_tpu_torch/ops/
quantize_wire.py``) against the JAX package's as its programs run it,
under ``jit``: the same float32 inputs, made with numpy from a seed, give
bit-identical int8 / int4 payloads and scales (XLA turns ``amax / qmax``
into ``amax * float32(1 / qmax)``, the port computes that; the values are
divided by their scale with an IEEE division on both sides; rounding is
half to even), and bit-identical dequantized floats; all-zero blocks take
scale 1, and ties at .5 round to even.  Run eagerly, op by op, the JAX
function divides by qmax instead: its scales are then within one float32
ulp.  ``CompressionSpec`` validates, round-trips its attr and does the
JAX package's byte arithmetic.  Stochastic rounding is held
to its statistics only: unbiased within five standard errors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import quantize_wire as jq

from paddle_tpu_torch.ops import quantize_wire as tq

TIERS = [("int8", 128), ("int8", 256), ("int8", 512), ("int4", 128),
         ("int4", 256), ("int4", 512)]


def _inputs(spec, blocks=23, seed=0):
    """Mixed magnitudes, one all-zero block, and a block of exact ties:
    its amax is qmax, so the scale is 1 and k + 0.5 stays a tie."""
    rng = np.random.RandomState(seed)
    bs, qmax = spec.block_size, spec.qmax
    x = rng.randn(blocks, bs).astype(np.float32)
    x *= rng.choice([1e-6, 1e-2, 1.0, 30.0, 1e4], (blocks, 1)).astype(
        np.float32)
    x[3] = 0.0
    ties = (rng.randint(-qmax, qmax, bs) + 0.5).astype(np.float32)
    ties[0] = qmax
    x[5] = ties
    return x.reshape(-1)


@pytest.mark.parametrize("dtype,block", TIERS)
def test_quantize_is_bit_identical_to_the_jax_package(dtype, block):
    x = _inputs(tq.CompressionSpec(dtype, block))
    jspec = jq.CompressionSpec(dtype, block)
    jq_, js = jax.jit(lambda v: jq.quantize_blockwise(v, jspec))(
        jnp.asarray(x))
    _, eager = jq.quantize_blockwise(jnp.asarray(x), jspec)
    np.testing.assert_allclose(np.asarray(eager), np.asarray(js),
                               rtol=2 ** -23, atol=0)
    tq_, ts = tq.quantize_blockwise(torch.from_numpy(x),
                                    tq.CompressionSpec(dtype, block))
    assert tq_.dtype == torch.int8 and ts.dtype == torch.float32
    assert np.array_equal(tq_.numpy(), np.asarray(jq_))
    assert np.array_equal(ts.numpy(), np.asarray(js))
    assert ts[3] == 1.0                       # the all-zero block
    if dtype == "int8":                       # ties rounded to even
        row = tq_[5].numpy().astype(np.float64)
        want = np.round(x.reshape(-1, block)[5].astype(np.float64))
        assert np.array_equal(row, want)
    back_t = tq.dequantize_blockwise(tq_, ts, tq.CompressionSpec(dtype,
                                                                 block))
    back_j = jq.dequantize_blockwise(jq_, js, jq.CompressionSpec(dtype,
                                                                 block))
    assert np.array_equal(back_t.numpy(), np.asarray(back_j))


def test_int4_unpack_sign_extends_every_nibble():
    vals = np.arange(-8, 8, dtype=np.int8)
    lo, hi = np.meshgrid(vals, vals)
    packed = ((lo & 0xF) | (hi << 4)).astype(np.int8).reshape(1, -1)
    out = tq.unpack_int4(torch.from_numpy(packed)).numpy().reshape(-1, 2)
    assert np.array_equal(out[:, 0], lo.reshape(-1))
    assert np.array_equal(out[:, 1], hi.reshape(-1))


def test_pad_to_blocks_matches():
    x = np.arange(1000, dtype=np.float32)
    for m in (1, 256, 3 * 256):
        assert np.array_equal(
            tq.pad_to_blocks(torch.from_numpy(x), m).numpy(),
            np.asarray(jq.pad_to_blocks(jnp.asarray(x), m)))


@pytest.mark.parametrize("kwargs,match", [
    ({"dtype": "fp8"}, "unknown wire dtype"),
    ({"block_size": 0}, "block_size must be positive"),
    ({"dtype": "int4", "block_size": 255}, "block_size must be even"),
])
def test_spec_validation_matches(kwargs, match):
    for mod in (tq, jq):
        with pytest.raises(ValueError, match=match):
            mod.CompressionSpec(**kwargs)


@pytest.mark.parametrize("attr", [
    None, "int4", {"dtype": "int8"},
    {"dtype": "int4", "block_size": 128, "stochastic_rounding": True},
    {"dtype": "bfloat16", "block_size": 64}])
def test_spec_attr_round_trip_and_bytes_match(attr):
    t, j = tq.CompressionSpec.from_attr(attr), jq.CompressionSpec.from_attr(
        attr)
    if attr is None:
        assert t is None and j is None
        return
    assert t.to_attr() == j.to_attr()
    assert tq.CompressionSpec.from_attr(t.to_attr()).to_attr() == t.to_attr()
    assert tq.CompressionSpec.from_attr(t) is t
    assert repr(t) == repr(j)
    assert (t.wire_bits, t.qmax) == (j.wire_bits, j.qmax)
    for numel in (1, 255, 256, 257, 23_440_896, 7_087_872):
        assert t.num_blocks(numel) == j.num_blocks(numel)
        assert t.payload_bytes(numel) == j.payload_bytes(numel)
        assert t.wire_bytes(numel) == j.wire_bytes(numel)


@pytest.mark.parametrize("attrs", [
    {}, {"compress_dtype": "bfloat16"}, {"compress_dtype": "bf16"},
    {"compress_dtype": "float16"}, {"quant_spec": {"dtype": "int4"}},
    {"quant_spec": {"dtype": "int8"}, "compress_dtype": "bfloat16"}])
def test_quant_spec_of_matches(attrs):
    t, j = tq.quant_spec_of(attrs), jq.quant_spec_of(attrs)
    assert (t is None) == (j is None)
    if t is not None:
        assert t.to_attr() == j.to_attr()


@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_stochastic_rounding_is_unbiased(dtype):
    """Every block holds qmax (so its scale is 1) and 255 copies of one
    value k + f; the mean of floor(x + u) over 400 blocks estimates x
    with a standard error of at most 0.5 / sqrt(102,000): it must land
    within five of them, where round-to-nearest is off by min(f, 1-f)."""
    spec = tq.CompressionSpec(dtype, 256, stochastic_rounding=True)
    gen = torch.Generator().manual_seed(3)
    bound = 5 * 0.5 / np.sqrt(400 * 255)
    for value in (2.25, -1.5, 0.9, -3.1):
        x = torch.full((400, 256), value)
        x[:, 0] = spec.qmax
        q, s = tq.quantize_blockwise(x.reshape(-1), spec, gen)
        assert torch.all(s == 1.0)
        deq = tq.dequantize_blockwise(q, s, spec).reshape(400, 256)[:, 1:]
        assert set(np.unique(deq.numpy())) <= {np.floor(value),
                                               np.floor(value) + 1}
        assert abs(float(deq.double().mean()) - value) <= bound, value
    # round-to-nearest (no generator) is the deterministic path
    q1, _ = tq.quantize_blockwise(x.reshape(-1), spec)
    q2, _ = tq.quantize_blockwise(x.reshape(-1), spec)
    assert torch.equal(q1, q2)


def test_stochastic_rounding_follows_its_generator():
    spec = tq.CompressionSpec("int8", 256, stochastic_rounding=True)
    x = torch.from_numpy(np.random.RandomState(1).randn(4096).astype(
        np.float32))

    def draw(seed):
        return tq.quantize_blockwise(
            x, spec, torch.Generator().manual_seed(seed))[0]
    assert torch.equal(draw(5), draw(5))
    assert not torch.equal(draw(5), draw(6))
