"""The launch plan and the arithmetic of the port's quantized all-reduce
receive-stage kernels (``paddle_tpu_torch/ops/cuda/csrc/quant_accumulate.cu``:
#11 dequant-accumulate, #12 dequant-accumulate-requantize).

The kernels run only on a GPU (chip_smoke.py phase 9 holds them against
their plain twins there).  What these tests reach on the CPU:

* ``quant_kernels.quant_plan``, the pure function that picks the launch:
  every row is taken exactly once by the blocks' row groups, a row's lanes
  cover its C payload bytes exactly once, the numbers are ones the C entry
  points accept, and the plan depends on its arguments alone, never on
  the device;
* a numpy model of the kernels' arithmetic in float32 and uint32 bit
  operations — int8 and int4 to float through the mantissa of 2^23 (a
  byte permute and one subtraction), acc = fma(q, s, acc) over the peers
  in order, the block scale amax * (1/qmax), the quotient from the
  block's correctly rounded reciprocal with Markstein's correction (or
  IEEE division outside the fast range), the clip, and rint with the
  int8 taken from the low byte of q + 1.5 * 2^23 — held bit for bit
  against IEEE division over every float32 significand of a binade, and
  against the Pallas kernels in interpret mode (on payloads the JAX
  package quantized, and on adversarial payloads: every byte and nibble,
  exact .5 quotients, |acc| = amax, quotients past qmax, amax = 0,
  subnormal, tiny and near-FLT_MAX amax, the fast range's edges) and the
  port's plain twins.  XLA flushes subnormal floats to zero on the CPU,
  so on subnormal payloads the Pallas kernel is no reference: there the
  model is held to the twins alone.

Inputs come from numpy with a fixed seed."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import quantize_wire as jq
from paddle_tpu.ops.pallas import quant_kernels as jqk

from paddle_tpu_torch.ops import quantize_wire as tq
from paddle_tpu_torch.ops.cuda import quant_kernels as tqk

F32, U32 = np.float32, np.uint32
BYTE_BIAS = F32(2.0 ** 23 + 128)
NIBBLE_BIAS = F32(2.0 ** 23 + 8)
RINT_MAGIC = F32(1.5 * 2.0 ** 23)
FAST_LO, FAST_HI = F32(2.0 ** -64), F32(2.0 ** 64)
INV_QMAX = F32(1.0) / F32(127.0)
TOL_ACC = 1e-5             # #11 against the Pallas kernel (abs)
TOL_ACC_BLOCK = 1e-6       # #11, each block of its own max|reference|


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


def _one_pass_vec(int4, requant):
    return 16 if requant else (2 if int4 else 4)


def _c_accepts(plan, n, cols, int4, requant):
    """csrc/quant_accumulate.cu plan_ok and the dispatch's instantiations,
    restated."""
    m = cols // plan.vec
    assert plan.vec in (16, 8, 4, 2, 1) and cols % plan.vec == 0
    assert plan.group == (32 if m >= 32 else 1 << (m - 1).bit_length())
    assert plan.blocks >= 1
    if plan.chunks == 0:
        assert plan.rows == 1 and plan.peers == 0
        if not requant:       # #11's loop kernels: the float4 chunk or bytes
            assert plan.vec in ((2, 1) if int4 else (4, 2, 1))
        return
    assert plan.chunks <= (1 if requant else 2)
    assert m <= plan.chunks * plan.group
    assert plan.rows == tqk.QUANT_ROWS
    assert plan.peers == n and n in tqk.QUANT_PEERS
    assert plan.vec == _one_pass_vec(int4, requant)


def _rows_taken(plan, sb):
    """How often each row is taken: block b's warp w is grid warp
    g = b * QUANT_WARPS + w, and pass t of it takes rows (g + t * warps)
    * per_warp + r * groups_per_warp + group for r < rows."""
    gpw = 32 // plan.group
    per_warp = gpw * plan.rows
    warps = plan.blocks * tqk.QUANT_WARPS
    passes = -(-sb // (warps * per_warp))
    g = np.arange(warps)[:, None, None, None]
    t = np.arange(passes)[None, :, None, None]
    r = np.arange(plan.rows)[None, None, :, None]
    gi = np.arange(gpw)[None, None, None, :]
    rows = ((g + t * warps) * per_warp + r * gpw + gi).reshape(-1)
    return np.bincount(rows[rows < sb], minlength=sb)


def _bytes_taken(plan, cols):
    """How often each payload byte of a row is loaded: lane l of the group
    takes chunks l + k * group (k < chunks; the loop kernels: every such
    chunk below cols / vec), vec bytes each."""
    m = cols // plan.vec
    per_lane = plan.chunks or -(-m // plan.group)
    c = (np.arange(plan.group)[:, None] +
         np.arange(per_lane)[None, :] * plan.group).reshape(-1)
    c = c[c < m]
    b = (c[:, None] * plan.vec + np.arange(plan.vec)[None, :]).reshape(-1)
    return np.bincount(b, minlength=cols)


PLAN_SB = (1, 13, 1003, 13844, 45783)
PLAN_KINDS = [("int8", 256, False), ("int8", 128, False),
              ("int4", 256, False), ("int4", 128, False),
              ("int8", 256, True), ("int8", 128, True)]


@pytest.mark.parametrize("aligned", [True, False])
@pytest.mark.parametrize("dtype,block,requant", PLAN_KINDS)
@pytest.mark.parametrize("sb", PLAN_SB)
@pytest.mark.parametrize("n", [2, 3, 4, 8, 16])
def test_plan_takes_every_row_once_and_covers_the_row(n, sb, dtype, block,
                                                      requant, aligned):
    int4 = dtype == "int4"
    cols = tq.CompressionSpec(dtype, block).payload_cols
    plan = tqk.quant_plan(n, sb, cols, int4, aligned, requant=requant)
    _c_accepts(plan, n, cols, int4, requant)
    assert np.array_equal(_rows_taken(plan, sb), np.ones(sb, np.int64))
    assert np.array_equal(_bytes_taken(plan, cols), np.ones(cols, np.int64))
    per_block = tqk.QUANT_WARPS * (32 // plan.group) * plan.rows
    assert plan.blocks == min(-(-sb // per_block),
                              tqk.QUANT_SMS * tqk.QUANT_BLOCKS_PER_SM)
    if aligned:
        # these widths take 16-byte chunks for #12, a float4 of output a
        # chunk for #11; the one-pass kernels at the compiled peer counts
        assert plan.vec == _one_pass_vec(int4, requant)
        assert (plan.chunks >= 1) == (n in tqk.QUANT_PEERS)
    else:
        assert plan.vec == 1 and plan.chunks == 0


@pytest.mark.parametrize("cols", [1, 2, 3, 48, 100, 130, 384, 512, 513,
                                  1024, 12288])
@pytest.mark.parametrize("int4,requant", [(False, False), (True, False),
                                          (False, True)])
def test_plan_takes_odd_and_wide_rows(cols, int4, requant):
    """Widths off the main path: odd ones take narrower chunks, rows wider
    than one pass the loop kernels — still every byte once."""
    for aligned in (True, False):
        plan = tqk.quant_plan(3, 1003, cols, int4, aligned, requant=requant)
        _c_accepts(plan, 3, cols, int4, requant)
        assert np.array_equal(_rows_taken(plan, 1003), np.ones(1003))
        assert np.array_equal(_bytes_taken(plan, cols), np.ones(cols))


def test_plan_depends_on_its_arguments_alone(monkeypatch):
    args = [(2, 45783, 256, False, True, True), (2, 13844, 128, True, True),
            (8, 1003, 64, True, False), (3, 13, 100, False, True, True)]
    before = [tqk.quant_plan(*a) for a in args]

    def no_device(*_a, **_k):
        raise AssertionError("quant_plan asked about the device")
    for name in ("is_available", "device_count", "get_device_properties",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    assert [tqk.quant_plan(*a) for a in args] == before
    with pytest.raises(ValueError):
        tqk.quant_plan(2, 13, 128, True, True, requant=True)
    with pytest.raises(ValueError):
        tqk.quant_plan(2, 0, 256, False, True)


# ---------------------------------------------------------------------------
# the arithmetic model
# ---------------------------------------------------------------------------


def fma32(a, b, c):
    """float32 fma(a, b, c), rounded once: the product is exact in
    float64, the sum is rounded to odd in float64 (TwoSum), and round to
    odd then to float32 is the float32 rounding of the exact value."""
    a, b, c = np.broadcast_arrays(np.asarray(a, F32), np.asarray(b, F32),
                                  np.asarray(c, F32))
    p = a.astype(np.float64) * b.astype(np.float64)
    c64 = c.astype(np.float64)
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    odd_fix = (err != 0) & ((s.view(np.int64) & 1) == 0)
    s = np.where(odd_fix, np.nextafter(s, np.where(err > 0, np.inf, -np.inf)),
                 s)
    return s.astype(F32)


def unbias(biased, bias):
    """__byte_perm(w, 0x4B000000, 0x7650 | j) then __fsub_rn(., bias): the
    biased byte in the low mantissa byte of 2^23."""
    return (U32(0x4B000000) | biased.astype(U32)).view(F32) - bias


def model_values(payload, int4):
    """(rows, C) int8 payload -> (rows, block) float32 values, as the
    kernels make them: the word xor 0x80808080 (int8) or 0x88888888 (int4)
    biases each byte or nibble, then unbias."""
    u = payload.view(np.uint8)
    if not int4:
        return unbias(u ^ 0x80, BYTE_BIAS)
    b = u ^ 0x88
    lo, hi = unbias(b & 0x0F, NIBBLE_BIAS), unbias((b >> 4) & 0x0F,
                                                    NIBBLE_BIAS)
    return np.stack([lo, hi], axis=-1).reshape(u.shape[0], -1)


def model_accumulate(payload, scales, n, int4):
    """#11: acc = fma(q, s, acc) over the peers in order, from zeros."""
    v = model_values(payload, int4)
    sb = v.shape[0] // n
    v = v.reshape(n, sb, -1)
    s = np.asarray(scales, F32).reshape(n, sb, 1)
    acc = np.zeros(v.shape[1:], F32)
    for p in range(n):
        acc = fma32(v[p], s[p], acc)
    return acc


def model_quotient(x, scale, y):
    """Markstein's correction with the block's correctly rounded
    reciprocal y: q0 = x * y, r = fma(-scale, q0, x), fma(r, y, q0)."""
    q0 = (np.asarray(x, F32) * y).astype(F32)
    return fma32(fma32(-scale, q0, x), y, q0)


def model_rint_byte(q, qmax=F32(127.0)):
    """clip(q, +-qmax) (fminf / fmaxf: NaN gives -qmax) plus 1.5 * 2^23,
    rounded to float32; the int8 is the low byte of its bits."""
    t = (np.fmin(np.fmax(q, -qmax), qmax) + RINT_MAGIC).astype(F32)
    return (t.view(U32) & 0xFF).astype(np.uint8).view(np.int8)


def model_requant(acc, qmax=F32(127.0), inv_qmax=INV_QMAX):
    """#12's requantization of (SB, C) sums: per block the scale, the fast
    range test, the hoisted quotient or IEEE division and rint, the clip,
    the byte.  Returns (q2, s2, fast)."""
    amax = np.fmax.reduce(np.abs(acc), axis=1)
    scale = np.where(amax > 0, (amax * inv_qmax).astype(F32), F32(1.0))
    fast = (amax >= FAST_LO) & (amax <= FAST_HI)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        y = np.where(fast, F32(1.0) / scale, F32(0.0)).astype(F32)
        q_fast = model_quotient(acc, scale[:, None], y[:, None])
        q_slow = np.rint(acc / scale[:, None])
    q = np.where(fast[:, None], q_fast, q_slow)
    return model_rint_byte(q, qmax), scale.astype(F32), fast


def _bits(a):
    return np.ascontiguousarray(a, F32).view(U32)


def test_every_byte_and_nibble_converts_exactly():
    every = np.arange(-128, 128, dtype=np.int8).reshape(1, 256)
    assert np.array_equal(model_values(every, False),
                          every.astype(F32))
    lo = ((every << 4) >> 4).astype(F32)            # the JAX kernel's unpack
    hi = (every >> 4).astype(F32)
    want = np.stack([lo, hi], -1).reshape(1, -1)
    assert np.array_equal(model_values(every, True), want)
    port = tq.unpack_int4(torch.from_numpy(every)).numpy().astype(F32)
    assert np.array_equal(model_values(every, True), port)


def test_biased_rint_is_half_to_even_and_the_low_byte_is_the_int8():
    k = np.arange(-140, 140, dtype=np.float64)
    ties = (k + 0.5).astype(F32)
    near = np.concatenate([np.nextafter(ties, F32(np.inf)),
                           np.nextafter(ties, F32(-np.inf))])
    rng = np.random.RandomState(0)
    q = np.concatenate([ties, near, k.astype(F32),
                        rng.uniform(-200, 200, 100000).astype(F32),
                        np.array([0.0, -0.0, 1e-30, -1e-30, 127.00002,
                                  -127.00002, np.inf, -np.inf, np.nan],
                                 F32)])
    want = np.fmin(np.fmax(np.rint(q), F32(-127)), F32(127))
    want = np.where(np.isnan(want), F32(-127), want).astype(np.int8)
    assert np.array_equal(model_rint_byte(q), want)
    # rounding before or after the clip gives the same integer (qmax is one)
    assert np.array_equal(
        model_rint_byte(np.rint(q)),
        model_rint_byte(q))


def _hoisted_mismatches(x, amax):
    scale = F32(amax * INV_QMAX)
    y = F32(1.0) / scale
    got = model_quotient(x, scale, y)
    return np.count_nonzero(_bits(got) != _bits(x / scale)), scale


@pytest.mark.parametrize("amax", [F32(1.0), F32(127.0), F32(1.5680445),
                                  np.nextafter(F32(2.0), F32(0.0)),
                                  F32(3.7e-12), F32(2.0 ** 63)])
def test_the_hoisted_quotient_is_ieee_division_on_every_significand(amax):
    """Every float32 x of the binade just under amax, whose quotients are
    the largest (every significand, both signs by symmetry of every
    step): x * y, fma(-scale, q0, x), fma(r, y, q0) is x / scale to the
    bit.  Scaling x by a power of two scales every step exactly while
    nothing under- or overflows, so the binade stands for every one
    above the subnormal range."""
    top = 2.0 ** np.floor(np.log2(float(amax)))
    sig = (np.arange(1 << 23, dtype=U32) | U32(0x3F800000)).view(F32)
    x = (sig * F32(top)).astype(F32)
    x = x[x <= amax]
    bad, scale = _hoisted_mismatches(x, amax)
    assert bad == 0, f"{bad} quotients differ from IEEE division"
    bad_neg, _ = _hoisted_mismatches(-x, amax)
    assert bad_neg == 0


@pytest.mark.parametrize("amax", [F32(1.0), F32(0.0123), FAST_LO, FAST_HI])
def test_the_hoisted_quotient_in_every_binade_down_to_the_subnormals(amax):
    """A sample of significands in every binade of [-amax, amax]: the
    quotient is IEEE division's where x / scale is normal and |x| >=
    2^-103 (the exact remainder stays normal), and elsewhere rounds to the
    same int8 (|q| < 0.5 there)."""
    rng = np.random.RandomState(1)
    scale = F32(amax * INV_QMAX)
    y = F32(1.0) / scale
    sig = np.concatenate([np.array([0x3F800000, 0x3FFFFFFF, 0x3FC00000],
                                   U32),
                          (rng.randint(0, 1 << 23, 4096).astype(U32) |
                           U32(0x3F800000))]).view(F32)
    e_top = int(np.floor(np.log2(float(amax))))
    for e in range(e_top, -150, -1):
        x = (sig.astype(np.float64) * 2.0 ** e).astype(F32)
        x = np.concatenate([x[(x <= amax) & (x > 0)], [F32(2.0 ** -149)]])
        x = np.concatenate([x, -x])
        got = model_quotient(x, scale, y)
        ieee = x / scale
        exact = (np.abs(ieee) >= np.finfo(F32).tiny) & \
            (np.abs(x) >= F32(2.0 ** -103))
        assert np.array_equal(_bits(got[exact]), _bits(ieee[exact])), e
        assert np.array_equal(model_rint_byte(got), model_rint_byte(
            np.rint(ieee))), e


# ---------------------------------------------------------------------------
# the model against the Pallas kernels and the plain twins
# ---------------------------------------------------------------------------


def _peers(dtype, n, block=256, sb=13, seed=0):
    """n peers' quantized copies of one shard, peer-major, quantized by the
    JAX package (as tests/test_torch_quant_kernels.py makes them)."""
    rng = np.random.RandomState(seed + n)
    spec = jq.CompressionSpec(dtype, block)
    qs, ss = [], []
    for _ in range(n):
        x = rng.randn(sb * block).astype(F32) * rng.choice([1e-3, 0.1, 1.0])
        q, s = jq.quantize_blockwise(jnp.asarray(x), spec)
        qs.append(np.asarray(q))
        ss.append(np.asarray(s))
    return np.concatenate(qs), np.concatenate(ss)


def _twin_acc(q, s, dtype, block, n):
    return tqk.dequant_accumulate_plain(
        torch.from_numpy(q), torch.from_numpy(s),
        tq.CompressionSpec(dtype, block), n).numpy()


def _twin_requant(q, s, block, n):
    q2, s2 = tqk.dequant_accumulate_requant_plain(
        torch.from_numpy(q), torch.from_numpy(s),
        tq.CompressionSpec("int8", block), n)
    return q2.numpy(), s2.numpy()


def _pallas_acc(q, s, dtype, block, n):
    return np.asarray(jqk.dequant_accumulate(
        jnp.asarray(q), jnp.asarray(s), jq.CompressionSpec(dtype, block), n,
        interpret=True))


def _pallas_requant(q, s, block, n):
    q2, s2 = jqk.dequant_accumulate_requant(
        jnp.asarray(q), jnp.asarray(s), jq.CompressionSpec("int8", block), n,
        interpret=True)
    return np.asarray(q2), np.asarray(s2)


def _held_requant(q, s, n, block=256, fast=None, pallas=True):
    """#12: the model's payload and scales bit for bit against the twin
    and (``pallas``) the Pallas kernel; ``fast`` (True, False) asks that
    every block took that path.  Returns the model's (q2, s2, acc)."""
    acc = model_accumulate(q, s, n, False)
    mq, ms, mfast = model_requant(acc)
    if fast is not None:
        assert np.all(mfast == fast)
    tq2, ts2 = _twin_requant(q, s, block, n)
    assert np.array_equal(mq, tq2)
    assert np.array_equal(_bits(ms), _bits(ts2))
    if pallas:
        pq2, ps2 = _pallas_requant(q, s, block, n)
        assert np.array_equal(mq, pq2)
        assert np.array_equal(_bits(ms), _bits(ps2))
    # the hoisted and the IEEE path give the same bytes wherever both apply
    ieee_q = model_rint_byte(np.rint(acc / ms[:, None]))
    assert np.array_equal(ieee_q[mfast], mq[mfast])
    return mq, ms, acc


@pytest.mark.parametrize("n", [2, 3, 8])
def test_the_model_is_the_pallas_kernels_on_jax_quantized_payloads(n):
    """int8: #11's sums and #12's payload and scales bit for bit against
    the Pallas kernels and the twins.  int4: the model is the twin to the
    bit; the Pallas kernel rounds each product before the add (its [lo |
    hi] concatenation keeps XLA from fusing a multiply-add), which the
    model reproduces bit for bit with the product rounded first, and the
    FMA keeps within TOL_ACC of it."""
    q, s = _peers("int8", n)
    acc = model_accumulate(q, s, n, False).reshape(-1)
    assert np.array_equal(_bits(acc), _bits(_pallas_acc(q, s, "int8", 256,
                                                         n)))
    assert np.array_equal(_bits(acc), _bits(_twin_acc(q, s, "int8", 256, n)))
    _held_requant(q, s, n)

    q4, s4 = _peers("int4", n, seed=5)
    acc4 = model_accumulate(q4, s4, n, True)
    assert np.array_equal(_bits(acc4.reshape(-1)),
                          _bits(_twin_acc(q4, s4, "int4", 256, n)))
    pallas = _pallas_acc(q4, s4, "int4", 256, n)
    v = model_values(q4, True).reshape(n, -1, 256)
    sc = s4.reshape(n, -1, 1)
    rounded = np.zeros(v.shape[1:], F32)
    for p in range(n):
        rounded = (rounded + (v[p] * sc[p]).astype(F32)).astype(F32)
    assert np.array_equal(_bits(rounded.reshape(-1)), _bits(pallas))
    diff = np.abs(acc4.reshape(-1) - pallas)
    assert diff.max() <= TOL_ACC
    ref = np.abs(pallas.reshape(-1, 256)).max(1)
    assert (diff.reshape(-1, 256).max(1) / np.maximum(ref, 1e-30)).max() \
        <= TOL_ACC_BLOCK


def _exact_peers(rows0, rows1, s0, s1):
    """Two peers whose products and sums are exact: (q (2 * SB, C), s)."""
    q = np.concatenate([np.asarray(rows0, np.int8), np.asarray(rows1,
                                                               np.int8)])
    sb = len(rows0)
    s = np.concatenate([np.broadcast_to(np.asarray(s0, F32), (sb,)),
                        np.broadcast_to(np.asarray(s1, F32), (sb,))])
    return q, s


def test_every_byte_of_every_peer_round_trips():
    """Blocks holding every int8 byte once (shuffled), on peers of several
    scales: the model, the Pallas kernels and the twins agree bit for
    bit; a lone peer over a zero one requantizes to its own bytes."""
    rng = np.random.RandomState(2)
    every = np.arange(-128, 128)
    rows0 = np.stack([rng.permutation(every) for _ in range(8)])
    rows1 = np.stack([rng.permutation(every) for _ in range(8)])
    q, s = _exact_peers(rows0, rows1, F32(0.02), F32(3e-3))
    s[1:8] = rng.uniform(1e-3, 1, 7).astype(F32)
    acc = model_accumulate(q, s, 2, False).reshape(-1)
    assert np.array_equal(_bits(acc), _bits(_pallas_acc(q, s, "int8", 256,
                                                         2)))
    _held_requant(q, s, 2, fast=True)
    # peer 1 all zeros: the sum is peer 0's block, its amax 128 * s0, and
    # -128 requantizes to -127
    q, s = _exact_peers(rows0, np.zeros_like(rows0), F32(1.0), F32(1.0))
    mq, ms, _ = _held_requant(q, s, 2, fast=True)
    assert np.all(mq[rows0 == -128] == -127) and np.all(mq[rows0 == 0] == 0)
    # every nibble, int4: each peer's two rows hold every byte once
    q4 = np.concatenate([rng.permutation(np.arange(-128, 128)).astype(
        np.int8).reshape(2, 128) for _ in range(2)])
    s4 = np.array([0.5, 0.25, 0.125, 1.0], F32)
    acc4 = model_accumulate(q4, s4, 2, True).reshape(-1)
    assert np.array_equal(_bits(acc4), _bits(_pallas_acc(q4, s4, "int4",
                                                         256, 2)))
    assert np.array_equal(_bits(acc4), _bits(_twin_acc(q4, s4, "int4", 256,
                                                       2)))


def _tie_scales():
    """Block scales S0 = 127 S0 * (1/127) in float32 with at most 12
    significant bits, so (k + 1/2) S0 is exact: amax = 127 S0 gives the
    scale S0 back and every (k + 1/2) S0 is a tie."""
    out = []
    for e in (-80, -30, -7, 0, 5, 40, 70):
        for sig in (1.0, 1.5, 1.25, 1.875, 1.0009765625, 1.9990234375):
            s0 = F32(sig * 2.0 ** e)
            if F32(F32(127) * s0 * INV_QMAX) == s0:
                out.append(s0)
    return out


def test_exact_half_quotients_round_to_even():
    """Peer 0 at scale S0 / 2 with odd bytes, peer 1 at S0 with the rest:
    every sum is (k + 1/2) S0 exactly, one element per block 127 S0 (and
    one -127 S0: |acc| = amax), so the scale is S0 and every quotient an
    exact tie, rounded half to even."""
    s0 = np.repeat(np.array(_tie_scales(), F32), 6)
    assert len(s0) >= 6 * 14
    rng = np.random.RandomState(3)
    k = rng.randint(-63, 63, (len(s0), 256))          # half of (2k+1) S0 ...
    rows0 = 2 * k + 1                                 # odd, |.| <= 125
    rows1 = rng.randint(-63, 64, (len(s0), 256))       # ... plus whole S0s
    rows0[:, 0], rows1[:, 0] = 0, 127                 # acc = 127 S0
    rows0[:, 1], rows1[:, 1] = 0, -127                # acc = -127 S0
    q, s = _exact_peers(rows0, rows1, (s0 / F32(2)).astype(F32), s0)
    mq, ms, acc = _held_requant(q, s, 2)
    assert np.array_equal(ms, s0)
    _, _, fast = model_requant(acc)
    assert fast.any() and not fast.all()              # both paths tie
    quot = acc[:, 2:] / ms[:, None]
    assert np.all(quot == np.floor(quot) + 0.5)       # every one a tie
    assert np.array_equal(mq[:, 2:], np.rint(quot).astype(np.int8))
    assert np.all(mq[:, 0] == 127) and np.all(mq[:, 1] == -127)


def _amax_peers(amax, rng):
    """Blocks whose amax is exactly ``amax[b]``: peer 0 at scale amax / 64
    with a 64 and a -64 and bytes of smaller magnitude, peer 1 zeros."""
    rows0 = rng.randint(-63, 64, (len(amax), 256))
    rows0[:, 0], rows0[:, 1] = 64, -64
    q, s = _exact_peers(rows0, np.zeros_like(rows0), F32(1.0), F32(1.0))
    s[:len(amax)] = (np.asarray(amax, F32) / F32(64)).astype(F32)
    return q, s


def test_quotients_just_past_qmax_and_the_clip():
    """Blocks whose amax * (1/127) rounds down, so |acc| = amax divides to
    just over 127 (still 127 after rint, and -127), and blocks at
    subnormal scales, whose few significant bits put amax / scale past
    127.5: the clip decides, in the IEEE-division path."""
    rng = np.random.RandomState(4)
    a = rng.uniform(1, 2, 200000).astype(F32)
    past = a[(a / (a * INV_QMAX).astype(F32)) > 127]
    assert past.size > 100
    q, s = _amax_peers(past[:16], rng)
    mq, ms, acc = _held_requant(q, s, 2, fast=True)
    amax = np.abs(acc).max(1)
    assert np.array_equal(amax, past[:16])
    assert np.all(model_quotient(amax, ms, F32(1) / ms) > 127)
    assert np.all(mq[:, 0] == 127) and np.all(mq[:, 1] == -127)
    # subnormal scales: amax / scale lands past 127.5 for some blocks
    # (peer 0 at 2^-149 .. 2^-140 with a top byte a0 in [64, 127]: the
    # scale round(a0 2^j / 127) 2^-149 can be far under amax / 127)
    top = rng.randint(64, 128, 48)
    rows0 = np.stack([rng.randint(-a, a + 1, 256) for a in top])
    rows0[:, 0], rows0[:, 1] = top, -top
    q, s = _exact_peers(rows0, np.zeros_like(rows0), F32(1.0), F32(1.0))
    s[:48] = np.ldexp(F32(1.0), np.arange(48) % 10 - 149).astype(F32)
    mq, ms, acc = _held_requant(q, s, 2, fast=False, pallas=False)
    amax = np.abs(acc).max(1)
    clipped = amax / ms >= 127.5
    assert clipped.any()
    assert np.all(mq[clipped, 0] == 127) and np.all(mq[clipped, 1] == -127)


def test_zero_tiny_huge_and_edge_amax():
    """amax = 0 (scale 1, payload 0; also peers that cancel), amax below
    and at the fast range's lower edge 2^-64, at and above its upper edge
    2^64, and near FLT_MAX: the IEEE-division path and the hoisted one
    give the twin's and the Pallas kernel's bits."""
    rng = np.random.RandomState(5)
    rows = rng.randint(-127, 128, (4, 256))
    zero = np.zeros_like(rows)
    q, s = _exact_peers(zero, zero, F32(0.5), F32(2.0))
    mq, ms, _ = _held_requant(q, s, 2)
    assert np.all(ms == 1.0) and not mq.any()
    q, s = _exact_peers(rows, -rows, F32(0.25), F32(0.25))   # cancel
    mq, ms, _ = _held_requant(q, s, 2)
    assert np.all(ms == 1.0) and not mq.any()
    below, above = np.nextafter(FAST_LO, F32(0)), np.nextafter(FAST_HI,
                                                                F32(np.inf))
    for amax, fast in (
            ([1e-30, 3e-25, 1e-35, 2e-20], False),            # tiny, normal
            ([FAST_LO, FAST_LO * 1.5, 2.0 ** -60, 1.0], True),  # lower edge
            ([below, 2.0 ** -65, 1e-21, 3e-20], False),
            ([FAST_HI, np.nextafter(FAST_HI, F32(0)), 1e19, 1.0], True),
            ([above, 2.0 ** 65, 1e30, 1e38], False),
            ([3.4e38, 3.0e38, 2.0 ** 127, 1.7e38], False)):   # near FLT_MAX
        q, s = _amax_peers(np.asarray(amax, F32), rng)
        mq, ms, acc = _held_requant(q, s, 2, fast=fast)
        assert np.array_equal(np.abs(acc).max(1), np.asarray(amax, F32))
    assert np.isfinite(acc).all() and acc.max() > 3e38
    # subnormal amax: the IEEE-division path, held to the twin
    q, s = _amax_peers(np.array([1e-39, 3e-41, 6e-44, 1e-42], F32), rng)
    mq, ms, acc = _held_requant(q, s, 2, fast=False, pallas=False)
    assert np.all(np.abs(acc).max(1) < np.finfo(F32).tiny) and \
        np.all(ms > 0)
