"""The launch plan and the arithmetic of the port's LayerNorm forward
kernel (``paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu``:
``ln_fwd_kernel``, both LN(x) and LN(a + b)).

The kernel runs only on a GPU (chip_smoke.py holds it against its plain
twin there).  What these tests reach on the CPU:

* the pure functions that pick its launch, ``fused_ops.ln_row_layout``
  (shared with the backward) and ``fused_ops.ln_fwd_plan``: every row is
  taken by exactly one row group, the lanes of a group hold the whole
  row, and the grid depends on (rows, D) alone, never on the device;
* a float32 model of the kernel's summation order (each lane's partial
  sum over its 4-column slices in order, the xor shuffle tree, the
  group's warp sums in warp order; the mean, then the sum of squared
  deviations with ``fmaf``, then ``fmaf(xhat, scale, bias)``), held
  against the TPU kernels run in Pallas interpret mode at TOL_F32, on
  float32 and bfloat16 inputs, on rows whose mean is several times their
  spread (where a one-pass E[u^2] - mean^2 loses digits) and on constant
  rows (variance 0, where the output is the bias exactly).

Inputs come from numpy with a fixed seed."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.ops.pallas import fused_ops as F

from paddle_tpu_torch.ops.cuda import fused_ops as tF

TOL_F32 = 2e-5             # chip_smoke.py's kernel-vs-twin tolerance (abs)
BF16_ULP_REL = 2.0 ** -7   # one bfloat16 ulp is at most this of |value|
EPS = 1e-5
# with the masked-LM head's rows at B32 and B96 x 20, and the encoder's
# at B96 x 128 (the bf16 pretraining program's float32 LayerNorms)
ROWS = (1, 7, 128, 640, 1000, 1003, 1920, 4096, 12288, 100000)
WIDTHS = tuple(range(128, tF.LN_MAX_DIM + 1, 128))
SMS, WARPS_PER_SM = 132, 32   # H100: 64 registers a thread leave 32 warps


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_plan_takes_every_row_once_and_covers_the_row(rows, d):
    """Block b's row group g takes row b * groups + g (ln_fwd_kernel), so
    the plan's blocks must cover each row exactly once, every block must
    take a row, and a group's lanes must hold all D columns."""
    plan = tF.ln_fwd_plan(rows, d)
    assert (plan.chunks, plan.group_warps) == tF.ln_row_layout(d)
    assert plan.chunks in tF.LN_CHUNKS
    assert plan.chunks * plan.group_warps * 128 >= d
    assert plan.block_warps % plan.group_warps == 0
    assert plan.block_warps <= 16
    assert plan.rows_per_block == plan.groups
    assert plan.blocks == -(-rows // plan.groups)
    taken = (np.arange(plan.blocks)[:, None] * plan.groups +
             np.arange(plan.groups)[None, :])
    assert bool((taken[:, 0] < rows).all()), "a block takes no row"
    counts = np.bincount(taken[taken < rows], minlength=rows)
    assert counts.shape == (rows,) and bool((counts == 1).all())
    for block in (0, plan.blocks - 1):
        for group in range(plan.groups):
            rng = plan.group_rows(block, group)
            assert list(rng) == [r for r in taken[block, group:group + 1]
                                 if r < rows]


@pytest.mark.parametrize("d", (128, 768, 896, 4096, 8192))
@pytest.mark.parametrize("rows", ROWS)
def test_plan_depends_on_rows_and_width_alone(rows, d, monkeypatch):
    plan = tF.ln_fwd_plan(rows, d)

    def no_device(*args, **kwargs):
        raise AssertionError("the plan asked about the device")
    for name in ("device_count", "get_device_properties", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    assert tF.ln_fwd_plan(rows, d) == plan
    assert tF.ln_row_layout(d) == (plan.chunks, plan.group_warps)


@pytest.mark.parametrize("d", WIDTHS)
def test_both_directions_share_the_row_layout(d):
    """One rule picks (chunks, group_warps) for the forward and the
    backward: the fewest warps (a power of two) that leave a lane at most
    six 128-column chunks, and the smallest instantiated chunk count."""
    chunks, group = tF.ln_row_layout(d)
    n = d // 128
    assert group in (1, 2, 4, 8, 16)
    assert group == 1 or -(-n // (group // 2)) > tF.LN_CHUNKS[-1]
    assert chunks == min(c for c in tF.LN_CHUNKS if c >= -(-n // group))
    fwd, bwd = tF.ln_fwd_plan(4096, d), tF.ln_bwd_plan(4096, d)
    assert (fwd.chunks, fwd.group_warps) == (bwd.chunks, bwd.group_warps)
    assert fwd.block_warps == max(tF.LN_FWD_BLOCK_WARPS, group)
    small = tF.ln_fwd_plan(tF.LN_FWD_SMALL_ROWS, d)
    assert small.block_warps == max(tF.LN_FWD_BLOCK_WARPS // 2, group)


@pytest.mark.parametrize("rows, block_warps", [(128, 4), (512, 4),
                                               (1024, 4), (4096, 8)])
def test_bert_base_rows_run_as_one_wave(rows, block_warps):
    """D = 768: six chunks a lane, one warp a row; four rows to a block of
    128 threads up to 1024 rows, eight to a block of 256 above; the
    served (R <= 4096) and training rows fit in one wave of an H100 at 32
    warps an SM."""
    plan = tF.ln_fwd_plan(rows, 768)
    assert plan == tF.LnPlan(rows, 768, 6, 1, block_warps, block_warps,
                             rows // block_warps)
    assert plan.blocks * plan.block_warps <= SMS * WARPS_PER_SM


def test_ln_gate_is_unchanged():
    """The gate the forward redesign must not narrow: D % 128 == 0,
    0 < D <= 8192, float32 or bfloat16; every width it takes has a
    forward plan."""
    for d in range(-256, tF.LN_MAX_DIM + 1025, 64):
        for dt in (torch.float32, torch.bfloat16, torch.float16,
                   torch.float64):
            want = d > 0 and d % 128 == 0 and d <= 8192 and \
                dt in (torch.float32, torch.bfloat16)
            assert tF.ln_supported(d, dt)[0] == want, (d, dt)
    for d in WIDTHS:
        tF.ln_fwd_plan(1, d)


@pytest.mark.parametrize("rows, d", [(0, 768), (4, 200), (4, 0), (4, -128)])
def test_plan_refuses_what_no_kernel_takes(rows, d):
    with pytest.raises(ValueError):
        tF.ln_fwd_plan(rows, d)


# ---------------------------------------------------------------------------
# a float32 model of the kernel's arithmetic
# ---------------------------------------------------------------------------


def _fmaf(x, y, z):
    """fmaf on float32 arrays, in float64: the product of two float32
    values is exact there, and the sum is rounded to float64 before
    float32 (apart from one rounding only on a float32 tie)."""
    return (x.astype(np.float64) * y.astype(np.float64) +
            z.astype(np.float64)).astype(np.float32)


def _row_sums(v, vec4, op):
    """Per-row sum of op(v[:, col]) in ln_fwd_kernel's order: each lane
    adds its slices (chunk c * group_warps + wg, columns in order), the
    xor shuffle tree (every lane ends with the same bits), then the
    group's warp sums in warp order.  ``op(acc, x)`` is one step of a
    lane's sum."""
    rows, d = v.shape
    chunks, group = tF.ln_row_layout(d)
    lanes = np.arange(32)
    part = np.zeros((rows, group, 32), np.float32)
    for wg in range(group):
        for c in range(chunks):
            k = c * group + wg
            if k >= d // 128:
                continue
            for j in range(4):
                col = k * 128 + (lanes * 4 + j if vec4 else j * 32 + lanes)
                part[:, wg] = op(part[:, wg], v[:, col])
    for off in (16, 8, 4, 2, 1):
        part = part + part[..., lanes ^ off]
    assert bool((part == part[..., :1]).all())
    total = np.zeros(rows, np.float32)
    for wg in range(group):
        total = total + part[:, wg, 0]
    return total


def ln_fwd_model(a, b, scale, bias, eps=EPS, vec4=True):
    """y = LN(a (+ b)) * scale + bias in float32, as ln_fwd_kernel takes
    it (rsqrtf's last bits aside); inputs are float32 arrays holding
    values of the kernel's dtype, the result is float32 before the one
    rounding to that dtype."""
    u = a if b is None else a + b
    d = np.float32(u.shape[1])
    mean = _row_sums(u, vec4, lambda acc, x: acc + x) / d
    dev = u - mean[:, None]
    var = _row_sums(dev, vec4, lambda acc, x: _fmaf(x, x, acc)) / d
    rstd = (1.0 / np.sqrt((var + np.float32(eps)).astype(np.float64))
            ).astype(np.float32)
    return _fmaf(dev * rstd[:, None], scale[None, :], bias[None, :])


def _bf16(x):
    """float32 values rounded to bfloat16 (nearest even), as float32."""
    return torch.from_numpy(np.ascontiguousarray(x)).bfloat16().float() \
        .numpy()


def _inputs(rng, kind, rows, d):
    if kind == "spread":
        a = (rng.randn(rows, d) * 3 + 1).astype(np.float32)
        b = rng.randn(rows, d).astype(np.float32)
    elif kind == "offset":        # mean several times the spread
        a = (4 + rng.randn(rows, d)).astype(np.float32)
        b = (0.5 * rng.randn(rows, d)).astype(np.float32)
    else:
        # constant rows: u = 0.5 (a = 0.75 and b = -0.25 for LN(a + b)).
        # A power of two, so the mean is exact in the reference too, which
        # multiplies the sum by a rounded 1/D (a row of 0.75 at D = 896
        # comes out 6e-8 off there, and its output 2.8e-5 from the bias)
        a = np.full((rows, d), 0.75, np.float32)
        b = np.full((rows, d), -0.25, np.float32)
    scale = (rng.rand(d) + 0.5).astype(np.float32)
    bias = rng.randn(d).astype(np.float32)
    return a, b, scale, bias


def _pallas(residual, a, b, scale, bias, dtype):
    args = [jnp.asarray(t).astype(dtype) for t in (a, b, scale, bias)]
    if residual:
        y = F.add_layer_norm(*args, EPS, True)
    else:
        y = F.layer_norm(args[0], args[2], args[3], EPS, True)
    return np.asarray(y.astype(jnp.float32))


RAGGED_ROWS = 133    # 4-row blocks and the Pallas kernel's 128-row blocks


@pytest.mark.parametrize("dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("kind", ("spread", "offset", "constant"))
@pytest.mark.parametrize("d", (128, 768, 896, 4096, 8192))
@pytest.mark.parametrize("residual", (False, True),
                         ids=("layer_norm", "add_layer_norm"))
def test_kernel_model_matches_pallas_interpret(residual, d, kind, dtype):
    rng = np.random.RandomState(d + 7 * residual)
    a, b, scale, bias = _inputs(rng, kind, RAGGED_ROWS, d)
    if dtype == "bfloat16":
        a, b, scale, bias = (_bf16(t) for t in (a, b, scale, bias))
    if kind == "constant" and not residual:
        a = a + b
    addend = b if residual else None
    # the float32 arithmetic, on the values the kernel reads
    ref = _pallas(residual, a, b, scale, bias, jnp.float32)
    for vec4 in (True, False):
        got = ln_fwd_model(a, addend, scale, bias, vec4=vec4)
        err = float(np.abs(got - ref).max())
        assert err <= TOL_F32, (vec4, err)
        if kind == "constant":     # variance 0: y is the bias, exactly
            assert np.array_equal(got, np.broadcast_to(bias, got.shape))
            assert np.array_equal(ref, got)
    if dtype == "bfloat16":
        # one rounding each to bfloat16 of values within TOL_F32: within
        # TOL_F32 and one bfloat16 ulp of the TPU kernel run on the
        # bfloat16 tensors themselves
        ref16 = _pallas(residual, a, b, scale, bias, jnp.bfloat16)
        got16 = _bf16(got)
        limit = TOL_F32 + BF16_ULP_REL * np.maximum(np.abs(got16),
                                                    np.abs(ref16))
        assert bool((np.abs(got16 - ref16) <= limit).all())
    # the wrapper's plain twin (what a CPU tensor runs) agrees as well
    tt = [torch.from_numpy(t) for t in (a, b, scale, bias)]
    if dtype == "bfloat16":
        tt = [t.bfloat16() for t in tt]
    twin = tF.add_layer_norm(*tt, EPS) if residual else \
        tF.layer_norm(tt[0], tt[2], tt[3], EPS)
    want = _bf16(got) if dtype == "bfloat16" else got
    limit = BF16_ULP_REL * np.abs(want) if dtype == "bfloat16" else 0.0
    assert bool((np.abs(twin.float().numpy() - want) <= limit + TOL_F32)
                .all())
