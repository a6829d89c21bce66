"""The launch plan of the port's LayerNorm backward kernel
(``paddle_tpu_torch/ops/cuda/csrc/layer_norm.cu``: ``ln_bwd_rows_kernel``
then ``ln_bwd_colsum_kernel``), and the width gate it serves.

The kernel runs only on a GPU (chip_smoke.py holds it against its plain
twin there); what these tests reach on the CPU is the pure function that
picks its grid, ``fused_ops.ln_bwd_plan``.  That grid decides how the
float32 partial sums of dscale/dbias are grouped, so it must cover every
row exactly once, stay within its block cap, fit every width the gate
accepts, and depend on (rows, D) alone: never on the device, so the sums
are the same bits on every card.  The column sum is launched as the row
pass's programmatic dependent, so its span overlaps the row pass's; the
last test holds chip_smoke.py's device-busy measure to the union of
spans."""

import pytest
import torch

from paddle_tpu_torch.ops.cuda import fused_ops as tF

# 1920 and 12288: the bf16 pretraining program's rows (B96 x 20, x 128)
ROWS = (1, 7, 640, 1000, 1003, 1920, 4096, 12288, 100000)
WIDTHS = (128, 768, 8192)


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_plan_covers_every_row_once_within_the_block_cap(rows, d):
    plan = tF.ln_bwd_plan(rows, d)
    assert 1 <= plan.blocks <= tF.LN_BWD_MAX_BLOCKS
    assert plan.blocks == -(-rows // plan.rows_per_block)
    assert plan.rows_per_block % plan.groups == 0
    seen = torch.zeros(rows, dtype=torch.int64)
    for block in range(plan.blocks):
        taken = 0
        for group in range(plan.groups):
            rng = plan.group_rows(block, group)
            seen[rng.start:rng.stop:rng.step] += 1
            taken += len(rng)
        assert taken >= 1, f"block {block} takes no row"
    assert bool((seen == 1).all())


@pytest.mark.parametrize("d", WIDTHS)
@pytest.mark.parametrize("rows", ROWS)
def test_plan_depends_on_rows_and_width_alone(rows, d, monkeypatch):
    plan = tF.ln_bwd_plan(rows, d)

    def no_device(*args, **kwargs):
        raise AssertionError("the plan asked about the device")
    for name in ("device_count", "get_device_properties", "is_available",
                 "current_device"):
        monkeypatch.setattr(torch.cuda, name, no_device)
    assert tF.ln_bwd_plan(rows, d) == plan
    assert tF.ln_bwd_plan(rows, d).group_rows(0, 0) == plan.group_rows(0, 0)


@pytest.mark.parametrize("d", range(128, tF.LN_MAX_DIM + 1, 128))
def test_every_width_the_gate_accepts_has_a_kernel_plan(d):
    """The lanes of a row group hold the whole row, no lane holds more
    than the kernel's largest instantiation, a row takes the fewest warps
    (a power of two up to 16) that allows that, and the block is one the
    kernel launches (8 warps, or the one row group of 16)."""
    assert tF.ln_supported(d, torch.float32)[0]
    plan = tF.ln_bwd_plan(4096, d)
    chunks = d // 128
    assert plan.chunks in tF.LN_CHUNKS
    assert plan.group_warps in (1, 2, 4, 8, 16)
    assert plan.chunks * plan.group_warps >= chunks
    assert plan.group_warps == 1 or \
        -(-chunks // (plan.group_warps // 2)) > tF.LN_CHUNKS[-1]
    assert plan.block_warps == max(tF.LN_BWD_BLOCK_WARPS, plan.group_warps)
    assert plan.block_warps * 32 <= 512


def test_bert_base_rows_take_one_warp_each():
    """D = 768: six 128-column chunks a lane, one warp a row, 8 rows to a
    block of 256 threads; the encoder's 4096 rows make 256 blocks of 16,
    the masked-LM head's 640 make 80 of 8."""
    assert tF.ln_bwd_plan(4096, 768) == tF.LnPlan(4096, 768, 6, 1, 8, 16,
                                                  256)
    assert tF.ln_bwd_plan(640, 768) == tF.LnPlan(640, 768, 6, 1, 8, 8, 80)


def test_ln_gate_accepts_and_refuses_exactly_as_before():
    """The gate the backward redesign must not narrow: D % 128 == 0,
    0 < D <= 8192, float32 or bfloat16."""
    dtypes = (torch.float32, torch.bfloat16, torch.float16, torch.float64,
              torch.int32)
    for d in range(-256, tF.LN_MAX_DIM + 1025):
        for dt in dtypes:
            want = d > 0 and d % 128 == 0 and d <= 8192 and \
                dt in (torch.float32, torch.bfloat16)
            ok, why = tF.ln_supported(d, dt)
            assert ok == want, (d, dt)
            assert bool(why) != want, (d, dt, why)
    assert tF.LN_MAX_DIM == 8192


@pytest.mark.parametrize("rows, d", [(0, 768), (4, 200), (4, 0)])
def test_plan_refuses_what_no_kernel_takes(rows, d):
    with pytest.raises(ValueError):
        tF.ln_bwd_plan(rows, d)


@pytest.mark.parametrize("spans, covered", [
    ([], 0.0),
    ([(0.0, 5.0)], 5.0),
    ([(0.0, 5.0), (5.0, 7.0)], 7.0),
    ([(0.0, 5.0), (3.0, 8.0), (10.0, 12.0)], 10.0),
    ([(10.0, 12.0), (0.0, 5.0), (1.0, 2.0)], 7.0),
])
def test_device_busy_counts_overlapping_kernels_once(spans, covered):
    """The column sum is a programmatic dependent launch: its span starts
    before the row pass ends, so chip_smoke.py's device-busy time is the
    union of the kernels' spans, not their sum."""
    import chip_smoke
    assert chip_smoke.covered_us(spans) == covered
