"""The arithmetic of the port's flash-attention backward kernels
(``paddle_tpu_torch/ops/cuda/csrc/flash_attention_bwd.cu``), emulated in
torch on the CPU, and the pure-Python plan that routes them.

The kernels' float32 arithmetic: the score product q.k^T is one float32
FMA chain per score over the head dim, in order from 0; the four other
products (do.v^T, ds.k, ds^T.q, p^T.do) are 3xTF32 on the tensor cores
(a = hi + lo with hi = tf32(a), lo = tf32(a - hi), rounded by
``cvt.rna.tf32.f32``: nearest, ties away from zero, to 10 mantissa bits;
a.b ~ lo.hi' + hi.lo' + hi.hi').  bf16 and float16 feed their operands to
the tensor cores as they are; dk/dv (#3) rounds p and ds to the type once
for p^T.do and ds^T.q, and dq (#2) splits the float32 ds into two halves
of the type.  Emulated here on the plain twin's formulas at B2 H2 S128
D64 (padding bias, and causal; 16 bits also at S 512), each must stay
within the tolerance ``chip_smoke.py`` holds the kernels to: TOL_GRAD of
max(1, max|plain|) in float32, two ulps of the type of max|plain| in 16
bits (BF16_REL in bf16).  The designs not taken (q.k^T in 3xTF32 too,
which missed TOL_GRAD on the card at B32 H12 S128; single-pass TF32; p
and ds split in every 16-bit product, #3's design before Hopper's) are
computed beside them and reported in the test's output (``-rP``), not
asserted, the first also at B32 H12 S128."""

import math

import pytest
import torch

from chip_smoke import BF16_REL, TOL_GRAD, padding_bias
from paddle_tpu_torch.ops.cuda import flash_attention as FA

BSZ, HEADS, SEQ, D = 2, 2, 128, 64
#: the 16-bit tolerances: two ulps of the type of max|plain| (bf16's is
#: chip_smoke.py's BF16_REL)
REL16 = {torch.bfloat16: BF16_REL, torch.float16: 2.0 ** -9}


def tf32(x):
    """cvt.rna.tf32.f32: round to 10 mantissa bits, ties away from zero
    (on the magnitude bits; the 13 dropped bits become zero)."""
    b = x.float().contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1FFF).view(torch.float32)


def split_tf32(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def mm_3xtf32(a, b):
    (ah, al), (bh, bl) = split_tf32(a), split_tf32(b)
    return (al @ bh + ah @ bl) + ah @ bh


def mm_tf32(a, b):
    return tf32(a) @ tf32(b)


def mm_fma_chain(a, b):
    """a.b with each element one float32 FMA chain over the inner dim in
    order from 0, as the kernels' float32 score product: fmaf(x, y, acc)
    emulated in float64 (the product of two floats is exact there) and
    rounded to float32 at each step."""
    acc = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    a64, b64 = a.double(), b.double()
    for i in range(a.shape[-1]):
        acc = (a64[..., :, i:i + 1] * b64[..., i:i + 1, :] +
               acc.double()).float()
    return acc


def backward(q, k, v, bias, o, lse, do, causal, mm, mm_p=None, mm_s=None,
             mm_dq=None):
    """dq, dk, dv by the plain twin's formulas with the five products
    taken by ``mm`` (``mm_p`` where p or ds is the left operand, ``mm_dq``
    for ds.k alone when given, ``mm_s`` for the scores q.k^T), in float32,
    or float64 for float64 operands."""
    mm_p = mm_p or mm
    mm_s = mm_s or mm
    mm_dq = mm_dq or mm_p
    ct = torch.float64 if q.dtype == torch.float64 else torch.float32
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = mm_s(q.to(ct), k.to(ct).transpose(1, 2)) * scale
    if bias is not None:
        s = s + bias.repeat_interleave(q.shape[0] // bias.shape[0], 0)
    if causal:
        keep = torch.ones(s.shape[1], s.shape[2], dtype=torch.bool).tril()
        s = s.masked_fill(~keep, FA.NEG_INF)
    p = torch.exp(s - lse)
    dof = do.to(ct)
    dp = mm(dof, v.to(ct).transpose(1, 2))
    ds = p * (dp - (dof * o.to(ct)).sum(-1, keepdim=True))
    return (mm_dq(ds, k.to(ct)) * scale,
            mm_p(ds.transpose(1, 2), q.to(ct)) * scale,
            mm_p(p.transpose(1, 2), dof))


def problem(mode, dtype=torch.float32, bsz=BSZ, heads=HEADS, seq=SEQ):
    gen = torch.Generator().manual_seed(6)
    q, k, v, do = (torch.randn(bsz * heads, seq, D, generator=gen)
                   .to(dtype) for _ in range(4))
    causal = mode == "causal"
    bias = None if causal else padding_bias(torch, gen, torch.device("cpu"),
                                            bsz, seq)
    o, lse = FA.flash_fwd_plain(q, k, v, bias, causal)
    ref = FA.flash_bwd_plain(q, k, v, bias, o, lse, do, causal)
    return (q, k, v, bias, o, lse, do, causal), ref


def rel_errs(got, ref, dtype):
    out = []
    for g, r in zip(got, ref):
        err = float((g.to(dtype).float() - r.float()).abs().max())
        top = float(r.float().abs().max())
        out.append(err / (top if dtype in REL16 else max(1.0, top)))
    return out


def mm_split(dtype):
    """a.b with a (p or ds) split into two halves of ``dtype``, b exact in
    it: #2's ds.k"""
    def mm(a, b):
        hi = a.to(dtype).float()
        return (a - hi).to(dtype).float() @ b + hi @ b
    return mm


def mm_rounded(dtype):
    """a.b with a rounded to ``dtype`` once: #3's p^T.do and ds^T.q"""
    def mm(a, b):
        return a.to(dtype).float() @ b
    return mm


def test_tf32_rounds_to_nearest_with_ties_away_from_zero():
    one = 1.0
    half_ulp = 2.0 ** -11                      # a TF32 ulp at 1 is 2^-10
    x = torch.tensor([one + half_ulp, -(one + half_ulp),
                      one + half_ulp - 2.0 ** -23, one + 3 * half_ulp,
                      3.0, -0.0, 2.0 ** -130])
    want = torch.tensor([one + 2 * half_ulp, -(one + 2 * half_ulp), one,
                         one + 4 * half_ulp, 3.0, -0.0, 2.0 ** -130])
    got = tf32(x)
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert bool(((got.view(torch.int32) & 0x1FFF) == 0).all())


def test_split_carries_22_bits():
    x = torch.randn(10000, generator=torch.Generator().manual_seed(1)) * \
        torch.logspace(-8, 8, 10000)
    hi, lo = split_tf32(x)
    assert bool((((hi.view(torch.int32) | lo.view(torch.int32)) & 0x1FFF)
                 == 0).all())
    err = ((hi.double() + lo.double()) - x.double()).abs()
    assert bool((err <= 2.0 ** -21 * x.double().abs()).all())


@pytest.mark.parametrize("mode", ["padding-bias", "causal"])
def test_float32_kernel_arithmetic_holds_the_float32_tolerance(mode):
    """FMA-chain scores and 3xTF32 for the other four products, as the
    kernels compute them."""
    args, ref = problem(mode)
    errs = rel_errs(backward(*args, mm_3xtf32, mm_s=mm_fma_chain), ref,
                    torch.float32)
    all3x = rel_errs(backward(*args, mm_3xtf32), ref, torch.float32)
    single = rel_errs(backward(*args, mm_tf32), ref, torch.float32)
    print(f"{mode}: dq, dk, dv error over max(1, max|plain|): kernel "
          f"arithmetic {errs}; q.k^T in 3xTF32 too (reported) {all3x}; "
          f"single-pass TF32 (reported) {single}; TOL_GRAD {TOL_GRAD}")
    assert max(errs) <= TOL_GRAD, (errs, TOL_GRAD)


def test_3xtf32_scores_at_bert_base_shape_reported():
    """At B32 H12 S128 with BERT's padding bias, where q.k^T in 3xTF32
    missed TOL_GRAD on the card: every variant and the float32 twin
    against the same backward in float64.  Reported; asserted only that
    each stays finite and within the float32 twin's own distance from
    float64 plus TOL_GRAD."""
    args, ref = problem("padding-bias", bsz=32, heads=12)
    wide = [a.double() if torch.is_tensor(a) else a for a in args]
    exact = backward(*wide, torch.matmul)

    def vs64(got):
        return [float((g.double() - e).abs().max()) /
                max(1.0, float(e.abs().max())) for g, e in zip(got, exact)]
    kernel = backward(*args, mm_3xtf32, mm_s=mm_fma_chain)
    all3x = backward(*args, mm_3xtf32)
    twin = vs64(ref)
    report = {"float32 twin": twin, "kernel arithmetic": vs64(kernel),
              "q.k^T in 3xTF32": vs64(all3x)}
    print("B32 H12 S128 padding bias, dq, dk, dv error over max(1, "
          "max|float64|): " + "; ".join(f"{k} {v}"
                                        for k, v in report.items())
          + f"; against the twin: kernel arithmetic "
          f"{rel_errs(kernel, ref, torch.float32)}, q.k^T in 3xTF32 "
          f"{rel_errs(all3x, ref, torch.float32)}; TOL_GRAD {TOL_GRAD}")
    for errs in report.values():
        assert all(math.isfinite(e) for e in errs)
        assert max(errs) <= max(twin) + TOL_GRAD, (report, TOL_GRAD)


@pytest.mark.parametrize("mode", ["padding-bias", "causal"])
def test_bf16_with_split_p_and_ds_holds_the_bf16_tolerance(mode):
    """What the kernels ship in bf16: #2's ds.k with ds split into two
    bf16 halves, #3's p^T.do and ds^T.q with p and ds rounded to bf16
    once.  Reported beside it: p and ds split in every product (the
    design #3 had before)."""
    args, ref = problem(mode, torch.bfloat16)
    shipped = rel_errs(backward(*args, torch.matmul,
                                mm_rounded(torch.bfloat16),
                                mm_dq=mm_split(torch.bfloat16)), ref,
                       torch.bfloat16)
    split = rel_errs(backward(*args, torch.matmul, mm_split(torch.bfloat16)),
                     ref, torch.bfloat16)
    print(f"{mode}: dq, dk, dv error over max|plain|: shipped (ds split in "
          f"dq, p and ds rounded once in dk, dv) {shipped}; split everywhere "
          f"(reported) {split}; BF16_REL {BF16_REL}")
    assert max(shipped) <= BF16_REL, (shipped, BF16_REL)


@pytest.mark.parametrize("seq", [128, 512])
@pytest.mark.parametrize("mode", ["padding-bias", "causal"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16],
                         ids=["bfloat16", "float16"])
def test_16bit_kernel_arithmetic_holds_the_16bit_tolerance(dtype, mode, seq):
    """The shipped 16-bit arithmetic (ds split in dq, p and ds rounded
    once in dk and dv) within two ulps of the type of max|plain| (bf16:
    BF16_REL), also at S 512; p and ds split everywhere reported."""
    args, ref = problem(mode, dtype, seq=seq)
    shipped = rel_errs(backward(*args, torch.matmul, mm_rounded(dtype),
                                mm_dq=mm_split(dtype)), ref, dtype)
    split = rel_errs(backward(*args, torch.matmul, mm_split(dtype)), ref,
                     dtype)
    print(f"{dtype} {mode} S{seq}: dq, dk, dv error over max|plain|: "
          f"shipped {shipped}; split everywhere (reported) {split}; "
          f"tolerance {REL16[dtype]}")
    assert max(shipped) <= REL16[dtype], (shipped, REL16[dtype])


@pytest.mark.parametrize("d", FA.HEAD_DIMS)
@pytest.mark.parametrize("sq,sk", [(1, 1), (64, 64), (65, 65), (128, 128),
                                   (100, 77), (77, 200), (512, 512)])
def test_bwd_plan_pads_the_score_gradient_to_whole_tiles(sq, sk, d):
    plan = FA.bwd_plan(4, sq, sk, d)
    assert FA.supported(sq, sk, d)[0]
    if d == 256:
        assert plan == FA.BwdPlan("fma", 0, 0)
        return
    assert plan.route == "mma"
    for rows, n in ((plan.ds_rows, sk), (plan.ds_cols, sq)):
        assert rows % FA.BWD_TILE == 0 and n <= rows < n + FA.BWD_TILE


@pytest.mark.parametrize("bh,s,route", [
    (32 * 12, 128, "mma"),        # BERT-base training: 25.2 MB of ds
    (8 * 12, 512, "mma"),         # 101 MB
    (32 * 12, 512, "mma"),        # 403 MB
    (8 * 12, 4096, "fma"),        # 6.4 GB: past the cap
    (1 * 12, 16384, "fma"),       # 12.9 GB
])
def test_bwd_plan_caps_the_score_gradient_scratch(bh, s, route):
    """The "mma" route's ds scratch is O(S^2); past DS_SCRATCH_CAP bytes
    the plan takes the "fma" route, whose kernels need O(S) memory."""
    plan = FA.bwd_plan(bh, s, s, 64)
    assert plan.route == route
    if route == "mma":
        assert 4 * bh * plan.ds_rows * plan.ds_cols <= FA.DS_SCRATCH_CAP


def test_bwd_plan_cap_is_inclusive_and_read_at_the_call(monkeypatch):
    need = 4 * 12 * 128 * 192                  # BH 12, Sq 190, Sk 100
    assert FA.bwd_plan(12, 190, 100, 128, cap=need).route == "mma"
    assert FA.bwd_plan(12, 190, 100, 128, cap=need - 1).route == "fma"
    monkeypatch.setattr(FA, "DS_SCRATCH_CAP", need - 1)
    assert FA.bwd_plan(12, 190, 100, 128).route == "fma"
    monkeypatch.setattr(FA, "DS_SCRATCH_CAP", 0)
    assert FA.bwd_plan(1, 1, 1, 64).route == "fma"


def test_bwd_plan_follows_the_gate():
    """Every head dim the gate takes has a route; the gate itself is the
    first port's (64/128/256, causal square, dropout in [0, 1)) with
    float16 beside float32 and bf16."""
    assert {FA.bwd_plan(12, 128, 128, d).route for d in FA.HEAD_DIMS} == \
        {"mma", "fma"}
    assert not FA.supported(128, 128, 96)[0]
    assert FA.supported(128, 128, 64, torch.float16)[0]
    assert not FA.supported(128, 128, 64, torch.float64)[0]
    assert not FA.supported(128, 64, 64, causal=True)[0]
    assert not FA.supported(128, 128, 64, dropout_rate=1.0)[0]
    assert FA.supported(100, 77, 128, torch.bfloat16, dropout_rate=0.5)[0]


@pytest.mark.parametrize("mode", ["padding-bias", "causal"])
def test_plain_twin_in_float64_is_the_float32_twin_widened(mode):
    """chip_smoke.py's float64 witness: the plain twin given float64
    tensors computes the same backward (dropout included) in float64 and
    returns float64.  The float32 twin is within TOL_GRAD of it when
    causal; with BERT's -1e4 padding bias it is not: a float32 score near
    -1e4 is rounded to 2^-11, which moves its p by up to 2^-11 of itself,
    so the float32 twin is held there to 2^-10 (and the kernels, which
    reproduce its q.k^T rounding, share its distance from float64)."""
    (q, k, v, bias, o, lse, do, causal), ref = problem(mode)
    seed = torch.tensor([5], dtype=torch.int32)
    ref = FA.flash_bwd_plain(q, k, v, bias, o, lse, do, causal, 0.1, seed)
    wide = [None if t is None else t.double()
            for t in (q, k, v, bias, o, lse, do)]
    got = FA.flash_bwd_plain(*wide, causal, 0.1, seed)
    assert all(g.dtype == torch.float64 for g in got)
    errs = rel_errs(ref, got, torch.float32)
    print(f"{mode}: float32 twin vs float64, dq, dk, dv over max(1, "
          f"max|float64|): {errs}")
    limit = TOL_GRAD if causal else 2.0 ** -10
    assert max(errs) <= limit, errs
    o32, lse32 = FA.flash_fwd_plain(q, k, v, bias, causal, 0.1, seed)
    o64, lse64 = FA.flash_fwd_plain(*wide[:4], causal, 0.1, seed)
    assert o64.dtype == lse64.dtype == torch.float64
    assert float((o64 - o32.double()).abs().max()) <= limit
    assert torch.equal(lse64.isinf(), lse32.isinf())
