"""The paged-KV cache ops of the PyTorch port against the JAX package, on
the CPU: ``cache_write`` (bitwise, -1 lanes dropped), ``gather_cache`` and
``ctx_len_bias`` (bitwise), the cache-read ``fused_attention`` with and
without ``QPos`` at Sq = 1 and Sq > 1 (within 1e-5 of the JAX op, through
the ``cached_flash_attention`` route at head dim 64 and through the plain
composition at head dim 32, which the kernel's gate rejects), the route's
gate and refusals, ``arg_max`` and the chained-decode sampling step
(greedy rows bit for bit, the same surviving set after top-k / top-p as
the JAX function, draws that depend on (seed, position) alone)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from paddle_tpu.ops import cache_ops as jcache
from paddle_tpu.ops import registry as jregistry
from paddle_tpu.ops import sampling_ops as jsampling

from paddle_tpu_torch.framework.errors import UnimplementedError
from paddle_tpu_torch.ops import cache_ops as tcache
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops import sampling_ops as tsampling
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.registry import LoweringContext, get_op

TOL = 1e-5


@pytest.fixture(autouse=True)
def _fresh_counts():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    assert port_cuda.launch_counts()["flash_attention_fwd"] == 0


def _ctx(donate=False):
    return LoweringContext(torch.Generator().manual_seed(0),
                           is_test=True, donate_state=donate)


def _jctx():
    return jregistry.LoweringContext(jax.random.PRNGKey(0), is_test=True)


def _pools(rng, nb=6, bs=4, h=16):
    return (rng.randn(nb, bs, h).astype(np.float32),
            rng.randn(nb, bs, h).astype(np.float32))


SLOT_CASES = {
    # a packed prefill row with padding, the drops scattered
    "mixed": np.array([[3, -1, 7, 8], [-1, 12, -1, 21]], np.int32),
    # every lane dropped: the pools stay bitwise unchanged
    "all-dropped": np.full((2, 4), -1, np.int32),
    # a dropped lane beside a valid write to slot 0 (the race a redirect
    # to slot 0 would lose)
    "slot-0-beside-drop": np.array([[-1, 0, -1, 5]], np.int32).reshape(
        2, 2),
    # the first valid lane is not lane 0
    "first-valid-late": np.array([[-1, -1, -1, 23]], np.int32).reshape(
        2, 2),
}


@pytest.mark.parametrize("case", sorted(SLOT_CASES))
@pytest.mark.parametrize("donate", [True, False])
def test_cache_write_is_bitwise_the_jax_op(case, donate):
    rng = np.random.RandomState(1)
    slots = SLOT_CASES[case]
    kp, vp = _pools(rng)
    k = rng.randn(*slots.shape, 16).astype(np.float32)
    v = rng.randn(*slots.shape, 16).astype(np.float32)
    want = jcache._cache_write(None, {
        "KPool": [jnp.asarray(kp)], "VPool": [jnp.asarray(vp)],
        "K": [jnp.asarray(k)], "V": [jnp.asarray(v)],
        "Slots": [jnp.asarray(slots)]}, {})
    tk, tv = torch.from_numpy(kp.copy()), torch.from_numpy(vp.copy())
    got = get_op("cache_write")(_ctx(donate), {
        "KPool": [tk], "VPool": [tv], "K": [torch.from_numpy(k)],
        "V": [torch.from_numpy(v)], "Slots": [torch.from_numpy(slots)]}, {})
    for slot in ("KPoolOut", "VPoolOut"):
        assert np.array_equal(got[slot].numpy(), np.asarray(want[slot]))
    # donated: the pools are written in place (the same tensors come
    # back); otherwise the inputs are untouched
    assert (got["KPoolOut"] is tk) == donate
    if not donate:
        assert np.array_equal(tk.numpy(), kp)
    if case == "all-dropped":
        assert np.array_equal(got["KPoolOut"].numpy(), kp)


def test_drop_lanes_points_dropped_lanes_at_the_first_valid_slot():
    idx = torch.tensor([-1, 9, -1, 4])
    flat = torch.arange(40.0).view(10, 4)
    rows = torch.randn(4, 4)
    targets, fill = tcache.drop_lanes(idx)
    assert targets.tolist() == [9, 9, 9, 4]
    vals = fill(flat, rows)
    assert torch.equal(vals[0], rows[1]) and torch.equal(vals[2], rows[1])
    targets, fill = tcache.drop_lanes(torch.tensor([-1, -1]))
    assert targets.tolist() == [0, 0]
    assert torch.equal(fill(flat, rows[:2]), flat[:1].expand(2, 4))


def test_cache_write_checks_widths_and_slot_counts():
    kp = torch.zeros(4, 2, 8)
    ins = {"KPool": [kp], "VPool": [kp.clone()],
           "K": [torch.zeros(1, 3, 6)], "V": [torch.zeros(1, 3, 6)],
           "Slots": [torch.zeros(1, 3, dtype=torch.int32)]}
    with pytest.raises(ValueError, match="hidden width 6"):
        get_op("cache_write")(_ctx(), ins, {})
    ins["K"] = ins["V"] = [torch.zeros(1, 3, 8)]
    ins["Slots"] = [torch.zeros(1, 2, dtype=torch.int32)]
    with pytest.raises(ValueError, match="Slots covers"):
        get_op("cache_write")(_ctx(), ins, {})


def test_gather_cache_and_ctx_len_bias_are_bitwise_the_jax_ones():
    rng = np.random.RandomState(2)
    kp, _ = _pools(rng, nb=10)
    table = np.array([[7, 2, 0], [4, 9, 9]], np.int32)
    ctx_len = np.array([6, 0], np.int32)      # row 1: a padded batch row
    want = jcache.gather_cache(jnp.asarray(kp), jnp.asarray(table))
    got = tcache.gather_cache(torch.from_numpy(kp), torch.from_numpy(table))
    assert np.array_equal(got.numpy(), np.asarray(want))
    want = jcache.ctx_len_bias(jnp.asarray(ctx_len), 12)
    got = tcache.ctx_len_bias(torch.from_numpy(ctx_len), 12)
    assert got.shape == (2, 1, 1, 12)
    assert np.array_equal(got.numpy(), np.asarray(want))


def _cached_ins(rng, b, sq, heads, d, q_pos=False, nb=12, bs=4, mbps=4):
    hidden = heads * d
    kp, vp = _pools(rng, nb, bs, hidden)
    table = np.stack([rng.permutation(nb)[:mbps] for _ in range(b)]
                     ).astype(np.int32)
    ctx_len = rng.randint(sq, mbps * bs + 1, (b,)).astype(np.int32)
    ctx_len[-1] = 0 if sq == 1 else ctx_len[-1]    # an all-masked row
    ins = {"Q": rng.randn(b, sq, hidden).astype(np.float32),
           "KPool": kp, "VPool": vp, "BlockTable": table, "CtxLen": ctx_len}
    if q_pos:
        ins["QPos"] = np.stack([np.arange(n - sq, n) for n in ctx_len]
                               ).astype(np.int64)
    return ins


@pytest.mark.parametrize("heads,d", [(2, 64), (2, 32)])
@pytest.mark.parametrize("sq,q_pos", [(1, False), (5, True), (5, False)])
def test_cached_fused_attention_matches_the_jax_op(heads, d, sq, q_pos):
    """Head dim 64 takes the cached_flash_attention route (the flash
    forward's twin on the CPU), head dim 32 the composition the gate
    falls back to; Sq = 1 is a decode step and is taken by the route."""
    rng = np.random.RandomState(3 + sq + d)
    ins = _cached_ins(rng, 3, sq, heads, d, q_pos)
    attrs = {"n_head": heads, "dropout_rate": 0.0, "is_test": True,
             "_cached": True}
    want = jregistry.get_op("fused_attention")(
        _jctx(), {k: [jnp.asarray(v)] for k, v in ins.items()}, attrs)
    got = get_op("fused_attention")(
        _ctx(), {k: [torch.from_numpy(v)] for k, v in ins.items()}, attrs)
    out = got["Out"].numpy()
    assert out.shape == (3, sq, heads * d) and np.isfinite(out).all()
    np.testing.assert_allclose(out, np.asarray(want["Out"]), rtol=TOL,
                               atol=TOL)
    outcome = "hit" if d == 64 else "fallback"
    reason = "supported" if d == 64 else f"head-dim:{d}"
    assert registry.route_counts() == {
        ("fused_attention", "cached_flash_attention", outcome, reason): 1}


def test_cached_bias_is_exactly_zero_on_valid_pairs_with_q_pos():
    """The [B, 1, Sq, T] bias a chunk hands the kernel: 0.0 where the key
    is inside the context and at or before the query, -1e9 (or -2e9)
    elsewhere; the flash wrapper flattens it to a head-shared
    (B, Sq, T)."""
    rng = np.random.RandomState(4)
    ins = _cached_ins(rng, 2, 3, 2, 64, q_pos=True)
    seen = {}
    real = tfa.flash_attention_bshd

    def spy(q, k, v, bias=None, **kw):
        seen["bias"] = bias
        return real(q, k, v, bias, **kw)

    tfa.flash_attention_bshd = spy
    try:
        get_op("fused_attention")(
            _ctx(), {k: [torch.from_numpy(v)] for k, v in ins.items()},
            {"n_head": 2, "_cached": True})
    finally:
        tfa.flash_attention_bshd = real
    bias = seen["bias"].numpy()
    assert bias.shape == (2, 1, 3, 16)
    t = np.arange(16)
    for b in range(2):
        for i, p in enumerate(ins["QPos"][b]):
            valid = (t < ins["CtxLen"][b]) & (t <= p)
            assert (bias[b, 0, i][valid] == 0.0).all()
            assert (bias[b, 0, i][~valid] <= -1e9).all()


def test_cached_route_gate_takes_sq_1_and_refuses_on_the_card():
    def meta_ins(sq, d, heads=2):
        hidden = heads * d
        return {"Q": [torch.empty(2, sq, hidden, device="meta")],
                "KPool": [torch.empty(8, 16, hidden, device="meta")],
                "VPool": [torch.empty(8, 16, hidden, device="meta")],
                "BlockTable": [torch.empty(2, 32, dtype=torch.int32,
                                           device="meta")],
                "CtxLen": [torch.empty(2, dtype=torch.int32,
                                       device="meta")]}
    attrs = {"n_head": 2, "_cached": True}
    for sq in (1, 7, 512):
        route, why = registry.cuda_route("fused_attention", meta_ins(sq, 64),
                                         attrs,
                                         kernel="cached_flash_attention")
        assert route is not None and route.kernel == "cached_flash_attention"
    # a head dim the kernel rejects raises off the CPU, with the reason
    with pytest.raises(UnimplementedError, match="head-dim:32"):
        registry.cuda_route("fused_attention", meta_ins(1, 32), attrs,
                            kernel="cached_flash_attention")
    # the plain flash route skips cached instances, the cached route plain
    # ones: neither counts a fallback for the other
    assert registry.cuda_route("fused_attention", meta_ins(1, 64), attrs,
                               kernel="flash_attention")[1] == \
        "no-matching-route"
    from paddle_tpu_torch.ops.op_specs import ROUTE_CACHED_FLASH
    assert ROUTE_CACHED_FLASH.supported(
        {"Q": [torch.empty(1, 1, 128)]}, attrs) == (False, "not-cached")


def test_q_pos_must_match_the_query_shape():
    rng = np.random.RandomState(5)
    ins = _cached_ins(rng, 2, 3, 2, 32, q_pos=True)
    ins["QPos"] = ins["QPos"][:, :2]
    with pytest.raises(ValueError, match="QPos"):
        get_op("fused_attention")(
            _ctx(), {k: [torch.from_numpy(v)] for k, v in ins.items()},
            {"n_head": 2, "_cached": True})


def test_the_sequence_parallel_branch_is_refused_by_name():
    """The sequence-parallel branch is ported: a ``_seq_axis`` the run
    lacks takes the plain branch (the JAX op's rule), and on a run over
    that axis the ring route refuses by name, off the CPU, what its kernel
    step does not take (an explicit AttnBias)."""
    from paddle_tpu_torch.framework.errors import UnimplementedError
    from paddle_tpu_torch.ops.collective_ops import DataParallelGroup
    rng = np.random.RandomState(3)
    q = torch.from_numpy(rng.randn(1, 4, 128).astype(np.float32))
    ins = {"Q": [q], "K": [q], "V": [q]}
    got = get_op("fused_attention")(_ctx(), ins, {"n_head": 2,
                                                  "_seq_axis": "sp"})["Out"]
    want = get_op("fused_attention")(_ctx(), ins, {"n_head": 2})["Out"]
    assert torch.equal(got, want)
    ctx = _ctx()
    ctx.dp = DataParallelGroup(0, 2, "gloo", axis_name="sp")
    m = torch.zeros(1, 4, 128, device="meta")
    with pytest.raises(UnimplementedError, match="ring-explicit-bias"):
        get_op("fused_attention")(
            ctx, {"Q": [m], "K": [m], "V": [m], "AttnBias": [m]},
            {"n_head": 2, "head_dim": 64, "_seq_axis": "sp"})


def test_arg_max_takes_the_first_of_ties_as_jnp_argmax():
    a = np.array([[1.0, 3.0, 3.0, 0.0], [2.0, 2.0, 2.0, 2.0],
                  [-1.0, -5.0, -1.0, -0.5]], np.float32)
    for attrs in ({"axis": -1}, {"axis": 0}, {"axis": 1, "keepdims": True}):
        want = jregistry.get_op("arg_max")(_jctx(),
                                           {"X": [jnp.asarray(a)]}, attrs)
        got = get_op("arg_max")(_ctx(), {"X": [torch.from_numpy(a)]},
                                attrs)
        assert got["Out"].dtype == torch.int64
        assert np.array_equal(got["Out"].numpy(), np.asarray(want["Out"]))


def test_the_decode_chain_marker_raises_outside_a_chain():
    with pytest.raises(RuntimeError, match="lower_decode_chain"):
        get_op("decode_chain")(_ctx(), {}, {})


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def _policy(b):
    rng = np.random.RandomState(6)
    return dict(
        logits=rng.randn(b, 32).astype(np.float32) * 2.0,
        temperature=np.array([0.0, 0.7, 1.0, 1.3, 0.9, 0.0][:b], np.float32),
        top_k=np.array([0, 8, 0, 3, 5, 1][:b], np.int32),
        top_p=np.array([0.0, 0.0, 0.8, 0.9, 0.5, 0.3][:b], np.float32),
        seeds=np.array([11, 12, 13, 14, 15, 16][:b], np.int32),
        positions=np.array([5, 5, 9, 9, 40, 2][:b], np.int32))


def _port_sample(p, greedy):
    return tsampling.sample_chain_tokens(
        torch.from_numpy(p["logits"]), greedy,
        *(torch.from_numpy(p[k]) for k in ("temperature", "top_k", "top_p",
                                           "seeds", "positions")))


def test_greedy_rows_return_the_body_tokens_bit_for_bit():
    p = _policy(6)
    greedy = torch.tensor([7, 1, 2, 3, 4, 31])
    out = _port_sample(p, greedy)
    assert out.dtype == greedy.dtype
    assert out[0] == 7 and out[5] == 31          # temperature 0
    # top_k = 1 is the argmax under any seed
    p["top_k"][:] = 1
    p["temperature"][:] = 0.8
    out = _port_sample(p, greedy)
    assert torch.equal(out, torch.from_numpy(p["logits"]).argmax(-1))


def test_surviving_set_after_top_k_top_p_equals_the_jax_functions(
        monkeypatch):
    """The JAX function's survivors, read through its draw: with noise
    that puts +1e30 on token j alone, the draw is j exactly when j
    survives its filters.  The port's :func:`sample_filter` keeps the
    same set on every row."""
    p = _policy(6)
    p["temperature"][p["temperature"] <= 0] = 1.0
    b, v = p["logits"].shape
    jargs = [jnp.asarray(p[k]) for k in ("temperature", "top_k", "top_p",
                                         "seeds", "positions")]
    greedy = jnp.zeros((b,), jnp.int32)
    want = np.zeros((b, v), bool)
    for j in range(v):
        onehot = jnp.zeros((v,)).at[j].set(1e30)
        monkeypatch.setattr(jsampling.jax.random, "gumbel",
                            lambda key, shape: onehot)
        tok = np.asarray(jsampling.sample_chain_tokens(
            jnp.asarray(p["logits"]), greedy, *jargs))
        want[:, j] = tok == j
    monkeypatch.undo()
    got = tsampling.sample_filter(
        torch.from_numpy(p["logits"]), torch.from_numpy(p["temperature"]),
        torch.from_numpy(p["top_k"]), torch.from_numpy(p["top_p"]))
    assert np.array_equal(np.isfinite(got.numpy()), want)
    assert want.sum(1).min() >= 1 and (want.sum(1) < v).any()


def test_a_draw_depends_on_seed_and_position_alone():
    p = _policy(5)
    p["temperature"][:] = 1.0
    p["top_k"][:] = 0
    p["top_p"][:] = 0.0
    greedy = torch.zeros(5, dtype=torch.int64)
    out = _port_sample(p, greedy)
    perm = np.array([3, 0, 4, 1, 2])
    shuffled = {k: v[perm] for k, v in p.items()}
    assert torch.equal(_port_sample(shuffled, greedy), out[perm])
    # another seed draws other noise
    noise = tsampling.chain_row_noise(torch.tensor([1, 2]),
                                      torch.tensor([3, 3]), 64)
    assert not torch.equal(noise[0], noise[1])
    assert torch.isfinite(noise).all()


def test_the_noise_is_word_0_of_the_kernels_philox():
    """Key (0, 0), counter 0: word 0 is Random123's known answer
    0x6627e8d5, which the noise turns into -log(-log(u))."""
    noise = tsampling.chain_row_noise(torch.tensor([0]), torch.tensor([0]),
                                      1)
    u = ((0x6627E8D5 >> 8) + 0.5) / (1 << 24)
    assert abs(float(noise[0, 0]) - (-np.log(-np.log(u)))) < 1e-6
