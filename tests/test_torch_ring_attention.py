"""Ring attention and its kernel entry through the port against the JAX
package.

``flash_attention_with_lse``'s plain twin (the CPU side of the flash
kernels #1-#3 with a differentiable lse) against the JAX package's
``flash_attention_with_lse(..., interpret=True)`` (the Pallas kernels in
interpret mode) at S 128 and 256, head dim 64: o, lse and dq/dk/dv under
a random ``do`` and a random ``dlse``, for the ring's three kinds of block
bias — a padding mask with one batch row all masked, the causal bias of a
diagonal block and that of a block wholly in the future (every row
masked).  Within ``TOL`` = 2e-5: absolute for o, relative to the value
for lse, of max(1, max|JAX gradient|) for the gradients (the all-masked
row's reach about 20 here, see below).  A row masked everywhere comes out as the uniform
mean of V in both.

``ring_attention`` on 2 and 4 gloo ranks of an ``sp`` axis
(``tests/torch_tp_runner.py``), the plain and the flash inner steps,
causal or not, with a kv_mask holding a fully padded batch row (the
causal cases keep key 0 of every row: a causal row whose every visible
key is padded has no defined result in either package), against the JAX
package's ``ring_attention`` (plain inner step) on the virtual mesh and
against full attention: the output within ``TOL``, the q/k/v gradients
within ``TOL_GRAD`` = 1e-4.  The flash inner step's gradients of the
fully padded batch row are left out: its lse, -1e30 + log(S_loc), rounds
to -1e30 in float32, so both packages' kernels take p = 1 where the
softmax has 1/S_loc."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from paddle_tpu.framework.jax_compat import shard_map
from paddle_tpu.ops.pallas.flash_attention import (
    flash_attention_with_lse as jflash_lse)
from paddle_tpu.parallel.ring_attention import (
    ring_attention as jring_attention)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_tp_runner.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_tp_runner import RING_CASES  # noqa: E402

NEG = -1e30
TOL = 2e-5
TOL_GRAD = 1e-4
LAUNCH_TIMEOUT_S = 300
B, H, S, D = 2, 2, 64, 64


def _bias(kind, b, s, rng):
    """The ring's block bias of ``kind``, (B, 1, 1|S, S) float32."""
    if kind == "padding":
        mask = (rng.rand(b, s) < 0.7).astype(np.float32)
        mask[0] = 0.0                      # a batch row all masked
        return ((1.0 - mask) * NEG)[:, None, None, :].astype(np.float32)
    if kind == "causal_diagonal":
        tri = np.where(np.arange(s)[:, None] >= np.arange(s)[None, :],
                       0.0, NEG)
        return np.broadcast_to(tri, (b, 1, s, s)).astype(np.float32)
    return np.full((b, 1, s, s), NEG, np.float32)     # causal_future


@pytest.mark.parametrize("kind", ["padding", "causal_diagonal",
                                  "causal_future"])
@pytest.mark.parametrize("seq", [128, 256])
def test_the_lse_twin_matches_the_pallas_kernels(seq, kind):
    from paddle_tpu_torch.ops.cuda.flash_attention import (
        flash_attention_with_lse)
    rng = np.random.RandomState(seq + len(kind))
    q, k, v, do = (rng.randn(2, 2, seq, 64).astype(np.float32)
                   for _ in range(4))
    dlse = rng.randn(2, 2, seq).astype(np.float32)
    bias = _bias(kind, 2, seq, rng)

    def f(a, b_, c):
        return jflash_lse(a, b_, c, jnp.asarray(bias), interpret=True)
    (jo, jlse), vjp = jax.vjp(f, q, k, v)
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    ts = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    o, lse = flash_attention_with_lse(*ts, torch.from_numpy(bias))
    grads = torch.autograd.grad([o, lse], ts, [torch.from_numpy(do),
                                               torch.from_numpy(dlse)])
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(jo),
                               rtol=0, atol=TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jlse),
                               rtol=TOL, atol=TOL)
    for name, g, jg in zip("qkv", grads, jgrads):
        jg = np.asarray(jg)
        np.testing.assert_allclose(g.numpy(), jg, rtol=0,
                                   atol=TOL * max(1.0, np.abs(jg).max()),
                                   err_msg=f"d{name}")
    # a row masked everywhere (batch row 0 of the padding bias, every row
    # of the future block): the uniform mean of V, in both, finite lse
    if kind != "causal_diagonal":
        rows = 0 if kind == "padding" else slice(None)
        want = v.mean(axis=2, keepdims=True)[rows]
        for got in (o.detach().numpy(), np.asarray(jo)):
            np.testing.assert_allclose(
                got[rows], np.broadcast_to(want, got[rows].shape), rtol=0,
                atol=TOL)
        assert np.isfinite(lse.detach().numpy()).all()


def test_on_a_cuda_tensor_the_ring_route_raises_on_what_the_kernel_rejects():
    """No fallback: an explicit AttnBias (per-source-block semantics) on
    the ring route is refused by name off the CPU; on the CPU it takes
    the plain inner step and counts the fallback."""
    from paddle_tpu_torch.framework.errors import UnimplementedError
    from paddle_tpu_torch.ops import registry
    q = torch.zeros(2, 64, 128, device="meta")
    ins = {"Q": [q], "K": [q], "V": [q], "AttnBias": [q]}
    attrs = {"n_head": 2, "head_dim": 64, "_seq_axis": "sp"}
    with pytest.raises(UnimplementedError, match="ring-explicit-bias"):
        registry.cuda_route("fused_attention", ins, attrs,
                            kernel="ring_flash_attention")
    cpu = {k: [torch.zeros(2, 64, 128)] for k in ins}
    route, why = registry.cuda_route("fused_attention", cpu, attrs,
                                     kernel="ring_flash_attention",
                                     count=False)
    assert route is None and why == "ring-explicit-bias"
    cpu.pop("AttnBias")
    route, _ = registry.cuda_route("fused_attention", cpu, attrs,
                                   kernel="ring_flash_attention",
                                   count=False)
    assert route is not None and route.kernels == (
        "flash_attention_fwd", "flash_attention_bwd_dq",
        "flash_attention_bwd_dkv")


def test_a_direct_ring_call_off_the_cpu_raises_on_what_the_kernel_rejects():
    """No fallback for direct callers either: ``ring_attention`` with
    ``use_flash=None`` on tensors off the CPU raises by the route's
    reasons (an explicit bias, the kernels' own) where the flash step
    cannot take them, and takes the plain step only where the flag or
    ``use_flash=False`` asks for it; CPU tensors take the plain step."""
    from paddle_tpu_torch import flags as port_flags
    from paddle_tpu_torch.framework.errors import UnimplementedError
    from paddle_tpu_torch.parallel import ring_attention
    assert port_flags.flag("use_flash_attention")
    meta = torch.zeros(1, 2, 16, 64, device="meta")
    bias = torch.zeros(1, 1, 16, 16, device="meta")
    with pytest.raises(UnimplementedError, match="ring-explicit-bias"):
        ring_attention(meta, meta, meta, "sp", bias=bias)
    with pytest.raises(UnimplementedError, match="ring-explicit-bias"):
        ring_attention(meta, meta, meta, "sp", bias=bias, use_flash=True)
    odd = torch.zeros(1, 2, 16, 48, device="meta")
    with pytest.raises(UnimplementedError, match="head-dim:48"):
        ring_attention(odd, odd, odd, "sp")
    with pytest.raises(UnimplementedError, match="dtype:torch.float64"):
        wide = meta.to(torch.float64)
        ring_attention(wide, wide, wide, "sp")
    assert ring_attention(meta, meta, meta, "sp", bias=bias,
                          use_flash=False).shape == meta.shape
    port_flags.set_flags({"use_flash_attention": False})
    try:
        assert ring_attention(odd, odd, odd, "sp", bias=bias).shape == \
            odd.shape
    finally:
        port_flags.set_flags({"use_flash_attention": True})
    rng = np.random.RandomState(5)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 16, 48).astype(np.float32))
               for _ in range(3))
    cpu_bias = torch.from_numpy(rng.randn(1, 1, 16, 16).astype(np.float32))
    want = torch.softmax(q @ k.transpose(-1, -2) / np.sqrt(48) + cpu_bias,
                         dim=-1) @ v
    got = ring_attention(q, k, v, "sp", bias=cpu_bias)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=TOL)


# ---------------------------------------------------------------------------
# the ring over 2 and 4 ranks
# ---------------------------------------------------------------------------


def _inputs():
    rng = np.random.RandomState(11)
    out = {t: rng.randn(B, H, S, D).astype(np.float32)
           for t in ("q", "k", "v", "dO")}
    mask = (rng.rand(B, S) < 0.6).astype(np.float32)
    mask[0] = 0.0                          # a fully padded batch row
    out["kv_mask"] = mask
    causal = (rng.rand(B, S) < 0.6).astype(np.float32)
    causal[:, 0] = 1.0
    out["kv_mask_causal"] = causal
    return out


def _with_vjp(f, inputs, mask):
    """(o, dq, dk, dv) of ``f(q, k, v, mask)`` under the cotangent dO, in
    one jitted call."""
    def run(q, k, v, m, do):
        o, vjp = jax.vjp(lambda a, b, c: f(a, b, c, m), q, k, v)
        return (o,) + vjp(do)
    outs = jax.jit(run)(*(inputs[t] for t in "qkv"), mask, inputs["dO"])
    return [np.asarray(t) for t in outs]


def _mask(inputs, causal, masked):
    return inputs["kv_mask_causal" if causal else "kv_mask"] if masked \
        else np.ones((B, S), np.float32)


def _full(inputs, causal, masked):
    """Full attention (the -1e30 masks) and its q/k/v gradients."""
    def f(q, k, v, mask):
        s = jnp.einsum("bhqd,bhkd->bhqk", q, k) / np.sqrt(D)
        s = jnp.where(mask[:, None, None, :] > 0, s, NEG)
        if causal:
            s = jnp.where(np.tril(np.ones((S, S), bool)), s, NEG)
        return jnp.einsum("bhqk,bhkd->bhqd", jax.nn.softmax(s, -1), v)
    return _with_vjp(f, inputs, _mask(inputs, causal, masked))


def _jax_ring(inputs, n, causal, masked):
    """The JAX package's ring (plain inner step) on n virtual devices."""
    mesh = Mesh(np.array(jax.devices()[:n]), ("sp",))

    def body(q, k, v, m):
        return jring_attention(q, k, v, "sp", causal=causal,
                               kv_mask=m if masked else None,
                               use_flash=False)
    seq = P(None, None, "sp", None)
    fn = shard_map(body, mesh=mesh, in_specs=(seq, seq, seq, P(None, "sp")),
                   out_specs=seq, check_vma=False)
    return _with_vjp(fn, inputs, _mask(inputs, causal, masked))


_REFS = {}


def _refs(inputs, n, causal, masked):
    """The JAX ring's and full attention's results, once a case."""
    key = (n, causal, masked)
    if key not in _REFS:
        _REFS[key] = (("jax ring", _jax_ring(inputs, n, causal, masked)),
                      ("full", _full(inputs, causal, masked)))
    return _REFS[key]


def launch(tmp, nproc, *args):
    out_dir = tmp / "out"
    out_dir.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, *args, str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S + 60,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(nproc)]


_RUNS = {}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    data = _inputs()
    tmp = tmp_path_factory.mktemp("ring")
    np.savez(tmp / "in.npz", **data)
    return data, tmp / "in.npz", tmp_path_factory


@pytest.fixture
def ring(inputs):
    data, path, factory = inputs

    def get(n):
        if n not in _RUNS:
            ranks = launch(factory.mktemp(f"sp{n}"), n, "ring", str(path))
            # each rank's shard back in sequence order
            _RUNS[n] = {k: np.concatenate([r[k] for r in ranks], axis=2)
                        for k in ranks[0] if k != "routes"}
        return _RUNS[n]
    return get


@pytest.mark.parametrize("case,use_flash,causal,masked", RING_CASES,
                         ids=[c[0] for c in RING_CASES])
@pytest.mark.parametrize("n", [2, 4])
def test_the_ring_matches_the_jax_ring_and_full_attention(
        inputs, ring, n, case, use_flash, causal, masked):
    data = inputs[0]
    got = ring(n)
    names = ("o", "dq", "dk", "dv")
    for ref_name, ref in _refs(data, n, causal, masked):
        for name, want in zip(names, ref):
            g = got[f"{case}/{name}"]
            if name != "o" and use_flash and masked and not causal:
                g, want = g[1:], want[1:]     # the fully padded row
            np.testing.assert_allclose(
                g, want, rtol=0, atol=TOL if name == "o" else TOL_GRAD,
                err_msg=f"{case} {name} vs {ref_name}")
    if masked and not causal:
        mean_v = data["v"][0].mean(axis=1, keepdims=True)
        np.testing.assert_allclose(got[f"{case}/o"][0],
                                   np.broadcast_to(mean_v, (H, S, D)),
                                   rtol=0, atol=TOL)
