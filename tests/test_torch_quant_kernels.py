"""The receive-stage kernels of the quantized all-reduce (#11
``dequant_accumulate``, #12 ``dequant_accumulate_requant``;
``paddle_tpu_torch/ops/cuda/quant_kernels.py``): their plain twins
against the Pallas kernels of ``paddle_tpu/ops/pallas/quant_kernels.py``
in interpret mode, on the same peer payloads made with numpy from a seed
and quantized by the JAX package — n in {2, 3, 8} peers, int8 and int4,
SB = 13 shard blocks (not a multiple of the TPU's 8-row tile).  #11
within 1e-5; #12's payload bit-identical and its scales within 2e-6 (the
``parity`` entries of KERNEL_CENSUS_r15.json).  Also: the gate's reasons
(no TPU lane or VMEM rule: int4 at block 128 is taken), the refusal on a
non-CPU tensor (``device="meta"``), and the route's hits and
fallbacks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops.pallas import quant_kernels as jqk
from paddle_tpu.ops import quantize_wire as jq

from paddle_tpu_torch import flags
from paddle_tpu_torch.framework.errors import UnimplementedError
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops import quantize_wire as tq
from paddle_tpu_torch.ops.cuda import quant_kernels as tqk
from paddle_tpu_torch.ops.op_specs import kernel_facts

SB = 13
TOL_ACC = 1e-5
TOL_SCALE = 2e-6


@pytest.fixture(autouse=True)
def _fresh_counts():
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield


def _peers(dtype, n, block=256, seed=0):
    """n peers' quantized copies of one shard of SB blocks, peer-major,
    as all_to_all delivers them (quantized by the JAX package)."""
    rng = np.random.RandomState(seed + n)
    spec = jq.CompressionSpec(dtype, block)
    qs, ss = [], []
    for _ in range(n):
        x = rng.randn(SB * block).astype(np.float32) * rng.choice(
            [1e-3, 0.1, 1.0])
        q, s = jq.quantize_blockwise(jnp.asarray(x), spec)
        qs.append(np.asarray(q))
        ss.append(np.asarray(s))
    return np.concatenate(qs), np.concatenate(ss), spec


@pytest.mark.parametrize("n", [2, 3, 8])
@pytest.mark.parametrize("dtype", ["int8", "int4"])
def test_dequant_accumulate_twin_matches_the_pallas_kernel(dtype, n):
    q, s, jspec = _peers(dtype, n)
    want = np.asarray(jqk.dequant_accumulate(jnp.asarray(q), jnp.asarray(s),
                                             jspec, n, interpret=True))
    spec = tq.CompressionSpec(dtype, 256)
    got = tqk.dequant_accumulate_plain(torch.from_numpy(q),
                                       torch.from_numpy(s), spec, n)
    assert got.shape == (SB * 256,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_ACC)
    # the wrapper on CPU tensors is the twin, and launches nothing
    again = tqk.dequant_accumulate(torch.from_numpy(q), torch.from_numpy(s),
                                   spec, n)
    assert torch.equal(again, got)
    assert sum(port_cuda.launch_counts().values()) == 0


@pytest.mark.parametrize("n", [2, 3, 8])
def test_dequant_accumulate_requant_twin_matches_the_pallas_kernel(n):
    q, s, jspec = _peers("int8", n, seed=10)
    jq2, js2 = jqk.dequant_accumulate_requant(jnp.asarray(q), jnp.asarray(s),
                                              jspec, n, interpret=True)
    spec = tq.CompressionSpec("int8", 256)
    q2, s2 = tqk.dequant_accumulate_requant_plain(
        torch.from_numpy(q), torch.from_numpy(s), spec, n)
    assert q2.shape == (SB, 256) and q2.dtype == torch.int8
    assert np.array_equal(q2.numpy(), np.asarray(jq2))
    np.testing.assert_allclose(s2.numpy(), np.asarray(js2), rtol=0,
                               atol=TOL_SCALE)
    w2, ws2 = tqk.dequant_accumulate_requant(torch.from_numpy(q),
                                             torch.from_numpy(s), spec, n)
    assert torch.equal(w2, q2) and torch.equal(ws2, s2)
    assert sum(port_cuda.launch_counts().values()) == 0


def test_int4_at_block_128_matches_too():
    """The TPU gate refuses it (128 / 2 payload bytes are not a lane
    multiple); the port's kernel takes it."""
    q, s, jspec = _peers("int4", 2, block=128)
    ok, why = jqk.supported(2, SB, jspec, backend="tpu")
    assert not ok and why.startswith("block-size")
    assert tqk.supported(2, SB, tq.CompressionSpec("int4", 128)) == (True, "")
    want = (np.asarray(jq.dequantize_blockwise(jnp.asarray(q),
                                               jnp.asarray(s), jspec))
            .reshape(2, -1).sum(0))
    got = tqk.dequant_accumulate_plain(torch.from_numpy(q),
                                       torch.from_numpy(s),
                                       tq.CompressionSpec("int4", 128), 2)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=TOL_ACC)


@pytest.mark.parametrize("args,requant,reason", [
    ((2, SB, tq.CompressionSpec("bfloat16")), False, "wire-dtype:bfloat16"),
    ((1, SB, tq.CompressionSpec("int8")), False, "peers:unknown-or-single"),
    ((None, SB, tq.CompressionSpec("int8")), False,
     "peers:unknown-or-single"),
    ((2, 0, tq.CompressionSpec("int8")), False, "blocks:unknown"),
    ((2, SB, tq.CompressionSpec("int4")), True, "requant-dtype:int4"),
    ((2, SB, tq.CompressionSpec("int8", stochastic_rounding=True)), True,
     "requant-stochastic-rounding"),
    ((2, SB, tq.CompressionSpec("int8", 16384)), True,
     "block-size:16384>12288"),
    ((2, SB, tq.CompressionSpec("int4", 2)), False, ""),
    ((8, 1, tq.CompressionSpec("int8", 100)), True, ""),
    ((2, SB, tq.CompressionSpec("int8", stochastic_rounding=True)), False,
     ""),
])
def test_the_gate_states_what_the_kernels_reject(args, requant, reason):
    assert tqk.supported(*args, requant=requant) == (not reason, reason)


def test_a_rejected_input_off_the_cpu_raises():
    spec = tq.CompressionSpec("int8")
    q = torch.empty((SB, 256), dtype=torch.int8, device="meta")
    s = torch.empty(SB, device="meta")
    with pytest.raises(UnimplementedError, match="peers:unknown-or-single"):
        tqk.dequant_accumulate(q, s, spec, 1)
    q4 = torch.empty((2 * SB, 128), dtype=torch.int8, device="meta")
    s4 = torch.empty(2 * SB, device="meta")
    with pytest.raises(UnimplementedError, match="requant-dtype:int4"):
        tqk.dequant_accumulate_requant(q4, s4, tq.CompressionSpec("int4"), 2)
    # an input the gate takes still needs a CUDA tensor for the kernel
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tqk.dequant_accumulate(q4, s4, tq.CompressionSpec("int4"), 2)


def test_the_route_counts_hits_and_fallbacks_and_refuses_off_the_cpu():
    attrs = {"quant_spec": {"dtype": "int8", "block_size": 256}}
    ins = {"X": [torch.zeros(1000), torch.zeros(24)]}
    route, why = registry.cuda_route("c_fused_quant_allreduce_sum", ins,
                                     dict(attrs, _n_peers=2))
    assert route is not None and route.kernel == "dequant_accumulate"
    flags.set_flags({"use_pallas_fused": False})
    try:
        route, why = registry.cuda_route("c_quant_allreduce_sum", ins,
                                         dict(attrs, _n_peers=2))
    finally:
        flags.set_flags({"use_pallas_fused": True})
    assert route is None and why == "flag:use_pallas_fused=off"
    route, why = registry.cuda_route("c_quant_allreduce_sum", ins,
                                     dict(attrs, _n_peers=1))
    assert route is None and why == "peers:unknown-or-single"
    counts = registry.route_counts()
    assert counts[("c_fused_quant_allreduce_sum", "dequant_accumulate",
                   "hit", "supported")] == 1
    assert counts[("c_quant_allreduce_sum", "dequant_accumulate",
                   "fallback", "flag:use_pallas_fused=off")] == 1
    meta = {"X": [torch.zeros(1000, device="meta")]}
    with pytest.raises(UnimplementedError, match="peers"):
        registry.cuda_route("c_quant_allreduce_sum", meta,
                            dict(attrs, _n_peers=1))


def test_kernel_facts_name_the_tpu_kernels_replaced():
    facts = kernel_facts()
    src = "paddle_tpu_torch/ops/cuda/csrc/quant_accumulate.cu"
    assert facts["dequant_accumulate"] == (
        src, "paddle_tpu/ops/pallas/quant_kernels.py:91")
    assert facts["dequant_accumulate_requant"] == (
        src, "paddle_tpu/ops/pallas/quant_kernels.py:111")
    lines = open(jqk.__file__).read().splitlines()
    assert lines[90].startswith("def _dq_acc_kernel")
    assert lines[110].startswith("def _dq_acc_requant_kernel")
    assert set(port_cuda.LAUNCHES) >= {"dequant_accumulate",
                                       "dequant_accumulate_requant"}
