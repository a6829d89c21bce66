"""The ``multihead_matmul`` path of the PyTorch port against the JAX
package, on the CPU.

The attention pattern matmul(Q, K^T) → scale → add bias → softmax →
dropout (test mode) → matmul(·, V) is built with each package's own
builders on head-split [B, H, S, D] operands (head dim 64, S = 128, so
the flash gate holds), fused by each package's ``multihead_matmul_fuse``
pass and run on the same numpy inputs.  The fused descs agree byte for
byte, and the port's fused op — through the flash route (the kernel's
plain twin on the CPU) and with the route's flag off (the composition) —
matches the JAX package's fused op within 2e-5.  The pattern's scale is
not 1/sqrt(D), so the route's folding of alpha into q is exercised, and
the test-mode ``downgrade_in_infer`` dropout's (1 - p) is applied after
the kernel.
"""

import json

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.passes import apply_pass as japply_pass
from paddle_tpu.framework.serialization import (
    program_to_desc as jprogram_to_desc)

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.passes import apply_pass as tapply_pass
from paddle_tpu_torch.framework.serialization import (
    program_to_desc as tprogram_to_desc)
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry

B, H, S, D = 2, 2, 128, 64
ALPHA = 0.1
DROPOUT = 0.25
TOL = 2e-5


@pytest.fixture(autouse=True)
def _fresh_port_state():
    tcore.reset_default_programs()
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    tcore.reset_default_programs()


def _build(fluid, core, unique_name, bias, dropout):
    unique_name.reset()
    main, startup = core.Program(), core.Program()
    with core.program_guard(main, startup):
        q, k, v = (fluid.layers.data(n, shape=[H, S, D])
                   for n in ("q", "k", "v"))
        scores = fluid.layers.matmul(q, k, transpose_y=True)
        scores = fluid.layers.scale(scores, scale=ALPHA)
        if bias is not None:
            shape = [1, 1, S] if bias == "padding" else [H, S, S]
            scores = fluid.layers.elementwise_add(
                scores, fluid.layers.data("bias", shape=shape))
        probs = fluid.layers.softmax(scores)
        if dropout:
            probs = fluid.layers.dropout(probs, DROPOUT, is_test=True)
        out = fluid.layers.matmul(probs, v)
    return main, out


def _feed(bias):
    rng = np.random.RandomState(7)
    feed = {n: rng.randn(B, H, S, D).astype(np.float32)
            for n in ("q", "k", "v")}
    if bias == "padding":
        lens = np.array([S, S // 3])
        feed["bias"] = np.where(np.arange(S)[None, :] < lens[:, None], 0.0,
                                -1e4).astype(np.float32).reshape(B, 1, 1, S)
    elif bias == "per-head":
        feed["bias"] = rng.randn(B, H, S, S).astype(np.float32)
    return feed


@pytest.mark.parametrize("bias,dropout", [("padding", True),
                                          ("per-head", False),
                                          (None, True)])
def test_multihead_matmul_fuse_and_op_match_the_jax_package(bias, dropout):
    feed = _feed(bias)
    jmain, jout = _build(jfluid, jcore, jun, bias, dropout)
    tmain, tout = _build(tfluid, tcore, tun, bias, dropout)
    assert json.dumps(jprogram_to_desc(jmain)) == \
        json.dumps(tprogram_to_desc(tmain))
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    unfused, = texe.run(tmain, feed=feed, fetch_list=[tout])

    japply_pass(jmain, "multihead_matmul_fuse", fetch_names=[jout.name])
    tapply_pass(tmain, "multihead_matmul_fuse", fetch_names=[tout.name])
    assert [op.type for op in tmain.global_block().ops] == \
        ["multihead_matmul"]
    assert json.dumps(jprogram_to_desc(jmain)) == \
        json.dumps(tprogram_to_desc(tmain))
    ref, = jexe.run(jmain, feed=feed, fetch_list=[jout])

    got, = texe.run(tmain, feed=feed, fetch_list=[tout])
    assert registry.route_counts() == {
        ("multihead_matmul", "flash_attention", "hit", "supported"): 1}
    assert sum(port_cuda.launch_counts().values()) == 0      # CPU: plain
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, unfused, rtol=TOL, atol=TOL)

    tflags.set_flags({"use_flash_attention": False})
    try:
        plain, = texe.run(tmain, feed=feed, fetch_list=[tout])
    finally:
        tflags.set_flags({"use_flash_attention": True})
    assert registry.route_counts("fallback") == {
        ("multihead_matmul", "flash_attention", "fallback",
         "flag:use_flash_attention=off"): 1}
    np.testing.assert_allclose(plain, ref, rtol=TOL, atol=TOL)
