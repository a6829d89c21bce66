"""Package rules of the PyTorch port (``paddle_tpu_torch``):

* importing it pulls in neither JAX nor the JAX package;
* no module of the port, nor ``chip_smoke.py``, imports either;
* its entry points run on the GPU unless the caller asks for the CPU, and
  raise (never fall back) when there is no GPU;
* a kernel wrapper given a CPU tensor runs its plain version and launches
  nothing;
* the kernel-route table is enumerable and counts every decision;
* on the card a gate's rejection raises with its reason: the plain
  composition runs there only when a flag asks for it.
"""

import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu_torch
from paddle_tpu_torch import flags
from paddle_tpu_torch import fluid
from paddle_tpu_torch.framework import core, unique_name
from paddle_tpu_torch.framework.errors import (UnavailableError,
                                               UnimplementedError)
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry
from paddle_tpu_torch.ops.cuda import flash_attention as tfa
from paddle_tpu_torch.ops.cuda import fused_ops as tF

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, "paddle_tpu_torch")


@pytest.fixture(autouse=True)
def _fresh_port_state():
    core.reset_default_programs()
    fluid.global_scope().drop_all()
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    yield
    core.reset_default_programs()
    fluid.global_scope().drop_all()


def test_import_pulls_in_no_jax():
    code = ("import sys, paddle_tpu_torch, paddle_tpu_torch.fluid, "
            "paddle_tpu_torch.inference, paddle_tpu_torch.serving, "
            "paddle_tpu_torch.io;"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'paddle_tpu' or "
            "m.startswith('paddle_tpu.'));"
            "print(bad); sys.exit(1 if bad else 0)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _port_sources():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, dirs, names in os.walk(PKG):
        dirs[:] = [d for d in dirs if d != "_build"]     # kernel build output
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return files


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 20
    bad = []
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "paddle_tpu"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad


def test_entry_points_need_a_gpu_unless_the_cpu_is_asked_for(
        monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(UnavailableError, match="no CUDA device"):
        fluid.Executor()
    with pytest.raises(UnavailableError):
        fluid.Executor(fluid.CUDAPlace(0))
    assert fluid.Executor(fluid.CPUPlace()).device.type == "cpu"

    from paddle_tpu_torch.inference import (AnalysisConfig,
                                            create_paddle_predictor)
    cfg = AnalysisConfig(str(tmp_path))
    assert cfg.use_gpu()
    with pytest.raises(UnavailableError):
        create_paddle_predictor(cfg)


def test_kernel_wrappers_run_plain_on_cpu_and_launch_nothing():
    q, k, v = (torch.randn(4, 128, 64) for _ in range(3))
    bias = torch.zeros(2, 128, 128)
    o, lse = tfa.flash_fwd(q, k, v, bias)
    po, plse = tfa.flash_fwd_plain(q, k, v, bias)
    assert torch.equal(o, po) and torch.equal(lse, plse)
    x, r = torch.randn(10, 256), torch.randn(10, 256)
    s, b = torch.rand(256) + 0.5, torch.randn(256)
    assert torch.equal(tF.layer_norm(x, s, b), tF.layer_norm_plain(x, s, b))
    assert torch.equal(tF.add_layer_norm(x, r, s, b),
                       tF.add_layer_norm_plain(x, r, s, b))
    assert torch.equal(tF.bias_gelu(x, b), tF.bias_gelu_plain(x, b))
    assert port_cuda.launch_counts() == {
        "flash_attention_fwd": 0, "flash_attention_bwd_dq": 0,
        "flash_attention_bwd_dkv": 0, "layer_norm_fwd": 0,
        "layer_norm_bwd": 0, "add_layer_norm_fwd": 0,
        "add_layer_norm_bwd": 0, "bias_gelu_fwd": 0, "bias_gelu_bwd": 0,
        "adam": 0, "dequant_accumulate": 0, "dequant_accumulate_requant": 0}


def test_kernel_wrappers_refuse_other_devices():
    meta = torch.empty(2, 128, device="meta")
    with pytest.raises(ValueError, match="no kernel for device"):
        tF.layer_norm(meta, torch.empty(128, device="meta"),
                      torch.empty(128, device="meta"))


def test_nothing_is_built_at_import():
    from paddle_tpu_torch.ops.cuda import build
    assert not build._LIBS
    assert set(build.SOURCES) == {"flash_attention", "flash_attention_bwd",
                                  "layer_norm", "bias_gelu", "adam",
                                  "quant_accumulate"}
    for name in build.SOURCES:
        path = build.library_path(name)
        assert path.startswith(build.BUILD_DIR)
        assert path.endswith(".so")


def test_route_table_names_every_kernel_and_what_it_replaces():
    table = registry.route_table()
    assert set(table) == {"fused_attention", "multihead_matmul",
                          "layer_norm", "fused_add_layernorm",
                          "fused_elemwise_activation", "adam", "adamw",
                          "c_quant_allreduce_sum",
                          "c_fused_quant_allreduce_sum"}
    kernels = {k for routes in table.values() for r in routes
               for k in r.kernels}
    assert kernels == set(port_cuda.LAUNCHES)
    for routes in table.values():
        for r in routes:
            assert len(r.replaces) == len(r.kernels)
            assert len(r.sources) == len(r.kernels)
            for source in r.sources:
                assert os.path.isfile(os.path.join(REPO, source))
    from paddle_tpu_torch.ops.op_specs import kernel_facts
    facts = kernel_facts()
    assert set(facts) == set(port_cuda.LAUNCHES)
    for name, (source, tpu) in facts.items():
        # file:line names the def of the Pallas kernel in the JAX package
        path, line = tpu.split(":")
        assert path.startswith("paddle_tpu/ops/pallas/")
        with open(os.path.join(REPO, path)) as f:
            text = f.read().splitlines()[int(line) - 1]
        assert text.startswith("def _") and "_kernel(" in text, (name, text)
        assert source.startswith("paddle_tpu_torch/ops/cuda/csrc/")


def _ln_ins(d, dtype=torch.float32):
    return {"X": [torch.zeros(4, 3, d, dtype=dtype)],
            "Scale": [torch.ones(d, dtype=dtype)],
            "Bias": [torch.zeros(d, dtype=dtype)]}


def test_cuda_route_counts_hits_and_fallbacks_with_reasons():
    attrs = {"begin_norm_axis": 2}
    route, why = registry.cuda_route("layer_norm", _ln_ins(256), attrs)
    assert route is not None and route.kernel == "fused_layer_norm"
    route, why = registry.cuda_route("layer_norm", _ln_ins(200), attrs)
    assert route is None and why == "norm-dim:200"
    flags.set_flags({"use_pallas_fused": False})
    try:
        route, why = registry.cuda_route("layer_norm", _ln_ins(256), attrs)
        assert route is None and why == "flag:use_pallas_fused=off"
    finally:
        flags.set_flags({"use_pallas_fused": True})
    # the pooled tanh is not a bias+GELU: skipped, not a fallback
    route, why = registry.cuda_route(
        "fused_elemwise_activation",
        {"X": [torch.zeros(2, 128)], "Y": [torch.zeros(128)]},
        {"functor_list": ["elementwise_add", "tanh"], "axis": 1})
    assert route is None and why == "no-matching-route"
    counts = registry.route_counts()
    assert counts[("layer_norm", "fused_layer_norm", "hit",
                   "supported")] == 1
    assert counts[("layer_norm", "fused_layer_norm", "fallback",
                   "norm-dim:200")] == 1
    assert counts[("layer_norm", "fused_layer_norm", "fallback",
                   "flag:use_pallas_fused=off")] == 1
    assert not any(k[0] == "fused_elemwise_activation" for k in counts)


def test_fused_attention_route_falls_back_for_training_dropout():
    """Training-mode dropout used to be the flash route's fallback; the
    kernels now draw the mask themselves, so it is a hit, and what still
    falls back is a rate the kernels cannot take (and with it, on the
    card, a refusal)."""
    from paddle_tpu_torch.ops.registry import LoweringContext, get_op
    q = torch.randn(2, 128, 128)
    ins = {"Q": [q], "K": [q], "V": [q]}
    attrs = {"n_head": 2, "dropout_rate": 0.1, "is_test": False,
             "causal": False}
    ctx = LoweringContext(torch.Generator().manual_seed(0))
    out = get_op("fused_attention")(ctx, ins, attrs)["Out"]
    assert out.shape == q.shape
    attrs["is_test"] = True
    get_op("fused_attention")(ctx, ins, attrs)
    assert registry.route_counts("hit") == {
        ("fused_attention", "flash_attention", "hit", "supported"): 2}
    attrs.update(is_test=False, dropout_rate=1.0)
    get_op("fused_attention")(ctx, ins, attrs)
    assert registry.route_counts("fallback") == {
        ("fused_attention", "flash_attention", "fallback",
         "dropout-rate:1.0"): 1}
    qm = torch.empty(2, 128, 128, device="meta")
    with pytest.raises(UnimplementedError, match="dropout-rate"):
        get_op("fused_attention")(ctx, {"Q": [qm], "K": [qm], "V": [qm]},
                                  attrs)


def _meta_ln_ins(d):
    return {k: [t.to("meta") for t in v] for k, v in _ln_ins(d).items()}


def test_a_gate_rejection_off_the_cpu_raises_unless_a_flag_asks():
    attrs = {"begin_norm_axis": 2}
    route, _ = registry.cuda_route("layer_norm", _meta_ln_ins(256), attrs)
    assert route is not None
    with pytest.raises(UnimplementedError, match="norm-dim:200"):
        registry.cuda_route("layer_norm", _meta_ln_ins(200), attrs)
    ins = _meta_ln_ins(200)
    ins["Residual"] = list(ins["X"])
    with pytest.raises(UnimplementedError, match="norm-dim:200"):
        registry.cuda_route("fused_add_layernorm", ins, attrs)
    with pytest.raises(UnimplementedError, match="dim:200"):
        registry.cuda_route(
            "fused_elemwise_activation",
            {"X": [torch.empty(4, 200, device="meta")],
             "Y": [torch.empty(200, device="meta")]},
            {"functor_list": ["elementwise_add", "gelu"]})
    qm = torch.empty(1, 2, 128, 32, device="meta")
    with pytest.raises(UnimplementedError, match="head-dim:32"):
        registry.cuda_route("multihead_matmul",
                            {"Q": [qm], "K": [qm], "V": [qm]}, {})
    # an explicit flag-off request is the only way to the plain path there
    flags.set_flags({"use_pallas_fused": False})
    try:
        route, why = registry.cuda_route("layer_norm", _meta_ln_ins(200),
                                         attrs)
    finally:
        flags.set_flags({"use_pallas_fused": True})
    assert route is None and why == "flag:use_pallas_fused=off"
    assert registry.route_counts("fallback") == {
        ("layer_norm", "fused_layer_norm", "fallback",
         "flag:use_pallas_fused=off"): 1}


def test_startup_program_draws_from_a_seeded_generator():
    from paddle_tpu_torch.models import bert
    cfg = bert.BertConfig(vocab_size=64, hidden_size=128,
                          num_hidden_layers=1, num_attention_heads=2,
                          intermediate_size=256, max_position_embeddings=32)

    def init(seed):
        unique_name.reset()
        main, startup = core.Program(), core.Program()
        startup.random_seed = seed
        with core.program_guard(main, startup):
            bert.build_inference_network(cfg)
        scope = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
        return scope

    a, b, c = init(1), init(1), init(2)
    w = "encoder_layer_0_qkv_w"
    assert torch.equal(a.find_var(w), b.find_var(w))
    assert not torch.equal(a.find_var(w), c.find_var(w))
    vals = a.find_var(w)
    assert float(vals.abs().max()) <= 2 * 0.02 + 1e-7   # truncated at 2σ
    assert abs(float(vals.std()) - 0.0176) < 0.002    # σ of N(0,.02)|2σ
    assert torch.equal(a.find_var("encoder_layer_0_ln1_scale"),
                       torch.ones(128))
    assert paddle_tpu_torch.__version__
    assert np.isfinite(a.find_var("word_embedding").numpy()).all()
