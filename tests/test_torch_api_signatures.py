"""Every keyword the JAX package's public API takes, the port takes too.

For each public class (its constructor and the public methods both
packages define) and function that both packages export from the
modules below, every parameter of the JAX signature is accepted by the
port's: by name, or through a ``**kwargs``.  A script written for the
JAX package then fails on the port only where the port refuses by name,
never with a bare ``TypeError``.  The keywords the port had lacked are
driven as well: ``DecodeConfig(prefix_reserve_blocks=...)``,
``ServingConfig(packing=..., mask_feed=..., pack_max_segments=...)`` and
``Executor.run(use_prune=...)``.  The parallelism package (topology, the
Megatron layers, ring attention, the pipeline's ``PipelineOptimizer`` and
``gpipe_spmd``, and MoE's ``moe_ffn``, ``collect_aux_losses`` and
``apply_expert_sharding``), ``framework.pipe`` and
``models.bert``'s builders (the tensor/sequence-parallel ones included)
are compared as well, and so is the pricing layer
(``framework.memory_analysis``, ``framework.shard_planner``,
``observability.flops``)."""

import importlib
import inspect

import numpy as np
import pytest

import paddle_tpu.fluid  # noqa: F401  (registers the JAX package's ops)
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.serving.decode import DecodeConfig
from paddle_tpu_torch.serving.engine import ServingConfig

MODULES = ("optimizer", "framework.executor", "framework.compiler",
           "inference", "io", "serving.engine", "serving.decode",
           "distributed.fleet", "layers.control_flow",
           "framework.mesh_layout", "framework.fsdp", "framework.reshard",
           "framework.analysis", "distributed.gloo",
           "distributed.preemption", "parallel", "parallel.topology",
           "parallel.tp_layers", "parallel.ring_attention", "models.bert",
           "framework.pipe", "parallel.pipeline", "parallel.moe",
           "framework.memory_analysis", "framework.shard_planner",
           "observability.flops")

#: JAX internals whose parameters differ by design, with the reason
ALLOWED = {
    ("framework.executor", "LoweringContext.__init__"): {
        # a JAX PRNG key and a device mesh; the port carries a
        # torch.Generator and its process group instead
        "key", "mesh", "axis_names"},
    ("framework.executor", "lower_decode_chain"): {
        # the JAX lowering threads the pools through lax.scan's carry by
        # name; the port's loop writes the env's pool tensors in place
        "pool_names"},
}


def _callables(obj, name):
    """(qualified name, JAX-side callable) pairs to compare: a function,
    or a class's constructor and its public methods."""
    if inspect.isfunction(obj):
        return [(name, obj)]
    out = [(f"{name}.__init__", obj.__init__)]
    out += [(f"{name}.{m}", f) for m, f in vars(obj).items()
            if not m.startswith("_") and inspect.isfunction(f)]
    return out


def _shared_api():
    cases = []
    for mod in MODULES:
        jmod = importlib.import_module(f"paddle_tpu.{mod}")
        tmod = importlib.import_module(f"paddle_tpu_torch.{mod}")
        for name in sorted(set(dir(jmod)) & set(dir(tmod))):
            if name.startswith("_"):
                continue
            jobj, tobj = getattr(jmod, name), getattr(tmod, name)
            if not all(inspect.isclass(o) or inspect.isfunction(o)
                       for o in (jobj, tobj)):
                continue
            for qual, jfn in _callables(jobj, name):
                attr = qual.split(".", 1)[1] if "." in qual else None
                tfn = tobj if attr is None else getattr(tobj, attr, None)
                if callable(tfn):
                    cases.append((mod, qual, jfn, tfn))
    return cases


SHARED = _shared_api()


def test_the_shared_api_is_large():
    assert len(SHARED) > 100
    assert {mod for mod, *_ in SHARED} == set(MODULES)


@pytest.mark.parametrize("mod", MODULES)
def test_every_jax_keyword_is_accepted(mod):
    missing = {}
    for m, qual, jfn, tfn in SHARED:
        if m != mod:
            continue
        try:
            jsig, tsig = inspect.signature(jfn), inspect.signature(tfn)
        except (TypeError, ValueError):
            continue
        params = tsig.parameters
        varkw = any(p.kind is p.VAR_KEYWORD for p in params.values())
        lost = {p.name for p in jsig.parameters.values()
                if p.kind not in (p.VAR_KEYWORD, p.VAR_POSITIONAL)
                and p.name not in params
                and not (varkw and p.kind is not p.POSITIONAL_ONLY)}
        lost -= ALLOWED.get((mod, qual), set())
        if lost:
            missing[qual] = sorted(lost)
    assert not missing, missing


def test_the_allow_list_names_real_differences():
    """Each allowed parameter exists in the JAX signature and not in the
    port's, so the list cannot hide a repaired or a renamed parameter."""
    by_qual = {(m, q): (j, t) for m, q, j, t in SHARED}
    for key, names in ALLOWED.items():
        jfn, tfn = by_qual[key]
        jp = inspect.signature(jfn).parameters
        tp = inspect.signature(tfn).parameters
        assert names <= set(jp) and not names & set(tp), key


#: the optimizers and the checkpoint API the port took over (with their
#: short aliases), each compared keyword by keyword above
OPTIMIZERS_AND_CHECKPOINTS = {
    "optimizer": {
        "MomentumOptimizer", "LarsMomentumOptimizer", "LambOptimizer",
        "AdagradOptimizer", "DecayedAdagradOptimizer", "RMSPropOptimizer",
        "AdadeltaOptimizer", "AdamaxOptimizer", "FtrlOptimizer",
        "DpsgdOptimizer", "Momentum", "LarsMomentum", "Lamb", "Adagrad",
        "DecayedAdagrad", "RMSProp", "Adadelta", "Adamax", "Ftrl",
        "Dpsgd"},
    "io": {"TrainStatus", "save_checkpoint", "load_checkpoint",
           "validate_checkpoint_dir", "save_params", "load_params",
           "AsyncCheckpointer", "save_persistables_sharded",
           "load_persistables_sharded"},
    "framework.reshard": {"plan_reshard", "plan_var_transfer",
                          "execute_reshard", "flat_shard_meta",
                          "flat_moved_bytes", "spec_dim_divisors",
                          "ReshardPlan", "VarTransfer", "ReshardStep"},
    "framework.analysis": {"verify_reshard", "VerifyResult", "Diagnostic"},
}


@pytest.mark.parametrize("mod", sorted(OPTIMIZERS_AND_CHECKPOINTS))
def test_the_optimizers_and_checkpoints_are_shared_api(mod):
    names = {qual.split(".")[0] for m, qual, *_ in SHARED if m == mod}
    assert OPTIMIZERS_AND_CHECKPOINTS[mod] <= names
    tmod = importlib.import_module(f"paddle_tpu_torch.{mod}")
    jmod = importlib.import_module(f"paddle_tpu.{mod}")
    for name in OPTIMIZERS_AND_CHECKPOINTS[mod]:
        if name.endswith("Optimizer"):
            # the short alias names the same class in both packages
            alias = name[:-len("Optimizer")]
            assert getattr(tmod, alias) is getattr(tmod, name)
            assert getattr(jmod, alias) is getattr(jmod, name)


#: the wrapper optimizers and the control flow they need, each compared
#: keyword by keyword above (constructor and public methods)
WRAPPERS_AND_CONTROL_FLOW = {
    "optimizer": {"RecomputeOptimizer", "GradientMergeOptimizer",
                  "DGCMomentumOptimizer", "ModelAverage",
                  "ExponentialMovingAverage", "LookaheadOptimizer",
                  "LocalSGDOptimizer"},
    "layers.control_flow": {"cond", "case"},
}


@pytest.mark.parametrize("mod", sorted(WRAPPERS_AND_CONTROL_FLOW))
def test_the_wrappers_and_cond_are_shared_api(mod):
    quals = {qual for m, qual, *_ in SHARED if m == mod}
    names = {qual.split(".")[0] for qual in quals}
    assert WRAPPERS_AND_CONTROL_FLOW[mod] <= names
    if mod == "optimizer":
        # the swaps' entry points are compared too
        assert {"ModelAverage.apply", "ModelAverage.restore",
                "ExponentialMovingAverage.update",
                "ExponentialMovingAverage.apply",
                "RecomputeOptimizer.backward",
                "GradientMergeOptimizer.minimize",
                "LookaheadOptimizer.minimize",
                "LocalSGDOptimizer.minimize"} <= quals


def test_the_ported_checkpoint_keeps_the_jax_constants():
    from paddle_tpu import io as jio
    from paddle_tpu_torch import io as tio
    assert (tio.CKPT_FORMAT_VERSION, tio.MANIFEST_FILE) == \
        (jio.CKPT_FORMAT_VERSION, jio.MANIFEST_FILE)
    assert issubclass(tio.ChecksumMismatchError, OSError)
    # the background writer is ported: nothing in flight, nothing to join
    ck = tio.AsyncCheckpointer()
    assert not ck.in_flight and ck.drain()


@pytest.mark.parametrize("reserve", [0, 3])
def test_prefix_reserve_blocks_is_taken_as_jax_takes_it(reserve):
    cfg = DecodeConfig(prefix_reserve_blocks=reserve)
    assert cfg.prefix_reserve_blocks == reserve


def test_negative_prefix_reserve_blocks_raises_as_in_jax():
    from paddle_tpu.framework.errors import \
        InvalidArgumentError as JInvalidArgumentError
    from paddle_tpu.serving.decode import DecodeConfig as JDecodeConfig
    with pytest.raises(JInvalidArgumentError, match="prefix_reserve_blocks"):
        JDecodeConfig(prefix_reserve_blocks=-1)
    with pytest.raises(InvalidArgumentError, match="prefix_reserve_blocks"):
        DecodeConfig(prefix_reserve_blocks=-1)
    # the budget that reads it is taken (the pool is sized by
    # memory_analysis.plan_cache_pool at engine start)
    cfg = DecodeConfig(hbm_budget_gb=1.0, prefix_reserve_blocks=2)
    assert cfg.hbm_budget_gb == 1.0 and cfg.prefix_reserve_blocks == 2


def test_serving_packing_keywords():
    cfg = ServingConfig(packing=False, mask_feed="input_mask",
                        pack_max_segments=2)
    assert (cfg.packing, cfg.mask_feed, cfg.pack_max_segments) == \
        (False, "input_mask", 2)
    seq = dict(seq_buckets=(64,), seq_feeds=("src_ids", "input_mask"))
    # JAX's own checks come first, as there
    with pytest.raises(InvalidArgumentError, match="seq_buckets"):
        ServingConfig(packing=True, mask_feed="input_mask")
    with pytest.raises(InvalidArgumentError, match="mask_feed"):
        ServingConfig(packing=True, mask_feed="pos_ids", **seq)
    with pytest.raises(InvalidArgumentError, match="pack_max_segments"):
        ServingConfig(packing=True, mask_feed="input_mask",
                      pack_max_segments=0, **seq)
    with pytest.raises(UnimplementedError, match="ragged"):
        ServingConfig(packing=True, mask_feed="input_mask", **seq)


@pytest.mark.parametrize("use_prune", [False, True])
def test_executor_run_takes_use_prune(use_prune):
    tcore.reset_default_programs()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        y = tfluid.layers.fc(x, 2)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope, use_prune=use_prune)
    feed = {"x": np.ones((3, 4), np.float32)}
    out, = exe.run(main, feed=feed, fetch_list=[y], scope=scope,
                   use_prune=use_prune)
    ref, = exe.run(main, feed=feed, fetch_list=[y], scope=scope)
    np.testing.assert_array_equal(out, ref)
    tcore.reset_default_programs()


def test_fetch_handles_count_their_wait_in_the_steps_stats():
    """``FetchHandle(value, name, stats)`` as in the JAX package: a
    prepared step's handles add their host wait to its
    ``fetch_wait_ns``."""
    tcore.reset_default_programs()
    main, startup = tcore.Program(), tcore.Program()
    with tcore.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        y = tfluid.layers.fc(x, 2)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    step = exe.prepare(main, fetch_list=[y], scope=scope)
    assert step.stats["fetch_wait_ns"] == 0
    handle, = step.run({"x": np.ones((3, 4), np.float32)})
    assert handle._stats is step.stats
    handle.numpy()
    waited = step.stats["fetch_wait_ns"]
    assert waited >= 0
    handle.numpy()                        # cached: no second wait counted
    assert step.stats["fetch_wait_ns"] == waited
    tcore.reset_default_programs()


#: ZeRO's public names: the sharded update, the layout and the ZeRO-3
#: rewrite, each compared keyword by keyword above
ZERO = {
    "optimizer": {"ShardedUpdateOptimizer.__init__",
                  "ShardedUpdateOptimizer.apply_gradients",
                  "ShardedUpdateOptimizer.minimize"},
    "framework.mesh_layout": {"MeshLayout.__init__", "MeshLayout.build_mesh",
                              "MeshLayout.spec", "MeshLayout.to_desc"},
    "framework.fsdp": {"apply_fsdp_sharding"},
    "framework.compiler": {"CompiledProgram.with_mesh"},
}


@pytest.mark.parametrize("mod", sorted(ZERO))
def test_zero_is_shared_api(mod):
    quals = {qual for m, qual, *_ in SHARED if m == mod}
    assert ZERO[mod] <= quals


#: the pipeline's public names (the stage-cut rewrite, the schedules,
#: PipelineOptimizer, gpipe_spmd), each compared keyword by keyword above
PIPELINE = {
    "framework.pipe": {"plan_stage_cuts", "simulate_schedule",
                       "schedule_1f1b", "enumerate_schedules",
                       "set_microbatches", "apply_pipeline",
                       "apply_pipe_weight_sharding", "StageCutPlan.__init__",
                       "StageCutPlan.as_dict", "plan_remat", "apply_remat"},
    "parallel.pipeline": {"gpipe_spmd", "PipelineOptimizer.__init__",
                          "PipelineOptimizer.minimize"},
}


@pytest.mark.parametrize("mod", sorted(PIPELINE))
def test_the_pipeline_is_shared_api(mod):
    quals = {qual for m, qual, *_ in SHARED if m == mod}
    assert PIPELINE[mod] <= quals


#: MoE's public names, each compared keyword by keyword above, in the
#: package and in its module
MOE = {
    "parallel": {"moe_ffn", "collect_aux_losses", "apply_expert_sharding"},
    "parallel.moe": {"moe_ffn", "collect_aux_losses",
                     "apply_expert_sharding"},
}


@pytest.mark.parametrize("mod", sorted(MOE))
def test_moe_is_shared_api(mod):
    quals = {qual for m, qual, *_ in SHARED if m == mod}
    assert MOE[mod] <= quals


#: the pricing layer's public names (the static estimate, the wire and
#: exposed-comm model, the planner, remat planning), each compared keyword
#: by keyword above
PRICING = {
    "framework.memory_analysis": {
        "analyze_memory", "estimate", "lint_memory", "check_hbm_budget",
        "plan_cache_pool", "collective_wire_summary", "exposed_comm_model",
        "mem_uncovered_suspects", "mesh_axes_of", "sig_bytes",
        "block_liveness", "program_liveness", "LiveTensor.__init__",
        "MemoryEstimate.__init__", "MemoryEstimate.as_dict",
        "MemoryEstimate.report", "Interval.__init__"},
    "framework.shard_planner": {
        "legal_tp_degrees", "legal_pipe_degrees", "legal_expert_degrees",
        "enumerate_layouts", "price_config", "plan_sharding",
        "stamp_winning_layout", "PlanConfig.__init__", "PlanConfig.as_dict",
        "Plan.__init__", "Plan.as_dict", "Plan.report", "Plan.write_report"},
    "observability.flops": {"estimate_step_flops", "device_peak_flops"},
    "framework.pipe": {"RematPlan.__init__", "RematPlan.as_dict",
                       "plan_remat", "apply_remat"},
}


@pytest.mark.parametrize("mod", sorted(PRICING))
def test_the_pricing_layer_is_shared_api(mod):
    quals = {qual for m, qual, *_ in SHARED if m == mod}
    assert PRICING[mod] <= quals
