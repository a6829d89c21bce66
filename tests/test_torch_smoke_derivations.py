"""``chip_smoke.py``'s launch and bucket figures, derived from the config
and the built program, against the numbers the 12-layer phases were
written with: the adamw ops of BERT-base (158), the fused program's
launch table, the quantized data-parallel step's 13 buckets at the 32 MB
cap (and their shard sizes at n = 2, block 256) and the overlapped run's
75 ready-order buckets at 4 MB.  Phases 15-17 run BERT-base's width at
``CUT_LAYERS`` layers with the same derivations, so this holds what they
gate to the same rules.  Builds programs only (no startup, no step)."""

import importlib.util
import os

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_under_test", os.path.join(REPO, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _program(smoke, layers=12):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.framework import unique_name
    from paddle_tpu_torch.models import bert
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    cfg = smoke.cut_depth(bert.BertConfig.base(), layers)
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        smoke.recipe_optimizer(fluid).minimize(total)
    return main


#: the 12-layer tables the phases were written with
FUSED_12 = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
            "flash_attention_bwd_dkv": 12, "layer_norm_fwd": 1,
            "layer_norm_bwd": 1, "adam": 1, "add_layer_norm_fwd": 25,
            "add_layer_norm_bwd": 25, "bias_gelu_fwd": 13,
            "bias_gelu_bwd": 13}
TRAIN_12 = {"flash_attention_fwd": 12, "flash_attention_bwd_dq": 12,
            "flash_attention_bwd_dkv": 12, "layer_norm_fwd": 26,
            "layer_norm_bwd": 26, "adam": 1}


def test_the_launch_tables_are_the_12_layer_ones(smoke):
    assert smoke.fused_launches(12) == FUSED_12 == smoke.FUSED_LAUNCHES
    assert smoke.train_launches(12) == TRAIN_12 == smoke.TRAIN_LAUNCHES
    assert smoke.CUT_LAYERS < 12


@pytest.mark.parametrize("layers", [12, 2])
def test_adam_ops_and_the_launch_table_follow_the_program(smoke, layers):
    """158 adamw ops at 12 layers (the ADAM_OPS the 12-layer phases
    check), 12 a layer plus 14; and the fused program's kernel ops by
    type match ``fused_launches(layers)``."""
    from paddle_tpu_torch.framework.passes import apply_pass
    main = _program(smoke, layers)
    assert smoke.adam_ops(main) == 12 * layers + 14
    if layers == 12:
        assert smoke.adam_ops(main) == smoke.ADAM_OPS
    loss = next(op for op in main.global_block().ops
                if op.type == "backward").attrs["loss_name"]
    apply_pass(main, "fuse_add_layernorm", fetch_names=[loss])
    apply_pass(main, "fuse_elemwise_add_act", fetch_names=[loss])
    types = [op.type if op.type != "fused_elemwise_activation" else
             op.type + ":" + op.attrs["functor_list"][-1]
             for op in main.global_block().ops]
    want = smoke.fused_launches(layers)
    assert types.count("fused_attention") == want["flash_attention_fwd"]
    assert types.count("fused_add_layernorm") == want["add_layer_norm_fwd"]
    assert types.count("layer_norm") == want["layer_norm_fwd"]
    assert types.count("fused_elemwise_activation:gelu") == \
        want["bias_gelu_fwd"]


def _buckets(smoke, strategy):
    from paddle_tpu_torch.framework.compiler import insert_grad_sync
    main = _program(smoke)
    insert_grad_sync(main, strategy, 2, ("dp",), axis_sizes={"dp": 2})
    block = main.global_block()
    return smoke.grad_sync_buckets(main), [
        sum(int(abs(__import__("math").prod(
            block._find_var_recursive(g).shape))) for g in op.input("X"))
        for op in block.ops if op.type in smoke.GRAD_SYNC_BUCKETS]


def test_the_quantized_step_has_13_buckets_of_the_phase_9_shards(smoke):
    from paddle_tpu_torch import fluid
    from paddle_tpu_torch.ops.quantize_wire import CompressionSpec
    bs = fluid.BuildStrategy()
    bs.fuse_all_reduce_ops = True
    bs.fuse_grad_size_in_MB = 32
    bs.allreduce_quant_spec = CompressionSpec("int8", 256).to_attr()
    n, numels = _buckets(smoke, bs)
    assert n == smoke.DP_BUCKETS == 13
    assert [-(-k // (2 * 256)) for k in numels] == \
        list(smoke.STEP_BUCKET_SB)


def test_the_overlapped_run_has_75_ready_order_buckets_at_4_mb(smoke):
    from paddle_tpu_torch import fluid
    bs = fluid.BuildStrategy()
    bs.fuse_all_reduce_ops = True
    bs.overlap_grad_sync = True
    bs.overlap_bucket_size_in_MB = 4
    bs.overlap_min_buckets = 4
    n, _ = _buckets(smoke, bs)
    assert n == 75
