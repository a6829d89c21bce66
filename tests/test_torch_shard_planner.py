"""The port's auto-shard planner (``framework/shard_planner.py``) against
the JAX package's on the same programs: the MLP of
``tests/test_shard_planner.py``, BERT-tiny pretraining (AdamW, without
and with a global-norm clip), its tensor-parallel build (tp-annotated
weights) and MoE BERT-tiny — each built by the JAX builders and crossed into the port
as the versioned desc, both planners given the same peak FLOP/s and link
figure.

* ``enumerate_layouts`` and the legal tp / pipe / expert degrees;
* ``plan_sharding``'s ranking at 2, 4 and 8 devices, without and with a
  budget (halfway between the free plan's peaks), with ``max_pipe`` and
  ``max_expert`` on, and with the ``remat`` dimension: the layout order,
  ``fits``, the winner, each config's peak and wire bytes (int64 at the
  JAX package's width) and its exposed-comm cost; no config carries an
  error;
* ``audit_winner=True`` and a winner the port does not run raise by name
  (``stamp_winning_layout`` never swaps in the runner-up);
* planning runs nothing: no route decision, no kernel launch, no CUDA
  context.

The two-rank runs of ``strategy.auto_shard`` are in
``tests/test_torch_zero.py`` (the zero3 launch)."""

import json

import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import flags as jflags
from paddle_tpu.framework import shard_planner as jsp
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.framework import memory_analysis as tma
from paddle_tpu_torch.framework import shard_planner as tsp
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.framework.mesh_layout import MeshLayout
from paddle_tpu_torch.framework.serialization import desc_to_program
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry

PEAK = 989e12
LINK = 0.75
B, S, MASKS = 4, 32, 5


@pytest.fixture(autouse=True)
def _figures(monkeypatch):
    """Both planners at the same peak and link figure; int64 priced at
    the JAX package's width."""
    jold = jflags.get_flags(["ici_gbps", "device_peak_flops"])
    told = tflags.get_flags(["link_gbps", "device_peak_flops"])
    jflags.set_flags({"ici_gbps": LINK, "device_peak_flops": PEAK})
    tflags.set_flags({"link_gbps": LINK, "device_peak_flops": PEAK})
    monkeypatch.setitem(registry.DTYPE_BYTES, "int64", 4)
    yield
    jflags.set_flags(jold)
    tflags.set_flags(told)


def _bert_feeds():
    return {"src_ids": ((B, S), "int64"), "pos_ids": ((B, S), "int64"),
            "sent_ids": ((B, S), "int64"),
            "input_mask": ((B, S, 1), "float32"),
            "mask_label": ((B * MASKS, 1), "int64"),
            "mask_pos": ((B, MASKS), "int64"), "labels": ((B, 1), "int64")}


def _mlp():
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", shape=[16])
        label = jfluid.layers.data("label", shape=[1], dtype="int64")
        h = x
        for i in range(2):
            h = jfluid.layers.fc(h, 32, act="relu", bias_attr=False,
                                 param_attr=jfluid.ParamAttr(name=f"w{i + 1}"))
        pred = jfluid.layers.fc(h, 4, act="softmax", bias_attr=False,
                                param_attr=jfluid.ParamAttr(name="w3"))
        loss = jfluid.layers.mean(jfluid.layers.cross_entropy(pred, label))
        jfluid.optimizer.Adam(5e-3).minimize(loss)
    return main, loss, {"x": ((64, 16), "float32"),
                        "label": ((64, 1), "int64")}


def _bert(kind):
    jun.reset()
    cfg = jbert.BertConfig.tiny()
    if kind == "moe":
        cfg.moe_experts = 4
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 7
    feeds = _bert_feeds()
    with jfluid.program_guard(main, startup):
        if kind == "tp":
            _, total = jbert.build_pretrain_network_parallel(cfg, 2)
            feeds = {n: ((B, S), "float32" if n in ("kv_mask", "lm_weights")
                         else "int64")
                     for n in ("src_ids", "pos_ids", "sent_ids", "kv_mask",
                               "lm_labels", "lm_weights")}
        else:
            _, total, _, _ = jbert.build_pretrain_network(cfg)
        clip = jfluid.clip.GradientClipByGlobalNorm(1.0) \
            if kind == "bert_clip" else None
        jfluid.optimizer.AdamW(1e-3, weight_decay=0.01,
                               grad_clip=clip).minimize(total)
    return main, total, feeds


@pytest.fixture(scope="module")
def programs():
    cache = {}

    def get(name):
        if name not in cache:
            main, loss, feeds = _mlp() if name == "mlp" else _bert(name)
            cache[name] = (main, desc_to_program(jdesc(main)), loss.name,
                           feeds)
        return cache[name]
    return get


@pytest.fixture(scope="module")
def free_plans(programs):
    """Both packages' plans without a budget, made once per program,
    device count and options (the tight case's budget comes from them)."""
    cache = {}

    def get(name, nd, kw):
        key = (name, nd, tuple(sorted(kw.items())))
        if key not in cache:
            jmain, tmain, loss, feeds = programs(name)
            args = dict(loss_name=loss, feed_shapes=feeds,
                        fetch_names=[loss], **kw)
            cache[key] = (jsp.plan_sharding(jmain, nd, **args),
                          tsp.plan_sharding(tmain, nd, **args))
        return cache[key]
    return get


def _rows(plan):
    return [(c.layout.sizes, c.fits, c.winner, c.remat, c.peak_bytes,
             c.wire_bytes, c.error) for c in plan.configs]


def _same_plan(jp, tp):
    assert _rows(tp) == _rows(jp)
    assert [c.layout.sizes for c in sorted(tp.configs,
                                           key=tsp.PlanConfig.sort_key)] == \
        [c.layout.sizes for c in sorted(jp.configs,
                                        key=jsp.PlanConfig.sort_key)]
    for jc, tc in zip(jp.configs, tp.configs):
        assert tc.error is None, tc.error
        if jc.cost_s is None:
            assert tc.cost_s is None
        else:
            assert tc.cost_s == pytest.approx(jc.cost_s, rel=1e-12)
        jd, td = jc.as_dict(), tc.as_dict()
        assert set(td) == set(jd)
        for k in ("wire_by_op", "state_bytes", "fsdp_sharded_params",
                  "expert_exchanges", "expert_sharded_params"):
            assert td.get(k) == jd.get(k), k
    if jp.winner is None:
        assert tp.winner is None
    else:
        assert tp.winner.layout.sizes == jp.winner.layout.sizes


@pytest.mark.parametrize("name,nd,kw", [
    ("mlp", 2, {}), ("mlp", 4, {}), ("mlp", 8, {}),
    ("bert", 2, {}), ("bert", 4, {}), ("bert", 8, {}),
    ("tp", 4, {}), ("tp", 8, {"max_tp": 2}),
    ("bert", 4, {"max_pipe": 2, "num_microbatches": 2}),
    ("moe", 4, {"max_expert": 2}), ("moe", 8, {"max_expert": 4}),
], ids=lambda v: str(v))
def test_enumeration_is_the_jax_packages(programs, name, nd, kw):
    jmain, tmain, _, _ = programs(name)
    lk = {k: v for k, v in kw.items() if k != "num_microbatches"}
    got = tsp.enumerate_layouts(tmain, nd, **lk)
    want = jsp.enumerate_layouts(jmain, nd, **lk)
    assert [m.sizes for m in got] == [m.sizes for m in want]
    assert tsp.legal_tp_degrees(tmain, nd, max_tp=kw.get("max_tp")) == \
        jsp.legal_tp_degrees(jmain, nd, max_tp=kw.get("max_tp"))
    assert tsp.legal_pipe_degrees(tmain, nd, kw.get("max_pipe")) == \
        jsp.legal_pipe_degrees(jmain, nd, kw.get("max_pipe"))
    assert tsp.legal_expert_degrees(tmain, nd, kw.get("max_expert")) == \
        jsp.legal_expert_degrees(jmain, nd, kw.get("max_expert"))


@pytest.mark.parametrize("name,nd,kw", [
    ("mlp", 2, {"min_shard_numel": 64}), ("mlp", 4, {"min_shard_numel": 64}),
    ("mlp", 8, {"min_shard_numel": 64}),
    ("bert", 2, {}), ("bert", 4, {}), ("bert", 8, {}),
    ("tp", 4, {}),
    ("bert", 4, {"max_pipe": 2, "num_microbatches": 2}),
    ("moe", 4, {"max_expert": 2}),
], ids=lambda v: str(v))
@pytest.mark.parametrize("budget", ["free", "tight"])
def test_ranking_is_the_jax_packages(programs, free_plans, name, nd, kw,
                                     budget):
    jmain, tmain, loss, feeds = programs(name)
    args = dict(loss_name=loss, feed_shapes=feeds, fetch_names=[loss],
                **kw)
    jp, tp = free_plans(name, nd, kw)
    if budget == "free":
        _same_plan(jp, tp)
    else:
        peaks = sorted(c.peak_bytes for c in jp.configs)
        gb = (peaks[0] + peaks[-1]) / 2 / float(1 << 30)
        jp = jsp.plan_sharding(jmain, nd, hbm_budget_gb=gb, **args)
        tp = tsp.plan_sharding(tmain, nd, hbm_budget_gb=gb, **args)
        _same_plan(jp, tp)
        assert any(not c.fits for c in tp.configs)
    assert tp.winner is not None


@pytest.mark.parametrize("nd", [2, 4])
def test_a_clipped_programs_ranking_differs_only_by_the_clip_allreduce(
        programs, nd):
    """Under a global-norm clip the port's fsdp and expert rewrites add
    the clip's all-reduce (the JAX package clips each device by its own
    blocks): the layout order, fits and the winner stay the JAX
    package's, and each such config's peak and wire bytes differ by
    exactly that op's 8 grad-sync bytes and its wire row."""
    jmain, tmain, loss, feeds = programs("bert_clip")
    args = dict(loss_name=loss, feed_shapes=feeds, fetch_names=[loss])
    free = jsp.plan_sharding(jmain, nd, **args)
    peaks = sorted(c.peak_bytes for c in free.configs)
    gb = (peaks[0] + peaks[-1]) / 2 / float(1 << 30)
    jp = jsp.plan_sharding(jmain, nd, hbm_budget_gb=gb, **args)
    tp = tsp.plan_sharding(tmain, nd, hbm_budget_gb=gb, **args)
    assert [(c.layout.sizes, c.fits, c.winner) for c in tp.configs] == \
        [(c.layout.sizes, c.fits, c.winner) for c in jp.configs]
    assert tp.winner.layout.fsdp == nd
    for jc, tc in zip(jp.configs, tp.configs):
        assert tc.error is None
        row = tc.wire["by_op"].get("c_global_norm_allreduce")
        assert (row is not None) == (tc.layout.fsdp > 1)
        extra = row["wire_bytes"] if row else 0
        assert tc.wire_bytes - extra == jc.wire_bytes
        assert tc.peak_bytes - (8 if row else 0) == jc.peak_bytes


def test_remat_rows_are_the_jax_packages(programs):
    """A budget only recompute can meet: every rejected config gets its
    rematerialized sibling, priced as the JAX package prices it."""
    jmain, tmain, loss, feeds = programs("bert")
    args = dict(loss_name=loss, feed_shapes=feeds, fetch_names=[loss],
                remat=True)
    free = jsp.plan_sharding(jmain, 2, **args)
    gb = min(c.peak_bytes for c in free.configs) * 0.97 / float(1 << 30)
    jp = jsp.plan_sharding(jmain, 2, hbm_budget_gb=gb, **args)
    tp = tsp.plan_sharding(tmain, 2, hbm_budget_gb=gb, **args)
    _same_plan(jp, tp)
    remat = [c for c in tp.configs if c.remat]
    assert remat
    for jc, tc in zip([c for c in jp.configs if c.remat], remat):
        assert tc.remat_plan.as_dict() == pytest.approx(
            jc.remat_plan.as_dict())


def test_the_report_is_the_jax_packages_artifact(programs, tmp_path):
    jmain, tmain, loss, feeds = programs("mlp")
    args = dict(loss_name=loss, feed_shapes=feeds, fetch_names=[loss],
                min_shard_numel=64, module="auto_shard")
    jp = jsp.plan_sharding(jmain, 4, **args)
    tp = tsp.plan_sharding(tmain, 4, report_path=str(tmp_path / "p.json"),
                           **args)
    got = json.loads((tmp_path / "p.json").read_text())
    want = jp.as_dict()
    assert set(got) == set(want)
    assert got["format_version"] == tsp.PLAN_FORMAT_VERSION == \
        jsp.PLAN_FORMAT_VERSION
    for k in ("artifact", "module", "num_devices", "configs_priced",
              "compiles_attempted"):
        assert got[k] == want[k], k
    assert got["winner"]["winner"] and got["winner_audit"] is None
    assert tp.report().splitlines()[0] == jp.report().splitlines()[0]


def test_planning_runs_nothing(programs):
    """No route decision, no kernel launch and no CUDA context while the
    planner prices every layout: its forward runs on meta tensors."""
    _, tmain, loss, feeds = programs("bert")
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    plan = tsp.plan_sharding(tmain, 4, loss_name=loss, feed_shapes=feeds,
                             fetch_names=[loss])
    assert plan.winner is not None
    assert not registry.route_counts()
    assert not any(port_cuda.launch_counts().values())
    assert not torch.cuda.is_initialized()


def test_audit_winner_is_refused_by_name(programs):
    _, tmain, loss, _ = programs("mlp")
    with pytest.raises(UnimplementedError, match="audit_winner"):
        tsp.plan_sharding(tmain, 2, loss_name=loss, audit_winner=True)


@pytest.mark.parametrize("sizes,match", [
    ({"fsdp": 2, "tp": 2}, None),
    ({"fsdp": 2, "pipe": 2}, "pipe axis beside"),
    ({"tp": 2, "expert": 2}, "expert axis beside"),
])
def test_a_winner_the_port_cannot_run_is_refused_by_name(programs, sizes,
                                                         match):
    """The planner prices the layout (its ranking stays the JAX
    package's), but stamping a layout the port does not run raises the
    check that refuses it; the program is left as it was and no other
    layout is stamped.  A fsdp x tp winner is stamped: the ZeRO-3 rewrite
    over its fsdp axis and the layout (``tests/test_torch_fsdp_tp.py``
    trains one)."""
    _, tmain, loss, feeds = programs("mlp")
    tmain = tmain.clone()
    cfg = tsp.PlanConfig(MeshLayout(**sizes))
    cfg.est = tma.analyze_memory(tmain, feed_shapes=feeds,
                                 fetch_names=[loss])
    cfg.wire = {"wire_bytes": 0}
    runner_up = tsp.PlanConfig(MeshLayout(data=4))
    runner_up.est = cfg.est
    runner_up.wire = {"wire_bytes": 1 << 40}
    plan = tsp.Plan([cfg, runner_up], 4, None)
    assert plan.winner is cfg
    before = json.dumps([op.type for op in tmain.global_block().ops])
    if match is None:
        layout = tsp.stamp_winning_layout(tmain, plan, min_shard_numel=64)
        assert layout is cfg.layout and tmain._mesh_layout is layout
        assert "fsdp_all_gather" in [op.type for op in
                                     tmain.global_block().ops]
        return
    with pytest.raises(UnimplementedError, match=match):
        tsp.stamp_winning_layout(tmain, plan)
    assert json.dumps([op.type for op in
                       tmain.global_block().ops]) == before
    assert getattr(tmain, "_mesh_layout", None) is None


def test_no_fitting_config_raises_with_the_ranking(programs):
    _, tmain, loss, feeds = programs("mlp")
    plan = tsp.plan_sharding(tmain, 2, loss_name=loss, feed_shapes=feeds,
                             fetch_names=[loss], hbm_budget_gb=1e-9)
    assert plan.winner is None
    with pytest.raises(InvalidArgumentError,
                       match="no sharding configuration fits"):
        tsp.stamp_winning_layout(tmain, plan)
