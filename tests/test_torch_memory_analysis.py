"""The port's static pricing layer (``framework/memory_analysis.py``,
``observability/flops.py``, the ``wire`` / ``mem`` channels of
``ops/op_specs.py``) against the JAX package's on the same programs.

Each program is built by the JAX builders and crosses into the port as
the versioned desc (``framework/serialization.py``): the MLP of
``tests/test_shard_planner.py``; BERT-tiny pretraining plain (AdamW, a
global-norm clip), fused (``fuse_add_layernorm`` +
``fuse_elemwise_add_act``), with dp 2 gradient sync, at fsdp 2 and at tp 2;
BERT-tiny at pp 2; MoE BERT-tiny at expert 2.  Both packages get the same
feed shapes, the same peak FLOP/s and the same link figure.

* ``analyze_memory`` (every field, the top live tensors included),
  ``lint_memory``, ``collective_wire_summary``, ``exposed_comm_model`` and
  ``estimate_step_flops`` equal the JAX functions' — bytes exactly, floats
  to 1e-12 relative — with int64 priced at the JAX package's 4 bytes
  (``registry.DTYPE_BYTES``).  The port prices int64 at the 8 bytes the
  card holds: the difference is stated variable by variable;
* ZeRO-3 rewritten by the port under a global-norm clip adds its
  ``c_global_norm_allreduce``: the wire summary and the peak differ from
  the JAX package's by exactly that op's bytes;
* ``plan_remat``'s checkpoints, ``plan_cache_pool``'s pool on the paged
  decoder's probe program, and the ``hbm_budget_gb`` gate, which raises
  before anything runs."""

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import memory_analysis as jma
from paddle_tpu.framework import pipe as jpipe
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.compiler import BuildStrategy as JBuild
from paddle_tpu.framework.compiler import insert_grad_sync as jsync
from paddle_tpu.framework.fsdp import apply_fsdp_sharding as jfsdp
from paddle_tpu.framework.mesh_layout import MeshLayout as JLayout
from paddle_tpu.framework.passes import apply_pass as japply
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert
from paddle_tpu.observability import flops as jflops
from paddle_tpu.parallel import apply_expert_sharding as jexpert

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import flags as tflags
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import memory_analysis as tma
from paddle_tpu_torch.framework import pipe as tpipe
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.compiler import BuildStrategy as TBuild
from paddle_tpu_torch.framework.compiler import insert_grad_sync as tsync
from paddle_tpu_torch.framework.errors import InvalidArgumentError
from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding as tfsdp
from paddle_tpu_torch.framework.mesh_layout import MeshLayout as TLayout
from paddle_tpu_torch.framework.serialization import desc_to_program
from paddle_tpu_torch.observability import flops as tflops
from paddle_tpu_torch.ops import cuda as port_cuda
from paddle_tpu_torch.ops import registry

PEAK = 989e12           # the figures both packages are given
LINK = 0.75
B, S, MASKS = 4, 32, 5


@pytest.fixture
def jax_int64(monkeypatch):
    """int64 priced at the JAX package's width (its x64 is off)."""
    monkeypatch.setitem(registry.DTYPE_BYTES, "int64", 4)


def _cross(jmain):
    return desc_to_program(jdesc(jmain))


def _bert_feeds(cfg=None, batch=B, seq=S):
    return {"src_ids": ((batch, seq), "int64"),
            "pos_ids": ((batch, seq), "int64"),
            "sent_ids": ((batch, seq), "int64"),
            "input_mask": ((batch, seq, 1), "float32"),
            "mask_label": ((batch * MASKS, 1), "int64"),
            "mask_pos": ((batch, MASKS), "int64"),
            "labels": ((batch, 1), "int64")}


def _mlp():
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        x = jfluid.layers.data("x", shape=[16])
        label = jfluid.layers.data("label", shape=[1], dtype="int64")
        h = x
        for i, w in enumerate((32, 32)):
            h = jfluid.layers.fc(h, w, act="relu", bias_attr=False,
                                 param_attr=jfluid.ParamAttr(name=f"w{i + 1}"))
        pred = jfluid.layers.fc(h, 4, act="softmax", bias_attr=False,
                                param_attr=jfluid.ParamAttr(name="w3"))
        loss = jfluid.layers.mean(jfluid.layers.cross_entropy(pred, label))
        jfluid.optimizer.Adam(5e-3).minimize(loss)
    feeds = {"x": ((64, 16), "float32"), "label": ((64, 1), "int64")}
    return main, loss, feeds, {}


def _bert(clip=1.0, cfg=None, parallel=False, tp=1):
    jun.reset()
    cfg = cfg or jbert.BertConfig.tiny()
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 7
    with jfluid.program_guard(main, startup):
        if parallel:
            _, total = jbert.build_pretrain_network_parallel(cfg, tp)
        else:
            _, total, _, _ = jbert.build_pretrain_network(cfg)
        jfluid.optimizer.AdamW(
            1e-3, weight_decay=0.01,
            grad_clip=jfluid.clip.GradientClipByGlobalNorm(clip)
            if clip else None).minimize(total)
    return main, total


def _build(name):
    """(JAX program, loss, feed shapes, analysis keywords) of ``name``."""
    if name == "mlp":
        return _mlp()
    feeds = _bert_feeds()
    if name == "bert":
        main, loss = _bert()
        return main, loss, feeds, {}
    if name == "bert_fused":
        main, loss = _bert()
        japply(main, "fuse_add_layernorm", fetch_names=[loss.name])
        japply(main, "fuse_elemwise_add_act", fetch_names=[loss.name])
        return main, loss, feeds, {}
    if name == "bert_dp2":
        main, loss = _bert()
        build = JBuild()
        build.fuse_all_reduce_ops = True
        jsync(main, build, 2, ("dp",), axis_sizes={"dp": 2})
        return main, loss, feeds, {"mesh_axes": {"dp": 2},
                                   "batch_axis": "dp"}
    if name == "bert_fsdp2":
        main, loss = _bert()
        layout = JLayout(fsdp=2)
        jfsdp(main, layout)
        jsync(main, JBuild(), 2, ("fsdp",), axis_sizes={"fsdp": 2})
        return main, loss, feeds, {"mesh_axes": layout.mesh_axes,
                                   "batch_axis": layout.batch_axes}
    if name == "bert_tp2":
        main, loss = _bert(parallel=True, tp=2)
        feeds = {"src_ids": ((B, S), "int64"), "pos_ids": ((B, S), "int64"),
                 "sent_ids": ((B, S), "int64"),
                 "kv_mask": ((B, S), "float32"),
                 "lm_labels": ((B, S), "int64"),
                 "lm_weights": ((B, S), "float32")}
        return main, loss, feeds, {"mesh_axes": {"tp": 2},
                                   "batch_axis": "dp"}
    if name == "bert_pp2":
        main, loss = _bert(clip=None)
        jpipe.apply_pipeline(main, 2, 2, feed_shapes=feeds)
        return main, loss, feeds, {"mesh_axes": {"pp": 2},
                                   "batch_axis": "dp"}
    if name == "moe_ep2":
        cfg = jbert.BertConfig.tiny()
        cfg.moe_experts = 4
        main, loss = _bert(clip=None, cfg=cfg)
        layout = JLayout(expert=2)
        jexpert(main, layout)
        return main, loss, feeds, {"mesh_axes": layout.mesh_axes,
                                   "batch_axis": layout.batch_axes}
    raise KeyError(name)


PROGRAMS = ["mlp", "bert", "bert_fused", "bert_dp2", "bert_fsdp2",
            "bert_tp2", "bert_pp2", "moe_ep2"]


@pytest.fixture(scope="module")
def programs():
    cache = {}

    def get(name):
        if name not in cache:
            jmain, loss, feeds, kw = _build(name)
            cache[name] = (jmain, _cross(jmain), loss.name, feeds, kw)
        return cache[name]
    return get


def _close(a, b, path=""):
    """Equal structures: ints and strings exactly, floats to 1e-12."""
    if isinstance(a, dict):
        assert set(a) == set(b), (path, set(a) ^ set(b))
        for k in a:
            _close(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) or isinstance(b, float):
        assert b == pytest.approx(a, rel=1e-12, abs=0), path
    else:
        assert a == b, (path, a, b)


@pytest.mark.parametrize("name", PROGRAMS)
def test_memory_estimate_is_the_jax_packages(programs, jax_int64, name):
    jmain, tmain, loss, feeds, kw = programs(name)
    for donate in (True, False):
        want = jma.analyze_memory(jmain, feed_shapes=feeds,
                                  fetch_names=[loss], donate_state=donate,
                                  **kw).as_dict()
        got = tma.analyze_memory(tmain, feed_shapes=feeds,
                                 fetch_names=[loss], donate_state=donate,
                                 **kw).as_dict()
        _close(want, got)
    assert want["peak_bytes"] > 0 and want["transient_bytes"] > 0
    if name == "bert_pp2":
        assert any("pipeline 1f1b" in n for n in got["notes"])


@pytest.mark.parametrize("name", PROGRAMS)
def test_wire_flops_and_exposed_comm_are_the_jax_packages(programs,
                                                          jax_int64, name):
    jmain, tmain, loss, feeds, kw = programs(name)
    kw = {k: v for k, v in kw.items()}
    jw = jma.collective_wire_summary(jmain, feed_shapes=feeds,
                                     fetch_names=[loss], **kw)
    tw = tma.collective_wire_summary(tmain, feed_shapes=feeds,
                                     fetch_names=[loss], **kw)
    _close(jw, tw)
    jf = jflops.estimate_step_flops(jmain, feed_shapes=feeds,
                                    fetch_names=[loss])
    tf = tflops.estimate_step_flops(tmain, feed_shapes=feeds,
                                    fetch_names=[loss])
    _close(jf, tf)
    assert tf["total_flops"] > 0
    n = int(np.prod(list((kw.get("mesh_axes") or {"x": 1}).values())))
    for overlap in (False, True):
        je = jma.exposed_comm_model(jw, jf["total_flops"], num_devices=n,
                                    overlap=overlap, ici_gbps=LINK,
                                    peak_flops=PEAK, bubble_frac=0.25)
        te = tma.exposed_comm_model(tw, tf["total_flops"], num_devices=n,
                                    overlap=overlap, link_gbps=LINK,
                                    peak_flops=PEAK, bubble_frac=0.25)
        assert te.pop("link_gbps") == je.pop("ici_gbps") == LINK
        _close(je, te)
    if kw.get("mesh_axes"):
        assert tw["wire_bytes"] > 0 and not tw["unpriced_collectives"]


@pytest.mark.parametrize("name", ["mlp", "bert", "bert_fused", "bert_dp2"])
def test_lints_and_uncovered_census_are_the_jax_packages(programs, name):
    jmain, tmain, loss, feeds, kw = programs(name)
    for fetch in ([loss], [loss, "fc_0.tmp_1"]):
        jr = jma.lint_memory(jmain, fetch_names=fetch)
        tr = tma.lint_memory(tmain, fetch_names=fetch)
        assert [(d.severity, d.code, d.message) for d in tr.diagnostics] \
            == [(d.severity, d.code, d.message) for d in jr.diagnostics]
    assert tma.mem_uncovered_suspects(tmain) == \
        jma.mem_uncovered_suspects(jmain)


def test_the_three_lint_codes_fire_as_in_the_jax_package():
    """A detached update (donation gap), an early activation fetched
    (fetch retention) and a persistable gradient accumulator (doubling)."""
    out = {}
    for pkg, fluid, un, ma in (("jax", jfluid, jun, jma),
                               ("port", tfluid, tun, tma)):
        un.reset()
        if pkg == "port":
            tcore.reset_default_programs()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            x = fluid.layers.data("x", shape=[8])
            h = fluid.layers.fc(x, 8, act="relu")
            loss = fluid.layers.mean(fluid.layers.fc(h, 1))
            fluid.optimizer.SGD(0.1).minimize(loss)
            blk = main.global_block()
            acc = blk.create_var(name="acc", shape=(8, 8),
                                 dtype="float32", persistable=True)
            w = main.all_parameters()[0].name
            blk.append_op(type="sum", inputs={"X": [acc.name, w + "@GRAD"]},
                          outputs={"Out": [acc.name]})
        sgd = [op for op in blk.ops if op.type == "sgd"]
        sgd[-1].outputs["ParamOut"] = ["detached"]
        blk.create_var(name="detached", shape=(8, 1), dtype="float32")
        r = ma.lint_memory(main, fetch_names=[loss.name, h.name])
        out[pkg] = [(d.code, d.message) for d in r.diagnostics]
    assert out["port"] == out["jax"]
    assert {c for c, _ in out["port"]} == {
        tma.DONATION_GAP, tma.FETCH_RETENTION, tma.GRAD_ACCUM_DOUBLING}


def test_int64_is_priced_at_the_cards_width(programs):
    """Unpatched, the port prices every int64 feed at 8 bytes where the
    JAX package prices 4: feed by feed, the feed bytes differ by exactly
    the int64 feeds' JAX bytes; nothing float differs."""
    jmain, tmain, loss, feeds, kw = programs("bert_dp2")
    want = jma.analyze_memory(jmain, feed_shapes=feeds, fetch_names=[loss],
                              **kw)
    got = tma.analyze_memory(tmain, feed_shapes=feeds, fetch_names=[loss],
                             **kw)
    extra = 0
    for n, (shape, dtype) in feeds.items():
        jb = int(np.prod(shape)) * 4 // 2       # split over dp 2
        if dtype == "int64":
            extra += jb
    assert extra > 0
    assert got.feed_bytes - want.feed_bytes == extra
    assert got.param_bytes == want.param_bytes
    assert got.opt_state_bytes == want.opt_state_bytes
    assert tma.sig_bytes(tma._feed_sigs(tmain, feeds, 1)["src_ids"]) == \
        2 * jma.sig_bytes(jma._feed_sigs(jmain, feeds, 1)["src_ids"])


def test_fsdp_clip_adds_exactly_its_allreduce(jax_int64):
    """The plain clipped program rewritten by each package for fsdp 2:
    the port's clip all-reduce is the one difference — its wire row, and
    its 4-byte input and output in the grad-sync zone."""
    jmain, loss = _bert(clip=0.05)
    tmain = _cross(jmain)
    jfsdp(jmain, JLayout(fsdp=2))
    tfsdp(tmain, TLayout(fsdp=2))
    jsync(jmain, JBuild(), 2, ("fsdp",), axis_sizes={"fsdp": 2})
    tsync(tmain, TBuild(), 2, ("fsdp",), axis_sizes={"fsdp": 2})
    kw = dict(feed_shapes=_bert_feeds(), fetch_names=[loss.name],
              mesh_axes={"fsdp": 2}, batch_axis="fsdp")
    jw, tw = (jma.collective_wire_summary(jmain, **kw),
              tma.collective_wire_summary(tmain, **kw))
    row = tw["by_op"].pop("c_global_norm_allreduce")
    assert row == {"count": 1, "wire_bytes": 4, "logical_bytes": 4}
    for k in ("wire_bytes", "logical_bytes", "grad_sync_wire_bytes"):
        tw[k] -= 4
    _close(jw, tw)
    je, te = (jma.analyze_memory(jmain, **kw), tma.analyze_memory(tmain, **kw))
    assert te.grad_bytes - je.grad_bytes == 8
    assert te.peak_bytes - je.peak_bytes == 8
    assert te.wire_bytes - je.wire_bytes == 4


def test_plan_remat_is_the_jax_packages(programs, jax_int64):
    jmain, tmain, loss, feeds, _ = programs("bert")
    est = jma.analyze_memory(jmain, feed_shapes=feeds, fetch_names=[loss])
    for budget in (None, est.peak_gb * 0.9, est.peak_gb * 0.5):
        jp = jpipe.plan_remat(jmain, feed_shapes=feeds, fetch_names=[loss],
                              budget_gb=budget)
        tp = tpipe.plan_remat(tmain, feed_shapes=feeds, fetch_names=[loss],
                              budget_gb=budget)
        _close(jp.as_dict(), tp.as_dict())
    assert tp.checkpoints and tp.flops_delta > 0
    clone = tmain.clone()
    bw = tpipe.apply_remat(clone, tp)
    assert bw.attrs["checkpoints"] == tp.checkpoints
    after = tma.analyze_memory(clone, feed_shapes=feeds, fetch_names=[loss])
    assert after.peak_bytes == tp.est_after.peak_bytes < est.peak_bytes


def test_plan_cache_pool_is_the_jax_packages(jax_int64):
    """The paged decoder's probe program, priced at its largest batch
    bucket's pad feeds: the same fixed bytes, and so the same pool."""
    from paddle_tpu.models.decoder import BertDecoder as JDecoder
    from paddle_tpu.models.bert import BertConfig as JCfg
    cfg = JCfg(vocab_size=512, hidden_size=64, num_hidden_layers=2,
               num_attention_heads=2, intermediate_size=128,
               max_position_embeddings=64)
    model = JDecoder(cfg, seed=3)
    jun.reset()
    probe = model.build(8, 4, 8, 2)
    feed = {"token_ids": ((4,), "int64"), "pos_ids": ((4,), "int64"),
            "slot_ids": ((4, 1), "int32"), "block_table": ((4, 8), "int32"),
            "ctx_len": ((4,), "int32")}
    tdecode = _cross(probe.decode)
    bb = model.cache_block_bytes(4)
    for budget in (None, 0.001, 0.5):
        kw = dict(feed_shapes=feed, fetch_names=probe.fetch_names,
                  cache_vars=probe.cache_vars, block_bytes=bb,
                  budget_gb=budget, min_blocks=8, reserve_blocks=2)
        jp = jma.plan_cache_pool(probe.decode, **kw)
        tp = tma.plan_cache_pool(tdecode, **kw)
        assert {k: v for k, v in tp.items() if k != "estimate"} == \
            {k: v for k, v in jp.items() if k != "estimate"}
    assert tp["blocks"] > 8
    with pytest.raises(InvalidArgumentError, match="decode cache admission"):
        tma.plan_cache_pool(tdecode, feed_shapes=feed,
                            fetch_names=probe.fetch_names,
                            cache_vars=probe.cache_vars, block_bytes=bb,
                            budget_gb=1e-6, min_blocks=8)


@pytest.fixture
def budget_flag():
    old = tflags.get_flags(["hbm_budget_gb"])
    yield lambda v: tflags.set_flags({"hbm_budget_gb": v})
    tflags.set_flags(old)


def test_budget_gate_raises_before_anything_runs(budget_flag):
    """With ``hbm_budget_gb`` below the estimate, ``Executor.run``,
    ``Executor.prepare`` and ``CompiledProgram.with_mesh`` raise
    ``InvalidArgumentError`` naming the budget, with nothing run: no op
    routed, no kernel launched, the scope untouched; above it the same
    calls run."""
    tcore.reset_default_programs()
    tun.reset()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[16])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 8, act="relu"))
        tfluid.optimizer.Adam(1e-3).minimize(loss)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    feed = {"x": np.ones((32, 16), np.float32)}
    est = tma.analyze_memory(main, feed_shapes=feed, fetch_names=[loss.name],
                             donate_state=False)
    before = {n: scope.find_var(n).clone() for n in scope.var_names()
              if hasattr(scope.find_var(n), "clone")}
    registry.reset_route_counts()
    port_cuda.reset_launch_counts()
    budget_flag(est.peak_gb * 0.5)
    with pytest.raises(InvalidArgumentError, match="hbm_budget_gb"):
        exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    with pytest.raises(InvalidArgumentError, match="hbm_budget_gb"):
        exe.prepare(main, fetch_list=[loss], scope=scope, feed=feed,
                    donate_state=True)
    from paddle_tpu_torch.framework.mesh_layout import ProcessMesh
    # with_mesh has no feeds: the declared shapes, -1 read as 1
    declared = tma.analyze_memory(main, fetch_names=[loss.name])
    budget_flag(declared.peak_gb * 0.5)
    with pytest.raises(InvalidArgumentError, match="hbm_budget_gb"):
        tfluid.CompiledProgram(main.clone()).with_mesh(
            ProcessMesh(("dp",), (1,)), loss_name=loss.name)
    assert not registry.route_counts()
    assert not any(port_cuda.launch_counts().values())
    for n, t in before.items():
        assert scope.find_var(n) is t or bool((scope.find_var(n) == t).all())
    budget_flag(est.peak_gb * 2)
    out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
    assert np.isfinite(out[0]).all()


def test_remat_on_reject_fits_the_budget_with_checkpoints(programs,
                                                          budget_flag,
                                                          jax_int64):
    """``flag("remat_on_reject")``: a training program over the budget
    gets the JAX package's recompute checkpoints instead of the refusal,
    when they fit; without the flag it is refused."""
    jmain, tmain, loss, feeds, _ = programs("bert")
    est = tma.analyze_memory(tmain, feed_shapes=feeds, fetch_names=[loss])
    budget = est.peak_gb * 0.9
    plan = tpipe.plan_remat(tmain, feed_shapes=feeds, fetch_names=[loss],
                            budget_gb=budget)
    assert plan.fits
    with pytest.raises(InvalidArgumentError, match="hbm_budget_gb"):
        tma.check_hbm_budget(tmain.clone(), feed_shapes=feeds,
                             fetch_names=[loss], budget_gb=budget)
    old = tflags.get_flags(["remat_on_reject"])
    tflags.set_flags({"remat_on_reject": True})
    try:
        prog = tmain.clone()
        got = tma.check_hbm_budget(prog, feed_shapes=feeds,
                                   fetch_names=[loss], budget_gb=budget)
    finally:
        tflags.set_flags(old)
    bw = next(op for op in prog.global_block().ops if op.type == "backward")
    assert bw.attrs["checkpoints"] == plan.checkpoints
    assert got.peak_gb <= budget and any("remat_on_reject" in n
                                         for n in got.notes)


def test_mesh_axes_of_reads_the_ports_mesh():
    from paddle_tpu_torch.framework.mesh_layout import ProcessMesh
    assert tma.mesh_axes_of(None) == {}
    assert tma.mesh_axes_of(ProcessMesh(("dp", "fsdp"), (2, 4))) == \
        {"dp": 2, "fsdp": 4}
    layout = TLayout(data=2, expert=2)
    assert tma.mesh_axes_of(ProcessMesh(("dp", "ep"), (2, 2))) == \
        {a: n for a, n in layout.mesh_axes.items() if n > 1}
