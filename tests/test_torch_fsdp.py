"""ZeRO-3's program rewrite (``paddle_tpu_torch/framework/fsdp.py``)
against the JAX package's (``paddle_tpu/framework/fsdp.py``) on the same
programs: the report (shard dims, windows, issue positions, byte counts,
the skip census), the ``@fsdp_full`` renames, the ``fsdp_all_gather`` ops
and their attrs, and the stamped ``dist_attr`` of parameters, gradients
and accumulators — the whole program desc, equal.  Also the port's copy
of the liveness pass against the JAX package's on the same block."""

import json

import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.fsdp import apply_fsdp_sharding as japply
from paddle_tpu.framework.memory_analysis import (
    block_liveness as jliveness)
from paddle_tpu.framework.mesh_layout import MeshLayout as JLayout
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.fsdp import (GATHER_SUFFIX,
                                             apply_fsdp_sharding as tapply)
from paddle_tpu_torch.framework.liveness import block_liveness as tliveness
from paddle_tpu_torch.framework.mesh_layout import MeshLayout as TLayout
from paddle_tpu_torch.framework.serialization import (
    program_to_desc as tdesc)
from paddle_tpu_torch.models import bert as tbert

PKGS = {"jax": (jfluid, jun, jbert, japply, JLayout, jdesc),
        "port": (tfluid, tun, tbert, tapply, TLayout, tdesc)}


def _bert(pkg, opt="adamw"):
    """BERT-tiny pretraining, minimized, in ``pkg``."""
    fluid, un, bert, *_ = PKGS[pkg]
    un.reset()
    if pkg == "port":
        tcore.reset_default_programs()
    cfg = bert.BertConfig.tiny()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        _, total, _, _ = bert.build_pretrain_network(cfg)
        inner = {"adamw": lambda: fluid.optimizer.AdamW(1e-3,
                                                        weight_decay=0.01),
                 "momentum": lambda: fluid.optimizer.Momentum(0.1, 0.9),
                 "sgd": lambda: fluid.optimizer.SGD(0.1)}[opt]()
        inner.minimize(total)
    return main, startup


def _mlp(pkg):
    """An MLP whose weights exercise every skip reason: a 3 x 5 weight
    (indivisible by 4 on either dim, and small), a 64 x 64 weight, and a
    weight the forward never reads."""
    fluid, un, *_ = PKGS[pkg]
    un.reset()
    if pkg == "port":
        tcore.reset_default_programs()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[64])
        h = fluid.layers.fc(x, 64, act="relu")
        h2 = fluid.layers.fc(h, 3)
        out = fluid.layers.fc(h2, 5)
        loss = fluid.layers.mean(out)
        main.global_block().create_parameter(
            name="unused_w", shape=[64, 64], dtype="float32")
        fluid.optimizer.Adam(0.01).minimize(loss)
    return main, startup


def _both(build, layout_kw, **kw):
    out = {}
    for pkg in ("jax", "port"):
        _, _, _, apply, Layout, to_desc = PKGS[pkg]
        main, startup = build(pkg)
        report = apply(main, Layout(**layout_kw), **kw)
        out[pkg] = (main, report, json.dumps(to_desc(main)),
                    json.dumps(to_desc(startup)))
    return out


@pytest.mark.parametrize("opt", ["adamw", "momentum", "sgd"])
@pytest.mark.parametrize("prefetch", [0, 1, 3])
def test_bert_rewrite_is_the_jax_packages(opt, prefetch):
    res = _both(lambda pkg: _bert(pkg, opt), {"fsdp": 2},
                prefetch_distance=prefetch)
    (jmain, jrep, jd, js), (tmain, trep, td, ts) = res["jax"], res["port"]
    assert json.dumps(trep) == json.dumps(jrep)
    assert td == jd and ts == js
    assert trep["sharded"] and trep["prefetch_distance"] == prefetch
    types = [op.type for op in tmain.global_block().ops]
    assert types.count("fsdp_all_gather") == len(trep["sharded"])
    # the tied word embedding: one gather feeds the lookup and the MLM
    # output projection
    reads = [op for op in tmain.global_block().ops
             if "word_embedding" + GATHER_SUFFIX in op.input_names()]
    assert len(reads) >= 2


@pytest.mark.parametrize("min_numel", [1, 2048, 100000])
@pytest.mark.parametrize("fsdp", [2, 4])
def test_skip_census_is_the_jax_packages(min_numel, fsdp):
    res = _both(_mlp, {"fsdp": fsdp}, min_shard_numel=min_numel)
    (_, jrep, jd, _), (_, trep, td, _) = res["jax"], res["port"]
    assert json.dumps(trep) == json.dumps(jrep)
    assert td == jd
    reasons = {why for _, why in trep["skipped"]}
    if min_numel == 1:
        assert "not-read-in-forward" in reasons
    if min_numel == 100000:
        assert not trep["sharded"]


def test_rewrite_is_idempotent_and_needs_a_backward():
    res = _both(_mlp, {"fsdp": 2})
    for pkg in ("jax", "port"):
        main, report, desc, _ = res[pkg]
        apply, Layout, to_desc = PKGS[pkg][3:]
        again = apply(main, Layout(fsdp=2))
        assert again["sharded"] == [] and json.dumps(to_desc(main)) == desc
        assert apply(main, Layout(fsdp=1)) == {
            "fsdp_axis": "fsdp", "fsdp_degree": 1, "sharded": [],
            "skipped": []}
    errs = []
    for pkg in ("jax", "port"):
        fluid, un, *_ = PKGS[pkg]
        un.reset()
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup):
            fluid.layers.fc(fluid.layers.data("x", shape=[64]), 64)
        with pytest.raises(ValueError) as e:
            PKGS[pkg][3](main, PKGS[pkg][4](fsdp=2))
        errs.append(str(e.value))
    assert errs[0] == errs[1]


@pytest.mark.parametrize("build", ["bert", "mlp"])
def test_liveness_is_the_jax_packages(build):
    make = (lambda pkg: _bert(pkg)) if build == "bert" else _mlp
    tables = []
    for pkg, live in (("jax", jliveness), ("port", tliveness)):
        main, _ = make(pkg)
        table = live(main.global_block())
        tables.append({n: (iv.def_idx, iv.last_use, iv.pinned)
                       for n, iv in table.items()})
    assert tables[0] == tables[1]
