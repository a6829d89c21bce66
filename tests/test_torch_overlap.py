"""``overlap_grad_sync`` through the port against the JAX package: the
ready-order gradient buckets fired from backward hooks.

* The port's ``insert_grad_sync`` with ``overlap_grad_sync`` writes the
  JAX package's program, op for op and attr for attr, for the fp32, bf16
  and int8 tiers, a cap that splits the buckets and the ``min_buckets``
  re-split.
* BERT-tiny pretraining (dropout 0, both fusion passes, AdamW 0.01 with
  warmup into linear decay and a global-norm clip of 1.0) through
  ``fleet`` on two ranks over gloo (``tests/torch_overlap_runner.py``),
  4 prepared steps a leg from the JAX package's startup parameters: the
  overlapped run equals the same program with ``overlap_lowering`` off
  (every bucket at the tail) and the classic tail-fused program bit for
  bit (a sum of two ranks does not depend on the buckets), and so does
  ``strategy.mesh`` of one data axis; the int8 tier on equals off; the
  hooks fire in ``_ready_rank`` order; the overlapped run is within
  ``tests/test_torch_data_parallel.py``'s fp32 tolerance (1e-5) of the
  JAX fleet with overlap on a 2-device mesh, whose desc it has; ZeRO-1
  is inert (no overlap op, bit for bit); AMP with gradient merge on
  equals off; recompute keeps every bucket at the tail; ZeRO-3 over one
  fsdp axis on equals off (the buckets and the gathers' transposes on
  the same ranks, on groups of their own); the NCCL knobs change
  nothing.
* HSDP data 2 x fsdp 2 on four ranks: on equals off bit for bit while
  the fsdp gathers' transposes run in the autograd thread, and fleet
  over a data x fsdp ``strategy.mesh`` trains the same steps.

Each launch has its own timeout, so a hung collective fails its test."""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import paddle_tpu.fluid as jfluid
from paddle_tpu.distributed.fleet import (
    DistributedStrategy as JStrategy, distributed_optimizer as jdistributed,
    fleet as jfleet, UserDefinedRoleMaker as JRoleMaker)
from paddle_tpu.framework import compiler as jcompiler
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.passes import apply_pass as japply
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch.framework import compiler as tcompiler
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.serialization import (
    program_to_desc as tdesc)
from paddle_tpu_torch.ops.collective_ops import DataParallelGroup, SyncWorker

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_overlap_runner.py")
STEPS = 4
LAUNCH_TIMEOUT_S = 240
TOL = 1e-5            # fp32 losses and parameters vs the JAX fleet


def _cfg():
    cfg = jbert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


# ---------------------------------------------------------------------------
# the rewrite in one process, against the JAX package's
# ---------------------------------------------------------------------------


def _fc_stack(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup):
        h = fl.layers.data("x", shape=[64])
        for _ in range(6):
            h = fl.layers.fc(h, 96, act="relu")
        loss = fl.layers.mean(fl.layers.fc(h, 3))
        fl.optimizer.SGD(0.1).minimize(loss)
    return main


@pytest.mark.parametrize("case", ["fp32", "bf16", "int8", "cap", "resplit"])
def test_insert_grad_sync_overlap_matches_the_jax_package(case):
    """Ready order, the caps, the re-split, the overlap attrs and the
    tiers' attrs and QScale vars: the same desc; the buckets come in
    ready order with their hook positions strictly descending."""
    descs, mains = [], []
    for fl, mod, to_desc in ((jfluid, jcompiler, jdesc),
                             (tfluid, tcompiler, tdesc)):
        tcore.reset_default_programs()
        jun.reset()
        tun.reset()
        main = _fc_stack(fl)
        bs = mod.BuildStrategy()
        bs.fuse_all_reduce_ops = True
        bs.overlap_grad_sync = True
        bs.overlap_bucket_size_in_MB = 0.05 if case == "cap" else 64
        if case == "bf16":
            bs.allreduce_compress_dtype = "bfloat16"
        elif case == "int8":
            bs.allreduce_quant_spec = {"dtype": "int8", "block_size": 128}
        elif case == "resplit":
            bs.overlap_min_buckets = 6
        mod.insert_grad_sync(main, bs, 2, ("dp",), axis_sizes={"dp": 2})
        descs.append(json.dumps(to_desc(main)))
        mains.append(main)
    assert descs[1] == descs[0]
    buckets = [op for op in mains[1].global_block().ops
               if op.attrs.get("_overlap")]
    assert len(buckets) >= 4
    ranks = [op.attrs["_ready_rank"] for op in buckets]
    assert ranks == list(range(len(buckets)))
    assert [op.attrs["_bucket_index"] for op in buckets] == ranks
    hooks = [op.attrs["_overlap_hook_pos"] for op in buckets]
    assert hooks == sorted(set(hooks), reverse=True)


def test_a_failed_bucket_raises_at_its_wait():
    """A failure on the communication worker's thread is kept and raised
    where the bucket is waited for, and the worker goes on."""
    worker = SyncWorker(DataParallelGroup(0, 1, "gloo"), "cpu")

    def fail():
        raise ValueError("peer lost")

    bad = worker.submit(fail)
    good = worker.submit(lambda: 7)
    with pytest.raises(ValueError, match="peer lost"):
        bad.result(timeout=60)
    assert good.result(timeout=60) == 7


# ---------------------------------------------------------------------------
# two ranks over gloo
# ---------------------------------------------------------------------------


def _jax_run():
    """The JAX package's fleet with overlap_grad_sync on a 2-device mesh:
    its startup state, the batches, the losses and the parameters after
    STEPS steps."""
    rng = np.random.RandomState(0)
    batches = [jbert.make_fake_batch(rng, _cfg(), batch_size=4,
                                     seq_len=128, num_masks=5)
               for _ in range(STEPS)]
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 7
    with jfluid.program_guard(main, startup):
        _, total, _, _ = jbert.build_pretrain_network(_cfg())
        jfleet.init(JRoleMaker(0, 1))
        s = JStrategy()
        s.mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
        s.overlap_grad_sync = True
        s.overlap_configs = {"bucket_mb": 4, "min_buckets": 4}
        lr = jfluid.layers.linear_lr_warmup(
            jfluid.layers.polynomial_decay(1e-3, 10, 0.0, power=1.0), 2,
            0.0, 1e-3)
        jdistributed(jfluid.optimizer.AdamW(
            lr, weight_decay=0.01,
            grad_clip=jfluid.clip.GradientClipByGlobalNorm(1.0)),
            s).minimize(total)
    japply(main, "fuse_add_layernorm", fetch_names=[total.name])
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        init = {n: np.asarray(scope.find_var(n)) for n in scope.var_names()
                if scope.find_var(n) is not None}
        losses = [float(np.asarray(exe.run(jfleet.main_program, feed=b,
                                           fetch_list=[total])[0]))
                  for b in batches]
        params = {p.name: np.asarray(scope.find_var(p.name))
                  for p in main.all_parameters()}
    return {"batches": batches, "init": init, "losses": losses,
            "params": params, "desc": json.dumps(jdesc(main))}


def launch(tmp, nproc, mode, inputs):
    """Run the rank program on ``nproc`` gloo ranks; returns each rank's
    saved arrays.  The ranks run one intra-op thread: with two, on a
    loaded machine, the first ``torch.exp`` of a process sometimes
    computes the second thread's half of its elements to only ~1e-4
    relative, so the first leg's attention came out apart from a later
    leg's on the same inputs, and the legs are compared bit for bit."""
    out_dir = tmp / "out"
    out_dir.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, mode, str(inputs),
           str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S + 60,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(nproc)]


@pytest.fixture(scope="module")
def ref():
    return _jax_run()


def _inputs(tmp, ref):
    arrays = {f"p/{n}": a for n, a in ref["init"].items()}
    for i, b in enumerate(ref["batches"]):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    np.savez(tmp / "in.npz", **arrays)
    return tmp / "in.npz"


@pytest.fixture(scope="module")
def legs(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap-legs")
    return launch(tmp, 2, "legs", _inputs(tmp, ref))


@pytest.fixture(scope="module")
def hsdp(ref, tmp_path_factory):
    tmp = tmp_path_factory.mktemp("overlap-hsdp")
    return launch(tmp, 4, "hsdp", _inputs(tmp, ref))


def _params(out, leg):
    head = f"{leg}/p/"
    return {k[len(head):]: v for k, v in out.items() if k.startswith(head)}


def _bit_for_bit(ranks, a, b):
    for r, out in enumerate(ranks):
        assert np.array_equal(out[f"{a}/losses"], out[f"{b}/losses"]), \
            (r, a, b)
        pa, pb = _params(out, a), _params(out, b)
        assert pa and pa.keys() == pb.keys()
        for n in pa:
            assert np.array_equal(pa[n], pb[n]), (r, a, b, n)


def _replicas_agree(ranks, leg):
    for out in ranks[1:]:
        assert np.array_equal(out[f"{leg}/losses"],
                              ranks[0][f"{leg}/losses"]), leg
        for n, a in _params(out, leg).items():
            assert np.array_equal(a, _params(ranks[0], leg)[n]), (leg, n)


@pytest.mark.parametrize("other", ["off", "classic", "mesh_on"])
def test_overlap_equals_lowering_off_and_the_classic_program(legs, other):
    _bit_for_bit(legs, "on", other)
    _replicas_agree(legs, "on")
    assert not int(legs[0]["on/fallbacks"])


def test_int8_overlap_on_equals_off(legs):
    _bit_for_bit(legs, "int8_on", "int8_off")
    _replicas_agree(legs, "int8_on")
    ops = list(legs[0]["int8_on/ops"])
    assert ops.count("c_fused_quant_allreduce_sum") >= 4
    assert not int(legs[0]["int8_on/fallbacks"])


def test_overlap_trains_like_the_jax_fleet(legs, ref):
    """Within the fp32 data-parallel tolerance of the JAX fleet with
    overlap on a 2-device mesh, and the same program desc."""
    for r, out in enumerate(legs):
        np.testing.assert_allclose(out["on/losses"], ref["losses"], rtol=0,
                                   atol=TOL, err_msg=f"rank {r}")
        got = _params(out, "on")
        assert got.keys() == ref["params"].keys()
        for n, want in ref["params"].items():
            np.testing.assert_allclose(got[n], want, rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {n}")
    assert str(legs[0]["on/desc"]) == ref["desc"]


@pytest.mark.parametrize("leg", ["on", "int8_on", "mesh_on", "amp_gm_on"])
def test_hooks_fire_in_ready_order(legs, leg):
    """Every bucket hooked, hooks placed in reverse ready order in the
    forward, fired in ready order by the backward, none left at the
    tail; with overlap_lowering off the same buckets all run at the
    tail."""
    out = legs[0]
    n = int(out[f"{leg}/hooked"].size)
    assert n >= 4
    assert list(out[f"{leg}/hooked"]) == list(range(n))[::-1]
    assert list(out[f"{leg}/fired"]) == list(range(n))
    assert int(out[f"{leg}/tail"]) == 0
    assert np.isfinite(float(out[f"{leg}/exposed_ms"]))
    off = leg.replace("_on", "_off") if leg != "on" else "off"
    if f"{off}/tail" in out:
        assert out[f"{off}/hooked"].size == 0
        assert int(out[f"{off}/tail"]) == n


def test_zero1_is_inert(legs):
    """ZeRO-1 syncs its gradients with its own scatter: overlap_grad_sync
    adds no overlap op and changes nothing."""
    _bit_for_bit(legs, "zero1", "zero1_on")
    desc = json.loads(str(legs[0]["zero1_on/desc"]))
    assert not [op for b in desc["blocks"] for op in b["ops"]
                if op["attrs"].get("_overlap")]
    assert "zero1_on/hooked" not in legs[0]


def test_overlap_composes_with_amp_and_gradient_merge(legs):
    _bit_for_bit(legs, "amp_gm_on", "amp_gm_off")
    ops = list(legs[0]["amp_gm_on/ops"])
    assert "cast" in ops and "conditional_block" in ops


def test_recompute_keeps_tail_placement(legs):
    out = legs[0]
    assert out["recompute_on/hooked"].size == 0
    assert int(out["recompute_on/tail"]) == int(out["on/hooked"].size)
    desc = json.loads(str(out["recompute_on/desc"]))
    assert [op for b in desc["blocks"] for op in b["ops"]
            if op["type"] == "backward" and op["attrs"].get("checkpoints")]
    _bit_for_bit(legs, "recompute_on", "on")


def test_zero3_overlap_on_equals_off(legs):
    """ZeRO-3 over one fsdp axis: the replicated parameters' buckets are
    hooked on the worker's own group while the gathers' transposes run on
    the run's group over the same ranks: on equals off bit for bit."""
    _bit_for_bit(legs, "zero3_on", "zero3_off")
    out = legs[0]
    hooked = list(out["zero3_on/hooked"])
    n = len(hooked)
    # the fully sharded parameters' buckets have a ready rank but no
    # collective: the hooked ranks skip them
    assert n >= 1 and list(out["zero3_on/fired"]) == sorted(hooked)
    assert int(out["zero3_off/tail"]) == n
    assert "fsdp_all_gather" in list(out["zero3_on/ops"])


def test_the_nccl_knobs_change_nothing(legs):
    """nccl_comm_num=2 and use_hierarchical_allreduce: the program op for
    op and attr for attr, and the steps bit for bit, of the classic one."""
    assert str(legs[0]["nccl/desc"]) == str(legs[0]["classic/desc"])
    _bit_for_bit(legs, "nccl", "classic")


# ---------------------------------------------------------------------------
# HSDP 2 x 2 on four ranks
# ---------------------------------------------------------------------------


def test_hsdp_overlap_on_equals_off(hsdp):
    """The dp-axis buckets are hooked while the fsdp gathers' transposes
    run in the autograd thread on the fsdp lines: on equals off bit for
    bit; the fsdp-stamped parameters' buckets reduce over dp only."""
    _bit_for_bit(hsdp, "on", "off")
    _replicas_agree(hsdp, "on")
    out = hsdp[0]
    n = int(out["on/hooked"].size)
    assert n >= 4 and list(out["on/fired"]) == list(range(n))
    assert int(out["off/tail"]) == n
    desc = json.loads(str(out["on/desc"]))
    axes = {str(op["attrs"]["_axis_name"]) for b in desc["blocks"]
            for op in b["ops"] if op["attrs"].get("_overlap")}
    assert "dp" in axes and "fsdp_all_gather" in list(out["on/ops"])


def test_fleet_takes_a_data_x_fsdp_mesh(hsdp):
    """fleet over strategy.mesh = MeshLayout(data=2, fsdp=2).build_mesh():
    data parallelism over the four ranks through with_mesh, overlapped;
    the same steps as HSDP within 1e-5."""
    _replicas_agree(hsdp, "fleet_mesh")
    out = hsdp[0]
    assert out["fleet_mesh/hooked"].size >= 4
    assert "fsdp_all_gather" not in list(out["fleet_mesh/ops"])
    np.testing.assert_allclose(out["fleet_mesh/losses"], out["on/losses"],
                               rtol=TOL)
    for n, a in _params(out, "on").items():
        np.testing.assert_allclose(_params(out, "fleet_mesh")[n], a,
                                   rtol=TOL, atol=TOL, err_msg=n)


def test_hooked_buckets_need_no_grad_outside_the_loss():
    """The hook is an identity: forward values and cotangents pass
    through unchanged (checked without a process group)."""
    from paddle_tpu_torch.framework.executor import _BucketHook

    class Bucket:
        seen = None

        def fire(self, cots):
            Bucket.seen = [c.clone() for c in cots]

    a = torch.randn(3, requires_grad=True)
    b = torch.randn(2, 2, requires_grad=True)
    ha, hb = _BucketHook.apply(Bucket(), a, b)
    assert torch.equal(ha, a) and torch.equal(hb, b)
    (ha * 2).sum().backward()
    assert torch.equal(a.grad, torch.full((3,), 2.0))
    assert torch.equal(b.grad, torch.zeros(2, 2))
    assert torch.equal(Bucket.seen[0], a.grad)
    assert torch.equal(Bucket.seen[1], torch.zeros(2, 2))
