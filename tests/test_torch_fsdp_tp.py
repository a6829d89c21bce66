"""fsdp beside tensor and sequence parallelism through the port against the
JAX package: BERT-tiny (2 layers, B4 x S64, dropout 0) built by
``build_pretrain_network_parallel``, rewritten by ``apply_fsdp_sharding``
and compiled ``with_mesh`` over ``MeshLayout(fsdp=2, tp=2)`` (the build
at tp 2) and ``MeshLayout(fsdp=2, extra_axes={"sp": 2})`` (the build at
tp 1, ring attention over sp), the port as four gloo processes on the
CPU in ONE launch (``tests/torch_fsdp_tp_runner.py``), and fsdp beside
two more axes (dp 2 x fsdp 2 x tp 2, dp 2 x fsdp 2 x sp 2, fsdp 2 x
tp 2 x sp 2) as eight gloo processes in a second launch beside it, held
to the JAX
package's ONE-DEVICE run of the same model built with ``tp_degree=1,
seq_axis=None`` from the same global weights (the JAX mesh runs scale tp
gradients and clip by shard-local norms: ROADMAP's Reference caveats).

* 3 SGD steps through ``Executor.run``, 3 SGD steps under a global-norm
  clip that binds and 3 Adam steps through ``prepare(donate_state=True)``:
  losses within ``TOL`` = 1e-5, every parameter within ``TOL`` after SGD
  and within ``TOL_ADAM`` = 1e-4 after Adam (the tolerances of
  ``tests/test_torch_tp_sp_bert.py``; the attention key biases, whose
  exact gradient is 0, are left out of the Adam comparison there too);
  the clip sums its squares once a step over each axis group (fsdp,
  tp); the eight-rank legs' 3 SGD steps within ``TOL`` too;
* the rewritten programs are the JAX package's desc after its own
  ``apply_fsdp_sharding`` and ``insert_grad_sync``, op for op and attr
  for attr (no ranks needed);
* each rank holds exactly its fsdp block or tp block and the rest whole,
  the replicas agree bit for bit, and the static estimate of a rank's
  persistent bytes is what it holds;
* the fsdp 2 x tp 2 save writes each block once, and its restores onto
  tp 2 x sp 2, data 4 and fsdp 4 are bit for bit, by the JAX package's
  ``plan_reshard`` (steps by kind, wire bytes), each rank reading the
  bytes the plan gives it; one more step on each restored layout lands
  within ``TOL`` of the source's;
* fleet's ``auto_shard`` with a budget whose JAX-planner winner is
  fsdp 2 x tp 2 stamps and trains that layout like the one-device run;
* no rank imports ``jax``.  The launch has its own timeout, so a hung
  collective fails its test and does not stall the suite."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
from paddle_tpu.framework import compiler as jcompiler
from paddle_tpu.framework import shard_planner as jsp
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.fsdp import apply_fsdp_sharding as jfsdp
from paddle_tpu.framework.mesh_layout import MeshLayout as JLayout
from paddle_tpu.framework.reshard import plan_reshard as jplan
from paddle_tpu.framework.serialization import program_to_desc as jdesc
from paddle_tpu.models import bert as jbert

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_fsdp_tp_runner.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_fsdp_tp_runner import (LEGS, LEGS8, OPTS,  # noqa: E402
                                  RESTORES, optimizer)

STEPS = 3
BATCH, SEQ, PER_SHARD = 4, 64, 5
LAUNCH_TIMEOUT_S = 300
TOL = 1e-5          # losses, and parameters after SGD (float32)
TOL_ADAM = 1e-4     # parameters after Adam: a tenth of its LR
ZERO_GRAD = "_attn_k.b_"
SRC = {"fsdp": 2, "tp": 2}


def _cfg():
    cfg = jbert.BertConfig.tiny()
    cfg.hidden_dropout_prob = 0.0
    cfg.attention_probs_dropout_prob = 0.0
    return cfg


def _batch(rng):
    """make_fake_parallel_batch's feeds with PER_SHARD masked tokens in
    each half (sp shard) of every row: the same masked count in every
    batch and sequence shard, so the mean of the shards' weighted means
    is the one-device loss."""
    d = jbert.make_fake_parallel_batch(rng, _cfg(), BATCH, SEQ)
    w = np.zeros((BATCH, SEQ), np.float32)
    half = SEQ // 2
    for i in range(BATCH):
        for h in range(2):
            w[i, h * half + rng.choice(half, PER_SHARD,
                                       replace=False)] = 1.0
    d["lm_weights"] = w
    return d


def _jax_program(opt, tp=1, seq_axis=None, layout=None):
    """The JAX package's program; with ``layout``, after its
    ``apply_fsdp_sharding`` over it."""
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    startup.random_seed = 3
    with jfluid.program_guard(main, startup):
        feeds, loss = jbert.build_pretrain_network_parallel(
            _cfg(), tp_degree=tp, seq_axis=seq_axis)
        optimizer(jfluid, opt).minimize(loss)
    if layout is not None:
        jfsdp(main, layout)
    return main, startup, loss, feeds


def _winner_budget():
    """A budget (GB) under which the JAX planner's winner for the Adam
    program built at tp 2 on four devices (``max_tp`` 2) is fsdp 2 x tp 2:
    halfway between its peak and the next larger one."""
    main, _, loss, feeds = _jax_program("adam", tp=2)
    shapes = {f.name: ((BATCH, SEQ), "float32" if f.name in (
        "kv_mask", "lm_weights") else "int64") for f in feeds}
    free = jsp.plan_sharding(main, 4, loss_name=loss.name,
                             feed_shapes=shapes, fetch_names=[loss.name],
                             max_tp=2)
    peaks = {json.dumps(c.layout.sizes): c.peak_bytes for c in free.configs}
    mine = peaks[json.dumps({"dp": 1, "fsdp": 2, "tp": 2})]
    above = min(p for p in peaks.values() if p > mine)
    gb = (mine + above) / 2 / float(1 << 30)
    plan = jsp.plan_sharding(main, 4, loss_name=loss.name,
                             feed_shapes=shapes, fetch_names=[loss.name],
                             max_tp=2, hbm_budget_gb=gb)
    return gb, plan


class _Refs:
    pass


@pytest.fixture(scope="module")
def refs(tmp_path_factory):
    """The launches (four ranks and eight) start as soon as their inputs
    are written, and the JAX one-device runs are made beside them."""
    refs = _Refs()
    rng = np.random.RandomState(0)
    refs.batches = [_batch(rng) for _ in range(STEPS)]
    refs.next = _batch(rng)
    main, startup, _, _ = _jax_program("sgd")
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        refs.init = {p.name: np.asarray(scope.find_var(p.name))
                     for p in main.all_parameters()}
    refs.budget_gb, refs.plan = _winner_budget()
    tmp = tmp_path_factory.mktemp("fsdp_tp")
    arrays = {f"p/{n}": a for n, a in refs.init.items()}
    for i, b in enumerate(refs.batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    arrays.update({f"next/{k}": v for k, v in refs.next.items()})
    arrays["budget_gb"] = np.array(refs.budget_gb)
    np.savez(tmp / "in.npz", **arrays)
    procs = {}
    for n in (4, 8):
        (tmp / f"out{n}").mkdir()
        log = open(tmp / f"log{n}.txt", "w")
        cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
               "--nproc", str(n), "--backend", "gloo", "--timeout",
               str(LAUNCH_TIMEOUT_S), RUNNER, str(tmp / "in.npz"),
               str(tmp / f"out{n}")]
        procs[n] = (subprocess.Popen(
            cmd, cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            env=dict(os.environ, OMP_NUM_THREADS="1")), log)
    try:
        refs.runs = {}
        for opt in OPTS:
            main, startup, loss, _ = _jax_program(opt)
            scope = jfluid.Scope()
            exe = jfluid.Executor(jfluid.CPUPlace())
            with jfluid.scope_guard(scope):
                exe.run(startup)
                losses = [float(np.asarray(exe.run(
                    main, feed=b, fetch_list=[loss])[0]).reshape(-1)[0])
                    for b in refs.batches]
                refs.runs[opt] = {"losses": losses, "final": {
                    n: np.asarray(scope.find_var(n)) for n in refs.init}}
        rcs = {n: p.wait(timeout=LAUNCH_TIMEOUT_S + 60)
               for n, (p, _) in procs.items()}
    finally:
        for p, log in procs.values():
            if p.poll() is None:
                p.kill()
            log.close()
    for n, rc in rcs.items():
        assert rc == 0, (tmp / f"log{n}.txt").read_text()[-6000:]
    refs.ranks, refs.ranks8 = (
        [dict(np.load(tmp / f"out{n}" / f"rank{r}.npz")) for r in range(n)]
        for n in (4, 8))
    refs.out_dir = tmp / "out4"
    return refs


@pytest.mark.parametrize("opt", OPTS)
@pytest.mark.parametrize("leg", sorted(LEGS))
def test_the_slice_trains_like_the_one_device_jax_run(refs, leg, opt):
    want = refs.runs[opt]
    tol = TOL_ADAM if opt == "adam" else TOL
    for r, out in enumerate(refs.ranks):
        np.testing.assert_allclose(out[f"{leg}/{opt}/losses"],
                                   want["losses"], rtol=0, atol=TOL,
                                   err_msg=f"rank {r}")
        for n, w in want["final"].items():
            if opt == "adam" and ZERO_GRAD in n:
                continue
            got = out[f"{leg}/{opt}/p/{n}"]
            assert got.shape == w.shape, n
            np.testing.assert_allclose(got, w, rtol=tol, atol=tol,
                                       err_msg=f"rank {r} {n}")
    routes = [str(x) for x in refs.ranks[0][f"{leg}/routes"]]
    assert not [x for x in routes if ":fallback:" in x], routes
    ring = [x for x in routes if x.startswith(
        "fused_attention:ring_flash_attention:hit")]
    assert bool(ring) == ("sp" in leg), routes


@pytest.mark.parametrize("leg", sorted(LEGS8))
def test_fsdp_beside_two_axes_trains_like_the_one_device_jax_run(refs, leg):
    """Eight ranks, fsdp beside two of the data, tensor and sequence axes:
    the losses and the parameters after 3 SGD steps within ``TOL`` of the
    JAX one-device run on every rank (a tp block's gradient reduced over
    the batch and sequence axes, a fsdp block's over the others), no
    fallback, and the ring route under sp."""
    want = refs.runs["sgd"]
    for r, out in enumerate(refs.ranks8):
        np.testing.assert_allclose(out[f"{leg}/sgd/losses"],
                                   want["losses"], rtol=0, atol=TOL,
                                   err_msg=f"rank {r}")
        for n, w in want["final"].items():
            np.testing.assert_allclose(out[f"{leg}/sgd/p/{n}"], w,
                                       rtol=TOL, atol=TOL,
                                       err_msg=f"rank {r} {n}")
    routes = [str(x) for x in refs.ranks8[0][f"{leg}/routes"]]
    assert not [x for x in routes if ":fallback:" in x], routes
    ring = [x for x in routes if x.startswith(
        "fused_attention:ring_flash_attention:hit")]
    assert bool(ring) == ("sp" in leg), routes


@pytest.mark.parametrize("leg", sorted(LEGS))
def test_the_clip_sums_its_squares_once_over_each_axis_group(refs, leg):
    """The clip binds (its run leaves the unclipped one by more than
    ``TOL``) and reads one all-reduce of squares for the fsdp-sharded
    gradients and one for the tp layers' (the build stamps them at any
    tp degree; where the mesh has no tp axis that one is the
    identity)."""
    assert np.abs(np.asarray(refs.runs["clip"]["losses"]) -
                  refs.runs["sgd"]["losses"]).max() > TOL
    for out in refs.ranks:
        assert list(out[f"{leg}/clip/allreduces"]) == ["fsdp", "tp"]
        assert list(out[f"{leg}/sgd/allreduces"]) == []


_DESC_LAYOUTS = {"tp2": (2, None, {"fsdp": 2, "tp": 2}),
                 "tp2sp2": (2, "sp", {"fsdp": 2, "tp": 2,
                                      "extra_axes": {"sp": 2}}),
                 "sp2": (1, "sp", {"fsdp": 2, "extra_axes": {"sp": 2}})}


@pytest.mark.parametrize("fused", [False, True], ids=["leaf", "bucketed"])
@pytest.mark.parametrize("name", sorted(_DESC_LAYOUTS))
def test_the_program_is_the_jax_packages_desc(name, fused):
    """``build_pretrain_network_parallel`` + Adam, ``apply_fsdp_sharding``
    over fsdp 2 beside tp and / or sp, and the gradient sync over the
    batch and sequence axes are the JAX package's desc, op for op and
    attr for attr, dist_attr included: the tp blocks are skipped as
    already sharded and reduce over (fsdp, sp), the fsdp blocks over sp
    only, the small replicated parameters over both."""
    from paddle_tpu_torch import fluid as tfluid
    from paddle_tpu_torch.framework import compiler as tcompiler
    from paddle_tpu_torch.framework import unique_name as tun
    from paddle_tpu_torch.framework.fsdp import apply_fsdp_sharding
    from paddle_tpu_torch.framework.mesh_layout import MeshLayout
    from paddle_tpu_torch.framework.serialization import (
        program_to_desc as tdesc)
    from paddle_tpu_torch.models import bert as tbert
    tp, seq, kw = _DESC_LAYOUTS[name]
    descs, reports = [], []
    for fl, un, model, comp, fsdp, layout, to_desc in (
            (jfluid, jun, jbert, jcompiler, jfsdp, JLayout, jdesc),
            (tfluid, tun, tbert, tcompiler, apply_fsdp_sharding,
             MeshLayout, tdesc)):
        un.reset()
        main, startup = fl.Program(), fl.Program()
        with fl.program_guard(main, startup):
            _, loss = model.build_pretrain_network_parallel(
                _cfg(), tp_degree=tp, seq_axis=seq)
            fl.optimizer.Adam(1e-3).minimize(loss)
        lay = layout(**kw)
        reports.append(fsdp(main, lay))
        bs = fl.BuildStrategy()
        bs.fuse_all_reduce_ops = fused
        axes = ("fsdp",) + ((seq,) if seq else ())
        comp.insert_grad_sync(main, bs, 2 * (2 if seq else 1), axes,
                              axis_sizes=lay.mesh_axes)
        descs.append((json.dumps(to_desc(main)),
                      json.dumps(to_desc(startup))))
    assert descs[0] == descs[1]
    assert reports[0]["sharded"] == reports[1]["sharded"]
    assert [tuple(x) for x in reports[0]["skipped"]] == \
        [tuple(x) for x in reports[1]["skipped"]]
    skipped = dict(reports[1]["skipped"])
    for n in ("word_embedding", "encoder_layer_0_attn_q.w_0"):
        assert skipped[n] == "already-sharded", n
    assert "pos_embedding" in {r["param"] for r in reports[1]["sharded"]}


@pytest.mark.parametrize("leg", sorted(LEGS) + sorted(LEGS8))
def test_each_rank_holds_its_fsdp_or_tp_block(refs, leg):
    """A persistable the JAX package's rewrite stamps is held at its
    block (the rank's fsdp or tp coordinate, row-major over the mesh's
    axes), the rest whole and bit for bit equal across the ranks; the
    static estimate of a rank's persistent bytes is what the rank holds
    of the persistables it prices, and nothing is held outside them."""
    kw, tp, seq = {**LEGS, **LEGS8}[leg]
    opt = "adam" if leg in LEGS else "sgd"
    ranks = refs.ranks if leg in LEGS else refs.ranks8
    layout = JLayout(**kw)
    main, _, _, _ = _jax_program(opt, tp=tp, seq_axis=seq, layout=layout)
    stamped = {v.name: v.dist_attr for v in main.list_vars()
               if v.persistable and getattr(v, "dist_attr", None)}
    over = {a: sorted(n for n, da in stamped.items() if a in
                      [e for e in da if e]) for a in ("fsdp", "tp")}
    assert over["fsdp"] and over["tp"]
    axes = [str(a) for a in ranks[0][f"{leg}/axes"]]
    sizes = [layout.mesh_axes[a] for a in axes]
    assert int(np.prod(sizes)) == len(ranks)
    for r, out in enumerate(ranks):
        coords = dict(zip(axes, [int(c) for c in out[f"{leg}/coords"]]))
        assert coords == dict(zip(axes, np.unravel_index(r, sizes)))
        held_names = {k.split("/", 2)[2] for k in out
                      if k.startswith(f"{leg}/held/")}
        for n in held_names:
            got = out[f"{leg}/held/{n}"]
            whole = out[f"{leg}/{opt}/p/{n}"]
            da = stamped.get(n)
            real = [(d, e) for d, e in enumerate(da or ()) if e
                    and e in coords]
            if not real:
                assert got.shape == whole.shape, n
                np.testing.assert_array_equal(
                    got, ranks[0][f"{leg}/held/{n}"], err_msg=n)
                continue
            (d, a), = real
            np.testing.assert_array_equal(
                got, np.split(whole, layout.mesh_axes[a], axis=d)[coords[a]],
                err_msg=n)
        assert int(out[f"{leg}/est_state"]) == int(out[f"{leg}/held_state"])
        assert json.loads(str(out[f"{leg}/held_other"])) == []


def test_the_sharded_save_writes_each_block_once(refs):
    d = str(refs.out_dir / "ckpt" / f"checkpoint_{STEPS}")
    seen, covered = set(), {}
    for r in range(4):
        with open(os.path.join(d, f"shard_manifest_{r}.json")) as f:
            man = json.load(f)
        assert dict(man["mesh_layout"]["axes"]) == {
            "dp": 1, "fsdp": 2, "tp": 2}
        for name, rec in man["vars"].items():
            for e in rec["shards"]:
                key = (name, json.dumps(e["index"]))
                assert key not in seen, key
                seen.add(key)
                n = np.prod(rec["shape"]) if e["index"] is None else \
                    np.prod([b - a for a, b in e["index"]])
                covered[name] = covered.get(name, 0) + int(n)
        specs = man["shard_specs"]
        assert specs["word_embedding"] == ["tp", None]
        assert specs["pos_embedding"] == ["fsdp", None]
    state = {k[len("fsdp2tp2/adam/p/"):]: v
             for k, v in refs.ranks[0].items()
             if k.startswith("fsdp2tp2/adam/p/")}
    assert covered == {n: a.size for n, a in state.items()}


@pytest.mark.parametrize("dst", sorted(RESTORES))
def test_a_restore_onto_another_layout_is_bit_for_bit(refs, dst):
    """The fsdp 2 x tp 2 save restored onto ``dst`` in a fresh program and
    scope: every persistable's global value bit for bit the saved one, the
    plan the JAX package's ``plan_reshard`` for the same layouts, shapes
    and specs, each rank reading the bytes its plan gives it (its rows
    of a var sharded on dim 0 there), and one more Adam step within
    ``TOL`` of the source layout's."""
    kw, tp, seq = RESTORES[dst]
    saved = {k[len("fsdp2tp2/adam/p/"):]: v
             for k, v in refs.ranks[0].items()
             if k.startswith("fsdp2tp2/adam/p/")}
    src_main, _, _, _ = _jax_program("adam", tp=2, layout=JLayout(**SRC))
    dst_layout = JLayout(**kw)
    dst_main, _, _, _ = _jax_program(
        "adam", tp=tp, seq_axis=seq,
        layout=dst_layout if dst_layout.fsdp > 1 else None)

    def specs(m):
        return {v.name: v.dist_attr for v in m.list_vars()
                if v.persistable and getattr(v, "dist_attr", None)}
    want = jplan(JLayout(**SRC), dst_layout,
                 var_sigs={n: (tuple(a.shape), str(a.dtype))
                           for n, a in saved.items()},
                 src_specs=specs(src_main), dst_specs=specs(dst_main))
    total = sum(a.nbytes for a in saved.values())
    for r, out in enumerate(refs.ranks):
        who = f"rank {r} onto {dst}"
        assert int(out[f"r/{dst}/epoch"]) == STEPS, who
        for n, a in saved.items():
            np.testing.assert_array_equal(out[f"r/{dst}/p/{n}"], a,
                                          err_msg=f"{who} {n}")
        assert json.loads(str(out[f"r/{dst}/steps"])) == \
            want.steps_by_kind(), who
        assert int(out[f"r/{dst}/wire"]) == want.wire_bytes, who
        read = int(out[f"r/{dst}/bytes_read"])
        assert read == int(out[f"r/{dst}/planned_bytes"]), who
        if dst == "data4":
            assert read == total, who
        else:
            assert read < total, who
        np.testing.assert_allclose(float(out[f"r/{dst}/next"]),
                                   float(out["r/fsdp2tp2/next"]), rtol=0,
                                   atol=TOL, err_msg=who)


def test_auto_shard_runs_the_jax_planners_fsdp_tp_winner(refs):
    """At the budget where the JAX planner's winner is fsdp 2 x tp 2, the
    port's fleet ``auto_shard`` ranks the layouts as the JAX planner does,
    stamps that winner and trains it like the one-device Adam run."""
    assert refs.plan.winner.layout.sizes == {"dp": 1, "fsdp": 2, "tp": 2}
    want = refs.runs["adam"]
    for r, out in enumerate(refs.ranks):
        assert json.loads(str(out["auto/layout"])) == \
            {"dp": 1, "fsdp": 2, "tp": 2}
        assert json.loads(str(out["auto/ranked"])) == \
            [c.layout.sizes for c in refs.plan.configs]
        np.testing.assert_allclose(out["auto/losses"], want["losses"],
                                   rtol=0, atol=TOL, err_msg=f"rank {r}")
        for n, w in want["final"].items():
            if ZERO_GRAD in n:
                continue
            np.testing.assert_allclose(out[f"auto/p/{n}"], w,
                                       rtol=TOL_ADAM, atol=TOL_ADAM,
                                       err_msg=f"rank {r} {n}")


def test_no_rank_imports_jax(refs):
    for out in refs.ranks + refs.ranks8:
        assert list(out["jax_imported"]) == []


@pytest.mark.parametrize("axes", [
    (("dp", "fsdp", "tp"), (2, 2, 2)), (("fsdp", "sp"), (2, 2)),
    (("fsdp", "tp", "sp"), (2, 2, 2))],
    ids=["dp_fsdp_tp", "fsdp_sp", "fsdp_tp_sp"])
def test_fleet_takes_a_mesh_of_fsdp_beside_tp_or_sp(axes):
    """``strategy.mesh`` over fsdp beside tp or sp passes fleet's check,
    its batch splits over dp and fsdp, and a fed [B, S] array's dim 1
    over sp; the layout's ProcessMesh lays the axes out row-major."""
    import importlib
    tfleet_mod = importlib.import_module(
        "paddle_tpu_torch.distributed.fleet")
    from paddle_tpu_torch.framework.mesh_layout import (MeshLayout,
                                                        ProcessMesh)
    names, sizes = axes
    mesh = ProcessMesh(names, sizes)
    s = tfleet_mod.DistributedStrategy()
    s.mesh = mesh
    tfleet_mod._refuse_unported(s)
    batch = tuple(a for a in names if a in ("dp", "fsdp"))
    assert tfleet_mod._batch_axes(mesh) == (batch if len(batch) > 1
                                            else batch[0])
    kw = dict(zip(names, sizes))
    layout = MeshLayout(data=kw.get("dp", 1), fsdp=kw.get("fsdp", 1),
                        tp=kw.get("tp", 1),
                        extra_axes={"sp": kw["sp"]} if "sp" in kw else None)
    layout.check_ported()
    with pytest.raises(ValueError, match=f"needs {layout.num_devices} "):
        layout.build_mesh()
    last = mesh.rank_of({a: n - 1 for a, n in zip(names, sizes)})
    assert last == mesh.size - 1
    assert mesh.coords(1) == {a: int(a == names[-1]) for a in names}


def test_fleet_refuses_data_fsdp_tp_and_sp_at_once():
    """No run has trained the four axes at once: fleet's ``strategy.mesh``
    and the layout refuse them by name."""
    import importlib
    tfleet_mod = importlib.import_module(
        "paddle_tpu_torch.distributed.fleet")
    from paddle_tpu_torch.framework.errors import UnimplementedError
    from paddle_tpu_torch.framework.mesh_layout import (MeshLayout,
                                                        ProcessMesh)
    s = tfleet_mod.DistributedStrategy()
    s.mesh = ProcessMesh(("dp", "fsdp", "tp", "sp"), (2, 2, 2, 2))
    with pytest.raises(UnimplementedError, match="at once is not ported"):
        tfleet_mod._refuse_unported(s)
    with pytest.raises(UnimplementedError, match="at once is not ported"):
        MeshLayout(data=2, fsdp=2, tp=2,
                   extra_axes={"sp": 2}).check_ported()
