"""Per-rank sharded checkpoints and the layout-changing restore across the
two packages, and ``AsyncCheckpointer``, on the CPU.  The model is a
three-layer MLP (16 -> 32 -> 32 -> 4, no biases) with Adam 5e-3, batches
of 64 rows made with numpy from a seed; the port runs as gloo ranks
(``tests/torch_hsdp_runner.py`` through ``paddle_tpu_torch.distributed.
launch``), the JAX package on the virtual CPU devices.

* A port HSDP checkpoint (``MeshLayout(data=2, fsdp=2)``, every weight
  fsdp-stamped), written after step 3 by four ranks with
  ``save_checkpoint(sharded=True)``: one file a rank, no block written
  twice.  The JAX package restores it onto ``fsdp=4`` and onto
  ``data=2``, and the port's own fresh ranks do too (four and two): the
  state bit for bit the saved one, each port rank reading exactly its
  planned bytes, then steps 4-5 within 1e-5 of the port's uninterrupted
  HSDP run.  The copy ``AsyncCheckpointer`` wrote beside it holds the
  same state.
* A JAX ZeRO-1 ``data=4`` sharded checkpoint (one process, four devices)
  is restored by two port ranks onto ZeRO-1 ``data=2``: the parameters
  and the flat optimizer state bit for bit (the flat state repadded for
  two ranks), then steps 4-5 within 1e-5 of the JAX package's
  uninterrupted run.
* The JAX package's ``AsyncCheckpointer`` tests
  (``tests/test_io_sharded.py``), against the port: the write holds the
  values of the ``save()`` call, and overlapping saves are serialised,
  the newest kept."""

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
from paddle_tpu import io as jio
from paddle_tpu.distributed.fleet import (
    DistributedStrategy as JStrategy, distributed_optimizer as jdistributed,
    fleet as jfleet, UserDefinedRoleMaker as JRoleMaker)
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.framework.fsdp import apply_fsdp_sharding as japply_fsdp
from paddle_tpu.framework.mesh_layout import MeshLayout as JLayout

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import core as tcore

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_hsdp_runner.py")
sys.path.insert(0, os.path.join(REPO, "tests"))
from torch_hsdp_runner import MLP_MIN_SHARD_NUMEL  # noqa: E402

LAUNCH_TIMEOUT_S = 180
SAVE_AT, AFTER = 3, 2
TOL = 1e-5
#: the JAX layouts the port's HSDP checkpoint is restored onto
JAX_LAYOUTS = {"f4": {"fsdp": 4}, "d2": {"data": 2}}


def _model(fl):
    x = fl.layers.data("x", shape=[16])
    label = fl.layers.data("label", shape=[1], dtype="int64")
    h = x
    for name, width, act in (("w1", 32, "relu"), ("w2", 32, "relu"),
                             ("w3", 4, None)):
        h = fl.layers.fc(h, width, act=act,
                         param_attr=fl.ParamAttr(name=name), bias_attr=False)
    return fl.layers.mean(
        fl.layers.softmax_with_cross_entropy(h, label))


def _batches(n):
    out = []
    for step in range(n):
        rng = np.random.RandomState(1000 + step)
        xs = rng.randn(64, 16).astype(np.float32)
        ys = (xs.sum(1) > 0).astype(np.int64).reshape(-1, 1) * 3
        out.append({"x": xs, "label": ys})
    return out


def _jax_mesh_program(sizes):
    """The MLP under the JAX package's ``with_mesh`` for ``sizes``
    (fsdp-stamped weights when the layout has an fsdp axis)."""
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        loss = _model(jfluid)
        jfluid.optimizer.Adam(5e-3).minimize(loss)
    layout = JLayout(**sizes)
    japply_fsdp(main, layout, min_shard_numel=MLP_MIN_SHARD_NUMEL)
    main._mesh_layout = layout
    bs = jfluid.BuildStrategy()
    bs.fuse_all_reduce_ops = True
    prog = jfluid.CompiledProgram(main).with_mesh(
        layout.build_mesh(), loss_name=loss.name,
        batch_axis=layout.batch_axes, build_strategy=bs)
    return main, startup, loss, prog


def _jax_zero1_program(ndev):
    jun.reset()
    main, startup = jfluid.Program(), jfluid.Program()
    with jfluid.program_guard(main, startup):
        loss = _model(jfluid)
        jfleet.init(JRoleMaker(0, 1))
        s = JStrategy()
        s.sharded_update = True
        s.mesh = Mesh(np.array(jax.devices()[:ndev]), ("dp",))
        jdistributed(jfluid.optimizer.Adam(5e-3), s).minimize(loss)
    main._mesh_layout = JLayout(data=ndev)
    return main, startup, loss, jfleet.main_program


def _jax_steps(exe, prog, loss, scope, batches):
    with jfluid.scope_guard(scope):
        return [float(np.asarray(exe.run(prog, feed=b,
                                         fetch_list=[loss])[0]))
                for b in batches]


def launch(tmp, nproc, *args):
    out_dir = tmp / "out"
    out_dir.mkdir(exist_ok=True)
    cmd = [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
           "--nproc", str(nproc), "--backend", "gloo",
           "--timeout", str(LAUNCH_TIMEOUT_S), RUNNER, *args, str(out_dir)]
    proc = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True,
                          timeout=LAUNCH_TIMEOUT_S + 60,
                          env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    return out_dir, [dict(np.load(out_dir / f"rank{r}.npz"))
                     for r in range(nproc)]


def _inputs(path, batches, init=None, save_at=None):
    arrays = {f"p/{n}": a for n, a in (init or {}).items()}
    for i, b in enumerate(batches):
        arrays.update({f"b{i}/{k}": v for k, v in b.items()})
    if save_at is not None:
        arrays["save_at"] = np.array(save_at)
    np.savez(path, **arrays)
    return str(path)


@pytest.fixture(scope="module")
def port_hsdp(tmp_path_factory):
    """The port's HSDP run on four ranks: 5 steps, the sharded checkpoint
    (and the AsyncCheckpointer copy) after step 3."""
    main, startup, _, _ = _jax_mesh_program({"data": 2, "fsdp": 2})
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        jfluid.Executor(jfluid.CPUPlace()).run(startup)
        init = {v.name: np.asarray(scope.find_var(v.name))
                for v in main.list_vars()
                if v.persistable and scope.find_var(v.name) is not None}
    tmp = tmp_path_factory.mktemp("port-hsdp")
    out_dir, ranks = launch(
        tmp, 4, "mlp", "d2f2",
        _inputs(tmp / "in.npz", _batches(SAVE_AT + AFTER), init, SAVE_AT))
    saved = {k[len("saved/"):]: v for k, v in ranks[0].items()
             if k.startswith("saved/")}
    return {"ckpt": str(out_dir / "ckpt"), "async": str(out_dir / "async"),
            "ranks": ranks, "saved": saved, "tmp": tmp}


def test_the_sharded_checkpoint_writes_each_block_once(port_hsdp):
    d = os.path.join(port_hsdp["ckpt"], f"checkpoint_{SAVE_AT}")
    files = sorted(os.listdir(d))
    assert files == ["ckpt_manifest.json"] + [
        f"shard_data_{r}.npz" for r in range(4)] + [
        f"shard_manifest_{r}.json" for r in range(4)] + [
        f"torch_rng_{r}.npz" for r in range(4)] + ["train_status.json"]
    assert jio.validate_checkpoint_dir(d) == (True, "ok")
    seen, payload = set(), 0
    for r in range(4):
        with open(os.path.join(d, f"shard_manifest_{r}.json")) as f:
            man = json.load(f)
        assert man["mesh_layout"] == JLayout(data=2, fsdp=2).to_desc()
        with np.load(os.path.join(d, f"shard_data_{r}.npz")) as data:
            for name, rec in man["vars"].items():
                for e in rec["shards"]:
                    key = (name, json.dumps(e["index"]))
                    assert key not in seen, key
                    seen.add(key)
                    payload += data[e["key"]].nbytes
        # ranks 2 and 3 (dp coordinate 1) hold replicas of ranks 0 and 1
        if r >= 2:
            assert man["vars"] == {}
    assert payload == sum(a.nbytes for a in port_hsdp["saved"].values())


@pytest.mark.parametrize("layout", sorted(JAX_LAYOUTS))
def test_a_port_hsdp_checkpoint_restores_in_the_jax_package(port_hsdp,
                                                            layout):
    main, startup, loss, prog = _jax_mesh_program(JAX_LAYOUTS[layout])
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        st = jio.load_checkpoint(exe, port_hsdp["ckpt"], main_program=main,
                                 scope=scope)
    assert st.epoch_no == SAVE_AT and st.reshard is not None
    assert st.reshard["src_layout"] == {"dp": 2, "fsdp": 2, "tp": 1}
    for n, want in port_hsdp["saved"].items():
        assert np.array_equal(np.asarray(scope.find_var(n)), want), n
    losses = _jax_steps(exe, prog, loss, scope,
                        _batches(SAVE_AT + AFTER)[SAVE_AT:])
    np.testing.assert_allclose(losses,
                               port_hsdp["ranks"][0]["losses"][SAVE_AT:],
                               rtol=0, atol=TOL)


@pytest.mark.parametrize("layout,nproc", [("f4", 4), ("d2", 2)])
def test_the_port_restores_its_hsdp_checkpoint_onto_another_layout(
        port_hsdp, tmp_path, layout, nproc):
    """Fresh port ranks restore the checkpoint onto ``fsdp=4`` (the
    blocks re-cut from 2 parts to 4) or ``data=2`` (every persistable
    whole): the global state bit for bit, each rank reading exactly its
    planned bytes (under fsdp 4 a quarter of each weight and its moments),
    then steps 4-5."""
    _, ranks = launch(tmp_path, nproc, "mlp", layout,
                      _inputs(tmp_path / "in.npz",
                              _batches(SAVE_AT + AFTER)[SAVE_AT:]),
                      port_hsdp["ckpt"])
    saved = port_hsdp["saved"]
    whole = sum(a.nbytes for a in saved.values())
    for r, out in enumerate(ranks):
        assert int(out["epoch"]) == SAVE_AT
        for n, want in saved.items():
            assert np.array_equal(out[f"loaded/{n}"], want), (r, n)
        assert int(out["bytes_read"]) == int(out["planned_bytes"]), r
        if layout == "f4":
            assert int(out["bytes_read"]) < whole / 2
            assert int(out["wire_bytes"]) == 0       # 2 -> 4: a slice
        else:
            assert int(out["bytes_read"]) == whole
            assert int(out["wire_bytes"]) > 0        # a gather
        np.testing.assert_allclose(
            out["losses"], port_hsdp["ranks"][0]["losses"][SAVE_AT:],
            rtol=0, atol=TOL, err_msg=f"rank {r}")


def test_the_async_copy_holds_the_saved_state(port_hsdp):
    d = os.path.join(port_hsdp["async"], f"checkpoint_{SAVE_AT}")
    assert tio.validate_checkpoint_dir(d) == (True, "ok")
    assert not [n for n in os.listdir(port_hsdp["async"])
                if n.startswith(".tmp")]
    arrays = tio._read_sharded_arrays(d)
    assert sorted(arrays) == sorted(port_hsdp["saved"])
    for n, want in port_hsdp["saved"].items():
        assert np.array_equal(arrays[n], want), n
    with open(os.path.join(d, "train_status.json")) as f:
        assert json.load(f)["epoch_no"] == SAVE_AT


def test_a_jax_zero1_checkpoint_restores_on_two_port_ranks(tmp_path):
    exe = jfluid.Executor(jfluid.CPUPlace())
    main, startup, loss, prog = _jax_zero1_program(4)
    scope = jfluid.Scope()
    with jfluid.scope_guard(scope):
        exe.run(startup)
    batches = _batches(SAVE_AT + AFTER)
    _jax_steps(exe, prog, loss, scope, batches[:SAVE_AT])
    with jfluid.scope_guard(scope):
        jio.save_checkpoint(exe, str(tmp_path / "ckpt"),
                            jio.TrainStatus(SAVE_AT), main, sharded=True)
        saved = {v.name: np.asarray(scope.find_var(v.name))
                 for v in main.list_vars() if v.persistable
                 and scope.find_var(v.name) is not None
                 and v.name != "@RNG_STATE@"}
    ref = _jax_steps(exe, prog, loss, scope, batches[SAVE_AT:])
    d = tmp_path / "ckpt" / f"checkpoint_{SAVE_AT}"
    assert any(n.startswith("shard_data_") for n in os.listdir(d))
    flat = jio._read_manifest(str(d))["flat_meta"]
    assert flat and all(rec["n"] == 4 for rec in flat.values())
    _, ranks = launch(tmp_path, 2, "mlp", "zero1d2",
                      _inputs(tmp_path / "in.npz", batches[SAVE_AT:]),
                      str(tmp_path / "ckpt"))
    repadded = 0
    for r, out in enumerate(ranks):
        assert int(out["epoch"]) == SAVE_AT
        assert int(out["bytes_read"]) == int(out["planned_bytes"]), r
        names = {k[len("loaded/"):] for k in out if k.startswith("loaded/")}
        assert names == set(saved)
        for n, want in saved.items():
            got = out[f"loaded/{n}"]
            if n in flat:
                numel = flat[n]["numel"]
                assert np.array_equal(got[:numel], want[:numel]), n
                assert not got[numel:].any(), n
                repadded += got.shape != want.shape
            else:
                assert np.array_equal(got, want), n
        np.testing.assert_allclose(out["losses"], ref, rtol=0, atol=TOL,
                                   err_msg=f"rank {r}")
    assert repadded, "no flat state changed its pad between 4 and 2 ranks"


# ---------------------------------------------------------------------------
# AsyncCheckpointer on one process (tests/test_io_sharded.py:79, :103)
# ---------------------------------------------------------------------------


def _port_program(optimizer=True):
    tcore.reset_default_programs()
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup):
        x = tfluid.layers.data("x", shape=[4])
        loss = tfluid.layers.mean(tfluid.layers.fc(x, 2, bias_attr=False))
        if optimizer:
            tfluid.optimizer.SGD(0.1).minimize(loss)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return main, scope, exe


def test_async_checkpointer_snapshots_at_save_time(tmp_path):
    main, scope, exe = _port_program()
    pname = main.all_parameters()[0].name
    w0 = scope.find_var(pname).clone()
    ck = tio.AsyncCheckpointer()
    ck.save(exe, str(tmp_path), tio.TrainStatus(0, 0), main, scope=scope)
    # written after save() returns: the write must hold the snapshot
    scope.find_var(pname).add_(100.0)
    ck.wait()
    scope.set_var(pname, torch.zeros_like(w0))
    ts = tio.load_checkpoint(exe, str(tmp_path), main_program=main,
                             scope=scope)
    assert ts.epoch_no == 0
    assert torch.equal(scope.find_var(pname), w0)


def test_async_checkpointer_serialises_overlapping_saves(tmp_path):
    main, scope, exe = _port_program(optimizer=False)
    ck = tio.AsyncCheckpointer(max_checkpoints=2)
    for epoch in range(4):
        ck.save(exe, str(tmp_path), tio.TrainStatus(epoch, epoch), main,
                scope=scope)
    ck.wait()
    kept = sorted(n for n in os.listdir(tmp_path)
                  if n.startswith("checkpoint_"))
    assert kept == ["checkpoint_2", "checkpoint_3"]
    ts = tio.load_checkpoint(exe, str(tmp_path), main_program=main,
                             scope=scope)
    assert ts.epoch_no == 3
    # what the JAX package writes, and its loader reads it
    assert sorted(os.listdir(tmp_path / "checkpoint_3")) == [
        "ckpt_manifest.json", "params.npz", "torch_rng.npz",
        "train_status.json"]
    assert jio.validate_checkpoint_dir(str(tmp_path / "checkpoint_3")) == \
        (True, "ok")


def test_a_failed_write_is_raised_on_wait(tmp_path, monkeypatch):
    main, scope, exe = _port_program(optimizer=False)
    ck = tio.AsyncCheckpointer()

    def fail(*a, **k):
        raise OSError("disk gone")

    monkeypatch.setattr(tio, "_npz_bytes", fail)
    monkeypatch.setattr(tio, "flag", lambda name: 0)     # no retries
    ck.save(exe, str(tmp_path), tio.TrainStatus(0), main, scope=scope)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        ck.wait()
    assert not [n for n in os.listdir(tmp_path)
                if n.startswith("checkpoint_")]
    ck.wait()                           # reported once
