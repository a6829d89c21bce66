"""Checkpoint v2 of the PyTorch port (``io.save_checkpoint`` /
``load_checkpoint``) on the CPU, alone and against the JAX package.

* Round trip: every persistable, the TrainStatus and the generator state
  come back; the manifest has the JAX package's keys and a sha256 per
  file; ``rng.npy`` (the JAX key's file) is never written.
* Exact resume: BERT-tiny pretraining with dropout 0.1 and LAMB through
  ``prepare(donate_state=True)``, checkpointed after step 2, resumed in a
  new scope and executor: steps 3-4 bit for bit those of the uninterrupted
  run (losses and every persistable), which holds only if the dropout
  generator's state was saved and restored.  A live prepared step that
  keeps running after ``load_checkpoint`` pulls the restored state.
* ``max_checkpoints`` keeps the newest; a corrupted file makes the loader
  skip to the older valid checkpoint and report it.
* Across the packages (dropout 0): a JAX checkpoint resumed by the port
  continues with the JAX package's own continued losses within 1e-5 (the
  tolerance ``tests/test_torch_training.py`` holds Adam to), the JAX key
  in ``rng.npy`` ignored; a port checkpoint passes the JAX package's
  ``validate_checkpoint_dir`` and loads through its ``load_checkpoint`` to
  the same arrays.
* Sharded saves and ``AsyncCheckpointer`` read back as saved on one
  process; a layout with a tensor or pipeline axis raises
  ``UnimplementedError`` by name, and a layout change with
  ``reshard=False`` the JAX package's ``InvalidArgumentError``."""

import json
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
from paddle_tpu import io as jio
from paddle_tpu.framework import core as jcore
from paddle_tpu.framework import unique_name as jun
from paddle_tpu.models import bert as jbert

from paddle_tpu_torch import fluid as tfluid
from paddle_tpu_torch import io as tio
from paddle_tpu_torch.framework import core as tcore
from paddle_tpu_torch.framework import unique_name as tun
from paddle_tpu_torch.framework.errors import (InvalidArgumentError,
                                               UnimplementedError)
from paddle_tpu_torch.framework.executor import _RNG_VAR
from paddle_tpu_torch.framework.mesh_layout import MeshLayout
from paddle_tpu_torch.models import bert as tbert

TOL = 1e-5
PACKAGES = {"jax": (jfluid, jcore, jun, jbert),
            "port": (tfluid, tcore, tun, tbert)}


@pytest.fixture(autouse=True)
def _fresh_programs():
    yield
    tcore.reset_default_programs()


def _cfg(bert, dropout):
    cfg = bert.BertConfig.tiny()          # hidden 128, 2 heads of 64
    cfg.hidden_dropout_prob = dropout
    cfg.attention_probs_dropout_prob = dropout
    return cfg


def _build(pkg, dropout=0.0, lamb=False):
    fluid, core, un, bert = PACKAGES[pkg]
    un.reset()
    main, startup = core.Program(), core.Program()
    startup.random_seed = main.random_seed = 7
    with core.program_guard(main, startup):
        loss = bert.build_pretrain_network(_cfg(bert, dropout))[1]
        if lamb:
            fluid.optimizer.Lamb(1e-3).minimize(loss)
        else:
            fluid.optimizer.Adam(1e-3).minimize(loss)
    return main, startup, loss


def _feeds(n):
    rng = np.random.RandomState(0)
    return [jbert.make_fake_batch(rng, _cfg(jbert, 0.0), batch_size=2,
                                  seq_len=128, num_masks=5)
            for _ in range(n)]


def _state(scope, main):
    tfluid.sync_prepared_state(scope)
    return {v.name: scope.find_var(v.name).clone() for v in main.list_vars()
            if v.persistable and scope.find_var(v.name) is not None}


def _fresh(main, startup):
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    return scope, exe


def test_round_trip_and_manifest(tmp_path):
    main, startup, loss = _build("port", dropout=0.1)
    scope, exe = _fresh(main, startup)
    exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    want = _state(scope, main)
    gen = scope.find_var(_RNG_VAR)
    d = tio.save_checkpoint(exe, str(tmp_path), tio.TrainStatus(4, 17),
                            main, scope=scope)
    assert d == os.path.join(str(tmp_path), "checkpoint_4")
    files = sorted(os.listdir(d))
    assert files == ["ckpt_manifest.json", "params.npz", "torch_rng.npz",
                     "train_status.json"]
    with open(os.path.join(d, tio.MANIFEST_FILE)) as f:
        manifest = json.load(f)
    assert sorted(manifest) == sorted(jio._manifest_dict(None, {}, {}))
    assert manifest["format_version"] == jio.CKPT_FORMAT_VERSION == 2
    assert sorted(manifest["files"]) == files[1:]
    assert all(h.startswith("sha256:") for h in manifest["files"].values())
    assert tio.validate_checkpoint_dir(d) == (True, "ok")

    scope2, exe2 = _fresh(main, startup)
    st = tio.load_checkpoint(exe2, str(tmp_path), main_program=main,
                             scope=scope2)
    assert st == tio.TrainStatus(4, 17)
    assert st.restored_from == d and st.skipped_checkpoints == []
    for n, t in want.items():
        assert torch.equal(scope2.find_var(n), t), n
    assert torch.equal(scope2.find_var(_RNG_VAR).get_state(),
                       gen.get_state())
    # no checkpoint yet: a cold start
    st = tio.load_checkpoint(exe2, str(tmp_path / "none"), main_program=main,
                             scope=scope2)
    assert st.epoch_no == -1 and st.skipped_checkpoints == []


def _uninterrupted(steps, feeds):
    main, startup, loss = _build("port", dropout=0.1, lamb=True)
    scope, exe = _fresh(main, startup)
    step = exe.prepare(main, fetch_list=[loss], scope=scope,
                       donate_state=True)
    losses = [float(step.run(f)[0]) for f in feeds[:steps]]
    return losses, _state(scope, main)


def test_resume_with_dropout_is_bitwise_the_uninterrupted_run(tmp_path):
    feeds = _feeds(4)
    ref_losses, ref_state = _uninterrupted(4, feeds)
    main, startup, loss = _build("port", dropout=0.1, lamb=True)
    scope, exe = _fresh(main, startup)
    step = exe.prepare(main, fetch_list=[loss], scope=scope,
                       donate_state=True)
    losses = [float(step.run(f)[0]) for f in feeds[:2]]
    tio.save_checkpoint(exe, str(tmp_path), tio.TrainStatus(0, 2), main,
                        scope=scope)
    # the live step runs on; then the checkpoint is loaded under it: its
    # next run must pull the restored state
    live = [float(step.run(f)[0]) for f in feeds[2:]]
    assert live == ref_losses[2:]
    tio.load_checkpoint(exe, str(tmp_path), main_program=main, scope=scope)
    again = [float(step.run(f)[0]) for f in feeds[2:]]
    assert again == ref_losses[2:]
    # a new scope and executor: startup, load, prepare, steps 3-4
    main, startup, loss = _build("port", dropout=0.1, lamb=True)
    scope, exe = _fresh(main, startup)
    st = tio.load_checkpoint(exe, str(tmp_path), main_program=main,
                             scope=scope)
    assert (st.epoch_no, st.step) == (0, 2)
    step = exe.prepare(main, fetch_list=[loss], scope=scope,
                       donate_state=True)
    losses += [float(step.run(f)[0]) for f in feeds[2:]]
    assert losses == ref_losses
    state = _state(scope, main)
    assert state.keys() == ref_state.keys()
    for n in state:
        assert torch.equal(state[n], ref_state[n]), n


def test_resume_without_the_generator_state_draws_other_masks(tmp_path):
    """The check above is not vacuous: with ``torch_rng.npz`` removed (and
    the manifest rewritten) the resumed steps differ."""
    feeds = _feeds(3)
    ref_losses, _ = _uninterrupted(3, feeds)
    main, startup, loss = _build("port", dropout=0.1, lamb=True)
    scope, exe = _fresh(main, startup)
    step = exe.prepare(main, fetch_list=[loss], scope=scope,
                       donate_state=True)
    step.run(feeds[0])
    step.run(feeds[1])
    d = tio.save_checkpoint(exe, str(tmp_path), tio.TrainStatus(0), main,
                            scope=scope)
    os.remove(os.path.join(d, tio.TORCH_RNG_FILE))
    tio._write_manifest(d, main)
    scope, exe = _fresh(main, startup)
    tio.load_checkpoint(exe, str(tmp_path), main_program=main, scope=scope)
    step = exe.prepare(main, fetch_list=[loss], scope=scope,
                       donate_state=True)
    assert float(step.run(feeds[2])[0]) != ref_losses[2]


def test_max_checkpoints_keeps_the_newest(tmp_path):
    main, startup, _ = _build("port")
    scope, exe = _fresh(main, startup)
    for epoch in range(5):
        tio.save_checkpoint(exe, str(tmp_path / "keep3"),
                            tio.TrainStatus(epoch), main, scope=scope)
        tio.save_checkpoint(exe, str(tmp_path / "all"),
                            tio.TrainStatus(epoch), main, scope=scope,
                            remain_all_checkpoint=True)
    assert sorted(os.listdir(tmp_path / "keep3")) == [
        "checkpoint_2", "checkpoint_3", "checkpoint_4"]
    assert len(os.listdir(tmp_path / "all")) == 5
    tio.save_checkpoint(exe, str(tmp_path / "keep3"), tio.TrainStatus(5),
                        main, scope=scope, max_checkpoints=1)
    assert os.listdir(tmp_path / "keep3") == ["checkpoint_5"]


@pytest.mark.parametrize("damage", ["flip-a-byte", "remove-a-file"])
def test_a_corrupted_checkpoint_is_skipped_for_the_older_one(tmp_path,
                                                             damage):
    main, startup, loss = _build("port")
    scope, exe = _fresh(main, startup)
    tio.save_checkpoint(exe, str(tmp_path), tio.TrainStatus(0, 1), main,
                        scope=scope)
    old = _state(scope, main)
    exe.run(main, feed=_feeds(1)[0], fetch_list=[loss], scope=scope)
    newest = tio.save_checkpoint(exe, str(tmp_path), tio.TrainStatus(1, 2),
                                 main, scope=scope)
    path = os.path.join(newest, "params.npz")
    if damage == "flip-a-byte":
        with open(path, "r+b") as f:
            f.seek(200)
            b = f.read(1)
            f.seek(200)
            f.write(bytes([b[0] ^ 0x40]))
        reason = "hash-mismatch:params.npz"
    else:
        os.remove(path)
        reason = "missing:params.npz"
    assert tio.validate_checkpoint_dir(newest) == (False, reason)
    assert jio.validate_checkpoint_dir(newest) == (False, reason)
    scope2, exe2 = _fresh(main, startup)
    st = tio.load_checkpoint(exe2, str(tmp_path), main_program=main,
                             scope=scope2)
    assert (st.epoch_no, st.step) == (0, 1)
    assert st.skipped_checkpoints == [{"dir": newest, "reason": reason}]
    assert st.restored_from == os.path.join(str(tmp_path), "checkpoint_0")
    for n, t in old.items():
        assert torch.equal(scope2.find_var(n), t), n


def _jax_checkpointed_run(path, feeds, split):
    """The JAX package: ``split`` steps, save_checkpoint, then the rest;
    returns the losses of the steps after the checkpoint."""
    main, startup, loss = _build("jax")
    scope = jfluid.Scope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(scope):
        exe.run(startup)
        for f in feeds[:split]:
            exe.run(main, feed=f, fetch_list=[loss])
        jio.save_checkpoint(exe, path, jio.TrainStatus(3, split), main,
                            scope=scope)
        return [float(np.asarray(exe.run(main, feed=f, fetch_list=[loss])[0]))
                for f in feeds[split:]]


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    feeds = _feeds(4)
    jax_after = _jax_checkpointed_run(str(tmp_path), feeds, 2)
    d = os.path.join(str(tmp_path), "checkpoint_3")
    assert "rng.npy" in os.listdir(d)           # the JAX key: ignored
    main, startup, loss = _build("port")
    scope, exe = _fresh(main, startup)
    gen_before = scope.find_var(_RNG_VAR)
    st = tio.load_checkpoint(exe, str(tmp_path), main_program=main,
                             scope=scope)
    assert (st.epoch_no, st.step) == (3, 2) and st.restored_from == d
    assert scope.find_var(_RNG_VAR) is gen_before
    step = exe.prepare(main, fetch_list=[loss], scope=scope,
                       donate_state=True)
    losses = [float(step.run(f)[0]) for f in feeds[2:]]
    np.testing.assert_allclose(losses, jax_after, rtol=0, atol=TOL)


def test_a_port_checkpoint_loads_in_the_jax_package(tmp_path):
    main, startup, loss = _build("port")
    scope, exe = _fresh(main, startup)
    step = exe.prepare(main, fetch_list=[loss], scope=scope,
                       donate_state=True)
    for f in _feeds(2):
        step.run(f)
    d = tio.save_checkpoint(exe, str(tmp_path), tio.TrainStatus(2, 2),
                            main, scope=scope)
    state = _state(scope, main)
    assert "rng.npy" not in os.listdir(d)
    assert jio.validate_checkpoint_dir(d) == (True, "ok")
    jmain, jstart, _ = _build("jax")
    jscope = jfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
        st = jio.load_checkpoint(jexe, str(tmp_path), main_program=jmain,
                                 scope=jscope)
    assert (st.epoch_no, st.step) == (2, 2) and st.restored_from == d
    assert st.skipped_checkpoints == []
    for n, t in state.items():
        np.testing.assert_array_equal(np.asarray(jscope.find_var(n)),
                                      t.numpy(), err_msg=n)


def test_unported_checkpoint_paths_are_refused_by_name(tmp_path):
    """What stays refused: a layout the port does not run (an expert axis
    beside a tensor or pipe axis) given at save or as the checkpoint's
    stamp, a restore across pipe layouts (``UnimplementedError`` naming
    the axis; the tensor axis is ported, ``tests/test_torch_tp_sp_bert.py``,
    and the expert axis beside data and fsdp,
    ``tests/test_torch_moe.py``), and a layout change with
    ``reshard=False`` (the JAX package's ``InvalidArgumentError``).  What
    was refused before and runs now: a sharded checkpoint, a per-process
    sharded save and ``AsyncCheckpointer``, each read back as saved."""
    main, startup, _ = _build("port")
    scope, exe = _fresh(main, startup)
    want = _state(scope, main)
    path = str(tmp_path)
    d = tio.save_checkpoint(exe, path, tio.TrainStatus(0), main, scope=scope,
                            sharded=True, layout=MeshLayout(data=1, tp=1))
    assert sorted(os.listdir(d)) == [
        "ckpt_manifest.json", "shard_data_0.npz", "shard_manifest_0.json",
        "torch_rng.npz", "train_status.json"]
    assert tio.validate_checkpoint_dir(d) == (True, "ok")
    tio.save_persistables_sharded(exe, str(tmp_path / "flat"), main,
                                  scope=scope)
    ck = tio.AsyncCheckpointer(max_checkpoints=2)
    ck.save(exe, str(tmp_path / "async"), tio.TrainStatus(1), main,
            scope=scope)
    ck.wait()
    for src in ("sharded", "flat", "async"):
        scope2, exe2 = _fresh(main, startup)
        for n, t in want.items():
            scope2.set_var(n, torch.zeros_like(t))
        if src == "flat":
            tio.load_persistables_sharded(exe2, str(tmp_path / "flat"), main,
                                          scope=scope2)
        else:
            tio.load_checkpoint(exe2, path if src == "sharded" else
                                str(tmp_path / "async"), main_program=main,
                                scope=scope2)
        for n, t in want.items():
            assert torch.equal(scope2.find_var(n), t), (src, n)
    # refused: an expert axis beside a tensor axis; a pipe layout change
    with pytest.raises(UnimplementedError, match="ep.*not ported"):
        tio.save_checkpoint(exe, path, tio.TrainStatus(0), main, scope=scope,
                            layout=MeshLayout(data=2, expert=2, tp=2))
    with pytest.raises(UnimplementedError, match="pp.*not ported"):
        tio.load_checkpoint(exe, path, main_program=main, scope=scope,
                            dst_layout=MeshLayout(pipe=2))
    man = tio._manifest_dict()
    man["mesh_layout"] = MeshLayout(expert=2, pipe=2).to_desc()
    tio._write_manifest(d, main, manifest=man)
    with pytest.raises(UnimplementedError, match="stamp.*ep"):
        tio.load_checkpoint(exe, path, main_program=main, scope=scope)
    # a layout change with resharding off: the JAX package's error
    man["mesh_layout"] = MeshLayout(data=2).to_desc()
    tio._write_manifest(d, main, manifest=man)
    with pytest.raises(InvalidArgumentError,
                       match="resharding is disabled") as e:
        tio.load_checkpoint(exe, path, main_program=main, scope=scope,
                            dst_layout=MeshLayout(fsdp=2), reshard=False)
    assert "{'dp': 2, 'fsdp': 1, 'tp': 1}" in str(e.value)
