"""Preemption-safe training through the port, ported from
``tests/test_preemption.py``: kill a run with SIGTERM, resume, and the
model must be bit for bit the uninterrupted run's
(``tests/torch_preemption_runner.py``, a deterministic MLP with Adam).

* One process: SIGTERM mid-run gives a checkpoint and exit 42, and the
  relaunch resumes bit for bit.
* Two ranks of ZeRO-3 (``MeshLayout(fsdp=2)``) with an
  ``AsyncCheckpointer`` saving every step, through
  ``paddle_tpu_torch.distributed.launch``: a SIGTERM to the launcher
  reaches both ranks, which save one sharded checkpoint at the same step
  and exit 42, and the launcher exits 42; a SIGTERM that reaches one rank
  alone stops both at the same step (the MAX agreement); the relaunch
  resumes bit for bit; the checkpoint restored onto one process (the
  shrink drill: resharded from fsdp 2) continues within 1e-6 of the
  uninterrupted run.
* In-process: the handler chains a handler installed before it, SIGINT
  is opt-in, a signal during the restore is deferred, and an in-flight
  async write is drained before the save.

Each launch and process has its own timeout."""

import json
import os
import shutil
import signal
import subprocess
import sys
import time

import numpy as np
import pytest

from paddle_tpu_torch import fluid
from paddle_tpu_torch.distributed.launch import PREEMPTED_EXIT_CODE
from paddle_tpu_torch.distributed.preemption import PreemptionHandler

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNNER = os.path.join(REPO, "tests", "torch_preemption_runner.py")
STEPS = 8
WAIT_AT = 3
TIMEOUT_S = 180


def _start(ckpt, layout, *extra, nproc=None):
    env = dict(os.environ, OMP_NUM_THREADS="1")
    args = [RUNNER, str(ckpt), str(STEPS), layout, *map(str, extra)]
    if nproc is not None:
        args = ["-m", "paddle_tpu_torch.distributed.launch", "--nproc",
                str(nproc), "--backend", "gloo", "--timeout",
                str(TIMEOUT_S)] + args
    return subprocess.Popen([sys.executable] + args, cwd=REPO, env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _results(proc, rc=0):
    try:
        out, err = proc.communicate(timeout=TIMEOUT_S + 30)
    except subprocess.TimeoutExpired:
        proc.kill()
        raise
    assert proc.returncode == rc, (proc.returncode, err[-3000:])
    return sorted((json.loads(line[len("RESULT "):])
                   for line in out.splitlines()
                   if line.startswith("RESULT ")),
                  key=lambda r: r["rank"])


def _signal_after_step(proc, step):
    """Read the markers until ``STEP step``, then SIGTERM ``proc`` (the
    process, or the launcher)."""
    deadline = time.monotonic() + TIMEOUT_S
    while time.monotonic() < deadline:
        line = proc.stdout.readline()
        if not line:
            break
        if line.startswith("STEP ") and int(line.split()[1]) >= step:
            proc.send_signal(signal.SIGTERM)
            return
    proc.kill()
    raise AssertionError(f"never reached step {step}: "
                         f"{proc.stderr.read()[-3000:]}")


def _checkpoints(path):
    return sorted(d for d in os.listdir(path) if d.startswith("checkpoint_"))


def test_sigterm_checkpoint_and_bitexact_resume(tmp_path):
    ref = _results(_start(tmp_path / "ref", "one"))[0]
    assert ref["first_step"] == 0
    p = _start(tmp_path / "pre", "one", WAIT_AT)
    _signal_after_step(p, WAIT_AT)
    _results(p, PREEMPTED_EXIT_CODE)
    assert _checkpoints(tmp_path / "pre") == [f"checkpoint_{WAIT_AT}"]
    res = _results(_start(tmp_path / "pre", "one"))[0]
    assert res["first_step"] == WAIT_AT + 1
    assert res["digest"] == ref["digest"]
    assert res["losses"] == ref["losses"][WAIT_AT + 1:]


@pytest.fixture(scope="module")
def fsdp_ref(tmp_path_factory):
    """The uninterrupted two-rank ZeRO-3 run."""
    tmp = tmp_path_factory.mktemp("preempt-ref")
    return _results(_start(tmp / "ref", "fsdp2", nproc=2))


def test_sigterm_to_the_launcher_stops_both_ranks_at_one_step(
        tmp_path, fsdp_ref):
    """The launcher forwards SIGTERM to both ranks; both save one sharded
    checkpoint at the same step and exit 42; the relaunch resumes bit for
    bit."""
    ckpt = tmp_path / "pre"
    launcher = _start(ckpt, "fsdp2", WAIT_AT, nproc=2)
    _signal_after_step(launcher, WAIT_AT)
    _results(launcher, PREEMPTED_EXIT_CODE)
    assert _checkpoints(ckpt) == [f"checkpoint_{WAIT_AT}"]
    saved = sorted(os.listdir(ckpt / f"checkpoint_{WAIT_AT}"))
    assert "shard_manifest_0.json" in saved and \
        "shard_manifest_1.json" in saved, saved
    resumed = _results(_start(ckpt, "fsdp2", nproc=2))
    for res, ref in zip(resumed, fsdp_ref):
        assert res["first_step"] == WAIT_AT + 1
        assert res["digest"] == ref["digest"]
        assert res["losses"] == ref["losses"][WAIT_AT + 1:]


def test_one_ranks_signal_stops_both_ranks_at_the_same_step(
        tmp_path, fsdp_ref):
    """Rank 1 alone gets the SIGTERM; the MAX agreement in step_done makes
    rank 0 save the same sharded checkpoint at the same step and exit 42
    too, and the relaunch resumes bit for bit."""
    ckpt = tmp_path / "pre"
    _results(_start(ckpt, "fsdp2", WAIT_AT, 1, nproc=2),
             PREEMPTED_EXIT_CODE)
    assert _checkpoints(ckpt) == [f"checkpoint_{WAIT_AT}"]
    shutil.copytree(ckpt, tmp_path / "shrink")
    resumed = _results(_start(ckpt, "fsdp2", nproc=2))
    for res, ref in zip(resumed, fsdp_ref):
        assert res["first_step"] == WAIT_AT + 1
        assert res["digest"] == ref["digest"]
    # the shrink drill: the fsdp 2 checkpoint onto one process, resharded
    res = _results(_start(tmp_path / "shrink", "shrink"))[0]
    assert res["first_step"] == WAIT_AT + 1 and res["resharded"]
    np.testing.assert_allclose(res["losses"],
                               fsdp_ref[0]["losses"][WAIT_AT + 1:],
                               rtol=1e-6, atol=1e-7)


# ---------------------------------------------------------------------------
# the handler in this process
# ---------------------------------------------------------------------------


def _exe():
    return fluid.Executor(fluid.CPUPlace())


def test_handler_chains_a_handler_installed_before(tmp_path):
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
    try:
        handler = PreemptionHandler(_exe(), str(tmp_path), None,
                                    signals=(signal.SIGUSR1,),
                                    exit_on_preempt=False)
        os.kill(os.getpid(), signal.SIGUSR1)
        time.sleep(0.05)
        assert handler.preempted
        assert hits == [signal.SIGUSR1]
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_handler_sigint_is_opt_in(tmp_path):
    prev = signal.getsignal(signal.SIGINT)
    try:
        PreemptionHandler(_exe(), str(tmp_path), None, signals=(),
                          exit_on_preempt=False)
        assert signal.getsignal(signal.SIGINT) is prev
        h2 = PreemptionHandler(_exe(), str(tmp_path), None, signals=(),
                               catch_sigint=True, exit_on_preempt=False)
        assert signal.getsignal(signal.SIGINT) == h2._on_signal
    finally:
        signal.signal(signal.SIGINT, prev)


def test_handler_defers_a_signal_during_restore(tmp_path, monkeypatch):
    """A signal that lands while the checkpoint loads is neither flagged
    nor chained until the restore is done, then replayed."""
    from paddle_tpu_torch import io
    hits = []
    prev = signal.signal(signal.SIGUSR1, lambda s, f: hits.append(s))
    try:
        handler = PreemptionHandler(_exe(), str(tmp_path), None,
                                    signals=(signal.SIGUSR1,),
                                    exit_on_preempt=False)
        seen = {}

        def load(*a, **kw):
            os.kill(os.getpid(), signal.SIGUSR1)
            time.sleep(0.05)
            seen["during"] = (handler.preempted, list(hits))
            return io.TrainStatus(-1)

        monkeypatch.setattr(io, "load_checkpoint", load)
        st = handler.restore()
        assert seen["during"] == (False, [])
        assert handler.preempted and hits == [signal.SIGUSR1]
        assert st.step == -1
    finally:
        signal.signal(signal.SIGUSR1, prev)


def test_handler_drains_an_inflight_async_write_before_the_save(tmp_path,
                                                               monkeypatch):
    order = []

    class Checkpointer:
        def drain(self):
            order.append("drain")
            return True

    handler = PreemptionHandler(_exe(), str(tmp_path), None, signals=(),
                                exit_on_preempt=False,
                                checkpointer=Checkpointer())
    monkeypatch.setattr(handler, "save", lambda step: order.append("save"))
    handler._preempted = True
    assert handler.step_done(7) is True
    assert order == ["drain", "save"]


def test_the_real_async_write_is_joined_by_the_drain(tmp_path):
    """With a real ``AsyncCheckpointer`` write in flight, a preemption at
    the next boundary joins it before its own save: both checkpoints are
    whole."""
    from paddle_tpu_torch import io
    from paddle_tpu_torch.framework import core, unique_name
    core.reset_default_programs()
    unique_name.reset()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup):
        x = fluid.layers.data("x", shape=[4])
        loss = fluid.layers.mean(fluid.layers.fc(x, 2))
        fluid.optimizer.SGD(0.1).minimize(loss)
    scope = fluid.Scope()
    exe = _exe()
    exe.run(startup, scope=scope)
    ck = io.AsyncCheckpointer()
    handler = PreemptionHandler(exe, str(tmp_path / "ck"), main,
                                scope=scope, signals=(),
                                exit_on_preempt=False, checkpointer=ck)
    ck.save(exe, str(tmp_path / "async"), io.TrainStatus(0), main,
            scope=scope)
    handler._preempted = True
    assert handler.step_done(0) is True
    assert not ck.in_flight
    for d in (tmp_path / "async" / "checkpoint_0", tmp_path / "ck" /
              "checkpoint_0"):
        assert io.validate_checkpoint_dir(str(d))[0], d
