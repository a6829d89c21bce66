"""The port's host collective service (``paddle_tpu_torch.distributed.
gloo``, the GlooWrapper analog), ported from ``tests/test_gloo.py``:
thread-per-rank in one process (the transport is the same across
processes), then real processes over TCP: two children meeting at an
OS-assigned port with a bounded timeout, and ``fleet.barrier_worker``
through the service on two ranks of the port's launcher."""

import os
import subprocess
import sys
import threading

import numpy as np
import pytest

from paddle_tpu_torch.distributed.gloo import (AUTHKEY_ENV, GlooContext,
                                               _combine, _Hub, init_from_env)
from paddle_tpu_torch.distributed.launch import free_port

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 60


def _run_world(world, fn):
    """fn(ctx, rank) on one thread per rank; returns per-rank results."""
    ctxs = [GlooContext(0, world, "127.0.0.1:0", timeout=30.0)]
    ctxs += [GlooContext(r, world, ctxs[0].endpoint, timeout=30.0)
             for r in range(1, world)]
    results, errors = [None] * world, []

    def worker(r):
        try:
            results[r] = fn(ctxs[r], r)
        except Exception as e:   # noqa: BLE001 — reported below
            errors.append((r, e))

    ts = [threading.Thread(target=worker, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(TIMEOUT_S)
    assert not any(t.is_alive() for t in ts), "a rank hung"
    for c in ctxs[1:]:
        c.close()
    ctxs[0].close()
    assert not errors, errors
    return results


def test_gloo_allreduce_and_gather():
    def body(ctx, r):
        s = ctx.all_reduce(np.asarray([float(r + 1)]), op="sum")
        m = ctx.all_reduce(np.asarray(float(r)), op="max")
        lo = ctx.all_reduce(np.asarray(float(r)), op="min")
        g = ctx.all_gather(f"rank{r}")
        return s, m, lo, g

    for s, m, lo, g in _run_world(4, body):
        np.testing.assert_allclose(np.asarray(s), [10.0])
        assert float(np.asarray(m)) == 3.0 and float(np.asarray(lo)) == 0.0
        assert g == ["rank0", "rank1", "rank2", "rank3"]


def test_gloo_broadcast_and_barrier():
    def body(ctx, r):
        ctx.barrier()
        v = ctx.broadcast({"vocab": 123} if r == 1 else None, root=1)
        ctx.barrier()
        return v

    assert all(v == {"vocab": 123} for v in _run_world(3, body))


@pytest.mark.parametrize("vals,want", [
    ([2.0, -3.0, 0.0], 0.0), ([2.0, -3.0, -0.5], 3.0),
    ([-1.0, -2.0, -4.0], -8.0)])
def test_gloo_prod_handles_zeros_and_negatives(vals, want):
    out = _run_world(3, lambda ctx, r: ctx.all_reduce(np.asarray(vals[r]),
                                                      op="prod"))
    assert all(float(np.asarray(v)) == want for v in out)


def test_combine_refuses_an_unknown_op():
    with pytest.raises(ValueError, match="unknown gloo op"):
        _combine("xor", {0: 1, 1: 2}, 0)


def test_a_desynchronised_call_order_is_reported():
    """A rank's second contribution to one collective means its calls
    went out of step: the hub says so instead of mixing them; a peer
    that never arrives times out naming the count."""
    hub = _Hub(2)
    with pytest.raises(TimeoutError, match="1/2 ranks arrived"):
        hub.collective(seq=0, rank=0, op="sum", value=1.0, timeout=0.05)
    with pytest.raises(RuntimeError, match="duplicate contribution"):
        hub.collective(seq=0, rank=0, op="sum", value=1.0, timeout=0.05)


def test_a_non_loopback_hub_needs_the_secret(monkeypatch):
    monkeypatch.delenv(AUTHKEY_ENV, raising=False)
    with pytest.raises(RuntimeError, match=AUTHKEY_ENV):
        GlooContext(0, 2, "0.0.0.0:0")


def test_init_from_env_needs_the_endpoint(monkeypatch):
    monkeypatch.delenv("PADDLE_GLOO_ENDPOINT", raising=False)
    assert init_from_env() is None


_CHILD = r"""
import os, sys, time
import numpy as np
sys.path.insert(0, os.environ["REPO"])
from paddle_tpu_torch.distributed.gloo import GlooContext
rank, world, ep_file = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
if rank == 0:
    # port 0: the OS picks a free port, published by an atomic rename
    ctx = GlooContext(0, world, "127.0.0.1:0", timeout=60.0)
    with open(ep_file + ".tmp", "w") as f:
        f.write(ctx.endpoint)
    os.replace(ep_file + ".tmp", ep_file)
else:
    deadline = time.monotonic() + 60.0
    while not os.path.exists(ep_file):
        if time.monotonic() > deadline:
            raise TimeoutError("rank 0 never published its endpoint")
        time.sleep(0.05)
    with open(ep_file) as f:
        ctx = GlooContext(rank, world, f.read().strip(), timeout=60.0)
s = ctx.all_reduce(np.asarray([rank + 1.0]))
p = ctx.all_reduce(np.asarray([-2.0 if rank else 0.0]), op="prod")
ctx.barrier()          # every rank has its results before the hub stops
print("RESULT", float(np.asarray(s)[0]), float(np.asarray(p)[0]))
ctx.close()
"""


def test_gloo_across_real_processes(tmp_path):
    script = tmp_path / "gloo_child.py"
    script.write_text(_CHILD)
    ep_file = tmp_path / "gloo_endpoint"
    env = dict(os.environ, REPO=REPO)
    env[AUTHKEY_ENV] = os.urandom(16).hex()
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(r), "2", str(ep_file)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for r in range(2)]
    try:
        outs = [p.communicate(timeout=TIMEOUT_S * 2) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, (o, e) in zip(procs, outs):
        assert p.returncode == 0, (o, e)
        assert "RESULT 3.0 -0.0" in o or "RESULT 3.0 0.0" in o, (o, e)


_BARRIER = r"""
import os, sys
sys.path.insert(0, os.environ["REPO"])
from paddle_tpu_torch import fluid
from paddle_tpu_torch.distributed import fleet
from paddle_tpu_torch.distributed.fleet import PaddleCloudRoleMaker
fleet.init(PaddleCloudRoleMaker(place=fluid.CPUPlace()))
fleet.barrier_worker()
g = fleet._gloo
total = g.all_reduce([fleet.worker_index() + 1.0])
g.barrier()
os.write(1, f"RESULT {fleet.worker_index()} {float(total[0])}\n".encode())
"""


def test_fleet_barrier_worker_meets_through_the_service(tmp_path):
    """With ``PADDLE_GLOO_ENDPOINT`` set, ``fleet._gloo`` is the service
    (the launcher hands every rank the same key) and
    ``barrier_worker`` meets through it."""
    script = tmp_path / "barrier.py"
    script.write_text(_BARRIER)
    env = dict(os.environ, REPO=REPO,
               PADDLE_GLOO_ENDPOINT=f"127.0.0.1:{free_port()}")
    env.pop(AUTHKEY_ENV, None)
    proc = subprocess.run(
        [sys.executable, "-m", "paddle_tpu_torch.distributed.launch",
         "--nproc", "2", "--backend", "gloo", "--timeout", str(TIMEOUT_S),
         str(script)], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=TIMEOUT_S + 30)
    assert proc.returncode == 0, proc.stderr[-3000:]
    lines = sorted(line for line in proc.stdout.splitlines()
                   if line.startswith("RESULT"))
    assert lines == ["RESULT 0 3.0", "RESULT 1 3.0"], proc.stdout
