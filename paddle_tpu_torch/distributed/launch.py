"""Multi-process launcher — the port of paddle_tpu/distributed/launch.py
(ref: python/paddle/distributed/launch.py).

    python -m paddle_tpu_torch.distributed.launch --nproc 2 \\
        [--selected_gpus 0,1] [--backend nccl|gloo] [--timeout SECONDS] \\
        [--master_addr 127.0.0.1] [--master_port PORT] train.py [args ...]

Spawns ``--nproc`` processes of the script, one per rank, each with
``MASTER_ADDR`` / ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``PADDLE_TRAINER_ID``, ``PADDLE_TRAINERS_NUM``, its GPU in
``FLAGS_selected_gpus`` (from ``--selected_gpus``, one id per rank, or one
id for all) and the backend in ``PADDLE_DISTRI_BACKEND`` when
``--backend`` names one.  ``fleet.init`` reads them
(``fleet.TPURoleMaker``).  Several ranks may share one GPU
(``--nproc 4 --selected_gpus 0,0,0,0 --backend gloo``: NCCL refuses two
ranks of a communicator on one device).

The launcher itself hosts the process group's rendezvous store (a
``torch.distributed.TCPStore`` on ``--master_port``, or on a port the OS
picks as it binds) and names it in every rank's
``PADDLE_TPU_LAUNCH_STORE`` (``host:port``, :data:`LAUNCH_STORE_ENV`);
``fleet.init`` joins it as a client when the rank meets at that address
(:func:`client_store`), and meets anywhere else as before (rank 0 hosts).
A port found free and handed to rank 0 to bind later could be taken in
between by another job or by a connection's ephemeral port.

Every rank also gets ``PADDLE_TPU_PS_AUTHKEY``, a fresh secret for the
job unless the environment has one: the key of the host collective
service (``distributed/gloo.py``).

The launcher returns the OR of the ranks' exit codes (a rank killed by a
signal counts as 128 + the signal).  When a rank fails, the others get a
short grace to fail too and are then killed; a rank still running at
``--timeout`` is killed and the launch fails, so a hung collective fails
its caller instead of hanging it.  A SIGTERM to the launcher (a
preemption notice) is forwarded to every rank, and a rank that exits
with :data:`PREEMPTED_EXIT_CODE` (``distributed/preemption.py``: it
checkpointed and stopped) is not a failure: when every rank does, the
launcher exits with that code too, so its caller can relaunch."""

from __future__ import annotations

import argparse
import os
import secrets
import signal
import socket
import subprocess
import sys
import time
from typing import List, Optional, Sequence

#: seconds the other ranks get to exit after one rank fails
FAILURE_GRACE_S = 10.0
#: exit code of a rank that checkpointed on a preemption notice and
#: stopped ("relaunch me")
PREEMPTED_EXIT_CODE = 42


def free_port(host: str = "127.0.0.1") -> int:
    """A port the OS reports free on ``host`` (bound to port 0)."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind((host, 0))
        return s.getsockname()[1]


#: the environment variable naming the store the launcher hosts
#: (``host:port``)
LAUNCH_STORE_ENV = "PADDLE_TPU_LAUNCH_STORE"


def rendezvous_store(host: str, nproc: int, port: int = 0):
    """The TCP store the ranks rendezvous through, hosted by this process
    on ``port`` (0: a port the OS picks while it binds; ``store.port``)."""
    from torch.distributed import TCPStore
    return TCPStore(host, port, nproc, is_master=True,
                    wait_for_workers=False)


def client_store(init_method: Optional[str], world: int, timeout):
    """A client of the store this rank's launcher hosts when
    ``init_method`` (``tcp://host:port``) is its address, else None."""
    addr = os.environ.get(LAUNCH_STORE_ENV)
    if not addr or init_method != f"tcp://{addr}":
        return None
    from torch.distributed import TCPStore
    host, port = addr.rsplit(":", 1)
    return TCPStore(host, int(port), world, is_master=False,
                    timeout=timeout)


def _gpu_ids(selected_gpus, nproc) -> Optional[List[str]]:
    if selected_gpus in (None, ""):
        return None
    ids = [t.strip() for t in str(selected_gpus).split(",") if t.strip()]
    if len(ids) not in (1, nproc):
        raise SystemExit(f"--selected_gpus {selected_gpus!r}: give one GPU "
                         f"id, or one per rank ({nproc})")
    return ids * nproc if len(ids) == 1 else ids


def rank_env(rank: int, nproc: int, master_addr: str, master_port: int,
             gpu: Optional[str] = None, backend: Optional[str] = None,
             base=None):
    """The environment of rank ``rank``."""
    env = dict(os.environ if base is None else base)
    env.update({
        "MASTER_ADDR": master_addr, "MASTER_PORT": str(master_port),
        "RANK": str(rank), "WORLD_SIZE": str(nproc),
        "LOCAL_RANK": str(rank),
        # the reference launcher's names
        "PADDLE_TRAINER_ID": str(rank), "PADDLE_TRAINERS_NUM": str(nproc),
    })
    if gpu is not None:
        env["FLAGS_selected_gpus"] = gpu
    if backend:
        env["PADDLE_DISTRI_BACKEND"] = backend
    return env


def _kill(procs):
    for p in procs:
        if p.poll() is None:
            p.send_signal(signal.SIGKILL)
    for p in procs:
        p.wait()


def launch(script_args: Sequence[str], nproc: int = 1,
           selected_gpus=None, backend: Optional[str] = None,
           timeout: Optional[float] = None,
           master_addr: str = "127.0.0.1",
           master_port: Optional[int] = None) -> int:
    """Run ``python script_args...`` as ``nproc`` ranks; returns the OR
    of their exit codes (non-zero when one failed or was killed)."""
    if not script_args:
        raise SystemExit("usage: python -m paddle_tpu_torch.distributed."
                         "launch [--nproc N] script.py [args...]")
    if nproc < 1:
        raise SystemExit(f"--nproc {nproc}: at least one rank")
    gpus = _gpu_ids(selected_gpus, nproc)
    base = dict(os.environ)
    base.setdefault("PADDLE_TPU_PS_AUTHKEY", secrets.token_hex(32))
    # held until the ranks are done
    store = rendezvous_store(master_addr, nproc, master_port or 0)
    port = store.port
    base[LAUNCH_STORE_ENV] = f"{master_addr}:{port}"
    procs = []

    def forward(signum, frame):
        for p in procs:
            if p.poll() is None:
                p.send_signal(signum)

    ok = (None, 0, PREEMPTED_EXIT_CODE)
    previous = signal.signal(signal.SIGTERM, forward)
    try:
        for rank in range(nproc):
            env = rank_env(rank, nproc, master_addr, port,
                           None if gpus is None else gpus[rank], backend,
                           base)
            procs.append(subprocess.Popen(
                [sys.executable] + list(script_args), env=env))
        deadline = None if not timeout else time.monotonic() + timeout
        timed_out = False
        while True:
            codes = [p.poll() for p in procs]
            if all(c is not None for c in codes):
                break
            now = time.monotonic()
            if any(c not in ok for c in codes):
                grace = now + FAILURE_GRACE_S
                deadline = grace if deadline is None else \
                    min(deadline, grace)
            if deadline is not None and now >= deadline:
                running = [r for r, c in enumerate(codes) if c is None]
                print(f"launch: killing rank(s) {running} "
                      + ("after a rank failed" if any(
                          c not in ok for c in codes)
                         else f"still running after {timeout} s"),
                      file=sys.stderr, flush=True)
                timed_out = all(c in ok for c in codes)
                _kill(procs)
                break
            time.sleep(0.05)
    except BaseException:
        _kill(procs)
        raise
    finally:
        signal.signal(signal.SIGTERM, previous)
    codes = [p.wait() for p in procs]
    if not timed_out and all(c == PREEMPTED_EXIT_CODE for c in codes):
        return PREEMPTED_EXIT_CODE
    rc = 0
    for code in codes:
        rc |= code if code >= 0 else 128 - code
    if timed_out and rc in (0, PREEMPTED_EXIT_CODE):
        rc = 124
    return rc


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m paddle_tpu_torch.distributed.launch",
        description="Run a training script as N data-parallel ranks.")
    ap.add_argument("--nproc", type=int, default=1,
                    help="ranks (processes) to start")
    ap.add_argument("--selected_gpus", default=None,
                    help="GPU ids, one per rank or one for all (0,1)")
    ap.add_argument("--backend", choices=("nccl", "gloo"), default=None,
                    help="torch.distributed backend (default: nccl on a "
                         "GPU, gloo on the CPU)")
    ap.add_argument("--timeout", type=float, default=None,
                    help="seconds before running ranks are killed")
    ap.add_argument("--master_addr", default="127.0.0.1")
    ap.add_argument("--master_port", type=int, default=None)
    ap.add_argument("script")
    ap.add_argument("args", nargs=argparse.REMAINDER)
    a = ap.parse_args(argv)
    return launch([a.script] + list(a.args), a.nproc, a.selected_gpus,
                  a.backend, a.timeout, a.master_addr, a.master_port)


if __name__ == "__main__":
    sys.exit(main())
