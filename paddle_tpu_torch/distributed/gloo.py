"""Host-side collective/barrier service — the port of
paddle_tpu/distributed/gloo.py, the GlooWrapper analog (ref:
framework/fleet/gloo_wrapper.h GlooWrapper: Barrier/AllReduce/AllGather
over a rendezvous, used by role makers to sync trainers before and after
training).

Device collectives ride ``torch.distributed`` and never touch this path;
it is for HOST coordination: barriers between processes and small numpy
reductions (metrics, vocabulary sizes, shard manifests).  The transport
is the port's copy of the parts of the JAX package's
``distributed/ps/rpc.py`` it needs — stdlib ``multiprocessing.connection``
(length-prefixed pickle over TCP behind an HMAC handshake) — in a star:
rank 0 hosts a hub, every rank (rank 0 too) connects as a client, and a
collective call blocks its hub thread until all ``world_size``
contributions of that sequence number arrive.

SPMD contract: all ranks issue the same collectives in the same order
(their sequence counters align), as with gloo.

The payload is pickle, so the handshake's key is the security boundary:
``PADDLE_TPU_PS_AUTHKEY`` (``distributed/launch.py`` sets a fresh one for
each job it starts).  Without it a key made once a process serves ranks
that are threads of one process; a hub on a non-loopback address
requires the variable."""

from __future__ import annotations

import os
import secrets
import threading
import time
from multiprocessing import AuthenticationError
from multiprocessing.connection import Client, Listener
from typing import Any, Callable, Dict, Optional

import numpy as np

from ..framework.errors import ExecutionTimeoutError, UnavailableError

#: the environment variable the connection key comes from
AUTHKEY_ENV = "PADDLE_TPU_PS_AUTHKEY"
_LOOPBACK = ("127.0.0.1", "localhost", "::1")
_PROCESS_KEY = secrets.token_bytes(32)


def _authkey() -> bytes:
    key = os.environ.get(AUTHKEY_ENV)
    return key.encode() if key else _PROCESS_KEY


class _Server:
    """Threaded request server: one thread per connected client."""

    def __init__(self, endpoint: str):
        host, port = endpoint.rsplit(":", 1)
        if host not in _LOOPBACK and not os.environ.get(AUTHKEY_ENV):
            raise RuntimeError(
                f"a hub on the non-loopback address {host!r} requires a "
                f"per-job secret in {AUTHKEY_ENV} (the transport unpickles "
                f"authenticated payloads)")
        self._listener = Listener((host, int(port)), authkey=_authkey())
        self.endpoint = f"{host}:{self._listener.address[1]}"
        self._handlers: Dict[str, Callable] = {}
        self._running = True

    def register(self, method: str, fn: Callable):
        self._handlers[method] = fn

    def start_background(self):
        threading.Thread(target=self._serve, daemon=True,
                         name="gloo hub").start()

    def _serve(self):
        try:
            while self._running:
                try:
                    conn = self._listener.accept()
                except (OSError, EOFError, AuthenticationError):
                    if not self._running:
                        break
                    continue
                threading.Thread(target=self._serve_conn, args=(conn,),
                                 daemon=True).start()
        finally:
            self._listener.close()

    def _serve_conn(self, conn):
        try:
            while True:
                method, payload = conn.recv()
                if method == "__stop__":
                    conn.send(("ok", None))
                    self._running = False
                    try:    # unblock the accept loop
                        Client(self._listener.address,
                               authkey=_authkey()).close()
                    except OSError:
                        pass
                    break
                fn = self._handlers.get(method)
                if fn is None:
                    conn.send(("error", f"no handler for {method!r}"))
                    continue
                try:
                    conn.send(("ok", fn(**payload)))
                except Exception as e:  # noqa: BLE001 — sent to the caller
                    conn.send(("error", f"{type(e).__name__}: {e}"))
        except (EOFError, OSError):
            pass                        # the client went away
        finally:
            conn.close()


class _Client:
    """One connection to a hub, with connect retries and a deadline on
    each reply."""

    def __init__(self, endpoint: str, deadline: float, retries: int = 100,
                 retry_wait: float = 0.1):
        host, port = endpoint.rsplit(":", 1)
        self._addr = (host, int(port))
        self.endpoint = endpoint
        self._deadline = deadline
        self._lock = threading.Lock()
        last = None
        for _ in range(retries):
            try:
                self._conn = Client(self._addr, authkey=_authkey())
                return
            except (OSError, AuthenticationError) as e:
                last = e
                time.sleep(retry_wait)
        raise ConnectionError(
            f"cannot reach the gloo hub at {endpoint}: {last!r} (ranks of "
            f"other processes must share {AUTHKEY_ENV})")

    def call(self, method: str, _timeout: Optional[float] = None,
             **payload) -> Any:
        deadline = self._deadline if _timeout is None else _timeout
        with self._lock:
            try:
                self._conn.send((method, payload))
                if not self._conn.poll(deadline):
                    raise ExecutionTimeoutError(
                        f"gloo hub {self.endpoint} {method}: no reply "
                        f"within {deadline} s")
                status, result = self._conn.recv()
            except (EOFError, OSError) as e:
                raise UnavailableError(
                    f"gloo hub {self.endpoint} {method}: connection lost: "
                    f"{e!r}") from e
        if status != "ok":
            raise RuntimeError(f"gloo hub {self.endpoint} {method}: "
                               f"{result}")
        return result

    def close(self):
        with self._lock:
            self._conn.close()


def _combine(op: str, vals: Dict[int, Any], root: int):
    ordered = [vals[r] for r in sorted(vals)]
    if op == "barrier":
        return None
    if op == "all_gather":
        return ordered
    if op == "broadcast":
        return vals[root]
    arrs = [np.asarray(v) for v in ordered]
    if op == "sum":
        return sum(arrs[1:], arrs[0].copy())
    if op == "max":
        return np.maximum.reduce(arrs)
    if op == "min":
        return np.minimum.reduce(arrs)
    if op == "prod":
        out = arrs[0].copy()
        for a in arrs[1:]:
            out = out * a
        return out
    raise ValueError(f"unknown gloo op {op!r}")


class _Hub:
    """Rendezvous state machine behind the server (rank 0 only)."""

    def __init__(self, world_size: int):
        self._world = world_size
        self._cond = threading.Condition()
        self._pending: Dict[int, dict] = {}

    def collective(self, seq: int, rank: int, op: str, value=None,
                   root: int = 0, timeout: float = 600.0):
        with self._cond:
            e = self._pending.setdefault(
                seq, {"vals": {}, "done": False, "served": 0})
            if rank in e["vals"]:
                raise RuntimeError(
                    f"gloo: duplicate contribution from rank {rank} for "
                    f"collective #{seq} — desynchronised call order")
            e["vals"][rank] = value
            if len(e["vals"]) == self._world:
                e["result"] = _combine(op, e["vals"], root)
                e["done"] = True
                self._cond.notify_all()
            elif not self._cond.wait_for(lambda: e["done"],
                                         timeout=timeout):
                raise TimeoutError(
                    f"gloo collective #{seq} ({op}): only "
                    f"{len(e['vals'])}/{self._world} ranks arrived")
            result = e["result"]
            e["served"] += 1
            if e["served"] == self._world:
                del self._pending[seq]
            return result


class GlooContext:
    """Per-process handle (the reference's GlooWrapper instance); rank 0
    also hosts the hub.  ``endpoint`` is the hub's ``host:port`` on every
    rank (rank 0 may give port 0: :attr:`endpoint` is then the port it
    got)."""

    def __init__(self, rank: int, world_size: int, endpoint: str,
                 timeout: float = 600.0):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self._timeout = timeout
        self._seq = 0
        self._server: Optional[_Server] = None
        if self.rank == 0:
            hub = _Hub(self.world_size)
            self._server = _Server(endpoint)
            self._server.register("collective", hub.collective)
            self._server.start_background()
            endpoint = self._server.endpoint
        self.endpoint = endpoint
        self._client = _Client(endpoint, deadline=timeout)

    def _call(self, op: str, value=None, root: int = 0):
        seq = self._seq
        self._seq += 1
        return self._client.call(
            "collective", _timeout=self._timeout + 30.0, seq=seq,
            rank=self.rank, op=op, value=value, root=root,
            timeout=self._timeout)

    # -- the GlooWrapper surface (ref: gloo_wrapper.h) -------------------
    def barrier(self):
        self._call("barrier")

    def all_reduce(self, value, op: str = "sum"):
        return self._call(op, np.asarray(value))

    def all_gather(self, value):
        return self._call("all_gather", value)

    def broadcast(self, value, root: int = 0):
        return self._call("broadcast", value, root=root)

    def close(self):
        """Close this rank's connection; rank 0 also stops the hub (after
        the others are done with it: end on a barrier)."""
        try:
            if self._server is not None:
                self._client.call("__stop__")
        except (RuntimeError, ExecutionTimeoutError, UnavailableError):
            pass                        # the hub is gone already
        self._client.close()


def init_from_env() -> Optional[GlooContext]:
    """A context from the launcher's environment (``PADDLE_TRAINER_ID``,
    ``PADDLE_TRAINERS_NUM``, ``PADDLE_GLOO_ENDPOINT``: the PaddleCloud
    rendezvous contract, ref: gloo_wrapper usage in role_maker.py), or
    None without ``PADDLE_GLOO_ENDPOINT``."""
    ep = os.environ.get("PADDLE_GLOO_ENDPOINT")
    if not ep:
        return None
    return GlooContext(int(os.environ.get("PADDLE_TRAINER_ID", 0)),
                       int(os.environ.get("PADDLE_TRAINERS_NUM", 1)), ep)


__all__ = ["GlooContext", "init_from_env", "AUTHKEY_ENV"]
