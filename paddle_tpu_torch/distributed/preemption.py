"""Preemption-safe training — the port of
paddle_tpu/distributed/preemption.py (ref: the reference has only
checkpoint/resume, incubate/fleet/collective/__init__.py:236,294).

A maintenance event delivers SIGTERM ahead of eviction.
``PreemptionHandler`` turns the signal into a flag the training loop
polls between steps: at the next step boundary the loop saves a
consistent checkpoint (parameters, optimizer state, the generators'
states, the TrainStatus) and the process exits with
:data:`PREEMPTED_EXIT_CODE`, which ``distributed/launch.py`` passes on
("relaunch me").  The relaunch resumes bit for bit on the same layout;
on another one (fewer ranks) ``io.load_checkpoint`` reshards the
checkpoint onto it (``framework/reshard.py``).

One process per rank: a signal reaches each rank on its own, and the
save of a program whose persistables are sharded over the group is a
collective.  So under a process group of more than one rank
:meth:`PreemptionHandler.step_done` agrees on the flag with one MAX
all-reduce a step, and every rank stops at the same step boundary.  Such
a program is saved sharded (each rank writes its own blocks:
``io.save_checkpoint(sharded=True)``); any other is saved whole by the
calling rank.

Robustness contract (the JAX package's):

* a signal handler installed before is CHAINED, never clobbered;
* SIGINT is opt-in (``catch_sigint=True``);
* a signal that arrives during :meth:`~PreemptionHandler.restore` is
  deferred until the scope holds the whole restored state;
* an in-flight :class:`~paddle_tpu_torch.io.AsyncCheckpointer` write is
  drained before ``os._exit``, so a preemption never leaves a torn
  checkpoint."""

from __future__ import annotations

import os
import signal
from typing import Iterable, Optional

import torch

from .. import io
from .launch import PREEMPTED_EXIT_CODE

__all__ = ["PreemptionHandler", "PREEMPTED_EXIT_CODE"]


class PreemptionHandler:
    """Cooperative preemption watcher.

    Usage::

        handler = PreemptionHandler(exe, ckpt_dir, main_program)
        status = handler.restore()          # step -1 on a cold start
        for step in range(status.step + 1, max_steps):
            exe.run(...)
            handler.step_done(step)                  # maybe checkpoints
        handler.finish(step)

    ``layout`` is the job's mesh layout: recorded as the checkpoint's
    source layout, and the layout a restore lands on (default: the
    program's ``_mesh_layout``)."""

    def __init__(self, executor, path, main_program=None, scope=None,
                 save_interval: Optional[int] = None,
                 signals: Iterable[int] = (signal.SIGTERM,),
                 exit_on_preempt: bool = True,
                 max_checkpoints: int = 3,
                 catch_sigint: bool = False,
                 checkpointer: Optional["io.AsyncCheckpointer"] = None,
                 layout=None):
        self._exe = executor
        self._path = path
        self._program = main_program
        self._scope = scope
        self._save_interval = save_interval
        self._exit_on_preempt = exit_on_preempt
        self._max_checkpoints = max_checkpoints
        self._checkpointer = checkpointer
        self._layout = layout
        self._preempted = False
        self._status = io.TrainStatus(-1)
        self._chained = {}
        # signals that arrive while restore() runs wait until the scope
        # holds the whole restored state: acting on them mid-restore
        # could publish a checkpoint of half-restored state
        self._restoring = False
        self._deferred: list = []
        sigs = list(signals)
        if catch_sigint and signal.SIGINT not in sigs:
            sigs.append(signal.SIGINT)
        for sig in sigs:
            prev = signal.signal(sig, self._on_signal)
            if callable(prev) and prev is not self._on_signal:
                self._chained[sig] = prev

    def _on_signal(self, signum, frame):
        if self._restoring:
            self._deferred.append(signum)
            return
        # only a flag: checkpointing mid-step would tear the state
        self._preempted = True
        prev = self._chained.get(signum)
        if prev is not None:
            prev(signum, frame)

    @property
    def preempted(self) -> bool:
        return self._preempted

    # -- lifecycle -------------------------------------------------------
    def restore(self) -> io.TrainStatus:
        """Load the newest valid checkpoint (a cold start loads nothing
        and gives step -1), resharded onto the job's layout when it was
        written under another.  A handled signal that arrives meanwhile
        is replayed (flag and chain) once the restore is done."""
        self._restoring = True
        try:
            st = io.load_checkpoint(self._exe, self._path,
                                    main_program=self._program,
                                    scope=self._scope,
                                    dst_layout=self._layout)
        finally:
            self._restoring = False
            deferred, self._deferred = self._deferred, []
            for signum in deferred:
                self._on_signal(signum, None)
        if st.epoch_no < 0:
            st.step = -1
        self._status = st
        return self._status

    def save(self, step: int):
        """Checkpoint ``step`` (every rank of a sharded program calls
        it)."""
        if self._restoring:
            from ..framework.errors import PreconditionNotMetError
            raise PreconditionNotMetError(
                "PreemptionHandler.save() during restore — a checkpoint "
                "of half-restored state must never be published")
        from ..framework.core import default_main_program
        from ..ops.collective_ops import sharded_group
        program = self._program or default_main_program()
        self._status = io.TrainStatus(epoch_no=step, step=step)
        io.save_checkpoint(self._exe, self._path, self._status, program,
                           scope=self._scope,
                           max_checkpoints=self._max_checkpoints,
                           sharded=sharded_group(program) is not None,
                           layout=self._layout)

    def _drain_inflight(self):
        if self._checkpointer is not None:
            self._checkpointer.drain()

    def _agreed(self) -> bool:
        """The flag, MAX over the process group's ranks (one all-reduce;
        the flag itself without a group of more than one rank)."""
        from ..ops.collective_ops import DataParallelGroup, all_reduce
        dp = DataParallelGroup.current()
        if dp is None:
            return self._preempted
        flag = torch.tensor([int(self._preempted)], dtype=torch.int32,
                            device=self._exe.device)
        return bool(all_reduce(dp, flag, "max").item())

    def step_done(self, step: int):
        """Call at every step boundary: the periodic checkpoint, and on a
        preemption (any rank's) the checkpoint and the exit."""
        if self._agreed():
            self._preempted = True
            self._drain_inflight()
            self.save(step)
            if self._exit_on_preempt:
                os._exit(PREEMPTED_EXIT_CODE)   # skip atexit: be gone
            return True
        if self._save_interval and step >= 0 and \
                (step + 1) % self._save_interval == 0:
            self.save(step)
        return False

    def finish(self, step: int):
        self._drain_inflight()
        self.save(step)
