"""Learning-rate schedules — the port of paddle_tpu/lr_scheduler.py (ref:
python/paddle/fluid/layers/learning_rate_scheduler.py — noam_decay,
exponential_decay, natural_exp_decay, inverse_time_decay,
polynomial_decay, piecewise_decay, cosine_decay, linear_lr_warmup).

As in the JAX package, a schedule is a persistable ``@LR_STEP@`` counter
incremented each run plus one ``lr_schedule`` op computing the current
LR into a persistable var that the optimizer ops read.  The op computes
the schedule's formula as float32 tensor ops on the run's device, so a
step never waits for the host.  The LR of a run is the schedule at the
counter's value before that run's increment: the first run reads step
0."""

from __future__ import annotations

import math

import torch

from .framework import unique_name
from .framework.core import default_main_program, default_startup_program
from .ops.registry import register, x


@register("lr_schedule")
def _lr_schedule_op(ctx, ins, attrs):
    a = attrs
    kind = a["kind"]
    s = x(ins, "Step").to(torch.float32).reshape(())
    if kind == "constant":
        lr = torch.full((), a["lr"], dtype=torch.float32, device=s.device)
    elif kind == "noam":
        w = a["warmup_steps"]
        lr = a["lr"] * (a["d_model"] ** -0.5) * torch.minimum(
            (s + 1) ** -0.5, (s + 1) * w ** -1.5)
    elif kind in ("exponential", "natural_exp", "inverse_time"):
        decay = s / a["decay_steps"]
        if a.get("staircase"):
            decay = torch.floor(decay)
        if kind == "exponential":
            lr = a["lr"] * a["decay_rate"] ** decay
        elif kind == "natural_exp":
            lr = a["lr"] * torch.exp(-a["decay_rate"] * decay)
        else:
            lr = a["lr"] / (1.0 + a["decay_rate"] * decay)
    elif kind == "polynomial":
        if a.get("cycle"):
            steps = a["decay_steps"] * torch.clamp(
                torch.ceil(s / a["decay_steps"]), min=1.0)
        else:
            steps = a["decay_steps"]
            s = torch.clamp(s, max=float(steps))
        lr = (a["lr"] - a["end_lr"]) * (1 - s / steps) ** a["power"] \
            + a["end_lr"]
    elif kind == "cosine":
        epoch = torch.floor(s / a["step_each_epoch"])
        lr = a["lr"] * 0.5 * (torch.cos(epoch * math.pi / a["epochs"]) + 1)
    elif kind == "piecewise":
        bounds = torch.tensor(a["boundaries"], dtype=torch.float32,
                              device=s.device)
        values = torch.tensor(a["values"], dtype=torch.float32,
                              device=s.device)
        lr = values[(s >= bounds).sum()]
    else:
        raise NotImplementedError(f"lr_schedule kind {kind!r}")
    if a.get("warmup_steps_linear"):
        w = a["warmup_steps_linear"]
        start, end = a["warmup_start_lr"], a["warmup_end_lr"]
        lr = torch.where(s < w, start + (end - start) * (s / w), lr)
    return {"Out": lr.to(torch.float32).reshape(1)}


class LRScheduler:
    """A schedule ``kind`` with its attrs; an optimizer given one as its
    learning rate calls :meth:`_create_ops` once."""

    def __init__(self, kind, **attrs):
        self.kind = kind
        self.attrs = attrs
        self._lr_var = None

    def _create_ops(self):
        if self._lr_var is not None:
            return self._lr_var
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        step_name = unique_name.generate("@LR_STEP@")
        step = main.create_var(name=step_name, shape=(1,), dtype="int64",
                               persistable=True)
        sstep = startup.create_var(name=step_name, shape=(1,), dtype="int64",
                                   persistable=True)
        startup.append_op(type="fill_constant", outputs={"Out": [sstep]},
                          attrs={"shape": [1], "dtype": "int64", "value": 0})
        lr_name = unique_name.generate("learning_rate")
        lr = main.create_var(name=lr_name, shape=(1,), dtype="float32",
                             persistable=True)
        slr = startup.create_var(name=lr_name, shape=(1,), dtype="float32",
                                 persistable=True)
        startup.append_op(type="fill_constant", outputs={"Out": [slr]},
                          attrs={"shape": [1], "dtype": "float32",
                                 "value": float(self.attrs.get("lr", 0.0))})
        main.append_op(type="lr_schedule", inputs={"Step": [step]},
                       outputs={"Out": [lr]},
                       attrs={"kind": self.kind, **self.attrs})
        main.append_op(type="increment", inputs={"X": [step]},
                       outputs={"Out": [step]}, attrs={"step": 1})
        self._lr_var = lr
        return lr

    def _wrap(self, **extra):
        self.attrs.update(extra)
        return self


def noam_decay(d_model, warmup_steps, learning_rate=1.0):
    return LRScheduler("noam", lr=learning_rate, d_model=d_model,
                       warmup_steps=warmup_steps)


def exponential_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return LRScheduler("exponential", lr=learning_rate,
                       decay_steps=decay_steps, decay_rate=decay_rate,
                       staircase=staircase)


def natural_exp_decay(learning_rate, decay_steps, decay_rate,
                      staircase=False):
    return LRScheduler("natural_exp", lr=learning_rate,
                       decay_steps=decay_steps, decay_rate=decay_rate,
                       staircase=staircase)


def inverse_time_decay(learning_rate, decay_steps, decay_rate,
                       staircase=False):
    return LRScheduler("inverse_time", lr=learning_rate,
                       decay_steps=decay_steps, decay_rate=decay_rate,
                       staircase=staircase)


def polynomial_decay(learning_rate, decay_steps, end_learning_rate=0.0001,
                     power=1.0, cycle=False):
    return LRScheduler("polynomial", lr=learning_rate,
                       decay_steps=decay_steps, end_lr=end_learning_rate,
                       power=power, cycle=cycle)


def piecewise_decay(boundaries, values):
    return LRScheduler("piecewise", lr=values[0], boundaries=list(boundaries),
                       values=list(values))


def cosine_decay(learning_rate, step_each_epoch, epochs):
    return LRScheduler("cosine", lr=learning_rate,
                       step_each_epoch=step_each_epoch, epochs=epochs)


def linear_lr_warmup(learning_rate, warmup_steps, start_lr, end_lr):
    """Linear warmup from ``start_lr`` to ``end_lr`` over the first
    ``warmup_steps`` runs, then ``learning_rate`` (a float or another
    schedule)."""
    if isinstance(learning_rate, LRScheduler):
        return learning_rate._wrap(warmup_steps_linear=warmup_steps,
                                   warmup_start_lr=start_lr,
                                   warmup_end_lr=end_lr)
    return LRScheduler("constant", lr=learning_rate,
                       warmup_steps_linear=warmup_steps,
                       warmup_start_lr=start_lr, warmup_end_lr=end_lr)
