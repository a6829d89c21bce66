"""Non-finite step defence — the port of
paddle_tpu/framework/guardrails.py.

With ``flag("guard_nonfinite")`` a training step whose loss or any
gradient holds a NaN or Inf is skipped: every persistable it writes comes
out bit for bit as it went in, and the run goes on.  More than
``flag("max_skipped_steps")`` skips in a row abort with a replayable
flight bundle and :class:`GuardrailViolation`.

The JAX package traces the defence into its one executable and selects
the old state with ``jnp.where`` after the update.  The port runs op by
op and updates its state in place, so the design differs at three
points:

* **the probe** (:func:`stash_probe`), right after the gradients
  materialize and before the ops after the backward: one multi-tensor
  pass over the loss and every gradient (``torch._foreach_norm`` of the
  largest magnitude, a few launches a step instead of one reduction per
  gradient), reduced to the JAX package's value (0.0 when every element
  is finite, NaN otherwise) on the device.  Under a process group the
  probe is summed over every rank of the run (NaN propagates through the
  sum), so every replica, shard and stage skips the same step — each sees
  different gradients.  No host read: the verdict is a device tensor,
  ``ctx.guard_skip`` (int32, 1 on a skipped step);
* **the skip**: ops that update in place (the Adam kernel #10, the plain
  Adam's beta powers, SGD, LAMB's ``_foreach`` composite) read
  ``ctx.guard_skip`` and write nothing when it is set — the kernel
  returns before its first store, the compositions select with
  ``torch.where``.  A skipped step's arithmetic never reaches the state:
  selecting is not adding NaN x 0.  Ops that write a new tensor are
  selected after the step (:func:`guarded_state_out`), as the JAX package
  selects all of them;
* **the step count** is the guard's device counter as in the JAX
  package; the ``grad_nonfinite`` drill seam reads it on the host only
  while that seam is armed.

The skip counters and the loss scale advance on the device through
:func:`scale_policy_update` (the AMP op's policy, shared); a prepared
step reads them on the host every few steps, at ``wait()`` and through
``guard_info``.  ``guard_loss_scale`` on a pipelined or microbatched
program is refused, as in the JAX package."""

from __future__ import annotations

from typing import Any, Dict, Optional, Sequence

import numpy as np
import torch

from ..flags import flag
from .errors import GuardrailViolation  # noqa: F401  (re-export)

#: reserved scope names of the guard's device state (never checkpointed)
GUARD_STEP = "@GUARD_STEP@"            # int32 step counter
GUARD_SKIP = "@GUARD_SKIP@"            # int32 CONSECUTIVE skipped steps
GUARD_SKIP_TOTAL = "@GUARD_SKIP_TOTAL@"  # int32 total skipped steps
GUARD_LAST = "@GUARD_LAST@"            # int32: 1 iff last step skipped
GUARD_SCALE = "@GUARD_SCALE@"          # f32 guard loss scale
GUARD_GOOD = "@GUARD_GOOD@"            # int32 good steps since growth
GUARD_PROBE = "@GUARD_PROBE@"          # f32 finite probe of last step

STATE_VARS = (GUARD_STEP, GUARD_SKIP, GUARD_SKIP_TOTAL, GUARD_LAST,
              GUARD_SCALE, GUARD_GOOD, GUARD_PROBE)

GUARD_PREFIX = "@GUARD_"


def is_guard_var(name: str) -> bool:
    return name.startswith(GUARD_PREFIX)


class GuardPolicy:
    """Resolved guardrail configuration for one program run."""

    __slots__ = ("use_scale", "init_scale", "incr_every", "incr_ratio",
                 "decr_ratio", "max_scale", "max_skipped", "scale_fetch")

    def __init__(self, use_scale: bool, scale_fetch: Optional[str] = None):
        self.use_scale = bool(use_scale)
        # without guard scaling the scale state is parked at a neutral 1.0
        self.init_scale = float(flag("guard_loss_scale_init")) \
            if self.use_scale else 1.0
        self.incr_every = int(flag("guard_incr_every_n_steps"))
        self.incr_ratio = float(flag("guard_incr_ratio"))
        self.decr_ratio = float(flag("guard_decr_ratio"))
        self.max_scale = float(flag("guard_loss_scale_max"))
        self.max_skipped = int(flag("max_skipped_steps"))
        # the var the telemetry "loss_scale" field reads: AMP's dynamic
        # scale var when the program carries one, else the guard's own
        self.scale_fetch = scale_fetch or GUARD_SCALE


def active_policy(has_backward: bool,
                  amp_scale_var: Optional[str] = None,
                  pipelined: bool = False) -> Optional[GuardPolicy]:
    """The policy for a run, or None when the guard is off or the program
    has nothing to guard (no backward)."""
    if not flag("guard_nonfinite") or not has_backward:
        return None
    use_scale = bool(flag("guard_loss_scale")) and amp_scale_var is None
    if use_scale and pipelined:
        from .errors import InvalidArgumentError
        raise InvalidArgumentError(
            "flag('guard_loss_scale') is not supported on "
            "pipelined/microbatched programs yet — the guard's finite "
            "check and skip gating compose with 1F1B, the scale "
            "application does not; use AMP's decorator scaling or "
            "disable guard_loss_scale")
    return GuardPolicy(use_scale, scale_fetch=amp_scale_var)


def policy_for(ops) -> Optional[GuardPolicy]:
    """:func:`active_policy` for the op list of a training block (None
    without a ``backward`` op)."""
    bw = next((op for op in ops if op.type == "backward"), None)
    if bw is None:
        return None
    pipelined = int(bw.attrs.get("pipe_microbatches") or 1) > 1 or \
        int(bw.attrs.get("pipe_stages") or 1) > 1
    return active_policy(True, amp_scale_var=bw.attrs.get("loss_scale_var"),
                         pipelined=pipelined)


def no_gate_names(ops) -> set:
    """The AMP scale-policy state: it must advance on a bad step (backoff
    is the response, not a casualty of the gate)."""
    return {n for op in ops if op.type == "update_loss_scaling"
            for n in op.output_names()}


def init_value(name: str, policy: Optional[GuardPolicy] = None):
    """Host-side initial value for a guard state var (a run's first
    step)."""
    if name == GUARD_SCALE:
        scale = policy.init_scale if policy is not None \
            else float(flag("guard_loss_scale_init"))
        return np.asarray(scale, np.float32)
    if name == GUARD_PROBE:
        return np.asarray(0.0, np.float32)
    return np.asarray(0, np.int32)


def init_state(scope, policy: GuardPolicy, device) -> Dict[str, Any]:
    """The guard's device state: the scope's values where it has them,
    else :func:`init_value`'s."""
    out = {}
    for n in STATE_VARS:
        v = scope.find_var(n) if scope is not None else None
        if v is None:
            v = init_value(n, policy)
        out[n] = torch.as_tensor(np.asarray(v) if not isinstance(
            v, torch.Tensor) else v).to(device).reshape(())
    return out


# ---------------------------------------------------------------------------
# the step's pieces (device tensors, no host read)
# ---------------------------------------------------------------------------


def finite_probe(leaves: Sequence[Any]) -> torch.Tensor:
    """ONE float32 scalar, 0.0 when every element of every float leaf is
    finite and NaN otherwise (the JAX package's ``sum(leaf * 0)``): the
    largest magnitude of each leaf in one multi-tensor pass
    (``torch._foreach_norm(.., inf)``, which keeps a NaN), times 0,
    summed."""
    floats = [v for v in leaves if isinstance(v, torch.Tensor) and
              v.is_floating_point() and v.numel()]
    if not floats:
        dev = next((v.device for v in leaves
                    if isinstance(v, torch.Tensor)), None)
        return torch.zeros((), dtype=torch.float32, device=dev)
    peaks = torch._foreach_norm(floats, float("inf"))
    return (torch.stack([p.float() for p in peaks]) * 0.0).sum()


def scale_policy_update(found_inf, scale, good, bad,
                        incr_every_n_steps: int,
                        decr_every_n_nan_or_inf: int,
                        incr_ratio: float, decr_ratio: float,
                        max_scale: Optional[float] = None):
    """The backoff/regrow policy of dynamic loss scaling (ref:
    operators/amp/update_loss_scaling_op.h), shared by the AMP
    ``update_loss_scaling`` op and the guard's own scale, on device
    tensors with ``torch.where`` only — no host read:

    * a bad (non-finite) step zeroes the good counter and bumps the bad
      one; ``decr_every_n_nan_or_inf`` bad steps back the scale off by
      ``decr_ratio``, floored at 1.0;
    * ``incr_every_n_steps`` consecutive good steps regrow it by
      ``incr_ratio``, capped at ``max_scale`` when one is given.

    ``found_inf`` is a bool tensor, ``scale`` a float tensor, ``good`` and
    ``bad`` integer tensors.  Returns ``(new_scale, new_good, new_bad)``,
    the counters int32."""
    good_new = torch.where(found_inf, torch.zeros_like(good), good + 1)
    bad_new = torch.where(found_inf, bad + 1, torch.zeros_like(bad))
    scale_up = good_new >= incr_every_n_steps
    scale_down = bad_new >= decr_every_n_nan_or_inf
    grown = scale * incr_ratio
    if max_scale is not None:
        grown = torch.clamp(grown, max=max_scale)
    backed_off = torch.clamp(scale * decr_ratio, min=1.0)
    new_scale = torch.where(scale_up, grown,
                            torch.where(scale_down, backed_off, scale))
    good_new = torch.where(scale_up, torch.zeros_like(good_new), good_new)
    bad_new = torch.where(scale_down, torch.zeros_like(bad_new), bad_new)
    return (new_scale, good_new.to(torch.int32), bad_new.to(torch.int32))


def loss_scale(ctx) -> Optional[torch.Tensor]:
    """The guard's own loss scale for this run's backward (detached), or
    None without ``guard_loss_scale``."""
    guard = getattr(ctx, "guard", None)
    if guard is None or not guard.use_scale:
        return None
    return ctx.guard_state[GUARD_SCALE]


def stash_probe(env: Dict[str, Any], loss_name: str,
                grad_names: Sequence[str], ctx):
    """Called by each backward lowering right after the gradients
    materialize (before the ops after the backward, whose collectives and
    unscale ops may rewrite them): apply an armed ``grad_nonfinite``
    drill, then take the probe over the loss and the raw gradients, sum
    it over the run's process group, and set ``ctx.guard_skip``.  A
    no-op when the guard is off and the seam is not armed."""
    from ..testing import faultline
    guard = getattr(ctx, "guard", None)
    if guard is None and not faultline._ARMED:
        return
    grads = [g for g in grad_names if g in env]
    if faultline._ARMED.get("grad_nonfinite") is not None:
        state = getattr(ctx, "guard_state", None)
        step = int(state[GUARD_STEP]) if state else None
        spec = faultline.poison_step(step)
        if spec is not None:
            target = spec.params.get("var")
            gname = target if target in env else \
                (grads[0] if grads else None)
            if gname is not None:
                env[gname] = torch.full_like(env[gname], float("nan"))
    if guard is None:
        return
    probe = finite_probe([env.get(loss_name)] + [env[g] for g in grads])
    if ctx.dp is not None:
        from ..ops.collective_ops import all_reduce
        probe = all_reduce(ctx.dp, probe)
    ctx.guard_probe = probe
    ctx.guard_skip = (~torch.isfinite(probe)).to(torch.int32)


def unscale(env: Dict[str, Any], grad_names: Sequence[str], ctx):
    """Under ``guard_loss_scale``: the gradients divided by the scale the
    loss was multiplied by (after the probe, and after an overlapped
    bucket has written its reduced gradients back)."""
    scale = loss_scale(ctx)
    if scale is None:
        return
    for g in grad_names:
        if g in env:
            env[g] = env[g] / scale.to(env[g].dtype)


def keep_old(ctx) -> Optional[torch.Tensor]:
    """The run's skip verdict as a bool tensor (True: keep the old
    state), or None when the run is not guarded."""
    skip = getattr(ctx, "guard_skip", None)
    return None if skip is None else skip.bool()


def write_guarded(ctx, dst: torch.Tensor, new: torch.Tensor):
    """``dst`` updated in place to ``new``, or left bit for bit on a
    skipped step (a select on the device, no host read)."""
    keep = keep_old(ctx)
    if keep is None:
        return dst.copy_(new)
    return dst.copy_(torch.where(keep, dst, new))


def guarded_state_out(env: Dict[str, Any], state_vals: Dict[str, Any],
                      state_out_names, ctx, no_gate=()):
    """The guard's epilogue of a run (the JAX package's, which selects
    every written persistable): each of ``state_out_names`` the run
    replaced by a new tensor takes its value from ``state_vals`` back in
    ``env`` on a skipped step (in-place writers read the verdict
    themselves), and ``ctx.guard_state`` advances.  Returns the packed
    tail the host decodes (:func:`decode_tail`)."""
    keep = keep_old(ctx)
    if keep is None:
        probe = torch.zeros((), dtype=torch.float32, device=ctx.device)
        keep = torch.zeros((), dtype=torch.bool, device=ctx.device)
    else:
        probe = ctx.guard_probe
    no_gate = set(no_gate)
    for n in state_out_names:
        new, prev = env.get(n), state_vals.get(n)
        if n in no_gate or prev is None or new is None or new is prev:
            continue
        env[n] = torch.where(keep, prev, new)
    return advance(ctx.guard_state, probe, ctx.guard,
                   env.get(ctx.guard.scale_fetch))


def advance(state: Dict[str, torch.Tensor], probe, policy: GuardPolicy,
            amp_scale=None):
    """The guard state after one step (in ``state``, new tensors), and
    the packed tail ``[i32[4] (last, consecutive, total, step), f32[2]
    (probe, loss scale)]`` the host decodes (:func:`decode_tail`)."""
    finite = torch.isfinite(probe)
    skipped_i = (~finite).to(torch.int32)
    scale_prev, good_prev = state[GUARD_SCALE], state[GUARD_GOOD]
    skip_prev = state[GUARD_SKIP]
    new_scale, new_good, _ = scale_policy_update(
        ~finite, scale_prev, good_prev, skip_prev,
        incr_every_n_steps=policy.incr_every,
        decr_every_n_nan_or_inf=1,          # the guard backs off per skip
        incr_ratio=policy.incr_ratio, decr_ratio=policy.decr_ratio,
        max_scale=policy.max_scale)
    if not policy.use_scale and policy.scale_fetch == GUARD_SCALE:
        # not applied to the loss: parked, so the telemetry is honest
        new_scale, new_good = scale_prev, good_prev
    state[GUARD_STEP] = (state[GUARD_STEP] + 1).to(torch.int32)
    state[GUARD_SKIP] = torch.where(finite, torch.zeros_like(skip_prev),
                                    skip_prev + 1).to(torch.int32)
    state[GUARD_SKIP_TOTAL] = (state[GUARD_SKIP_TOTAL] + skipped_i) \
        .to(torch.int32)
    state[GUARD_LAST] = skipped_i
    state[GUARD_SCALE] = new_scale.to(torch.float32)
    state[GUARD_GOOD] = new_good.to(torch.int32)
    state[GUARD_PROBE] = probe.to(torch.float32).reshape(())
    scale_out = new_scale if amp_scale is None or \
        policy.scale_fetch == GUARD_SCALE else amp_scale
    g_i32 = torch.stack([state[GUARD_LAST], state[GUARD_SKIP],
                         state[GUARD_SKIP_TOTAL], state[GUARD_STEP]])
    g_f32 = torch.stack([state[GUARD_PROBE],
                         scale_out.reshape(()).to(torch.float32)])
    return [g_i32, g_f32]


def decode_tail(g_i32, g_f32) -> Dict[str, Any]:
    """Host-side decode of one step's packed guard tail."""
    i = np.asarray(g_i32).reshape(4)
    f = np.asarray(g_f32).reshape(2)
    return {"last_skipped": bool(int(i[0])),
            "consecutive": int(i[1]),
            "skipped_total": int(i[2]),
            "step_counter": int(i[3]),
            "probe": np.float32(f[0]),
            "loss_scale": float(f[1])}


def probe_bits(value) -> str:
    """The f32 probe's exact bit pattern as hex — the replay token."""
    return format(
        int(np.asarray(value, np.float32).reshape(()).view(np.uint32)),
        "08x")


# ---------------------------------------------------------------------------
# host-side escalation (cold path)
# ---------------------------------------------------------------------------


def dump_abort_bundle(reason: str, *, program, step_id, consecutive,
                      total, probe, scale, rng_key, feed,
                      step_counter) -> Optional[str]:
    """Flight bundle and replayable sidecars for the skip-budget abort:
    the bundle's ``guard`` extra carries the offending step's identity
    (guard step counter, run step id, probe bits, loss scale) and the
    paths of two sidecars — the step's feed and random state (npz) and
    the serialized program (json)."""
    import json
    import os
    from ..observability import flight
    from ..testing import faultline

    out_dir = flight.dump_dir()
    feed_file = prog_file = None
    try:
        os.makedirs(out_dir, exist_ok=True)
        tag = f"{os.getpid()}_{step_id}"
        feed_file = os.path.join(out_dir, f"flight_step_{tag}.npz")
        payload = {k: _host(v) for k, v in (feed or {}).items()}
        payload["__rng_key__"] = _host(rng_key)
        payload["__step_counter__"] = np.asarray(step_counter, np.int64)
        payload["__loss_scale__"] = np.asarray(scale, np.float32)
        np.savez(feed_file, **payload)
        from .serialization import program_to_desc
        prog_file = os.path.join(out_dir, f"flight_program_{tag}.json")
        with open(prog_file, "w") as f:
            json.dump(program_to_desc(program), f)
    except Exception:          # sidecar failure must not mask the abort
        pass
    extra = {
        "guard": {
            "step": step_id,
            "step_counter": int(step_counter),
            "consecutive_skipped": int(consecutive),
            "skipped_total": int(total),
            "probe_bits": probe_bits(probe),
            "loss_scale": float(np.asarray(scale).reshape(())),
            "feed_file": feed_file,
            "program_file": prog_file,
        },
        "faultline": faultline.armed(),
    }
    return flight.dump(reason, program=program, extra=extra)


def _host(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().numpy()
    if v is None:
        return np.zeros((0,), np.uint8)
    return np.asarray(v)


__all__ = ["GuardPolicy", "GuardrailViolation", "active_policy",
           "policy_for", "no_gate_names", "init_value", "init_state",
           "finite_probe", "scale_policy_update", "loss_scale",
           "stash_probe", "unscale", "keep_old", "write_guarded",
           "guarded_state_out",
           "advance", "dump_abort_bundle", "probe_bits", "is_guard_var",
           "STATE_VARS", "decode_tail",
           "GUARD_STEP", "GUARD_SKIP", "GUARD_SKIP_TOTAL", "GUARD_LAST",
           "GUARD_SCALE", "GUARD_GOOD", "GUARD_PROBE"]
