"""The dynamic loss-scale policy — the port of
``scale_policy_update`` from paddle_tpu/framework/guardrails.py, the one
function of that module the mixed-precision path needs (the AMP
``update_loss_scaling`` op, ops/optimizer_ops.py).

The rest of the JAX package's guardrails (the non-finite step defence,
its own scale state, the fault lines) is ROADMAP Queue 1 item 5 and is
not ported; the executor refuses a program that asks for it."""

from __future__ import annotations

from typing import Optional

import torch


def scale_policy_update(found_inf, scale, good, bad,
                        incr_every_n_steps: int,
                        decr_every_n_nan_or_inf: int,
                        incr_ratio: float, decr_ratio: float,
                        max_scale: Optional[float] = None):
    """The backoff/regrow policy of dynamic loss scaling (ref:
    operators/amp/update_loss_scaling_op.h), on device tensors with
    ``torch.where`` only — no host read, no branch on a value:

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
