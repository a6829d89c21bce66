"""Optimizer update ops — the port of paddle_tpu/ops/optimizer_ops.py (sgd,
adam and adamw; ref: operators/optimizers/sgd_op, adam_op), and the AMP
loss-scaling ops ``check_finite_and_unscale`` / ``update_loss_scaling``
(ref: operators/amp/).

The JAX package returns new arrays (ParamOut, Moment1Out, ...) that the
executor writes back under the same names.  The port does the same in
``Executor.run``; a step prepared with ``donate_state=True`` sets
``ctx.donate_state`` and the ops update their state tensors in place, so
parameters and moments keep their storage across steps.

Dense ``adam`` and ``adamw`` run on the ``fused_adam`` route: the
executor hands every run of them to :func:`adam_group`
(``registry.register_group``), which sends the ops the route takes to the
multi-tensor kernel in one launch (ops/cuda/optimizer.py; the JAX
package's step fuses the same updates into its one XLA executable).  The
kernel computes each op's bias-corrected step ``lr_t = lr * sqrt(1 -
beta2^t) / (1 - beta1^t)``, AdamW's decoupled decay ``lr * coeff * p`` of
the parameter as it was before the update, and the beta-power updates on
the device, so no op waits for the host.  An op on its own is a run of
one.  The lazy ``SparseRows`` branch and an op whose route is turned off
are plain compositions, as in the JAX package.

The loss-scaling ops are plain tensor compositions, as in the JAX package
(no Pallas kernel there): they read the overflow verdict and the scale
state on the device and never wait for the host, and they write their
``Out`` back under the gradients' own names."""

from __future__ import annotations

import torch

from .cuda import optimizer as cuda_opt
from .registry import cuda_route, register, register_group, x


@register("sgd")
def _sgd(ctx, ins, attrs):
    p, g, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "LearningRate")
    step = lr.to(p.dtype) * g.to(p.dtype)
    if ctx.donate_state:
        return {"ParamOut": p.sub_(step)}
    return {"ParamOut": p - step}


def _lazy_adam(p, g, m1, m2, b1p, b2p, lr_t, beta1, beta2, eps, rows):
    """SelectedRows semantics (ref: adam_op.h's lazy branch): rows the
    batch never touched keep their param and moments."""
    ids = torch.cat([r.reshape(-1).long() for r in rows])
    touched = torch.zeros(p.shape[0], dtype=torch.bool, device=p.device)
    touched[ids] = True
    rowsel = touched.reshape((-1,) + (1,) * (p.dim() - 1))
    m1_new = beta1 * m1 + (1 - beta1) * g
    m2_new = beta2 * m2 + (1 - beta2) * g * g
    p_new = p - lr_t.to(p.dtype) * (m1_new / (m2_new.sqrt() + eps))
    return {"ParamOut": torch.where(rowsel, p_new, p),
            "Moment1Out": torch.where(rowsel, m1_new, m1),
            "Moment2Out": torch.where(rowsel, m2_new, m2),
            "Beta1PowOut": b1p * beta1, "Beta2PowOut": b2p * beta2}


def _composed(op_type, ctx, ins, attrs):
    """The plain composition of one dense or lazy ``adam`` / ``adamw``,
    AdamW's decay taken from the parameter before the update."""
    p, g, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "LearningRate")
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1p, b2p = x(ins, "Beta1Pow"), x(ins, "Beta2Pow")
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g = g.to(m1.dtype)
    coeff = _decay_coeff(op_type, attrs)
    decay = lr.to(p.dtype) * coeff * p if coeff else None
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    if attrs.get("lazy_mode") and ins.get("SparseRows"):
        out = _lazy_adam(p, g, m1, m2, b1p, b2p, lr_t, beta1, beta2, eps,
                         ins["SparseRows"])
    else:
        m1_out = beta1 * m1 + (1 - beta1) * g
        m2_out = beta2 * m2 + (1 - beta2) * g * g
        out = {"ParamOut": p - lr_t.to(p.dtype) *
               (m1_out / (m2_out.sqrt() + eps)),
               "Moment1Out": m1_out, "Moment2Out": m2_out}
        if ctx.donate_state:             # lr_t above already read them
            out.update(Beta1PowOut=b1p.mul_(beta1),
                       Beta2PowOut=b2p.mul_(beta2))
        else:
            out.update(Beta1PowOut=b1p * beta1, Beta2PowOut=b2p * beta2)
    if decay is not None:
        out["ParamOut"] = out["ParamOut"] - decay
    return out


def _decay_coeff(op_type, attrs) -> float:
    if op_type == "adamw" and attrs.get("with_decay", True):
        return attrs.get("coeff", 0.01)
    return 0.0


def _kernel_update(ctx, items):
    """One launch for the ops ``items`` the route took; without
    ``donate_state`` (Executor.run) on copies, so the inputs stay intact."""
    entries, outs = [], []
    for op_type, ins, attrs in items:
        state = [x(ins, s) for s in ("Param", "Moment1", "Moment2",
                                     "Beta1Pow", "Beta2Pow")]
        if not ctx.donate_state:
            state = [t.clone() for t in state]
        p, m1, m2, b1p, b2p = state
        lr = x(ins, "LearningRate")
        entries.append(cuda_opt.AdamTensor(
            p, x(ins, "Grad").to(m1.dtype).contiguous(), m1, m2,
            lr.to(torch.float32).reshape(1), b1p, b2p,
            attrs.get("beta1", 0.9), attrs.get("beta2", 0.999),
            attrs.get("epsilon", 1e-8), _decay_coeff(op_type, attrs)))
        outs.append({"ParamOut": p, "Moment1Out": m1, "Moment2Out": m2,
                     "Beta1PowOut": b1p, "Beta2PowOut": b2p})
    cuda_opt.adam_multi(entries)
    return outs


@register_group("adam", "adamw")
def adam_group(ctx, items):
    """A run of ``adam`` / ``adamw`` ops (``(op_type, ins, attrs)`` each, no
    op reading what another writes): every maximal run of those the
    ``fused_adam`` route takes is one kernel launch; the lazy ``SparseRows``
    updates and the ops whose route is off run their compositions between
    them.  Returns each op's outputs."""
    outs, batch = [None] * len(items), []

    def flush():
        if not batch:
            return
        for i, out in zip(batch, _kernel_update(
                ctx, [items[i] for i in batch])):
            outs[i] = out
        batch.clear()
    for i, (op_type, ins, attrs) in enumerate(items):
        route = None
        if not (attrs.get("lazy_mode") and ins.get("SparseRows")):
            route, _ = cuda_route(op_type, ins, attrs)
        if route is None:
            flush()
            outs[i] = _composed(op_type, ctx, ins, attrs)
        else:
            batch.append(i)
    flush()
    return outs


@register("adam")
def _adam(ctx, ins, attrs):
    return adam_group(ctx, [("adam", ins, attrs)])[0]


@register("adamw")
def _adamw(ctx, ins, attrs):
    """Adam, then ``ParamOut -= lr * coeff * Param`` with ``Param`` read
    before the update, as the JAX package computes it."""
    return adam_group(ctx, [("adamw", ins, attrs)])[0]


# ---------------------------------------------------------------------------
# AMP loss-scaling ops (ref: operators/amp/)
# ---------------------------------------------------------------------------


def _found_inf(xs, like):
    """A 0-d bool device tensor: True when any element of ``xs`` is not
    finite (no host read)."""
    if not xs:
        return torch.zeros((), dtype=torch.bool, device=like.device)
    return ~torch.stack([torch.isfinite(g).all() for g in xs]).all()


def _zeroed_if(found_inf, xs):
    """Every tensor of ``xs``, or zeros of its shape where ``found_inf``."""
    return [torch.where(found_inf, torch.zeros((), dtype=g.dtype,
                                               device=g.device), g)
            for g in xs]


@register("check_finite_and_unscale")
def _check_finite_and_unscale(ctx, ins, attrs):
    """``Out = X / Scale`` (the scale cast to each gradient's dtype, a
    true division as the JAX op computes it), all zeros when any element
    of any ``X`` is not finite; ``FoundInfinite`` is that verdict, a bool
    on the device."""
    xs = ins["X"]
    scale = x(ins, "Scale")
    found_inf = _found_inf(xs, scale)
    outs = [g / scale.to(g.dtype) for g in xs]
    return {"Out": _zeroed_if(found_inf, outs), "FoundInfinite": found_inf}


@register("amp_check_finite_and_scale")
def _amp_check_finite_and_scale(ctx, ins, attrs):
    return _check_finite_and_unscale(ctx, ins, attrs)


@register("update_loss_scaling")
def _update_loss_scaling(ctx, ins, attrs):
    """ref: operators/amp/update_loss_scaling_op.h — the dynamic loss
    scale through :func:`~..framework.guardrails.scale_policy_update`,
    and ``Out`` = ``X`` zeroed on a found overflow.  The op's own
    ``decr_ratio`` default is 0.5, as in the JAX op; the AMP decorator
    passes 0.8."""
    from ..framework.guardrails import scale_policy_update
    found_inf = x(ins, "FoundInfinite")
    new_scale, good_new, bad_new = scale_policy_update(
        found_inf, x(ins, "PrevLossScaling"), x(ins, "InGoodSteps"),
        x(ins, "InBadSteps"),
        incr_every_n_steps=attrs.get("incr_every_n_steps", 1000),
        decr_every_n_nan_or_inf=attrs.get("decr_every_n_nan_or_inf", 2),
        incr_ratio=attrs.get("incr_ratio", 2.0),
        decr_ratio=attrs.get("decr_ratio", 0.5))
    return {"Out": _zeroed_if(found_inf, ins.get("X", [])),
            "LossScaling": new_scale, "OutGoodSteps": good_new,
            "OutBadSteps": bad_new}
