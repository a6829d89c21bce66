"""Optimizer update ops — the port of paddle_tpu/ops/optimizer_ops.py (sgd,
adam and adamw; ref: operators/optimizers/sgd_op, adam_op).

The JAX package returns new arrays (ParamOut, Moment1Out, ...) that the
executor writes back under the same names.  The port does the same in
``Executor.run``; a step prepared with ``donate_state=True`` sets
``ctx.donate_state`` and the ops update their state tensors in place, so
parameters and moments keep their storage across steps.

The dense ``adam`` runs on the ``fused_adam`` route (the hand-written
one-pass kernel, ops/cuda/optimizer.py).  Its bias-corrected step
``lr_t = lr * sqrt(1 - beta2^t) / (1 - beta1^t)`` and the beta-power
updates are device tensor ops, so no op waits for the host.  The lazy
``SparseRows`` branch is a plain composition, as in the JAX package.
``adamw`` runs the same update on the same kernel, then subtracts the
decoupled decay ``lr * coeff * p`` of the parameter as it was before the
update."""

from __future__ import annotations

import torch

from .cuda import optimizer as cuda_opt
from .registry import cuda_route, register, x


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


def _adam_update(op_type, ctx, ins, attrs):
    p, g, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "LearningRate")
    m1, m2 = x(ins, "Moment1"), x(ins, "Moment2")
    b1p, b2p = x(ins, "Beta1Pow"), x(ins, "Beta2Pow")
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    g = g.to(m1.dtype)
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    if attrs.get("lazy_mode") and ins.get("SparseRows"):
        return _lazy_adam(p, g, m1, m2, b1p, b2p, lr_t, beta1, beta2, eps,
                          ins["SparseRows"])
    donate = ctx.donate_state
    route, _ = cuda_route(op_type, ins, attrs)
    if route is not None:
        if not donate:              # Executor.run: leave the inputs intact
            p, m1, m2 = p.clone(), m1.clone(), m2.clone()
        p_out, m1_out, m2_out = cuda_opt.adam(
            p, g.contiguous(), m1, m2, lr_t.reshape(1).to(torch.float32),
            beta1=beta1, beta2=beta2, eps=eps)
    else:
        m1_out = beta1 * m1 + (1 - beta1) * g
        m2_out = beta2 * m2 + (1 - beta2) * g * g
        p_out = p - lr_t.to(p.dtype) * (m1_out / (m2_out.sqrt() + eps))
    if donate:                      # lr_t above already read the powers
        b1p_out, b2p_out = b1p.mul_(beta1), b2p.mul_(beta2)
    else:
        b1p_out, b2p_out = b1p * beta1, b2p * beta2
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out,
            "Beta1PowOut": b1p_out, "Beta2PowOut": b2p_out}


@register("adam")
def _adam(ctx, ins, attrs):
    return _adam_update("adam", ctx, ins, attrs)


@register("adamw")
def _adamw(ctx, ins, attrs):
    """Adam, then ``ParamOut -= lr * coeff * Param`` with ``Param`` read
    before the update, as the JAX package computes it.  The decay term is
    taken first: with ``donate_state`` the update writes p in place."""
    if not attrs.get("with_decay", True):
        return _adam_update("adamw", ctx, ins, attrs)
    p, lr = x(ins, "Param"), x(ins, "LearningRate")
    decay = lr.to(p.dtype) * attrs.get("coeff", 0.01) * p
    out = _adam_update("adamw", ctx, ins, attrs)
    if ctx.donate_state:
        out["ParamOut"].sub_(decay)
    else:
        out["ParamOut"] = out["ParamOut"] - decay
    return out
