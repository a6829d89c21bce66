"""Optimizer update ops — the port of paddle_tpu/ops/optimizer_ops.py (sgd,
momentum, lars_momentum, adam, adamw, lamb, adagrad, decayed_adagrad,
rmsprop, adadelta, adamax, ftrl and dpsgd; ref: operators/optimizers/),
and the AMP loss-scaling ops ``check_finite_and_unscale`` /
``update_loss_scaling`` (ref: operators/amp/).

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

The other optimizers' ops are plain tensor compositions in the JAX ops'
arithmetic order (no Pallas kernel there, so no CUDA kernel here).  A run
of ``lamb`` ops goes to :func:`lamb_group`, which computes what the ops
compute one after the other with ``torch._foreach_*`` over the run's
tensors: the same elementwise values with a few launches per expression
instead of one per tensor.  ``dpsgd`` draws its noise from the run's
seeded generator (the JAX package from a JAX key: the bits differ, as
they do for dropout).

The loss-scaling ops are plain tensor compositions, as in the JAX package
(no Pallas kernel there): they read the overflow verdict and the scale
state on the device and never wait for the host, and they write their
``Out`` back under the gradients' own names.

The wrapper optimizers' ops, ``average_accumulates`` (ModelAverage) and
``dgc_momentum``, are plain compositions too, with their counters and the
DGC sparsity schedule on the device; DGC's quantile is a sort
(:func:`quantile_linear`)."""

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
    p_new = p - lr_t.to(p.dtype) * (m1_new / (m2_new.sqrt() + eps)).to(
        p.dtype)
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
    decay = cuda_opt.adamw_decay(lr, coeff, p) if coeff else None
    lr_t = lr * torch.sqrt(1 - b2p) / (1 - b1p)
    if attrs.get("lazy_mode") and ins.get("SparseRows"):
        out = _lazy_adam(p, g, m1, m2, b1p, b2p, lr_t, beta1, beta2, eps,
                         ins["SparseRows"])
    else:
        m1_out = beta1 * m1 + (1 - beta1) * g
        m2_out = beta2 * m2 + (1 - beta2) * g * g
        out = {"ParamOut": p - lr_t.to(p.dtype) *
               (m1_out / (m2_out.sqrt() + eps)).to(p.dtype),
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


@register("momentum")
def _momentum(ctx, ins, attrs):
    p, g, v, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "Velocity"), \
        x(ins, "LearningRate")
    mu = attrs.get("mu", 0.9)
    lr = lr.to(p.dtype)
    g = g.to(p.dtype)
    # L2 regularization folded into the op (ref: momentum_op.h
    # regularization_method)
    if attrs.get("regularization_method", "") == "l2_decay":
        g = g + attrs.get("regularization_coeff", 0.0) * p
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


def _l2_norm(t):
    return torch.sqrt(torch.sum(torch.square(t)))


@register("lars_momentum")
def _lars_momentum(ctx, ins, attrs):
    p, g, v, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "Velocity"), \
        x(ins, "LearningRate")
    mu = attrs.get("mu", 0.9)
    lars_coeff = attrs.get("lars_coeff", 0.001)
    lars_wd = attrs.get("lars_weight_decay", 0.0005)
    eps = attrs.get("epsilon", 0.0)
    p_norm, g_norm = _l2_norm(p), _l2_norm(g)
    local_lr = torch.where(
        (p_norm > 0) & (g_norm > 0),
        lr * lars_coeff * p_norm / (g_norm + lars_wd * p_norm + eps), lr)
    v_out = mu * v + local_lr * (g + lars_wd * p)
    return {"ParamOut": p - v_out, "VelocityOut": v_out}


def _fe(op, *args):
    """``torch._foreach_<op>`` over lists: per tensor the value of the
    plain op (fused launches where the tensors allow, one op each
    otherwise)."""
    return getattr(torch, f"_foreach_{op}")(*args)


@register_group("lamb")
def lamb_group(ctx, items):
    """A run of ``lamb`` ops (ref: operators/optimizers/lamb_op.h; the JAX
    op's arithmetic, in its order), each op's outputs computed as the op
    alone computes them::

        m1 = b1 * m1 + (1 - b1) * g;  m2 = b2 * m2 + ((1 - b2) * g) * g
        r = (m1 / (1 - b1p)) / (sqrt(m2 / (1 - b2p)) + eps) + wd * p
        ratio = |p| / |r| where both norms are > 0, else 1
        p = p - (lr * ratio) * r;  b1p *= b1;  b2p *= b2

    The elementwise expressions run as ``torch._foreach_*`` over the run
    (per element the same operation, so the same value); the ops' scalars
    (bias corrections, trust ratios, steps) are stacked and computed
    once; the quotients by each op's own bias corrections and the product
    by its own step are one op per tensor; the trust ratio's norms are
    ``_foreach_norm`` in the single op and the run alike.  With ``donate_state`` the moments,
    parameters and beta powers are updated in place."""
    n = len(items)
    ins_ = [ins for _, ins, _ in items]
    attrs_ = [attrs for _, _, attrs in items]
    ps = [x(i, "Param") for i in ins_]
    m1s = [x(i, "Moment1") for i in ins_]
    m2s = [x(i, "Moment2") for i in ins_]
    b1ps = [x(i, "Beta1Pow") for i in ins_]
    b2ps = [x(i, "Beta2Pow") for i in ins_]
    lrs = [x(i, "LearningRate") for i in ins_]
    gs = [x(i, "Grad").to(m.dtype) for i, m in zip(ins_, m1s)]
    b1 = [a.get("beta1", 0.9) for a in attrs_]
    b2 = [a.get("beta2", 0.999) for a in attrs_]
    eps = [a.get("epsilon", 1e-6) for a in attrs_]
    wd = [a.get("weight_decay", 0.01) for a in attrs_]
    inplace = ctx.donate_state
    if inplace:
        m1o, m2o = m1s, m2s
        _fe("mul_", m1o, b1)
        _fe("mul_", m2o, b2)
    else:
        m1o, m2o = _fe("mul", m1s, b1), _fe("mul", m2s, b2)
    _fe("add_", m1o, _fe("mul", gs, [1 - b for b in b1]))
    gg = _fe("mul", gs, [1 - b for b in b2])
    _fe("mul_", gg, gs)
    _fe("add_", m2o, gg)
    # each op's own bias corrections 1 - b1p and 1 - b2p, all in one op
    c1, c2 = 1 - torch.stack(b1ps), 1 - torch.stack(b2ps)
    m1h = [m / c1[k] for k, m in enumerate(m1o)]
    m2h = [m / c2[k] for k, m in enumerate(m2o)]
    r = _fe("sqrt", m2h)
    _fe("add_", r, eps)
    r = _fe("div", m1h, r)
    _fe("add_", r, _fe("mul", ps, wd))
    p_norm = torch.stack(_fe("norm", ps))
    r_norm = torch.stack(_fe("norm", r))
    ratio = torch.where((p_norm > 0) & (r_norm > 0), p_norm / r_norm, 1.0)
    step = torch.stack(lrs) * ratio[:, None]        # each op's lr * ratio
    upd = [step[k].to(p.dtype) * rk.to(p.dtype)
           for k, (p, rk) in enumerate(zip(ps, r))]
    if inplace:
        p_out = ps
        _fe("sub_", p_out, upd)
        b1o, b2o = b1ps, b2ps
        _fe("mul_", b1o, b1)
        _fe("mul_", b2o, b2)
    else:
        p_out = _fe("sub", ps, upd)
        b1o, b2o = _fe("mul", b1ps, b1), _fe("mul", b2ps, b2)
    return [{"ParamOut": p_out[k], "Moment1Out": m1o[k],
             "Moment2Out": m2o[k], "Beta1PowOut": b1o[k],
             "Beta2PowOut": b2o[k]} for k in range(n)]


@register("lamb")
def _lamb(ctx, ins, attrs):
    """ref: operators/optimizers/lamb_op.h — layer-adaptive large-batch
    Adam (a run of one of :func:`lamb_group`)."""
    return lamb_group(ctx, [("lamb", ins, attrs)])[0]


@register("adagrad")
def _adagrad(ctx, ins, attrs):
    p, g, mom, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "Moment"), \
        x(ins, "LearningRate")
    eps = attrs.get("epsilon", 1e-6)
    mom_out = mom + g * g
    p_out = p - lr.to(p.dtype) * g / (torch.sqrt(mom_out) + eps)
    return {"ParamOut": p_out, "MomentOut": mom_out}


@register("decayed_adagrad")
def _decayed_adagrad(ctx, ins, attrs):
    p, g, mom, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "Moment"), \
        x(ins, "LearningRate")
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    mom_out = decay * mom + (1 - decay) * g * g
    p_out = p - lr.to(p.dtype) * g / (torch.sqrt(mom_out) + eps)
    return {"ParamOut": p_out, "MomentOut": mom_out}


@register("rmsprop")
def _rmsprop(ctx, ins, attrs):
    p, g, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "LearningRate")
    ms, mom, mg = x(ins, "MeanSquare"), x(ins, "Moment"), x(ins, "MeanGrad")
    rho = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    momentum = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * g * g
    if attrs.get("centered", False):
        mg_out = rho * mg + (1 - rho) * g
        denom = ms_out - mg_out * mg_out + eps
    else:
        mg_out = mg
        denom = ms_out + eps
    mom_out = momentum * mom + lr.to(p.dtype) * g / torch.sqrt(denom)
    return {"ParamOut": p - mom_out, "MomentOut": mom_out,
            "MeanSquareOut": ms_out, "MeanGradOut": mg_out}


@register("adadelta")
def _adadelta(ctx, ins, attrs):
    p, g = x(ins, "Param"), x(ins, "Grad")
    avg_sq_g, avg_sq_u = x(ins, "AvgSquaredGrad"), x(ins, "AvgSquaredUpdate")
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * g * g
    update = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * update * update
    return {"ParamOut": p + update, "AvgSquaredGradOut": g2,
            "AvgSquaredUpdateOut": u2}


@register("adamax")
def _adamax(ctx, ins, attrs):
    p, g, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "LearningRate")
    mom, inf_norm = x(ins, "Moment"), x(ins, "InfNorm")
    b1p = x(ins, "Beta1Pow")
    beta1 = attrs.get("beta1", 0.9)
    beta2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    mom_out = beta1 * mom + (1 - beta1) * g
    inf_out = torch.maximum(beta2 * inf_norm, torch.abs(g))
    lr_t = lr / (1 - b1p)
    p_out = p - lr_t.to(p.dtype) * mom_out / (inf_out + eps)
    # the beta1 power advances every step (the reference does it in
    # AdamaxOptimizer._finish_update)
    return {"ParamOut": p_out, "MomentOut": mom_out, "InfNormOut": inf_out,
            "Beta1PowOut": b1p * beta1}


@register("ftrl")
def _ftrl(ctx, ins, attrs):
    p, g, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "LearningRate")
    sq, lin = x(ins, "SquaredAccumulator"), x(ins, "LinearAccumulator")
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    new_sq = sq + g * g
    if lr_power == -0.5:
        root_new, root_old = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        root_new = torch.pow(new_sq, -lr_power)
        root_old = torch.pow(sq, -lr_power)
    sigma = (root_new - root_old) / lr
    lin_out = lin + g - sigma * p
    denom = root_new / lr + 2 * l2
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    return {"ParamOut": pre / denom, "SquaredAccumOut": new_sq,
            "LinearAccumOut": lin_out}


@register("dpsgd")
def _dpsgd(ctx, ins, attrs):
    """Differentially private SGD (ref: optimizers/dpsgd_op.h): the
    gradient clipped to L2 norm ``clip``, plus Gaussian noise of standard
    deviation ``sigma * clip / batch_size`` drawn from the run's
    generator."""
    p, g, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "LearningRate")
    clip = attrs.get("clip", 10.0)
    batch_size = attrs.get("batch_size", 16.0)
    sigma = attrs.get("sigma", 1.0)
    scale = torch.clamp(clip / torch.clamp(_l2_norm(g), min=1e-12),
                        max=1.0)
    noise = torch.randn(g.shape, generator=ctx.generator, dtype=g.dtype,
                        device=g.device) * (sigma * clip / batch_size)
    return {"ParamOut": p - lr.to(p.dtype) * (g * scale + noise)}


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


# ---------------------------------------------------------------------------
# the wrapper optimizers' ops: ModelAverage's accumulators and DGC momentum
# ---------------------------------------------------------------------------

#: kMaxNumAccumulates of the reference's average_accumulates_op.h
MAX_NUM_ACCUMULATES = 16384


@register("average_accumulates")
def _average_accumulates(ctx, ins, attrs):
    """Sliding-window parameter averaging (ref: operators/optimizers/
    average_accumulates_op.h; ModelAverage's op), the JAX op's state
    machine on int32 counters, every branch a select (no host read):

      num_updates += 1; num_accumulates += 1; sum_1 += param
      every kMaxNumAccumulates updates: sum_2 += sum_1; sum_1 = 0
      when num_accumulates >= min_average_window and num_accumulates >=
      min(max_average_window, num_updates * average_window) (the window
      in float32): sum_3 = sum_1 + sum_2; sum_1 = sum_2 = 0;
      old_num_accumulates = num_accumulates; num_accumulates = 0."""
    p = x(ins, "param")
    s1, s2, s3 = x(ins, "in_sum_1"), x(ins, "in_sum_2"), x(ins, "in_sum_3")
    num_acc = x(ins, "in_num_accumulates")
    old_num = x(ins, "in_old_num_accumulates")
    num_upd = x(ins, "in_num_updates")
    rate = attrs.get("average_window", 0.0)
    max_win = attrs.get("max_average_window", 10000)
    min_win = attrs.get("min_average_window", 10000)

    num_upd = num_upd + 1
    num_acc = num_acc + 1
    s1 = s1 + p.to(s1.dtype)
    roll = (num_upd % MAX_NUM_ACCUMULATES) == 0
    zero = torch.zeros((), dtype=s1.dtype, device=s1.device)
    s2 = torch.where(roll, s2 + s1, s2)
    s1 = torch.where(roll, zero, s1)
    updates = num_upd.to(torch.float32) * rate
    window = torch.minimum(torch.full_like(updates, float(max_win)), updates)
    shift = (num_acc >= min_win) & (num_acc.to(torch.float32) >= window)
    s3 = torch.where(shift, s1 + s2, s3)
    s1 = torch.where(shift, zero, s1)
    s2 = torch.where(shift, zero, s2)
    old_num = torch.where(shift, num_acc, old_num)
    num_acc = torch.where(shift, torch.zeros_like(num_acc), num_acc)
    return {"out_sum_1": s1, "out_sum_2": s2, "out_sum_3": s3,
            "out_num_accumulates": num_acc,
            "out_old_num_accumulates": old_num,
            "out_num_updates": num_upd}


def quantile_linear(values: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """The linear-interpolation quantile (``np.quantile``'s default,
    ``jnp.quantile``'s) of a float32 tensor at a device scalar ``q``: the
    values at the floor and ceiling of the rank position ``q * (n - 1)``
    in the sorted input, weighted ``1 - f`` and ``f``, rounded once to
    float32.  The position and the weights are float64 scalars, exact
    for any n below 2^29 (``jnp.quantile`` forms the position in float32,
    which cannot hold a rank of BERT-base's 23.4 M-element word embedding
    to the unit).  A sort and two one-element gathers on the device, no
    host read (``torch.quantile`` refuses more than 2^24 elements)."""
    flat = values.reshape(-1)
    last = flat.numel() - 1
    ordered = torch.sort(flat).values
    pos = q.reshape(1).to(torch.float64) * last
    low = torch.clamp(torch.floor(pos), 0, last)
    high = torch.clamp(torch.ceil(pos), 0, last)
    high_w = pos - low
    lo = ordered.index_select(0, low.to(torch.int64)).to(torch.float64)
    hi = ordered.index_select(0, high.to(torch.int64)).to(torch.float64)
    return (lo * (1.0 - high_w) + hi * high_w).to(torch.float32).reshape(())


@register("dgc_momentum")
def _dgc_momentum(ctx, ins, attrs):
    """Deep Gradient Compression momentum (ref: operators/dgc_op.cc,
    DGCMomentumOptimizer), the JAX op's dense form: U = mu U + g
    (momentum correction), V = V + U; the elements of V at or above the
    sparsity quantile of |V| are sent (here: applied to the parameter)
    and zeroed in U and V, the rest stay as residual.  The sparsity ramps
    through ``sparsity`` over ``rampup_step`` steps from
    ``rampup_begin_step``; before it the op is plain momentum.  The ramp
    index and the quantile are computed on the device from the
    ``CurrentStep`` counter, so nothing is read on the host."""
    p, g, lr = x(ins, "Param"), x(ins, "Grad"), x(ins, "LearningRate")
    u, v = x(ins, "U"), x(ins, "V")
    step = x(ins, "CurrentStep")
    mu = attrs.get("momentum", 0.9)
    use_nesterov = attrs.get("use_nesterov", False)
    rampup_begin = float(attrs.get("rampup_begin_step", 0.0))
    rampup_step = max(float(attrs.get("rampup_step", 1.0)), 1.0)
    sparsity = list(attrs.get("sparsity", [0.999]))

    lr = lr.to(p.dtype)
    g = g.to(p.dtype)
    stepf = step.reshape(()).to(torch.float32)
    prog = torch.clamp((stepf - rampup_begin) / rampup_step, 0.0, 1.0)
    sched = torch.tensor(sparsity, dtype=torch.float32, device=p.device)
    idx = torch.clamp((prog * len(sparsity)).to(torch.int32),
                      max=len(sparsity) - 1)
    ratio = sched.index_select(0, idx.reshape(1).to(torch.int64))

    u_new = mu * u + g
    v_new = v + u_new
    thr = quantile_linear(torch.abs(v_new).to(torch.float32),
                          ratio).to(p.dtype)
    mask = (torch.abs(v_new) >= thr).to(p.dtype)
    sent = v_new * mask
    v_keep = v_new * (1.0 - mask)
    u_keep = u_new * (1.0 - mask)

    dgc_on = stepf >= rampup_begin
    plain_update = g + mu * u_new if use_nesterov else u_new
    return {"ParamOut": torch.where(dgc_on, p - lr * sent,
                                    p - lr * plain_update),
            "UOut": torch.where(dgc_on, u_keep, u_new),
            "VOut": torch.where(dgc_on, v_keep, v)}
