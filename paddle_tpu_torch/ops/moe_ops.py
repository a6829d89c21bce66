"""Mixture-of-Experts ops — the port of paddle_tpu/ops/moe_ops.py (the
GShard / Switch formulation: top-k routing with a per-(group, expert)
capacity, expressed as dense one-hot einsums, and the expert exchange
as one all-to-all each way over the expert axis).

Layout contract (enforced by ``parallel/moe.py``):

- the gate weight ``[M, E]`` is replicated;
- the expert weights ``[E, M, H]`` / ``[E, H, M]`` (and biases ``[E,
  ...]``) carry ``dist_attr = (ep_axis, None, ...)``, so each rank holds
  its ``E/ep`` experts (``collective_ops.block_of``);
- the expert axis is a batch axis (every rank contributes tokens and
  owns experts), so an expert weight's gradient arrives summed over the
  ranks' tokens through the exchange's backward and is not all-reduced
  over that axis again (``compiler.insert_grad_sync`` leaves a
  parameter's stamped axes out, keeping the 1/n mean-loss scale).

Tokens are routed within groups of ``S_g`` tokens (the GShard G dim):
the dispatch / combine one-hots are ``[G, S_g, E, C]`` with capacity
``C = ceil(cf * k * S_g / E)``.  Per group:

    gates   = softmax(x @ Wg)                         [G, S, E] float32
    k picks = iterated argmax, the chosen column multiplied by 1 - m
    pos     = running per-(group, expert) cumsum -> slot within capacity
    disp    = sum_k keep_k * one_hot(pos_k, C)        [G, S, E, C]
    combine = sum_k gate_k * that                     [G, S, E, C]
    xe      = einsum('gsec,gsm->egcm', disp, x)       (dispatch)
    ye      = W2 act(W1 xe) per expert                (batched matmuls)
    out     = einsum('gsec,egcm->gsm', combine, ye)   (combine)

A token past its expert's capacity in its group is dropped (its combine
weight is zero: it passes through the block's residual).  The slot
one-hot is a comparison against ``arange(C)``, so a dropped slot is a
row of zeros as ``jax.nn.one_hot`` gives it (``F.one_hot`` would raise),
and the ops run on ``meta`` tensors (the stage-cut planner).

The JAX package's MoE FFN uses ``jax.nn.gelu``, whose default is the tanh
approximation; so does this port (``F.gelu(approximate="tanh")``), unlike
its other GELUs, which are erf.

``c_expert_alltoall`` is the exchange as a collective op on the port's
process groups (``collective_ops.all_to_all``): the identity when the run
has no such axis or it has size 1; otherwise an autograd function whose
backward is the other direction's exchange of the cotangent.  The bf16
tier casts around it (its backward casts the cotangent too); the int8 /
int4 tiers quantize each destination's slice padded to whole blocks,
exchange payload and scales, and dequantize with
``quantize_wire.dequantize_blockwise`` — the receive has one "peer" a
slice, which the receive-stage kernels (#11, #12) do not take, so the
exchange runs no kernel route.  Its backward is the quantized exchange of
the cotangent the other way (deterministic rounding), as the JAX
package's ``custom_vjp``."""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from . import collective_ops
from .collective_ops import _group, _ring_axis
from .quantize_wire import (CompressionSpec, dequantize_blockwise,
                            quant_spec_of, quantize_blockwise)
from .registry import register, x

_ACTS = {
    "gelu": lambda a: F.gelu(a, approximate="tanh"),
    "relu": torch.relu,
    "silu": F.silu,
    "tanh": torch.tanh,
    None: lambda a: a,
}


def _group_size(n: int, target: int = 256) -> int:
    """Largest divisor of n that is <= target (the GShard group dim)."""
    for d in range(min(n, target), 0, -1):
        if n % d == 0:
            return d
    return 1


def _one_hot(idx, n: int, dtype):
    """One-hot of integer ``idx`` over ``n`` classes in ``dtype``; an index
    outside ``[0, n)`` gives a row of zeros (``jax.nn.one_hot``)."""
    return (idx.unsqueeze(-1) ==
            torch.arange(n, device=idx.device, dtype=idx.dtype)).to(dtype)


def _route(gates, top_k: int, capacity: int):
    """Top-k routing with per-(group, expert) capacity.

    gates [G, S, E] float32 -> (dispatch [G, S, E, C], combine [G, S, E,
    C], me [E], ce [E]); me and ce feed the load-balance aux loss."""
    g, s, e = gates.shape
    remaining = gates
    masks, gvals = [], []
    for _ in range(top_k):
        idx = torch.argmax(remaining, dim=-1)                # [G, S]
        m = _one_hot(idx, e, gates.dtype)                    # [G, S, E]
        gvals.append(torch.sum(remaining * m, dim=-1))       # [G, S]
        remaining = remaining * (1.0 - m)
        masks.append(m)

    # slot of each token within its (group, expert): a running cumsum over
    # the group's tokens, earlier-k choices first (GShard section 3.2)
    dispatch = gates.new_zeros((g, s, e, capacity))
    combine = gates.new_zeros((g, s, e, capacity))
    offset = gates.new_zeros((g, 1, e))
    for m, gv in zip(masks, gvals):
        pos = torch.cumsum(m, dim=1) - m + offset            # [G, S, E]
        offset = offset + torch.sum(m, dim=1, keepdim=True)
        keep = m * (pos < capacity).to(m.dtype)              # [G, S, E]
        slot = _one_hot(torch.sum(pos * m, dim=-1).to(torch.int32),
                        capacity, gates.dtype)               # [G, S, C]
        hot = (keep[..., None] * slot[:, :, None, :]).detach()
        dispatch = dispatch + hot
        combine = combine + gv[..., None, None] * hot

    me = torch.mean(gates, dim=(0, 1))                       # softmax mass
    ce = torch.mean(masks[0], dim=(0, 1))                    # top-1 traffic
    return dispatch, combine, me, ce


def _dims(n: int, e: int, top_k: int, cf: float, group_size: int, what):
    """(group size, groups, capacity) of ``n`` tokens over ``e`` experts."""
    sg = int(group_size) or _group_size(n)
    if n % sg:
        raise ValueError(f"{what}: group_size {sg} does not divide token "
                         f"count {n}")
    return sg, n // sg, max(1, int(math.ceil(cf * top_k * sg / e)))


def _gates(xg, gate_w):
    return torch.softmax(torch.einsum(
        "gsm,me->gse", xg.to(torch.float32), gate_w.to(torch.float32)),
        dim=-1)


def _expert_ffn(xe, w1, w2, b1, b2, act):
    h = torch.matmul(xe, w1)                       # esm,emh->esh
    if b1 is not None:
        h = h + b1[:, None, :]
    h = _ACTS[act](h)
    ye = torch.matmul(h, w2)                       # esh,ehm->esm
    if b2 is not None:
        ye = ye + b2[:, None, :]
    return ye


def moe_ffn_fn(xf, gate_w, w1, w2, b1=None, b2=None, *, top_k=2,
               capacity_factor=1.25, act="gelu", group=None,
               group_size=0):
    """Functional MoE FFN on flattened tokens xf [N, M].

    w1 / w2 hold the LOCAL experts [E_local, ...]; ``group`` is the expert
    axis's process group (None: one rank), so the global expert count is
    E_local * its size.  Returns (out [N, M], aux_loss scalar)."""
    n, m = xf.shape
    e_local = int(w1.shape[0])
    ep = group.world if group is not None else 1
    e = e_local * ep
    sg, g, capacity = _dims(n, e, top_k, capacity_factor, group_size,
                            "moe_ffn")
    xg = xf.reshape(g, sg, m)
    gates = _gates(xg, gate_w)
    dispatch, combine, me, ce = _route(gates, top_k, capacity)
    aux = e * torch.sum(me * ce)
    xe = torch.einsum("gsec,gsm->egcm", dispatch.to(xf.dtype), xg)
    xe = xe.reshape(e, g * capacity, m)
    if ep > 1:
        # the same flat order as the fused JAX function's exchange
        xe = ExpertExchange.apply(xe, group, "dispatch", None)
    ye = _expert_ffn(xe, w1, w2, b1, b2, act)
    if ep > 1:
        ye = ExpertExchange.apply(ye, group, "combine", None)
    ye = ye.reshape(e, g, capacity, m)
    out = torch.einsum("gsec,egcm->gsm", combine.to(ye.dtype), ye)
    return out.reshape(n, m).to(xf.dtype), aux.to(torch.float32)


def _moe_static_dims(x_shape, num_experts, top_k, capacity_factor,
                     group_size):
    """Static (N, G, S_g, C) for declared shapes; -1 where the token count
    is unknown (dynamic leading dims).  Mirrors the runtime arithmetic of
    ``moe_dispatch``."""
    lead = [int(d) for d in x_shape[:-1]]
    if lead and all(d > 0 for d in lead):
        n = 1
        for d in lead:
            n *= d
    else:
        n = -1
    e = int(num_experts)
    if n > 0:
        sg = int(group_size) or _group_size(n)
        g = n // sg if n % sg == 0 else -1
    else:
        sg = int(group_size) or -1
        g = -1
    if sg > 0:
        c = max(1, int(math.ceil(
            float(capacity_factor) * int(top_k) * sg / e)))
    else:
        c = -1
    return n, g, sg, c


# ---------------------------------------------------------------------------
# the decomposed pipeline: dispatch -> c_expert_alltoall -> expert FFN ->
# c_expert_alltoall -> combine
# ---------------------------------------------------------------------------


@register("moe_dispatch")
def _moe_dispatch(ctx, ins, attrs):
    """Route tokens into per-expert blocks.  Xe is dest-major ([E_global,
    G*C, M]) so a leading-dim reshape is the per-destination split the
    expert exchange needs."""
    a = x(ins, "X")
    gate_w = x(ins, "GateW")
    e = int(attrs["num_experts"])
    top_k = int(attrs.get("top_k", 2))
    m = a.shape[-1]
    xf = a.reshape(-1, m)
    sg, g, capacity = _dims(xf.shape[0], e, top_k,
                            float(attrs.get("capacity_factor", 1.25)),
                            attrs.get("group_size", 0), "moe_dispatch")
    xg = xf.reshape(g, sg, m)
    gates = _gates(xg, gate_w)
    dispatch, combine, me, ce = _route(gates, top_k, capacity)
    aux = e * torch.sum(me * ce)
    xe = torch.einsum("gsec,gsm->egcm", dispatch.to(a.dtype), xg)
    return {"Xe": xe.reshape(e, g * capacity, m),
            "Combine": combine.to(torch.float32),
            "AuxLoss": aux.to(torch.float32)}


def _exchange(g, arr, direction: str):
    """The expert all-to-all on a dest-major [E, B, M] block tensor over
    the group ``g`` of n ranks.

    dispatch: [E_global, b, m] -> [E/n, n*b, m] (each rank keeps its E/n
    experts and receives every peer's token block for them); combine is
    its inverse, so the backward of one direction is the other direction
    applied to the cotangent."""
    n = g.world
    if direction == "combine":
        e_l, bb, m = arr.shape
        parts = arr.reshape(e_l, n, bb // n, m).transpose(0, 1)
        recv = collective_ops.all_to_all(g, parts.contiguous())
        return recv.reshape(n * e_l, bb // n, m)
    e, b, m = arr.shape
    recv = collective_ops.all_to_all(g, arr.reshape(n, e // n, b, m))
    return recv.transpose(0, 1).reshape(e // n, n * b, m)


def _quant_exchange(g, arr, direction: str, spec: CompressionSpec):
    """The blockwise-quantized expert exchange: each destination's slice
    padded to whole blocks (per slice, so no row straddles a block after
    the exchange), quantized (payload + float32 scales, round to nearest
    even), payload and scales each in one all-to-all, and the receive
    dequantized by the composition (one peer a slice)."""
    n = g.world
    orig = arr.dtype
    if direction == "combine":
        e_l, bb, m = arr.shape
        parts = arr.reshape(e_l, n, bb // n, m).transpose(0, 1)
        recv_shape = (n, e_l, bb // n, m)
    else:
        e, b, m = arr.shape
        parts = arr.reshape(n, e // n, b, m)
        recv_shape = (n, e // n, b, m)
    pf = parts.reshape(n, -1).to(torch.float32)
    slice_numel = pf.shape[1]
    bs = spec.block_size
    k = -(-slice_numel // bs)                  # blocks a destination slice
    pad = k * bs - slice_numel
    if pad:
        pf = F.pad(pf, (0, pad))
    q, s = quantize_blockwise(pf.reshape(-1), spec)
    qx = collective_ops.all_to_all(g, q.reshape(n, k, -1))
    sx = collective_ops.all_to_all(g, s.reshape(n, k))
    full = dequantize_blockwise(qx.reshape(n * k, -1), sx.reshape(-1), spec)
    full = full.reshape(n, k * bs)
    if pad:
        full = full[:, :slice_numel]
    recv = full.reshape(recv_shape)
    if direction == "combine":
        out = recv.reshape(n * recv_shape[1], recv_shape[2], recv_shape[3])
    else:
        out = recv.transpose(0, 1).reshape(recv_shape[1], n * recv_shape[2],
                                           recv_shape[3])
    return out.to(orig)


_OTHER = {"dispatch": "combine", "combine": "dispatch"}


class ExpertExchange(torch.autograd.Function):
    """The expert exchange over a group, float (``spec`` None) or
    quantized (int8 / int4); the backward exchanges the cotangent in the
    other direction, at the same tier."""

    @staticmethod
    def forward(ctx, a, group, direction, spec):
        ctx.group, ctx.direction, ctx.spec = group, direction, spec
        return _run_exchange(group, a, direction, spec)

    @staticmethod
    def backward(ctx, grad):
        return (_run_exchange(ctx.group, grad.contiguous(),
                              _OTHER[ctx.direction], ctx.spec),
                None, None, None)


def _run_exchange(group, a, direction, spec):
    if spec is None:
        return _exchange(group, a, direction)
    return _quant_exchange(group, a, direction, spec)


@register("c_expert_alltoall")
def _c_expert_alltoall(ctx, ins, attrs):
    """The expert exchange as a collective op: the identity when the run
    has no such axis (one rank running an ep-stamped program) or it has
    one rank.  ``direction`` in {dispatch, combine}; a ``quant_spec``
    attr picks the wire tier (bf16: a cast around it; int8 / int4:
    blockwise payload + scales)."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs)
    if axis is None:
        return {"Out": a}
    g = _group(ctx, axis)
    if g.world <= 1:
        return {"Out": a}
    direction = attrs.get("direction", "dispatch")
    spec = quant_spec_of(attrs)
    if spec is not None and a.is_floating_point():
        if spec.dtype == "bfloat16":
            out = ExpertExchange.apply(a.to(torch.bfloat16), g, direction,
                                       None)
            return {"Out": out.to(a.dtype)}
        return {"Out": ExpertExchange.apply(a, g, direction, spec)}
    return {"Out": ExpertExchange.apply(a, g, direction, None)}


@register("moe_expert_ffn")
def _moe_expert_ffn(ctx, ins, attrs):
    """The per-expert FFN on dispatched blocks [E_local, B, M]: two
    batched matmuls."""
    return {"Out": _expert_ffn(x(ins, "Xe"), x(ins, "W1"), x(ins, "W2"),
                               x(ins, "B1"), x(ins, "B2"),
                               attrs.get("act", "gelu"))}


@register("moe_combine")
def _moe_combine(ctx, ins, attrs):
    """The weighted un-route of the expert outputs back to token order.
    X is the shape / dtype reference only."""
    ye = x(ins, "Ye")
    comb = x(ins, "Combine")
    ref = x(ins, "X")
    g, _, e, c = comb.shape
    ye = ye.reshape(e, g, c, ye.shape[-1])
    out = torch.einsum("gsec,egcm->gsm", comb.to(ye.dtype), ye)
    return {"Out": out.reshape(ref.shape).to(ref.dtype)}


@register("moe_ffn")
def _moe_ffn(ctx, ins, attrs):
    """The fused MoE FFN (one op, the exchange inside it over
    ``_axis_name`` when the run has that axis)."""
    a = x(ins, "X")
    axis = _ring_axis(ctx, attrs) if attrs.get("_axis_name") else None
    group = _group(ctx, axis) if axis is not None else None
    shape = a.shape
    out, aux = moe_ffn_fn(
        a.reshape(-1, shape[-1]), x(ins, "GateW"), x(ins, "W1"),
        x(ins, "W2"), x(ins, "B1"), x(ins, "B2"),
        top_k=int(attrs.get("top_k", 2)),
        capacity_factor=float(attrs.get("capacity_factor", 1.25)),
        act=attrs.get("act", "gelu"), group=group,
        group_size=int(attrs.get("group_size", 0)))
    return {"Out": out.reshape(shape), "AuxLoss": aux}
