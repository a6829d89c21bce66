"""Mixture-of-Experts layer API — the port of paddle_tpu/parallel/moe.py:
expert parallelism over a mesh axis, in the GShard layout (experts
sharded over an axis that also shards the batch: every rank contributes
tokens and owns E/ep experts; the token exchange is one
``c_expert_alltoall`` each way; the routing math is dense einsums,
``ops/moe_ops.py``).

The layer emits the decomposed pipeline

    moe_dispatch -> [c_expert_alltoall] -> moe_expert_ffn
                 -> [c_expert_alltoall] -> moe_combine

with the exchange ops only when ``ep > 1``: a dense build carries no
collective, and :func:`apply_expert_sharding` retrofits the exchange for
any expert degree.  Usage::

    out, aux = parallel.moe_ffn(x, num_experts=8, ffn_hidden=256,
                                ep_degree=4, axis_name="ep")
    loss = task_loss + 0.01 * aux
"""

from __future__ import annotations

import copy
from typing import Any, Dict, Optional, Tuple

from ..framework.core import Variable, grad_var_name
from ..framework.layer_helper import LayerHelper, ParamAttr
from ..framework.mesh_layout import MeshLayout, ShardSpec

EXCHANGE_SUFFIX = "@ep_exch"


def _quant_attr(quant_spec):
    """A CompressionSpec | dict | dtype string in the plain-dict attr form
    collective ops carry (None passes through)."""
    if quant_spec is None:
        return None
    from ..ops.quantize_wire import CompressionSpec
    return CompressionSpec.from_attr(quant_spec).to_attr()


def moe_ffn(x: Variable, num_experts: int, ffn_hidden: int,
            top_k: int = 2, capacity_factor: float = 1.25,
            ep_degree: Optional[int] = None, axis_name: str = "ep",
            act: str = "gelu", group_size: int = 0, param_attr=None,
            bias_attr=None, quant_spec=None,
            name: Optional[str] = None) -> Tuple[Variable, Variable]:
    """MoE feed-forward block: each token goes to its top-k of
    ``num_experts`` expert FFNs (M -> ffn_hidden -> M).

    With ``ep_degree`` > 1 the expert dim of the expert weights is sharded
    over ``axis_name`` (``dist_attr``: each rank holds its block) and a
    ``c_expert_alltoall`` pair moves the token blocks to their owners and
    back, optionally wire-compressed by ``quant_spec`` (the bf16 / int8 /
    int4 CompressionSpec tiers).  Returns ``(out, aux_loss)``: add
    ``aux_weight * aux_loss`` to the training loss (the
    Switch-Transformer load-balance term)."""
    ep = int(ep_degree or 1)
    if num_experts % ep:
        raise ValueError(
            f"num_experts {num_experts} not divisible by ep degree {ep}")
    helper = LayerHelper(name or "moe_ffn", name=name)
    m = int(x.shape[-1])

    def _sub(attr, suffix):
        """One shared param_attr names several parameters: suffix each."""
        a = ParamAttr._to_attr(attr)
        if a and getattr(a, "name", None):
            a = copy.copy(a)
            a.name = f"{a.name}_{suffix}"
        return a

    gate_w = helper.create_parameter(_sub(param_attr, "gate"),
                                     [m, num_experts], x.dtype)
    w1 = helper.create_parameter(_sub(param_attr, "w1"),
                                 [num_experts, m, ffn_hidden], x.dtype)
    w2 = helper.create_parameter(_sub(param_attr, "w2"),
                                 [num_experts, ffn_hidden, m], x.dtype)
    if ep > 1:
        # the expert dim sharded; the gradients arrive summed through the
        # exchange's backward (the grad sync leaves this axis out but keeps
        # the 1/n mean-loss scale)
        w1.dist_attr = ShardSpec((axis_name, None, None))
        w2.dist_attr = ShardSpec((axis_name, None, None))
    ffn_inputs: Dict[str, list] = {"W1": [w1], "W2": [w2]}
    if bias_attr is not False:
        b1 = helper.create_parameter(_sub(bias_attr, "b1"),
                                     [num_experts, ffn_hidden], x.dtype,
                                     is_bias=True)
        b2 = helper.create_parameter(_sub(bias_attr, "b2"),
                                     [num_experts, m], x.dtype, is_bias=True)
        if ep > 1:
            b1.dist_attr = ShardSpec((axis_name, None))
            b2.dist_attr = ShardSpec((axis_name, None))
        ffn_inputs["B1"], ffn_inputs["B2"] = [b1], [b2]

    from ..ops.moe_ops import _moe_static_dims
    _, g, sg, cap = _moe_static_dims(x.shape, num_experts, top_k,
                                     capacity_factor, group_size)
    gc = g * cap if (g > 0 and cap > 0) else -1

    xe = helper.create_variable_for_type_inference(
        x.dtype, [num_experts, gc, m])
    comb = helper.create_variable_for_type_inference(
        "float32", [g, sg, num_experts, cap])
    aux = helper.create_variable_for_type_inference("float32", ())
    helper.append_op(
        type="moe_dispatch", inputs={"X": [x], "GateW": [gate_w]},
        outputs={"Xe": [xe], "Combine": [comb], "AuxLoss": [aux]},
        attrs={"num_experts": num_experts, "top_k": top_k,
               "capacity_factor": capacity_factor,
               "group_size": group_size})

    qattr = _quant_attr(quant_spec)
    cur = xe
    if ep > 1:
        ex = helper.create_variable_for_type_inference(
            x.dtype, [num_experts, gc, m])
        helper.append_op(
            type="c_expert_alltoall", inputs={"X": [cur]},
            outputs={"Out": [ex]},
            attrs={"ring_id": 0, "_axis_name": axis_name,
                   "direction": "dispatch", "quant_spec": qattr})
        cur = ex

    ye = helper.create_variable_for_type_inference(
        x.dtype, [num_experts, gc, m])
    helper.append_op(
        type="moe_expert_ffn", inputs=dict(ffn_inputs, Xe=[cur]),
        outputs={"Out": [ye]}, attrs={"act": act})

    cur = ye
    if ep > 1:
        ex = helper.create_variable_for_type_inference(
            x.dtype, [num_experts, gc, m])
        helper.append_op(
            type="c_expert_alltoall", inputs={"X": [cur]},
            outputs={"Out": [ex]},
            attrs={"ring_id": 0, "_axis_name": axis_name,
                   "direction": "combine", "quant_spec": qattr})
        cur = ex

    out = helper.create_variable_for_type_inference(x.dtype, x.shape)
    helper.append_op(
        type="moe_combine",
        inputs={"Ye": [cur], "Combine": [comb], "X": [x]},
        outputs={"Out": [out]}, attrs={})
    # recorded on the program being built, so a model builder folds every
    # routed block's balance term into its loss
    collect_aux_losses(helper.main_program, peek=True).append(aux)
    return out, aux


def collect_aux_losses(program, peek: bool = False):
    """Every MoE aux-loss Variable recorded while building ``program``.

    By default it DRAINS the list (a loss builder consumes the terms
    once); ``peek=True`` returns the live list without clearing it."""
    lst = program.__dict__.setdefault("_moe_aux_losses", [])
    if peek:
        return lst
    out = list(lst)
    lst.clear()
    return out


def _expert_spec(axis: str, rank: int) -> ShardSpec:
    """The dim-0 (expert dim) shard spec of a tensor of ``rank`` dims."""
    return ShardSpec((axis,) + (None,) * (rank - 1) if rank else (axis,))


def apply_expert_sharding(program, layout: MeshLayout,
                          quant_spec=None) -> Dict[str, Any]:
    """Rewrite a DENSE-built MoE ``program`` in place for expert
    parallelism over ``layout``'s expert axis: the ``c_expert_alltoall``
    pair inserted around every ``moe_expert_ffn``, and the expert-dim
    parameters (their gradients and the optimizer accumulators shaped
    like them) stamped with the expert axis's ShardSpec.  Idempotent; call
    it BEFORE ``apply_fsdp_sharding`` (ZeRO-3 then skips the expert
    weights) and before ``CompiledProgram.with_mesh`` (whose gradient sync
    leaves the expert axis out of their reduction).

    Returns the report: the exchanges inserted, the parameters stamped
    and the skip census.  A global-norm clip over the stamped gradients
    sums their squares over the expert axis before the root
    (``clip.shard_global_norm``): every rank clips by the norm of the
    whole gradient (the JAX package clips each device by its own
    blocks)."""
    ep = layout.expert
    axis = layout.expert_axis
    report: Dict[str, Any] = {"expert_axis": axis, "expert_degree": ep,
                              "rewritten": [], "stamped": [],
                              "skipped": []}
    if ep <= 1:
        return report
    block = program.global_block()
    if any(op.type == "c_expert_alltoall" for op in block.ops):
        report["skipped"].append(("<program>", "already-expert-sharded"))
        return report
    qattr = _quant_attr(quant_spec)
    bw_idx = next((i for i, op in enumerate(block.ops)
                   if op.type == "backward"), None)

    ffn_sites = [i for i, op in enumerate(block.ops)
                 if op.type == "moe_expert_ffn"]
    if not ffn_sites:
        report["skipped"].append(("<program>", "no-moe-ops"))
        return report

    from ..framework.fsdp import _rename_inputs

    # descending order: each insertion leaves the earlier indices valid
    for i in reversed(ffn_sites):
        op = block.ops[i]
        xe_name = op.inputs["Xe"][0]
        ye_name = op.outputs["Out"][0]
        w1_name = op.inputs["W1"][0]
        w1 = block.vars[w1_name]
        e = int(w1.shape[0])
        if e % ep:
            raise ValueError(
                f"apply_expert_sharding: num_experts {e} of {w1_name} "
                f"not divisible by expert degree {ep}")
        xe_var = block.vars[xe_name]
        ye_var = block.vars[ye_name]
        disp = block.create_var(name=xe_name + EXCHANGE_SUFFIX,
                                shape=tuple(xe_var.shape),
                                dtype=xe_var.dtype)
        comb = block.create_var(name=ye_name + EXCHANGE_SUFFIX,
                                shape=tuple(ye_var.shape),
                                dtype=ye_var.dtype)
        # the combine-side exchange first (index i + 1, before the
        # dispatch insertion shifts it); every later reader of the expert
        # output reads the exchanged (global expert order) tensor
        for later in block.ops[i + 1:]:
            _rename_inputs(later, ye_name, comb.name)
        block._insert_op(
            i + 1, type="c_expert_alltoall",
            inputs={"X": [ye_name]}, outputs={"Out": [comb.name]},
            attrs={"ring_id": 0, "_axis_name": axis,
                   "direction": "combine", "quant_spec": qattr})
        block._insert_op(
            i, type="c_expert_alltoall",
            inputs={"X": [xe_name]}, outputs={"Out": [disp.name]},
            attrs={"ring_id": 0, "_axis_name": axis,
                   "direction": "dispatch", "quant_spec": qattr})
        _rename_inputs(block.ops[i + 1], xe_name, disp.name)
        report["rewritten"].append(
            {"ffn": ye_name, "num_experts": e, "dispatch": disp.name,
             "combine": comb.name})

        # stamp the expert-dim weights (+ gradient + coupled
        # accumulators): the gradients arrive summed through the
        # exchange's backward, so the grad sync skips this axis
        for slot in ("W1", "W2", "B1", "B2"):
            names = op.inputs.get(slot) or []
            if not names:
                continue
            p = block.vars.get(names[0])
            if p is None:
                continue
            if getattr(p, "dist_attr", None):
                report["skipped"].append((p.name, "already-sharded"))
                continue
            spec = _expert_spec(axis, len(p.shape))
            p.dist_attr = spec
            g = block.vars.get(grad_var_name(p.name))
            if g is not None:
                g.dist_attr = spec
            if bw_idx is not None:
                coupled = {p.name, grad_var_name(p.name)}
                for uop in block.ops[bw_idx:]:
                    names2 = set(uop.input_names()) | \
                        set(uop.output_names())
                    if not (names2 & coupled):
                        continue
                    for n in names2:
                        v = block._find_var_recursive(n)
                        if v is None or not v.persistable or \
                                n == p.name:
                            continue
                        if tuple(v.shape) == tuple(p.shape) and \
                                not getattr(v, "dist_attr", None):
                            v.dist_attr = spec
            report["stamped"].append(p.name)
    # a global-norm clip reads each rank's blocks of the expert gradients:
    # their squares are summed over the expert axis before the root
    from ..clip import shard_global_norm
    shard_global_norm(block)
    program._bump_version()
    return report
