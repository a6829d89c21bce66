"""Program-level optimization passes — the port of
paddle_tpu/framework/passes.py (ref: framework/ir/ fusion passes and the
inference pass pipeline).

Passes rewrite the Program's op list in place.  ``INFERENCE_PASSES`` keeps
the JAX package's order.  The passes that match BERT are ported in full;
``conv_bn_fuse``, ``conv_affine_channel_fuse`` and ``fuse_bn_act`` are
registered as no-ops until the convolution ops are ported (ROADMAP.md,
Queue 1), so the pipeline stays the same list in both packages."""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

from .core import Program

PASSES: Dict[str, Callable] = {}


def register_pass(name: str):
    def deco(fn):
        PASSES[name] = fn
        return fn
    return deco


def apply_pass(program: Program, name: str, **kwargs) -> Program:
    """Apply one pass in place."""
    PASSES[name](program, **kwargs)
    program._bump_version()
    return program


class PassBuilder:
    """Ordered pass pipeline (ref: framework/ir/pass_builder.h)."""

    #: default inference pipeline: fusions first, folds, DCE last
    INFERENCE_PASSES = ["conv_bn_fuse", "conv_affine_channel_fuse",
                        "embedding_eltwise_layernorm_fuse",
                        "fuse_elemwise_add_act", "fuse_bn_act",
                        "fuse_add_layernorm", "multihead_matmul_fuse",
                        "fc_fuse", "transpose_matmul_fold",
                        "fold_identity_ops", "cast_elimination",
                        "dead_code_elimination"]

    def __init__(self, passes: Optional[Sequence[str]] = None):
        self._passes: List[str] = list(
            passes if passes is not None else self.INFERENCE_PASSES)

    def all_passes(self) -> List[str]:
        return list(self._passes)

    def append_pass(self, name: str):
        self._passes.append(name)
        return self

    def delete_pass(self, name: str):
        self._passes = [p for p in self._passes if p != name]
        return self

    def apply(self, program: Program, **kwargs) -> Program:
        for name in self._passes:
            apply_pass(program, name, **kwargs)
        return program


# ---------------------------------------------------------------------------
# helpers — pattern matching on a flat op list
# ---------------------------------------------------------------------------


def _use_counts(block, keep_names=()):
    """name → number of consuming ops; fetched/kept names get +1."""
    uses: Dict[str, int] = {}
    for op in block.ops:
        for n in op.input_names():
            uses[n] = uses.get(n, 0) + 1
        for attr in op.attrs.values():
            # sub-block closures (control flow) capture outer vars
            if hasattr(attr, "ops"):
                for sub in attr.ops:
                    for n in sub.input_names():
                        uses[n] = uses.get(n, 0) + 1
    for n in keep_names:
        uses[n] = uses.get(n, 0) + 1
    return uses


def _consumed_in_subblock(block, name):
    """True when a control-flow op's sub-block closure reads ``name``."""
    for op in block.ops:
        for attr in op.attrs.values():
            if hasattr(attr, "ops"):
                for sub in attr.ops:
                    if name in sub.input_names():
                        return True
    return False


def _single_use_chain(block, i, uses, next_types, out_name=None):
    """If op i's output (first, or ``out_name``) feeds exactly one consumer
    whose type is in ``next_types``, return (consumer_index, consumer)."""
    op = block.ops[i]
    if out_name is None:
        outs = op.output_names()
        if not outs:
            return None
        out = outs[0]
    else:
        out = out_name
    if uses.get(out, 0) != 1:
        return None
    for j in range(i + 1, len(block.ops)):
        nxt = block.ops[j]
        if out in nxt.input_names():
            return (j, nxt) if nxt.type in next_types else None
    return None


def _drop(block, drop):
    block.ops[:] = [op for k, op in enumerate(block.ops) if k not in drop]


# ---------------------------------------------------------------------------
# passes
# ---------------------------------------------------------------------------


@register_pass("conv_bn_fuse")
@register_pass("conv_affine_channel_fuse")
@register_pass("fuse_bn_act")
def _not_ported_yet(program: Program, **_):
    """Convolution/batch-norm fusions: no-ops until those ops are ported
    (ROADMAP.md Queue 1); they cannot match a program the port runs."""


@register_pass("dead_code_elimination")
def dead_code_elimination(program: Program, fetch_names=(), **_):
    """Remove ops none of whose outputs are consumed, fetched, or
    persistable."""
    for block in program.blocks:
        changed = True
        while changed:
            changed = False
            persist = {name for name, v in block.vars.items()
                       if getattr(v, "persistable", False)}
            uses = _use_counts(block, keep_names=fetch_names)
            kept = []
            for op in block.ops:
                outs = op.output_names()
                live = (not outs  # side-effect-only ops stay
                        or any(uses.get(n, 0) > 0 or n in persist
                               for n in outs)
                        or op.type in ("backward", "fetch", "feed",
                                       "pipeline"))
                if live:
                    kept.append(op)
                else:
                    changed = True
            block.ops[:] = kept


_FUSABLE_ACTS = ("relu", "sigmoid", "tanh", "gelu")


@register_pass("fuse_elemwise_add_act")
def fuse_elemwise_add_act(program: Program, fetch_names=(), **_):
    """elementwise_add → act  ⇒  fused_elemwise_activation
    (ref: framework/ir/fuse_elewise_add_act_pass.cc)."""
    for block in program.blocks:
        uses = _use_counts(block, keep_names=fetch_names)
        drop = set()
        for i, op in enumerate(block.ops):
            if op.type != "elementwise_add" or i in drop:
                continue
            hit = _single_use_chain(block, i, uses, _FUSABLE_ACTS)
            if hit is None:
                continue
            j, act = hit
            op.type = "fused_elemwise_activation"
            op.attrs["functor_list"] = ["elementwise_add", act.type]
            op.outputs = {"Out": list(act.outputs.values())[0]}
            drop.add(j)
        _drop(block, drop)


@register_pass("fold_identity_ops")
def fold_identity_ops(program: Program, fetch_names=(), **_):
    """Remove no-op scales (scale=1, bias=0) and fold consecutive scale
    ops into one."""
    fetch = set(fetch_names)
    for block in program.blocks:
        uses = _use_counts(block, keep_names=fetch_names)
        drop = set()
        for i, op in enumerate(block.ops):
            if op.type != "scale" or i in drop:
                continue
            if op.attrs.get("bias", 0.0) != 0.0:
                continue
            hit = _single_use_chain(block, i, uses, ("scale",))
            if hit is None:
                continue
            j, nxt = hit
            # s2·(s1·x)+b2 folds only when nxt applies its bias after
            # scaling
            if nxt.attrs.get("bias_after_scale", True) is False and \
                    float(nxt.attrs.get("bias", 0.0)) != 0.0:
                continue
            nxt.attrs["scale"] = float(nxt.attrs.get("scale", 1.0)) * \
                float(op.attrs.get("scale", 1.0))
            nxt.inputs = {"X": list(op.inputs["X"])}
            drop.add(i)
        _drop(block, drop)
        # rewrite identity scales to pass-through by aliasing consumers
        drop = set()
        for i, op in enumerate(block.ops):
            if op.type != "scale":
                continue
            if float(op.attrs.get("scale", 1.0)) != 1.0 or \
                    float(op.attrs.get("bias", 0.0)) != 0.0 or \
                    op.attrs.get("bias_after_scale", True) is False:
                continue
            src = op.inputs["X"][0]
            dst = op.output_names()[0]
            if dst in fetch or _consumed_in_subblock(block, dst):
                continue
            for later in block.ops[i + 1:]:
                later.inputs = {k: [src if n == dst else n for n in v]
                                for k, v in later.inputs.items()}
            drop.add(i)
        _drop(block, drop)


@register_pass("cast_elimination")
def cast_elimination(program: Program, fetch_names=(), **_):
    """Drop casts whose target dtype equals the source var's dtype."""
    fetch = set(fetch_names)
    for block in program.blocks:
        drop = set()
        for i, op in enumerate(block.ops):
            if op.type != "cast":
                continue
            src = op.inputs.get("X", [None])[0]
            dst = op.output_names()[0]
            v = block._find_var_recursive(src)
            if v is None or dst in fetch or \
                    _consumed_in_subblock(block, dst):
                continue
            if str(v.dtype) != str(op.attrs.get("out_dtype", "")):
                continue
            for later in block.ops[i + 1:]:
                later.inputs = {k: [src if n == dst else n for n in vs]
                                for k, vs in later.inputs.items()}
            drop.add(i)
        _drop(block, drop)


@register_pass("transpose_matmul_fold")
def transpose_matmul_fold(program: Program, fetch_names=(), **_):
    """transpose2 (last two dims) feeding a matmul operand folds into the
    matmul's transpose_X/transpose_Y attr."""
    for block in program.blocks:
        uses = _use_counts(block, keep_names=fetch_names)
        drop = set()
        for i, op in enumerate(block.ops):
            if op.type != "transpose2" or i in drop:
                continue
            perm = list(op.attrs.get("axis", ()))
            nd = len(perm)
            if nd < 2 or perm[:-2] != list(range(nd - 2)) or \
                    perm[-2:] != [nd - 1, nd - 2]:
                continue
            out = op.outputs.get("Out", [None])[0]
            if uses.get(out, 0) != 1:
                continue
            hit = _single_use_chain(block, i, uses,
                                    ("matmul", "matmul_v2"), out_name=out)
            if hit is None:
                continue
            j, mm = hit
            tx, ty = ("transpose_X", "transpose_Y") \
                if mm.type == "matmul" else ("trans_x", "trans_y")
            src = op.inputs["X"][0]
            if mm.inputs.get("X", [None])[0] == out:
                if mm.attrs.get(tx, False):
                    continue
                mm.attrs[tx] = True
                mm.inputs["X"] = [src]
            elif mm.inputs.get("Y", [None])[0] == out:
                if mm.attrs.get(ty, False):
                    continue
                mm.attrs[ty] = True
                mm.inputs["Y"] = [src]
            else:
                continue
            drop.add(i)
        _drop(block, drop)


@register_pass("fuse_add_layernorm")
def fuse_add_layernorm(program: Program, fetch_names=(), **_):
    """elementwise_add (residual) → layer_norm  ⇒  fused_add_layernorm,
    which routes onto the add+LayerNorm kernel."""
    for block in program.blocks:
        uses = _use_counts(block, keep_names=fetch_names)
        drop = set()
        for i, op in enumerate(block.ops):
            if op.type != "elementwise_add" or i in drop:
                continue
            if op.attrs.get("axis", -1) not in (-1, 0):
                continue
            hit = _single_use_chain(block, i, uses, ("layer_norm",))
            if hit is None:
                continue
            j, ln = hit
            # the fused kernel produces Y only — Mean/Variance consumers
            # would silently read zeros
            aux = [n for slot in ("Mean", "Variance")
                   for n in ln.outputs.get(slot, ())]
            if any(uses.get(n, 0) > 0 for n in aux) or \
                    any(n in set(fetch_names) for n in aux):
                continue
            a = op.inputs.get("X", [None])[0]
            b = op.inputs.get("Y", [None])[0]
            av = block._find_var_recursive(a)
            bv = block._find_var_recursive(b)
            if av is None or bv is None or \
                    tuple(av.shape) != tuple(bv.shape):
                continue  # residual adds are same-shape; skip broadcasts
            ln.type = "fused_add_layernorm"
            ln.inputs = dict(ln.inputs)
            ln.inputs["X"] = [a]
            ln.inputs["Residual"] = [b]
            drop.add(i)
        _drop(block, drop)


@register_pass("multihead_matmul_fuse")
def multihead_matmul_fuse(program: Program, fetch_names=(), **_):
    """matmul(Q,K,transpose_Y) [→scale] [→add bias] → softmax [→dropout]
    → matmul(·,V)  ⇒  one ``multihead_matmul`` op on the flash kernel
    (ref: framework/ir/multihead_matmul_fuse_pass.cc)."""
    for block in program.blocks:
        uses = _use_counts(block, keep_names=fetch_names)
        drop = set()
        for i, op in enumerate(block.ops):
            if op.type != "matmul" or i in drop:
                continue
            if not op.attrs.get("transpose_Y", False) \
                    or op.attrs.get("transpose_X", False):
                continue
            alpha = float(op.attrs.get("alpha", 1.0))
            chain = [i]
            bias_name = None
            cur = i
            hit = _single_use_chain(block, cur, uses, ("scale",))
            if hit is not None:
                j, sc = hit
                if sc.attrs.get("bias", 0.0) == 0.0:
                    alpha *= float(sc.attrs.get("scale", 1.0))
                    chain.append(j)
                    cur = j
            hit = _single_use_chain(block, cur, uses, ("elementwise_add",))
            if hit is not None:
                j, add = hit
                prev_out = block.ops[cur].output_names()[0]
                xs, ys = add.inputs.get("X", []), add.inputs.get("Y", [])
                bias_name = ys[0] if xs and xs[0] == prev_out else xs[0]
                chain.append(j)
                cur = j
            hit = _single_use_chain(block, cur, uses, ("softmax",))
            if hit is None:
                continue
            chain.append(hit[0])
            cur = hit[0]
            dropout_rate = 0.0
            dropout_impl = "downgrade_in_infer"
            is_test = op.attrs.get("is_test", False)
            hit2 = _single_use_chain(block, cur, uses, ("dropout",))
            if hit2 is not None:
                dattrs = block.ops[hit2[0]].attrs
                dropout_rate = float(dattrs.get("dropout_prob", 0.0))
                dropout_impl = dattrs.get("dropout_implementation",
                                          "downgrade_in_infer")
                is_test = is_test or dattrs.get("is_test", False)
                chain.append(hit2[0])
                cur = hit2[0]
            hit = _single_use_chain(block, cur, uses, ("matmul",))
            if hit is None:
                continue
            j, mm2 = hit
            if mm2.attrs.get("transpose_X", False) \
                    or mm2.attrs.get("transpose_Y", False):
                continue
            # probs must be the X operand of the context matmul
            probs_name = block.ops[cur].output_names()[0]
            if mm2.inputs.get("X", [None])[0] != probs_name:
                continue
            chain.append(j)
            q_name = op.inputs["X"][0]
            k_name = op.inputs["Y"][0]
            v_name = mm2.inputs["Y"][0]
            qv = block._find_var_recursive(q_name)
            if qv is not None and qv.shape is not None \
                    and len(qv.shape) != 4:
                continue  # only head-split [B,H,S,D] operands
            inputs = {"Q": [q_name], "K": [k_name], "V": [v_name]}
            if bias_name is not None:
                inputs["BiasQK"] = [bias_name]
            op.type = "multihead_matmul"
            op.inputs = {k: list(v) for k, v in inputs.items()}
            op.outputs = {"Out": list(mm2.outputs["Out"])}
            op.attrs = {"alpha": alpha, "dropout_rate": dropout_rate,
                        "dropout_implementation": dropout_impl,
                        "is_test": is_test}
            drop.update(chain[1:])
        _drop(block, drop)


@register_pass("fc_fuse")
def fc_fuse(program: Program, fetch_names=(), **_):
    """mul → elementwise_add(1-D bias) [→ relu]  ⇒  one ``fc`` op
    (ref: framework/ir/fc_fuse_pass.cc)."""
    for block in program.blocks:
        uses = _use_counts(block, keep_names=fetch_names)
        drop = set()
        for i, op in enumerate(block.ops):
            if op.type != "mul" or i in drop:
                continue
            if op.attrs.get("y_num_col_dims", 1) != 1:
                continue
            hit = _single_use_chain(block, i, uses, ("elementwise_add",))
            if hit is None:
                continue
            j, add = hit
            mul_out = op.outputs["Out"][0]
            xs = add.inputs.get("X", [])
            ys = add.inputs.get("Y", [])
            bias = ys[0] if xs and xs[0] == mul_out else \
                (xs[0] if ys and ys[0] == mul_out else None)
            if bias is None:
                continue
            bv = block._find_var_recursive(bias)
            if bv is None or len(bv.shape) != 1:
                continue            # fc bias is 1-D [size]
            # the 1-D add must broadcast over the OUTPUT dim
            wv = block._find_var_recursive(op.inputs["Y"][0])
            axis = add.attrs.get("axis", -1)
            if axis not in (-1, 1):
                continue
            if wv is not None and wv.shape is not None and \
                    bv.shape[0] != wv.shape[-1]:
                continue
            act = None
            end = j
            hit2 = _single_use_chain(block, j, uses, ("relu",))
            if hit2 is not None:
                end, _relu = hit2
                act = "relu"
            tail = block.ops[end]
            tail.type = "fc"
            tail.inputs = {"Input": list(op.inputs["X"]),
                           "W": list(op.inputs["Y"]),
                           "Bias": [bias]}
            tail.attrs = {"in_num_col_dims":
                          op.attrs.get("x_num_col_dims", 1),
                          "activation_type": act or ""}
            drop.add(i)
            if end != j:
                drop.add(j)
        _drop(block, drop)


@register_pass("embedding_eltwise_layernorm_fuse")
def embedding_eltwise_layernorm_fuse(program: Program, fetch_names=(),
                                     **_):
    """N lookup_tables summed pairwise then layer_norm'd  ⇒  one
    ``fused_embedding_eltwise_layernorm`` op (BERT's word + position +
    sentence embedding stack)."""
    for block in program.blocks:
        uses = _use_counts(block, keep_names=fetch_names)
        drop = set()
        lookup_out = {}
        for i, op in enumerate(block.ops):
            if op.type in ("lookup_table", "lookup_table_v2"):
                lookup_out[op.outputs["Out"][0]] = i
        for i, op in enumerate(block.ops):
            if op.type not in ("lookup_table", "lookup_table_v2") \
                    or i in drop:
                continue
            chain_ops = [i]
            members = [i]
            cur = i
            while True:
                hit = _single_use_chain(block, cur, uses,
                                        ("elementwise_add",))
                if hit is None:
                    break
                j, add = hit
                prev_out = block.ops[cur].outputs["Out"][0]
                xs = add.inputs.get("X", [])
                ys = add.inputs.get("Y", [])
                other = ys[0] if xs and xs[0] == prev_out else \
                    (xs[0] if ys and ys[0] == prev_out else None)
                if other is None or other not in lookup_out or \
                        uses.get(other, 0) != 1:
                    break
                members.append(lookup_out[other])
                chain_ops.append(j)
                cur = j
            if len(members) < 2:
                continue
            hit = _single_use_chain(block, cur, uses, ("layer_norm",))
            if hit is None:
                continue
            ln_i, ln = hit
            aux = [n for slot in ("Mean", "Variance")
                   for n in ln.outputs.get(slot, ())]
            if any(uses.get(n, 0) > 0 for n in aux) or \
                    any(n in set(fetch_names) for n in aux):
                continue
            # the fused op normalises the LAST axis only
            yv = block._find_var_recursive(ln.outputs["Y"][0])
            if yv is None or \
                    ln.attrs.get("begin_norm_axis", 1) != len(yv.shape) - 1:
                continue
            ids, tables = [], []
            for m in members:
                lk = block.ops[m]
                ids.append(lk.inputs["Ids"][0])
                tables.append(lk.inputs["W"][0])
            ln.type = "fused_embedding_eltwise_layernorm"
            ln.inputs = {"Ids": ids, "Embs": tables,
                         "Scale": list(ln.inputs.get("Scale", [])),
                         "Bias": list(ln.inputs.get("Bias", []))}
            drop.update(members)
            drop.update(chain_ops[1:])
        _drop(block, drop)
