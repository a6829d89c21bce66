"""Gradient clipping — the port of paddle_tpu/clip.py (ref:
python/paddle/fluid/clip.py — GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, set_gradient_clip).

Each clip appends ops after the backward op that replace the gradients
the optimizer ops read; a parameter with ``need_clip=False`` keeps its
gradient.  The JAX package's ``_eager_clip`` methods serve its dygraph
mode, which the port does not have: they are left out.

A global-norm clip over gradients that are each rank's block of a
sharded parameter (ZeRO-3 and HSDP over ``fsdp``, expert weights over the
expert axis, tp layers over ``tp``) would clip every rank by its own
blocks' norm.  :func:`shard_global_norm` rewrites the clip's sum of
squares from the parameters' ``dist_attr``: the squares of the gradients
of parameters sharded over the same axes are summed and all-reduced over
those axes first (one ``c_global_norm_allreduce`` of a scalar per axis
group a step), and the replicated gradients' squares are added once,
locally: every rank then clips by the norm of the whole gradient.  The
clip calls it when it is built, and ``apply_fsdp_sharding`` and
``apply_expert_sharding`` each call it after they stamp.  The JAX
package has no such all-reduce (its fsdp run clips each device by its
own blocks)."""

from __future__ import annotations

from typing import Dict, List, Tuple

from .framework import unique_name
from .framework.core import GRAD_SUFFIX, default_main_program


def _shard_axes(block, grad: str) -> Tuple[str, ...]:
    """The axes the gradient ``grad`` is a block over: those of its
    parameter's ``dist_attr``, sorted."""
    from .framework.mesh_layout import _flat_axes
    owner = block._find_var_recursive(grad[:-len(GRAD_SUFFIX)]) \
        if grad.endswith(GRAD_SUFFIX) else None
    da = getattr(owner, "dist_attr", None) if owner is not None else None
    return tuple(sorted(set(_flat_axes(tuple(da or ())))))


def shard_global_norm(block) -> int:
    """Rewrite the global-norm clips of ``block`` for gradients that are
    blocks of sharded parameters.  In each clip's ``sum`` of
    ``squared_l2_norm`` outputs, the squares of the gradients sharded over
    the same axes (:func:`_shard_axes`) are summed and all-reduced over
    those axes before the total; the others stay as they were, and so do
    the totals of an earlier call, so passes that stamp one after another
    (``apply_expert_sharding``, then ``apply_fsdp_sharding``) each group
    their own gradients once.  Returns the number of all-reduces
    inserted."""
    from .ops.op_specs import CLIP_NORM_ALLREDUCE
    producer = {}
    totals, parts = set(), set()
    for op in block.ops:
        if op.type == "squared_l2_norm":
            for n in op.output_names():
                producer[n] = op.input_names()[0]
        elif op.type == CLIP_NORM_ALLREDUCE:
            totals.update(op.output_names())
            parts.update(op.input_names())
    inserted = 0
    i = 0
    while i < len(block.ops):
        op = block.ops[i]
        ins = op.inputs.get("X", [])
        if op.type != "sum" or not ins or \
                set(op.output_names()) & parts or \
                not all(n in producer or n in totals for n in ins):
            i += 1
            continue
        groups: Dict[Tuple[str, ...], List[str]] = {}
        kept = []
        for n in ins:
            axes = _shard_axes(block, producer[n]) if n in producer else ()
            if axes:
                groups.setdefault(axes, []).append(n)
            else:
                kept.append(n)
        if not groups:
            i += 1
            continue
        like = block._find_var_recursive(ins[0])
        new_ops = []
        for axes in sorted(groups):
            part = block.create_var(
                name=unique_name.generate("global_norm_part"),
                shape=(1,), dtype=like.dtype)
            total = block.create_var(
                name=unique_name.generate("global_norm_part"),
                shape=(1,), dtype=like.dtype)
            new_ops.append(("sum", {"X": groups[axes]}, {"Out": [part.name]},
                            {}))
            new_ops.append((CLIP_NORM_ALLREDUCE, {"X": [part.name]},
                            {"Out": [total.name]},
                            {"ring_id": 0, "_axis_name":
                             axes[0] if len(axes) == 1 else tuple(axes)}))
            kept.append(total.name)
            inserted += 1
        op.inputs["X"] = kept
        for k, (t, oin, oout, attrs) in enumerate(new_ops):
            block._insert_op(i + k, type=t, inputs=oin, outputs=oout,
                             attrs=attrs)
        i += len(new_ops) + 1
    if inserted:
        block.program._bump_version()
    return inserted


class GradientClipBase:
    def __call__(self, params_grads):
        raise NotImplementedError


def _clip_each(params_grads, prefix, op_type, attrs):
    block = default_main_program().global_block()
    out = []
    for p, g in params_grads:
        if not getattr(p, "need_clip", True):
            out.append((p, g))
            continue
        c = block.create_var(name=unique_name.generate(prefix),
                             shape=g.shape, dtype=g.dtype)
        block.append_op(type=op_type, inputs={"X": [g]},
                        outputs={"Out": [c]}, attrs=dict(attrs))
        out.append((p, c))
    return out


class GradientClipByValue(GradientClipBase):
    """Each gradient element clipped to [min, max] (min defaults to
    -max)."""

    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -float(max)

    def __call__(self, params_grads):
        return _clip_each(params_grads, "clip", "clip",
                          {"min": self.min, "max": self.max})


class GradientClipByNorm(GradientClipBase):
    """Each gradient scaled to L2 norm ``clip_norm`` when its norm is
    larger."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        return _clip_each(params_grads, "clip_norm", "clip_by_norm",
                          {"max_norm": self.clip_norm})


class GradientClipByGlobalNorm(GradientClipBase):
    """ref: clip.py GradientClipByGlobalNorm — every gradient times
    clip / max(clip, global norm), the norm taken over all of them
    together."""

    def __init__(self, clip_norm, group_name="default_group"):
        self.clip_norm = float(clip_norm)

    def __call__(self, params_grads):
        block = default_main_program().global_block()

        def var(prefix, like, shape=(1,)):
            return block.create_var(name=unique_name.generate(prefix),
                                    shape=shape, dtype=like.dtype)
        sq_vars = []
        for p, g in params_grads:
            if not getattr(p, "need_clip", True):
                continue
            s = var("sq_l2", g)
            block.append_op(type="squared_l2_norm", inputs={"X": [g]},
                            outputs={"Out": [s]})
            sq_vars.append(s)
        if not sq_vars:
            return params_grads
        total = var("global_norm_sq", sq_vars[0])
        block.append_op(type="sum", inputs={"X": sq_vars},
                        outputs={"Out": [total]})
        # a build whose parameters already carry a dist_attr (tp layers,
        # moe_ffn(ep_degree=n)) hands this clip each rank's blocks
        shard_global_norm(block)
        gnorm = var("global_norm", total)
        block.append_op(type="sqrt", inputs={"X": [total]},
                        outputs={"Out": [gnorm]})
        # scale = clip / max(gnorm, clip)
        clip_v = var("clip_const", gnorm)
        block.append_op(type="fill_constant", outputs={"Out": [clip_v]},
                        attrs={"shape": [1], "dtype": gnorm.dtype,
                               "value": self.clip_norm})
        denom = var("clip_denom", gnorm)
        block.append_op(type="elementwise_max",
                        inputs={"X": [gnorm], "Y": [clip_v]},
                        outputs={"Out": [denom]}, attrs={"axis": -1})
        scale = var("clip_scale", gnorm)
        block.append_op(type="elementwise_div",
                        inputs={"X": [clip_v], "Y": [denom]},
                        outputs={"Out": [scale]}, attrs={"axis": -1})
        out = []
        for p, g in params_grads:
            if not getattr(p, "need_clip", True):
                out.append((p, g))
                continue
            c = var("clipped_grad", g, g.shape)
            block.append_op(type="elementwise_mul",
                            inputs={"X": [g], "Y": [scale]},
                            outputs={"Out": [c]}, attrs={"axis": -1})
            out.append((p, c))
        return out


# the legacy program-level clip (ref: clip.py set_gradient_clip): picked
# up by Optimizer.apply_gradients when no grad_clip= was passed
_global_gradient_clip = None


def set_gradient_clip(clip, param_list=None, program=None):
    global _global_gradient_clip
    if clip is not None and not isinstance(clip, GradientClipBase):
        raise TypeError("set_gradient_clip expects a GradientClip* instance")
    _global_gradient_clip = clip


def get_gradient_clip():
    return _global_gradient_clip
