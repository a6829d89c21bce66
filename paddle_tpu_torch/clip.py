"""Gradient clipping — the port of paddle_tpu/clip.py (ref:
python/paddle/fluid/clip.py — GradientClipByValue, GradientClipByNorm,
GradientClipByGlobalNorm, set_gradient_clip).

Each clip appends ops after the backward op that replace the gradients
the optimizer ops read; a parameter with ``need_clip=False`` keeps its
gradient.  The JAX package's ``_eager_clip`` methods serve its dygraph
mode, which the port does not have: they are left out."""

from __future__ import annotations

from .framework import unique_name
from .framework.core import default_main_program


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
