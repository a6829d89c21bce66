"""Weight-decay regularizers — the port of paddle_tpu/regularizer.py (ref:
python/paddle/fluid/regularizer.py).

Regularization appends ops that add the penalty gradient to each
parameter's grad before the optimizer op consumes it: L2 adds
``coeff * p``, L1 adds ``coeff * p / (|p| + 1e-12)``, the JAX package's
sign."""

from __future__ import annotations

from .framework import unique_name
from .framework.core import default_main_program


class WeightDecayRegularizer:
    def __call__(self, param, grad, block):
        raise NotImplementedError


def _add_to_grad(param, grad, decay, block):
    out = block.create_var(name=unique_name.generate("reg_grad"),
                           shape=param.shape, dtype=param.dtype)
    block.append_op(type="sum", inputs={"X": [grad, decay]},
                    outputs={"Out": [out]})
    return out


class L2DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def __call__(self, param, grad, block):
        decay = block.create_var(name=unique_name.generate("l2_decay"),
                                 shape=param.shape, dtype=param.dtype)
        block.append_op(type="scale", inputs={"X": [param]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff})
        return _add_to_grad(param, grad, decay, block)


class L1DecayRegularizer(WeightDecayRegularizer):
    def __init__(self, regularization_coeff=0.0):
        self.coeff = regularization_coeff

    def __call__(self, param, grad, block):
        def var(prefix):
            return block.create_var(name=unique_name.generate(prefix),
                                    shape=param.shape, dtype=param.dtype)
        absv, eps, sign, decay = (var(n) for n in ("l1_abs", "l1_eps",
                                                   "l1_sign", "l1_decay"))
        block.append_op(type="abs", inputs={"X": [param]},
                        outputs={"Out": [absv]})
        block.append_op(type="scale", inputs={"X": [absv]},
                        outputs={"Out": [eps]},
                        attrs={"scale": 1.0, "bias": 1e-12})
        block.append_op(type="elementwise_div",
                        inputs={"X": [param], "Y": [eps]},
                        outputs={"Out": [sign]}, attrs={"axis": -1})
        block.append_op(type="scale", inputs={"X": [sign]},
                        outputs={"Out": [decay]},
                        attrs={"scale": self.coeff})
        return _add_to_grad(param, grad, decay, block)


def append_regularization_ops(params_grads, regularization=None):
    """ref: regularizer.py append_regularization_ops — a parameter's own
    regularizer (``ParamAttr(regularizer=...)``) wins over the
    optimizer's."""
    out = []
    block = default_main_program().global_block()
    for p, g in params_grads:
        reg = getattr(p, "regularizer", None) or regularization
        out.append((p, g) if reg is None else (p, reg(p, g, block)))
    return out


L1Decay = L1DecayRegularizer
L2Decay = L2DecayRegularizer
