"""Optimizers — the port of paddle_tpu/optimizer.py (the static-graph
``Optimizer`` base, SGD, Momentum, LarsMomentum, Adam, AdamW, Lamb,
Adagrad, DecayedAdagrad, RMSProp, Adadelta, Adamax, Ftrl and Dpsgd; ref:
python/paddle/fluid/optimizer.py).  The wrappers (Recompute,
GradientMerge, ModelAverage, EMA, Lookahead, LocalSGD, DGCMomentum) are
not ported.

Same architecture as the reference: ``minimize = append_backward +
apply_gradients``; the learning rate (a float, a Variable or an
``lr_scheduler`` schedule) and the accumulators are persistable variables
initialised in the startup program, and each parameter gets one optimizer
op in the main program (``ops/optimizer_ops.py``; dense Adam and AdamW
run on the fused Adam kernel).  Accumulator names, dtypes and startup
values are the JAX package's, so checkpoints cross between the two.  ``apply_gradients`` appends the
regularization ops first and the gradient clip after them, the JAX
package's order."""

from __future__ import annotations

from typing import Dict, Optional

from .framework import unique_name
from .framework.backward import append_backward
from .framework.core import (Variable, default_main_program,
                             default_startup_program, program_guard)
from .clip import get_gradient_clip
from .lr_scheduler import LRScheduler
from .regularizer import append_regularization_ops


class Optimizer:
    type = "sgd"

    def __init__(self, learning_rate, regularization=None, grad_clip=None,
                 name=None, parameter_list=None):
        if parameter_list is not None:
            raise NotImplementedError(
                "Optimizer(parameter_list=...) is the dygraph API, which is "
                "not ported")
        self._learning_rate = learning_rate
        self.regularization = regularization
        self._grad_clip = grad_clip
        self._name = name
        self._accumulators: Dict[str, Dict[str, Variable]] = {}
        self._lr_var: Optional[Variable] = None

    # -- learning rate ---------------------------------------------------
    def _create_global_learning_rate(self):
        if self._lr_var is not None:
            return
        if isinstance(self._learning_rate, Variable):
            self._lr_var = self._learning_rate
            return
        if isinstance(self._learning_rate, LRScheduler):
            self._lr_var = self._learning_rate._create_ops()
            return
        name = unique_name.generate("learning_rate")
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        self._lr_var = main.create_var(name=name, shape=(1,),
                                       dtype="float32", persistable=True)
        sv = startup.create_var(name=name, shape=(1,), dtype="float32",
                                persistable=True)
        startup.append_op(type="fill_constant", outputs={"Out": [sv]},
                          attrs={"shape": [1], "dtype": "float32",
                                 "value": float(self._learning_rate)})

    @property
    def learning_rate_var(self):
        return self._lr_var

    def _param_lr(self, param):
        """The global LR scaled by ``ParamAttr(learning_rate=...)``."""
        mult = getattr(param, "optimize_attrs", {}).get("learning_rate", 1.0)
        if mult == 1.0:
            return self._lr_var
        block = default_main_program().global_block()
        scaled = block.create_var(
            name=unique_name.generate(f"{param.name}_lr"),
            shape=(1,), dtype="float32")
        block.append_op(type="scale", inputs={"X": [self._lr_var]},
                        outputs={"Out": [scaled]},
                        attrs={"scale": float(mult)})
        return scaled

    # -- accumulators ----------------------------------------------------
    def _add_accumulator(self, name, param, fill_value=0.0, shape=None,
                         dtype=None):
        accs = self._accumulators.setdefault(name, {})
        if param.name in accs:
            return accs[param.name]
        var_name = unique_name.generate(f"{param.name}_{name}")
        shape = list(shape if shape is not None else param.shape)
        dtype = dtype or param.dtype
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        v = main.create_var(name=var_name, shape=shape, dtype=dtype,
                            persistable=True)
        sv = startup.create_var(name=var_name, shape=shape, dtype=dtype,
                                persistable=True)
        startup.append_op(type="fill_constant", outputs={"Out": [sv]},
                          attrs={"shape": shape, "dtype": dtype,
                                 "value": float(fill_value)})
        accs[param.name] = v
        return v

    def _get_accumulator(self, name, param):
        return self._accumulators[name][param.name]

    def _create_accumulators(self, block, parameters):
        pass

    def _append_optimize_op(self, block, param_and_grad):
        raise NotImplementedError

    # -- entry points ----------------------------------------------------
    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None, checkpoints=None):
        return append_backward(loss, parameter_list, no_grad_set,
                               checkpoints=checkpoints)

    def apply_gradients(self, params_grads):
        prog = default_main_program()
        block = prog.current_block()
        params_grads = append_regularization_ops(params_grads,
                                                 self.regularization)
        grad_clip = self._grad_clip
        if grad_clip is None:
            grad_clip = get_gradient_clip()
        if grad_clip is not None:
            params_grads = grad_clip(params_grads)
        self._create_global_learning_rate()
        self._create_accumulators(prog.global_block(),
                                  [p for p, _ in params_grads])
        return [self._append_optimize_op(block, pg) for pg in params_grads]

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        """append_backward + one optimizer op per parameter, in the loss's
        program; returns (optimize ops, (param, grad) pairs)."""
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


class SGDOptimizer(Optimizer):
    type = "sgd"

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            type="sgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p]})


class AdamOptimizer(Optimizer):
    type = "adam"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, grad_clip=None,
                 lazy_mode=False, name=None, parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon
        self._lazy_mode = lazy_mode

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment1", p)
            self._add_accumulator("moment2", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])
            self._add_accumulator("beta2_pow_acc", p, fill_value=self._beta2,
                                  shape=[1])

    def _lookup_ids_for(self, block, param):
        """Ids vars of the lookup_table ops reading ``param`` when they are
        its only forward consumers (the rows a lazy update touches)."""
        ids = []
        for op in block.ops:
            if op.type == "backward":
                break
            if param.name not in op.input_names():
                continue
            if op.type not in ("lookup_table", "lookup_table_v2"):
                return []
            ids.extend(n for n in op.inputs.get("Ids", ()) if n not in ids)
        return ids

    def _append_optimize_op(self, block, pg):
        p, g = pg
        inputs = {"Param": [p], "Grad": [g],
                  "LearningRate": [self._param_lr(p)],
                  "Moment1": [self._get_accumulator("moment1", p)],
                  "Moment2": [self._get_accumulator("moment2", p)],
                  "Beta1Pow": [self._get_accumulator("beta1_pow_acc", p)],
                  "Beta2Pow": [self._get_accumulator("beta2_pow_acc", p)]}
        attrs = self._op_attrs()
        if self._lazy_mode:
            rows = self._lookup_ids_for(block, p)
            if rows:
                inputs["SparseRows"] = rows
                attrs["lazy_mode"] = True
        return block.append_op(
            type=self.type, inputs=inputs,
            outputs={"ParamOut": [p], "Moment1Out": inputs["Moment1"],
                     "Moment2Out": inputs["Moment2"],
                     "Beta1PowOut": inputs["Beta1Pow"],
                     "Beta2PowOut": inputs["Beta2Pow"]},
            attrs=attrs)

    def _op_attrs(self):
        return {"beta1": self._beta1, "beta2": self._beta2,
                "epsilon": self._epsilon}


class AdamWOptimizer(AdamOptimizer):
    """Adam with decoupled weight decay: the ``adamw`` op subtracts
    ``lr * weight_decay * p`` after the Adam update."""
    type = "adamw"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, weight_decay=0.01, **kw):
        super().__init__(learning_rate, beta1, beta2, epsilon, **kw)
        self._coeff = weight_decay

    def _op_attrs(self):
        return dict(super()._op_attrs(), coeff=self._coeff)


class MomentumOptimizer(Optimizer):
    type = "momentum"

    def __init__(self, learning_rate, momentum=0.9, use_nesterov=False,
                 regularization=None, grad_clip=None, name=None,
                 parameter_list=None):
        super().__init__(learning_rate, regularization, grad_clip, name,
                         parameter_list=parameter_list)
        self._momentum = momentum
        self._use_nesterov = use_nesterov

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "use_nesterov": self._use_nesterov})


class LarsMomentumOptimizer(Optimizer):
    type = "lars_momentum"

    def __init__(self, learning_rate, momentum=0.9, lars_coeff=0.001,
                 lars_weight_decay=0.0005, epsilon=0, regularization=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, regularization, grad_clip, name)
        self._momentum = momentum
        self._lars_coeff = lars_coeff
        self._lars_weight_decay = lars_weight_decay
        self._epsilon = epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("velocity", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        v = self._get_accumulator("velocity", p)
        return block.append_op(
            type="lars_momentum",
            inputs={"Param": [p], "Grad": [g], "Velocity": [v],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "VelocityOut": [v]},
            attrs={"mu": self._momentum, "lars_coeff": self._lars_coeff,
                   "lars_weight_decay": self._lars_weight_decay,
                   "epsilon": self._epsilon})


class LambOptimizer(AdamOptimizer):
    """LAMB (You et al. 2019): Adam's moments, the update scaled per tensor
    by the trust ratio |p| / |r|.  ``exclude_from_weight_decay_fn(param)``
    returning True gives that parameter's op a weight decay of 0 (the BERT
    recipe excludes LayerNorm parameters and biases)."""
    type = "lamb"

    def __init__(self, learning_rate=0.001, lamb_weight_decay=0.01,
                 beta1=0.9, beta2=0.999, epsilon=1e-6, regularization=None,
                 grad_clip=None, exclude_from_weight_decay_fn=None,
                 name=None):
        super().__init__(learning_rate, beta1, beta2, epsilon,
                         regularization=regularization, grad_clip=grad_clip,
                         name=name)
        self._weight_decay = lamb_weight_decay
        self._exclude_fn = exclude_from_weight_decay_fn

    def _append_optimize_op(self, block, pg):
        p, g = pg
        wd = self._weight_decay
        if self._exclude_fn is not None and self._exclude_fn(p):
            wd = 0.0
        m1 = self._get_accumulator("moment1", p)
        m2 = self._get_accumulator("moment2", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        b2p = self._get_accumulator("beta2_pow_acc", p)
        return block.append_op(
            type="lamb",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._param_lr(p)],
                    "Moment1": [m1], "Moment2": [m2],
                    "Beta1Pow": [b1p], "Beta2Pow": [b2p]},
            outputs={"ParamOut": [p], "Moment1Out": [m1], "Moment2Out": [m2],
                     "Beta1PowOut": [b1p], "Beta2PowOut": [b2p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon, "weight_decay": wd})


class AdagradOptimizer(Optimizer):
    type = "adagrad"

    def __init__(self, learning_rate, epsilon=1e-6,
                 initial_accumulator_value=0.0, regularization=None,
                 grad_clip=None, name=None):
        super().__init__(learning_rate, regularization, grad_clip, name)
        self._epsilon = epsilon
        self._initial = initial_accumulator_value

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p, fill_value=self._initial)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"epsilon": self._epsilon})


class DecayedAdagradOptimizer(Optimizer):
    type = "decayed_adagrad"

    def __init__(self, learning_rate, decay=0.95, epsilon=1e-6,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, regularization, grad_clip, name)
        self._decay, self._epsilon = decay, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        return block.append_op(
            type="decayed_adagrad",
            inputs={"Param": [p], "Grad": [g], "Moment": [m],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "MomentOut": [m]},
            attrs={"decay": self._decay, "epsilon": self._epsilon})


class RMSPropOptimizer(Optimizer):
    type = "rmsprop"

    def __init__(self, learning_rate, rho=0.95, epsilon=1e-6, momentum=0.0,
                 centered=False, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, regularization, grad_clip, name)
        self._rho, self._epsilon = rho, epsilon
        self._momentum, self._centered = momentum, centered

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("mean_square", p)
            self._add_accumulator("mean_grad", p)
            self._add_accumulator("momentum", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        ms = self._get_accumulator("mean_square", p)
        mg = self._get_accumulator("mean_grad", p)
        mom = self._get_accumulator("momentum", p)
        return block.append_op(
            type="rmsprop",
            inputs={"Param": [p], "Grad": [g], "MeanSquare": [ms],
                    "MeanGrad": [mg], "Moment": [mom],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "MeanSquareOut": [ms],
                     "MeanGradOut": [mg], "MomentOut": [mom]},
            attrs={"decay": self._rho, "epsilon": self._epsilon,
                   "momentum": self._momentum, "centered": self._centered})


class AdadeltaOptimizer(Optimizer):
    type = "adadelta"

    def __init__(self, learning_rate, epsilon=1e-6, rho=0.95,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, regularization, grad_clip, name)
        self._rho, self._epsilon = rho, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("avg_squared_grad", p)
            self._add_accumulator("avg_squared_update", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sg = self._get_accumulator("avg_squared_grad", p)
        su = self._get_accumulator("avg_squared_update", p)
        return block.append_op(
            type="adadelta",
            inputs={"Param": [p], "Grad": [g], "AvgSquaredGrad": [sg],
                    "AvgSquaredUpdate": [su]},
            outputs={"ParamOut": [p], "AvgSquaredGradOut": [sg],
                     "AvgSquaredUpdateOut": [su]},
            attrs={"rho": self._rho, "epsilon": self._epsilon})


class AdamaxOptimizer(Optimizer):
    type = "adamax"

    def __init__(self, learning_rate=0.001, beta1=0.9, beta2=0.999,
                 epsilon=1e-8, regularization=None, grad_clip=None,
                 name=None):
        super().__init__(learning_rate, regularization, grad_clip, name)
        self._beta1, self._beta2, self._epsilon = beta1, beta2, epsilon

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("moment", p)
            self._add_accumulator("inf_norm", p)
            self._add_accumulator("beta1_pow_acc", p, fill_value=self._beta1,
                                  shape=[1])

    def _append_optimize_op(self, block, pg):
        p, g = pg
        m = self._get_accumulator("moment", p)
        inf = self._get_accumulator("inf_norm", p)
        b1p = self._get_accumulator("beta1_pow_acc", p)
        return block.append_op(
            type="adamax",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._param_lr(p)], "Moment": [m],
                    "InfNorm": [inf], "Beta1Pow": [b1p]},
            outputs={"ParamOut": [p], "MomentOut": [m], "InfNormOut": [inf],
                     "Beta1PowOut": [b1p]},
            attrs={"beta1": self._beta1, "beta2": self._beta2,
                   "epsilon": self._epsilon})


class FtrlOptimizer(Optimizer):
    type = "ftrl"

    def __init__(self, learning_rate, l1=0.0, l2=0.0, lr_power=-0.5,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, regularization, grad_clip, name)
        self._l1, self._l2, self._lr_power = l1, l2, lr_power

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("squared", p)
            self._add_accumulator("linear", p)

    def _append_optimize_op(self, block, pg):
        p, g = pg
        sq = self._get_accumulator("squared", p)
        lin = self._get_accumulator("linear", p)
        return block.append_op(
            type="ftrl",
            inputs={"Param": [p], "Grad": [g], "SquaredAccumulator": [sq],
                    "LinearAccumulator": [lin],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p], "SquaredAccumOut": [sq],
                     "LinearAccumOut": [lin]},
            attrs={"l1": self._l1, "l2": self._l2,
                   "lr_power": self._lr_power})


class DpsgdOptimizer(Optimizer):
    type = "dpsgd"

    def __init__(self, learning_rate, clip=10.0, batch_size=16.0, sigma=1.0,
                 name=None):
        super().__init__(learning_rate, name=name)
        self._clip, self._batch_size, self._sigma = clip, batch_size, sigma

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            type="dpsgd",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._param_lr(p)]},
            outputs={"ParamOut": [p]},
            attrs={"clip": self._clip, "batch_size": self._batch_size,
                   "sigma": self._sigma})


SGD = SGDOptimizer
Momentum = MomentumOptimizer
Adam = AdamOptimizer
AdamW = AdamWOptimizer
Adamax = AdamaxOptimizer
Adagrad = AdagradOptimizer
DecayedAdagrad = DecayedAdagradOptimizer
Adadelta = AdadeltaOptimizer
RMSProp = RMSPropOptimizer
Ftrl = FtrlOptimizer
Lamb = LambOptimizer
LarsMomentum = LarsMomentumOptimizer
Dpsgd = DpsgdOptimizer
