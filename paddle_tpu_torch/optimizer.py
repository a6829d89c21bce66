"""Optimizers — the port of paddle_tpu/optimizer.py (the static-graph
``Optimizer`` base, SGD, Momentum, LarsMomentum, Adam, AdamW, Lamb,
Adagrad, DecayedAdagrad, RMSProp, Adadelta, Adamax, Ftrl, Dpsgd and
DGCMomentum, and the wrappers Recompute, GradientMerge, ModelAverage,
ExponentialMovingAverage, Lookahead, LocalSGD and ShardedUpdate (ZeRO-1:
the gradient reduce-scattered to flat 1/n shards, the update on the
shard, the parameter all-gathered); ref: python/paddle/fluid/optimizer.py).

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

import numpy as np

from .framework import unique_name
from .framework.backward import append_backward
from .framework.core import (Parameter, Variable, default_main_program,
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
        # an accumulator shaped like a sharded parameter (a ZeRO-1 flat
        # shard, a tensor-parallel split) is sharded with it
        da = getattr(param, "dist_attr", None)
        if da and shape == list(param.shape):
            v.dist_attr = da
            sv.dist_attr = da
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


class RecomputeOptimizer(Optimizer):
    """Activation recomputation wrapper (ref: optimizer.py:4479).

    ``checkpoints`` mark segment boundaries: the backward op records their
    names, and the executor runs each segment of the forward that ends at
    one under ``torch.utils.checkpoint``, recomputing it in the backward
    (``executor.run_training_block``)."""

    def __init__(self, optimizer):
        self._optimizer = optimizer
        self._checkpoints = None

    def _set_checkpoints(self, checkpoints):
        self._checkpoints = checkpoints

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None, checkpoints=None):
        # wrappers stacked on top (GradientMerge) reach the inner
        # optimizer through here; inject the checkpoints
        return self._optimizer.backward(
            loss, startup_program, parameter_list, no_grad_set, callbacks,
            checkpoints=checkpoints or self._checkpoints)

    def apply_gradients(self, params_grads):
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


class GradientMergeOptimizer(Optimizer):
    """Gradient accumulation over ``k_steps`` runs (ref: optimizer.py:4949).

    Each run adds the gradients into persistable accumulators; on every
    k-th run (``step % k == 0``) the inner optimizer applies their mean
    (``avg``) or sum, inside one ``cond``: its true branch holds the whole
    inner apply, so parameters and optimizer state (Adam's moments) stay
    exactly as they were on the other runs, and the accumulators restart
    from zero after an apply."""

    def __init__(self, inner_optimizer, k_steps=1, avg=True):
        self._inner = inner_optimizer
        self.k_steps = k_steps
        self.avg = avg

    def __getattr__(self, item):
        return getattr(self._inner, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            return self._minimize_impl(loss, startup_program,
                                       parameter_list, no_grad_set)

    def _minimize_impl(self, loss, startup_program, parameter_list,
                       no_grad_set):
        from .layers import tensor_ops as T
        from .layers.control_flow import cond as cond_layer
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        params_grads = self._inner.backward(loss, startup_program,
                                            parameter_list, no_grad_set)
        # apply_mask = (step % k == 0)
        maskf, inv_mask = _periodic_mask(main, startup, self.k_steps, "gm")

        merged = []
        for p, g in params_grads:
            acc_name = unique_name.generate(f"{p.name}_gm_acc")
            acc = main.create_var(name=acc_name, shape=p.shape, dtype=p.dtype,
                                  persistable=True)
            sacc = startup.create_var(name=acc_name, shape=p.shape,
                                      dtype=p.dtype, persistable=True)
            startup.append_op(type="fill_constant", outputs={"Out": [sacc]},
                              attrs={"shape": list(p.shape), "dtype": p.dtype,
                                     "value": 0.0})
            main.append_op(type="sum", inputs={"X": [acc, g]},
                           outputs={"Out": [acc]})
            eff_name = unique_name.generate(f"{p.name}_gm_eff")
            eff = main.create_var(name=eff_name, shape=p.shape, dtype=p.dtype)
            scale = 1.0 / self.k_steps if self.avg else 1.0
            main.append_op(type="scale", inputs={"X": [acc]},
                           outputs={"Out": [eff]}, attrs={"scale": scale})
            merged.append((p, eff))
            # reset acc when applied: acc *= (1 - mask)
            main.append_op(type="elementwise_mul",
                           inputs={"X": [acc], "Y": [inv_mask]},
                           outputs={"Out": [acc]}, attrs={"axis": -1})

        # the exact skip: the whole inner apply runs in the true branch of
        # one cond on step % k == 0 (ref: the reference's conditional_block
        # in GradientMergeOptimizer._true_apply_gradients)
        prog = default_main_program()
        gb = prog.global_block()
        pred = T.cast(maskf, "bool")
        written = []

        def true_fn():
            blk = prog.current_block()
            start = len(blk.ops)
            self._inner.apply_gradients(merged)
            seen = []
            for op in blk.ops[start:]:
                for n in op.output_names():
                    if n not in seen:
                        seen.append(n)
            written[:] = [n for n in seen
                          if n in gb.vars and gb.vars[n].persistable]
            return [gb.vars[n] for n in written]

        def false_fn():
            return [T.assign(gb.vars[n]) for n in written]

        outs = cond_layer(pred, true_fn, false_fn, name="gm_apply")
        opt_ops = []
        for n, o in zip(written, outs):
            opt_ops.append(main.append_op(
                type="assign", inputs={"X": [o]}, outputs={"Out": [n]}))
        return opt_ops, merged


def _persistable_scalar(main, startup, prefix, value=0.0):
    """A persistable (1,) float32 var in main and startup, startup-filled
    with ``value``: the step counters and products below."""
    name = unique_name.generate(prefix)
    v = main.create_var(name=name, shape=(1,), dtype="float32",
                        persistable=True)
    sv = startup.create_var(name=name, shape=(1,), dtype="float32",
                            persistable=True)
    startup.append_op(type="fill_constant", outputs={"Out": [sv]},
                      attrs={"shape": [1], "dtype": "float32",
                             "value": float(value)})
    return v


def _step_counter(main, startup, prefix):
    """A persistable step counter incremented once per main-program run."""
    step = _persistable_scalar(main, startup, f"{prefix}_step")
    main.append_op(type="increment", inputs={"X": [step]},
                   outputs={"Out": [step]}, attrs={"step": 1.0})
    return step


def _periodic_mask(main, startup, k, prefix="pm"):
    """A step counter and ``mask = (step % k == 0)``; returns (maskf,
    inv_maskf) float32 (1,) vars (GradientMerge, Lookahead)."""
    step = _step_counter(main, startup, prefix)
    modk = main.create_var(name=unique_name.generate(f"{prefix}_modk"),
                           shape=(1,), dtype="float32")
    main.append_op(type="elementwise_mod", inputs={
        "X": [step], "Y": [_const_var(main, startup, float(k))]},
        outputs={"Out": [modk]}, attrs={"axis": -1})
    mask = main.create_var(name=unique_name.generate(f"{prefix}_mask"),
                           shape=(1,), dtype="bool")
    main.append_op(type="equal", inputs={
        "X": [modk], "Y": [_const_var(main, startup, 0.0)]},
        outputs={"Out": [mask]})
    maskf = main.create_var(name=unique_name.generate(f"{prefix}_maskf"),
                            shape=(1,), dtype="float32")
    main.append_op(type="cast", inputs={"X": [mask]},
                   outputs={"Out": [maskf]},
                   attrs={"out_dtype": "float32"})
    inv = main.create_var(name=unique_name.generate(f"{prefix}_inv"),
                          shape=(1,), dtype="float32")
    main.append_op(type="scale", inputs={"X": [maskf]},
                   outputs={"Out": [inv]},
                   attrs={"scale": -1.0, "bias": 1.0})
    return maskf, inv


def _swap_context(executor, apply_program, restore_fn, need_restore):
    """The apply()/restore() context manager of the parameter-swapping
    averages (ModelAverage, EMA)."""
    import contextlib

    @contextlib.contextmanager
    def _ctx():
        # the swap program reads parameters and accumulators through the
        # scope: hand a donated prepared step's current state over first
        from .framework.executor import global_scope, sync_prepared_state
        sync_prepared_state(global_scope())
        executor.run(apply_program)
        try:
            yield
        finally:
            if need_restore:
                restore_fn(executor)
    return _ctx()


def _const_var(main, startup, value):
    name = unique_name.generate("const")
    v = main.create_var(name=name, shape=(1,), dtype="float32",
                        persistable=True)
    sv = startup.create_var(name=name, shape=(1,), dtype="float32",
                            persistable=True)
    startup.append_op(type="fill_constant", outputs={"Out": [sv]},
                      attrs={"shape": [1], "dtype": "float32",
                             "value": float(value)})
    return v


class DGCMomentumOptimizer(Optimizer):
    """Deep Gradient Compression momentum (ref: optimizer.py:1143
    DGCMomentumOptimizer; operators/dgc_op.cc).  The ``dgc_momentum`` op
    keeps DGC's convergence semantics (momentum correction, the masked
    top-k update, the local residual, the ramped sparsity); the gradient
    all-reduce stays dense.  ``num_trainers`` and ``local_grad_clip_norm``
    are taken for script compatibility."""

    type = "dgc_momentum"

    def __init__(self, learning_rate, momentum, rampup_begin_step,
                 rampup_step=1, sparsity=None, use_nesterov=False,
                 local_grad_clip_norm=None, num_trainers=None,
                 regularization=None, grad_clip=None, name=None):
        super().__init__(learning_rate, regularization, grad_clip, name)
        self._momentum = momentum
        self._use_nesterov = use_nesterov
        self._rampup_begin_step = rampup_begin_step
        self._rampup_step = rampup_step
        self._sparsity = list(sparsity or [0.999])
        self._step_var = None

    def _create_accumulators(self, block, parameters):
        for p in parameters:
            self._add_accumulator("u_velocity", p)
            self._add_accumulator("v_residual", p)
        if self._step_var is None:
            main = default_main_program().global_block()
            startup = default_startup_program().global_block()
            self._step_var = _persistable_scalar(main, startup, "dgc_step")

    def _append_optimize_op(self, block, pg):
        p, g = pg
        return block.append_op(
            type="dgc_momentum",
            inputs={"Param": [p], "Grad": [g],
                    "LearningRate": [self._param_lr(p)],
                    "U": [self._get_accumulator("u_velocity", p)],
                    "V": [self._get_accumulator("v_residual", p)],
                    "CurrentStep": [self._step_var]},
            outputs={"ParamOut": [p],
                     "UOut": [self._get_accumulator("u_velocity", p)],
                     "VOut": [self._get_accumulator("v_residual", p)]},
            attrs={"momentum": self._momentum,
                   "use_nesterov": self._use_nesterov,
                   "rampup_begin_step": float(self._rampup_begin_step),
                   "rampup_step": float(self._rampup_step),
                   "sparsity": self._sparsity})

    def apply_gradients(self, params_grads):
        opt_ops = super().apply_gradients(params_grads)
        block = default_main_program().global_block()
        block.append_op(type="increment", inputs={"X": [self._step_var]},
                        outputs={"Out": [self._step_var]},
                        attrs={"step": 1.0})
        return opt_ops


class ModelAverage(Optimizer):
    """Sliding-window parameter averaging (ref: optimizer.py:3069
    ModelAverage; operators/optimizers/average_accumulates_op.h).

    Appends one ``average_accumulates`` op per trainable parameter to the
    main program; ``apply()`` swaps the parameters for their windowed
    average (the weights to evaluate) and ``restore()`` swaps them back,
    each a program of its own run against the scope."""

    _ACCS = ("sum_1", "sum_2", "sum_3", "num_accumulates",
             "old_num_accumulates", "num_updates")

    def __init__(self, average_window_rate, min_average_window=10000,
                 max_average_window=10000, regularization=None, name=None):
        super().__init__(0.0, regularization, None, name)
        self.average_window = average_window_rate
        self.min_average_window = min_average_window
        self.max_average_window = max_average_window
        self._params = [
            v for v in default_main_program().global_block().vars.values()
            if isinstance(v, Parameter) and v.trainable]
        main = default_main_program().global_block()
        for p in self._params:
            for n in self._ACCS[:3]:
                self._add_accumulator(n, p)
            for n in self._ACCS[3:]:
                self._add_accumulator(n, p, shape=(1,), dtype="int32")
            acc = {n: self._get_accumulator(n, p) for n in self._ACCS}
            main.append_op(
                type="average_accumulates",
                inputs=dict({"param": [p]}, **{f"in_{n}": [acc[n]]
                                               for n in self._ACCS}),
                outputs={f"out_{n}": [acc[n]] for n in self._ACCS},
                attrs={"average_window": float(self.average_window),
                       "min_average_window": int(self.min_average_window),
                       "max_average_window": int(self.max_average_window)})
        self._apply_program, self._restore_program = self._build_swap()

    def _build_swap(self):
        from .framework.core import Program
        apply_prog, restore_prog = Program(), Program()
        acc_names = {p.name: {n: self._get_accumulator(n, p).name
                              for n in self._ACCS[:5]}
                     for p in self._params}
        with program_guard(apply_prog, Program()):
            blk = apply_prog.global_block()
            for p in self._params:
                names = acc_names[p.name]
                pv = blk.create_var(name=p.name, shape=p.shape,
                                    dtype=p.dtype, persistable=True)
                backup = blk.create_var(name=f"{p.name}@MA_BACKUP",
                                        shape=p.shape, dtype=p.dtype,
                                        persistable=True)
                blk.append_op(type="assign", inputs={"X": [pv]},
                              outputs={"Out": [backup]})
                sums = [blk.create_var(name=names[n], shape=p.shape,
                                       dtype=p.dtype, persistable=True)
                        for n in ("sum_1", "sum_2", "sum_3")]
                total = blk.create_var(name=f"{p.name}@MA_SUM",
                                       shape=p.shape, dtype=p.dtype)
                blk.append_op(type="sum", inputs={"X": sums},
                              outputs={"Out": [total]})
                counts = [blk.create_var(name=names[n], shape=(1,),
                                         dtype="int32", persistable=True)
                          for n in ("num_accumulates",
                                    "old_num_accumulates")]
                cnt = blk.create_var(name=f"{p.name}@MA_CNT", shape=(1,),
                                     dtype="int32")
                blk.append_op(type="sum", inputs={"X": counts},
                              outputs={"Out": [cnt]})
                cntf = blk.create_var(name=f"{p.name}@MA_CNTF", shape=(1,),
                                      dtype=p.dtype)
                blk.append_op(type="cast", inputs={"X": [cnt]},
                              outputs={"Out": [cntf]},
                              attrs={"out_dtype": p.dtype})
                one = blk.create_var(name=f"{p.name}@MA_ONE", shape=(1,),
                                     dtype=p.dtype)
                blk.append_op(type="fill_constant", outputs={"Out": [one]},
                              attrs={"shape": [1], "dtype": p.dtype,
                                     "value": 1.0})
                denom = blk.create_var(name=f"{p.name}@MA_DEN", shape=(1,),
                                       dtype=p.dtype)
                blk.append_op(type="elementwise_max",
                              inputs={"X": [cntf], "Y": [one]},
                              outputs={"Out": [denom]}, attrs={"axis": -1})
                blk.append_op(type="elementwise_div",
                              inputs={"X": [total], "Y": [denom]},
                              outputs={"Out": [pv]}, attrs={"axis": -1})
        restore_prog = _restore_program(self._params, "MA_BACKUP")
        return apply_prog, restore_prog

    def apply(self, executor, need_restore=True):
        """A context manager in which the parameters are their averages
        (ref: optimizer.py ModelAverage.apply)."""
        return _swap_context(executor, self._apply_program, self.restore,
                             need_restore)

    def restore(self, executor):
        executor.run(self._restore_program)


def _restore_program(params, backup_tag):
    """A program that assigns each parameter its ``@<backup_tag>`` copy."""
    from .framework.core import Program
    prog = Program()
    with program_guard(prog, Program()):
        blk = prog.global_block()
        for p in params:
            pv = blk.create_var(name=p.name, shape=p.shape, dtype=p.dtype,
                                persistable=True)
            backup = blk.create_var(name=f"{p.name}@{backup_tag}",
                                    shape=p.shape, dtype=p.dtype,
                                    persistable=True)
            blk.append_op(type="assign", inputs={"X": [backup]},
                          outputs={"Out": [pv]})
    return prog


class ExponentialMovingAverage:
    """EMA of the parameters (ref: optimizer.py:3378
    ExponentialMovingAverage).

    ``update()`` appends ``ema = decay_t * ema + (1 - decay_t) * param`` to
    the main program, with ``decay_t = min(decay, (1 + t) / (10 + t))``
    when ``thres_steps`` (a variable t) is given, else ``decay``, and
    keeps the running product of the ``decay_t``; ``apply()`` swaps in the
    bias-corrected ``ema / (1 - prod decay_t)``, ``restore()`` swaps
    back."""

    def __init__(self, decay=0.999, thres_steps=None, name=None):
        self._decay = decay
        self._thres_steps = thres_steps
        self._name = name or ""
        self._ema_vars = {}
        self._params = []
        self._step_var = None
        self._apply_program = None
        self._restore_program = None

    def update(self):
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        self._params = [v for v in main.vars.values()
                        if isinstance(v, Parameter) and v.trainable]
        self._step_var = _step_counter(main, startup, "ema")
        # the running product of decay_t: the exact bias correction, also
        # when thres_steps ramps the decay
        self._decay_prod = _persistable_scalar(main, startup,
                                               "ema_decay_prod", 1.0)
        if self._thres_steps is not None:
            t = self._thres_steps
            ramp = main.create_var(name=unique_name.generate("ema_ramp"),
                                   shape=(1,), dtype="float32")
            num = main.create_var(name=unique_name.generate("ema_num"),
                                  shape=(1,), dtype="float32")
            den = main.create_var(name=unique_name.generate("ema_den"),
                                  shape=(1,), dtype="float32")
            main.append_op(type="scale", inputs={"X": [t]},
                           outputs={"Out": [num]},
                           attrs={"scale": 1.0, "bias": 1.0})
            main.append_op(type="scale", inputs={"X": [t]},
                           outputs={"Out": [den]},
                           attrs={"scale": 1.0, "bias": 10.0})
            main.append_op(type="elementwise_div",
                           inputs={"X": [num], "Y": [den]},
                           outputs={"Out": [ramp]}, attrs={"axis": -1})
            decay_var = main.create_var(
                name=unique_name.generate("ema_decay"), shape=(1,),
                dtype="float32")
            cd = _const_var(main, startup, self._decay)
            main.append_op(type="elementwise_min",
                           inputs={"X": [ramp], "Y": [cd]},
                           outputs={"Out": [decay_var]}, attrs={"axis": -1})
        else:
            decay_var = _const_var(main, startup, self._decay)
        self._decay_var_name = decay_var.name
        main.append_op(type="elementwise_mul",
                       inputs={"X": [self._decay_prod], "Y": [decay_var]},
                       outputs={"Out": [self._decay_prod]},
                       attrs={"axis": -1})
        for p in self._params:
            ema_name = unique_name.generate(f"{p.name}_ema")
            ema = main.create_var(name=ema_name, shape=p.shape,
                                  dtype=p.dtype, persistable=True)
            sev = startup.create_var(name=ema_name, shape=p.shape,
                                     dtype=p.dtype, persistable=True)
            startup.append_op(type="fill_constant", outputs={"Out": [sev]},
                              attrs={"shape": list(p.shape),
                                     "dtype": p.dtype, "value": 0.0})
            self._ema_vars[p.name] = ema
            t1 = main.create_var(name=unique_name.generate("ema_t1"),
                                 shape=p.shape, dtype=p.dtype)
            main.append_op(type="elementwise_mul",
                           inputs={"X": [ema], "Y": [decay_var]},
                           outputs={"Out": [t1]}, attrs={"axis": -1})
            omd = main.create_var(name=unique_name.generate("ema_omd"),
                                  shape=(1,), dtype="float32")
            main.append_op(type="scale", inputs={"X": [decay_var]},
                           outputs={"Out": [omd]},
                           attrs={"scale": -1.0, "bias": 1.0})
            t2 = main.create_var(name=unique_name.generate("ema_t2"),
                                 shape=p.shape, dtype=p.dtype)
            main.append_op(type="elementwise_mul",
                           inputs={"X": [p], "Y": [omd]},
                           outputs={"Out": [t2]}, attrs={"axis": -1})
            main.append_op(type="elementwise_add",
                           inputs={"X": [t1], "Y": [t2]},
                           outputs={"Out": [ema]}, attrs={"axis": -1})
        self._apply_program, self._restore_program = self._build_swap()

    def _build_swap(self):
        from .framework.core import Program
        apply_prog = Program()
        with program_guard(apply_prog, Program()):
            blk = apply_prog.global_block()
            prod = blk.create_var(name=self._decay_prod.name, shape=(1,),
                                  dtype="float32", persistable=True)
            factor = blk.create_var(name=unique_name.generate("ema_factor"),
                                    shape=(1,), dtype="float32")
            blk.append_op(type="scale", inputs={"X": [prod]},
                          outputs={"Out": [factor]},
                          attrs={"scale": -1.0, "bias": 1.0})
            for p in self._params:
                pv = blk.create_var(name=p.name, shape=p.shape,
                                    dtype=p.dtype, persistable=True)
                ema = blk.create_var(name=self._ema_vars[p.name].name,
                                     shape=p.shape, dtype=p.dtype,
                                     persistable=True)
                backup = blk.create_var(name=f"{p.name}@EMA_BACKUP",
                                        shape=p.shape, dtype=p.dtype,
                                        persistable=True)
                blk.append_op(type="assign", inputs={"X": [pv]},
                              outputs={"Out": [backup]})
                blk.append_op(type="elementwise_div",
                              inputs={"X": [ema], "Y": [factor]},
                              outputs={"Out": [pv]}, attrs={"axis": -1})
        return apply_prog, _restore_program(self._params, "EMA_BACKUP")

    def apply(self, executor, need_restore=True):
        return _swap_context(executor, self._apply_program, self.restore,
                             need_restore)

    def restore(self, executor):
        executor.run(self._restore_program)


class LookaheadOptimizer:
    """Lookahead (ref: optimizer.py:4788 LookaheadOptimizer): the fast
    weights step with the inner optimizer every run; every ``k`` runs the
    slow weights move ``alpha`` of the way to the fast weights and the
    fast weights are reset to them.  The k-periodic swap is a 0/1 mask,
    so every run executes the same ops."""

    def __init__(self, inner_optimizer, alpha=0.5, k=5):
        assert inner_optimizer is not None
        assert 0.0 <= alpha <= 1.0
        assert k >= 1 and isinstance(k, int)
        self.inner_optimizer = inner_optimizer
        self.alpha = alpha
        self.k = k
        self.type = "lookahead"

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        opt_ops, params_grads = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            self._append_lookahead(params_grads)
        return opt_ops, params_grads

    def _append_lookahead(self, params_grads):
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        maskf, inv = _periodic_mask(main, startup, self.k, "la")
        for p, _ in params_grads:
            slow_name = unique_name.generate(f"{p.name}_slow")
            slow = main.create_var(name=slow_name, shape=p.shape,
                                   dtype=p.dtype, persistable=True)
            sslow = startup.create_var(name=slow_name, shape=p.shape,
                                       dtype=p.dtype, persistable=True)
            # the slow weights start as the initialised fast weights
            startup.append_op(type="assign", inputs={"X": [p.name]},
                              outputs={"Out": [sslow]})
            # slow' = slow + mask * alpha * (fast - slow)
            diff = main.create_var(name=unique_name.generate("la_diff"),
                                   shape=p.shape, dtype=p.dtype)
            main.append_op(type="elementwise_sub",
                           inputs={"X": [p], "Y": [slow]},
                           outputs={"Out": [diff]}, attrs={"axis": -1})
            scaled = main.create_var(name=unique_name.generate("la_sc"),
                                     shape=p.shape, dtype=p.dtype)
            main.append_op(type="scale", inputs={"X": [diff]},
                           outputs={"Out": [scaled]},
                           attrs={"scale": float(self.alpha)})
            masked = main.create_var(name=unique_name.generate("la_msk"),
                                     shape=p.shape, dtype=p.dtype)
            main.append_op(type="elementwise_mul",
                           inputs={"X": [scaled], "Y": [maskf]},
                           outputs={"Out": [masked]}, attrs={"axis": -1})
            main.append_op(type="elementwise_add",
                           inputs={"X": [slow], "Y": [masked]},
                           outputs={"Out": [slow]}, attrs={"axis": -1})
            # fast' = mask * slow' + (1 - mask) * fast
            t1 = main.create_var(name=unique_name.generate("la_t1"),
                                 shape=p.shape, dtype=p.dtype)
            main.append_op(type="elementwise_mul",
                           inputs={"X": [slow], "Y": [maskf]},
                           outputs={"Out": [t1]}, attrs={"axis": -1})
            t2 = main.create_var(name=unique_name.generate("la_t2"),
                                 shape=p.shape, dtype=p.dtype)
            main.append_op(type="elementwise_mul",
                           inputs={"X": [p], "Y": [inv]},
                           outputs={"Out": [t2]}, attrs={"axis": -1})
            main.append_op(type="elementwise_add",
                           inputs={"X": [t1], "Y": [t2]},
                           outputs={"Out": [p]}, attrs={"axis": -1})


class LocalSGDOptimizer:
    """Local SGD (ref: transpiler/collective.py:270 LocalSGD,
    fleet/meta_optimizers/localsgd_optimizer.py): each rank steps on its
    own gradients (no per-step gradient all-reduce) and every ``k_steps``
    runs from ``begin_step`` on the parameters are averaged over the
    data-parallel group (``local_sgd_sync``); on one rank it is the
    identity."""

    def __init__(self, inner_optimizer, k_steps=1, begin_step=1,
                 axis_name="dp"):
        self.inner_optimizer = inner_optimizer
        self.k_steps = k_steps
        self.begin_step = begin_step
        self.axis_name = axis_name
        self.type = "localsgd"

    def __getattr__(self, item):
        return getattr(self.inner_optimizer, item)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        opt_ops, params_grads = self.inner_optimizer.minimize(
            loss, startup_program, parameter_list, no_grad_set)
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            self._append_avg(params_grads)
        return opt_ops, params_grads

    def _append_avg(self, params_grads):
        main = default_main_program().global_block()
        startup = default_startup_program().global_block()
        step = _step_counter(main, startup, "localsgd")
        params = [p for p, _ in params_grads]
        main.append_op(
            type="local_sgd_sync",
            inputs={"Step": [step], "Params": params},
            outputs={"Out": params},
            attrs={"k_steps": float(self.k_steps),
                   "begin_step": float(self.begin_step),
                   "ring_id": 0, "_axis_name": self.axis_name})


class ShardedUpdateOptimizer(Optimizer):
    """ZeRO-1 sharded weight update (ref: "Automatic Cross-Replica
    Sharding of Weight Update in Data-Parallel Training",
    arXiv:2004.13336; the reference fleet's ``sharding`` stage 1) — the
    JAX package's rewrite, op for op.  Data-parallel gradient sync and
    update

        all_reduce(g);  p = update(p, g)            # every rank, full

    become

        g_shard = reduce_scatter(flat(g)) / n       # zero_reduce_scatter
        p_shard = slice(flat(p))                    # zero_shard_slice
        p_shard = update(p_shard, g_shard)          # the inner optimizer
        p       = all_gather(p_shard)               # zero_all_gather

    The accumulators are created from the shard var (flat, padded to a
    multiple of ``n·128``, or ``n·block_size`` under a quantized scatter,
    ``dist_attr`` over the data axis), so each rank holds 1/n of the
    optimizer state (the executor keeps each rank's block of them).

    ``axis_name`` may be a tuple of axes, as in the JAX package: the
    scatter and the gather ride the first, and the gradient is all-reduced
    over the rest before the scatter (``nranks`` is the first axis's
    size).

    Only elementwise update rules shard (LAMB and LARS need full-tensor
    norms: ``ValueError``); norm-based gradient clipping is refused
    (``NotImplementedError``: a shard-local norm clips each rank
    differently); a parameter with a ``dist_attr`` or ``is_distributed``
    keeps the dense mean + all-reduce and the full update."""

    _ELEMENTWISE = {"sgd", "momentum", "adam", "adamw", "adagrad",
                    "decayed_adagrad", "rmsprop", "adadelta", "adamax",
                    "ftrl", "dpsgd"}

    def __init__(self, optimizer, nranks, axis_name="dp",
                 compress_dtype=None, quant_spec=None):
        base = getattr(optimizer, "type", None)
        if base not in self._ELEMENTWISE:
            raise ValueError(
                f"sharded_update: optimizer type {base!r} is not an "
                f"elementwise update rule (LAMB/LARS trust ratios need "
                f"full-tensor norms) — supported: "
                f"{sorted(self._ELEMENTWISE)}")
        self._inner = optimizer
        self._nranks = int(nranks)
        self._axes = tuple(axis_name) if isinstance(axis_name, (tuple, list)) \
            else (axis_name,)
        self._compress = compress_dtype
        # the int8/int4 wire tier of the gradient scatter; the parameter
        # all-gather stays full precision (it moves updated weights, whose
        # error would accumulate step over step)
        from .ops.quantize_wire import CompressionSpec
        self._quant = CompressionSpec.from_attr(quant_spec)
        if self._quant is not None and self._quant.dtype == "bfloat16":
            self._compress, self._quant = "bfloat16", None

    def __getattr__(self, item):
        if item == "_inner":
            raise AttributeError(item)
        return getattr(self._inner, item)

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None, checkpoints=None):
        return self._inner.backward(loss, startup_program, parameter_list,
                                    no_grad_set, callbacks, checkpoints)

    def _check_clip(self):
        from .clip import GradientClipByGlobalNorm, GradientClipByNorm
        clip = self._inner._grad_clip or get_gradient_clip()
        if isinstance(clip, (GradientClipByNorm, GradientClipByGlobalNorm)):
            raise NotImplementedError(
                "sharded_update: norm-based gradient clipping would use "
                "shard-local norms (each replica clips differently) — "
                "use GradientClipByValue or disable sharded_update")

    def apply_gradients(self, params_grads):
        self._check_clip()
        block = default_main_program().current_block()
        n = self._nranks
        data_axis = self._axes[0]
        axis_attr = self._axes if len(self._axes) > 1 else data_axis
        shard_pairs, gathers, plain = [], [], []
        # a quantized scatter pads every rank's shard to whole blocks, and
        # the parameter slice must take the same pad; unquantized shards
        # align to 128 (zero padding leaves the update unchanged)
        align = self._quant.block_size if self._quant is not None else 128
        for p, g in params_grads:
            if getattr(p, "dist_attr", None) or \
                    getattr(p, "is_distributed", False):
                plain.append((p, g))
                continue
            numel = int(np.prod(p.shape)) if len(tuple(p.shape)) else 1
            padded = numel + (-numel % (n * align))
            gsh = block.create_var(
                name=unique_name.generate(f"{p.name}_grad_zshard"),
                shape=(padded,), dtype=p.dtype)
            scatter_attrs = {"ring_id": 0, "_axis_name": axis_attr,
                             "scale": 1.0 / n}
            if self._quant is not None:
                scatter_type = "quant_reduce_scatter"
                scatter_attrs["quant_spec"] = self._quant.to_attr()
            else:
                scatter_type = "zero_reduce_scatter"
                scatter_attrs["align"] = align
                if self._compress:
                    scatter_attrs["compress_dtype"] = self._compress
            block.append_op(type=scatter_type, inputs={"X": [g]},
                            outputs={"Out": [gsh]}, attrs=scatter_attrs)
            psh = block.create_var(
                name=unique_name.generate(f"{p.name}_zshard"),
                shape=(padded,), dtype=p.dtype)
            # accumulators created from the shard var inherit its layout
            psh.dist_attr = (data_axis,)
            psh.regularizer = getattr(p, "regularizer", None)
            psh.optimize_attrs = dict(getattr(p, "optimize_attrs", {}) or {})
            psh.trainable = True
            block.append_op(
                type="zero_shard_slice", inputs={"X": [p]},
                outputs={"Out": [psh]},
                attrs={"ring_id": 0, "_axis_name": data_axis,
                       **({"align": align} if align > 1 else {})})
            shard_pairs.append((psh, gsh))
            gathers.append((psh, p, numel))
        opt_ops = []
        if shard_pairs:
            opt_ops += self._inner.apply_gradients(shard_pairs)
        for psh, p, numel in gathers:
            opt_ops.append(block.append_op(
                type="zero_all_gather", inputs={"X": [psh]},
                outputs={"Out": [p]},
                attrs={"ring_id": 0, "_axis_name": data_axis,
                       "numel": numel, "shape": list(p.shape)}))
        if plain:
            # sharded params: the mean scale and a dense all-reduce over
            # the data axes their shards do not cover, the full update
            for p, g in plain:
                da = tuple(getattr(p, "dist_attr", None) or ())
                axes = tuple(a for a in self._axes if a not in da)
                block.append_op(type="scale", inputs={"X": [g]},
                                outputs={"Out": [g]},
                                attrs={"scale": 1.0 / n})
                if axes:
                    block.append_op(
                        type="c_allreduce_sum", inputs={"X": [g]},
                        outputs={"Out": [g]},
                        attrs={"ring_id": 0,
                               "_axis_name": axes if len(axes) > 1
                               else axes[0]})
            opt_ops += self._inner.apply_gradients(plain)
        return opt_ops

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


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
