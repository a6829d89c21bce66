"""AMP optimizer decorator (ref: contrib/mixed_precision/decorator.py:27
OptimizerWithMixedPrecision, :218 decorate) — the port of the JAX
package's decorator, which writes the same program.

bf16 first: the default is bfloat16 compute with float32 master weights
and no loss scaling (bf16 has float32's exponent range).  fp16 keeps the
reference's dynamic loss scaling, with the same ops
(``check_finite_and_unscale`` / ``update_loss_scaling``,
ops/optimizer_ops.py) and the backward's ``loss_scale_var``."""

from __future__ import annotations

from ...framework import unique_name
from ...framework.core import default_startup_program, program_guard
from .fp16_lists import AutoMixedPrecisionLists
from .fp16_utils import rewrite_program


class OptimizerWithMixedPrecision:
    def __init__(self, optimizer, amp_lists=None,
                 init_loss_scaling=2.0 ** 15,
                 use_dynamic_loss_scaling=True,
                 incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
                 incr_ratio=2.0, decr_ratio=0.8, use_pure_bf16=True):
        self._optimizer = optimizer
        self._amp_lists = amp_lists or AutoMixedPrecisionLists()
        self._use_bf16 = use_pure_bf16
        self._dest_dtype = "bfloat16" if use_pure_bf16 else "float16"
        self._init_loss_scaling = init_loss_scaling
        self._use_dynamic = use_dynamic_loss_scaling and not use_pure_bf16
        self._use_scaling = not use_pure_bf16
        self._incr_every = incr_every_n_steps
        self._decr_every = decr_every_n_nan_or_inf
        self._incr_ratio = incr_ratio
        self._decr_ratio = decr_ratio
        self._loss_scale_var = None
        self._block = None

    def __getattr__(self, item):
        return getattr(self._optimizer, item)

    def _make_scale_state(self):
        main = self._block
        startup = default_startup_program().global_block()

        def persist(name, value, dtype="float32", shape=(1,)):
            v = main.create_var(name=unique_name.generate(name), shape=shape,
                                dtype=dtype, persistable=True)
            sv = startup.create_var(name=v.name, shape=shape, dtype=dtype,
                                    persistable=True)
            startup.append_op(type="fill_constant", outputs={"Out": [sv]},
                              attrs={"shape": list(shape), "dtype": dtype,
                                     "value": value})
            return v

        self._loss_scale_var = persist("loss_scaling",
                                       self._init_loss_scaling)
        if self._use_dynamic:
            self._good_steps = persist("good_steps", 0, "int32")
            self._bad_steps = persist("bad_steps", 0, "int32")

    def backward(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None, callbacks=None, checkpoints=None):
        """All AMP state is created here, not in ``minimize``, so a
        wrapper optimizer that calls ``backward`` and ``apply_gradients``
        apart still gets loss scaling."""
        program = loss.block.program
        self._block = program.global_block()
        rewrite_program(program, self._amp_lists, self._dest_dtype)
        if self._use_scaling and self._loss_scale_var is None:
            self._make_scale_state()
        params_grads = self._optimizer.backward(loss, startup_program,
                                                parameter_list, no_grad_set,
                                                callbacks, checkpoints)
        if self._use_scaling:
            bw = next(op for op in reversed(self._block.ops)
                      if op.type == "backward")
            bw.attrs["loss_scale_var"] = self._loss_scale_var.name
        return params_grads

    def apply_gradients(self, params_grads):
        block = self._block
        if self._use_scaling:
            # unscale + zero-on-overflow + dynamic scale update
            grads = [g for _, g in params_grads]
            found_inf = block.create_var(
                name=unique_name.generate("found_inf"), shape=(1,),
                dtype="bool")
            block.append_op(
                type="check_finite_and_unscale",
                inputs={"X": grads, "Scale": [self._loss_scale_var]},
                outputs={"Out": grads, "FoundInfinite": [found_inf]})
            if self._use_dynamic:
                block.append_op(
                    type="update_loss_scaling",
                    inputs={"X": grads, "FoundInfinite": [found_inf],
                            "PrevLossScaling": [self._loss_scale_var],
                            "InGoodSteps": [self._good_steps],
                            "InBadSteps": [self._bad_steps]},
                    outputs={"Out": grads,
                             "LossScaling": [self._loss_scale_var],
                             "OutGoodSteps": [self._good_steps],
                             "OutBadSteps": [self._bad_steps]},
                    attrs={"incr_every_n_steps": self._incr_every,
                           "decr_every_n_nan_or_inf": self._decr_every,
                           "incr_ratio": self._incr_ratio,
                           "decr_ratio": self._decr_ratio})
        return self._optimizer.apply_gradients(params_grads)

    def minimize(self, loss, startup_program=None, parameter_list=None,
                 no_grad_set=None):
        with program_guard(loss.block.program,
                           startup_program or default_startup_program()):
            params_grads = self.backward(loss, startup_program,
                                         parameter_list, no_grad_set)
            opt_ops = self.apply_gradients(params_grads)
        return opt_ops, params_grads


def decorate(optimizer, amp_lists=None, init_loss_scaling=2.0 ** 15,
             incr_every_n_steps=1000, decr_every_n_nan_or_inf=2,
             incr_ratio=2.0, decr_ratio=0.8,
             use_dynamic_loss_scaling=True, use_pure_bf16=True,
             use_fp16_guard=None):
    """ref: decorator.py:218 ``decorate`` — wrap any optimizer for AMP."""
    return OptimizerWithMixedPrecision(
        optimizer, amp_lists, init_loss_scaling=init_loss_scaling,
        use_dynamic_loss_scaling=use_dynamic_loss_scaling,
        incr_every_n_steps=incr_every_n_steps,
        decr_every_n_nan_or_inf=decr_every_n_nan_or_inf,
        incr_ratio=incr_ratio, decr_ratio=decr_ratio,
        use_pure_bf16=use_pure_bf16)
