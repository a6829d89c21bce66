"""Autodiff over the Program IR — the port of paddle_tpu/framework/backward.py
(ref: python/paddle/fluid/backward.py ``append_backward``).

As in the JAX package, the forward block is differentiated when it runs
(``executor.run_training_block`` with ``torch.autograd.grad``), so
``append_backward`` only declares the ``param@GRAD`` variables — they can
be fetched and are read by the optimizer ops — and appends one
``backward`` meta-op recording the loss and the parameters."""

from __future__ import annotations

from typing import List, Tuple

from .core import Variable, grad_var_name


def append_backward(loss: Variable, parameter_list=None, no_grad_set=None,
                    checkpoints=None,
                    callbacks=None) -> List[Tuple[Variable, Variable]]:
    """Declare the grads of ``loss`` with respect to the trainable
    parameters (or ``parameter_list``); returns (param, grad) pairs."""
    block = loss.block
    program = block.program
    if parameter_list is not None:
        params = [block.var(p) if isinstance(p, str) else p
                  for p in parameter_list]
    else:
        params = [p for p in program.all_parameters() if p.trainable]
    no_grad = {v.name if isinstance(v, Variable) else str(v)
               for v in (no_grad_set or ())}
    params = [p for p in params if p.name not in no_grad]

    grad_vars = [block.create_var(name=grad_var_name(p.name), shape=p.shape,
                                  dtype=p.dtype, stop_gradient=True)
                 for p in params]
    loss_grad = block.create_var(name=grad_var_name(loss.name),
                                 shape=loss.shape, dtype=loss.dtype)
    ckpt_names = None
    if checkpoints:
        ckpt_names = [c.name if isinstance(c, Variable) else str(c)
                      for c in checkpoints]
    block.append_op(
        type="backward",
        inputs={"Loss": [loss]},
        outputs={"Grads": grad_vars, "LossGrad": [loss_grad]},
        attrs={"loss_name": loss.name,
               "param_names": [p.name for p in params],
               "checkpoints": ckpt_names,
               "loss_scale": 1.0})
    return list(zip(params, grad_vars))


def gradients(targets, inputs, target_gradients=None, no_grad_set=None):
    """Grads of one target with respect to arbitrary ``inputs``
    (ref: backward.py ``gradients``)."""
    if isinstance(targets, Variable):
        targets = [targets]
    if isinstance(inputs, Variable):
        inputs = [inputs]
    if len(targets) != 1:
        raise ValueError("gradients: sum the targets into one first")
    if target_gradients is not None:
        raise NotImplementedError(
            "gradients(target_gradients=...) is not ported yet")
    loss = targets[0]
    block = loss.block
    grad_vars = [block.create_var(name=grad_var_name(v.name), shape=v.shape,
                                  dtype=v.dtype, stop_gradient=True)
                 for v in inputs]
    block.append_op(
        type="backward",
        inputs={"Loss": [loss]},
        outputs={"Grads": grad_vars},
        attrs={"loss_name": loss.name,
               "param_names": [v.name for v in inputs],
               "checkpoints": None,
               "loss_scale": 1.0})
    return grad_vars
