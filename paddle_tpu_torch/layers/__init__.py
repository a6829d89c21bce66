"""Layer builders — the port of paddle_tpu/layers/ (the subset the BERT
encoder, its pretraining heads and the decoder call, the LR schedules of
``lr_scheduler.py``, and ``cond`` / ``case`` with the comparisons their
predicates are built from)."""

from .math_ops import (_binary, _broadcast_shape, _to_variable,  # noqa: F401
                       elementwise_add, elementwise_sub, elementwise_mul,
                       elementwise_div, relu, sigmoid, tanh, gelu, scale,
                       matmul, mul, mean, square, elementwise_mod, sum,
                       reduce_sum, equal, not_equal, less_than, less_equal,
                       greater_than, greater_equal, logical_and, logical_or,
                       logical_not)
from .loss import cross_entropy, softmax_with_cross_entropy  # noqa: F401
from .nn import (data, fc, layer_norm, embedding, softmax,  # noqa: F401
                 dropout, argmax)
from .tensor_ops import (cast, fill_constant, reshape,  # noqa: F401
                         transpose, split, squeeze, unsqueeze, slice,
                         assign)
from .control_flow import cond, case  # noqa: F401
from ..lr_scheduler import (noam_decay, exponential_decay,  # noqa: F401
                            natural_exp_decay, inverse_time_decay,
                            polynomial_decay, piecewise_decay, cosine_decay,
                            linear_lr_warmup)
