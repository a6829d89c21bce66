"""Parameter initializers (ref: python/paddle/fluid/initializer.py) — the
port of paddle_tpu/framework/initializer.py.

An initializer appends an init op (fill_constant / uniform_random /
gaussian_random / truncated_gaussian_random / assign_value) writing the
parameter into the *startup* program; running the startup program draws
the values from the executor's seeded ``torch.Generator``.  Class names
and attribute names match the JAX package's, so a program desc carries
initializers between the two packages byte for byte."""

from __future__ import annotations

import math

import numpy as np


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, var, block):
        block.append_op(type="fill_constant", outputs={"Out": [var]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(type="uniform_random", outputs={"Out": [var]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "min": self.low, "max": self.high,
                               "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(type="gaussian_random", outputs={"Out": [var]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed})


class TruncatedNormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.loc, self.scale, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(type="truncated_gaussian_random",
                        outputs={"Out": [var]},
                        attrs={"shape": list(var.shape), "dtype": var.dtype,
                               "mean": self.loc, "std": self.scale,
                               "seed": self.seed})


def _fan_in_out(shape):
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


class XavierInitializer(Initializer):
    """ref: initializer.py XavierInitializer (Glorot)."""

    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform, self.fan_in, self.fan_out, self.seed = \
            uniform, fan_in, fan_out, seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = math.sqrt(6.0 / (fi + fo))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = math.sqrt(2.0 / (fi + fo))
            NormalInitializer(0.0, std, self.seed)(var, block)


class MSRAInitializer(Initializer):
    """Kaiming/He init (ref: initializer.py MSRAInitializer)."""

    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform, self.fan_in, self.seed = uniform, fan_in, seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var.shape)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = math.sqrt(6.0 / fi)
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            NormalInitializer(0.0, math.sqrt(2.0 / fi), self.seed)(var, block)


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(type="assign_value", outputs={"Out": [var]},
                        attrs={"shape": list(self.value.shape),
                               "dtype": var.dtype,
                               "values": self.value.reshape(-1).tolist()})


# public aliases matching the reference's exported names
Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
TruncatedNormal = TruncatedNormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
