"""Parameter initializers — append fill ops to the startup program.

Counterpart of paddle_tpu/fluid/initializer.py (Constant / Uniform /
Normal / Xavier through fill_constant / uniform_random / gaussian_random
ops in the startup program).
"""
from __future__ import annotations

import numpy as np

__all__ = ["Constant", "Uniform", "Normal", "Xavier", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer", "XavierInitializer",
           "force_init_on_cpu"]


def force_init_on_cpu():
    # placement is the executor's concern; kept for API parity
    return False


class Initializer:
    def __call__(self, var, block):
        raise NotImplementedError


class ConstantInitializer(Initializer):
    def __init__(self, value=0.0, force_cpu=False):
        self.value = value

    def __call__(self, var, block):
        block.append_op(
            type="fill_constant", outputs={"Out": var},
            attrs={"shape": list(var.shape),
                   "dtype": int(var.proto_dtype),
                   "value": float(self.value)})


class UniformInitializer(Initializer):
    def __init__(self, low=-1.0, high=1.0, seed=0):
        self.low, self.high, self.seed = low, high, seed

    def __call__(self, var, block):
        block.append_op(
            type="uniform_random", outputs={"Out": var},
            attrs={"shape": list(var.shape),
                   "dtype": int(var.proto_dtype),
                   "min": float(self.low), "max": float(self.high),
                   "seed": self.seed})


class NormalInitializer(Initializer):
    def __init__(self, loc=0.0, scale=1.0, seed=0):
        self.mean, self.std, self.seed = loc, scale, seed

    def __call__(self, var, block):
        block.append_op(
            type="gaussian_random", outputs={"Out": var},
            attrs={"shape": list(var.shape),
                   "dtype": int(var.proto_dtype),
                   "mean": float(self.mean), "std": float(self.std),
                   "seed": self.seed})


def _fan_in_out(var):
    shape = var.shape
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    fan_in = shape[1] * receptive if len(shape) > 2 else shape[0]
    fan_out = shape[0] * receptive if len(shape) > 2 else shape[1]
    return fan_in, fan_out


class XavierInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, fan_out=None, seed=0):
        self.uniform = uniform
        self.fan_in, self.fan_out = fan_in, fan_out
        self.seed = seed

    def __call__(self, var, block):
        fi, fo = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        fo = self.fan_out if self.fan_out is not None else fo
        if self.uniform:
            limit = float(np.sqrt(6.0 / (fi + fo)))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / (fi + fo)))
            NormalInitializer(0.0, std, self.seed)(var, block)


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
