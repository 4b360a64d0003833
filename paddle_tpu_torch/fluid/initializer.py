"""Parameter initializers — append fill ops to the startup program.

Counterpart of paddle_tpu/fluid/initializer.py, class for class
(Constant / Uniform / Normal / Xavier / MSRA through fill_constant /
uniform_random / gaussian_random ops in the startup program; Bilinear and
NumpyArray through assign_value).
"""
from __future__ import annotations

import numpy as np


__all__ = ["Constant", "Uniform", "Normal", "Xavier", "MSRA", "Bilinear",
           "NumpyArrayInitializer", "ConstantInitializer",
           "UniformInitializer", "NormalInitializer", "XavierInitializer",
           "MSRAInitializer", "force_init_on_cpu"]


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


class MSRAInitializer(Initializer):
    def __init__(self, uniform=True, fan_in=None, seed=0):
        self.uniform = uniform
        self.fan_in = fan_in
        self.seed = seed

    def __call__(self, var, block):
        fi, _ = _fan_in_out(var)
        fi = self.fan_in if self.fan_in is not None else fi
        if self.uniform:
            limit = float(np.sqrt(6.0 / fi))
            UniformInitializer(-limit, limit, self.seed)(var, block)
        else:
            std = float(np.sqrt(2.0 / fi))
            NormalInitializer(0.0, std, self.seed)(var, block)


class BilinearInitializer(Initializer):
    """For upsampling conv_transpose filters (reference initializer.py)."""

    def __call__(self, var, block):
        shape = var.shape
        if len(shape) != 4:
            raise ValueError("bilinear init expects 4-D filter")
        f = np.ceil(shape[3] / 2.0)
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        weight = np.zeros(shape, dtype=np.float32)
        size = int(np.prod(shape))
        vals = np.zeros(size, dtype=np.float32)
        for i in range(size):
            x = i % shape[3]
            y = (i // shape[3]) % shape[2]
            vals[i] = (1 - abs(x / f - c)) * (1 - abs(y / f - c))
        weight = vals.reshape(shape)
        block.append_op(
            type="assign_value", outputs={"Out": var},
            attrs={"shape": list(shape), "dtype": int(var.proto_dtype),
                   "fp32_values": [float(v) for v in weight.flatten()]})


class NumpyArrayInitializer(Initializer):
    def __init__(self, value):
        self.value = np.asarray(value)

    def __call__(self, var, block):
        block.append_op(
            type="assign_value", outputs={"Out": var},
            attrs={"shape": list(self.value.shape),
                   "dtype": int(var.proto_dtype),
                   "fp32_values": [float(v) for v in
                                   self.value.astype(np.float32).flatten()]})


Constant = ConstantInitializer
Uniform = UniformInitializer
Normal = NormalInitializer
Xavier = XavierInitializer
MSRA = MSRAInitializer
Bilinear = BilinearInitializer
