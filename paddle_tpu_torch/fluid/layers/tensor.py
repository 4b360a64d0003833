"""Tensor-creation and manipulation layers.

Counterpart of paddle_tpu/fluid/layers/tensor.py, function for
function.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.types import np_dtype_to_proto

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer

__all__ = [
    "create_tensor", "create_parameter", "create_global_var", "cast",
    "concat", "sums", "assign", "fill_constant",
    "fill_constant_batch_size_like", "ones", "zeros", "reverse",
    "argmax", "argmin", "argsort", "isfinite", "range_",
]


def create_tensor(dtype, name=None, persistable=False):
    helper = LayerHelper("create_tensor", name=name)
    return helper.create_variable(name=helper.name, dtype=dtype,
                                  persistable=persistable)


def create_parameter(shape, dtype, name=None, attr=None,
                     is_bias=False, default_initializer=None):
    helper = LayerHelper("create_parameter", name=name)
    from ..param_attr import ParamAttr
    attr = attr or ParamAttr(name=name)
    return helper.create_parameter(attr, shape, dtype, is_bias,
                                   default_initializer)


def create_global_var(shape, value, dtype, persistable=False,
                      force_cpu=False, name=None):
    helper = LayerHelper("global_var", name=name)
    var = helper.create_global_variable(
        dtype=dtype, shape=shape, persistable=persistable,
        name=name or helper.name)
    helper.set_variable_initializer(
        var, initializer=ConstantInitializer(value=float(value)))
    return var


def cast(x, dtype):
    helper = LayerHelper("cast", **locals())
    out = helper.create_tmp_variable(dtype=np.dtype(dtype)
                                     if not isinstance(dtype, np.dtype)
                                     else dtype)
    helper.append_op(type="cast", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"in_dtype": int(x.proto_dtype),
                            "out_dtype": int(np_dtype_to_proto(dtype))})
    return out


def concat(input, axis=0, name=None):
    helper = LayerHelper("concat", **locals())
    out = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(type="concat", inputs={"X": input},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def sums(input, out=None):
    helper = LayerHelper("sum", **locals())
    if out is None:
        out = helper.create_tmp_variable(dtype=helper.input_dtype())
    helper.append_op(type="sum", inputs={"X": input},
                     outputs={"Out": [out]})
    return out


def assign(input, output=None):
    helper = LayerHelper("assign", **locals())
    if isinstance(input, Variable):
        if output is None:
            output = helper.create_tmp_variable(dtype=input.dtype)
        helper.append_op(type="assign", inputs={"X": [input]},
                         outputs={"Out": [output]})
    elif isinstance(input, np.ndarray):
        if output is None:
            output = helper.create_tmp_variable(dtype=input.dtype)
        if input.dtype in (np.float32, np.float64):
            values = [float(v) for v in input.astype(np.float32).flat]
            key = "fp32_values"
        else:
            values = [int(v) for v in input.astype(np.int32).flat]
            key = "int32_values"
        helper.append_op(type="assign_value", outputs={"Out": [output]},
                         attrs={"shape": list(input.shape),
                                "dtype": int(np_dtype_to_proto(input.dtype)),
                                key: values})
    else:
        raise TypeError("assign expects Variable or ndarray")
    return output


def fill_constant(shape, dtype, value, force_cpu=False, out=None):
    helper = LayerHelper("fill_constant", **locals())
    if out is None:
        out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="fill_constant", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": int(np_dtype_to_proto(dtype)),
                            "value": float(value)})
    out.stop_gradient = True
    return out


def fill_constant_batch_size_like(input, shape, dtype, value,
                                  input_dim_idx=0, output_dim_idx=0):
    helper = LayerHelper("fill_constant_batch_size_like", **locals())
    out = helper.create_tmp_variable(dtype=dtype)
    helper.append_op(type="fill_constant_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "dtype": int(np_dtype_to_proto(dtype)),
                            "value": float(value),
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx})
    out.stop_gradient = True
    return out


def ones(shape, dtype, force_cpu=False):
    return fill_constant(value=1.0, shape=shape, dtype=dtype)


def zeros(shape, dtype, force_cpu=False):
    return fill_constant(value=0.0, shape=shape, dtype=dtype)


def reverse(x, axis):
    if isinstance(axis, int):
        axis = [axis]
    helper = LayerHelper("reverse", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="reverse", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmax(x, axis=0):
    helper = LayerHelper("arg_max", **locals())
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="arg_max", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argmin(x, axis=0):
    helper = LayerHelper("arg_min", **locals())
    out = helper.create_tmp_variable("int64")
    helper.append_op(type="arg_min", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return out


def argsort(input, axis=-1, name=None):
    helper = LayerHelper("argsort", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    ids = helper.create_tmp_variable("int64")
    helper.append_op(type="argsort", inputs={"X": [input]},
                     outputs={"Out": [out], "Indices": [ids]},
                     attrs={"axis": axis})
    return out, ids


def isfinite(x):
    helper = LayerHelper("isfinite", **locals())
    out = helper.create_tmp_variable("bool")
    helper.append_op(type="isfinite", inputs={"X": [x]},
                     outputs={"Out": [out]})
    return out


def range_(start, end, step, dtype):
    """numpy.arange as a constant (host-computed)."""
    return assign(np.arange(start, end, step, dtype=np.dtype(dtype)))
