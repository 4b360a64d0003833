"""Tensor-creation and manipulation layers.

Counterpart of paddle_tpu/fluid/layers/tensor.py (the layers ported so
far).
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.types import np_dtype_to_proto

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer

__all__ = ["create_parameter", "create_global_var", "cast", "concat"]


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
