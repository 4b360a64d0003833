"""Neural-network layers (functions that append ops).

Counterpart of paddle_tpu/fluid/layers/nn.py (the layers ported so far).
"""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer

__all__ = [
    "fc", "embedding", "layer_norm", "softmax_with_cross_entropy", "mean",
    "reshape", "transpose", "elementwise_add",
]


def fc(input, size, num_flatten_dims=1, param_attr=None, bias_attr=None,
       act=None, is_test=False, name=None):
    """Fully-connected layer (reference nn.py:45): W per input, summed, plus
    bias and activation.  Lowers to `mul` ops that hit the MXU."""
    helper = LayerHelper("fc", **locals())
    dtype = helper.input_dtype()
    mul_results = []
    for input_var, param_attr_ in helper.iter_inputs_and_params():
        input_shape = input_var.shape
        nfd = num_flatten_dims
        if input_var.lod_level > 0 and nfd == 1:
            # ragged input is padded [N, T, ...]: default fc is per-token,
            # like the reference's fc on packed [sum_T, D] LoD tensors
            nfd = max(1, len(input_shape) - 1)
        param_shape = [
            int(np.prod(input_shape[nfd:]))] + [size]
        w = helper.create_parameter(attr=param_attr_, shape=param_shape,
                                    dtype=dtype)
        tmp = helper.create_tmp_variable(dtype)
        helper.append_op(
            type="mul", inputs={"X": [input_var], "Y": [w]},
            outputs={"Out": [tmp]},
            attrs={"x_num_col_dims": nfd,
                   "y_num_col_dims": 1})
        mul_results.append(tmp)
    if len(mul_results) == 1:
        pre_bias = mul_results[0]
    else:
        pre_bias = helper.create_tmp_variable(dtype)
        helper.append_op(type="sum", inputs={"X": mul_results},
                         outputs={"Out": [pre_bias]})
    pre_act = helper.append_bias_op(pre_bias, dim_start=-1)
    return helper.append_activation(pre_act)


def embedding(input, size, is_sparse=False, is_distributed=False,
              padding_idx=None, param_attr=None, dtype="float32"):
    helper = LayerHelper("embedding", **locals())
    w = helper.create_parameter(attr=helper.param_attr(), shape=list(size),
                                dtype=dtype)
    tmp = helper.create_tmp_variable(dtype)
    padding_idx = (-1 if padding_idx is None else
                   padding_idx if padding_idx >= 0 else size[0] + padding_idx)
    helper.append_op(
        type="lookup_table", inputs={"W": [w], "Ids": [input]},
        outputs={"Out": [tmp]},
        attrs={"is_sparse": is_sparse, "is_distributed": is_distributed,
               "padding_idx": padding_idx})
    return tmp


def layer_norm(input, scale=True, shift=True, begin_norm_axis=1,
               epsilon=1e-5, param_attr=None, bias_attr=None, act=None,
               name=None):
    helper = LayerHelper("layer_norm", **locals())
    dtype = helper.input_dtype()
    input_shape = input.shape
    param_shape = [int(np.prod(input_shape[begin_norm_axis:]))]
    inputs = {"X": [input]}
    if scale:
        s = helper.create_parameter(
            attr=helper.param_attr(), shape=param_shape, dtype=dtype,
            default_initializer=ConstantInitializer(1.0))
        inputs["Scale"] = [s]
    if shift:
        b = helper.create_parameter(
            attr=helper.bias_attr() or None, shape=param_shape, dtype=dtype,
            is_bias=True)
        inputs["Bias"] = [b]
    mean_out = helper.create_tmp_variable(dtype, stop_gradient=True)
    variance_out = helper.create_tmp_variable(dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="layer_norm", inputs=inputs,
        outputs={"Y": [out], "Mean": [mean_out], "Variance": [variance_out]},
        attrs={"epsilon": epsilon, "begin_norm_axis": begin_norm_axis})
    return helper.append_activation(out)


def softmax_with_cross_entropy(logits, label, soft_label=False):
    helper = LayerHelper("softmax_with_cross_entropy", **locals())
    softmax_ = helper.create_tmp_variable(dtype=logits.dtype)
    loss = helper.create_tmp_variable(dtype=logits.dtype)
    helper.append_op(type="softmax_with_cross_entropy",
                     inputs={"Logits": [logits], "Label": [label]},
                     outputs={"Softmax": [softmax_], "Loss": [loss]},
                     attrs={"soft_label": soft_label})
    return loss


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def reshape(x, shape, actual_shape=None, act=None, inplace=True, name=None):
    helper = LayerHelper("reshape", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="reshape", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape]})
    return helper.append_activation(out)


def transpose(x, perm, name=None):
    helper = LayerHelper("transpose", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="transpose", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"axis": [int(p) for p in perm]})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)
