"""Neural-network layers (functions that append ops).

Counterpart of paddle_tpu/fluid/layers/nn.py (the layers ported so far).
"""
from __future__ import annotations

import numpy as np

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer, NormalInitializer

__all__ = [
    "fc", "embedding", "conv2d", "pool2d", "batch_norm", "layer_norm",
    "softmax", "cross_entropy", "softmax_with_cross_entropy", "mean",
    "reshape", "transpose", "topk", "scale", "elementwise_add", "dropout",
    "matmul", "square_error_cost", "reduce_sum",
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


def _pair(v):
    return list(v) if isinstance(v, (list, tuple)) else [v, v]


def conv2d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, use_cudnn=True,
           use_mkldnn=False, act=None, name=None):
    helper = LayerHelper("conv2d", **locals())
    dtype = helper.input_dtype()
    groups = groups or 1
    num_channels = input.shape[1]
    filter_size = _pair(filter_size)
    filter_shape = [num_filters, num_channels // groups] + filter_size
    fan_in = (num_channels // groups) * filter_size[0] * filter_size[1]
    std = (2.0 / fan_in) ** 0.5
    filter_param = helper.create_parameter(
        attr=helper.param_attr(), shape=filter_shape, dtype=dtype,
        default_initializer=NormalInitializer(0.0, std, 0))
    pre_bias = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="conv2d",
        inputs={"Input": [input], "Filter": [filter_param]},
        outputs={"Output": [pre_bias]},
        attrs={"strides": _pair(stride), "paddings": _pair(padding),
               "dilations": _pair(dilation), "groups": groups})
    pre_act = helper.append_bias_op(pre_bias, dim_start=1, dim_end=2)
    return helper.append_activation(pre_act)


def pool2d(input, pool_size=-1, pool_type="max", pool_stride=1,
           pool_padding=0, global_pooling=False, use_cudnn=True,
           ceil_mode=False, use_mkldnn=False, name=None, exclusive=True):
    if pool_type not in ("max", "avg"):
        raise ValueError("pool_type must be max|avg, got %r" % pool_type)
    helper = LayerHelper("pool2d", **locals())
    dtype = helper.input_dtype()
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="pool2d", inputs={"X": [input]}, outputs={"Out": [out]},
        attrs={"pooling_type": pool_type, "ksize": _pair(pool_size),
               "global_pooling": global_pooling,
               "strides": _pair(pool_stride),
               "paddings": _pair(pool_padding),
               "ceil_mode": ceil_mode, "exclusive": exclusive})
    return out


def batch_norm(input, act=None, is_test=False, momentum=0.9, epsilon=1e-5,
               param_attr=None, bias_attr=None, data_layout="NCHW",
               in_place=False, use_mkldnn=False, name=None,
               moving_mean_name=None, moving_variance_name=None,
               do_model_average_for_mean_and_var=False):
    helper = LayerHelper("batch_norm", **locals())
    dtype = helper.input_dtype()
    input_shape = input.shape
    if data_layout == "NCHW":
        channel_num = input_shape[1]
    else:
        channel_num = input_shape[-1]
    param_shape = [channel_num]
    scale = helper.create_parameter(
        attr=helper.param_attr(), shape=param_shape, dtype=dtype,
        default_initializer=ConstantInitializer(1.0))
    bias = helper.create_parameter(
        attr=helper.bias_attr() or None, shape=param_shape, dtype=dtype,
        is_bias=True)
    from ..param_attr import ParamAttr
    mean = helper.create_parameter(
        attr=ParamAttr(name=moving_mean_name,
                       initializer=ConstantInitializer(0.0),
                       trainable=False),
        shape=param_shape, dtype=dtype)
    mean.stop_gradient = True
    variance = helper.create_parameter(
        attr=ParamAttr(name=moving_variance_name,
                       initializer=ConstantInitializer(1.0),
                       trainable=False),
        shape=param_shape, dtype=dtype)
    variance.stop_gradient = True

    saved_mean = helper.create_tmp_variable(dtype, stop_gradient=True)
    saved_variance = helper.create_tmp_variable(dtype, stop_gradient=True)
    batch_norm_out = input if in_place else \
        helper.create_tmp_variable(dtype)
    helper.append_op(
        type="batch_norm",
        inputs={"X": [input], "Scale": [scale], "Bias": [bias],
                "Mean": [mean], "Variance": [variance]},
        outputs={"Y": [batch_norm_out], "MeanOut": [mean],
                 "VarianceOut": [variance], "SavedMean": [saved_mean],
                 "SavedVariance": [saved_variance]},
        attrs={"momentum": momentum, "epsilon": epsilon,
               "is_test": is_test, "data_layout": data_layout})
    return helper.append_activation(batch_norm_out)


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


def softmax(input, use_cudnn=True, name=None):
    helper = LayerHelper("softmax", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def cross_entropy(input, label, soft_label=False):
    helper = LayerHelper("cross_entropy", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="cross_entropy",
                     inputs={"X": [input], "Label": [label]},
                     outputs={"Y": [out]},
                     attrs={"soft_label": soft_label})
    return out


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


def topk(input, k, name=None):
    helper = LayerHelper("top_k", **locals())
    values = helper.create_tmp_variable(dtype=input.dtype)
    indices = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="top_k", inputs={"X": [input]},
                     outputs={"Out": [values], "Indices": [indices]},
                     attrs={"k": k})
    values.stop_gradient = True
    indices.stop_gradient = True
    return values, indices


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def dropout(x, dropout_prob, is_test=False, seed=None, name=None):
    helper = LayerHelper("dropout", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    mask = helper.create_tmp_variable(dtype=x.dtype, stop_gradient=True)
    helper.append_op(
        type="dropout", inputs={"X": [x]},
        outputs={"Out": [out], "Mask": [mask]},
        attrs={"dropout_prob": dropout_prob, "is_test": is_test,
               "seed": seed if seed is not None else 0})
    return out


def matmul(x, y, transpose_x=False, transpose_y=False, alpha=1.0, name=None):
    helper = LayerHelper("matmul", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="matmul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"transpose_X": transpose_x,
                            "transpose_Y": transpose_y,
                            "alpha": float(alpha)})
    return out


def square_error_cost(input, label):
    helper = LayerHelper("square_error_cost", **locals())
    minus_out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="elementwise_sub",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [minus_out]})
    square_out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="square", inputs={"X": [minus_out]},
                     outputs={"Out": [square_out]})
    return square_out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    helper = LayerHelper("reduce_sum", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, list) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type="reduce_sum", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out
