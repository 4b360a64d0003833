"""Neural-network layers (functions that append ops).

Counterpart of paddle_tpu/fluid/layers/nn.py, function for function:
the same calls build the same ops and descs.  The layers whose ops are
not ported yet keep the reference's signatures and raise
NotImplementedError naming their ROADMAP item (``_not_ported``).
"""
from __future__ import annotations

import numpy as np

from ..framework import Variable
from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer, NormalInitializer
from paddle_tpu_torch.core.types import np_dtype_to_proto

__all__ = [
    "fc", "embedding", "conv2d", "conv3d", "conv2d_transpose", "pool2d",
    "batch_norm", "layer_norm", "dropout", "softmax", "cross_entropy",
    "softmax_with_cross_entropy", "square_error_cost", "mean", "mul",
    "matmul", "reduce_sum", "reduce_mean", "reduce_max", "reduce_min",
    "reduce_prod", "split", "reshape", "transpose", "topk", "l2_normalize",
    "one_hot", "lrn", "im2sequence", "label_smooth", "smooth_l1", "nce",
    "row_conv", "multiplex", "resize_bilinear", "prelu", "pad", "clip",
    "clip_by_norm", "elementwise_add", "elementwise_sub", "elementwise_mul",
    "elementwise_div", "elementwise_max", "elementwise_min",
    "elementwise_pow", "expand", "squeeze", "unsqueeze", "gather", "scatter",
    "sigmoid_cross_entropy_with_logits", "hinge_loss", "huber_loss",
    "log_loss", "rank_loss", "margin_rank_loss", "maxout", "relu", "log",
    "conv_shift", "modified_huber_loss", "roi_pool", "unpool",
    "lambda_rank", "scale_sub_region",
    "crop", "slice_op", "shape_op", "hsigmoid", "cos_sim", "scale",
    "dot_product_attention", "warpctc", "bilinear_tensor_product",
    "sampling_id", "gaussian_random", "uniform_random",
    "gaussian_random_batch_size_like", "uniform_random_batch_size_like",
    "random_crop", "mean_iou", "spp", "beam_search", "beam_search_decode",
    "linear_chain_crf", "crf_decoding", "ctc_greedy_decoder",
    "chunk_eval",
]


_CONV = "queue 1 item 7, the conv family"
_MISC = "queue 1 item 7, detection and misc"
# the layers whose ops the port lacks, and the ROADMAP item of each
_UNPORTED = {
    "conv3d": _CONV, "conv2d_transpose": _CONV, "row_conv": _CONV,
    "spp": _CONV, "conv_shift": _MISC, "roi_pool": _MISC, "unpool": _MISC,
    "scale_sub_region": _MISC}


def _not_ported(layer):
    raise NotImplementedError(
        "fluid.layers.%s: its op is not ported to paddle_tpu_torch yet "
        "(ROADMAP %s)" % (layer, _UNPORTED[layer]))


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


def conv3d(input, num_filters, filter_size, stride=1, padding=0, dilation=1,
           groups=None, param_attr=None, bias_attr=None, act=None,
           name=None):
    _not_ported("conv3d")


def conv2d_transpose(input, num_filters, output_size=None, filter_size=None,
                     padding=0, stride=1, dilation=1, groups=None,
                     param_attr=None, bias_attr=None, use_cudnn=True,
                     act=None, name=None):
    _not_ported("conv2d_transpose")


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


def mean(x, name=None):
    helper = LayerHelper("mean", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="mean", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def mul(x, y, x_num_col_dims=1, y_num_col_dims=1, name=None):
    helper = LayerHelper("mul", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="mul", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"x_num_col_dims": x_num_col_dims,
                            "y_num_col_dims": y_num_col_dims})
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


def _reduce(op_type, input, dim, keep_dim, name):
    helper = LayerHelper(op_type, **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    if dim is None:
        attrs = {"dim": [0], "keep_dim": keep_dim, "reduce_all": True}
    else:
        attrs = {"dim": dim if isinstance(dim, list) else [dim],
                 "keep_dim": keep_dim, "reduce_all": False}
    helper.append_op(type=op_type, inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs=attrs)
    return out


def reduce_sum(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_sum", input, dim, keep_dim, name)


def reduce_mean(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_mean", input, dim, keep_dim, name)


def reduce_max(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_max", input, dim, keep_dim, name)


def reduce_min(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_min", input, dim, keep_dim, name)


def reduce_prod(input, dim=None, keep_dim=False, name=None):
    return _reduce("reduce_prod", input, dim, keep_dim, name)


def split(input, num_or_sections, dim=-1, name=None):
    helper = LayerHelper("split", **locals())
    input_shape = input.shape
    dim = dim if dim >= 0 else dim + len(input_shape)
    if isinstance(num_or_sections, int):
        num = num_or_sections
        attrs = {"num": num, "sections": [], "axis": dim}
    else:
        num = len(num_or_sections)
        attrs = {"num": 0, "sections": list(num_or_sections), "axis": dim}
    outs = [helper.create_tmp_variable(dtype=input.dtype)
            for _ in range(num)]
    helper.append_op(type="split", inputs={"X": [input]},
                     outputs={"Out": outs}, attrs=attrs)
    return outs


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


def l2_normalize(x, axis, epsilon=1e-12, name=None):
    helper = LayerHelper("l2_normalize", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    norm = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="norm", inputs={"X": [x]},
                     outputs={"Out": [out], "Norm": [norm]},
                     attrs={"axis": 1 if axis is None else axis,
                            "epsilon": epsilon})
    return out


def one_hot(input, depth):
    helper = LayerHelper("one_hot", **locals())
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(type="one_hot", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"depth": depth})
    return out


def lrn(input, n=5, k=1.0, alpha=1e-4, beta=0.75, name=None):
    helper = LayerHelper("lrn", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    mid = helper.create_tmp_variable(dtype=input.dtype, stop_gradient=True)
    helper.append_op(type="lrn", inputs={"X": [input]},
                     outputs={"Out": [out], "MidOut": [mid]},
                     attrs={"n": n, "k": k, "alpha": alpha, "beta": beta})
    return out


def im2sequence(input, filter_size=1, stride=1, padding=0, name=None):
    helper = LayerHelper("im2sequence", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    pads = _pair(padding)
    helper.append_op(type="im2sequence", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"kernels": _pair(filter_size),
                            "strides": _pair(stride),
                            "paddings": pads + pads})
    return out


def label_smooth(label, prior_dist=None, epsilon=0.1, dtype="float32",
                 name=None):
    helper = LayerHelper("label_smooth", **locals())
    out = helper.create_tmp_variable(dtype)
    inputs = {"X": [label]}
    if prior_dist is not None:
        inputs["PriorDist"] = [prior_dist]
    helper.append_op(type="label_smooth", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def smooth_l1(x, y, inside_weight=None, outside_weight=None, sigma=None):
    helper = LayerHelper("smooth_l1", **locals())
    diff = helper.create_tmp_variable(dtype=x.dtype)
    loss = helper.create_tmp_variable(dtype=x.dtype)
    inputs = {"X": [x], "Y": [y]}
    if inside_weight is not None:
        inputs["InsideWeight"] = [inside_weight]
    if outside_weight is not None:
        inputs["OutsideWeight"] = [outside_weight]
    helper.append_op(type="smooth_l1_loss", inputs=inputs,
                     outputs={"Diff": [diff], "Out": [loss]},
                     attrs={"sigma": sigma if sigma is not None else 1.0})
    return loss


def nce(input, label, num_total_classes, sample_weight=None,
        param_attr=None, bias_attr=None, num_neg_samples=None):
    helper = LayerHelper("nce", **locals())
    dim = input.shape[1]
    w = helper.create_parameter(attr=helper.param_attr(),
                                shape=[num_total_classes, dim],
                                dtype=input.dtype)
    b = helper.create_parameter(attr=helper.bias_attr(),
                                shape=[num_total_classes],
                                dtype=input.dtype, is_bias=True)
    cost = helper.create_tmp_variable(dtype=input.dtype)
    sample_logits = helper.create_tmp_variable(dtype=input.dtype,
                                               stop_gradient=True)
    sample_labels = helper.create_tmp_variable(dtype="int64",
                                               stop_gradient=True)
    num_neg_samples = 10 if num_neg_samples is None else int(num_neg_samples)
    helper.append_op(
        type="nce",
        inputs={"Input": [input], "Label": [label], "Weight": [w],
                "Bias": [b]},
        outputs={"Cost": [cost], "SampleLogits": [sample_logits],
                 "SampleLabels": [sample_labels]},
        attrs={"num_total_classes": int(num_total_classes),
               "num_neg_samples": num_neg_samples})
    return cost


def row_conv(input, future_context_size, param_attr=None, act=None):
    _not_ported("row_conv")


def multiplex(inputs, index):
    helper = LayerHelper("multiplex", **locals())
    out = helper.create_tmp_variable(dtype=inputs[0].dtype)
    helper.append_op(type="multiplex",
                     inputs={"X": inputs, "Ids": [index]},
                     outputs={"Out": [out]})
    return out


def resize_bilinear(input, out_shape=None, scale=None, name=None):
    helper = LayerHelper("bilinear_interp", **locals())
    if out_shape is None:
        out_shape = [int(input.shape[2] * scale),
                     int(input.shape[3] * scale)]
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="bilinear_interp", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"out_h": int(out_shape[0]),
                            "out_w": int(out_shape[1])})
    return out


def prelu(x, mode="all", param_attr=None, name=None):
    helper = LayerHelper("prelu", **locals())
    if mode == "all":
        alpha_shape = [1]
    elif mode == "channel":
        alpha_shape = [x.shape[1]]
    else:
        alpha_shape = list(x.shape[1:])
    alpha = helper.create_parameter(
        attr=helper.param_attr(), shape=alpha_shape, dtype=x.dtype,
        default_initializer=ConstantInitializer(0.25))
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="prelu", inputs={"X": [x], "Alpha": [alpha]},
                     outputs={"Out": [out]}, attrs={"mode": mode})
    return out


def pad(x, paddings, pad_value=0.0, name=None):
    helper = LayerHelper("pad", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="pad", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"paddings": [int(p) for p in paddings],
                            "pad_value": float(pad_value)})
    return out


def clip(x, min, max, name=None):
    helper = LayerHelper("clip", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="clip", inputs={"X": [x]}, outputs={"Out": [out]},
                     attrs={"min": float(min), "max": float(max)})
    return out


def clip_by_norm(x, max_norm, name=None):
    helper = LayerHelper("clip_by_norm", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="clip_by_norm", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"max_norm": float(max_norm)})
    return out


def _elementwise(op_type, x, y, axis=-1, act=None, name=None):
    helper = LayerHelper(op_type, **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type=op_type, inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]}, attrs={"axis": axis})
    return helper.append_activation(out)


def elementwise_add(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_add", x, y, axis, act, name)


def elementwise_sub(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_sub", x, y, axis, act, name)


def elementwise_mul(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_mul", x, y, axis, act, name)


def elementwise_div(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_div", x, y, axis, act, name)


def elementwise_max(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_max", x, y, axis, act, name)


def elementwise_min(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_min", x, y, axis, act, name)


def elementwise_pow(x, y, axis=-1, act=None, name=None):
    return _elementwise("elementwise_pow", x, y, axis, act, name)


def expand(x, expand_times, name=None):
    helper = LayerHelper("expand", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="expand", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"expand_times": [int(t) for t in expand_times]})
    return out


def squeeze(input, axes, name=None):
    helper = LayerHelper("squeeze", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="squeeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": axes})
    return out


def unsqueeze(input, axes, name=None):
    helper = LayerHelper("unsqueeze", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="unsqueeze", inputs={"X": [input]},
                     outputs={"Out": [out]}, attrs={"axes": axes})
    return out


def gather(input, index):
    helper = LayerHelper("gather", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="gather",
                     inputs={"X": [input], "Index": [index]},
                     outputs={"Out": [out]})
    return out


def scatter(input, index, updates, name=None):
    helper = LayerHelper("scatter", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="scatter",
                     inputs={"X": [input], "Ids": [index],
                             "Updates": [updates]},
                     outputs={"Out": [out]})
    return out


def sigmoid_cross_entropy_with_logits(x, label, name=None):
    helper = LayerHelper("sigmoid_cross_entropy_with_logits", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="sigmoid_cross_entropy_with_logits",
                     inputs={"X": [x], "Label": [label]},
                     outputs={"Out": [out]})
    return out


def hinge_loss(logits, labels):
    helper = LayerHelper("hinge_loss", **locals())
    out = helper.create_tmp_variable(dtype=logits.dtype)
    helper.append_op(type="hinge_loss",
                     inputs={"Logits": [logits], "Labels": [labels]},
                     outputs={"Loss": [out]})
    return out


def huber_loss(x, y, delta):
    helper = LayerHelper("huber_loss", **locals())
    residual = helper.create_tmp_variable(dtype=x.dtype, stop_gradient=True)
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="huber_loss", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out], "Residual": [residual]},
                     attrs={"delta": float(delta)})
    return out


def log_loss(input, label, epsilon=1e-4, name=None):
    helper = LayerHelper("log_loss", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="log_loss",
                     inputs={"Predicted": [input], "Labels": [label]},
                     outputs={"Loss": [out]},
                     attrs={"epsilon": float(epsilon)})
    return out


def rank_loss(label, left, right, name=None):
    helper = LayerHelper("rank_loss", **locals())
    out = helper.create_tmp_variable("float32")
    helper.append_op(type="rank_loss",
                     inputs={"Label": [label], "Left": [left],
                             "Right": [right]},
                     outputs={"Out": [out]})
    return out


def margin_rank_loss(label, left, right, margin=0.1, name=None):
    helper = LayerHelper("margin_rank_loss", **locals())
    out = helper.create_tmp_variable("float32")
    act = helper.create_tmp_variable("float32", stop_gradient=True)
    helper.append_op(type="margin_rank_loss",
                     inputs={"Label": [label], "X1": [left], "X2": [right]},
                     outputs={"Out": [out], "Activated": [act]},
                     attrs={"margin": float(margin)})
    return out


def maxout(x, groups, name=None):
    helper = LayerHelper("maxout", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="maxout", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"groups": groups})
    return out


def relu(x, name=None):
    helper = LayerHelper("relu", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="relu", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def log(x, name=None):
    helper = LayerHelper("log", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="log", inputs={"X": [x]}, outputs={"Out": [out]})
    return out


def crop(x, shape=None, offsets=None, name=None):
    helper = LayerHelper("crop", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    inputs = {"X": [x]}
    attrs = {}
    if isinstance(shape, Variable):
        inputs["Y"] = [shape]
        attrs["shape"] = [0]
    else:
        attrs["shape"] = [int(s) for s in shape]
    attrs["offsets"] = ([int(o) for o in offsets] if offsets
                        else [0] * len(x.shape))
    helper.append_op(type="crop", inputs=inputs, outputs={"Out": [out]},
                     attrs=attrs)
    return out


def slice_op(input, axes, starts, ends, name=None):
    helper = LayerHelper("slice", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="slice", inputs={"Input": [input]},
                     outputs={"Out": [out]},
                     attrs={"axes": axes, "starts": starts, "ends": ends})
    return out


def shape_op(input, name=None):
    helper = LayerHelper("shape", **locals())
    out = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="shape", inputs={"Input": [input]},
                     outputs={"Out": [out]})
    return out


def hsigmoid(input, label, num_classes, param_attr=None, bias_attr=None):
    """Hierarchical sigmoid approximated by the nce path for parity."""
    return nce(input, label, num_classes, param_attr=param_attr,
               bias_attr=bias_attr)


def cos_sim(X, Y):
    helper = LayerHelper("cos_sim", **locals())
    out = helper.create_tmp_variable(dtype=X.dtype)
    xnorm = helper.create_tmp_variable(dtype=X.dtype, stop_gradient=True)
    ynorm = helper.create_tmp_variable(dtype=X.dtype, stop_gradient=True)
    helper.append_op(type="cos_sim", inputs={"X": [X], "Y": [Y]},
                     outputs={"Out": [out], "XNorm": [xnorm],
                              "YNorm": [ynorm]})
    return out


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    helper = LayerHelper("scale", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="scale", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"scale": float(scale), "bias": float(bias),
                            "bias_after_scale": bias_after_scale})
    return helper.append_activation(out)


def dot_product_attention(querys, keys, values):
    """(reference nets.py scaled_dot_product_attention simplified form)"""
    product = matmul(querys, keys, transpose_y=True)
    attn = softmax(product)
    return matmul(attn, values), attn


def bilinear_tensor_product(x, y, size, act=None, name=None,
                            param_attr=None, bias_attr=None):
    helper = LayerHelper("bilinear_tensor_product", **locals())
    dtype = helper.input_dtype("x")
    param_shape = [size, x.shape[1], y.shape[1]]
    w = helper.create_parameter(attr=helper.param_attr(), shape=param_shape,
                                dtype=dtype)
    out = helper.create_tmp_variable(dtype=dtype)
    inputs = {"X": [x], "Y": [y], "Weight": [w]}
    if bias_attr is not False:
        bias_size = [1, size]
        bias = helper.create_parameter(attr=helper.bias_attr(),
                                       shape=bias_size, dtype=dtype,
                                       is_bias=True)
        if bias is not None:
            inputs["Bias"] = [bias]
    helper.append_op(type="bilinear_tensor_product", inputs=inputs,
                     outputs={"Out": [out]})
    return helper.append_activation(out)


def sampling_id(x, min=0.0, max=1.0, seed=0):
    helper = LayerHelper("sampling_id", **locals())
    out = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="sampling_id", inputs={"X": [x]},
                     outputs={"Out": [out]}, attrs={"seed": seed})
    return out


def gaussian_random(shape, mean=0.0, std=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random", **locals())
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="gaussian_random", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "mean": float(mean), "std": float(std),
                            "seed": seed,
                            "dtype": int(np_dtype_to_proto(dtype))})
    return out


def uniform_random(shape, min=-1.0, max=1.0, seed=0, dtype="float32"):
    helper = LayerHelper("uniform_random", **locals())
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="uniform_random", outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "min": float(min), "max": float(max),
                            "seed": seed,
                            "dtype": int(np_dtype_to_proto(dtype))})
    return out


def gaussian_random_batch_size_like(input, shape, input_dim_idx=0,
                                    output_dim_idx=0, mean=0.0, std=1.0,
                                    seed=0, dtype="float32"):
    helper = LayerHelper("gaussian_random_batch_size_like", **locals())
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="gaussian_random_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx,
                            "mean": float(mean), "std": float(std),
                            "seed": seed,
                            "dtype": int(np_dtype_to_proto(dtype))})
    return out


def uniform_random_batch_size_like(input, shape, dtype="float32",
                                   input_dim_idx=0, output_dim_idx=0,
                                   min=-1.0, max=1.0, seed=0):
    helper = LayerHelper("uniform_random_batch_size_like", **locals())
    out = helper.create_tmp_variable(dtype)
    helper.append_op(type="uniform_random_batch_size_like",
                     inputs={"Input": [input]}, outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape],
                            "input_dim_idx": input_dim_idx,
                            "output_dim_idx": output_dim_idx,
                            "min": float(min), "max": float(max),
                            "seed": seed,
                            "dtype": int(np_dtype_to_proto(dtype))})
    return out


def random_crop(x, shape, seed=None):
    helper = LayerHelper("random_crop", **locals())
    out = helper.create_tmp_variable(dtype=x.dtype)
    helper.append_op(type="random_crop", inputs={"X": [x]},
                     outputs={"Out": [out]},
                     attrs={"shape": [int(s) for s in shape]})
    return out


def mean_iou(input, label, num_classes):
    helper = LayerHelper("mean_iou", **locals())
    out_mean_iou = helper.create_tmp_variable(dtype="float32")
    out_wrong = helper.create_tmp_variable(dtype="int32")
    out_correct = helper.create_tmp_variable(dtype="int32")
    helper.append_op(type="mean_iou",
                     inputs={"Predictions": [input], "Labels": [label]},
                     outputs={"OutMeanIou": [out_mean_iou],
                              "OutWrong": [out_wrong],
                              "OutCorrect": [out_correct]},
                     attrs={"num_classes": num_classes})
    return out_mean_iou, out_wrong, out_correct


def spp(input, pyramid_height, pool_type="max"):
    _not_ported("spp")


def beam_search(pre_ids, pre_scores, ids, scores, beam_size, end_id,
                level=0, name=None):
    """One beam-growth step (reference nn.py:2025 / beam_search_op.cc).

    Signature follows the op's evolved form with explicit ``pre_scores``
    (the 0.14 layer smuggled them through the score LoD); ``scores`` are
    the ACCUMULATED log-probs of each candidate in ``ids``.  Returns
    (selected_ids, selected_scores, parent_idx) — ancestry is an explicit
    gather index instead of the reference's output-LoD encoding."""
    helper = LayerHelper("beam_search", **locals())
    selected_ids = helper.create_tmp_variable(dtype=ids.dtype)
    selected_scores = helper.create_tmp_variable(dtype="float32")
    parent_idx = helper.create_tmp_variable(dtype="int32")
    for v in (selected_ids, selected_scores, parent_idx):
        v.stop_gradient = True
    helper.append_op(
        type="beam_search",
        inputs={"pre_ids": [pre_ids], "pre_scores": [pre_scores],
                "ids": [ids], "scores": [scores]},
        outputs={"selected_ids": [selected_ids],
                 "selected_scores": [selected_scores],
                 "parent_idx": [parent_idx]},
        attrs={"beam_size": beam_size, "end_id": end_id, "level": level})
    return selected_ids, selected_scores, parent_idx


def beam_search_decode(ids, scores, parents, beam_size, end_id, name=None):
    """Backtrack a finished decode loop's arrays into whole sequences
    (reference nn.py:1765 / beam_search_decode_op.cc).  ``ids``/``scores``
    /``parents`` are the TensorArrays written per step; returns
    (sentence_ids [N, beam, T] best-first, sentence_scores [N, beam])."""
    helper = LayerHelper("beam_search_decode", **locals())
    sentence_ids = helper.create_tmp_variable(dtype="int64")
    sentence_scores = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="beam_search_decode",
        inputs={"Ids": [ids], "Scores": [scores], "Parents": [parents]},
        outputs={"SentenceIds": [sentence_ids],
                 "SentenceScores": [sentence_scores]},
        attrs={"beam_size": beam_size, "end_id": end_id})
    return sentence_ids, sentence_scores


def linear_chain_crf(input, label, param_attr=None):
    """Linear-chain CRF cost (reference nn.py linear_chain_crf /
    linear_chain_crf_op.cc).  Creates the [K+2, K] transition parameter
    (row 0 start, row 1 stop) and returns the per-sequence negative
    log-likelihood [N, 1]."""
    helper = LayerHelper("linear_chain_crf", **locals())
    size = input.shape[-1]
    transition = helper.create_parameter(
        attr=helper.param_attr(), shape=[size + 2, size],
        dtype=helper.input_dtype())
    log_likelihood = helper.create_tmp_variable(
        dtype=helper.input_dtype())
    helper.append_op(
        type="linear_chain_crf",
        inputs={"Emission": [input], "Transition": [transition],
                "Label": [label]},
        outputs={"LogLikelihood": [log_likelihood]})
    return log_likelihood


def crf_decoding(input, param_attr, label=None):
    """Viterbi decode with the CRF's transition parameter (reference
    nn.py crf_decoding / crf_decoding_op.cc).  With ``label`` the output
    is the per-token correctness mask."""
    helper = LayerHelper("crf_decoding", **locals())
    block = helper.main_program.global_block()
    if param_attr.name in block.vars:
        transition = block.var(param_attr.name)
    else:
        # standalone inference program: declare the parameter so
        # load_persistables can fill it by name
        size = input.shape[-1]
        transition = helper.create_parameter(
            attr=param_attr, shape=[size + 2, size],
            dtype=helper.input_dtype())
    viterbi_path = helper.create_tmp_variable(dtype="int64")
    inputs = {"Emission": [input], "Transition": [transition]}
    if label is not None:
        inputs["Label"] = [label]
    helper.append_op(type="crf_decoding", inputs=inputs,
                     outputs={"ViterbiPath": [viterbi_path]})
    viterbi_path.stop_gradient = True
    return viterbi_path


def warpctc(input, label, blank=0, norm_by_times=False):
    """CTC loss (reference nn.py warpctc / warpctc_op.cc).  ``input`` is
    the raw [N, T, V] logits; returns per-sequence loss [N, 1]."""
    helper = LayerHelper("warpctc", **locals())
    loss = helper.create_tmp_variable(dtype=input.dtype)
    grad = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(
        type="warpctc", inputs={"Logits": [input], "Label": [label]},
        outputs={"Loss": [loss], "WarpCTCGrad": [grad]},
        attrs={"blank": int(blank), "norm_by_times": norm_by_times})
    return loss


def ctc_greedy_decoder(input, blank, name=None):
    """argmax + ctc_align: merge repeats then drop blanks (reference
    nn.py ctc_greedy_decoder built on ctc_align_op.cc)."""
    helper = LayerHelper("ctc_greedy_decoder", **locals())
    _, ids = topk(input, k=1)
    ids = reshape(ids, list(ids.shape[:-1]))
    out = helper.create_tmp_variable(dtype="int64")
    helper.append_op(type="ctc_align", inputs={"Input": [ids]},
                     outputs={"Output": [out]},
                     attrs={"blank": int(blank), "padding_value": 0})
    out.stop_gradient = True
    return out


def chunk_eval(input, label, chunk_scheme, num_chunk_types,
               excluded_chunk_types=None):
    """Chunk-level precision/recall/F1 (reference nn.py chunk_eval /
    chunk_eval_op.cc; schemes plain/IOB/IOE/IOBES)."""
    helper = LayerHelper("chunk_eval", **locals())
    precision = helper.create_tmp_variable(dtype="float32")
    recall = helper.create_tmp_variable(dtype="float32")
    f1_score = helper.create_tmp_variable(dtype="float32")
    num_infer = helper.create_tmp_variable(dtype="int64")
    num_label = helper.create_tmp_variable(dtype="int64")
    num_correct = helper.create_tmp_variable(dtype="int64")
    helper.append_op(
        type="chunk_eval",
        inputs={"Inference": [input], "Label": [label]},
        outputs={"Precision": [precision], "Recall": [recall],
                 "F1-Score": [f1_score], "NumInferChunks": [num_infer],
                 "NumLabelChunks": [num_label],
                 "NumCorrectChunks": [num_correct]},
        attrs={"chunk_scheme": chunk_scheme,
               "num_chunk_types": int(num_chunk_types),
               "excluded_chunk_types": list(excluded_chunk_types or [])})
    return (precision, recall, f1_score, num_infer, num_label,
            num_correct)


def conv_shift(x, y):
    _not_ported("conv_shift")


def modified_huber_loss(input, label):
    """Modified Huber loss for binary classification (reference
    modified_huber_loss_op.cc): label in {0, 1}."""
    helper = LayerHelper("modified_huber_loss", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    inter = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="modified_huber_loss",
                     inputs={"X": [input], "Y": [label]},
                     outputs={"Out": [out], "IntermediateVal": [inter]})
    return out


def roi_pool(input, rois, pooled_height, pooled_width, spatial_scale=1.0):
    _not_ported("roi_pool")


def unpool(input, indices, unpool_size, unpool_stride=None,
           unpool_padding=0):
    _not_ported("unpool")


def lambda_rank(score, label, ndcg_num=5, return_ndcg=False):
    """LambdaRank cost per query (reference LambdaCost ->
    lambda_rank op); ``score`` = model outputs, ``label`` = gold
    relevance, ragged sequences over each query's candidates.  With
    return_ndcg, also returns the reference forward's reported
    NDCG@k."""
    helper = LayerHelper("lambda_rank", **locals())
    out = helper.create_tmp_variable(dtype="float32")
    ndcg = helper.create_tmp_variable(dtype="float32",
                                      stop_gradient=True)
    helper.append_op(type="lambda_rank",
                     inputs={"Score": [score], "Label": [label]},
                     outputs={"Out": [out], "NDCG": [ndcg]},
                     attrs={"NDCG_num": int(ndcg_num)})
    return (out, ndcg) if return_ndcg else out


def scale_sub_region(x, indices, value):
    _not_ported("scale_sub_region")
