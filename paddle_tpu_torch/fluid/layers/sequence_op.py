"""Sequence (LoD) layers.

Counterpart of ``paddle_tpu/fluid/layers/sequence_op.py``, function for
function, so the same calls build the same ProgramDesc in both packages
(parity: reference python/paddle/fluid/layers/nn.py dynamic_lstm /
dynamic_gru / sequence_* builders over operators/sequence_*_op.cc,
lstm_op.cc, gru_op.cc).  The ops are ``ops/sequence.py``'s.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = [
    "kmax_seq_score", "sub_nested_seq",
    "dynamic_lstm", "dynamic_gru", "sequence_pool", "sequence_softmax",
    "sequence_expand", "sequence_conv", "sequence_first_step",
    "sequence_last_step", "sequence_erase", "lod_reset", "edit_distance",
    "lstm_unit", "gru_unit", "dynamic_lstmp", "sequence_concat",
    "sequence_reshape", "sequence_slice",
]


def dynamic_lstm(input, size, h_0=None, c_0=None, param_attr=None,
                 bias_attr=None, use_peepholes=True, is_reverse=False,
                 gate_activation="sigmoid", cell_activation="tanh",
                 candidate_activation="tanh", dtype="float32", name=None):
    """LSTM over a ragged batch (reference nn.py dynamic_lstm).  ``input``
    is the pre-projected [N, T, 4H] tensor (size = 4H)."""
    helper = LayerHelper("lstm", **locals())
    hidden_size = size // 4
    weight = helper.create_parameter(
        attr=helper.param_attr(), shape=[hidden_size, 4 * hidden_size],
        dtype=dtype)
    bias_size = [1, 7 * hidden_size if use_peepholes else 4 * hidden_size]
    bias = helper.create_parameter(attr=helper.bias_attr(), shape=bias_size,
                                   dtype=dtype, is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    if c_0 is not None:
        inputs["C0"] = [c_0]
    helper.append_op(
        type="lstm", inputs=inputs,
        outputs={"Hidden": [hidden], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation})
    return hidden, cell


def dynamic_gru(input, size, h_0=None, param_attr=None, bias_attr=None,
                is_reverse=False, gate_activation="sigmoid",
                candidate_activation="tanh", dtype="float32", name=None):
    """GRU over a ragged batch (reference nn.py dynamic_gru).  ``input``
    is the pre-projected [N, T, 3D] tensor (size = D)."""
    helper = LayerHelper("gru", **locals())
    weight = helper.create_parameter(attr=helper.param_attr(),
                                     shape=[size, 3 * size], dtype=dtype)
    bias = helper.create_parameter(attr=helper.bias_attr(),
                                   shape=[1, 3 * size], dtype=dtype,
                                   is_bias=True)
    hidden = helper.create_tmp_variable(dtype)
    inputs = {"Input": [input], "Weight": [weight], "Bias": [bias]}
    if h_0 is not None:
        inputs["H0"] = [h_0]
    helper.append_op(
        type="gru", inputs=inputs, outputs={"Hidden": [hidden]},
        attrs={"is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "activation": candidate_activation})
    return hidden


def sequence_pool(input, pool_type, name=None):
    helper = LayerHelper("sequence_pool", **locals())
    out = helper.create_tmp_variable(input.dtype)
    max_index = helper.create_tmp_variable("int32")
    helper.append_op(
        type="sequence_pool", inputs={"X": [input]},
        outputs={"Out": [out], "MaxIndex": [max_index]},
        attrs={"pooltype": pool_type.upper()})
    return out


def sequence_first_step(input, name=None):
    return sequence_pool(input, "first")


def sequence_last_step(input, name=None):
    return sequence_pool(input, "last")


def sequence_softmax(input, name=None, use_cudnn=True):
    helper = LayerHelper("sequence_softmax", **locals())
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_softmax", inputs={"X": [input]},
                     outputs={"Out": [out]})
    return out


def sequence_expand(x, y, ref_level=-1, name=None):
    helper = LayerHelper("sequence_expand", **locals())
    out = helper.create_tmp_variable(x.dtype)
    helper.append_op(type="sequence_expand",
                     inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]},
                     attrs={"ref_level": ref_level})
    return out


def sequence_conv(input, num_filters, filter_size=3, filter_stride=1,
                  padding=None, bias_attr=None, param_attr=None, act=None,
                  name=None):
    helper = LayerHelper("sequence_conv", **locals())
    dtype = helper.input_dtype()
    filter_shape = [filter_size * input.shape[-1], num_filters]
    filter_param = helper.create_parameter(attr=helper.param_attr(),
                                           shape=filter_shape, dtype=dtype)
    out = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="sequence_conv",
        inputs={"X": [input], "Filter": [filter_param]},
        outputs={"Out": [out]},
        attrs={"contextStride": filter_stride,
               "contextStart": -int(filter_size // 2),
               "contextLength": filter_size})
    out = helper.append_bias_op(out, dim_start=2)
    return helper.append_activation(out)


def sequence_erase(input, tokens, name=None):
    helper = LayerHelper("sequence_erase", **locals())
    out = helper.create_tmp_variable(input.dtype)
    helper.append_op(type="sequence_erase", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"tokens": list(tokens)})
    return out


def lod_reset(x, y=None, target_lod=None):
    helper = LayerHelper("lod_reset", **locals())
    out = helper.create_tmp_variable(x.dtype)
    inputs = {"X": [x]}
    if y is not None:
        inputs["Y"] = [y]
    helper.append_op(type="lod_reset", inputs=inputs,
                     outputs={"Out": [out]},
                     attrs={"target_lod": list(target_lod or [])})
    return out


def edit_distance(input, label, normalized=True, ignored_tokens=None,
                  name=None):
    helper = LayerHelper("edit_distance", **locals())
    if ignored_tokens:
        input = sequence_erase(input, ignored_tokens)
        label = sequence_erase(label, ignored_tokens)
    out = helper.create_tmp_variable("float32")
    seq_num = helper.create_tmp_variable("int64")
    helper.append_op(type="edit_distance",
                     inputs={"Hyps": [input], "Refs": [label]},
                     outputs={"Out": [out], "SequenceNum": [seq_num]},
                     attrs={"normalized": normalized})
    return out, seq_num


def lstm_unit(x_t, hidden_t_prev, cell_t_prev, forget_bias=0.0,
              param_attr=None, bias_attr=None, name=None):
    """One LSTM step from raw x (reference nn.py lstm_unit: concat[x, h]
    -> fc -> lstm_unit op)."""
    from . import nn as nn_layers
    from . import tensor as tensor_layers
    helper = LayerHelper("lstm_unit_layer", **locals())
    size = cell_t_prev.shape[-1]
    concat = tensor_layers.concat([x_t, hidden_t_prev], axis=-1)
    fc_out = nn_layers.fc(concat, size=4 * size, param_attr=param_attr,
                          bias_attr=bias_attr)
    c = helper.create_tmp_variable(x_t.dtype)
    h = helper.create_tmp_variable(x_t.dtype)
    helper.append_op(type="lstm_unit",
                     inputs={"X": [fc_out], "C_prev": [cell_t_prev]},
                     outputs={"C": [c], "H": [h]},
                     attrs={"forget_bias": forget_bias})
    return h, c


def gru_unit(input, hidden, size, param_attr=None, bias_attr=None,
             activation="tanh", gate_activation="sigmoid", name=None):
    """One GRU step (reference nn.py gru_unit); size = 3*D."""
    helper = LayerHelper("gru_unit_layer", **locals())
    d = size // 3
    weight = helper.create_parameter(attr=helper.param_attr(),
                                     shape=[d, 3 * d], dtype=input.dtype)
    bias = helper.create_parameter(attr=helper.bias_attr(),
                                   shape=[1, 3 * d], dtype=input.dtype,
                                   is_bias=True)
    gate = helper.create_tmp_variable(input.dtype)
    reset_hidden = helper.create_tmp_variable(input.dtype)
    updated = helper.create_tmp_variable(input.dtype)
    helper.append_op(
        type="gru_unit",
        inputs={"Input": [input], "HiddenPrev": [hidden],
                "Weight": [weight], "Bias": [bias]},
        outputs={"Gate": [gate], "ResetHiddenPrev": [reset_hidden],
                 "Hidden": [updated]},
        attrs={"activation": activation,
               "gate_activation": gate_activation})
    return updated, reset_hidden, gate


def dynamic_lstmp(input, size, proj_size, param_attr=None,
                  bias_attr=None, use_peepholes=True, is_reverse=False,
                  gate_activation="sigmoid", cell_activation="tanh",
                  candidate_activation="tanh", proj_activation="tanh",
                  dtype="float32", name=None):
    """LSTM with recurrent projection (reference nn.py dynamic_lstmp /
    lstmp_op.cc).  Returns (projection [N,T,P], cell [N,T,H])."""
    helper = LayerHelper("lstmp", **locals())
    hidden_size = size // 4
    # two distinct parameters: replicate the (possibly shared) attr so
    # create_parameter doesn't collide Weight and ProjWeight on one name
    w_attr, proj_attr = helper.multiple_param_attr(2)
    weight = helper.create_parameter(
        attr=w_attr, shape=[proj_size, 4 * hidden_size], dtype=dtype)
    proj_weight = helper.create_parameter(
        attr=proj_attr, shape=[hidden_size, proj_size], dtype=dtype)
    bias_size = [1, 7 * hidden_size if use_peepholes
                 else 4 * hidden_size]
    bias = helper.create_parameter(attr=helper.bias_attr(),
                                   shape=bias_size, dtype=dtype,
                                   is_bias=True)
    proj = helper.create_tmp_variable(dtype)
    cell = helper.create_tmp_variable(dtype)
    helper.append_op(
        type="lstmp",
        inputs={"Input": [input], "Weight": [weight],
                "ProjWeight": [proj_weight], "Bias": [bias]},
        outputs={"Projection": [proj], "Cell": [cell]},
        attrs={"use_peepholes": use_peepholes, "is_reverse": is_reverse,
               "gate_activation": gate_activation,
               "cell_activation": cell_activation,
               "candidate_activation": candidate_activation,
               "proj_activation": proj_activation})
    return proj, cell


def sequence_concat(input, name=None):
    """Concatenate sequences row-wise along time (reference nn.py
    sequence_concat / sequence_concat_op.cc)."""
    helper = LayerHelper("sequence_concat", **locals())
    xs = input if isinstance(input, (list, tuple)) else [input]
    out = helper.create_tmp_variable(dtype=xs[0].dtype)
    helper.append_op(type="sequence_concat", inputs={"X": list(xs)},
                     outputs={"Out": [out]})
    return out


def sequence_reshape(input, new_dim):
    """Change token width, rescaling sequence lengths (reference nn.py
    sequence_reshape / sequence_reshape_op.cc)."""
    helper = LayerHelper("sequence_reshape", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="sequence_reshape", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"new_dim": int(new_dim)})
    return out


def sequence_slice(input, offset, length, name=None):
    """Per-sequence [offset, offset+length) slice (reference nn.py
    sequence_slice / sequence_slice_op.cc)."""
    helper = LayerHelper("sequence_slice", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    helper.append_op(type="sequence_slice",
                     inputs={"X": [input], "Offset": [offset],
                             "Length": [length]},
                     outputs={"Out": [out]})
    for v in (offset, length):
        v.stop_gradient = True
    return out


def kmax_seq_score(input, beam_size=1):
    """Top-k score positions per sequence (reference
    kmax_seq_score_layer -> kmax_seq_score op); returns [N, beam_size]
    int32 indices, -1 padded for short sequences."""
    helper = LayerHelper("kmax_seq_score", **locals())
    out = helper.create_tmp_variable(dtype="int32")
    helper.append_op(type="kmax_seq_score", inputs={"X": [input]},
                     outputs={"Out": [out]},
                     attrs={"beam_size": int(beam_size)})
    out.stop_gradient = True
    return out


def sub_nested_seq(input, selected_indices):
    """Keep the selected inner sub-sequences of a level-2 input
    (reference sub_nested_seq_layer -> sub_nested_seq op)."""
    helper = LayerHelper("sub_nested_seq", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    out.desc.lod_level = 2
    helper.append_op(
        type="sub_nested_seq",
        inputs={"X": [input], "SelectedIndices": [selected_indices]},
        outputs={"Out": [out]})
    return out
