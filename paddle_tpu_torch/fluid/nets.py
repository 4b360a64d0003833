"""Composite networks (counterpart of ``paddle_tpu/fluid/nets.py``,
parity: python/paddle/fluid/nets.py): the image blocks the VGG and
MNIST models build from, and ``sequence_conv_pool``, the sentiment
net's text tower.  ``glu`` and the attention composite are not ported
yet (ROADMAP queue 1 item 7)."""
from __future__ import annotations

from . import layers

__all__ = ["simple_img_conv_pool", "img_conv_group", "sequence_conv_pool"]


def simple_img_conv_pool(input, num_filters, filter_size, pool_size,
                         pool_stride, act, param_attr=None,
                         pool_type="max", use_cudnn=True, use_mkldnn=False):
    conv_out = layers.conv2d(input=input, num_filters=num_filters,
                             filter_size=filter_size, param_attr=param_attr,
                             act=act)
    return layers.pool2d(input=conv_out, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def img_conv_group(input, conv_num_filter, pool_size, conv_padding=1,
                   conv_filter_size=3, conv_act=None, param_attr=None,
                   conv_with_batchnorm=False, conv_batchnorm_drop_rate=0.0,
                   pool_stride=1, pool_type="max", use_cudnn=True,
                   use_mkldnn=False):
    tmp = input
    assert isinstance(conv_num_filter, (list, tuple))

    def _extend(v):
        return v if hasattr(v, "__len__") else [v] * len(conv_num_filter)

    conv_padding = _extend(conv_padding)
    conv_filter_size = _extend(conv_filter_size)
    param_attr = _extend(param_attr)
    conv_with_batchnorm = _extend(conv_with_batchnorm)
    conv_batchnorm_drop_rate = _extend(conv_batchnorm_drop_rate)

    for i in range(len(conv_num_filter)):
        local_conv_act = conv_act
        if conv_with_batchnorm[i]:
            local_conv_act = None
        tmp = layers.conv2d(input=tmp, num_filters=conv_num_filter[i],
                            filter_size=conv_filter_size[i],
                            padding=conv_padding[i],
                            param_attr=param_attr[i], act=local_conv_act)
        if conv_with_batchnorm[i]:
            tmp = layers.batch_norm(input=tmp, act=conv_act)
            drop_rate = conv_batchnorm_drop_rate[i]
            if abs(drop_rate) > 1e-5:
                tmp = layers.dropout(x=tmp, dropout_prob=drop_rate)
    return layers.pool2d(input=tmp, pool_size=pool_size,
                         pool_type=pool_type, pool_stride=pool_stride)


def sequence_conv_pool(input, num_filters, filter_size, param_attr=None,
                       act="sigmoid", pool_type="max"):
    """Context-window conv over a ragged batch, then a whole-sequence
    pool (reference nets.py sequence_conv_pool: the sentiment /
    recommender text tower)."""
    conv_out = layers.sequence_conv(input=input, num_filters=num_filters,
                                    filter_size=filter_size,
                                    param_attr=param_attr, act=act)
    return layers.sequence_pool(input=conv_out, pool_type=pool_type)
