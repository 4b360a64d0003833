"""GoogLeNet / Inception-v1 (counterpart of
``paddle_tpu/models/googlenet.py``, function for function: the legacy
benchmark's googlenet workload; 9 inception modules, the main head only,
NCHW, Momentum).  No TPU kernel is on its path."""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["googlenet", "get_model"]


def _conv(input, num_filters, filter_size, stride=1, padding=0):
    return fluid.layers.conv2d(input, num_filters=num_filters,
                               filter_size=filter_size, stride=stride,
                               padding=padding, act="relu")


def _inception(x, c1, c3r, c3, c5r, c5, proj):
    """One inception module: 1x1 / 3x3 / 5x5 towers + pooled projection,
    channel-concatenated."""
    t1 = _conv(x, c1, 1)
    t3 = _conv(_conv(x, c3r, 1), c3, 3, padding=1)
    t5 = _conv(_conv(x, c5r, 1), c5, 5, padding=2)
    tp = _conv(fluid.layers.pool2d(x, pool_size=3, pool_stride=1,
                                   pool_padding=1, pool_type="max"),
               proj, 1)
    return fluid.layers.concat([t1, t3, t5, tp], axis=1)


def googlenet(input, class_dim, is_test=False):
    x = _conv(input, 64, 7, stride=2, padding=3)
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2,
                            pool_padding=1, pool_type="max")
    x = fluid.layers.lrn(x, n=5)
    x = _conv(_conv(x, 64, 1), 192, 3, padding=1)
    x = fluid.layers.lrn(x, n=5)
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2,
                            pool_padding=1, pool_type="max")

    x = _inception(x, 64, 96, 128, 16, 32, 32)     # 3a
    x = _inception(x, 128, 128, 192, 32, 96, 64)   # 3b
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2,
                            pool_padding=1, pool_type="max")
    x = _inception(x, 192, 96, 208, 16, 48, 64)    # 4a
    x = _inception(x, 160, 112, 224, 24, 64, 64)   # 4b
    x = _inception(x, 128, 128, 256, 24, 64, 64)   # 4c
    x = _inception(x, 112, 144, 288, 32, 64, 64)   # 4d
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 4e
    x = fluid.layers.pool2d(x, pool_size=3, pool_stride=2,
                            pool_padding=1, pool_type="max")
    x = _inception(x, 256, 160, 320, 32, 128, 128)  # 5a
    x = _inception(x, 384, 192, 384, 48, 128, 128)  # 5b

    x = fluid.layers.pool2d(x, pool_size=7, pool_stride=1,
                            pool_type="avg")
    x = fluid.layers.dropout(x, dropout_prob=0.4, is_test=is_test)
    return fluid.layers.fc(x, size=class_dim, act="softmax")


def get_model(class_dim=102, learning_rate=0.01, is_test=False):
    """(avg_cost, [image, label], [batch_acc]) at ImageNet shapes."""
    images = fluid.layers.data(name="data", shape=[3, 224, 224],
                               dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = googlenet(images, class_dim, is_test=is_test)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)
    if not is_test:
        fluid.optimizer.Momentum(learning_rate=learning_rate,
                                 momentum=0.9).minimize(avg_cost)
    return avg_cost, [images, label], [batch_acc]
