"""AlexNet (counterpart of ``paddle_tpu/models/alexnet.py``, function
for function: the legacy benchmark's alexnet workload, benchmark/README.md
publishing its K40m ms/batch; the classic 5-conv / 3-fc net with LRN and
grouped convs, NCHW, Momentum).  No TPU kernel is on its path: the convs
are ``F.conv2d``, ``lrn`` a plain torch op."""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["alexnet", "get_model"]


def alexnet(input, class_dim, is_test=False):
    conv1 = fluid.layers.conv2d(input, num_filters=96, filter_size=11,
                                stride=4, padding=2, act="relu")
    lrn1 = fluid.layers.lrn(conv1, n=5, alpha=1e-4, beta=0.75)
    pool1 = fluid.layers.pool2d(lrn1, pool_size=3, pool_stride=2,
                                pool_type="max")
    conv2 = fluid.layers.conv2d(pool1, num_filters=256, filter_size=5,
                                padding=2, groups=2, act="relu")
    lrn2 = fluid.layers.lrn(conv2, n=5, alpha=1e-4, beta=0.75)
    pool2 = fluid.layers.pool2d(lrn2, pool_size=3, pool_stride=2,
                                pool_type="max")
    conv3 = fluid.layers.conv2d(pool2, num_filters=384, filter_size=3,
                                padding=1, act="relu")
    conv4 = fluid.layers.conv2d(conv3, num_filters=384, filter_size=3,
                                padding=1, groups=2, act="relu")
    conv5 = fluid.layers.conv2d(conv4, num_filters=256, filter_size=3,
                                padding=1, groups=2, act="relu")
    pool5 = fluid.layers.pool2d(conv5, pool_size=3, pool_stride=2,
                                pool_type="max")
    fc6 = fluid.layers.fc(pool5, size=4096, act="relu")
    drop6 = fluid.layers.dropout(fc6, dropout_prob=0.5, is_test=is_test)
    fc7 = fluid.layers.fc(drop6, size=4096, act="relu")
    drop7 = fluid.layers.dropout(fc7, dropout_prob=0.5, is_test=is_test)
    return fluid.layers.fc(drop7, size=class_dim, act="softmax")


def get_model(class_dim=102, learning_rate=0.01, is_test=False):
    """(avg_cost, [image, label], [batch_acc]) at ImageNet shapes."""
    images = fluid.layers.data(name="data", shape=[3, 224, 224],
                               dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = alexnet(images, class_dim, is_test=is_test)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)
    if not is_test:
        fluid.optimizer.Momentum(learning_rate=learning_rate,
                                 momentum=0.9).minimize(avg_cost)
    return avg_cost, [images, label], [batch_acc]
