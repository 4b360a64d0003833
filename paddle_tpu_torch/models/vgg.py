"""VGG16-BN (parity: benchmark/fluid/models/vgg.py:28 vgg16_bn_drop).

Counterpart of ``paddle_tpu/models/vgg.py``, with the same function
names, so the tests build the same graph in both packages: thirteen
NCHW 3x3 conv + BN + relu layers in five groups, each group ending in a
2x2 max pool, with dropout after most of them (``fluid.nets
.img_conv_group``), then dropout, fc 512, BN + relu, dropout, fc 512
and the classifier, under Adam.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["vgg16_bn_drop", "get_model"]


def vgg16_bn_drop(input, is_test=False):
    def conv_block(input, num_filter, groups, dropouts):
        return fluid.nets.img_conv_group(
            input=input, pool_size=2, pool_stride=2,
            conv_num_filter=[num_filter] * groups, conv_filter_size=3,
            conv_act="relu", conv_with_batchnorm=True,
            conv_batchnorm_drop_rate=dropouts, pool_type="max")

    conv1 = conv_block(input, 64, 2, [0.3, 0])
    conv2 = conv_block(conv1, 128, 2, [0.4, 0])
    conv3 = conv_block(conv2, 256, 3, [0.4, 0.4, 0])
    conv4 = conv_block(conv3, 512, 3, [0.4, 0.4, 0])
    conv5 = conv_block(conv4, 512, 3, [0.4, 0.4, 0])

    drop = fluid.layers.dropout(x=conv5, dropout_prob=0.5,
                                is_test=is_test)
    fc1 = fluid.layers.fc(input=drop, size=512, act=None)
    bn = fluid.layers.batch_norm(input=fc1, act="relu", is_test=is_test)
    drop2 = fluid.layers.dropout(x=bn, dropout_prob=0.5, is_test=is_test)
    fc2 = fluid.layers.fc(input=drop2, size=512, act=None)
    return fc2


def get_model(data_set="cifar10", learning_rate=1e-3, is_test=False):
    """(avg_cost, [image, label], [batch_acc]) — reference vgg.py:55."""
    if data_set == "cifar10":
        classdim, data_shape = 10, [3, 32, 32]
    else:
        classdim, data_shape = 102, [3, 224, 224]
    images = fluid.layers.data(name="data", shape=data_shape,
                               dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    net = vgg16_bn_drop(images, is_test=is_test)
    predict = fluid.layers.fc(input=net, size=classdim, act="softmax")
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)
    if not is_test:
        opt = fluid.optimizer.Adam(learning_rate=learning_rate)
        opt.minimize(avg_cost)
    return avg_cost, [images, label], [batch_acc]
