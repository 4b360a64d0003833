"""MNIST ConvNet (counterpart of ``paddle_tpu/models/mnist.py``; parity:
benchmark/fluid/models/mnist.py:36 cnn_model): the same fluid program,
built by the port's fluid, so its desc serializes as the reference's."""
from __future__ import annotations

import numpy as np

import paddle_tpu_torch.fluid as fluid

__all__ = ["cnn_model", "get_model"]


def cnn_model(data):
    conv_pool_1 = fluid.nets.simple_img_conv_pool(
        input=data, filter_size=5, num_filters=20, pool_size=2,
        pool_stride=2, act="relu")
    conv_pool_2 = fluid.nets.simple_img_conv_pool(
        input=conv_pool_1, filter_size=5, num_filters=50, pool_size=2,
        pool_stride=2, act="relu")

    size = 10
    input_shape = conv_pool_2.shape
    param_shape = [int(np.prod(input_shape[1:]))] + [size]
    scale = (2.0 / (param_shape[0] ** 2 * size)) ** 0.5
    predict = fluid.layers.fc(
        input=conv_pool_2, size=size, act="softmax",
        param_attr=fluid.param_attr.ParamAttr(
            initializer=fluid.initializer.NormalInitializer(
                loc=0.0, scale=scale)))
    return predict


def get_model(batch_size=64, learning_rate=0.001):
    """Build the train graph in the current default program.

    Returns (avg_cost, [img, label], [batch_acc]) like the reference
    harness's ``get_model`` (benchmark/fluid/models/mnist.py:69).
    """
    images = fluid.layers.data(name="pixel", shape=[1, 28, 28],
                               dtype="float32")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    predict = cnn_model(images)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)
    opt = fluid.optimizer.Adam(learning_rate=learning_rate, beta1=0.9,
                               beta2=0.999)
    opt.minimize(avg_cost)
    return avg_cost, [images, label], [batch_acc]
