"""ResNet for cifar10 / imagenet (parity: benchmark/fluid/models/resnet.py:
conv_bn_layer:32, basicblock:53, bottleneck:60, resnet_imagenet:75,
resnet_cifar10:102).

Counterpart of ``paddle_tpu/models/resnet.py``, with the same function
names, so the tests build the same graphs in both packages.  The NCHW
program runs its convs through ``F.conv2d``; under
``FLAGS.conv_layout=NHWC`` (and ``conv_fused_stages``) every conv + BN
(+ residual) (+ relu) chain becomes one ``fused_conv2d_bn_act`` op
backed by the hand-written conv-stage kernel.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["resnet_imagenet", "resnet_cifar10", "get_model"]


def conv_bn_layer(input, ch_out, filter_size, stride, padding, act="relu",
                  is_test=False):
    conv1 = fluid.layers.conv2d(
        input=input, filter_size=filter_size, num_filters=ch_out,
        stride=stride, padding=padding, act=None, bias_attr=False)
    return fluid.layers.batch_norm(input=conv1, act=act, is_test=is_test)


def shortcut(input, ch_out, stride, is_test=False):
    ch_in = input.shape[1]
    if ch_in != ch_out:
        return conv_bn_layer(input, ch_out, 1, stride, 0, None,
                             is_test=is_test)
    return input


def basicblock(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 3, stride, 1, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, act=None, is_test=is_test)
    return fluid.layers.elementwise_add(x=short, y=conv2, act="relu")


def bottleneck(input, ch_out, stride, is_test=False):
    short = shortcut(input, ch_out * 4, stride, is_test=is_test)
    conv1 = conv_bn_layer(input, ch_out, 1, stride, 0, is_test=is_test)
    conv2 = conv_bn_layer(conv1, ch_out, 3, 1, 1, is_test=is_test)
    conv3 = conv_bn_layer(conv2, ch_out * 4, 1, 1, 0, act=None,
                          is_test=is_test)
    return fluid.layers.elementwise_add(x=short, y=conv3, act="relu")


def layer_warp(block_func, input, ch_out, count, stride, is_test=False):
    res_out = block_func(input, ch_out, stride, is_test=is_test)
    for _ in range(1, count):
        res_out = block_func(res_out, ch_out, 1, is_test=is_test)
    return res_out


def resnet_imagenet(input, class_dim, depth=50, is_test=False):
    cfg = {
        18: ([2, 2, 2, 1], basicblock),
        34: ([3, 4, 6, 3], basicblock),
        50: ([3, 4, 6, 3], bottleneck),
        101: ([3, 4, 23, 3], bottleneck),
        152: ([3, 8, 36, 3], bottleneck),
    }
    stages, block_func = cfg[depth]
    conv1 = conv_bn_layer(input, ch_out=64, filter_size=7, stride=2,
                          padding=3, is_test=is_test)
    pool1 = fluid.layers.pool2d(input=conv1, pool_type="avg", pool_size=3,
                                pool_stride=2)
    res1 = layer_warp(block_func, pool1, 64, stages[0], 1, is_test=is_test)
    res2 = layer_warp(block_func, res1, 128, stages[1], 2, is_test=is_test)
    res3 = layer_warp(block_func, res2, 256, stages[2], 2, is_test=is_test)
    res4 = layer_warp(block_func, res3, 512, stages[3], 2, is_test=is_test)
    pool2 = fluid.layers.pool2d(input=res4, pool_size=7, pool_type="avg",
                                pool_stride=1, global_pooling=True)
    out = fluid.layers.fc(input=pool2, size=class_dim, act="softmax")
    return out


def resnet_cifar10(input, class_dim, depth=32, is_test=False):
    assert (depth - 2) % 6 == 0
    n = (depth - 2) // 6
    conv1 = conv_bn_layer(input=input, ch_out=16, filter_size=3, stride=1,
                          padding=1, is_test=is_test)
    res1 = layer_warp(basicblock, conv1, 16, n, 1, is_test=is_test)
    res2 = layer_warp(basicblock, res1, 32, n, 2, is_test=is_test)
    res3 = layer_warp(basicblock, res2, 64, n, 2, is_test=is_test)
    pool = fluid.layers.pool2d(input=res3, pool_size=8, pool_type="avg",
                               pool_stride=1)
    out = fluid.layers.fc(input=pool, size=class_dim, act="softmax")
    return out


def get_model(data_set="flowers", depth=50, learning_rate=0.01,
              is_test=False, input_dtype="float32", data_format=None,
              fused_stages=None):
    """Build train graph; (avg_cost, [input, label], [batch_acc]).

    data_set 'cifar10' → 32×32/10-way resnet_cifar10; 'flowers'/'imagenet'
    → 224×224 resnet_imagenet (reference resnet.py get_model:119).

    input_dtype 'uint8': the data layer takes raw bytes and the graph
    casts + scales by 1/255 on the device (the reference normalizes on
    the host before the feed, image/image.py; shipping uint8 and
    normalizing on the device is the same math at a quarter of the
    traffic).

    data_format None → ``FLAGS.conv_layout``; 'NHWC' runs the
    LayoutTranspiler on the built graph BEFORE backward generation: NHWC
    pinned end-to-end, weights stored HWIO, and (fused_stages, default
    ``FLAGS.conv_fused_stages``) conv+BN+act stages fused into the
    conv-stage op (K6, kernels/conv_fused.py).  The feed contract stays
    NCHW — one transpose bridges the feed into the pinned domain.
    """
    from paddle_tpu_torch.core.flags import FLAGS

    if data_format is None:
        data_format = FLAGS.conv_layout or "NCHW"
    if fused_stages is None:
        fused_stages = bool(FLAGS.conv_fused_stages)

    if data_set == "cifar10":
        class_dim, dshape, model = 10, [3, 32, 32], resnet_cifar10
        kwargs = {"depth": 32 if depth == 50 else depth}
    else:
        class_dim = 102 if data_set == "flowers" else 1000
        dshape, model = [3, 224, 224], resnet_imagenet
        kwargs = {"depth": depth}

    input = fluid.layers.data(name="data", shape=dshape, dtype=input_dtype)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    x = input
    if input_dtype == "uint8":
        x = fluid.layers.scale(fluid.layers.cast(input, "float32"),
                               scale=1.0 / 255.0)
    predict = model(x, class_dim, is_test=is_test, **kwargs)
    cost = fluid.layers.cross_entropy(input=predict, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=predict, label=label)
    if data_format == "NHWC":
        # before minimize: backward then differentiates the pinned
        # forward, so filter grads / optimizer state are HWIO too
        from paddle_tpu_torch.fluid.transpiler import LayoutTranspiler
        LayoutTranspiler().transpile(
            fluid.default_main_program(),
            startup_program=fluid.default_startup_program(),
            data_format="NHWC", fuse_stages=fused_stages)
    if not is_test:
        opt = fluid.optimizer.Momentum(learning_rate=learning_rate,
                                       momentum=0.9)
        opt.minimize(avg_cost)
    return avg_cost, [input, label], [batch_acc]
