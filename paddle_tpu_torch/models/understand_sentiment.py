"""Sentiment-classification book models (counterpart of
``paddle_tpu/models/understand_sentiment.py``; parity:
python/paddle/fluid/tests/book/notest_understand_sentiment.py — the
convolution net, the hand-built DynamicRNN LSTM; the stacked-LSTM
variant lives in models/stacked_dynamic_lstm.py).

Text towers are ragged (lod_level=1) batches.  ``convolution_net``
(sequence_conv_pool, an ``is_sparse`` embedding, Adagrad) runs;
``dyn_rnn_lstm`` needs ``DynamicRNN``, which is not ported yet, and
raises NotImplementedError.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["convolution_net", "dyn_rnn_lstm", "get_model"]


def convolution_net(data, input_dim, class_dim=2, emb_dim=32, hid_dim=32):
    """Two context-window conv towers (filter 3 and 4) with sqrt pooling
    (reference notest_understand_sentiment.py:27)."""
    emb = fluid.layers.embedding(input=data, size=[input_dim, emb_dim],
                                 is_sparse=True)
    conv_3 = fluid.nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                           filter_size=3, act="tanh",
                                           pool_type="sqrt")
    conv_4 = fluid.nets.sequence_conv_pool(input=emb, num_filters=hid_dim,
                                           filter_size=4, act="tanh",
                                           pool_type="sqrt")
    return fluid.layers.fc(input=[conv_3, conv_4], size=class_dim,
                           act="softmax")


def dyn_rnn_lstm(data, input_dim, class_dim=2, emb_dim=32, lstm_size=128):
    """An LSTM cell written out gate by gate inside a DynamicRNN block
    (reference notest_understand_sentiment.py:52).  DynamicRNN, a
    sub-block with its tensor arrays, is not ported yet."""
    raise NotImplementedError(
        "understand_sentiment net='dyn_rnn' needs DynamicRNN (sub-blocks "
        "and control flow), which is not ported to paddle_tpu_torch yet "
        "(ROADMAP queue 1 item \"1 + 6 (rest)\", sub-blocks)")


def get_model(dict_dim, net="conv", class_dim=2, emb_dim=32, hid_dim=32,
              learning_rate=0.002):
    """(avg_cost, [data, label], [accuracy]) in the current program."""
    data = fluid.layers.data(name="words", shape=[1], dtype="int64",
                             lod_level=1)
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    if net == "conv":
        prediction = convolution_net(data, dict_dim, class_dim, emb_dim,
                                     hid_dim)
    elif net == "dyn_rnn":
        prediction = dyn_rnn_lstm(data, dict_dim, class_dim, emb_dim,
                                  lstm_size=hid_dim)
    else:
        raise ValueError("net must be conv|dyn_rnn, got %r" % net)
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = fluid.layers.mean(cost)
    accuracy = fluid.layers.accuracy(input=prediction, label=label)
    fluid.optimizer.Adagrad(learning_rate=learning_rate).minimize(avg_cost)
    return avg_cost, [data, label], [accuracy]
