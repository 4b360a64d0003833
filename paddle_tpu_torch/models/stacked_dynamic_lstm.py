"""Stacked LSTM sentiment model on ragged batches (counterpart of
``paddle_tpu/models/stacked_dynamic_lstm.py``, with the same function
names, so the tests build the same program in both packages; parity:
benchmark/fluid/models/stacked_dynamic_lstm.py — IMDB LSTM with
embedding -> fc -> recurrence -> max-pool -> softmax).

The stacked recurrence is dynamic_lstm ops: masked loops over the
padded time steps (``ops/sequence.py``), captured with the rest of the
step as one CUDA graph a bucket by the prepared step.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["stacked_lstm_net", "get_model"]


def stacked_lstm_net(words, dict_dim, class_dim=2, emb_dim=128,
                     hidden_dim=512, stacked_num=3):
    emb = fluid.layers.embedding(words, size=[dict_dim, emb_dim])
    fc1 = fluid.layers.fc(emb, size=hidden_dim, act="tanh")
    lstm1, _ = fluid.layers.dynamic_lstm(fc1, size=hidden_dim,
                                         use_peepholes=False)
    inputs = [fc1, lstm1]
    for _ in range(2, stacked_num + 1):
        fc = fluid.layers.fc(inputs[-1], size=hidden_dim, act="tanh")
        lstm, _ = fluid.layers.dynamic_lstm(fc, size=hidden_dim,
                                            use_peepholes=False,
                                            is_reverse=False)
        inputs = [fc, lstm]
    fc_last = fluid.layers.sequence_pool(inputs[0], "max")
    lstm_last = fluid.layers.sequence_pool(inputs[1], "max")
    return fluid.layers.fc(input=[fc_last, lstm_last], size=class_dim,
                           act="softmax")


def get_model(dict_dim=5000, class_dim=2, emb_dim=128, hidden_dim=512,
              stacked_num=3, learning_rate=2e-3):
    """(avg_cost, [words, label], [batch_acc])."""
    words = fluid.layers.data(name="words", shape=[1], lod_level=1,
                              dtype="int64")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    prediction = stacked_lstm_net(words, dict_dim, class_dim, emb_dim,
                                  hidden_dim, stacked_num)
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = fluid.layers.mean(cost)
    batch_acc = fluid.layers.accuracy(input=prediction, label=label)
    fluid.optimizer.Adam(learning_rate=learning_rate).minimize(avg_cost)
    return avg_cost, [words, label], [batch_acc]
