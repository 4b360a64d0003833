"""Seq2seq without attention, DynamicRNN decoder (counterpart of
``paddle_tpu/models/rnn_encoder_decoder.py``; parity: book test
python/paddle/fluid/tests/book/test_rnn_encoder_decoder.py: a bi-LSTM
encoder and a hand-built LSTM-cell DynamicRNN decoder).

The decoder is a ``fluid.layers.DynamicRNN`` whose per-step sub-block
(concat -> 4 fc gates -> cell update -> softmax fc) the ``recurrent`` op
steps over the target sequence, masked past each row's length.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["seq_to_seq_net", "get_model"]


def bi_lstm_encoder(input_seq, hidden_dim):
    """Forward+backward LSTM over the padded [N, T, D] source embedding
    (reference test_rnn_encoder_decoder.py:40-60)."""
    fwd_proj = fluid.layers.fc(input=input_seq, size=hidden_dim * 4,
                               bias_attr=False)
    forward, _ = fluid.layers.dynamic_lstm(fwd_proj, size=hidden_dim * 4,
                                           use_peepholes=False)
    bwd_proj = fluid.layers.fc(input=input_seq, size=hidden_dim * 4,
                               bias_attr=False)
    backward, _ = fluid.layers.dynamic_lstm(bwd_proj, size=hidden_dim * 4,
                                            use_peepholes=False,
                                            is_reverse=True)
    return forward, backward


def lstm_step(x_t, hidden_t_prev, cell_t_prev, size):
    """One LSTM cell from four fc gates (reference
    test_rnn_encoder_decoder.py:63-82)."""

    def linear(inputs):
        return fluid.layers.fc(input=inputs, size=size, bias_attr=True)

    forget_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
    input_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
    output_gate = fluid.layers.sigmoid(linear([hidden_t_prev, x_t]))
    cell_tilde = fluid.layers.tanh(linear([hidden_t_prev, x_t]))

    cell_t = fluid.layers.sums(input=[
        fluid.layers.elementwise_mul(x=forget_gate, y=cell_t_prev),
        fluid.layers.elementwise_mul(x=input_gate, y=cell_tilde)])
    hidden_t = fluid.layers.elementwise_mul(
        x=output_gate, y=fluid.layers.tanh(cell_t))
    return hidden_t, cell_t


def lstm_decoder_without_attention(target_embedding, decoder_boot, context,
                                   decoder_size, target_dict_dim):
    """DynamicRNN decoder (reference test_rnn_encoder_decoder.py:85-112)."""
    rnn = fluid.layers.DynamicRNN()

    cell_init = fluid.layers.fill_constant_batch_size_like(
        input=decoder_boot, shape=[1, decoder_size], dtype="float32",
        value=0.0)

    with rnn.block():
        current_word = rnn.step_input(target_embedding)
        context_ = rnn.static_input(context)
        hidden_mem = rnn.memory(init=decoder_boot, need_reorder=True)
        cell_mem = rnn.memory(init=cell_init)
        decoder_inputs = fluid.layers.concat(
            input=[context_, current_word], axis=1)
        h, c = lstm_step(decoder_inputs, hidden_mem, cell_mem, decoder_size)
        rnn.update_memory(hidden_mem, h)
        rnn.update_memory(cell_mem, c)
        out = fluid.layers.fc(input=h, size=target_dict_dim,
                              act="softmax")
        rnn.output(out)
    return rnn()


def seq_to_seq_net(src_word, trg_word, src_dict_dim, trg_dict_dim,
                   emb_dim=32, encoder_size=32, decoder_size=32):
    src_embedding = fluid.layers.embedding(
        src_word, size=[src_dict_dim, emb_dim])
    src_forward, src_backward = bi_lstm_encoder(src_embedding, encoder_size)

    # context = last forward state + first backward state
    forward_last = fluid.layers.sequence_last_step(input=src_forward)
    backward_first = fluid.layers.sequence_first_step(input=src_backward)
    encoded_vector = fluid.layers.concat(
        input=[forward_last, backward_first], axis=1)
    decoder_boot = fluid.layers.fc(input=backward_first, size=decoder_size,
                                   act=None, bias_attr=False)

    trg_embedding = fluid.layers.embedding(
        trg_word, size=[trg_dict_dim, emb_dim])
    prediction = lstm_decoder_without_attention(
        trg_embedding, decoder_boot, encoded_vector, decoder_size,
        trg_dict_dim)
    return prediction


def get_model(src_dict_dim=60, trg_dict_dim=60, emb_dim=32, hidden_dim=32,
              learning_rate=2e-3):
    """(avg_cost, [src, trg, label], [])."""
    src_word = fluid.layers.data(name="source_sequence", shape=[1],
                                 lod_level=1, dtype="int64")
    trg_word = fluid.layers.data(name="target_sequence", shape=[1],
                                 lod_level=1, dtype="int64")
    label = fluid.layers.data(name="label_sequence", shape=[1],
                              lod_level=1, dtype="int64")
    prediction = seq_to_seq_net(src_word, trg_word, src_dict_dim,
                                trg_dict_dim, emb_dim, hidden_dim,
                                hidden_dim)
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = fluid.layers.mean(cost)
    fluid.optimizer.Adam(learning_rate=learning_rate).minimize(avg_cost)
    return avg_cost, [src_word, trg_word, label], []
