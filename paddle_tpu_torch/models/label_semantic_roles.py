"""Semantic-role-labeling book model (parity:
python/paddle/fluid/tests/book/test_label_semantic_roles.py — the
8-feature db_lstm: per-feature embeddings (words share one frozen
table), a depth-8 alternating-direction LSTM stack with direct edges,
linear-chain CRF loss and crf_decoding inference).

The bidirectional-ish stack is eight masked LSTMs (alternating
is_reverse), each a loop over the padded T (``ops/sequence.py``); the
CRF is the exact forward algorithm of ``ops/crf_ctc.py``.  The port's
counterpart of ``paddle_tpu/models/label_semantic_roles.py``, line for
line: the same calls build the same ProgramDesc.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["db_lstm", "get_model"]

WORD_DIM = 32
MARK_DIM = 5
MARK_DICT_LEN = 2
EMBEDDING_NAME = "emb"


def db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, mark,
            word_dict_len, label_dict_len, pred_dict_len,
            hidden_dim=512, depth=8, emb_lr=1.0, train_word_emb=False):
    predicate_embedding = fluid.layers.embedding(
        input=predicate, size=[pred_dict_len, WORD_DIM], dtype="float32",
        is_sparse=True, param_attr="vemb")
    mark_embedding = fluid.layers.embedding(
        input=mark, size=[MARK_DICT_LEN, MARK_DIM], dtype="float32",
        is_sparse=True)

    word_input = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2]
    # the six word-context features share one embedding table; frozen by
    # default because the reference loads it from a pre-trained emb file
    # (load_parameter) — train it when no pre-trained table exists
    emb_layers = [
        fluid.layers.embedding(
            input=x, size=[word_dict_len, WORD_DIM],
            param_attr=fluid.ParamAttr(name=EMBEDDING_NAME,
                                       trainable=train_word_emb,
                                       learning_rate=emb_lr))
        for x in word_input]
    emb_layers.append(predicate_embedding)
    emb_layers.append(mark_embedding)

    hidden_0_layers = [fluid.layers.fc(input=emb, size=hidden_dim)
                       for emb in emb_layers]
    hidden_0 = fluid.layers.sums(input=hidden_0_layers)

    lstm_0, _ = fluid.layers.dynamic_lstm(
        input=hidden_0, size=hidden_dim, candidate_activation="relu",
        gate_activation="sigmoid", cell_activation="sigmoid")

    # stack L-LSTM and R-LSTM with direct edges
    input_tmp = [hidden_0, lstm_0]
    for i in range(1, depth):
        mix_hidden = fluid.layers.sums(input=[
            fluid.layers.fc(input=input_tmp[0], size=hidden_dim),
            fluid.layers.fc(input=input_tmp[1], size=hidden_dim)])
        lstm, _ = fluid.layers.dynamic_lstm(
            input=mix_hidden, size=hidden_dim,
            candidate_activation="relu", gate_activation="sigmoid",
            cell_activation="sigmoid", is_reverse=((i % 2) == 1))
        input_tmp = [mix_hidden, lstm]

    return fluid.layers.sums(input=[
        fluid.layers.fc(input=input_tmp[0], size=label_dict_len,
                        act="tanh"),
        fluid.layers.fc(input=input_tmp[1], size=label_dict_len,
                        act="tanh")])


def get_model(word_dict_len, label_dict_len, pred_dict_len, hidden_dim=512,
              depth=8, mix_hidden_lr=1e-3, train_word_emb=False,
              learning_rate=0.01):
    """(avg_cost, feed vars in conll05 column order, [crf_decode])."""

    def seq_data(name):
        return fluid.layers.data(name=name, shape=[1], dtype="int64",
                                 lod_level=1)

    word = seq_data("word_data")
    predicate = seq_data("verb_data")
    ctx_n2 = seq_data("ctx_n2_data")
    ctx_n1 = seq_data("ctx_n1_data")
    ctx_0 = seq_data("ctx_0_data")
    ctx_p1 = seq_data("ctx_p1_data")
    ctx_p2 = seq_data("ctx_p2_data")
    mark = seq_data("mark_data")
    target = seq_data("target")

    feature_out = db_lstm(word, predicate, ctx_n2, ctx_n1, ctx_0, ctx_p1,
                          ctx_p2, mark, word_dict_len, label_dict_len,
                          pred_dict_len, hidden_dim, depth,
                          train_word_emb=train_word_emb)

    crf_cost = fluid.layers.linear_chain_crf(
        input=feature_out, label=target,
        param_attr=fluid.ParamAttr(name="crfw",
                                   learning_rate=mix_hidden_lr))
    avg_cost = fluid.layers.mean(crf_cost)
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)

    crf_decode = fluid.layers.crf_decoding(
        input=feature_out, param_attr=fluid.ParamAttr(name="crfw"))

    feeds = [word, ctx_n2, ctx_n1, ctx_0, ctx_p1, ctx_p2, predicate, mark,
             target]
    return avg_cost, feeds, [crf_decode]
