"""N-gram word2vec book model (counterpart of
``paddle_tpu/models/word2vec.py``, function for function; parity:
python/paddle/fluid/tests/book/test_word2vec.py): four context-word
embeddings sharing one 'shared_w' table (``is_sparse``: its gradient
flows as a SelectedRows), concat, a hidden fc, softmax over the vocab,
SGD."""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["inference_program", "get_model"]

EMBED_SIZE = 32
HIDDEN_SIZE = 256
N = 5  # 5-gram: 4 context words predict the 5th


def inference_program(words, dict_size, is_sparse=True,
                      embed_size=EMBED_SIZE, hidden_size=HIDDEN_SIZE):
    """``words`` = [first, second, third, forth] id tensors."""
    embs = [
        fluid.layers.embedding(
            input=w, size=[dict_size, embed_size], dtype="float32",
            is_sparse=is_sparse,
            param_attr=fluid.ParamAttr(name="shared_w"))
        for w in words]
    concat_embed = fluid.layers.concat(input=embs, axis=1)
    hidden1 = fluid.layers.fc(input=concat_embed, size=hidden_size,
                              act="sigmoid")
    return fluid.layers.fc(input=hidden1, size=dict_size, act="softmax")


def get_model(dict_size, is_sparse=True, embed_size=EMBED_SIZE,
              hidden_size=HIDDEN_SIZE, learning_rate=1e-3):
    """(avg_cost, feeds in imikolov 5-gram column order, [predict])."""
    first = fluid.layers.data(name="firstw", shape=[1], dtype="int64")
    second = fluid.layers.data(name="secondw", shape=[1], dtype="int64")
    third = fluid.layers.data(name="thirdw", shape=[1], dtype="int64")
    forth = fluid.layers.data(name="forthw", shape=[1], dtype="int64")
    next_word = fluid.layers.data(name="nextw", shape=[1], dtype="int64")

    predict_word = inference_program(
        [first, second, third, forth], dict_size, is_sparse,
        embed_size, hidden_size)
    cost = fluid.layers.cross_entropy(input=predict_word, label=next_word)
    avg_cost = fluid.layers.mean(cost)
    fluid.optimizer.SGD(learning_rate=learning_rate).minimize(avg_cost)
    return avg_cost, [first, second, third, forth, next_word], \
        [predict_word]
