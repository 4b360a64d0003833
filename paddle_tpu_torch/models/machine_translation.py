"""Seq2seq-attention NMT (parity: benchmark/fluid/models/
machine_translation.py + book test machine_translation — encoder-decoder
with attention, WMT-style vocab).

The reference runs Bahdanau attention step-by-step inside a DynamicRNN
(sequence_expand + sequence_softmax per decoder step); here the decoder
recurrence is a dynamic_lstm and the attention is one batched
seq_cross_attention op over all decoder steps — mathematically the
post-attention (Luong) formulation, one masked batched product
(``ops/sequence.py``) instead of T separate per-step graphs.

The port's counterpart of ``paddle_tpu/models/machine_translation.py``,
line for line: the same calls build the same ProgramDesc.
"""
from __future__ import annotations

import paddle_tpu_torch.fluid as fluid

__all__ = ["seq_to_seq_net", "get_model"]


def _encoder(src_word, src_dict_dim, emb_dim, hidden_dim):
    emb = fluid.layers.embedding(src_word, size=[src_dict_dim, emb_dim])
    proj = fluid.layers.fc(emb, size=hidden_dim * 4, act=None)
    fwd, _ = fluid.layers.dynamic_lstm(proj, size=hidden_dim * 4,
                                       use_peepholes=False)
    bproj = fluid.layers.fc(emb, size=hidden_dim * 4, act=None)
    bwd, _ = fluid.layers.dynamic_lstm(bproj, size=hidden_dim * 4,
                                       use_peepholes=False,
                                       is_reverse=True)
    return fluid.layers.concat([fwd, bwd], axis=-1)  # [N, Te, 2H]


def seq_to_seq_net(src_word, trg_word, src_dict_dim, trg_dict_dim,
                   emb_dim=512, hidden_dim=512):
    enc = _encoder(src_word, src_dict_dim, emb_dim, hidden_dim)
    enc_proj = fluid.layers.fc(enc, size=hidden_dim, act=None)

    trg_emb = fluid.layers.embedding(trg_word,
                                     size=[trg_dict_dim, emb_dim])
    dproj = fluid.layers.fc(trg_emb, size=hidden_dim * 4, act=None)
    dec, _ = fluid.layers.dynamic_lstm(dproj, size=hidden_dim * 4,
                                       use_peepholes=False)

    helper = fluid.layer_helper.LayerHelper("attention")
    ctxv = helper.create_tmp_variable(dec.dtype)
    helper.append_op(type="seq_cross_attention",
                     inputs={"Q": [dec], "K": [enc_proj],
                             "V": [enc_proj]},
                     outputs={"Out": [ctxv]})
    merged = fluid.layers.concat([dec, ctxv], axis=-1)
    att = fluid.layers.fc(merged, size=hidden_dim, act="tanh")
    logits = fluid.layers.fc(att, size=trg_dict_dim, act="softmax")
    return logits


def get_model(src_dict_dim=10000, trg_dict_dim=10000, emb_dim=256,
              hidden_dim=256, learning_rate=2e-3):
    """(avg_cost, [src_word, trg_word, trg_next], [])."""
    src_word = fluid.layers.data(name="source_sequence", shape=[1],
                                 lod_level=1, dtype="int64")
    trg_word = fluid.layers.data(name="target_sequence", shape=[1],
                                 lod_level=1, dtype="int64")
    label = fluid.layers.data(name="label_sequence", shape=[1],
                              lod_level=1, dtype="int64")
    prediction = seq_to_seq_net(src_word, trg_word, src_dict_dim,
                                trg_dict_dim, emb_dim, hidden_dim)
    cost = fluid.layers.cross_entropy(input=prediction, label=label)
    avg_cost = fluid.layers.mean(cost)
    fluid.optimizer.Adam(learning_rate=learning_rate).minimize(avg_cost)
    return avg_cost, [src_word, trg_word, label], []
