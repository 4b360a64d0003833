"""The book's two DynamicRNN models in the port against the JAX package,
on the CPU, at small sizes (vocabulary 100 and 40, widths 8 to 16,
batch 4, T <= 12):

- ``understand_sentiment`` with ``net="dyn_rnn"`` (an LSTM cell written
  gate by gate in a DynamicRNN) and ``rnn_encoder_decoder`` (a bi-LSTM
  encoder and a DynamicRNN decoder) build the reference's ProgramDesc,
  main and startup, byte for byte;
- from the reference's startup values, 3 steps follow its losses and
  parameters at test_torch_lstm.py's tolerances (rtol 1e-4; parameters
  atol 1e-5);
- every output of the models' ``recurrent_grad`` ops (the gradients of
  the step input and of every parameter the body reads) at the first
  step at test_torch_lstm.py's gradient tolerance (rtol 1e-5, atol
  1e-6);
- the prepared step over three padded buckets gives ``run()``'s losses
  and state bit for bit.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import rnn_encoder_decoder as jseq
from paddle_tpu.models import understand_sentiment as jsent
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import rnn_encoder_decoder as tseq
from paddle_tpu_torch.models import understand_sentiment as tsent

STEPS = 3
VOCAB = 100
SEQ_VOCAB = 40
TRAIN_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sentiment(fluid, module):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, _ = module.get_model(VOCAB, net="dyn_rnn", emb_dim=8,
                                          hid_dim=16)
    return main, startup, loss, slots


def _seq2seq(fluid, module):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, _ = module.get_model(
            src_dict_dim=SEQ_VOCAB, trg_dict_dim=SEQ_VOCAB, emb_dim=16,
            hidden_dim=16, learning_rate=5e-3)
    return main, startup, loss, slots


def _sentiment_batches(seed, n=STEPS, max_len=12, batch=4):
    rng = np.random.RandomState(seed)
    return [[(rng.randint(0, VOCAB, rng.randint(3, max_len + 1)).tolist(),
              [int(rng.randint(2))]) for _ in range(batch)]
            for _ in range(n)]


def _seq2seq_batches(seed, n=STEPS, batch=4):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        b = []
        for _ in range(batch):
            src = rng.randint(2, SEQ_VOCAB, rng.randint(3, 10)).tolist()
            trg = rng.randint(2, SEQ_VOCAB, rng.randint(3, 12)).tolist()
            b.append((src, trg, trg[1:] + [1]))
        out.append(b)
    return out


MODELS = {"sentiment_dyn_rnn": (_sentiment, jsent, tsent,
                                _sentiment_batches),
          "rnn_encoder_decoder": (_seq2seq, jseq, tseq, _seq2seq_batches)}


def _recurrent_grad_outputs(main):
    return [n for op in main.desc.blocks[0].ops
            if op.type == "recurrent_grad"
            for n in op.output_arg_names() if n]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_builds_the_reference_desc(model):
    build, jmod, tmod, _ = MODELS[model]
    jmain, jstart, _, _ = build(jfluid, jmod)
    tmain, tstart, _, _ = build(tfluid, tmod)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    assert len(tmain.desc.blocks) > 1
    assert "recurrent" in [op.type for op in tmain.desc.blocks[0].ops]


def _train(model):
    build, jmod, tmod, batches_of = MODELS[model]
    jmain, jstart, jloss, jslots = build(jfluid, jmod)
    tmain, _, tloss, tslots = build(tfluid, tmod)
    grads = _recurrent_grad_outputs(tmain)
    assert grads == _recurrent_grad_outputs(jmain) and grads
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    ts = tfluid.Scope()
    set_scope_arrays(ts, {n: np.asarray(js.find_var(n)) for n in persist},
                     "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    jfeed = jfluid.DataFeeder(jslots, program=jmain)
    tfeed = tfluid.DataFeeder(tslots, program=tmain)
    losses = {"jax": [], "port": []}
    first = None
    for k, b in enumerate(batches_of(0)):
        fetch = [jloss.name] + (grads if k == 0 else [])
        j = jexe.run(jmain, feed=jfeed.feed(b), fetch_list=fetch, scope=js)
        t = texe.run(tmain, feed=tfeed.feed(b), fetch_list=fetch, scope=ts)
        losses["jax"].append(float(np.ravel(j[0])[0]))
        losses["port"].append(float(np.ravel(t[0])[0]))
        if k == 0:
            first = (j[1:], t[1:])
    jv = {n: np.asarray(js.find_var(n)) for n in persist}
    return losses, jv, get_scope_arrays(ts, persist), grads, first


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_trains_as_the_reference(model):
    losses, jv, tv, grads, (jg, tg) = _train(model)
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=TRAIN_RTOL)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    for n, a, b in zip(grads, tg, jg):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_prepared_over_buckets_is_run_bit_for_bit(model):
    """Three ragged batches of padded T 8, 16 and 8 again: the prepared
    step takes each bucket and gives run()'s losses and state bit for
    bit."""
    build, _, tmod, batches_of = MODELS[model]
    main, startup, loss, slots = build(tfluid, tmod)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    exe = tfluid.Executor(tfluid.CPUPlace())
    s0 = tfluid.Scope()
    exe.run(startup, scope=s0)
    init = get_scope_arrays(s0, persist)
    feeder = tfluid.DataFeeder(slots, program=main)
    if model == "sentiment_dyn_rnn":
        raw = (_sentiment_batches(1, 1, 8) + _sentiment_batches(2, 1, 12)
               + _sentiment_batches(3, 1, 6))
    else:
        raw = _seq2seq_batches(4)
    batches = [feeder.feed(b) for b in raw]
    sa, sb = tfluid.Scope(), tfluid.Scope()
    set_scope_arrays(sa, init, "cpu")
    set_scope_arrays(sb, init, "cpu")
    la = [exe.run(main, feed=f, fetch_list=[loss], scope=sa)[0]
          for f in batches]
    with exe.prepare(main, feed_specs=batches[0], fetch_list=[loss],
                     scope=sb) as prep:
        lb = [prep.run_prepared(f, return_numpy=True)[0] for f in batches]
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    pa, pb = get_scope_arrays(sa, persist), get_scope_arrays(sb, persist)
    for n in persist:
        np.testing.assert_array_equal(pa[n], pb[n])
