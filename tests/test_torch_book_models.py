"""The last three book models in the port against the JAX package, on
the CPU, at small sizes, each fed by its dataset adapter's synthetic
path (the port's copy for the port, the reference's for the
reference):

- ``machine_translation`` (dicts 80, emb and hidden 32, batch 4),
  ``recommender`` (its fixed widths, batch 16) and
  ``label_semantic_roles`` (hidden 16, depth 2, batch 4) build the
  reference's ProgramDesc, main and startup, byte for byte;
- from the reference's startup values, 3 steps follow its losses
  within rtol 1e-4 (test_torch_train.py's bar) and its parameters
  within rtol 1e-4, atol 1e-5;
- the prepared step over the padded buckets of ragged batches gives
  ``run()``'s losses and state bit for bit;
- ``tests/test_book_models2.py``'s training bars for the three models
  hold on the port, from the reference's startup values.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu import dataset as jdata
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import label_semantic_roles as jsrl
from paddle_tpu.models import machine_translation as jmt
from paddle_tpu.models import recommender as jrec
from paddle_tpu_torch import dataset as tdata
from paddle_tpu_torch.core.executor_impl import _prepare_lod_feeds
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import label_semantic_roles as tsrl
from paddle_tpu_torch.models import machine_translation as tmt
from paddle_tpu_torch.models import recommender as trec

STEPS = 3
TRAIN_RTOL = 1e-4
MT_DICT = 80


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _batches(reader, batch_size):
    it = reader()
    while True:
        b = list(itertools.islice(it, batch_size))
        if len(b) < batch_size:
            return
        yield b


def _guarded(fluid, fn):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, extra = fn()
    return main, startup, loss, slots, extra


def _mt(fluid, module, lr=1e-2):
    return _guarded(fluid, lambda: module.get_model(
        src_dict_dim=MT_DICT, trg_dict_dim=MT_DICT, emb_dim=32,
        hidden_dim=32, learning_rate=lr))


def _rec(fluid, module, lr=0.3):
    return _guarded(fluid, lambda: module.get_model(learning_rate=lr))


def _srl(fluid, module, hidden=16, depth=2):
    data = tdata if fluid is tfluid else jdata
    word, verb, label = data.conll05.get_dict()
    return _guarded(fluid, lambda: module.get_model(
        word_dict_len=len(word), label_dict_len=len(label),
        pred_dict_len=len(verb), hidden_dim=hidden, depth=depth,
        train_word_emb=True, learning_rate=0.1))


def _mt_reader(data):
    return data.wmt14.train(MT_DICT)


def _rec_reader(data):
    return data.movielens.train()


def _srl_reader(data):
    return data.conll05.test()


# {model: (build, jax module, port module, reader of a dataset package,
#          batch)}
MODELS = {"machine_translation": (_mt, jmt, tmt, _mt_reader, 4),
          "recommender": (_rec, jrec, trec, _rec_reader, 16),
          "label_semantic_roles": (_srl, jsrl, tsrl, _srl_reader, 4)}


def _persist(main):
    return sorted(n for n, v in main.desc.blocks[0].vars.items()
                  if v.persistable)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_builds_the_reference_desc(model):
    build, jmod, tmod, _, _ = MODELS[model]
    jmain, jstart = build(jfluid, jmod)[:2]
    tmain, tstart = build(tfluid, tmod)[:2]
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()


def _train(model, steps=STEPS):
    """``steps`` steps of ``model`` in both packages from the
    reference's startup values: (losses {"jax" | "port": [...]},
    the reference's persistables, the port's)."""
    build, jmod, tmod, reader, bs = MODELS[model]
    jmain, jstart, jloss, jslots, _ = build(jfluid, jmod)
    tmain, _, tloss, tslots, _ = build(tfluid, tmod)
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    persist = _persist(jmain)
    ts = tfluid.Scope()
    set_scope_arrays(ts, {n: np.asarray(js.find_var(n)) for n in persist},
                     "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    jfeed = jfluid.DataFeeder(jslots, program=jmain)
    tfeed = tfluid.DataFeeder(tslots, program=tmain)
    losses = {"jax": [], "port": []}
    batches = zip(_batches(reader(jdata), bs), _batches(reader(tdata), bs))
    for jb, tb in itertools.islice(batches, steps):
        j, = jexe.run(jmain, feed=jfeed.feed(jb), fetch_list=[jloss.name],
                      scope=js)
        t, = texe.run(tmain, feed=tfeed.feed(tb), fetch_list=[tloss.name],
                      scope=ts)
        losses["jax"].append(float(np.ravel(j)[0]))
        losses["port"].append(float(np.ravel(t)[0]))
    jv = {n: np.asarray(js.find_var(n)) for n in persist}
    return losses, jv, get_scope_arrays(ts, persist)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_trains_as_the_reference(model):
    losses, jv, tv = _train(model)
    assert len(losses["port"]) == STEPS
    np.testing.assert_allclose(losses["port"], losses["jax"],
                               rtol=TRAIN_RTOL)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_prepared_over_buckets_is_run_bit_for_bit(model):
    """Four batches whose ragged slots fall in more than one padded
    bucket: the prepared step takes each bucket and gives run()'s
    losses and state bit for bit."""
    build, _, tmod, reader, bs = MODELS[model]
    main, startup, loss, slots, _ = build(tfluid, tmod)
    persist = _persist(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    s0 = tfluid.Scope()
    exe.run(startup, scope=s0)
    init = get_scope_arrays(s0, persist)
    feeder = tfluid.DataFeeder(slots, program=main)
    raw = list(itertools.islice(_batches(reader(tdata), bs), 4))
    if model == "recommender":
        # every synthetic title pads to 8: lengthen the titles of every
        # other batch to 9-12 words (their own, repeated)
        for b in raw[1::2]:
            for i, row in enumerate(b):
                b[i] = list(row)
                b[i][6] = (row[6] * 12)[:9 + i % 4]
    batches = [feeder.feed(b) for b in raw]
    buckets = {tuple(sorted((k, np.shape(v)) for k, v in
                            _prepare_lod_feeds(dict(f)).items()))
               for f in batches}
    assert len(buckets) > 1
    sa, sb = tfluid.Scope(), tfluid.Scope()
    set_scope_arrays(sa, init, "cpu")
    set_scope_arrays(sb, init, "cpu")
    la = [exe.run(main, feed=f, fetch_list=[loss], scope=sa)[0]
          for f in batches]
    with exe.prepare(main, feed_specs=list(batches[0]), fetch_list=[loss],
                     scope=sb) as prep:
        lb = [prep.run_prepared(f, return_numpy=True)[0] for f in batches]
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    pa, pb = get_scope_arrays(sa, persist), get_scope_arrays(sb, persist)
    for n in persist:
        np.testing.assert_array_equal(pa[n], pb[n])


# --- tests/test_book_models2.py's training bars, on the port ---

def _fit(build, jmod, tmod, batches_of, epochs, **kw):
    """``epochs`` epochs of the port's model over ``batches_of()``, from
    the reference's startup values (the two packages draw different
    random numbers, so the port never re-draws them)."""
    jmain, jstart = build(jfluid, jmod, **kw)[:2]
    main, _, loss, slots, extra = build(tfluid, tmod, **kw)
    js = JScope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=js)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    set_scope_arrays(scope, {n: np.asarray(js.find_var(n))
                             for n in _persist(jmain)}, "cpu")
    feeder = tfluid.DataFeeder(slots, program=main)
    per_epoch = []
    for _ in range(epochs):
        ls = []
        for batch in batches_of():
            l, = exe.run(main, feed=feeder.feed(batch), fetch_list=[loss],
                         scope=scope)
            ls.append(float(np.asarray(l).ravel()[0]))
        per_epoch.append(ls)
    return exe, scope, main, feeder, extra, per_epoch


def test_recommender_system_trains():
    """test_book_models2.py:88's bar: six epochs over the synthetic
    ratings beat predict-the-mean and keep improving."""
    per_epoch = _fit(_rec, jrec, trec, lambda: _batches(
        tdata.movielens.train(), 64), 6)[-1]
    epoch_means = [float(np.mean(ls)) for ls in per_epoch]
    assert epoch_means[-1] < epoch_means[0] * 0.85, epoch_means
    assert epoch_means[-1] < 6.2, epoch_means


def test_machine_translation_wmt14_trains():
    """test_book_models2.py:107's bar: on the permutation-cipher corpus
    the cross-entropy falls below half its start within 8 epochs."""
    src_dict, _ = tdata.wmt14.get_dict(MT_DICT)
    assert len(src_dict) == MT_DICT and src_dict[0] == "<s>"
    per_epoch = _fit(_mt, jmt, tmt, lambda: _batches(
        tdata.wmt14.train(MT_DICT), 16), 8)[-1]
    ls = [l for e in per_epoch for l in e]
    assert ls[-1] < ls[0] * 0.5, (ls[0], ls[-1])


def test_label_semantic_roles_trains():
    """test_book_models2.py:181's bar: the CRF NLL falls within the
    first epoch and keeps improving; crf_decoding gives valid tags."""
    label_dict = tdata.conll05.get_dict()[2]
    exe, scope, main, feeder, (decode,), per_epoch = _fit(
        _srl, jsrl, tsrl, lambda: _batches(tdata.conll05.test(), 16), 3,
        hidden=64)
    assert all(np.isfinite(ls).all() for ls in per_epoch)
    first = [ls[0] for ls in per_epoch]
    last = [ls[-1] for ls in per_epoch]
    assert last[0] < first[0] * 0.85, (first, last)
    assert last[-1] < last[0], (first, last)
    batch = next(_batches(tdata.conll05.test(), 8))
    decoded, = exe.run(main, feed=feeder.feed(batch), fetch_list=[decode],
                       scope=scope)
    decoded = np.asarray(decoded)
    assert decoded.min() >= 0 and decoded.max() < len(label_dict)
