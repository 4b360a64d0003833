"""The stacked dynamic LSTM and the sentiment conv net in the port
against the JAX package, on the CPU, at small sizes (hidden 16, 2
stacks, batch 4, T <= 12).

- ``dynamic_lstm`` (reversed and not, with and without peepholes) and
  ``dynamic_gru`` (reversed and not): the hidden / cell outputs and the
  gradients of the input and the parameters at rtol 1e-5 (mirrors
  tests/test_sequence_ops.py:55 and :90);
- ``models/stacked_dynamic_lstm`` and ``models/understand_sentiment``'s
  conv net (an is_sparse embedding, Adagrad) build the reference's
  ProgramDesc and train 3 steps from its startup values to its losses
  at rtol 1e-4 (test_torch_train.py's bar), under bf16 AMP at
  test_torch_amp.py's LOSS_RTOL, where every op output has the
  reference's dtype;
- the LSTM's prepared step on ragged batches (three padded buckets)
  gives ``run()``'s losses and state bit for bit;
- ``understand_sentiment`` with ``net="dyn_rnn"`` (a DynamicRNN) builds
  the reference's ProgramDesc and trains 3 steps as it does.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.lod import LoDTensor as JLoD
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import stacked_dynamic_lstm as jlstm
from paddle_tpu.models import understand_sentiment as jsent
from paddle_tpu_torch.core.lod import LoDTensor as TLoD
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import stacked_dynamic_lstm as tlstm
from paddle_tpu_torch.models import understand_sentiment as tsent
from test_torch_amp import LOSS_RTOL

STEPS = 3
VOCAB = 100
TRAIN_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rnn_program(fluid, kind, reverse, peepholes):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        width = 4 * 8 if kind == "lstm" else 3 * 6
        x = fluid.layers.data(name="x", shape=[width], lod_level=1,
                              dtype="float32")
        x.stop_gradient = False
        if kind == "lstm":
            hid, cell = fluid.layers.dynamic_lstm(
                x, size=width, use_peepholes=peepholes, is_reverse=reverse)
            outs = [hid, cell]
            loss = fluid.layers.elementwise_add(fluid.layers.mean(hid),
                                                fluid.layers.mean(cell))
        else:
            hid = fluid.layers.dynamic_gru(x, size=6, is_reverse=reverse)
            outs = [hid]
            loss = fluid.layers.mean(hid)
        fluid.backward.append_backward(loss)
    grads = ["x@GRAD"] + [p.name + "@GRAD" for p in main.all_parameters()]
    return main, startup, [o.name for o in outs] + grads


@pytest.mark.parametrize("kind,reverse,peepholes", [
    ("lstm", False, False), ("lstm", True, False), ("lstm", False, True),
    ("lstm", True, True), ("gru", False, False), ("gru", True, False)])
def test_dynamic_rnn_forward_and_backward(kind, reverse, peepholes):
    jmain, jstart, names = _rnn_program(jfluid, kind, reverse, peepholes)
    tmain, _, tnames = _rnn_program(tfluid, kind, reverse, peepholes)
    assert tnames == names
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    rng = np.random.RandomState(1 + reverse + 2 * peepholes)
    lens = [5, 2, 7]
    width = 32 if kind == "lstm" else 18
    data = (rng.randn(sum(lens), width) * 0.5).astype(np.float32)
    offs = np.cumsum([0] + lens).tolist()
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    init = {n: np.asarray(js.find_var(n)) for n in persist}
    # random peepholes and biases, not the startup's zeros
    for n in init:
        init[n] = (rng.randn(*init[n].shape) * 0.3).astype(np.float32)
        js.set(n, init[n])
    want = jexe.run(jmain, feed={"x": JLoD(data, [offs])},
                    fetch_list=names, scope=js)
    ts = tfluid.Scope()
    set_scope_arrays(ts, init, "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={"x": TLoD(data, [offs])}, fetch_list=names, scope=ts)
    for n, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    # padded positions of the outputs are zero
    hid = got[0]
    for i, ln in enumerate(lens):
        assert np.abs(hid[i, ln:]).max(initial=0.0) == 0.0


def _lstm_model(fluid, module, amp=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, _ = module.get_model(dict_dim=VOCAB, hidden_dim=16,
                                          stacked_num=2)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss, slots


def _sentiment_model(fluid, module, amp=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, _ = module.get_model(VOCAB, net="conv", emb_dim=8,
                                          hid_dim=8)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss, slots


MODELS = {"lstm": (_lstm_model, jlstm, tlstm),
          "sentiment_conv": (_sentiment_model, jsent, tsent)}


def _batches(seed=0, n=STEPS, max_len=12, batch=4):
    rng = np.random.RandomState(seed)
    return [[(rng.randint(0, VOCAB, rng.randint(3, max_len + 1)).tolist(),
              [int(rng.randint(2))]) for _ in range(batch)]
            for _ in range(n)]


def _watched(main):
    """Every forward op's first float output, for the AMP dtype check."""
    names = []
    for op in main.desc.blocks[0].ops:
        if op.role or op.type in ("feed", "fetch"):
            continue
        for slot in ("Out", "Hidden", "Cell", "Y"):
            if op.outputs.get(slot):
                names.append(op.outputs[slot][0])
                break
    return names


def _train(model, amp):
    """STEPS steps of ``model`` (a MODELS key, or a (build, jax module,
    port module) triple) in both packages from the reference's
    startup values: {"jax" | "port": (losses, {watched: dtype})}."""
    build, jmod, tmod = model if isinstance(model, tuple) else MODELS[model]
    jmain, jstart, jloss, jslots = build(jfluid, jmod, amp)
    tmain, tstart, tloss, tslots = build(tfluid, tmod, amp)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    watched = _watched(tmain)
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    init = {n: np.asarray(js.find_var(n)) for n in persist}
    ts = tfluid.Scope()
    set_scope_arrays(ts, init, "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    jfeed = jfluid.DataFeeder(jslots, program=jmain)
    tfeed = tfluid.DataFeeder(tslots, program=tmain)
    out = {"jax": ([], {}), "port": ([], {})}
    for b in _batches():
        j = jexe.run(jmain, feed=jfeed.feed(b),
                     fetch_list=[jloss.name] + watched, scope=js,
                     return_numpy=False)
        t = texe.run(tmain, feed=tfeed.feed(b),
                     fetch_list=[tloss.name] + watched, scope=ts,
                     return_numpy=False)
        out["jax"][0].append(float(np.asarray(j[0]).ravel()[0]))
        out["port"][0].append(float(t[0].float().ravel()[0]))
        out["jax"][1].update({n: np.dtype(v.dtype).name
                              for n, v in zip(watched, j[1:])})
        out["port"][1].update({n: str(v.dtype).replace("torch.", "")
                               for n, v in zip(watched, t[1:])})
    jv = {n: np.asarray(js.find_var(n)) for n in persist}
    tv = get_scope_arrays(ts, persist)
    return out, jv, tv


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_trains_as_the_reference(model):
    out, jv, tv = _train(model, amp=False)
    np.testing.assert_allclose(out["port"][0], out["jax"][0],
                               rtol=TRAIN_RTOL)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    assert out["port"][1] == out["jax"][1]


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_trains_as_the_reference_under_amp(model):
    """bf16 AMP: fc, sequence_conv and the bias adds in bf16, the LSTM's
    recurrence in f32 (its Bias is f32, as in the reference); the losses
    at LOSS_RTOL, every watched op output in the reference's dtype."""
    out, _, tv = _train(model, amp=True)
    np.testing.assert_allclose(out["port"][0], out["jax"][0],
                               rtol=LOSS_RTOL)
    assert out["port"][1] == out["jax"][1]
    assert "bfloat16" in out["port"][1].values()
    assert {str(v.dtype) for v in tv.values()} == {"float32"}
    if model == "lstm":
        lstm_out = [n for n in out["port"][1] if n.startswith("lstm")]
        assert lstm_out and {out["port"][1][n] for n in lstm_out} == \
            {"float32"}


def test_lstm_prepared_over_buckets_is_run_bit_for_bit():
    """Three ragged batches of padded T 8, 16 and 8 again: the prepared
    step takes each bucket and gives run()'s losses and state bit for
    bit."""
    main, startup, loss, slots = _lstm_model(tfluid, tlstm)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    exe = tfluid.Executor(tfluid.CPUPlace())
    s0 = tfluid.Scope()
    exe.run(startup, scope=s0)
    init = get_scope_arrays(s0, persist)
    feeder = tfluid.DataFeeder(slots, program=main)
    batches = [feeder.feed(b) for b in
               _batches(1, 1, 8) + _batches(2, 1, 12) + _batches(3, 1, 6)]
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


def _sentiment_dyn_model(fluid, module, amp=False):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, _ = module.get_model(VOCAB, net="dyn_rnn", emb_dim=8,
                                          hid_dim=16)
    return main, startup, loss, slots


def test_sentiment_dyn_rnn_trains_as_the_reference():
    """The DynamicRNN sentiment net, which raised NotImplementedError
    before DynamicRNN was ported: the reference's desc, its 3 steps'
    losses and parameters, every watched op output in its dtype."""
    out, jv, tv = _train((_sentiment_dyn_model, jsent, tsent), amp=False)
    np.testing.assert_allclose(out["port"][0], out["jax"][0],
                               rtol=TRAIN_RTOL)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], rtol=1e-4, atol=1e-5,
                                   err_msg=n)
    assert out["port"][1] == out["jax"][1]
