"""The sequence (LoD) ops and layers of the port against the JAX
package, on the CPU.

- each of ``ops/sequence.py``'s 18 op types replays its ``SPECS`` entry
  (``tools/tpu_optest.py``) at the spec's tolerance, forward and, where
  the op has one, gradient (specs without ``grad`` get one here);
  ``sequence_pool`` at every pool type (``MAX`` with tied maxima, whose
  gradient splits among them as ``jnp.max``'s does), and pool, softmax
  and conv on level-2 inputs (the finest level);
- every layer of ``fluid/layers/sequence_op.py`` and
  ``nets.sequence_conv_pool`` builds the reference's ProgramDesc, byte
  for byte (so build-time shape inference gives the reference's shapes
  and dtypes).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from test_torch_ops import optest, replay_spec

SEQUENCE_OPS = ["lstm", "gru", "lstm_unit", "gru_unit", "sequence_pool",
                "sequence_softmax", "sequence_expand", "sequence_conv",
                "sequence_erase", "seq_cross_attention", "lod_reset",
                "edit_distance", "sequence_concat", "sequence_reshape",
                "sequence_slice", "lstmp", "kmax_seq_score",
                "sub_nested_seq"]
S = optest.SPECS
F = optest.F


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("op", SEQUENCE_OPS + ["adagrad", "sigmoid",
                                               "concat"])
def test_sequence_op_replays_its_spec(op):
    """The 18 sequence op types, adagrad (dense), and the sigmoid and
    concat ops their layers append (the sequence_conv_pool default act,
    lstm_unit's fc input)."""
    replay_spec(op)


def _tied():
    """SPECS' pool input rounded to halves: tied maxima in most
    columns."""
    x = S["sequence_pool"]["inputs"]["X"]
    return optest.LoDTensor(np.round(np.asarray(x.data) * 2) / 2, x.lod)


GRAD_CASES = {
    "lstm": ("lstm", dict(S["lstm"],
                          grad=["Input", "Weight", "Bias", "H0", "C0"])),
    "lstm_peepholes_reversed": ("lstm", dict(
        S["lstm"], inputs=dict(S["lstm"]["inputs"], Bias=F(1, 21)),
        attrs={"use_peepholes": True, "is_reverse": True},
        grad=["Input", "Weight", "Bias", "H0", "C0"])),
    "lstm_reversed": ("lstm", dict(
        S["lstm"], attrs={"use_peepholes": False, "is_reverse": True},
        grad=["Input", "Weight", "Bias"])),
    "gru": ("gru", dict(S["gru"], grad=["Input", "Weight", "Bias", "H0"])),
    "gru_reversed": ("gru", dict(
        S["gru"], attrs=dict(S["gru"]["attrs"], is_reverse=True),
        grad=["Input", "Weight", "Bias", "H0"])),
    "lstmp": ("lstmp", dict(S["lstmp"], grad=["Input", "Weight",
                                              "ProjWeight", "Bias"])),
    "sequence_expand": ("sequence_expand",
                        dict(S["sequence_expand"], grad=["X"])),
    "sequence_concat": ("sequence_concat",
                        dict(S["sequence_concat"], grad=["sq_a", "sq_b"])),
    "sequence_reshape": ("sequence_reshape",
                         dict(S["sequence_reshape"], grad=["X"])),
    "sequence_slice": ("sequence_slice",
                       dict(S["sequence_slice"], grad=["X"])),
    "lod_reset": ("lod_reset", dict(S["lod_reset"], grad=["X"])),
    "sequence_conv_x": ("sequence_conv",
                        dict(S["sequence_conv"], grad=["X", "Filter"])),
    "sequence_pool_max_tied": ("sequence_pool", dict(
        S["sequence_pool"], inputs={"X": _tied()},
        attrs={"pooltype": "MAX"})),
}
for _pt in ("AVERAGE", "SQRT", "MAX", "LAST", "FIRST"):
    GRAD_CASES["sequence_pool_" + _pt.lower()] = (
        "sequence_pool", dict(S["sequence_pool"], attrs={"pooltype": _pt}))


@pytest.mark.parametrize("case", sorted(GRAD_CASES))
def test_sequence_op_grad_replays(case):
    """Forward and gradient in both packages at the spec's tolerance:
    the recurrences reversed and with peepholes, every pool type."""
    op, s = GRAD_CASES[case]
    replay_spec(op, s)


def _level2():
    return optest.lodt2([2, 3], 4, 3)


def _level2_full():
    """A level-2 input whose samples fill their padded sub-sequence dim
    (4 each): no empty sub-sequence."""
    return optest.lodt2([4, 4], 4, 3)


LEVEL2_CASES = {
    "sequence_pool_sum": ("sequence_pool", dict(
        S["sequence_pool"], inputs={"X": _level2()},
        attrs={"pooltype": "SUM"}, grad=["X"])),
    "sequence_pool_max": ("sequence_pool", dict(
        S["sequence_pool"], inputs={"X": _level2()},
        attrs={"pooltype": "MAX"}, grad=["X"])),
    "sequence_softmax": ("sequence_softmax", dict(
        S["sequence_softmax"], inputs={"X": _level2_full()}, grad=["X"])),
    "sequence_conv": ("sequence_conv", dict(
        S["sequence_conv"], inputs={"X": _level2(), "Filter": F(9, 5)},
        grad=["X", "Filter"])),
}


@pytest.mark.parametrize("case", sorted(LEVEL2_CASES))
def test_sequence_op_on_a_level2_input(case):
    """The ops that take a level-2 input work at its finest level, as
    the reference's do (``_fold_level2``)."""
    op, s = LEVEL2_CASES[case]
    replay_spec(op, s)


def test_level2_softmax_empty_subsequences_get_no_nan_gradient():
    """An empty sub-sequence (a level-2 batch's padding): the forward
    equals the reference's, and where the reference's gradient is NaN
    (it masks exp's output alone: 0 * inf) the port's is 0; elsewhere
    the gradients agree at the spec's tolerance."""
    from test_torch_ops import run_in_port

    s = dict(S["sequence_softmax"], inputs={"X": _level2()}, grad=["X"])
    t = optest._make_optest("sequence_softmax", s)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)
    for n in names:
        np.testing.assert_allclose(got[n], ref[n], rtol=1e-5, atol=1e-5)
    t2 = optest._make_optest("sequence_softmax", s)
    t2.outputs = {k: ref[k] for k in t.outputs}
    gmain, _, gfeed, gnames = optest._grad_program(t2, s["grad"])
    want = optest._run_on(jfluid.CPUPlace(), gmain, gfeed, gnames)[0]
    g = run_in_port(gmain, gfeed, gnames)[gnames[0]]
    empty = np.isnan(want)
    assert empty.any() and np.isfinite(g).all()
    assert (g[empty] == 0).all()
    np.testing.assert_allclose(g[~empty], want[~empty], rtol=1e-5,
                               atol=1e-5)


def _layer_calls(fluid):
    """{layer: a function of the data vars that calls it}: every layer of
    sequence_op.py, and nets.sequence_conv_pool."""
    L = fluid.layers
    return {
        "dynamic_lstm": lambda d: list(L.dynamic_lstm(d["x"], size=16)),
        "dynamic_lstm_reversed": lambda d: list(L.dynamic_lstm(
            d["x"], size=16, use_peepholes=False, is_reverse=True)),
        "dynamic_gru": lambda d: [L.dynamic_gru(L.fc(d["x"], size=12),
                                                size=4)],
        "sequence_pool": lambda d: [L.sequence_pool(d["x"], pt) for pt in (
            "sum", "average", "sqrt", "max", "last", "first")],
        "sequence_first_last_step": lambda d: [
            L.sequence_first_step(d["x"]), L.sequence_last_step(d["x"])],
        "sequence_softmax": lambda d: [
            L.sequence_softmax(L.fc(d["x"], size=1))],
        "sequence_expand": lambda d: [L.sequence_expand(d["v"], d["y"])],
        "sequence_conv": lambda d: [L.sequence_conv(
            d["x"], num_filters=8, filter_size=3, act="tanh")],
        "sequence_erase": lambda d: [L.sequence_erase(d["ids"], [2, 3])],
        "lod_reset": lambda d: [L.lod_reset(d["x"], target_lod=[0, 2, 5]),
                                L.lod_reset(d["x"], y=d["ln"])],
        "edit_distance": lambda d: list(L.edit_distance(
            d["ids"], d["ids"], ignored_tokens=[0])),
        "lstm_unit": lambda d: list(L.lstm_unit(d["v"], d["h0"], d["h0"])),
        "gru_unit": lambda d: list(L.gru_unit(L.fc(d["v"], size=12),
                                              d["h0"], size=12)),
        "dynamic_lstmp": lambda d: list(L.dynamic_lstmp(d["x"], size=16,
                                                        proj_size=3)),
        "sequence_concat": lambda d: [L.sequence_concat([d["x"], d["y"]])],
        "sequence_reshape": lambda d: [L.sequence_reshape(d["x"], 8)],
        "sequence_slice": lambda d: [L.sequence_slice(d["x"], d["off"],
                                                      d["ln"])],
        "kmax_seq_score": lambda d: [L.kmax_seq_score(
            L.fc(d["x"], size=1), beam_size=2)],
        "sub_nested_seq": lambda d: [L.sub_nested_seq(d["nested"],
                                                      d["sel"])],
        "sequence_conv_pool": lambda d: [fluid.nets.sequence_conv_pool(
            d["x"], num_filters=8, filter_size=3)],
    }


def _all_layers(fluid, names=None):
    """A program calling the layers ``names`` (all by default) on ragged
    and dense data vars; returns (main, startup, outputs)."""
    L = fluid.layers
    calls = _layer_calls(fluid)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        d = {"x": L.data(name="x", shape=[16], dtype="float32",
                         lod_level=1),
             "y": L.data(name="y", shape=[16], dtype="float32",
                         lod_level=1),
             "v": L.data(name="v", shape=[4], dtype="float32"),
             "ids": L.data(name="ids", shape=[1], dtype="int64",
                           lod_level=1),
             "nested": L.data(name="nested", shape=[16], dtype="float32",
                              lod_level=2),
             "sel": L.data(name="sel", shape=[1], dtype="int64",
                           lod_level=1),
             "off": L.data(name="off", shape=[1], dtype="int64"),
             "ln": L.data(name="ln", shape=[1], dtype="int64"),
             "h0": L.data(name="h0", shape=[4], dtype="float32")}
        outs = []
        for name in names or sorted(calls):
            outs += calls[name](d)
    return main, startup, outs


def _same_programs(names=None):
    jmain, jstart, jouts = _all_layers(jfluid, names)
    tmain, tstart, touts = _all_layers(tfluid, names)
    assert len(touts) == len(jouts)
    ops = [op.type for op in tmain.desc.blocks[0].ops]
    assert ops == [op.type for op in jmain.desc.blocks[0].ops]
    for a, b in zip(touts, jouts):
        assert (a.name, tuple(a.shape), a.dtype, a.lod_level) == \
            (b.name, tuple(b.shape), b.dtype, b.lod_level)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    return ops


@pytest.mark.parametrize("layer", sorted(_layer_calls(tfluid)))
def test_sequence_layer_builds_the_references_program(layer):
    """Each layer alone: the same ops, output vars (names, inferred
    shapes and dtypes, lod levels) and serialized desc."""
    _same_programs([layer])


def test_every_sequence_layer_builds_the_references_program():
    ops = _same_programs()
    # seq_cross_attention has no layer in either package
    assert set(SEQUENCE_OPS) - {"seq_cross_attention"} <= set(ops)


def test_sequence_layers_are_exported():
    from paddle_tpu.fluid.layers import sequence_op as jseq
    from paddle_tpu_torch.fluid.layers import sequence_op as tseq

    assert tseq.__all__ == jseq.__all__ and len(tseq.__all__) == 19
    for name in tseq.__all__:
        assert getattr(tfluid.layers, name) is getattr(tseq, name)
