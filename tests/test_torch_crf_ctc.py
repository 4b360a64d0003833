"""The port's CRF / CTC / chunk_eval ops (``ops/crf_ctc.py``) and their
layers against the JAX package, on the CPU:

- ``linear_chain_crf``, ``crf_decoding``, ``warpctc`` and ``ctc_align``
  replay their ``SPECS`` entries (``tools/tpu_optest.py``) at the spec's
  tolerance, with gradients where the spec has them, plus variants
  (blank 2, norm_by_times, a label CTC cannot align, Viterbi with a
  Label, every tie pattern);
- the brute-force cases of ``tests/test_crf_ctc.py`` (every path of a
  CRF enumerated, every CTC alignment), its CTC training run and its
  ``ctc_align`` and ``chunk_eval`` cases, each also against the JAX
  package's run of the same program;
- ``chunk_eval`` under every scheme against the reference's;
- the layers' ProgramDescs (their shapes from build-time inference)
  and the registry.
"""
import itertools

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.lod import LoDTensor as JLoD
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.core.lod import LoDTensor as TLoD
from test_torch_ops import _check, optest, replay_spec

S = optest.SPECS
OPS = ["linear_chain_crf", "crf_decoding", "warpctc", "ctc_align"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("op", OPS)
def test_op_replays_its_spec(op):
    replay_spec(op)


def _lodt(padded, lens):
    return optest.lodt(np.asarray(padded), lens)


_rng = np.random.RandomState(11)
# the tie patterns: every score equal; integer scores (many equal sums);
# a transition that makes two predecessors tie at every step
_TIES = {
    "all_equal": (np.zeros((2, 5, 4), np.float32),
                  np.zeros((6, 4), np.float32)),
    "integer": (_rng.randint(0, 2, (2, 5, 4)).astype(np.float32),
                _rng.randint(0, 2, (6, 4)).astype(np.float32)),
    "equal_rows": (np.tile(np.asarray([1.0, 1.0, 0.0, 1.0], np.float32),
                           (2, 5, 1)),
                   np.asarray([[0] * 4, [0, 0.5, 0, 0.5]] + [[0] * 4] * 4,
                              np.float32)),
}

VARIANTS = {
    "warpctc_blank_2": ("warpctc", dict(S["warpctc"], attrs={
        "blank": 2, "norm_by_times": False})),
    "warpctc_norm_by_times": ("warpctc", dict(S["warpctc"], attrs={
        "blank": 0, "norm_by_times": True})),
    # row 0 needs 3 frames for 3 distinct labels and has 2: its alpha
    # stays at NEG, where logaddexp's gradient is jax's (1 each)
    "warpctc_unalignable": ("warpctc", dict(S["warpctc"], inputs=dict(
        S["warpctc"]["inputs"],
        Logits=_lodt(np.asarray(S["warpctc"]["inputs"]["Logits"].data)
                     [:7].reshape(1, 7, 5).repeat(2, 0)[:, :6], [2, 5]),
        Label=_lodt(np.asarray([[[1], [2], [3]], [[1], [1], [0]]],
                               np.int64), [3, 2])))),
    "warpctc_repeated_labels": ("warpctc", dict(S["warpctc"], inputs=dict(
        S["warpctc"]["inputs"],
        Label=_lodt(np.asarray([[[1], [1], [2]], [[3], [3], [0]]],
                               np.int64), [3, 2])))),
    "crf_decoding_with_label": ("crf_decoding", dict(
        S["crf_decoding"], inputs=dict(
            S["crf_decoding"]["inputs"],
            Label=_lodt(_rng.randint(0, 4, (2, 5, 1)).astype(np.int64),
                        [5, 3])))),
    "ctc_align_blank_1_pad_9": ("ctc_align", dict(S["ctc_align"], attrs={
        "blank": 1, "padding_value": 9})),
    "linear_chain_crf_dense": ("linear_chain_crf", dict(
        S["linear_chain_crf"], inputs=dict(
            S["linear_chain_crf"]["inputs"],
            Emission=np.asarray(S["linear_chain_crf"]["inputs"]
                                ["Emission"].data[:8]).reshape(2, 4, 4),
            Label=_rng.randint(0, 4, (2, 4, 1)).astype(np.int64)))),
}
for _name, (_em, _tr) in _TIES.items():
    VARIANTS["crf_decoding_ties_" + _name] = ("crf_decoding", dict(
        S["crf_decoding"], inputs={"Emission": _lodt(_em, [5, 3]),
                                   "Transition": _tr}))
    VARIANTS["linear_chain_crf_ties_" + _name] = ("linear_chain_crf", dict(
        S["linear_chain_crf"], inputs=dict(
            S["linear_chain_crf"]["inputs"], Emission=_lodt(_em, [5, 3]),
            Transition=_tr)))


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_op_variant_replays(case):
    replay_spec(*VARIANTS[case])


def test_viterbi_ties_take_the_first_tag():
    """All scores equal: every path ties and the reference's argmax
    takes tag 0 at each step; the port gives the same path."""
    em, tr = _TIES["all_equal"]
    t = optest._make_optest("crf_decoding", dict(
        S["crf_decoding"], inputs={"Emission": _lodt(em, [5, 3]),
                                   "Transition": tr}))
    names = optest._fetch_names(t)
    main, _, feed = t._build()
    from test_torch_ops import run_in_port
    got = np.asarray(run_in_port(main, feed, names)[names[0]])
    assert got.shape[:2] == (2, 8) and not got.any()


def test_first_argmax_takes_the_first_maximum():
    from paddle_tpu_torch.ops.crf_ctc import _first_argmax

    x = torch.tensor([[[1.0, 3.0], [3.0, 3.0], [3.0, 0.0]]])
    best, arg = _first_argmax(x, 1)
    assert best.tolist() == [[3.0, 3.0]] and arg.tolist() == [[1, 0]]


def test_logaddexp_is_jaxs_value_and_gradient():
    """Against jnp.logaddexp and its jvp: equal inputs, NEG pairs (the
    reference's cotangent 1 each, not torch's 0.5), one NEG."""
    import jax
    import jax.numpy as jnp

    from paddle_tpu_torch.ops.crf_ctc import NEG, logaddexp

    a = np.asarray([3.0, NEG, NEG, -2.5, 0.0], np.float32)
    b = np.asarray([3.0, NEG, 2.0, 1.25, -0.0], np.float32)
    want = np.asarray(jnp.logaddexp(a, b))
    ga, gb = jax.grad(lambda x, y: jnp.sum(jnp.logaddexp(x, y)),
                      (0, 1))(a, b)
    ta = torch.tensor(a, requires_grad=True)
    tb = torch.tensor(b, requires_grad=True)
    out = logaddexp(ta, tb)
    np.testing.assert_array_equal(out.detach().numpy(), want)
    da, db = torch.autograd.grad(out.sum(), (ta, tb))
    np.testing.assert_allclose(da.numpy(), np.asarray(ga), rtol=1e-6)
    np.testing.assert_allclose(db.numpy(), np.asarray(gb), rtol=1e-6)


# --------------------------------------------------------------------------
# tests/test_crf_ctc.py's cases, in both packages
# --------------------------------------------------------------------------

def _both(build, feed, params=None, steps=1):
    """Run ``build(fluid) -> fetch vars`` in both packages on ``feed``
    ({name: (padded or dense array, lens or None)}); ``params`` set by
    name after the startup.  Returns (the reference's fetches, the
    port's), each a list over ``steps`` runs."""
    out = []
    for fluid, lod, scope in ((jfluid, JLoD, JScope()),
                              (tfluid, TLoD, tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = build(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        for n, v in (params or {}).items():
            if fluid is jfluid:
                scope.set(n, v)
            else:
                scope.set(n, torch.from_numpy(v))
        f = {n: (lod.from_sequences([a[i, :l] for i, l in enumerate(ls)])
                 if ls is not None else a) for n, (a, ls) in feed.items()}
        out.append([[np.asarray(v) for v in
                     exe.run(main, feed=f, fetch_list=fetch, scope=scope)]
                    for _ in range(steps)])
    return out


def _crf_brute(em, trans, lens):
    """Every path enumerated: logZ and the score of a path."""
    start, stop, pair = trans[0], trans[1], trans[2:]
    n, t, k = em.shape

    def score(row, path):
        s = start[path[0]] + em[row, 0, path[0]] + stop[path[-1]]
        for i in range(1, len(path)):
            s += em[row, i, path[i]] + pair[path[i - 1], path[i]]
        return s

    logz = np.zeros(n)
    for row in range(n):
        scores = [score(row, p)
                  for p in itertools.product(range(k), repeat=lens[row])]
        logz[row] = np.log(np.sum(np.exp(scores)))
    return logz, score


def _crf_program(k, decode=False):
    def build(fluid):
        e = fluid.layers.data(name="e", shape=[k], lod_level=1,
                              dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], lod_level=1,
                                dtype="int64")
        ll = fluid.layers.linear_chain_crf(
            e, lab, param_attr=fluid.ParamAttr(name="crf_w"))
        if decode:
            return [fluid.layers.crf_decoding(
                e, param_attr=fluid.ParamAttr(name="crf_w"))]
        return [ll]
    return build


def test_linear_chain_crf_matches_brute_force():
    rng = np.random.RandomState(0)
    n, t, k = 2, 3, 3
    em = rng.randn(n, t, k).astype(np.float32)
    trans = (rng.randn(k + 2, k) * 0.5).astype(np.float32)
    lens = [3, 2]
    label = rng.randint(0, k, (n, t, 1)).astype(np.int64)
    (ref,), (got,) = _both(_crf_program(k), {"e": (em, lens),
                                             "lab": (label, lens)},
                           {"crf_w": trans})
    got = np.ravel(got[0])
    logz, score = _crf_brute(em, trans, lens)
    for row in range(n):
        gold = score(row, list(label[row, :lens[row], 0]))
        np.testing.assert_allclose(got[row], logz[row] - gold,
                                   rtol=2e-4, atol=2e-4)
    _check("LogLikelihood", ref[0], got.reshape(ref[0].shape), (1e-5, 1e-5))


def test_crf_decoding_matches_brute_force():
    rng = np.random.RandomState(1)
    n, t, k = 2, 4, 3
    em = rng.randn(n, t, k).astype(np.float32)
    trans = (rng.randn(k + 2, k) * 0.5).astype(np.float32)
    lens = [4, 2]
    (ref,), (got,) = _both(
        _crf_program(k, decode=True),
        {"e": (em, lens), "lab": (np.zeros((n, t, 1), np.int64), lens)},
        {"crf_w": trans})
    got = got[0][..., 0]
    _, score = _crf_brute(em, trans, lens)
    for row in range(n):
        best = max(itertools.product(range(k), repeat=lens[row]),
                   key=lambda p: score(row, list(p)))
        assert got[row, :lens[row]].tolist() == list(best), row
    np.testing.assert_array_equal(got, ref[0][..., 0])


def _ctc_brute(logits, label, blank):
    """-log of the summed probability of every alignment that collapses
    to ``label``."""
    t, v = logits.shape
    p = np.exp(logits - logits.max(-1, keepdims=True))
    p = p / p.sum(-1, keepdims=True)

    def collapse(path):
        out, prev = [], None
        for s in path:
            if s != prev and s != blank:
                out.append(s)
            prev = s
        return out

    total = 0.0
    for path in itertools.product(range(v), repeat=t):
        if collapse(path) == list(label):
            total += np.prod([p[i, s] for i, s in enumerate(path)])
    return -np.log(total)


def test_warpctc_matches_brute_force():
    rng = np.random.RandomState(2)
    n, t, v = 2, 4, 3
    logits = rng.randn(n, t, v).astype(np.float32)
    labels = np.asarray([[[1], [2]], [[2], [0]]], np.int64)
    t_lens, l_lens = [4, 3], [2, 1]

    def build(fluid):
        lg = fluid.layers.data(name="lg", shape=[v], lod_level=1,
                               dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], lod_level=1,
                                dtype="int64")
        return [fluid.layers.warpctc(lg, lab, blank=0)]

    (ref,), (got,) = _both(build, {"lg": (logits, t_lens),
                                   "lab": (labels, l_lens)})
    got = np.ravel(got[0])
    for i in range(n):
        want = _ctc_brute(logits[i, :t_lens[i]],
                          labels[i, :l_lens[i], 0].tolist(), 0)
        np.testing.assert_allclose(got[i], want, rtol=1e-4)
    np.testing.assert_allclose(got, np.ravel(ref[0]), rtol=1e-5)


def test_warpctc_trains():
    """CTC on a two-sample copy task: the loss halves under SGD in 25
    steps (test_crf_ctc.py's bar), the trajectory within 1e-4 of the
    reference's from its startup values."""
    rng = np.random.RandomState(3)
    x = np.zeros((2, 6, 8), np.float32)
    x[0] = rng.randn(6, 8)
    x[1, :4] = rng.randn(4, 8)
    lab = np.asarray([[[1], [3]], [[2], [0]]], np.int64)
    w0 = (rng.randn(8, 5) * 0.3).astype(np.float32)

    def build(fluid):
        xv = fluid.layers.data(name="x", shape=[8], lod_level=1,
                               dtype="float32")
        lv = fluid.layers.data(name="lab", shape=[1], lod_level=1,
                               dtype="int64")
        h = fluid.layers.fc(xv, size=5,
                            param_attr=fluid.ParamAttr(name="w"),
                            bias_attr=fluid.ParamAttr(name="b"))
        loss = fluid.layers.mean(fluid.layers.warpctc(h, lv, blank=0))
        fluid.optimizer.SGD(learning_rate=0.5).minimize(loss)
        return [loss]

    ref, got = _both(build, {"x": (x, [6, 4]), "lab": (lab, [2, 1])},
                     {"w": w0, "b": np.zeros((5,), np.float32)}, steps=25)
    ls = [float(np.ravel(s[0])[0]) for s in got]
    rs = [float(np.ravel(s[0])[0]) for s in ref]
    assert ls[-1] < ls[0] * 0.5, (ls[0], ls[-1])
    np.testing.assert_allclose(ls, rs, rtol=1e-4)


def test_ctc_align_and_the_greedy_decoder():
    """test_crf_ctc.py's ctc_align case, and ctc_greedy_decoder (top-1
    then ctc_align) on logits with tied maxima, against the
    reference."""
    xv = np.asarray([[0, 1, 1, 0, 2, 2, 0, 3],
                     [1, 1, 2, 0, 0, 2, 2, 1]], np.int64)

    def align(fluid):
        x = fluid.layers.data(name="x", shape=[8], dtype="int64",
                              append_batch_size=False)
        helper = fluid.layer_helper.LayerHelper("ctc_align")
        o = helper.create_tmp_variable(dtype="int64")
        helper.append_op(type="ctc_align", inputs={"Input": [x]},
                         outputs={"Output": [o]},
                         attrs={"blank": 0, "padding_value": 0})
        return [o]

    (ref,), (got,) = _both(align, {"x": (xv, None)})
    np.testing.assert_array_equal(got[0][0], [1, 2, 3, 0, 0, 0, 0, 0])
    np.testing.assert_array_equal(got[0][1], [1, 2, 2, 1, 0, 0, 0, 0])
    np.testing.assert_array_equal(got[0], ref[0])

    rng = np.random.RandomState(4)
    logits = rng.randint(0, 3, (3, 8, 4)).astype(np.float32)

    def greedy(fluid):
        x = fluid.layers.data(name="p", shape=[8, 4], dtype="float32")
        return [fluid.layers.ctc_greedy_decoder(x, blank=0)]

    (ref,), (got,) = _both(greedy, {"p": (logits, None)})
    np.testing.assert_array_equal(got[0], ref[0])


def _chunk_program(scheme, num_types, excluded=None, computed=False,
                   printed=False):
    def build(fluid):
        inf = fluid.layers.data(name="inf", shape=[1], lod_level=1,
                                dtype="int64")
        lab = fluid.layers.data(name="lab", shape=[1], lod_level=1,
                                dtype="int64")
        if computed:
            inf = fluid.layers.cast(fluid.layers.scale(
                fluid.layers.cast(inf, "float32"), scale=1.0), "int64")
        outs = fluid.layers.chunk_eval(inf, lab, scheme,
                                       num_chunk_types=num_types,
                                       excluded_chunk_types=excluded)
        if printed:
            fluid.layers.Print(outs[0], message="prec")
            return [outs[0]]
        return list(outs)
    return build


def _seqs(rows):
    lens = [len(r) for r in rows]
    pad = np.zeros((len(rows), max(lens), 1), np.int64)
    for i, r in enumerate(rows):
        pad[i, :len(r), 0] = r
    return pad, lens


def test_chunk_eval_iob():
    # 2 types, IOB: tag = type*2 + {B:0, I:1}, O = 4
    # label [B0 I0 O B1] -> {(0,2,0), (3,4,1)}; infer [B0 I0 O B0]
    (ref,), (got,) = _both(_chunk_program("IOB", 2), {
        "inf": _seqs([[0, 1, 4, 0]]), "lab": _seqs([[0, 1, 4, 2]])})
    p, r, f1, ni, nl, nc = got
    assert int(ni[0]) == 2 and int(nl[0]) == 2 and int(nc[0]) == 1
    np.testing.assert_allclose([p[0], r[0], f1[0]], [0.5, 0.5, 0.5])
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_chunk_eval_computed_input_respects_lengths():
    """chunk_eval on a computed (not fed) inference var still sees the
    real sequence lengths, not the padded T."""
    (ref,), (got,) = _both(_chunk_program("IOB", 2, computed=True), {
        "inf": _seqs([[0, 1, 4, 0], [2]]), "lab": _seqs([[0, 1, 4, 2],
                                                        [2]])})
    assert [int(got[k][0]) for k in (3, 4, 5)] == [3, 3, 2]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_postlude_host_op_chain():
    """A host op reading another postlude host op's output (chunk_eval
    -> Print) is not a device fetch."""
    (ref,), (got,) = _both(_chunk_program("IOB", 2, computed=True,
                                          printed=True),
                           {"inf": _seqs([[0, 1]]), "lab": _seqs([[0, 1]])})
    np.testing.assert_allclose(float(np.ravel(got[0])[0]), 1.0)
    np.testing.assert_array_equal(got[0], ref[0])


@pytest.mark.parametrize("scheme,num_types,excluded", [
    ("plain", 3, None), ("IOB", 3, None), ("IOE", 3, None),
    ("IOBES", 3, None), ("IOB", 3, [1])])
def test_chunk_eval_scheme_against_the_reference(scheme, num_types,
                                                 excluded):
    """Random tag rows (O included) of ragged lengths: every count and
    rate equals the reference's."""
    rng = np.random.RandomState(len(scheme) + num_types)
    kinds = {"plain": 1, "IOB": 2, "IOE": 2, "IOBES": 4}[scheme]
    hi = num_types * kinds + (0 if scheme == "plain" else 1)
    rows = [rng.randint(0, hi, rng.randint(3, 12)).tolist()
            for _ in range(5)]
    noisy = [[t if rng.rand() < 0.7 else int(rng.randint(0, hi))
              for t in r] for r in rows]
    (ref,), (got,) = _both(_chunk_program(scheme, num_types, excluded), {
        "inf": _seqs(noisy), "lab": _seqs(rows)})
    assert int(got[4][0]) > 0
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def test_crf_layers_build_the_reference_desc():
    """linear_chain_crf + crf_decoding (with and without a label),
    warpctc, ctc_greedy_decoder and chunk_eval: the same ProgramDesc."""
    def build(fluid):
        e = fluid.layers.data(name="e", shape=[4], lod_level=1,
                              dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[1], lod_level=1,
                                dtype="int64")
        ll = fluid.layers.linear_chain_crf(
            e, lab, param_attr=fluid.ParamAttr(name="crfw"))
        fluid.layers.mean(ll)
        d = fluid.layers.crf_decoding(e, fluid.ParamAttr(name="crfw"))
        fluid.layers.crf_decoding(e, fluid.ParamAttr(name="crfw"), label=lab)
        fluid.layers.warpctc(e, lab, blank=1, norm_by_times=True)
        fluid.layers.ctc_greedy_decoder(e, blank=0)
        fluid.layers.chunk_eval(d, lab, "IOB", 2, excluded_chunk_types=[1])

    descs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            build(fluid)
        descs.append((main.desc.serialize_to_string(),
                      startup.desc.serialize_to_string()))
    assert descs[0] == descs[1]


def test_the_port_registers_every_crf_ctc_op():
    import importlib
    import inspect

    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    mod = importlib.import_module("paddle_tpu.ops.crf_ctc")
    ops = sorted(op for op in jreg.registered_ops()
                 if inspect.getmodule(jreg._registry[op].lower) is mod)
    assert ops == ["chunk_eval", "crf_decoding", "ctc_align",
                   "linear_chain_crf", "warpctc"]
    for op in ops:
        j, t = jreg._registry[op], treg.get_op_info(op)
        assert (t.host_op, t.seq_aware, t.no_vjp_outputs,
                t.grad_maker is None) == (j.host_op, j.seq_aware,
                                          tuple(j.no_vjp_outputs),
                                          j.grad_maker is None), op
