"""The port's beam-search ops (``ops/beam_search.py``) and layers against
the JAX package, on the CPU:

- ``beam_search`` replays its ``SPECS`` entry (``tools/tpu_optest.py``)
  and variants with finished beams and tied scores;
- ``tests/test_beam_search.py``'s step semantics and its While-loop
  decode (the garden-path LM where beam 2 beats greedy), in both
  packages: ids bit for bit, scores within 1e-6; the same decode at two
  sentences and three beams over a random table;
- ties: candidates of equal score are taken in index order, as
  ``jax.lax.top_k`` takes them, where ``torch.topk`` may order them
  otherwise; the ``top_k`` op likewise;
- the decode program's ProgramDesc and the registry.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from test_torch_ops import optest, replay_spec

S = optest.SPECS
END = 0


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_beam_search_replays_its_spec():
    replay_spec("beam_search")


_TIED = np.full((4, 6), -1.0, np.float32)
VARIANTS = {
    # every candidate of every beam ties: the lowest positions win
    "all_tied": dict(S["beam_search"], inputs=dict(
        S["beam_search"]["inputs"], scores=_TIED)),
    # ties between beams: beam 1's candidates equal beam 0's
    "tied_across_beams": dict(S["beam_search"], inputs=dict(
        S["beam_search"]["inputs"], scores=np.tile(
            np.asarray([[-0.5, -0.5, -1.0, -2.0, -0.5, -3.0]], np.float32),
            (4, 1)))),
    # a finished beam (pre_id == end_id 0) in each sentence
    "finished": dict(S["beam_search"], inputs=dict(
        S["beam_search"]["inputs"],
        pre_ids=np.asarray([[0], [3], [2], [0]], np.int64))),
    "beam_3": dict(S["beam_search"], inputs={
        "pre_ids": np.asarray([[1], [2], [0], [4], [4], [4]], np.int64),
        "pre_scores": np.asarray([[-1.0], [-1.5], [-0.2], [-2.0], [-2.0],
                                  [-2.0]], np.float32),
        "ids": np.tile(np.arange(5, dtype=np.int64), (6, 1)),
        "scores": np.log(np.tile(np.asarray(
            [[0.1, 0.2, 0.2, 0.2, 0.3]], np.float32), (6, 1)))},
        attrs={"beam_size": 3, "end_id": 0}),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_beam_search_variant_replays(case):
    replay_spec("beam_search", VARIANTS[case])


def test_ties_are_taken_in_index_order():
    """One sentence, two beams, every candidate at the same score:
    jax.lax.top_k takes flat positions 0 and 1, so both winners come
    from beam 0; the port takes the same two."""
    from paddle_tpu_torch.ops.tensor import top_k

    x = torch.full((1, 6), -1.0)
    vals, pos = top_k(x, 2)
    assert pos.tolist() == [[0, 1]] and vals.tolist() == [[-1.0, -1.0]]
    x = torch.tensor([[0.0, 2.0, 1.0, 2.0, 2.0]])
    assert top_k(x, 4)[1].tolist() == [[1, 3, 4, 2]]


def test_top_k_op_orders_ties_as_the_reference():
    """The top_k op on rows with repeated values: values and indices
    equal the reference's (the lower index first)."""
    rng = np.random.RandomState(5)
    x = rng.randint(0, 3, (4, 9)).astype(np.float32)
    s = dict(S["top_k"], inputs={"X": x}, attrs={"k": 5})
    replay_spec("top_k", s)


def _run(fluid, scope, build, params, feed=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        fetch = build(fluid)
    exe = fluid.Executor(fluid.CPUPlace())
    exe.run(startup, scope=scope)
    for n, v in params.items():
        scope.set(n, v if fluid is jfluid else torch.from_numpy(v))
    out = exe.run(main, feed=feed or {}, fetch_list=fetch, scope=scope)
    return main, [np.asarray(o) for o in out]


def _both(build, params=None, feed=None):
    (jm, ref), (tm, got) = (_run(jfluid, JScope(), build, params or {},
                                 feed),
                            _run(tfluid, tfluid.Scope(), build,
                                 params or {}, feed))
    assert tm.desc.serialize_to_string() == jm.desc.serialize_to_string()
    return ref, got


def test_beam_search_step_semantics():
    """test_beam_search.py's step: N = 1 sentence, B = 2 beams, K = 3
    candidates; beam 1 has finished."""
    def build(fluid):
        layers = fluid.layers
        pre_ids = layers.data(name="pre_ids", shape=[1], dtype="int64",
                              append_batch_size=False)
        pre_scores = layers.data(name="pre_scores", shape=[1],
                                 dtype="float32", append_batch_size=False)
        ids = layers.data(name="ids", shape=[3], dtype="int64",
                          append_batch_size=False)
        scores = layers.data(name="scores", shape=[3], dtype="float32",
                             append_batch_size=False)
        return list(layers.beam_search(pre_ids, pre_scores, ids, scores,
                                       beam_size=2, end_id=END))

    ref, got = _both(build, feed={
        "pre_ids": np.asarray([[5], [END]], np.int64),
        "pre_scores": np.asarray([[-0.5], [-0.1]], np.float32),
        "ids": np.asarray([[7, 8, END], [1, 2, 3]], np.int64),
        "scores": np.asarray([[-0.6, -0.9, -2.0], [-9.0, -9.0, -9.0]],
                             np.float32)})
    got_ids, got_scores, got_parent = got
    assert got_ids.reshape(-1).tolist() == [END, 7]
    np.testing.assert_allclose(got_scores.reshape(-1), [-0.1, -0.6],
                               rtol=1e-6)
    assert got_parent.tolist() == [1, 0]
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(a, b)


def build_decode(fluid, beam_size, n=1, max_len=4, vocab=5):
    """test_beam_search.py's While-loop decode over a transition table
    (the machine_translation decode program's shape), generalised to
    ``n`` sentences: only beam 0 of each is live at t = 0."""
    layers = fluid.layers
    nb = n * beam_size
    counter = layers.fill_constant(shape=[1], dtype="int64", value=0)
    limit = layers.fill_constant(shape=[1], dtype="int64", value=max_len)
    init_ids = layers.fill_constant(shape=[nb, 1], dtype="int64", value=1)
    init_scores = layers.assign(np.asarray(
        ([[0.0]] + [[-1e9]] * (beam_size - 1)) * n, np.float32))
    ids_arr = layers.array_write(init_ids, i=counter, capacity=max_len + 1)
    sc_arr = layers.array_write(init_scores, i=counter,
                                capacity=max_len + 1)
    par_arr = layers.array_write(
        layers.assign(np.zeros((nb,), np.int32)), i=counter,
        capacity=max_len + 1)
    cond = layers.less_than(x=counter, y=limit)
    w = layers.While(cond=cond)
    with w.block():
        pre_ids = layers.array_read(ids_arr, i=counter)
        pre_scores = layers.array_read(sc_arr, i=counter)
        logp = layers.embedding(pre_ids, size=[vocab, vocab],
                                param_attr=fluid.ParamAttr(name="table"))
        logp = layers.reshape(logp, [nb, vocab])
        accu = layers.elementwise_add(x=logp, y=pre_scores)
        cand_scores, cand_ids = layers.topk(accu, k=vocab - 1)
        sel_ids, sel_scores, parent = layers.beam_search(
            pre_ids, pre_scores, cand_ids, cand_scores,
            beam_size=beam_size, end_id=END)
        layers.increment(x=counter, value=1, in_place=True)
        layers.array_write(sel_ids, i=counter, array=ids_arr)
        layers.array_write(sel_scores, i=counter, array=sc_arr)
        layers.array_write(parent, i=counter, array=par_arr)
        layers.less_than(x=counter, y=limit, cond=cond)
    return list(layers.beam_search_decode(ids_arr, sc_arr, par_arr,
                                          beam_size, END))


def garden_table():
    """Greedy takes 1 -> 2 and then a weak continuation; 1 -> 3 -> END
    has the higher total probability."""
    t = np.full((5, 5), -1e9, np.float32)
    t[1, 2] = np.log(0.6)
    t[1, 3] = np.log(0.4)
    t[2, 4] = np.log(0.55)
    t[2, END] = np.log(0.45)
    t[4, END] = 0.0
    t[3, END] = 0.0
    t[END, END] = 0.0
    return t


def _decode(beam_size, table, n=1):
    ref, got = _both(lambda fluid: build_decode(fluid, beam_size, n=n),
                     {"table": table})
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_allclose(got[1], ref[1], rtol=1e-6, atol=1e-6)
    return got


def test_beam_beats_greedy_on_garden_path():
    g_ids, g_scores = _decode(1, garden_table())
    assert g_ids[0, 0].tolist()[:4] == [1, 2, 4, END]
    np.testing.assert_allclose(g_scores[0, 0], np.log(0.6 * 0.55),
                               rtol=1e-5)
    b_ids, b_scores = _decode(2, garden_table())
    assert b_ids[0, 0].tolist()[:3] == [1, 3, END]
    np.testing.assert_allclose(b_scores[0, 0], np.log(0.4), rtol=1e-5)
    assert b_scores[0, 0] > g_scores[0, 0]
    assert b_ids[0, 1].tolist()[:4] == [1, 2, 4, END]


@pytest.mark.parametrize("seed", [0, 1])
def test_decode_of_two_sentences_and_three_beams(seed):
    """A random log-prob table (every row a distribution), two
    sentences of three beams, five steps: the reference's beams and
    scores."""
    rng = np.random.RandomState(seed)
    p = rng.uniform(0.1, 1.0, (5, 5))
    table = np.log(p / p.sum(1, keepdims=True)).astype(np.float32)
    ids, scores = _decode(3, table, n=2)
    assert ids.shape == (2, 3, 5) and scores.shape == (2, 3)
    assert (np.diff(scores, axis=1) <= 0).all()


def test_decode_with_tied_tables():
    """Every transition equally likely: all beams tie at every step, so
    each choice is the tie rule's; the reference's beams exactly."""
    _decode(2, np.full((5, 5), np.log(0.2), np.float32), n=2)


def test_the_port_registers_every_beam_search_op():
    import importlib
    import inspect

    from paddle_tpu.core import registry as jreg
    from paddle_tpu_torch.core import registry as treg

    mod = importlib.import_module("paddle_tpu.ops.beam_search")
    ops = sorted(op for op in jreg.registered_ops()
                 if inspect.getmodule(jreg._registry[op].lower) is mod)
    assert ops == ["beam_search", "beam_search_decode"]
    for op in ops:
        assert treg.get_op_info(op).grad_maker is None
