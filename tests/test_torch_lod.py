"""Ragged (LoD) feeds in the port against the JAX package, on the CPU.

- ``core/lod.LoDTensor``'s padding at levels 1, 2 and 3 and its inverse,
  ``fluid.create_lod_tensor`` / ``create_random_int_lodtensor`` and the
  ``DataFeeder``'s ragged slots give the reference's arrays and offsets;
- ``executor_impl._prepare_lod_feeds`` gives the reference's padded
  arrays and '@LEN' / '@LEN@j' lengths (int32), bucket for bucket;
- ``Executor.run`` on lod_level 1, 2 and 3 feeds matches the reference
  (rtol 1e-5), and ``prepare()`` / ``run_prepared`` matches ``run()``
  bit for bit, across padded buckets (a new bucket is taken; a dense
  feed of another shape still raises);
- a length never becomes a variable: not in the scope, not in a
  checkpoint; a fetch of one is the lengths, or None where the block
  made none.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import executor_impl as jexec
from paddle_tpu.core.lod import LoDTensor as JLoD
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.core import executor_impl as texec
from paddle_tpu_torch.core.executor_impl import PreparedShapeMismatch
from paddle_tpu_torch.core.lod import LoDTensor as TLoD
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _nested(rng, depth, width=3):
    """A ragged nested list ``depth`` levels deep of [k, 2] float rows
    (lengths 1 .. width at every level)."""
    if depth == 0:
        return rng.randn(2).astype(np.float32)
    return [_nested(rng, depth - 1, width)
            for _ in range(rng.randint(1, width + 1))]


def _lod_of(seqs, depth):
    """(flat data, offset lod) of a nested list ``depth`` levels deep."""
    lod = [[0] for _ in range(depth)]
    rows = []

    def walk(x, level):
        if level == depth:
            rows.append(x)
            return
        lod[level].append(lod[level][-1] + len(x))
        for item in x:
            walk(item, level + 1)

    for s in seqs:
        walk(s, 0)
    return np.stack(rows).astype(np.float32), lod


def _pair(data, lod):
    return JLoD(data, lod), TLoD(data.copy(), [list(l) for l in lod])


@pytest.mark.parametrize("level", [1, 2, 3])
def test_prepare_lod_feeds_pads_as_the_reference(level):
    """Mirrors tests/test_sequence_ops.py:238 / :464: the padded array
    and every '@LEN' / '@LEN@j' array equal the reference's (dtype
    int32), the dense feed rides along."""
    rng = np.random.RandomState(level)
    data, lod = _lod_of([_nested(rng, level, 4) for _ in range(3)], level)
    j, t = _pair(data, lod)
    dense = rng.randn(3, 2).astype(np.float32)
    want = jexec._prepare_lod_feeds({"x": j, "d": dense})
    got = texec._prepare_lod_feeds({"x": t, "d": dense})
    assert sorted(got) == sorted(want)
    assert len([k for k in got if "@LEN" in k]) == level
    for k in want:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]))
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype
    assert got["x@LEN"].dtype == np.int32
    # T pads to a multiple of 8, the outer ragged dims to 4
    assert got["x"].shape[level] % 8 == 0
    assert all(d % 4 == 0 for d in got["x"].shape[1:level])


def test_dense_feeds_pass_through():
    feed = {"a": np.zeros((2, 3), np.float32)}
    assert texec._prepare_lod_feeds(feed) is feed


def test_lod_tensor_pads_and_inverts_as_the_reference():
    """to_padded / to_padded_2level / to_padded_klevel and their
    inverses (tests/test_sequence_ops.py:464's round trip)."""
    rng = np.random.RandomState(7)
    d1, l1 = _lod_of([_nested(rng, 1, 5) for _ in range(3)], 1)
    j, t = _pair(d1, l1)
    for a, b in zip(j.to_padded(max_len=8), t.to_padded(max_len=8)):
        np.testing.assert_array_equal(a, b)
    back = TLoD.from_padded(*t.to_padded())
    assert back.lod == t.lod
    np.testing.assert_array_equal(back.data, t.data)
    d2, l2 = _lod_of([_nested(rng, 2) for _ in range(2)], 2)
    j, t = _pair(d2, l2)
    for a, b in zip(j.to_padded_2level(), t.to_padded_2level()):
        np.testing.assert_array_equal(a, b)
    back = TLoD.from_padded_2level(*t.to_padded_2level())
    assert back.lod == t.lod
    d3, l3 = _lod_of([_nested(rng, 3) for _ in range(2)], 3)
    j, t = _pair(d3, l3)
    pj, lj = j.to_padded_klevel()
    pt, lt = t.to_padded_klevel()
    np.testing.assert_array_equal(pj, pt)
    for a, b in zip(lj, lt):
        np.testing.assert_array_equal(a, b)
    back = TLoD.from_padded_klevel(pt, lt)
    assert back.lod == t.lod
    np.testing.assert_array_equal(back.data, t.data)
    assert (t.lod_level(), t.sequence_lengths(), t.num_sequences()) == \
        (j.lod_level(), j.sequence_lengths(), j.num_sequences())


def test_create_lod_tensor_matches_the_reference():
    data = np.arange(10, dtype=np.float32).reshape(5, 2)
    j = jfluid.create_lod_tensor(data, [[2, 3]])
    t = tfluid.create_lod_tensor(data, [[2, 3]])
    assert isinstance(t, TLoD) and t.lod == j.lod == [[0, 2, 5]]
    np.testing.assert_array_equal(t.data, j.data)
    words = [[1, 2, 3], [4, 5]]
    j = jfluid.create_lod_tensor(words, [[3, 2]])
    t = tfluid.create_lod_tensor(words, [[3, 2]])
    assert t.lod == j.lod and t.dtype == np.int64
    np.testing.assert_array_equal(t.data, np.asarray(j.data))
    np.random.seed(3)
    j = jfluid.create_random_int_lodtensor([[2, 1], [1, 2, 3]], [4],
                                           low=0, high=9)
    np.random.seed(3)
    t = tfluid.create_random_int_lodtensor([[2, 1], [1, 2, 3]], [4],
                                           low=0, high=9)
    assert t.lod == j.lod and t.shape == (6, 4)
    np.testing.assert_array_equal(t.data, j.data)
    with pytest.raises(AssertionError):
        tfluid.create_lod_tensor(data, [[2, 2]])


def _data_var(fluid, level, shape=(2,), dtype="float32"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=list(shape), dtype=dtype,
                              lod_level=level)
    return main, x


@pytest.mark.parametrize("level", [1, 2, 3])
def test_data_feeder_builds_the_references_lod_tensor(level):
    rng = np.random.RandomState(10 + level)
    samples = [(_nested(rng, level),) for _ in range(3)]
    out = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main, x = _data_var(fluid, level)
        out[name] = fluid.DataFeeder([x], program=main).feed(samples)["x"]
    assert isinstance(out["port"], TLoD)
    assert out["port"].lod == out["jax"].lod
    np.testing.assert_array_equal(out["port"].data,
                                  np.asarray(out["jax"].data))
    assert out["port"].data.dtype == np.float32


def _pool_programs(fluid, level):
    """sequence_pool at every level of a level-k feed (each pool eats
    the finest level), then a sum: fetched are every pool output."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[2], dtype="float32",
                              lod_level=level)
        outs, h = [], x
        for ptype in ("sum", "max", "average")[:level]:
            h = fluid.layers.sequence_pool(h, ptype)
            outs.append(h)
    return main, outs


@pytest.mark.parametrize("level", [1, 2, 3])
def test_run_takes_lod_feeds_at_every_level(level):
    rng = np.random.RandomState(20 + level)
    data, lod = _lod_of([_nested(rng, level) for _ in range(3)], level)
    j, t = _pair(data, lod)
    jmain, jouts = _pool_programs(jfluid, level)
    tmain, touts = _pool_programs(tfluid, level)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    want = jfluid.Executor(jfluid.CPUPlace()).run(
        jmain, feed={"x": j}, fetch_list=jouts, scope=JScope())
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={"x": t}, fetch_list=touts, scope=tfluid.Scope())
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6)


def _seq_model(fluid):
    """test_prepared_executor.py's seq_model: embedding, sum pool, fc,
    SGD."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data(name="ids", shape=[1], dtype="int64",
                                lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="float32")
        emb = fluid.layers.embedding(ids, size=[30, 6])
        pooled = fluid.layers.sequence_pool(emb, pool_type="sum")
        pred = fluid.layers.fc(pooled, size=1)
        loss = fluid.layers.mean(
            fluid.layers.square_error_cost(pred, label))
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return main, startup, loss


def _seq_feeds(n, max_len=6, seed=0):
    rng = np.random.RandomState(seed)
    feeds = []
    for i in range(n):
        lens = [int(rng.randint(1, max_len + 1)) for _ in range(3)]
        lens[0] = max_len if i % 2 else lens[0]
        offs = np.cumsum([0] + lens).tolist()
        flat = rng.randint(0, 30, size=(offs[-1], 1)).astype(np.int64)
        feeds.append({"ids": TLoD(flat, [offs]),
                      "label": rng.randn(3, 1).astype(np.float32)})
    return feeds


def _persist(main):
    return sorted(n for n, v in main.desc.blocks[0].vars.items()
                  if v.persistable)


def test_prepared_lod_feed_parity():
    """Mirrors tests/test_prepared_executor.py::test_prepared_lod_feed_
    parity: the prepared step on ragged feeds (padded T 8 and 16, a
    new bucket taken on the way) gives run()'s losses and persistables
    bit for bit, and the reference's losses at rtol 1e-5."""
    main, startup, loss = _seq_model(tfluid)
    feeds = _seq_feeds(6, max_len=6) + _seq_feeds(2, max_len=12, seed=1)
    exe = tfluid.Executor(tfluid.CPUPlace())
    start = tfluid.Scope()
    exe.run(startup, scope=start)
    init = get_scope_arrays(start, _persist(main))
    sa, sb = tfluid.Scope(), tfluid.Scope()
    set_scope_arrays(sa, init, "cpu")
    set_scope_arrays(sb, init, "cpu")
    la = [exe.run(main, feed=f, fetch_list=[loss], scope=sa)[0]
          for f in feeds]
    with exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                     scope=sb) as prep:
        lb = [prep.run_prepared(f, return_numpy=True)[0] for f in feeds]
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    pa = get_scope_arrays(sa, _persist(main))
    pb = get_scope_arrays(sb, _persist(main))
    for n in pa:
        np.testing.assert_array_equal(pa[n], pb[n])
    assert not any("@LEN" in n for n in sa._vars)
    # the reference, from the same start
    jmain, jstart, jloss = _seq_model(jfluid)
    js = JScope()
    for n, v in init.items():
        js.set(n, v)
    jexe = jfluid.Executor(jfluid.CPUPlace())
    want = [jexe.run(jmain, feed={k: JLoD(np.asarray(v.data), v.lod)
                                  if isinstance(v, TLoD) else v
                                  for k, v in f.items()},
                     fetch_list=[jloss], scope=js)[0] for f in feeds]
    np.testing.assert_allclose(np.ravel(la), np.ravel(want), rtol=1e-5)


def test_prepared_names_only_takes_the_lengths():
    """A prepared step given feed names alone adds the '@LEN' of each
    ragged one (its var's lod_level)."""
    main, startup, loss = _seq_model(tfluid)
    feeds = _seq_feeds(2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    sa, sb = tfluid.Scope(), tfluid.Scope()
    exe.run(startup, scope=sa)
    set_scope_arrays(sb, get_scope_arrays(sa, _persist(main)), "cpu")
    prep = exe.prepare(main, feed_specs=["ids", "label"], fetch_list=[loss],
                       scope=sb)
    assert prep._prep._feed_names == {"ids", "ids@LEN", "label"}
    for f in feeds:
        np.testing.assert_array_equal(
            prep.run_prepared(f, return_numpy=True)[0],
            exe.run(main, feed=f, fetch_list=[loss], scope=sa)[0])


def test_a_dense_feed_of_another_shape_still_raises():
    """A ragged feed's new padded shape is a new bucket; a dense feed
    (label) of another batch still raises PreparedShapeMismatch."""
    main, startup, loss = _seq_model(tfluid)
    feeds = _seq_feeds(2, max_len=6) + _seq_feeds(1, max_len=12, seed=2)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                       scope=scope)
    for f in feeds:
        prep.run_prepared(f)
    bad = dict(feeds[0], label=np.zeros((4, 1), np.float32))
    with pytest.raises(PreparedShapeMismatch, match="label"):
        prep.run_prepared(bad)


def test_lengths_never_become_variables(tmp_path):
    """'@LEN' stays out of the scope and of a checkpoint; a fetch of a
    length the run made is those lengths (int32), of one it did not
    make None; with return_numpy=False a ragged fetch is the padded
    tensor, as the reference's is its padded device array."""
    main, startup, loss = _seq_model(tfluid)
    f = _seq_feeds(1)[0]
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    emb = next(op.output("Out")[0] for op in main.desc.blocks[0].ops
               if op.type == "lookup_table")
    lens, absent, padded = exe.run(
        main, feed=f, fetch_list=["ids@LEN", "label@LEN", emb],
        scope=scope, return_numpy=False)
    assert lens.dtype == torch.int32
    assert lens.tolist() == f["ids"].sequence_lengths()
    assert absent is None
    assert isinstance(padded, torch.Tensor) and padded.shape[:2] == (3, 8)
    assert not any("@LEN" in n for n in scope._vars)
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(exe, str(tmp_path), main_program=main)
    import os
    assert not any("LEN" in n for n in os.listdir(tmp_path))


def test_int64_guard_reads_a_lod_tensor():
    """The int64 feed guard reads a LoDTensor's data (padded first): a
    value past the int32 range raises, as the reference's does."""
    main, startup, loss = _seq_model(tfluid)
    f = _seq_feeds(1)[0]
    data = np.asarray(f["ids"].data).copy()
    data[0, 0] = 2 ** 33
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    with pytest.raises(ValueError, match="int32 range"):
        exe.run(main, feed=dict(f, ids=TLoD(data, f["ids"].lod)),
                fetch_list=[loss], scope=scope)


def _masked_program(fluid):
    """A ragged fc output through mean, cross_entropy and
    softmax_with_cross_entropy, each of which skips the padding."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], lod_level=1,
                              dtype="float32")
        x.stop_gradient = False
        lab = fluid.layers.data(name="lab", shape=[1], lod_level=1,
                                dtype="int64")
        y = fluid.layers.fc(x, size=3)
        ce = fluid.layers.cross_entropy(fluid.layers.softmax(y), lab)
        sce = fluid.layers.softmax_with_cross_entropy(y, lab)
        loss = fluid.layers.elementwise_add(
            fluid.layers.mean(y), fluid.layers.elementwise_add(
                fluid.layers.mean(ce), fluid.layers.mean(sce)))
        fluid.backward.append_backward(loss)
    return main, startup, [loss.name, ce.name, sce.name, "x@GRAD",
                           "fc_0.w_0@GRAD"]


def test_ragged_mean_and_losses_skip_the_padding():
    """mean averages over the valid tokens and the per-token losses are
    0 at padded positions, as in the reference (its mean is seq-aware,
    its losses ``_mask_padded``): values and gradients at rtol 1e-5."""
    jmain, jstart, names = _masked_program(jfluid)
    tmain, _, _ = _masked_program(tfluid)
    rng = np.random.RandomState(5)
    offs = [0, 2, 7, 8]
    data = rng.randn(8, 4).astype(np.float32)
    lab = rng.randint(0, 3, (8, 1)).astype(np.int64)
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    init = {n: np.asarray(js.find_var(n))
            for n, v in jmain.desc.blocks[0].vars.items() if v.persistable}
    want = jexe.run(jmain, feed={"x": JLoD(data, [offs]),
                                 "lab": JLoD(lab, [offs])},
                    fetch_list=names, scope=js)
    ts = tfluid.Scope()
    set_scope_arrays(ts, init, "cpu")
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed={"x": TLoD(data, [offs]), "lab": TLoD(lab, [offs])},
        fetch_list=names, scope=ts)
    for n, a, b in zip(names, got, want):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-5, atol=1e-6,
                                   err_msg=n)
    assert (got[1][0, 2:] == 0).all() and (got[2][2, 1:] == 0).all()
