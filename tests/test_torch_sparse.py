"""SelectedRows gradients and the sparse optimizer updates of the port
against the JAX package, on the CPU.

- ``sgd`` replays its ``SPECS`` entry; ``lookup_table`` /
  ``lookup_table_grad`` with ``is_sparse`` give the reference's
  SelectedRows (rows, values and height; duplicates kept);
- ``merge_rows`` keeps its static length K and merges as the
  reference's does, the inactive slots at row == height; ``scale`` and
  ``sum`` of SelectedRows stay sparse, a mixed ``sum`` densifies;
- embedding programs with ``is_sparse=True`` and duplicate ids (two
  lookups of one table, so the backward sums two SelectedRows) train 3
  steps under sgd, momentum and adam (its lazy row-subset update) from
  the reference's startup values, and hold its losses and parameters
  to 1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import selected_rows as jsr
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.core import selected_rows as tsr
from paddle_tpu_torch.core.lowering import Ins, LoweringContext
from paddle_tpu_torch.core.registry import get_op_info
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from test_torch_ops import optest, replay_spec, run_in_port

TOL = dict(rtol=1e-6, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("op", ["sgd", "lookup_table"])
def test_op_replays_its_spec(op):
    replay_spec(op)


def _dense(sr):
    """A fetched SelectedRows (either package's) as its dense table
    (slots past the height dropped)."""
    sr = sr.item() if isinstance(sr, np.ndarray) else sr
    out = np.zeros((sr.height,) + tuple(np.shape(sr.values)[1:]),
                   np.float64)
    rows, vals = np.asarray(sr.rows), np.asarray(sr.values)
    keep = rows < sr.height
    np.add.at(out, rows[keep], vals[keep])
    return out


def test_sparse_lookup_table_grad_is_the_references_selected_rows():
    s = optest.SPECS["lookup_table_grad"]
    t = optest._make_optest("lookup_table_grad", s)
    t.attrs = dict(s["attrs"], is_sparse=True)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)["W@GRAD"]
    ref = ref.item()
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)["W@GRAD"]
    assert isinstance(got, tsr.SelectedRows)
    assert got.height == ref.height == 10
    np.testing.assert_array_equal(got.rows, np.asarray(ref.rows))
    np.testing.assert_array_equal(got.values, np.asarray(ref.values))
    np.testing.assert_allclose(_dense(got), _dense(ref), **TOL)


def _rows_values(seed, k=12, height=9, width=3):
    rng = np.random.RandomState(seed)
    rows = rng.randint(0, height, k).astype(np.int64)
    rows[:3] = rows[3]          # duplicates, whatever the draw
    return rows, rng.randn(k, width).astype(np.float32), height


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_rows_matches_the_reference(seed):
    rows, vals, height = _rows_values(seed)
    ref = jsr.merge_rows(jsr.SelectedRows(jnp.asarray(rows, jnp.int32),
                                          jnp.asarray(vals), height))
    got = tsr.merge_rows(tsr.SelectedRows(torch.from_numpy(rows),
                                          torch.from_numpy(vals), height))
    assert got.rows.shape == (len(rows),)      # the static length K
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(ref.rows))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values),
                               **TOL)
    n = len(np.unique(rows))
    assert (got.rows.numpy()[n:] == height).all()
    np.testing.assert_array_equal(got.values.numpy()[n:], 0.0)
    # a merged gradient scatters back to the same dense table, the
    # inactive slots dropped
    table = torch.zeros(height, vals.shape[1])
    out = tsr.scatter_set(table, got, got.values)
    np.testing.assert_allclose(out.numpy(), _dense(got), **TOL)


def _lower(op_type, ins, attrs):
    ctx = LoweringContext(_DummyProgram(), 0, {}, torch.device("cpu"))
    return get_op_info(op_type).lower(ctx, Ins(ins), attrs, None)


class _DummyProgram:
    blocks = [None]


@pytest.mark.parametrize("how", ["scale", "sum_sparse", "sum_mixed"])
def test_scale_and_sum_of_selected_rows(how):
    """``scale`` and an all-sparse ``sum`` stay SelectedRows (its rows
    concatenated), a sum with a dense term densifies: as the
    reference's lowerings."""
    from paddle_tpu.core.registry import get_op_info as jget

    parts = [_rows_values(s) for s in (3, 4)]
    tparts = [tsr.SelectedRows(torch.from_numpy(r), torch.from_numpy(v), h)
              for r, v, h in parts]
    jparts = [jsr.SelectedRows(jnp.asarray(r, jnp.int32), jnp.asarray(v), h)
              for r, v, h in parts]
    dense = np.random.RandomState(5).randn(9, 3).astype(np.float32)
    if how == "scale":
        attrs = {"scale": 0.25, "bias": 0.0}
        t_ins, j_ins = {"X": tparts[:1]}, {"X": jparts[:1]}
    elif how == "sum_sparse":
        attrs = {}
        t_ins, j_ins = {"X": tparts}, {"X": jparts}
    else:
        attrs = {}
        t_ins = {"X": tparts + [torch.from_numpy(dense)]}
        j_ins = {"X": jparts + [jnp.asarray(dense)]}
    op_type = "scale" if how == "scale" else "sum"
    got = _lower(op_type, t_ins, attrs)["Out"]
    from paddle_tpu.core import lowering as jlow
    jctx = jlow.LoweringContext(_DummyProgram(), 0, {}, None)
    want = jget(op_type).lower(jctx, jlow.Ins(j_ins), attrs, None)["Out"]
    if how == "sum_mixed":
        assert isinstance(got, torch.Tensor)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        return
    assert isinstance(got, tsr.SelectedRows)
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               **TOL)
    assert got.height == want.height


VOCAB, DIM, BATCH, SEQ = 40, 8, 4, 6


def _embedding_program(fluid, optimizer):
    """Two lookups of one sparse table (its gradient a sum of two
    SelectedRows), an fc, softmax cross-entropy, ``optimizer``."""
    ids = fluid.layers.data(name="ids", shape=[SEQ, 1], dtype="int64")
    ids2 = fluid.layers.data(name="ids2", shape=[SEQ, 1], dtype="int64")
    label = fluid.layers.data(name="label", shape=[1], dtype="int64")
    attr = fluid.ParamAttr(name="emb_w")
    e1 = fluid.layers.embedding(ids, size=[VOCAB, DIM], is_sparse=True,
                                param_attr=attr)
    e2 = fluid.layers.embedding(ids2, size=[VOCAB, DIM], is_sparse=True,
                                param_attr=attr)
    h = fluid.layers.elementwise_add(e1, e2)
    logits = fluid.layers.fc(h, size=5, num_flatten_dims=1)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, label))
    opt = {"sgd": lambda: fluid.optimizer.SGD(learning_rate=0.5),
           "momentum": lambda: fluid.optimizer.Momentum(
               learning_rate=0.5, momentum=0.9),
           "adam": lambda: fluid.optimizer.Adam(learning_rate=0.05),
           "adagrad": lambda: fluid.optimizer.Adagrad(learning_rate=0.05)}
    opt[optimizer]().minimize(loss)
    return loss


def _embedding_feeds(n):
    rng = np.random.RandomState(7)
    out = []
    for _ in range(n):
        ids = rng.randint(0, VOCAB // 4, (BATCH, SEQ, 1)).astype(np.int64)
        ids[:, 0] = ids[0, 1]           # duplicate ids in every batch
        out.append({"ids": ids,
                    "ids2": rng.randint(0, VOCAB, (BATCH, SEQ, 1))
                    .astype(np.int64),
                    "label": rng.randint(0, 5, (BATCH, 1)).astype(np.int64)})
    return out


def _train_both(optimizer, sparse, feeds):
    """3 steps in both packages from the reference's startup values:
    {False: (reference losses, persistables), True: the port's}, and
    the startup values."""
    runs, init = {}, None
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = _embedding_program(fluid, optimizer)
        ops = [op.type for op in main.desc.blocks[0].ops]
        assert "lookup_table_grad" in ops and "sum" in ops, ops
        if not sparse:
            for op in main.desc.blocks[0].ops:
                if op.type.startswith("lookup_table"):
                    op.set_attr("is_sparse", False)
        exe = fluid.Executor(fluid.CPUPlace())
        persist = sorted(v.name for v in main.list_vars() if v.persistable)
        if fluid is jfluid:
            scope = JScope()
            exe.run(startup, scope=scope)
            init = {n: np.array(scope.find_var(n)) for n in persist}
        else:
            scope = tfluid.Scope()
            set_scope_arrays(scope, init, "cpu")
        losses = [float(np.ravel(exe.run(main, feed=f, fetch_list=[loss],
                                         scope=scope)[0])[0])
                  for f in feeds]
        vals = ({n: np.array(scope.find_var(n)) for n in persist}
                if fluid is jfluid else get_scope_arrays(scope, persist))
        runs[fluid is tfluid] = losses, vals
    return runs, init


@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam",
                                       "adagrad"])
def test_sparse_embedding_trains_as_the_reference(optimizer):
    """Losses and parameters within 1e-6 (rtol and atol) of the
    reference's.  Adam's step is lr * m / sqrt(v), about lr whatever
    the gradient's size, so it carries the two packages' float rounding
    of a near-zero gradient into the parameters at lr times its
    relative size; so does Adagrad's, lr * g / sqrt(m), whose first
    step is about lr as well: there the bar is the larger of 1e-6 and
    the same program's gap with dense gradients (is_sparse off in both
    packages), measured here."""
    feeds = _embedding_feeds(3)
    runs, init = _train_both(optimizer, True, feeds)
    (jl, jv), (tl, tv) = runs[False], runs[True]
    np.testing.assert_allclose(tl, jl, **TOL)
    tol = dict(TOL)
    if optimizer in ("adam", "adagrad"):
        dense, _ = _train_both(optimizer, False, feeds)
        gap = max(float(np.abs(dense[True][1][n] - dense[False][1][n]).max())
                  for n in jv)
        tol["atol"] = max(TOL["atol"], gap)
    for n in jv:
        np.testing.assert_allclose(tv[n], jv[n], err_msg=n, **tol)
    # only the looked-up rows of the table moved under sgd and adam
    touched = np.unique(np.concatenate(
        [np.concatenate([f["ids"].ravel(), f["ids2"].ravel()])
         for f in feeds]))
    untouched = np.setdiff1d(np.arange(VOCAB), touched)
    if optimizer != "momentum" and untouched.size:
        np.testing.assert_array_equal(tv["emb_w"][untouched],
                                      init["emb_w"][untouched])
