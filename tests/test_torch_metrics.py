"""The port's metric ops (``ops/metric.py``: ``auc``,
``precision_recall``), ``layers.auc`` and the metric front end
(``fluid/metrics.py``, ``evaluator.py``, ``average.py``) against the
JAX package, on the CPU:

- ``auc`` and ``precision_recall`` replay their ``SPECS`` entries at
  the spec's tolerance, and variants (no weights, no states, states
  carried in, every prediction on one class);
- ``layers.auc`` builds the reference's desc, and its int64 statistics
  stream over batches: the counts equal, the AUC at the spec's
  tolerance, batch by batch;
- the evaluator and average cases of ``tests/test_fluid_parity_modules.py``
  (``:15``, ``:65``, ``:116``) run on the port, and against the
  reference's results on the same batches;
- every class of ``fluid/metrics.py`` against the reference's on the
  same inputs; the copies import neither jax nor paddle_tpu.
"""
import warnings

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from test_torch_ops import optest, replay_spec

S = optest.SPECS


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("op", ["auc", "precision_recall"])
def test_op_replays_its_spec(op):
    replay_spec(op)


_rng = np.random.RandomState(13)
_PR = S["precision_recall"]["inputs"]
VARIANTS = {
    "precision_recall_unweighted": ("precision_recall", dict(
        S["precision_recall"], inputs={k: v for k, v in _PR.items()
                                       if k != "Weights"})),
    "precision_recall_no_states": ("precision_recall", dict(
        S["precision_recall"], inputs={k: v for k, v in _PR.items()
                                       if k != "StatesInfo"})),
    "precision_recall_states_in": ("precision_recall", dict(
        S["precision_recall"], inputs=dict(
            _PR, StatesInfo=_rng.randint(0, 5, (3, 4)).astype(
                np.float32)))),
    "precision_recall_one_class": ("precision_recall", dict(
        S["precision_recall"], inputs=dict(
            _PR, Indices=np.zeros((6, 1), np.int64)))),
    "precision_recall_duplicates": ("precision_recall", dict(
        S["precision_recall"], inputs={
            "MaxProbs": _rng.uniform(0, 1, (40, 1)).astype(np.float32),
            "Indices": _rng.randint(0, 4, (40, 1)).astype(np.int64),
            "Labels": _rng.randint(0, 4, (40, 1)).astype(np.int64),
            "Weights": _rng.uniform(0.1, 2, (40, 1)).astype(np.float32)},
        attrs={"class_number": 4})),
    "auc_counts_in": ("auc", dict(S["auc"], inputs=dict(
        S["auc"]["inputs"],
        TP=_rng.randint(0, 9, 200).astype(np.int64),
        FP=_rng.randint(0, 9, 200).astype(np.int64),
        TN=_rng.randint(0, 9, 200).astype(np.int64),
        FN=_rng.randint(0, 9, 200).astype(np.int64)))),
    "auc_20_thresholds": ("auc", dict(S["auc"], inputs=dict(
        S["auc"]["inputs"], TP=np.zeros(20, np.int64),
        FP=np.zeros(20, np.int64), TN=np.zeros(20, np.int64),
        FN=np.zeros(20, np.int64)), attrs={"num_thresholds": 20})),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_op_variant_replays(case):
    replay_spec(*VARIANTS[case])


# ---------------------------------------------------------- layers.auc

def test_layers_auc_streams_as_the_reference():
    """layers.auc over a softmax: the same desc bytes, the int64
    statistics persistable and carried from batch to batch, the counts
    equal to the reference's and the AUC within 1e-6, over 4 batches."""
    rng = np.random.RandomState(1)
    batches = [(rng.randn(16, 2).astype(np.float32),
                rng.randint(0, 2, (16, 1)).astype(np.int64))
               for _ in range(4)]
    descs, results = [], []
    for fluid, scope in ((jfluid, JScope()), (tfluid, tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[2], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            auc = fluid.layers.auc(fluid.layers.softmax(x), y,
                                   num_thresholds=50)
        descs.append(main.desc.serialize_to_string())
        stats = sorted(v.name for v in main.list_vars()
                       if v.persistable and v.name.startswith("auc_"))
        assert len(stats) == 4
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        res = []
        for xv, yv in batches:
            vals = exe.run(main, feed={"x": xv, "y": yv},
                           fetch_list=[auc] + stats, scope=scope)
            res.append([np.asarray(v) for v in vals])
        if fluid is tfluid:
            assert all(scope.find_var(n).dtype == torch.int64
                       for n in stats)
        results.append(res)
    assert descs[0] == descs[1]
    for ref, got in zip(*results):
        np.testing.assert_allclose(got[0], ref[0], rtol=1e-6, atol=1e-6)
        for a, b in zip(ref[1:], got[1:]):
            np.testing.assert_array_equal(a.astype(np.int64), b)
    # the counts accumulated: every threshold saw all 64 rows
    tp, fp, tn, fn = results[1][-1][1:]
    np.testing.assert_array_equal(tp + fp + tn + fn, np.full(50, 64))


# ------------------------------------- tests/test_fluid_parity_modules.py

def test_weighted_average():
    """test_fluid_parity_modules.py:15 on the port."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        avg = tfluid.average.WeightedAverage()
    avg.add(value=2.0, weight=1)
    avg.add(value=4.0, weight=3)
    assert abs(avg.eval() - 3.5) < 1e-9
    avg.reset()
    with pytest.raises(ValueError):
        avg.eval()
    with pytest.raises(ValueError):
        avg.add(value="x", weight=1)


def _chunk_batches():
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(3):
        batch = []
        for _ in range(4):
            n = int(rng.randint(3, 8))
            batch.append((rng.randint(0, 5, n).tolist(),
                          rng.randint(0, 5, n).tolist()))
        batches.append(batch)
    return batches


def _chunk_evaluator_run(fluid, scope):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.scope_guard(scope), fluid.program_guard(main, startup), \
            fluid.unique_name.guard():
        pred = fluid.layers.data(name="pred", shape=[1], dtype="int64",
                                 lod_level=1)
        label = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                  lod_level=1)
        ev = fluid.evaluator.ChunkEvaluator(input=pred, label=label,
                                            chunk_scheme="IOB",
                                            num_chunk_types=2)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        ev.reset(exe)
        feeder = fluid.DataFeeder([pred, label], program=main)
        batches = _chunk_batches()
        for batch in batches:
            exe.run(main, feed=feeder.feed(batch), fetch_list=[])
        got = ev.eval(exe)

        main2 = fluid.Program()
        with fluid.program_guard(main2):
            p2 = fluid.layers.data(name="pred", shape=[1], dtype="int64",
                                   lod_level=1)
            l2 = fluid.layers.data(name="label", shape=[1], dtype="int64",
                                   lod_level=1)
            _, _, _, ni, nl, nc = fluid.layers.chunk_eval(
                input=p2, label=l2, chunk_scheme="IOB", num_chunk_types=2)
        tot = np.zeros(3)
        feeder2 = fluid.DataFeeder([p2, l2], program=main2)
        for batch in batches:
            vals = exe.run(main2, feed=feeder2.feed(batch),
                           fetch_list=[ni, nl, nc])
            tot += [float(np.asarray(v).ravel()[0]) for v in vals]
    return got, tot


def test_chunk_evaluator_streaming():
    """test_fluid_parity_modules.py:65 on the port: the states accumulate
    across runs, the precision and recall those of the op's own batch
    counts; and the port's three numbers are the reference's."""
    (precision, recall, f1), tot = _chunk_evaluator_run(tfluid,
                                                        tfluid.Scope())
    assert 0.0 <= float(precision[0]) <= 1.0
    assert 0.0 <= float(f1[0]) <= 1.0
    want_p = tot[2] / tot[0] if tot[0] else 0.0
    want_r = tot[2] / tot[1] if tot[1] else 0.0
    assert abs(float(precision[0]) - want_p) < 1e-6
    assert abs(float(recall[0]) - want_r) < 1e-6
    ref, ref_tot = _chunk_evaluator_run(jfluid, JScope())
    np.testing.assert_array_equal(tot, ref_tot)
    for a, b in zip(ref, (precision, recall, f1)):
        np.testing.assert_array_equal(a, b)


def _edit_distance_run(fluid, scope):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.scope_guard(scope), fluid.program_guard(main, startup), \
            fluid.unique_name.guard():
        hyp = fluid.layers.data(name="hyp", shape=[1], dtype="int64",
                                lod_level=1)
        ref = fluid.layers.data(name="ref", shape=[1], dtype="int64",
                                lod_level=1)
        ev = fluid.evaluator.EditDistance(input=hyp, label=ref)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        ev.reset(exe)
        feeder = fluid.DataFeeder([hyp, ref], program=main)
        exe.run(main, feed=feeder.feed([([1, 2], [1, 2]),
                                        ([1, 2, 3], [1, 9, 3])]),
                fetch_list=[])
        exe.run(main, feed=feeder.feed([([4], [5, 6]),
                                        ([7, 7], [7, 7])]),
                fetch_list=[])
        return ev.eval(exe)


def test_edit_distance_evaluator():
    """test_fluid_parity_modules.py:116 on the port (its batch, then a
    second one accumulated), and the reference's numbers."""
    dist, err = _edit_distance_run(tfluid, tfluid.Scope())
    # 4 sequences, 2 of them wrong
    assert abs(float(err[0]) - 0.5) < 1e-6
    assert float(dist[0]) > 0.0
    rdist, rerr = _edit_distance_run(jfluid, JScope())
    np.testing.assert_array_equal(dist, rdist)
    np.testing.assert_array_equal(err, rerr)


# --------------------------------------------------------- fluid.metrics

def _updates(rng):
    preds = rng.uniform(0, 1, (32, 2)).astype(np.float32)
    labels = rng.randint(0, 2, (32, 1)).astype(np.int64)
    return preds, labels


def _exercise(metrics):
    """The same calls into each class of a package's ``fluid.metrics``;
    returns what each eval() gave, after 3 updates and after a reset
    and 1 more."""
    rng = np.random.RandomState(3)
    out = {}
    for name in ("Precision", "Recall", "Auc"):
        m = getattr(metrics, name)()
        vals = []
        for _ in range(3):
            p, lab = _updates(rng)
            m.update(p[:, 1] if name != "Auc" else p, lab)
        vals.append(m.eval())
        m.reset()
        p, lab = _updates(rng)
        m.update(p[:, 1] if name != "Auc" else p, lab)
        vals.append(m.eval())
        out[name] = vals
    acc = metrics.Accuracy()
    for v, w in ((0.5, 8), (0.75, 4), (np.asarray([0.25]), 2)):
        acc.update(v, w)
    out["Accuracy"] = [acc.eval()]
    ch = metrics.ChunkEvaluator()
    ch.update(np.asarray([5]), np.asarray([6]), np.asarray([3]))
    ch.update(3, 2, 2)
    out["ChunkEvaluator"] = [ch.eval()]
    ed = metrics.EditDistance()
    ed.update(np.asarray([[0.0], [2.0], [1.0]]), 3)
    ed.update(np.asarray([0.0, 0.0]), 2)
    out["EditDistance"] = [ed.eval()]
    comp = metrics.CompositeMetric()
    comp.add_metric(metrics.Precision())
    comp.add_metric(metrics.Recall())
    p, lab = _updates(rng)
    comp.update(p[:, 0], lab)
    out["CompositeMetric"] = [comp.eval()]
    return out


def test_metric_classes_are_the_references():
    from paddle_tpu.fluid import metrics as jmetrics
    from paddle_tpu_torch.fluid import metrics as tmetrics

    assert tmetrics.__all__ == jmetrics.__all__
    ref, got = _exercise(jmetrics), _exercise(tmetrics)
    assert got == ref
    with pytest.raises(ValueError):
        tmetrics.Accuracy().eval()


def test_front_end_modules_are_exported():
    """fluid.metrics / evaluator / average beside the reference's, with
    the same public names."""
    for mod in ("metrics", "evaluator", "average"):
        t, j = getattr(tfluid, mod), getattr(jfluid, mod)
        assert t.__all__ == j.__all__, mod
        assert mod in tfluid.__all__
        for name in t.__all__:
            assert getattr(t, name).__module__.startswith(
                "paddle_tpu_torch."), (mod, name)
