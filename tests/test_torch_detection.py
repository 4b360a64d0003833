"""The port's detection ops (``ops/detection.py``), their layers
(``fluid/layers/detection.py``) and MobileNet-SSD against the JAX
package, on the CPU:

- each op with a ``SPECS`` entry replays it at the spec's tolerance,
  and variants (plain bipartite matching, tied distances, encoding,
  no variances, steps and no flip, tied and sampled mining, negatives
  in target_assign, a batched IoU);
- ``tests/test_detection.py``'s cases, each run in both packages: the
  hand-computed values, and the host ops (``multiclass_nms``,
  ``detection_map``) bit for bit with the reference's on the same
  inputs; ``mine_hard_examples`` on tied losses ranks as the reference;
- the SSD head + loss program of ``test_detection.py:159`` and
  MobileNet-SSD at a narrow width (64 x 64 images, width scale 0.25,
  ``chip_smoke.build_mobilenet_ssd``): byte-identical ProgramDescs, and
  3 Adam steps from the reference's startup values (the small SSD
  free running, 15 steps), each of MobileNet-SSD's step losses within
  rtol 1e-4 of the reference's from the reference's state before it
  (free running the two packages part at the third step: see
  ``test_mobilenet_ssd_steps_as_the_reference``);
- the prepared step over two ragged gt buckets, bit for bit with
  ``run()``, each ``prior_box`` a constant made once at ``prepare()``;
- ``fluid.layers`` exports every name of the reference's.
"""
import importlib.util
import os

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
OPS = ["prior_box", "iou_similarity", "box_coder", "bipartite_match",
       "target_assign", "mine_hard_examples", "gather_encoded_target"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "chip_smoke", os.path.join(REPO, "chip_smoke.py"))
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("op", OPS)
def test_op_replays_its_spec(op):
    replay_spec(op)


_rng = np.random.RandomState(17)


def _boxes(n, lo=0.0, hi=1.0):
    c = np.sort(_rng.uniform(lo, hi, (n, 2, 2)), axis=1)
    return c.transpose(0, 2, 1).reshape(n, 4)[:, [0, 1, 2, 3]].astype(
        np.float32)


_TIED_DIST = np.asarray([[[0.5, 0.5, 0.2, 0.5], [0.5, 0.5, 0.5, 0.1],
                          [0.3, 0.5, 0.5, 0.5]]], np.float32)
VARIANTS = {
    "bipartite_match_bipartite": ("bipartite_match", dict(
        S["bipartite_match"], attrs={"match_type": "bipartite",
                                     "dist_threshold": 0.5})),
    "bipartite_match_ties": ("bipartite_match", dict(
        S["bipartite_match"], inputs={"DistMat": _TIED_DIST})),
    "bipartite_match_2d": ("bipartite_match", dict(
        S["bipartite_match"], inputs={
            "DistMat": _rng.uniform(0, 1, (4, 9)).astype(np.float32)})),
    "box_coder_encode": ("box_coder", dict(S["box_coder"], inputs={
        "PriorBox": _boxes(5), "PriorBoxVar": np.full((5, 4), 0.1,
                                                      np.float32),
        "TargetBox": np.stack([_boxes(3), _boxes(3)])},
        attrs={"code_type": "encode_center_size"})),
    "box_coder_no_variance": ("box_coder", dict(S["box_coder"], inputs={
        k: v for k, v in S["box_coder"]["inputs"].items()
        if k != "PriorBoxVar"})),
    "prior_box_steps_no_flip": ("prior_box", dict(S["prior_box"], attrs=dict(
        S["prior_box"]["attrs"], flip=False, clip=False, step_w=6.0,
        step_h=7.0, offset=0.25, aspect_ratios=[2.0, 3.0],
        min_sizes=[4.0, 9.0], max_sizes=[8.0, 12.0]))),
    "prior_box_no_max": ("prior_box", dict(S["prior_box"], inputs={
        "Input": np.zeros((1, 3, 3, 5), np.float32),
        "Image": np.zeros((1, 3, 30, 50), np.float32)},
        attrs=dict(S["prior_box"]["attrs"], max_sizes=[],
                   aspect_ratios=[2.0, 0.5, 3.0]))),
    "mine_hard_examples_ties": ("mine_hard_examples", dict(
        S["mine_hard_examples"], inputs=dict(
            S["mine_hard_examples"]["inputs"],
            ClsLoss=np.asarray([[1, 1, 1, 0.5, 1, 1, 1, 1],
                                [2, 2, 2, 2, 2, 2, 2, 2]], np.float32)))),
    "mine_hard_examples_sample_size": ("mine_hard_examples", dict(
        S["mine_hard_examples"], attrs=dict(
            S["mine_hard_examples"]["attrs"], neg_pos_ratio=3.0,
            sample_size=3))),
    "target_assign_negatives": ("target_assign", dict(
        S["target_assign"], inputs=dict(
            S["target_assign"]["inputs"],
            NegIndices=np.asarray([[0, 1, 0, 1], [0, 0, 1, 0]], np.int32)),
        attrs={"mismatch_value": 3})),
    "iou_similarity_batched": ("iou_similarity", dict(
        S["iou_similarity"], inputs={
            "X": np.stack([_boxes(3), _boxes(3)]), "Y": _boxes(4)})),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_op_variant_replays(case):
    replay_spec(*VARIANTS[case])


# --------------------------------------------------------------------------
# tests/test_detection.py's cases, in both packages
# --------------------------------------------------------------------------

def _both(build, feed, scope_vals=None):
    """Run ``build(fluid) -> fetch vars`` once in both packages on
    ``feed``; ``scope_vals`` set in the scope before the run.  Returns
    (the reference's fetches, the port's) as numpy."""
    out = []
    for fluid, scope in ((jfluid, JScope()), (tfluid, tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.scope_guard(scope), \
                fluid.program_guard(main, startup), \
                fluid.unique_name.guard():
            fetch = build(fluid)
            exe = fluid.Executor(fluid.CPUPlace())
            exe.run(startup)
            for n, v in (scope_vals or {}).items():
                scope.set(n, v if fluid is jfluid
                          else torch.from_numpy(v.copy()))
            f = {k: (v(JLoD if fluid is jfluid else TLoD)
                     if callable(v) else v) for k, v in feed.items()}
            out.append([np.asarray(v) for v in
                        exe.run(main, feed=f, fetch_list=fetch)])
    return out


def test_prior_box_geometry():
    def build(fluid):
        feat = fluid.layers.data(name="feat", shape=[8, 2, 2],
                                 dtype="float32")
        img = fluid.layers.data(name="img", shape=[3, 32, 32],
                                dtype="float32")
        return list(fluid.layers.detection.prior_box(
            feat, img, min_sizes=[4.0], max_sizes=[8.0],
            aspect_ratios=[2.0], flip=True, clip=True))

    ref, (b, v) = _both(build, {
        "feat": np.zeros((1, 8, 2, 2), np.float32),
        "img": np.zeros((1, 3, 32, 32), np.float32)})
    assert b.shape == (2, 2, 4, 4) and v.shape == b.shape
    np.testing.assert_allclose(
        b[0, 0, 0], [6 / 32, 6 / 32, 10 / 32, 10 / 32], rtol=1e-6)
    s = np.sqrt(32.0)
    np.testing.assert_allclose(
        b[0, 0, 3], [(8 - s / 2) / 32, (8 - s / 2) / 32,
                     (8 + s / 2) / 32, (8 + s / 2) / 32], rtol=1e-6)
    assert (b >= 0).all() and (b <= 1).all()
    np.testing.assert_allclose(v[1, 1, 2], [0.1, 0.1, 0.2, 0.2])
    # f32 in the reference's order of operations: the same bits
    np.testing.assert_array_equal(b, ref[0])
    np.testing.assert_array_equal(v, ref[1])


def test_iou_similarity_values():
    def build(fluid):
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.data(name="y", shape=[2, 4], dtype="float32",
                              append_batch_size=False)
        return [fluid.layers.detection.iou_similarity(x, y)]

    (ref,), (got,) = _both(build, {
        "x": np.asarray([[0, 0, 2, 2], [1, 1, 3, 3]], np.float32),
        "y": np.asarray([[0, 0, 2, 2], [2, 2, 4, 4]], np.float32)})
    np.testing.assert_allclose(got[0], [1.0, 0.0], atol=1e-6)
    np.testing.assert_allclose(got[1], [1 / 7, 1 / 7], rtol=1e-5)
    np.testing.assert_array_equal(got, ref)


def test_box_coder_roundtrip():
    rng = np.random.RandomState(0)
    priors = np.sort(rng.rand(3, 2, 2), axis=1).reshape(
        3, 4).astype(np.float32)
    gts = np.sort(rng.rand(2, 2, 2), axis=1).reshape(
        2, 4).astype(np.float32)
    pv = np.full((3, 4), 0.5, np.float32)

    def program(fluid):
        prior = fluid.layers.data(name="prior", shape=[3, 4],
                                  dtype="float32", append_batch_size=False)
        pvar = fluid.layers.data(name="pvar", shape=[3, 4],
                                 dtype="float32", append_batch_size=False)
        gt = fluid.layers.data(name="gt", shape=[2, 4], dtype="float32",
                               append_batch_size=False)
        enc = fluid.layers.detection.box_coder(prior, pvar, gt,
                                               "encode_center_size")
        dec_in = fluid.layers.data(name="den", shape=[2, 3, 4],
                                   dtype="float32", append_batch_size=False)
        dec = fluid.layers.detection.box_coder(prior, pvar, dec_in,
                                               "decode_center_size")
        return [enc, dec]

    feed = {"prior": priors, "pvar": pv, "gt": gts,
            "den": np.zeros((2, 3, 4), np.float32)}
    (renc, _), (enc, _) = _both(program, feed)
    _check("encoded", renc, enc, (1e-5, 1e-5))
    (_, rdec), (_, dec) = _both(program, dict(feed, den=enc))
    for g in range(2):
        for m in range(3):
            np.testing.assert_allclose(dec[g, m], gts[g], rtol=1e-4,
                                       atol=1e-5)
    _check("decoded", rdec, dec, (1e-5, 1e-5))


def test_bipartite_match_greedy():
    def build(fluid):
        dist = fluid.layers.data(name="dist", shape=[2, 3],
                                 dtype="float32")
        mi, md = fluid.layers.detection.bipartite_match(dist)
        mi2, md2 = fluid.layers.detection.bipartite_match(
            dist, match_type="per_prediction", dist_threshold=0.55)
        return [mi, md, mi2, md2]

    ref, (a, b, c, d) = _both(build, {"dist": np.asarray(
        [[[0.9, 0.8, 0.1], [0.85, 0.2, 0.6]]], np.float32)})
    np.testing.assert_array_equal(a[0], [0, -1, 1])
    np.testing.assert_allclose(b[0], [0.9, 0.0, 0.6])
    np.testing.assert_array_equal(c[0], [0, 0, 1])
    np.testing.assert_allclose(d[0], [0.9, 0.8, 0.6])
    for r, g in zip(ref, (a, b, c, d)):
        np.testing.assert_array_equal(g, r)


def _mine_program(fluid):
    cls = fluid.layers.data(name="cls", shape=[6], dtype="float32")
    mi = fluid.layers.data(name="mi", shape=[6], dtype="int32")
    helper = fluid.layer_helper.LayerHelper("mine")
    neg = helper.create_tmp_variable(dtype="int32")
    upd = helper.create_tmp_variable(dtype="int32")
    helper.append_op(type="mine_hard_examples",
                     inputs={"ClsLoss": [cls], "MatchIndices": [mi]},
                     outputs={"NegIndices": [neg],
                              "UpdatedMatchIndices": [upd]},
                     attrs={"neg_pos_ratio": 2.0})
    return [neg]


def test_mine_hard_examples():
    (ref,), (got,) = _both(_mine_program, {
        "cls": np.asarray([[5.0, 1.0, 3.0, 4.0, 2.0, 0.5]], np.float32),
        "mi": np.asarray([[0, -1, -1, -1, -1, -1]], np.int32)})
    np.testing.assert_array_equal(got[0], [0, 0, 1, 1, 0, 0])
    np.testing.assert_array_equal(got, ref)


def test_mine_hard_examples_on_tied_losses():
    """Every negative's loss equal (an untrained head gives many such
    ties): the stable ranking keeps the first n_neg in prior order, as
    the reference's jnp.argsort does."""
    (ref,), (got,) = _both(_mine_program, {
        "cls": np.asarray([[0.7] * 6, [0.7, 0.2, 0.7, 0.7, 0.2, 0.7]],
                          np.float32),
        "mi": np.asarray([[-1, 0, -1, -1, -1, -1],
                          [-1, -1, -1, -1, -1, 1]], np.int32)})
    np.testing.assert_array_equal(got[0], [1, 0, 1, 0, 0, 0])
    np.testing.assert_array_equal(got[1], [1, 0, 1, 0, 0, 0])
    np.testing.assert_array_equal(got, ref)


def test_multiclass_nms_suppression():
    def build(fluid):
        bb = fluid.layers.data(name="bb", shape=[3, 4], dtype="float32")
        sc = fluid.layers.data(name="sc", shape=[2, 3], dtype="float32")
        return [fluid.layers.detection.multiclass_nms(
            bb, sc, background_label=0, score_threshold=0.1,
            nms_threshold=0.4, keep_top_k=10)]

    (ref,), (got,) = _both(build, {
        "bb": np.asarray([[[0, 0, 1, 1], [0, 0, 1.05, 1.05],
                           [2, 2, 3, 3]]], np.float32),
        "sc": np.asarray([[[0.9, 0.8, 0.7], [0.6, 0.95, 0.5]]],
                         np.float32)})
    assert got.shape == (2, 6)
    np.testing.assert_allclose(got[0, :2], [1.0, 0.95])
    np.testing.assert_allclose(got[0, 2:], [0, 0, 1.05, 1.05])
    np.testing.assert_allclose(got[1, :2], [1.0, 0.5])
    np.testing.assert_array_equal(got, ref)


def test_multiclass_nms_random_batch_is_the_references():
    """4 images, 6 classes, 40 boxes, eta < 1 and a keep_top_k cut: the
    rows and the '@ROWS' counts bit for bit."""
    rng = np.random.RandomState(2)
    c = np.sort(rng.uniform(0, 1, (4, 40, 2, 2)), axis=2)
    boxes = c.transpose(0, 1, 3, 2).reshape(4, 40, 4).astype(np.float32)
    scores = rng.uniform(0, 1, (4, 6, 40)).astype(np.float32)

    def build(fluid):
        bb = fluid.layers.data(name="bb", shape=[40, 4], dtype="float32")
        sc = fluid.layers.data(name="sc", shape=[6, 40], dtype="float32")
        out = fluid.layers.detection.multiclass_nms(
            bb, sc, score_threshold=0.3, nms_top_k=20, nms_threshold=0.45,
            keep_top_k=25, nms_eta=0.9)
        return [out, out.name + "@ROWS"]

    ref, got = _both(build, {"bb": boxes, "sc": scores})
    # (the reference's fetch narrows the int64 counts to int32)
    assert ref[0].dtype == got[0].dtype == np.float32
    assert got[1].dtype == np.int64
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    assert got[1].sum() == got[0].shape[0] and (got[1] <= 25).all()


def _ssd_small(fluid):
    """test_detection.py:159's program: two convs, multi_box_head,
    ssd_loss, Adam."""
    layers = fluid.layers
    img = layers.data(name="img", shape=[3, 16, 16], dtype="float32")
    gt_box = layers.data(name="gt_box", shape=[2, 4], dtype="float32")
    gt_lab = layers.data(name="gt_lab", shape=[2, 1], dtype="int64")
    c1 = layers.conv2d(img, num_filters=8, filter_size=3, padding=1,
                       stride=2, act="relu")
    c2 = layers.conv2d(c1, num_filters=8, filter_size=3, padding=1,
                       stride=2, act="relu")
    locs, confs, boxes, vars_ = layers.detection.multi_box_head(
        inputs=[c1, c2], image=img, base_size=16, num_classes=3,
        aspect_ratios=[[2.0], [2.0]], min_sizes=[4.0, 8.0],
        max_sizes=[8.0, 12.0], flip=True)
    loss = layers.mean(layers.detection.ssd_loss(
        locs, confs, gt_box, gt_lab, boxes, vars_))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def _steps(build, feeds, teacher=False):
    """``build(fluid) -> loss`` in both packages; the port starts from
    the reference's startup values.  Free running (``teacher`` False):
    each package steps on its own state.  Otherwise every port step
    starts from the reference's state before that step (its parameters,
    moments and counters).  Returns (descs, reference losses, port
    losses)."""
    descs, progs = [], []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = build(fluid)
        descs.append(main.desc.serialize_to_string())
        progs.append((main, startup, loss))
    (jmain, jstart, jloss), (tmain, tstart, tloss) = progs
    jexe, texe = (jfluid.Executor(jfluid.CPUPlace()),
                  tfluid.Executor(tfluid.CPUPlace()))
    jscope, tscope = JScope(), tfluid.Scope()
    jexe.run(jstart, scope=jscope)
    texe.run(tstart, scope=tscope)
    persist = sorted(v.name for v in jmain.list_vars()
                     if v.persistable and jscope.has_var(v.name))

    def copy_state():
        for n in persist:
            tscope.set(n, torch.from_numpy(
                np.array(jscope.find_var(n), copy=True)))

    copy_state()
    ref, got = [], []
    for feed in feeds:
        if teacher:
            copy_state()
        got.append(float(np.ravel(texe.run(
            tmain, feed=feed(TLoD), fetch_list=[tloss],
            scope=tscope)[0])[0]))
        ref.append(float(np.ravel(jexe.run(
            jmain, feed=feed(JLoD), fetch_list=[jloss],
            scope=jscope)[0])[0]))
    return descs, ref, got


def test_ssd_head_and_loss_trains():
    """test_detection.py:159: the same desc bytes, the loss finite and
    falling over 15 steps, and the trajectory within rtol 1e-4 of the
    reference's from its startup values."""
    rng = np.random.RandomState(0)
    imgv = rng.rand(2, 3, 16, 16).astype(np.float32)
    gbv = np.asarray([[[0.1, 0.1, 0.4, 0.4], [0.5, 0.5, 0.9, 0.9]],
                      [[0.2, 0.3, 0.6, 0.7], [0.0, 0.0, 0.3, 0.2]]],
                     np.float32)
    glv = np.asarray([[[1], [2]], [[2], [1]]], np.int64)

    def feed(_):
        return {"img": imgv, "gt_box": gbv, "gt_lab": glv}

    descs, ref, got = _steps(_ssd_small, [feed] * 15)
    assert descs[0] == descs[1]
    assert np.isfinite(got).all() and got[-1] < got[0], (got[0], got[-1])
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_ssd_loss_default_prior_var_and_threshold_zero():
    """prior_box_var=None runs (variances 1), and dist_threshold=0.0 is
    kept."""
    rng = np.random.RandomState(0)

    def build(fluid):
        layers = fluid.layers
        loc = layers.data(name="loc", shape=[4, 4], dtype="float32")
        conf = layers.data(name="conf", shape=[4, 3], dtype="float32")
        gt_box = layers.data(name="gt_box", shape=[1, 4], dtype="float32")
        gt_lab = layers.data(name="gt_lab", shape=[1, 1], dtype="int64")
        prior = layers.data(name="prior", shape=[4, 4], dtype="float32",
                            append_batch_size=False)
        loss = layers.detection.ssd_loss(loc, conf, gt_box, gt_lab, prior)
        dist = layers.data(name="dist", shape=[1, 4], dtype="float32")
        mi0, _ = layers.detection.bipartite_match(
            dist, match_type="per_prediction", dist_threshold=0.0)
        return [loss, mi0]

    priors = np.asarray([[0.0, 0.0, 0.5, 0.5], [0.5, 0.5, 1, 1],
                         [0, 0.5, 0.5, 1], [0.5, 0, 1, 0.5]], np.float32)
    (rloss, rmi), (loss, mi) = _both(build, {
        "loc": rng.randn(1, 4, 4).astype(np.float32) * 0.1,
        "conf": rng.randn(1, 4, 3).astype(np.float32),
        "gt_box": np.asarray([[[0.1, 0.1, 0.4, 0.4]]], np.float32),
        "gt_lab": np.asarray([[[1]]], np.int64),
        "prior": priors,
        "dist": np.asarray([[[0.3, 0.2, 0.1, 0.05]]], np.float32)})
    assert np.isfinite(loss).all()
    np.testing.assert_array_equal(mi[0], [0, 0, 0, 0])
    np.testing.assert_array_equal(mi, rmi)
    np.testing.assert_allclose(loss, rloss, rtol=1e-5)


def test_detection_output_end_to_end():
    def build(fluid):
        layers = fluid.layers
        loc = layers.data(name="loc", shape=[4, 4], dtype="float32")
        sc = layers.data(name="sc", shape=[4, 3], dtype="float32")
        prior = layers.data(name="prior", shape=[4, 4], dtype="float32",
                            append_batch_size=False)
        pvar = layers.data(name="pvar", shape=[4, 4], dtype="float32",
                           append_batch_size=False)
        return [layers.detection.detection_output(loc, sc, prior, pvar)]

    priors = np.asarray([[0.1, 0.1, 0.3, 0.3], [0.4, 0.4, 0.6, 0.6],
                         [0.6, 0.6, 0.8, 0.8], [0.2, 0.2, 0.5, 0.5]],
                        np.float32)
    (ref,), (got,) = _both(build, {
        "loc": np.zeros((1, 4, 4), np.float32),
        "sc": np.asarray([[[0.1, 0.8, 0.1], [0.2, 0.2, 0.6],
                           [0.8, 0.1, 0.1], [0.7, 0.2, 0.1]]], np.float32),
        "prior": priors, "pvar": np.full((4, 4), 0.1, np.float32)})
    assert got.ndim == 2 and got.shape[1] == 6
    np.testing.assert_allclose(got[0, :2], [1.0, 0.8])
    np.testing.assert_allclose(got[0, 2:], priors[0], atol=1e-6)
    np.testing.assert_array_equal(got, ref)


def _map_program(fluid):
    det = fluid.layers.data(name="det", shape=[6], dtype="float32",
                            append_batch_size=False)
    lab = fluid.layers.data(name="lab", shape=[5], lod_level=1,
                            dtype="float32")
    return [fluid.layers.detection.detection_map(det, lab, class_num=2)]


def test_detection_map_hand_computed():
    """2 images, 2 classes, integral AP 1.0."""
    detv = np.asarray([[0, 0.9, 0.0, 0.0, 1.0, 1.0],
                       [0, 0.8, 5.0, 5.0, 6.0, 6.0],
                       [1, 0.7, 0.0, 0.0, 1.0, 1.0]], np.float32)
    (ref,), (got,) = _both(_map_program, {
        "det": detv,
        "lab": lambda lod: lod.from_sequences([
            np.asarray([[0, 0, 0, 1, 1]], np.float32),
            np.asarray([[1, 0, 0, 1, 1]], np.float32)])},
        {"det@ROWS": np.asarray([2, 1], np.int64)})
    np.testing.assert_allclose(float(np.ravel(got)[0]), 1.0)
    np.testing.assert_array_equal(got, ref)


def test_detection_map_half():
    detv = np.asarray([[1, 0.9, 5, 5, 6, 6], [1, 0.8, 0, 0, 1, 1]],
                      np.float32)
    (ref,), (got,) = _both(_map_program, {
        "det": detv,
        "lab": lambda lod: lod.from_sequences([
            np.asarray([[1, 0, 0, 1, 1], [1, 2, 2, 3, 3]], np.float32)])},
        {"det@ROWS": np.asarray([2], np.int64)})
    np.testing.assert_allclose(float(np.ravel(got)[0]), 0.25, atol=1e-6)
    np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("ap_version", ["integral", "11point"])
def test_detection_map_random_is_the_references(ap_version):
    """NMS rows of a random batch against ragged labels of 1-5 boxes an
    image, 4 classes, in one program (NMS, then mAP: two host ops in
    the postlude): the mAP bit for bit."""
    rng = np.random.RandomState(5)
    c = np.sort(rng.uniform(0, 1, (3, 30, 2, 2)), axis=2)
    boxes = c.transpose(0, 1, 3, 2).reshape(3, 30, 4).astype(np.float32)
    scores = rng.uniform(0, 1, (3, 4, 30)).astype(np.float32)
    labels = []
    for i in range(3):
        g = int(rng.randint(1, 6))
        labels.append(np.concatenate(
            [rng.randint(1, 4, (g, 1)).astype(np.float32),
             boxes[i, rng.choice(30, g, replace=False)]], 1))

    def build(fluid):
        bb = fluid.layers.data(name="bb", shape=[30, 4], dtype="float32")
        sc = fluid.layers.data(name="sc", shape=[4, 30], dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[5], lod_level=1,
                                dtype="float32")
        out = fluid.layers.detection.multiclass_nms(bb, sc,
                                                    score_threshold=0.2)
        return [out, fluid.layers.detection.detection_map(
            out, lab, class_num=4, overlap_threshold=0.3,
            ap_version=ap_version)]

    ref, got = _both(build, {"bb": boxes, "sc": scores,
                             "lab": lambda lod: lod.from_sequences(labels)})
    for a, b in zip(ref, got):
        np.testing.assert_array_equal(b, a)
    assert 0.0 < float(got[1][0]) <= 1.0


# --------------------------------------------------------------------------
# MobileNet-SSD at a narrow width
# --------------------------------------------------------------------------

NARROW = dict(image=64, scale=0.25)


def _ssd_build(fluid):
    loss, _, _ = chip_smoke.build_mobilenet_ssd(fluid, **NARROW)
    return loss


def _ssd_feeds(n, steps, seed=0, max_gt=4):
    feeds = []
    for k in range(steps):
        imgs, boxes, labels = chip_smoke.ssd_batch(
            n, image=NARROW["image"], max_gt=max_gt, seed=seed + k)
        feeds.append(lambda lod, a=(imgs, boxes, labels):
                     chip_smoke.ssd_feed(lod, *a))
    return feeds


def test_mobilenet_ssd_builds_the_reference_desc():
    """mobilenet_ssd.py's MobileNet-SSD at width 0.25 over 64 x 64
    images: the same ProgramDesc bytes in both packages, and the
    reference's prior count through multi_box_head."""
    descs = []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            chip_smoke.build_mobilenet_ssd(fluid, **NARROW)
        descs.append(main.desc.serialize_to_string())
        # maps 4, 2, 1, 1, 1, 1: 4 priors a cell on the first, 6 after
        m = [v for v in main.list_vars() if v.name.startswith("concat_")]
        assert any(tuple(v.shape) == (112, 4) for v in m), \
            [tuple(v.shape) for v in m]
    assert descs[0] == descs[1]


def test_mobilenet_ssd_steps_as_the_reference():
    """3 Adam steps on ragged batches of 2 images (1-4 gt boxes each),
    every step from the reference's state before it: each loss within
    rtol 1e-4 of the reference's (1.2e-5 at most, measured).  Free
    running, the first two steps agree within 5e-5 and the third parts
    by 4.6e-3: at 64 x 64 the extra blocks' batch norms normalize 2
    values of a 1 x 1 map, and on one repeated batch the reference's own
    third loss moves by 1.0e-3 when every filter moves by one ulp."""
    _, ref, got = _steps(_ssd_build, _ssd_feeds(2, 3), teacher=True)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, ref, rtol=1e-4)


def test_mobilenet_ssd_prepared_over_buckets_is_run_bit_for_bit():
    """The prepared step over two padded gt buckets (G 8 and 16: 1-8 and
    13 boxes an image), stepped 0, 1, 0, is ``run()`` bit for bit on
    every loss and persistable; each of the 6 prior_box ops reads the
    constant made once at ``prepare()``."""
    from paddle_tpu_torch.fluid.io import get_scope_arrays

    fluid = tfluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = _ssd_build(fluid)
    batches = []
    for k, max_gt in enumerate((8, 13)):
        imgs, boxes, labels = chip_smoke.ssd_batch(
            2, image=NARROW["image"], max_gt=max_gt, seed=40 + k)
        # the second image at the bucket's most boxes
        reps = max_gt // len(boxes[1]) + 1
        boxes[1] = np.concatenate([boxes[1]] * reps)[:max_gt]
        labels[1] = np.concatenate([labels[1]] * reps)[:max_gt]
        batches.append(chip_smoke.ssd_feed(TLoD, imgs, boxes, labels))
    order = (0, 1, 0)
    exe = fluid.Executor(fluid.CPUPlace())
    persist = sorted(v.name for v in main.list_vars() if v.persistable)
    sa, sb = fluid.Scope(), fluid.Scope()
    exe.run(startup, scope=sa)
    init = get_scope_arrays(sa, [n for n in persist if sa.has_var(n)])
    for n, v in init.items():
        sb.set(n, torch.from_numpy(v.copy()))
    la = [exe.run(main, feed=batches[i], fetch_list=[loss], scope=sa)[0]
          for i in order]
    with exe.prepare(main, feed_specs=list(batches[0]), fetch_list=[loss],
                     scope=sb) as prep:
        lb = [prep.run_prepared(batches[i], return_numpy=True)[0]
              for i in order]
        consts = prep._prep._step._constants
    assert len(consts) == 6 and all(set(c) == {"Boxes", "Variances"}
                                    for c in consts.values())
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    pa, pb = get_scope_arrays(sa, list(init)), get_scope_arrays(sb,
                                                                 list(init))
    for n in init:
        np.testing.assert_array_equal(pa[n], pb[n], err_msg=n)


def test_prior_box_constant_is_the_lowering():
    """The prepared step's constant (from the desc shapes) equals the
    op's eager output bit for bit."""
    from paddle_tpu_torch.ops.detection import (prior_box_arrays,
                                                prior_box_constant)

    attrs = dict(S["prior_box"]["attrs"], aspect_ratios=[2.0, 3.0])
    shapes = {"Input": (-1, 8, 19, 19), "Image": (-1, 3, 300, 300)}
    const = prior_box_constant(attrs, torch.device("cpu"), shapes.get)
    boxes, var = prior_box_arrays(attrs, 19, 19, 300, 300)
    assert torch.equal(const["Boxes"], boxes)
    assert torch.equal(const["Variances"], var)
    assert prior_box_constant(attrs, torch.device("cpu"), {
        "Input": (-1, 8, -1, -1), "Image": (-1, 3, 300, 300)}.get) is None


# the reader layers of the reference's fluid/layers/io.py, which waited
# for the reader ops (ROADMAP queue 1, item 11) until slice 28
READER_LAYERS = {"Preprocessor", "batch", "double_buffer", "multi_pass",
                 "open_files", "open_recordio_file", "random_data_generator",
                 "read_file", "shuffle", "threaded"}


def test_layers_export_every_reference_name():
    """fluid.layers exports every name of the reference's __all__, the
    reader layers included, detection's and io's all; each name the port
    exports is one the reference does."""
    assert tfluid.layers.detection.__all__ == \
        jfluid.layers.detection.__all__
    assert tfluid.layers.io.__all__ == jfluid.layers.io.__all__
    assert READER_LAYERS <= set(tfluid.layers.io.__all__)
    want = set(jfluid.layers.__all__)
    assert set(tfluid.layers.__all__) == want
    for name in want:
        assert hasattr(tfluid.layers, name), name
