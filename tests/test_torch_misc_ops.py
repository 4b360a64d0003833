"""The port's specialty ops (``ops/misc.py``: ``conv_shift``,
``fake_dequantize_max_abs``, ``polygon_box_transform``,
``max_pool2d_with_index``, ``unpool``, ``roi_pool``,
``positive_negative_pair``, ``scale_sub_region``) and their layers
against the JAX package, on the CPU:

- each op with a ``SPECS`` entry replays it at the spec's tolerance,
  with its gradient where the spec has one, and variants (padding,
  overlapping windows, a wider shift, a scaled ROI);
- ``tests/test_misc_ops.py``'s cases, each run in both packages against
  its hand-computed values and against the reference's outputs;
  ``positive_negative_pair`` (a host op) bit for bit;
- ``unpool`` assigns: with overlapping windows one value a position,
  and its gradient where jax's scatter-set sends it (the last
  duplicate), not to every duplicate; ``max_pool2d_with_index``'s and
  ``roi_pool``'s gradients on tied values against jax's;
- the layers' ProgramDescs (the reference's bytes).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core import registry as jreg
from paddle_tpu.core.desc import ProgramDesc as JProgramDesc
from paddle_tpu.core.lowering import Ins as JIns
from paddle_tpu.core.lowering import LoweringContext as JCtx
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.core import registry as treg
from paddle_tpu_torch.core.desc import ProgramDesc as TProgramDesc
from paddle_tpu_torch.core.lowering import Ins as TIns
from paddle_tpu_torch.core.lowering import LoweringContext as TCtx
from test_torch_ops import optest, replay_spec

S = optest.SPECS
OPS = ["conv_shift", "fake_dequantize_max_abs", "polygon_box_transform",
       "max_pool2d_with_index", "unpool", "roi_pool", "scale_sub_region"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("op", OPS)
def test_op_replays_its_spec(op):
    replay_spec(op)


_rng = np.random.RandomState(7)


def _f(*shape):
    return _rng.uniform(-1, 1, shape).astype(np.float32)


VARIANTS = {
    "conv_shift_width_5": ("conv_shift", dict(S["conv_shift"], inputs={
        "X": _f(2, 9), "Y": _f(2, 5)})),
    "max_pool2d_with_index_padded": ("max_pool2d_with_index", dict(
        S["max_pool2d_with_index"], inputs={"X": _f(2, 2, 7, 7)},
        attrs={"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]})),
    "max_pool2d_with_index_overlapping": ("max_pool2d_with_index", dict(
        S["max_pool2d_with_index"], inputs={"X": _f(1, 2, 6, 6)},
        attrs={"ksize": [3, 3], "strides": [1, 1], "paddings": [0, 0]})),
    "roi_pool_scaled": ("roi_pool", dict(S["roi_pool"], inputs={
        "X": _f(2, 3, 10, 12),
        "ROIs": np.asarray([[0, 2, 2, 17, 13], [1, 0, 4, 23, 19],
                            [1, 6, 6, 7, 7]], np.float32)},
        attrs={"pooled_height": 3, "pooled_width": 2,
               "spatial_scale": 0.5})),
    "polygon_box_transform_8": ("polygon_box_transform", dict(
        S["polygon_box_transform"], inputs={"Input": _f(2, 8, 4, 5)})),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_op_variant_replays(case):
    replay_spec(*VARIANTS[case])


# --------------------------------------------------------------------------
# tests/test_misc_ops.py's cases, in both packages
# --------------------------------------------------------------------------

def _run_both(op_type, ins, attrs=None):
    """One op's lowering in both packages on ``ins`` ({slot: array});
    returns ({slot: reference numpy}, {slot: port numpy})."""
    jctx = JCtx(JProgramDesc(), 0, {}, jax.random.PRNGKey(0), "train")
    jout = jreg.get_op_info(op_type).lower(
        jctx, JIns({k: [jnp.asarray(v)] for k, v in ins.items()}),
        dict(attrs or {}), None)
    tctx = TCtx(TProgramDesc(), 0, {}, torch.device("cpu"))
    tout = treg.get_op_info(op_type).lower(
        tctx, TIns({k: [torch.from_numpy(np.asarray(v).copy())]
                    for k, v in ins.items()}), dict(attrs or {}), None)
    return ({k: np.asarray(v) for k, v in jout.items()},
            {k: v.detach().numpy() for k, v in tout.items()})


def test_conv_shift_matches_naive():
    rng = np.random.RandomState(0)
    x = rng.randn(2, 7).astype(np.float32)
    y = rng.randn(2, 3).astype(np.float32)
    ref, got = _run_both("conv_shift", {"X": x, "Y": y})
    want = np.zeros_like(x)
    m, n = 7, 3
    for b in range(2):
        for i in range(m):
            for j in range(n):
                want[b, i] += x[b, (i + j - n // 2) % m] * y[b, j]
    np.testing.assert_allclose(got["Out"], want, rtol=1e-5)
    np.testing.assert_allclose(got["Out"], ref["Out"], rtol=1e-6)


def test_fake_dequantize():
    x = np.asarray([[127.0, -63.5]], np.float32)
    ref, got = _run_both("fake_dequantize_max_abs",
                         {"X": x, "Scale": np.asarray([0.5], np.float32)},
                         {"max_range": 127.0})
    np.testing.assert_allclose(got["Out"], [[0.5, -0.25]], rtol=1e-6)
    np.testing.assert_array_equal(got["Out"], ref["Out"])


def test_polygon_box_transform():
    ref, got = _run_both("polygon_box_transform",
                         {"Input": np.ones((1, 4, 2, 2), np.float32)})
    out = got["Output"]
    # even channels: x-coord = col*4 - 1; odd: row*4 - 1
    np.testing.assert_allclose(out[0, 0], [[-1, 3], [-1, 3]])
    np.testing.assert_allclose(out[0, 1], [[-1, -1], [3, 3]])
    np.testing.assert_array_equal(out, ref["Output"])


def test_pool_with_index_and_unpool_roundtrip():
    rng = np.random.RandomState(1)
    # positive data: the unpool re-pool check compares against zeros
    x = rng.rand(2, 3, 4, 4).astype(np.float32) + 0.1
    attrs = {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}
    ref, got = _run_both("max_pool2d_with_index", {"X": x}, attrs)
    out, mask = got["Out"], got["Mask"]
    np.testing.assert_allclose(
        out, x.reshape(2, 3, 2, 2, 2, 2).max(axis=(3, 5)), rtol=1e-6)
    np.testing.assert_array_equal(mask, ref["Mask"])
    flat = x.reshape(2, 3, 16)
    np.testing.assert_allclose(
        np.take_along_axis(flat, mask.reshape(2, 3, 4).astype(np.int64),
                           axis=2), out.reshape(2, 3, 4), rtol=1e-6)
    uref, ugot = _run_both("unpool", {"X": out, "Indices": mask}, attrs)
    up = ugot["Out"]
    assert up.shape == x.shape
    np.testing.assert_allclose(
        up.reshape(2, 3, 2, 2, 2, 2).max(axis=(3, 5)), out, rtol=1e-6)
    assert np.count_nonzero(up) <= 2 * 3 * 4
    np.testing.assert_array_equal(up, uref["Out"])


def test_roi_pool_hand_case():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.asarray([[0, 0, 0, 1, 1], [0, 2, 2, 3, 3]], np.float32)
    ref, got = _run_both("roi_pool", {"X": x, "ROIs": rois},
                         {"spatial_scale": 1.0, "pooled_height": 1,
                          "pooled_width": 1})
    np.testing.assert_allclose(got["Out"][:, 0, 0, 0], [5.0, 15.0])
    np.testing.assert_array_equal(got["Out"], ref["Out"])
    np.testing.assert_array_equal(got["Argmax"], ref["Argmax"])


def test_roi_pool_argmax():
    x = np.arange(16, dtype=np.float32).reshape(1, 1, 4, 4)
    rois = np.asarray([[0, 0, 0, 1, 1]], np.float32)
    ref, got = _run_both("roi_pool", {"X": x, "ROIs": rois},
                         {"spatial_scale": 1.0, "pooled_height": 1,
                          "pooled_width": 1})
    np.testing.assert_allclose(got["Out"][0, 0, 0, 0], 5.0)
    assert int(got["Argmax"][0, 0, 0, 0]) == 5
    assert got["Argmax"].dtype == ref["Argmax"].dtype == np.int32


def test_unpool_overlapping_windows_assigns_once():
    x = np.zeros((1, 1, 3, 3), np.float32)
    x[0, 0, 1, 1] = 5.0
    attrs = {"ksize": [2, 2], "strides": [1, 1], "paddings": [0, 0]}
    _, pooled = _run_both("max_pool2d_with_index", {"X": x}, attrs)
    ref, got = _run_both("unpool", {"X": pooled["Out"],
                                    "Indices": pooled["Mask"]}, attrs)
    # every window recorded index (1,1); unpool must ASSIGN 5, not 20
    np.testing.assert_allclose(got["Out"][0, 0, 1, 1], 5.0)
    np.testing.assert_array_equal(got["Out"], ref["Out"])


def _pnp_program(fluid):
    s = fluid.layers.data(name="s", shape=[1], dtype="float32")
    lab = fluid.layers.data(name="l", shape=[1], dtype="float32")
    q = fluid.layers.data(name="q", shape=[1], dtype="int64")
    helper = fluid.layer_helper.LayerHelper("pnp")
    pos = helper.create_tmp_variable("float32")
    neg = helper.create_tmp_variable("float32")
    neu = helper.create_tmp_variable("float32")
    helper.append_op(
        type="positive_negative_pair",
        inputs={"Score": [s], "Label": [lab], "QueryID": [q]},
        outputs={"PositivePair": [pos], "NegativePair": [neg],
                 "NeutralPair": [neu]})
    return [pos, neg, neu]


@pytest.mark.parametrize("case", ["reference", "ties", "random"])
def test_positive_negative_pair(case):
    """test_misc_ops.py's case (2, 1, 0), a case with score ties, and
    64 random rows over 5 queries: the port's host op gives the
    reference's counts bit for bit."""
    if case == "reference":
        feed = {"s": np.asarray([[3], [1], [3], [1], [2]], np.float32),
                "l": np.asarray([[1], [0], [1], [1], [0]], np.float32),
                "q": np.asarray([[0], [0], [0], [1], [1]], np.int64)}
    elif case == "ties":
        feed = {"s": np.asarray([[1], [1], [2], [2], [2]], np.float32),
                "l": np.asarray([[0], [1], [2], [0], [1]], np.float32),
                "q": np.zeros((5, 1), np.int64)}
    else:
        rng = np.random.RandomState(4)
        feed = {"s": rng.randint(0, 6, (64, 1)).astype(np.float32),
                "l": rng.randint(0, 3, (64, 1)).astype(np.float32),
                "q": rng.randint(0, 5, (64, 1)).astype(np.int64)}
    outs = []
    for fluid, scope in ((jfluid, JScope()), (tfluid, tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = _pnp_program(fluid)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        outs.append([np.asarray(v) for v in exe.run(
            main, feed=feed, fetch_list=fetch, scope=scope)])
    for a, b in zip(*outs):
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)
    if case == "reference":
        assert [float(np.ravel(v)[0]) for v in outs[1]] == [2.0, 1.0, 0.0]


def test_scale_sub_region_vs_numpy():
    """Per-sample sub-box scaling with 1-based inclusive bounds, through
    the layer in both packages."""
    rng = np.random.RandomState(0)
    xv = rng.randn(2, 3, 4, 4).astype(np.float32)
    iv = np.asarray([[1, 2, 1, 3, 2, 4], [2, 3, 2, 2, 1, 1]], np.int64)
    outs = []
    for fluid, scope in ((jfluid, JScope()), (tfluid, tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="ssr_x", shape=[3, 4, 4],
                                  dtype="float32")
            ind = fluid.layers.data(name="ssr_i", shape=[6], dtype="int64")
            out = fluid.layers.scale_sub_region(
                x, fluid.layers.cast(ind, "int32"), 2.0)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        outs.append(np.asarray(exe.run(main, feed={"ssr_x": xv,
                                                   "ssr_i": iv},
                                       fetch_list=[out], scope=scope)[0]))
    want = xv.copy()
    for s in range(2):
        c0, c1, h0, h1, w0, w1 = iv[s] - 1
        want[s, c0:c1 + 1, h0:h1 + 1, w0:w1 + 1] *= 2.0
    np.testing.assert_allclose(outs[1], want, atol=1e-6)
    np.testing.assert_array_equal(outs[1], outs[0])


# --------------------------------------------------------------------------
# gradients where duplicates and ties meet
# --------------------------------------------------------------------------

def _jax_grad(op_type, ins, wrt, attrs, cot):
    """jax.vjp of the reference's lowering of ``op_type`` w.r.t. the
    slot ``wrt`` at cotangent ``cot`` for its first output."""
    info = jreg.get_op_info(op_type)
    first = {"unpool": "Out", "max_pool2d_with_index": "Out",
             "roi_pool": "Out"}[op_type]

    def f(v):
        d = {k: [jnp.asarray(a)] for k, a in ins.items()}
        d[wrt] = [v]
        ctx = JCtx(JProgramDesc(), 0, {}, jax.random.PRNGKey(0), "train")
        return info.lower(ctx, JIns(d), dict(attrs), None)[first]

    _, vjp = jax.vjp(f, jnp.asarray(ins[wrt]))
    return np.asarray(vjp(jnp.asarray(cot))[0])


def _torch_grad(op_type, ins, wrt, attrs, cot):
    info = treg.get_op_info(op_type)
    d = {k: [torch.from_numpy(np.asarray(a).copy())] for k, a in ins.items()}
    leaf = d[wrt][0].requires_grad_(True)
    ctx = TCtx(TProgramDesc(), 0, {}, torch.device("cpu"))
    out = info.lower(ctx, TIns(d), dict(attrs), None)["Out"]
    g, = torch.autograd.grad(out, leaf, torch.from_numpy(cot))
    return g.numpy()


@pytest.mark.parametrize("ksize,stride", [(2, 1), (3, 1), (3, 2)])
def test_unpool_gradient_goes_where_jax_sends_it(ksize, stride):
    """Overlapping windows over a map with a few large values record one
    position many times.  Unpool's forward is the reference's bit for
    bit, and its gradient w.r.t. X is jax's scatter-set vjp: the
    cotangent reaches one duplicate (the last), the others 0."""
    rng = np.random.RandomState(ksize * 10 + stride)
    x = rng.rand(2, 3, 7, 7).astype(np.float32)
    x[:, :, 3, 3] += 5.0          # wins every window that holds it
    x[:, 1, 1, 5] += 4.0
    attrs = {"ksize": [ksize, ksize], "strides": [stride, stride],
             "paddings": [0, 0]}
    _, pooled = _run_both("max_pool2d_with_index", {"X": x}, attrs)
    mask = pooled["Mask"]
    flat = mask.reshape(2, 3, -1)
    assert any(len(np.unique(r)) < r.size for r in flat.reshape(6, -1))
    ins = {"X": pooled["Out"], "Indices": mask}
    ref, got = _run_both("unpool", ins, attrs)
    np.testing.assert_array_equal(got["Out"], ref["Out"])
    cot = rng.randn(*got["Out"].shape).astype(np.float32)
    want = _jax_grad("unpool", ins, "X", attrs, cot)
    g = _torch_grad("unpool", ins, "X", attrs, cot)
    np.testing.assert_array_equal(g, want)
    # each recorded position's cotangent reached exactly one duplicate
    assert np.count_nonzero(g) == sum(
        len(np.unique(r)) for r in flat.reshape(6, -1))


def test_pool_with_index_gradient_on_ties_is_jaxs():
    """Integer-valued maps tie inside windows: the value's gradient
    splits evenly over the tied positions in both packages (jax's max
    reduction), the Mask takes the first."""
    rng = np.random.RandomState(9)
    x = rng.randint(0, 3, (2, 2, 6, 6)).astype(np.float32)
    attrs = {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}
    ref, got = _run_both("max_pool2d_with_index", {"X": x}, attrs)
    np.testing.assert_array_equal(got["Mask"], ref["Mask"])
    cot = rng.randn(*got["Out"].shape).astype(np.float32)
    want = _jax_grad("max_pool2d_with_index", {"X": x}, "X", attrs, cot)
    g = _torch_grad("max_pool2d_with_index", {"X": x}, "X", attrs, cot)
    np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)


def test_roi_pool_gradient_is_jaxs():
    """Overlapping cells (the floor / ceil bounds), ROIs sharing an
    image, tied integer values: the gradient w.r.t. X is jax's vjp of
    the reference's lowering."""
    rng = np.random.RandomState(10)
    x = rng.randint(0, 4, (2, 3, 9, 11)).astype(np.float32)
    rois = np.asarray([[0, 1, 1, 8, 7], [0, 0, 2, 10, 8],
                       [1, 3, 0, 9, 6], [1, 5, 5, 5, 5]], np.float32)
    attrs = {"pooled_height": 3, "pooled_width": 4, "spatial_scale": 1.0}
    ins = {"X": x, "ROIs": rois}
    ref, got = _run_both("roi_pool", ins, attrs)
    np.testing.assert_array_equal(got["Out"], ref["Out"])
    np.testing.assert_array_equal(got["Argmax"], ref["Argmax"])
    cot = rng.randn(*got["Out"].shape).astype(np.float32)
    want = _jax_grad("roi_pool", ins, "X", attrs, cot)
    g = _torch_grad("roi_pool", ins, "X", attrs, cot)
    np.testing.assert_allclose(g, want, rtol=1e-6, atol=1e-6)


# --------------------------------------------------------------------------
# layers
# --------------------------------------------------------------------------

def _misc_layers(fluid):
    layers = fluid.layers
    x = layers.data(name="x", shape=[8], dtype="float32")
    y = layers.data(name="y", shape=[3], dtype="float32")
    img = layers.data(name="img", shape=[2, 6, 6], dtype="float32")
    rois = layers.data(name="rois", shape=[5], dtype="float32")
    idx = layers.data(name="idx", shape=[2, 3, 3], dtype="int32")
    ind = layers.data(name="ind", shape=[6], dtype="int32")
    pooled = layers.data(name="pooled", shape=[2, 3, 3], dtype="float32")
    return [layers.conv_shift(x, y),
            layers.roi_pool(img, rois, 2, 2, 0.5),
            layers.unpool(pooled, idx, 2),
            layers.scale_sub_region(img, ind, 3.0)]


def test_misc_layers_build_the_reference_desc():
    """conv_shift, roi_pool, unpool (its strides defaulting to the
    window) and scale_sub_region: the same ProgramDesc bytes, their
    shapes from build-time inference."""
    descs, shapes = [], []
    for fluid in (jfluid, tfluid):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            outs = _misc_layers(fluid)
        descs.append(main.desc.serialize_to_string())
        shapes.append([tuple(v.shape) for v in outs])
    assert descs[0] == descs[1]
    assert shapes[0] == shapes[1]
