"""The port's conv family (``ops/nn.py``: ``depthwise_conv2d``,
``conv3d``, ``conv2d_transpose``, ``row_conv``, ``spp``) and its layers
against the JAX package, on the CPU:

- each op replays its ``SPECS`` entry (``tools/tpu_optest.py``) at the
  spec's tolerance, forward and gradient, and variants (strides,
  dilations, groups, avg spp, a lookahead of 1);
- the three convs' explicit gradients (``grad_lower``) never re-run the
  forward, and agree with autograd through it;
- under bf16 AMP each conv and its gradient through both packages'
  ``run_op``: the reference's dtypes, values within two bf16 ulps; the
  layers' program under AMP, 3 steps within 1e-2 of the reference's;
- ``tests/test_conv_pool_ops.py``'s conv2d_transpose shape case and
  every layer's ProgramDesc (the reference's bytes), run in both
  packages.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from test_torch_amp import ACT, _assert_same, _rand, _run_both
from test_torch_ops import _check, optest, replay_spec

S = optest.SPECS
OPS = ["depthwise_conv2d", "conv3d", "conv2d_transpose", "row_conv", "spp"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("op", OPS)
def test_op_replays_its_spec(op):
    replay_spec(op)


_rng = np.random.RandomState(5)


def _f(*shape):
    return _rng.uniform(-1, 1, shape).astype(np.float32)


VARIANTS = {
    "depthwise_conv2d_stride_2": ("depthwise_conv2d", dict(
        S["depthwise_conv2d"], attrs=dict(S["depthwise_conv2d"]["attrs"],
                                          strides=[2, 2]))),
    "depthwise_conv2d_multiplier_2": ("depthwise_conv2d", dict(
        S["depthwise_conv2d"], inputs={"Input": _f(2, 4, 7, 7),
                                       "Filter": _f(8, 1, 3, 3)})),
    "conv3d_stride_dilation": ("conv3d", dict(S["conv3d"], attrs={
        "strides": [2, 1, 2], "paddings": [0, 1, 1],
        "dilations": [1, 2, 1], "groups": 1})),
    "conv3d_groups": ("conv3d", dict(S["conv3d"], inputs={
        "Input": _f(1, 4, 4, 5, 5), "Filter": _f(6, 2, 3, 3, 3)},
        attrs={"strides": [1, 1, 1], "paddings": [1, 1, 1],
               "dilations": [1, 1, 1], "groups": 2})),
    "conv2d_transpose_dilation": ("conv2d_transpose", dict(
        S["conv2d_transpose"], attrs={"strides": [1, 2], "paddings": [0, 1],
                                      "dilations": [2, 1]})),
    "conv2d_transpose_4x4_stride_2": ("conv2d_transpose", dict(
        S["conv2d_transpose"], inputs={"Input": _f(2, 4, 5, 5),
                                       "Filter": _f(4, 3, 4, 4)},
        attrs={"strides": [2, 2], "paddings": [1, 1],
               "dilations": [1, 1]})),
    "row_conv_lookahead_1": ("row_conv", dict(S["row_conv"], inputs={
        "X": _f(3, 5, 4), "Filter": _f(1, 4)})),
    "spp_avg_odd": ("spp", dict(S["spp"], inputs={"X": _f(2, 3, 7, 10)},
                                attrs={"pyramid_height": 3,
                                       "pooling_type": "avg"})),
    "spp_max_odd": ("spp", dict(S["spp"], inputs={"X": _f(2, 3, 7, 10)},
                                attrs={"pyramid_height": 3,
                                       "pooling_type": "max"})),
}


@pytest.mark.parametrize("case", sorted(VARIANTS))
def test_op_variant_replays(case):
    replay_spec(*VARIANTS[case])


# ------------------------------------------------- the explicit gradients

@pytest.mark.parametrize("op", ["depthwise_conv2d", "conv3d",
                                "conv2d_transpose"])
def test_explicit_grad_never_reruns_the_forward(op, monkeypatch):
    """``<op>_grad`` lowers through the forward's ``grad_lower``
    (``convolution_backward``): the gradient program calls the forward
    lowering once (its own forward op), and its gradients equal autograd
    through the forward at the spec's tolerance."""
    from paddle_tpu_torch.core import registry
    from paddle_tpu_torch.core.lowering import generic_grad_lower
    from test_torch_ops import run_in_port

    s = dict(S[op])
    t = optest._make_optest(op, s)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    t2 = optest._make_optest(op, s)
    t2.outputs = {slot: ref[slot] for slot in t.outputs}
    gmain, _, gfeed, gnames = optest._grad_program(t2, s["grad"])
    info = registry.get_op_info(op)
    assert info.grad_lower is not None
    assert registry.get_op_info(op + "_grad").lower is generic_grad_lower
    want = run_in_port(gmain, gfeed, gnames)
    # autograd through the forward (the generic lowering without the
    # explicit gradient)
    monkeypatch.setattr(info, "grad_lower", None)
    auto = run_in_port(gmain, gfeed, gnames)
    for n in gnames:
        _check(n, auto[n], want[n], s["tol"])
    monkeypatch.undo()

    real = info.lower
    calls = []

    def forward_only(ctx, ins, attrs, op_):
        calls.append(1)
        return real(ctx, ins, attrs, op_)

    monkeypatch.setattr(info, "lower", forward_only)
    got = run_in_port(gmain, gfeed, gnames)
    # the forward ran once (the program's own forward op), never again
    # inside the gradient
    assert len(calls) == 1, calls
    for n in gnames:
        _check(n, want[n], got[n], (0.0, 0.0))


# ----------------------------------------------------------------- AMP

AMP_CASES = {
    "depthwise_conv2d": (lambda r: {"Input": _rand(r, 2, 4, 9, 9),
                                    "Filter": _rand(r, 4, 1, 3, 3)},
                         {"strides": [2, 2], "paddings": [1, 1],
                          "groups": 4}),
    "conv3d": (lambda r: {"Input": _rand(r, 1, 3, 5, 6, 6),
                          "Filter": _rand(r, 4, 3, 3, 3, 3, scale=1 / 6)},
               {"strides": [1, 2, 2], "paddings": [1, 1, 1]}),
    "conv2d_transpose": (lambda r: {"Input": _rand(r, 2, 4, 5, 5),
                                    "Filter": _rand(r, 4, 3, 4, 4,
                                                    scale=1 / 4)},
                         {"strides": [2, 2], "paddings": [1, 1]}),
}


@pytest.mark.parametrize("x_dtype", ACT)
@pytest.mark.parametrize("op", sorted(AMP_CASES))
def test_conv_and_its_grad_under_amp(op, x_dtype):
    """The AMP white list casts each conv's f32 operands to bf16 in both
    packages: the output and both gradients in the reference's dtypes
    (bf16 out, each gradient in its operand's dtype), within two bf16
    ulps of the reference's values."""
    rng = np.random.RandomState(2)
    arrays, attrs = AMP_CASES[op]
    a = arrays(rng)
    ins = {"Input": (a["Input"], x_dtype), "Filter": (a["Filter"], None)}
    fwd = _run_both(op, ins, ["Output"], attrs)
    _assert_same(fwd)
    dy = _rand(rng, *fwd["Output"][1].shape)
    for dy_dtype in ACT:
        _assert_same(_run_both(
            op + "_grad", {**ins, "Output@GRAD": (dy, dy_dtype)},
            ["Input@GRAD", "Filter@GRAD"], attrs))


# -------------------------------------------------------------- layers

def test_conv2d_transpose_shape():
    """tests/test_conv_pool_ops.py:98 in both packages."""
    for fluid in (jfluid, tfluid):
        with fluid.program_guard(fluid.Program(), fluid.Program()):
            x = fluid.layers.data(name="x", shape=[3, 8, 8],
                                  dtype="float32")
            y = fluid.layers.conv2d_transpose(x, num_filters=6,
                                              filter_size=4, stride=2,
                                              padding=1)
            assert tuple(y.shape[1:]) == (6, 16, 16), y.shape


def _conv_layers(fluid):
    layers = fluid.layers
    img = layers.data(name="img", shape=[4, 8, 8], dtype="float32")
    vol = layers.data(name="vol", shape=[2, 4, 6, 6], dtype="float32")
    seq = layers.data(name="seq", shape=[5, 6], dtype="float32")
    up = layers.conv2d_transpose(img, num_filters=3, output_size=16,
                                 stride=2, padding=1, act="relu")
    dw = layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                       groups=4)
    c3 = layers.conv3d(vol, num_filters=3, filter_size=3, padding=1,
                       act="relu")
    rc = layers.row_conv(seq, future_context_size=2, act="tanh")
    sp = layers.spp(img, pyramid_height=2, pool_type="avg")
    loss = layers.mean(layers.concat(
        [layers.reshape(v, [-1, int(np.prod(v.shape[1:]))])
         for v in (up, dw, c3, rc, sp)], axis=1))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return loss


def test_conv_layers_build_and_train_as_the_reference():
    """conv2d_transpose (from output_size), a depthwise conv2d, conv3d,
    row_conv and spp layers: the same ProgramDesc bytes (their shapes
    from build-time inference), and 3 SGD steps from the reference's
    startup values within 1e-5 of its losses and parameters."""
    rng = np.random.RandomState(3)
    feed = {"img": rng.randn(2, 4, 8, 8).astype(np.float32),
            "vol": rng.randn(2, 2, 4, 6, 6).astype(np.float32),
            "seq": rng.randn(2, 5, 6).astype(np.float32)}
    descs, losses, params = [], [], []
    init = None
    for fluid, scope in ((jfluid, JScope()), (tfluid, tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = _conv_layers(fluid)
        descs.append(main.desc.serialize_to_string())
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        names = sorted(p.name for p in main.global_block().all_parameters())
        if init is None:
            init = {n: np.asarray(scope.find_var(n)) for n in names}
        else:
            for n in names:
                scope.set(n, torch.from_numpy(init[n].copy()))
        losses.append([float(np.ravel(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0])[0])
            for _ in range(3)])
        params.append({n: np.asarray(scope.find_var(n)) for n in names})
    assert descs[0] == descs[1]
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-5)
    for n, v in params[0].items():
        _check(n, v, params[1][n], (1e-5, 1e-5))


def test_conv_layers_train_under_amp_as_the_reference():
    """The conv layers' program under bf16 AMP (Float16Transpiler) in
    both packages: 3 SGD steps from the reference's startup values,
    the losses within 1e-2 of the reference's AMP losses
    (test_torch_amp.py's bar for a program's steps), every parameter
    still float32."""
    rng = np.random.RandomState(4)
    feed = {"img": rng.randn(2, 4, 8, 8).astype(np.float32),
            "vol": rng.randn(2, 2, 4, 6, 6).astype(np.float32),
            "seq": rng.randn(2, 5, 6).astype(np.float32)}
    losses, init = [], None
    for fluid, scope in ((jfluid, JScope()), (tfluid, tfluid.Scope())):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss = _conv_layers(fluid)
        fluid.transpiler.Float16Transpiler().transpile(main)
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup, scope=scope)
        names = sorted(p.name for p in main.global_block().all_parameters())
        if init is None:
            init = {n: np.asarray(scope.find_var(n)) for n in names}
        else:
            for n in names:
                scope.set(n, torch.from_numpy(init[n].copy()))
        losses.append([float(np.ravel(exe.run(
            main, feed=feed, fetch_list=[loss], scope=scope)[0])[0])
            for _ in range(3)])
        if fluid is tfluid:
            assert all(scope.find_var(n).dtype == torch.float32
                       for n in names)
    np.testing.assert_allclose(losses[1], losses[0], rtol=1e-2)
