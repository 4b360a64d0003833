"""ResNet through the port's fluid Executor against the JAX package's, on
the CPU.

- ``models/resnet.get_model`` builds the same ProgramDesc and startup
  desc, byte for byte, as the reference for flowers / depth 50 (224 x
  224, 102 classes, uint8 feed) and cifar10 / depth 8, in the NCHW
  program, the NHWC program (``LayoutTranspiler`` without fusion) and
  the NHWC fused-stage program, with the same transpiler counts;
- three Momentum steps of cifar10 depth 8 at batch 4, from the
  reference's startup parameters, track the reference in all three
  programs: losses rtol 1e-4, parameters after 3 steps within the bar
  of ``tests/test_layout_pass.py`` (max |drift| < 5e-4);
- the port's fused and unfused programs agree at that same bar (losses
  2e-4, parameters 5e-4);
- the fused ``is_test`` forward (K6's full epilogue on the card) matches
  the reference's.
"""
import collections

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.core.flags import FLAGS
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import resnet as tresnet

OIHW_TO_HWIO = (2, 3, 1, 0)
STEPS = 3
# (data_format, fused_stages) of the three programs
PROGRAMS = [("NCHW", False), ("NHWC", False), ("NHWC", True)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def build(fluid, module, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, (acc,) = module.get_model(**kw)
    return main, startup, loss, acc


def _forward(fluid, module, **kw):
    """The reference's get_model up to the LayoutTranspiler call: the
    forward graph, not minimized, for counting the passes' rewrites."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        data = fluid.layers.data(name="data", shape=kw["dshape"],
                                 dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = kw["model"](module)(data, kw["classes"], depth=kw["depth"])
        fluid.layers.mean(fluid.layers.cross_entropy(input=predict,
                                                     label=label))
    return main, startup


@pytest.mark.parametrize("data_set,depth,input_dtype,is_test", [
    ("flowers", 50, "uint8", False), ("flowers", 50, "uint8", True),
    ("cifar10", 8, "float32", False)])
@pytest.mark.parametrize("data_format,fused", PROGRAMS)
def test_programs_serialize_as_the_references(data_set, depth, input_dtype,
                                              is_test, data_format, fused):
    kw = dict(data_set=data_set, depth=depth, input_dtype=input_dtype,
              is_test=is_test, data_format=data_format, fused_stages=fused)
    jmain, jstart, _, _ = build(jfluid, jresnet, **kw)
    tmain, tstart, _, _ = build(tfluid, tresnet, **kw)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    assert [op.type for op in tmain.global_block().ops] == \
        [op.type for op in tmain.desc.blocks[0].ops]
    ops = collections.Counter(o.type for o in tmain.desc.blocks[0].ops)
    convs = 53 if depth == 50 else 9
    if fused:
        assert ops["fused_conv2d_bn_act"] == convs and ops["conv2d"] == 0
        assert ops["fused_conv2d_bn_act_grad"] == (0 if is_test else convs)
    else:
        assert ops["conv2d"] == convs and ops["batch_norm"] == convs


@pytest.mark.parametrize("data_set", ["flowers", "cifar10"])
@pytest.mark.parametrize("fused", [False, True])
def test_layout_transpiler_counts_are_the_references(data_set, fused):
    spec = (dict(dshape=[3, 224, 224], classes=102, depth=50,
                 model=lambda m: m.resnet_imagenet)
            if data_set == "flowers" else
            dict(dshape=[3, 32, 32], classes=10, depth=8,
                 model=lambda m: m.resnet_cifar10))
    counts, descs = [], []
    for fluid, module in ((jfluid, jresnet), (tfluid, tresnet)):
        main, startup = _forward(fluid, module, **spec)
        counts.append(fluid.transpiler.LayoutTranspiler().transpile(
            main, startup_program=startup, data_format="NHWC",
            fuse_stages=fused))
        descs.append((main.desc.serialize_to_string(),
                      startup.desc.serialize_to_string()))
    assert counts[0] == counts[1]
    assert counts[1]["nhwc_layout"] > 0
    convs = 53 if data_set == "flowers" else 9
    assert counts[1].get("fuse_conv_bn_act", 0) == (convs if fused else 0)
    assert descs[0] == descs[1]


def test_filters_pinned_hwio_in_the_live_scope():
    """A scope that already holds OIHW filters gets them transposed to
    HWIO, as the reference's pass does."""
    spec = dict(dshape=[3, 32, 32], classes=10, depth=8,
                model=lambda m: m.resnet_cifar10)
    main, startup = _forward(tfluid, tresnet, **spec)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    fname = [o.input("Filter")[0] for o in main.desc.blocks[0].ops
             if o.type == "conv2d"][0]
    before = scope.find_var(fname).clone()
    tfluid.transpiler.LayoutTranspiler().transpile(
        main, startup_program=startup, scope=scope, data_format="NHWC")
    after = scope.find_var(fname)
    assert torch.equal(after, before.permute(*OIHW_TO_HWIO))
    assert after.is_contiguous()


# ------------------------------------------------------------- training

def _feeds(seed, batch=4):
    rng = np.random.RandomState(seed)
    return {"data": rng.rand(batch, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (batch, 1)).astype(np.int64)}


def _params_for(arrays, main):
    """The NCHW startup's arrays, filters transposed HWIO where the
    program stores them so."""
    block = main.desc.blocks[0]
    out = {}
    for name, v in arrays.items():
        shape = tuple(block.vars[name].shape)
        if v.ndim == 4 and v.shape != shape:
            v = np.ascontiguousarray(np.transpose(v, OIHW_TO_HWIO))
        assert v.shape == shape, (name, v.shape, shape)
        out[name] = v
    return out


@pytest.fixture(scope="module")
def resnet_runs():
    """Reference and port, each program, 3 Momentum steps of cifar10
    depth 8 at batch 4 from the reference's NCHW startup parameters:
    {(package, data_format, fused): (losses, final persistables)}."""
    kw = dict(data_set="cifar10", depth=8)
    jmain0, jstart0, _, _ = build(jfluid, jresnet, **kw,
                                  data_format="NCHW", fused_stages=False)
    persist = sorted(n for n, v in jmain0.desc.blocks[0].vars.items()
                     if v.persistable)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart0)
    init = {n: np.asarray(jscope.find_var(n)) for n in persist}
    feed = _feeds(0)
    runs = {}
    for fmt, fused in PROGRAMS:
        jmain, _, jloss, _ = build(jfluid, jresnet, **kw, data_format=fmt,
                                   fused_stages=fused)
        tmain, _, tloss, _ = build(tfluid, tresnet, **kw, data_format=fmt,
                                   fused_stages=fused)
        params = _params_for(init, jmain)
        jscope = JScope()
        for n, v in params.items():
            jscope.set(n, v)
        jexe = jfluid.Executor(jfluid.CPUPlace())
        tscope = tfluid.Scope()
        set_scope_arrays(tscope, params, "cpu")
        texe = tfluid.Executor(tfluid.CPUPlace())
        jl, tl = [], []
        for _ in range(STEPS):
            with jfluid.scope_guard(jscope):
                jl.append(float(np.asarray(jexe.run(
                    jmain, feed=feed, fetch_list=[jloss])[0]).ravel()[0]))
            tl.append(float(texe.run(tmain, feed=feed, fetch_list=[tloss],
                                     scope=tscope)[0].ravel()[0]))
        runs[("jax", fmt, fused)] = (
            jl, {n: np.asarray(jscope.find_var(n)) for n in persist})
        runs[("port", fmt, fused)] = (tl, get_scope_arrays(tscope, persist))
    return runs


def _max_drift(a, b):
    """Largest |a - b| over the float persistables, filters compared in
    b's layout."""
    drift = []
    for n, v in a.items():
        w = b[n]
        if v.dtype.kind != "f":
            continue
        if v.shape != w.shape and v.ndim == 4:
            v = np.transpose(v, OIHW_TO_HWIO)
        assert v.shape == w.shape, n
        drift.append(float(np.abs(v - w).max()))
    return max(drift)


@pytest.mark.parametrize("data_format,fused", PROGRAMS)
def test_losses_track_the_reference(resnet_runs, data_format, fused):
    want, _ = resnet_runs[("jax", data_format, fused)]
    got, _ = resnet_runs[("port", data_format, fused)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]


@pytest.mark.parametrize("data_format,fused", PROGRAMS)
def test_parameters_track_the_reference_after_three_steps(resnet_runs,
                                                          data_format,
                                                          fused):
    _, want = resnet_runs[("jax", data_format, fused)]
    _, got = resnet_runs[("port", data_format, fused)]
    assert _max_drift(want, got) < 5e-4


@pytest.mark.parametrize("data_format,fused", PROGRAMS[1:])
def test_nhwc_programs_agree_with_the_nchw_program(resnet_runs, data_format,
                                                   fused):
    base, base_post = resnet_runs[("port", "NCHW", False)]
    got, post = resnet_runs[("port", data_format, fused)]
    np.testing.assert_allclose(got, base, rtol=2e-4, atol=2e-4)
    assert _max_drift(base_post, post) < 5e-4


@pytest.mark.parametrize("data_format,fused", [("NCHW", False),
                                               ("NHWC", True)])
def test_inference_forward_matches_the_reference(data_format, fused):
    """``get_model(is_test=True)``: BN from running statistics and, in
    the fused program, the conv stage's affine + residual + relu
    epilogue; softmax outputs held to 1e-5."""
    kw = dict(data_set="cifar10", depth=8, is_test=True,
              data_format=data_format, fused_stages=fused)
    jmain, jstart, _, _ = build(jfluid, jresnet, **kw)
    tmain, _, _, _ = build(tfluid, tresnet, **kw)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    persist = [n for n, v in jmain.desc.blocks[0].vars.items()
               if v.persistable]
    rng = np.random.RandomState(5)
    params = {}
    for n in persist:     # running statistics away from (0, 1)
        v = np.asarray(jscope.find_var(n))
        if ".w_" in n and v.ndim == 1:
            v = v + rng.rand(*v.shape).astype(np.float32)
        params[n] = v
        jscope.set(n, v)
    tscope = tfluid.Scope()
    set_scope_arrays(tscope, params, "cpu")
    softmax = [o.output("Out")[0] for o in jmain.desc.blocks[0].ops
               if o.type == "softmax"]
    feed = _feeds(1)
    with jfluid.scope_guard(jscope):
        want = jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, feed=feed, fetch_list=softmax)[0]
    got = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=softmax, scope=tscope)[0]
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_flag_gating():
    """FLAGS.conv_layout is NCHW by default; NHWC (with
    conv_fused_stages on by default) builds the fused program."""
    assert FLAGS.conv_layout == "NCHW" and FLAGS.conv_fused_stages is True
    main, _, _, _ = build(tfluid, tresnet, data_set="cifar10", depth=8)
    assert not any(o.type.startswith("fused_")
                   for o in main.desc.blocks[0].ops)
    FLAGS.conv_layout = "NHWC"
    try:
        main, _, _, _ = build(tfluid, tresnet, data_set="cifar10", depth=8)
        assert any(o.type == "fused_conv2d_bn_act"
                   for o in main.desc.blocks[0].ops)
    finally:
        FLAGS.conv_layout = "NCHW"
