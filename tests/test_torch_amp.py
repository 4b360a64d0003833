"""bf16 mixed precision in the port against the JAX package, on the CPU.

- the autocast lists (``AMP_WHITE``, ``AMP_BLACK``, ``AMP_AUTOCAST_OPS``)
  are the reference's, member for member;
- ``Float16Transpiler`` sets and reverts ``amp_bf16``, which survives
  serialize and clone;
- every op the ResNet AMP programs run, forward and grad, through both
  packages' ``run_op`` under AMP with ``FLAGS.bn_bf16`` off and on: each
  output's dtype is the reference's, and the values agree within
  rtol = atol = 2**-7 (two bf16 ulps) once both are widened to f32;
- three Momentum steps of cifar10 depth 8 at batch 4 under AMP, NCHW
  and NHWC fused, from the reference's startup parameters: losses
  within rtol 1e-2 of the reference's AMP losses, the dtypes of a set
  of fetched activations the reference's, every parameter and
  parameter gradient float32;
- an AMP program on an sp mesh runs the ring on bf16 and matches its
  dense AMP run (the LM's AMP programs are held to the reference in
  ``test_torch_lm_amp.py``, the sp one in ``test_torch_sp_amp.py``).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu.ops  # noqa: F401  (registers the reference's ops)
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.ops  # noqa: F401
from paddle_tpu.core import desc as jdesc
from paddle_tpu.core import lowering as jlowering
from paddle_tpu.core.flags import FLAGS as JFLAGS
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import resnet as jresnet
from paddle_tpu_torch.core import desc as tdesc
from paddle_tpu_torch.core import lowering as tlowering
from paddle_tpu_torch.core.executor_impl import ExecutorCore
from paddle_tpu_torch.core.flags import FLAGS as TFLAGS
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parallel import make_mesh

TOL = 2 ** -7          # two bf16 ulps, relative and absolute
LOSS_RTOL = 1e-2
STEPS = 3
OIHW_TO_HWIO = (2, 3, 1, 0)


@pytest.fixture(autouse=True)
def _bn_bf16_restored():
    jprev, tprev = JFLAGS.bn_bf16, TFLAGS.bn_bf16
    yield
    JFLAGS.bn_bf16, TFLAGS.bn_bf16 = jprev, tprev


def _set_bn_bf16(on):
    JFLAGS.bn_bf16 = TFLAGS.bn_bf16 = on


def test_autocast_lists_are_the_references():
    assert tlowering.AMP_WHITE == jlowering.AMP_WHITE
    assert tlowering.AMP_BLACK == jlowering.AMP_BLACK
    assert tlowering.AMP_AUTOCAST_OPS == jlowering.AMP_AUTOCAST_OPS


def _convnet(fluid):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = fluid.layers.data(name="img", shape=[3, 8, 8],
                                dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        conv = fluid.layers.conv2d(input=img, num_filters=4, filter_size=3,
                                   padding=1, act="relu")
        fc = fluid.layers.fc(input=conv, size=10, act="softmax")
        fluid.layers.mean(fluid.layers.cross_entropy(input=fc, label=label))
    return main


def test_transpiler_sets_and_reverts_the_flag():
    main = _convnet(tfluid)
    v0 = main.desc.version
    tfluid.transpiler.Float16Transpiler().transpile(main)
    assert main.desc.amp_bf16 and main.desc.version == v0 + 1
    tfluid.transpiler.Float16Transpiler().revert(main)
    assert not main.desc.amp_bf16 and main.desc.version == v0 + 2


def test_amp_flag_survives_serialize_and_clone():
    jmain, tmain = _convnet(jfluid), _convnet(tfluid)
    jfluid.transpiler.Float16Transpiler().transpile(jmain)
    tfluid.transpiler.Float16Transpiler().transpile(tmain)
    data = tmain.desc.serialize_to_string()
    assert data == jmain.desc.serialize_to_string()
    assert tdesc.ProgramDesc.parse_from_string(data).amp_bf16
    test_prog = tmain.clone(for_test=True)
    assert test_prog.desc.amp_bf16
    tfluid.transpiler.Float16Transpiler().revert(tmain)
    assert not tmain.desc.amp_bf16
    assert test_prog.desc.amp_bf16       # the clone is independent


def test_optimizer_role_ops_pass_through():
    x = torch.ones(2, 3, dtype=torch.bfloat16)
    ins = tlowering.Ins({"Param": [torch.ones(2, 3)], "Grad": [x]})
    out = tlowering.amp_cast_ins("batch_norm", ins, role=0x0002)
    assert out is ins
    out = tlowering.amp_cast_ins("mean", ins)
    assert out["Grad"].dtype == torch.float32


def test_autograd_through_the_cast_gives_float32_gradients():
    """The port's counterpart of the reference's vjp-of-cast: a float32
    leaf cast to bf16 for a product gets a float32 gradient."""
    w = torch.randn(4, 3, requires_grad=True)
    x = torch.randn(2, 4, dtype=torch.bfloat16)
    (g,) = torch.autograd.grad((x @ w.to(torch.bfloat16)).float().sum(), w)
    assert g.dtype == torch.float32
    want = x.float().sum(0)[:, None].expand(4, 3)
    torch.testing.assert_close(g, want.to(torch.bfloat16).float())


# ----------------------------------------------------------- op by op

def _jax_value(a, dtype):
    v = jnp.asarray(a)
    return v.astype(jnp.bfloat16) if dtype == "bf16" else v


def _torch_value(a, dtype):
    v = torch.from_numpy(np.array(a))
    return v.to(torch.bfloat16) if dtype == "bf16" else v


def _run_both(op_type, inputs, outputs, attrs=None):
    """One op through both packages' run_op in an AMP program.
    ``inputs``: {slot: (numpy array, 'f32' | 'bf16' | None)} (None: as
    given); ``outputs``: slot names.  Returns {slot: (jax value, torch
    value)}."""
    ins = {s: [s.lower().replace("@", "_")] for s in inputs}
    outs = {s: [s.lower().replace("@", "_") + "_out"] for s in outputs}
    results = {}
    for pkg in ("jax", "port"):
        desc = jdesc if pkg == "jax" else tdesc
        prog = desc.ProgramDesc()
        prog.amp_bf16 = True
        op = desc.OpDesc(op_type, inputs=ins, outputs=outs,
                         attrs=dict(attrs or {}))
        if pkg == "jax":
            env = {ins[s][0]: _jax_value(a, dt)
                   for s, (a, dt) in inputs.items()}
            ctx = jlowering.LoweringContext(prog, 0, env,
                                            jax.random.PRNGKey(0))
            jlowering.run_op(ctx, op)
        else:
            env = {ins[s][0]: _torch_value(a, dt)
                   for s, (a, dt) in inputs.items()}
            ctx = tlowering.LoweringContext(prog, 0, env,
                                            torch.device("cpu"))
            tlowering.run_op(ctx, op)
        for s in outputs:
            results.setdefault(s, []).append(env[outs[s][0]])
    return results


def _assert_same(results, terms=None):
    """Each output's dtype is the reference's and its value within TOL
    (relative and absolute) of the reference's.  ``terms``: {slot:
    magnitude of the terms the reference sums in bf16 for each element};
    a bf16 accumulator rounds at every add, so such a sum is held to TOL
    of that magnitude besides."""
    for slot, (j, t) in results.items():
        assert str(t.dtype).replace("torch.", "") == \
            jnp.dtype(j.dtype).name, (slot, j.dtype, t.dtype)
        want = np.asarray(j.astype(jnp.float32)) if \
            jnp.issubdtype(j.dtype, jnp.floating) else np.asarray(j)
        got = t.double().numpy()
        err = np.abs(got - want.astype(np.float64))
        bound = TOL + TOL * np.abs(want) + TOL * (terms or {}).get(slot, 0)
        assert np.all(err <= bound), (slot, float(err.max()))


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _bn_params(rng, c):
    return {"Scale": (rng.rand(c).astype(np.float32) + 0.5, None),
            "Bias": (_rand(rng, c), None),
            "Mean": (_rand(rng, c, scale=0.1), None),
            "Variance": (rng.rand(c).astype(np.float32) + 0.5, None)}


# the input dtype an activation has under AMP: bf16 out of a white op,
# or f32 (the image, or out of a black op with bn_bf16 off)
ACT = ["f32", "bf16"]


@pytest.mark.parametrize("x_dtype", ACT)
@pytest.mark.parametrize("data_format", ["NCHW", "NHWC"])
def test_conv2d_and_its_grad(x_dtype, data_format):
    rng = np.random.RandomState(1)
    x = _rand(rng, 2, 4, 9, 9)
    w = _rand(rng, 6, 4, 3, 3, scale=1 / 6)
    attrs = {"strides": [2, 2], "paddings": [1, 1]}
    if data_format == "NHWC":
        x, w = x.transpose(0, 2, 3, 1), w.transpose(*OIHW_TO_HWIO)
        attrs.update(data_format="NHWC", filter_format="HWIO")
    ins = {"Input": (x, x_dtype), "Filter": (w, None)}
    fwd = _run_both("conv2d", ins, ["Output"], attrs)
    _assert_same(fwd)
    dy = _rand(rng, *fwd["Output"][1].shape)
    for dy_dtype in ACT:
        _assert_same(_run_both(
            "conv2d_grad", {**ins, "Output@GRAD": (dy, dy_dtype)},
            ["Input@GRAD", "Filter@GRAD"], attrs))


@pytest.mark.parametrize("bn_bf16", [False, True])
@pytest.mark.parametrize("x_dtype", ACT)
@pytest.mark.parametrize("layout,is_test", [("NCHW", False),
                                            ("NHWC", False),
                                            ("NCHW", True)])
def test_batch_norm_and_its_grad(bn_bf16, x_dtype, layout, is_test):
    _set_bn_bf16(bn_bf16)
    rng = np.random.RandomState(2)
    x = _rand(rng, 4, 5, 3, 3) + 0.5
    if layout == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    ins = {"X": (x, x_dtype), **_bn_params(rng, 5)}
    attrs = {"data_layout": layout, "is_test": is_test, "epsilon": 1e-5,
             "momentum": 0.9}
    _assert_same(_run_both("batch_norm", ins,
                           ["Y", "MeanOut", "VarianceOut", "SavedMean",
                            "SavedVariance"], attrs))
    if is_test:
        return
    for dy_dtype in ACT:
        dy = _rand(rng, *x.shape)
        _assert_same(_run_both(
            "batch_norm_grad", {**ins, "Y@GRAD": (dy, dy_dtype)},
            ["X@GRAD", "Scale@GRAD", "Bias@GRAD"], attrs),
            _bn_grad_terms(x, dy, ins["Scale"][0], layout)
            if bn_bf16 and x_dtype == "bf16" else None)


def _bn_grad_terms(x, dy, scale, layout):
    """With bn_bf16, the reference differentiates a bf16 batch_norm, and
    its vjp sums the per-channel terms of the BN gradient in a bf16
    accumulator: dBias = sum dy, dScale = sum dy xhat, dX = a (dy -
    mean dy - xhat mean(dy xhat)).  Their magnitudes, per element."""
    axes = (0, 2, 3) if layout == "NCHW" else (0, 1, 2)
    x, dy = x.astype(np.float64), dy.astype(np.float64)
    mean = x.mean(axes, keepdims=True)
    inv = 1 / np.sqrt(x.var(axes, keepdims=True) + 1e-5)
    xhat = (x - mean) * inv
    shape = [1] * 4
    shape[1 if layout == "NCHW" else 3] = -1
    a = np.abs(scale.reshape(shape)) * inv
    s_dy, s_dyx = np.abs(dy).sum(axes), np.abs(dy * xhat).sum(axes)
    n = x.size // s_dy.size
    return {"Bias@GRAD": s_dy, "Scale@GRAD": s_dyx,
            "X@GRAD": a * (np.abs(dy) + s_dy.reshape(shape) / n
                           + np.abs(xhat) * s_dyx.reshape(shape) / n)}


@pytest.mark.parametrize("x_dtype,y_dtype", [("bf16", "bf16"),
                                             ("f32", "bf16"),
                                             ("bf16", "f32")])
def test_elementwise_add_and_its_grad(x_dtype, y_dtype):
    """The residual add (4-D) and the fc bias add (2-D + 1-D)."""
    rng = np.random.RandomState(3)
    for xs, ys, axis in (((2, 4, 3, 3), (2, 4, 3, 3), -1),
                         ((4, 10), (10,), 1)):
        ins = {"X": (_rand(rng, *xs), x_dtype), "Y": (_rand(rng, *ys),
                                                      y_dtype)}
        attrs = {"axis": axis}
        _assert_same(_run_both("elementwise_add", ins, ["Out"], attrs))
        for dy_dtype in ACT:
            _assert_same(_run_both(
                "elementwise_add_grad",
                {**ins, "Out@GRAD": (_rand(rng, *xs), dy_dtype)},
                ["X@GRAD", "Y@GRAD"], attrs))


def test_elementwise_add_of_a_scalar_stays_float32():
    """An add whose X has fewer than 2 dims is learning-rate or counter
    arithmetic: no cast."""
    rng = np.random.RandomState(4)
    res = _run_both("elementwise_add", {"X": (_rand(rng, 1), None),
                                        "Y": (_rand(rng, 1), None)},
                    ["Out"], {"axis": -1})
    _assert_same(res)
    assert res["Out"][1].dtype == torch.float32


@pytest.mark.parametrize("x_dtype", ACT)
def test_relu_and_its_grad(x_dtype):
    rng = np.random.RandomState(5)
    x = _rand(rng, 2, 4, 3, 3)
    _assert_same(_run_both("relu", {"X": (x, x_dtype)}, ["Out"]))
    for dy_dtype in ACT:
        _assert_same(_run_both(
            "relu_grad", {"X": (x, x_dtype),
                          "Out@GRAD": (_rand(rng, *x.shape), dy_dtype)},
            ["X@GRAD"]))


@pytest.mark.parametrize("x_dtype", ACT)
@pytest.mark.parametrize("attrs", [
    {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "max", "ksize": [3, 3], "strides": [2, 2],
     "paddings": [1, 1]},
    {"pooling_type": "avg", "ksize": [7, 7], "global_pooling": True},
    {"pooling_type": "avg", "ksize": [7, 7], "global_pooling": True,
     "data_format": "NHWC"}])
def test_pool2d_and_its_grad(x_dtype, attrs):
    rng = np.random.RandomState(6)
    x = _rand(rng, 2, 4, 7, 7)
    if attrs.get("data_format") == "NHWC":
        x = x.transpose(0, 2, 3, 1)
    fwd = _run_both("pool2d", {"X": (x, x_dtype)}, ["Out"], attrs)
    _assert_same(fwd)
    for dy_dtype in ACT:
        _assert_same(_run_both(
            "pool2d_grad",
            {"X": (x, x_dtype),
             "Out@GRAD": (_rand(rng, *fwd["Out"][1].shape), dy_dtype)},
            ["X@GRAD"], attrs))


@pytest.mark.parametrize("x_dtype", ACT)
def test_mul_and_its_grad(x_dtype):
    rng = np.random.RandomState(7)
    ins = {"X": (_rand(rng, 4, 2, 3, 3), x_dtype),
           "Y": (_rand(rng, 18, 10, scale=0.2), None)}
    attrs = {"x_num_col_dims": 1, "y_num_col_dims": 1}
    _assert_same(_run_both("mul", ins, ["Out"], attrs))
    for dy_dtype in ACT:
        _assert_same(_run_both(
            "mul_grad", {**ins, "Out@GRAD": (_rand(rng, 4, 10), dy_dtype)},
            ["X@GRAD", "Y@GRAD"], attrs))


@pytest.mark.parametrize("x_dtype", ACT)
def test_softmax_cross_entropy_mean_and_their_grads(x_dtype):
    """The black-listed head: softmax, cross_entropy, mean,
    softmax_with_cross_entropy, all in f32."""
    rng = np.random.RandomState(8)
    logits = _rand(rng, 4, 10)
    label = rng.randint(0, 10, (4, 1)).astype(np.int64)
    sm = _run_both("softmax", {"X": (logits, x_dtype)}, ["Out"])
    _assert_same(sm)
    probs = np.asarray(sm["Out"][0])
    _assert_same(_run_both("softmax_grad", {
        "X": (logits, x_dtype), "Out@GRAD": (_rand(rng, 4, 10), "f32")},
        ["X@GRAD"]))
    ce_ins = {"X": (probs, x_dtype), "Label": (label, None)}
    _assert_same(_run_both("cross_entropy", ce_ins, ["Y"]))
    _assert_same(_run_both("cross_entropy_grad", {
        **ce_ins, "Y@GRAD": (_rand(rng, 4, 1), "f32")}, ["X@GRAD"]))
    mean_ins = {"X": (_rand(rng, 4, 1), x_dtype)}
    _assert_same(_run_both("mean", mean_ins, ["Out"]))
    _assert_same(_run_both("mean_grad", {
        **mean_ins, "Out@GRAD": (np.ones(1, np.float32), "f32")},
        ["X@GRAD"]))
    swce = {"Logits": (logits, x_dtype), "Label": (label, None)}
    _assert_same(_run_both("softmax_with_cross_entropy", swce,
                           ["Softmax", "Loss"]))
    _assert_same(_run_both("softmax_with_cross_entropy_grad", {
        **swce, "Loss@GRAD": (_rand(rng, 4, 1), "f32")}, ["Logits@GRAD"]))


def test_cast_and_scale_of_the_uint8_feed():
    rng = np.random.RandomState(9)
    img = rng.randint(0, 256, (2, 3, 4, 4)).astype(np.uint8)
    cast = _run_both("cast", {"X": (img, None)}, ["Out"],
                     {"in_dtype": 20, "out_dtype": 5})
    _assert_same(cast)
    _assert_same(_run_both("scale", {"X": (np.asarray(cast["Out"][0]),
                                           None)}, ["Out"],
                           {"scale": 1 / 255.0}))


def _fused_inputs(rng, x_dtype, residual, co=8):
    x = _rand(rng, 2, 9, 9, 4) + 0.3
    w = _rand(rng, 3, 3, 4, co, scale=1 / 6)
    ins = {"Input": (x, x_dtype), "Filter": (w, None),
           **_bn_params(rng, co)}
    if residual:
        ins["Residual"] = (_rand(rng, 2, 9, 9, co), "bf16")
    return ins


@pytest.mark.parametrize("x_dtype", ACT)
@pytest.mark.parametrize("residual,act", [(False, "relu"), (True, "relu"),
                                          (False, "")])
@pytest.mark.parametrize("is_test", [False, True])
def test_fused_conv_bn_act(x_dtype, residual, act, is_test):
    rng = np.random.RandomState(10)
    ins = _fused_inputs(rng, x_dtype, residual)
    attrs = {"strides": [1, 1], "paddings": [1, 1], "epsilon": 1e-5,
             "momentum": 0.9, "act": act, "is_test": is_test}
    outs = ["Y", "MeanOut", "VarianceOut", "SavedMean", "SavedInvStd"]
    _assert_same(_run_both("fused_conv2d_bn_act", ins,
                           outs + ([] if is_test else ["ConvOut"]), attrs))


@pytest.mark.parametrize("x_dtype", ACT)
@pytest.mark.parametrize("residual,act", [(False, "relu"), (True, "relu"),
                                          (False, "")])
def test_fused_conv_bn_act_grad(x_dtype, residual, act):
    """The explicit grad from the forward's saved values: BN/relu grad
    math in f32, the two grad convs in bf16."""
    rng = np.random.RandomState(11)
    ins = _fused_inputs(rng, x_dtype, residual)
    attrs = {"strides": [1, 1], "paddings": [1, 1], "epsilon": 1e-5,
             "momentum": 0.9, "act": act}
    fwd = _run_both("fused_conv2d_bn_act", ins,
                    ["Y", "ConvOut", "SavedMean", "SavedInvStd"], attrs)
    # the reference's saved values feed both grads
    saved = {s: (np.asarray(fwd[s][0].astype(jnp.float32)),
                 "bf16" if s == "ConvOut" else None)
             for s in ("ConvOut", "SavedMean", "SavedInvStd")}
    dy = (_rand(rng, *fwd["Y"][1].shape), "bf16")
    outs = ["Input@GRAD", "Filter@GRAD", "Scale@GRAD", "Bias@GRAD"]
    if residual:
        outs.append("Residual@GRAD")
    _assert_same(_run_both("fused_conv2d_bn_act_grad",
                           {**ins, **saved, "Y@GRAD": dy}, outs, attrs))


# ------------------------------------------------------ the programs

def build(fluid, module, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = module.get_model(**kw)
    fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


def _params_for(arrays, main):
    block = main.desc.blocks[0]
    out = {}
    for name, v in arrays.items():
        if v.ndim == 4 and v.shape != tuple(block.vars[name].shape):
            v = np.ascontiguousarray(np.transpose(v, OIHW_TO_HWIO))
        out[name] = v
    return out


def _watched(main):
    """Activations whose dtype AMP decides: every conv / fused stage /
    batch_norm / add / relu / pool output, the fc product and the
    softmax."""
    names = []
    for op in main.desc.blocks[0].ops:
        if op.role:
            continue
        slot = {"conv2d": "Output", "fused_conv2d_bn_act": "Y",
                "batch_norm": "Y", "elementwise_add": "Out",
                "relu": "Out", "pool2d": "Out", "mul": "Out",
                "softmax": "Out"}.get(op.type)
        if slot:
            names.append(op.output(slot)[0])
    return names


@pytest.fixture(scope="module")
def amp_runs():
    """Reference and port, NCHW and NHWC fused, bn_bf16 off and on, 3
    Momentum steps of cifar10 depth 8 at batch 4 under AMP from the
    reference's NCHW startup parameters: {key: (losses, dtypes of the
    watched activations, grad dtypes, param dtypes)}."""
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    kw = dict(data_set="cifar10", depth=8)
    jmain0, jstart0, _ = build(jfluid, jresnet, **kw, data_format="NCHW",
                               fused_stages=False)
    persist = sorted(n for n, v in jmain0.desc.blocks[0].vars.items()
                     if v.persistable)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart0)
    init = {n: np.asarray(jscope.find_var(n)) for n in persist}
    rng = np.random.RandomState(0)
    feed = {"data": rng.rand(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    runs = {}
    jprev, tprev = JFLAGS.bn_bf16, TFLAGS.bn_bf16
    try:
        for bn in (False, True):
            _set_bn_bf16(bn)
            for fmt, fused in (("NCHW", False), ("NHWC", True)):
                jmain, _, jloss = build(jfluid, jresnet, **kw,
                                        data_format=fmt, fused_stages=fused)
                tmain, _, tloss = build(tfluid, tresnet, **kw,
                                        data_format=fmt, fused_stages=fused)
                params = _params_for(init, jmain)
                watched = _watched(tmain)
                grads = [p.name + "@GRAD" for p in tmain.all_parameters()
                         if p.trainable]
                fetch = [tloss.name] + watched + grads
                jscope = JScope()
                for n, v in params.items():
                    jscope.set(n, v)
                tscope = tfluid.Scope()
                set_scope_arrays(tscope, params, "cpu")
                jexe = jfluid.Executor(jfluid.CPUPlace())
                texe = tfluid.Executor(tfluid.CPUPlace())
                for pkg in ("jax", "port"):
                    losses = []
                    for _ in range(STEPS):
                        if pkg == "jax":
                            with jfluid.scope_guard(jscope):
                                out = jexe.run(jmain, feed=feed,
                                               fetch_list=fetch,
                                               return_numpy=False)
                            dtypes = [jnp.dtype(v.dtype).name for v in out]
                        else:
                            out = texe.run(tmain, feed=feed,
                                           fetch_list=fetch, scope=tscope,
                                           return_numpy=False)
                            dtypes = [str(v.dtype).replace("torch.", "")
                                      for v in out]
                        losses.append(float(np.asarray(
                            out[0].float() if pkg == "port"
                            else out[0]).ravel()[0]))
                    scope = jscope if pkg == "jax" else tscope
                    pdt = {p.name: str(np.asarray(scope.find_var(p.name))
                                       .dtype if pkg == "jax" else
                                       scope.find_var(p.name).dtype)
                           .replace("torch.", "")
                           for p in tmain.all_parameters()}
                    n = len(watched)
                    runs[(pkg, fmt, bn)] = (
                        losses, dict(zip(watched, dtypes[1:1 + n])),
                        dict(zip(grads, dtypes[1 + n:])), pdt)
    finally:
        JFLAGS.bn_bf16, TFLAGS.bn_bf16 = jprev, tprev
        torch.set_num_threads(prev)
    return runs


PROGRAMS = [("NCHW", False), ("NCHW", True), ("NHWC", False),
            ("NHWC", True)]


@pytest.mark.parametrize("fmt,bn", PROGRAMS)
def test_amp_losses_track_the_reference(amp_runs, fmt, bn):
    want = amp_runs[("jax", fmt, bn)][0]
    got = amp_runs[("port", fmt, bn)][0]
    np.testing.assert_allclose(got, want, rtol=LOSS_RTOL)
    assert got[-1] < got[0]


@pytest.mark.parametrize("fmt,bn", PROGRAMS)
def test_amp_activation_dtypes_are_the_references(amp_runs, fmt, bn):
    want = amp_runs[("jax", fmt, bn)][1]
    got = amp_runs[("port", fmt, bn)][1]
    assert got == want
    # the products really ran in bf16
    assert "bfloat16" in got.values()


@pytest.mark.parametrize("fmt,bn", PROGRAMS)
def test_amp_parameters_and_gradients_stay_float32(amp_runs, fmt, bn):
    _, _, grads, params = amp_runs[("port", fmt, bn)]
    assert set(grads.values()) == {"float32"}
    assert set(params.values()) == {"float32"}
    assert amp_runs[("jax", fmt, bn)][2] == grads


def test_amp_on_an_sp_mesh_is_refused():
    """(Its name is kept from when the ring had no bf16 form.)  An AMP
    program on a mesh whose sp axis is > 1 runs the ring on bf16 Q/K/V
    and matches the same program run dense under AMP from the same
    parameters: the loss within rtol 1e-3 and each parameter gradient
    within 2e-2 in relative Frobenius norm (the ring's Out is one bf16
    rounding of another f32 sum than the flash kernel's, and its
    gradients sum two bf16-rounded steps), all float32."""
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        loss, _, _ = ttransformer.get_model(
            vocab_size=16, seq_len=8, d_model=8, n_head=2, n_layers=1,
            d_ff=16, sp=True)
    tfluid.transpiler.Float16Transpiler().transpile(main)
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(startup, scope=scope)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    dense = tfluid.Scope()
    set_scope_arrays(dense, get_scope_arrays(scope, persist), "cpu")
    toks = np.random.RandomState(0).randint(0, 16, (2, 9))
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    fetch = [loss.name] + sorted(p.name + "@GRAD"
                                 for p in main.all_parameters())
    mesh = make_mesh({"sp": 2}, [torch.device("cpu")] * 2)
    got = ExecutorCore(tfluid.CPUPlace(), mesh=mesh).run(
        main.desc, scope, 0, feed, fetch)
    want = tfluid.Executor(tfluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=dense)
    assert np.isfinite(got[0]).all()
    np.testing.assert_allclose(got[0], want[0], rtol=1e-3)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        assert a.dtype == np.float32, name
        assert np.linalg.norm(a - b) <= 2e-2 * np.linalg.norm(b), name
