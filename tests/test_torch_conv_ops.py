"""The ResNet slice's ops and the conv-stage kernel's plain version in the
port against the JAX package, on the CPU.

- Each op of the ResNet training step (and the optest grad heads')
  replays its ``SPECS`` entry of ``tools/tpu_optest.py``: the one-op
  program built with ``paddle_tpu.fluid``, its desc run by the port, every
  output (and, where the spec has ``grad``, every gradient of its
  weighted scalar head) held against the JAX package's run at the
  spec's own tolerance;
- ``gaussian_random`` cannot draw the JAX package's numbers (another
  generator): shape, dtype and moments;
- ``conv2d_nhwc``'s plain version (what a CPU tensor runs, and what K6
  is held against on the card) against the reference's Pallas kernel in
  interpret mode, at ResNet stage shapes in miniature, in every
  epilogue mode, at the tolerances of ``tests/test_conv_fused.py``;
- build-time shape inference of the new ops infers what the JAX
  package's abstract evaluation does.
"""
import importlib.util
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.kernels import conv_fused as jconv
from paddle_tpu_torch.core.scope import Scope as PortScope
from paddle_tpu_torch.kernels import conv_fused as tconv

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "tpu_optest", os.path.join(REPO, "tools", "tpu_optest.py"))
optest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(optest)

RESNET_OPS = ["conv2d", "pool2d", "batch_norm", "softmax", "cross_entropy",
              "top_k", "accuracy", "momentum", "cast", "scale",
              "fused_conv2d_bn_act"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run_in_port(main, feed, fetch_names):
    """Run a ``paddle_tpu.fluid`` program's desc in the port on the CPU."""
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    outs = tfluid.Executor(tfluid.CPUPlace()).run(
        prog, feed=feed, fetch_list=fetch_names, scope=PortScope())
    return dict(zip(fetch_names, outs))


def _check(name, ref, got, tol):
    err = optest._compare(name, ref, got, *tol)
    assert err is None, err


@pytest.mark.parametrize("op", RESNET_OPS)
def test_op_replays_its_spec(op):
    s = optest.SPECS[op]
    t = optest._make_optest(op, s)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)
    for n in names:
        _check(n, ref[n], got[n], s["tol"])
    if not s["grad"]:
        return
    # as tools/tpu_optest.py does: the grad head needs the outputs'
    # true shapes, taken from the reference run
    t2 = optest._make_optest(op, s)
    outs2 = {}
    for slot, val in t.outputs.items():
        entries = val if isinstance(val, list) else [(slot, val)]
        outs2[slot] = [(n, ref[n]) for n, _ in entries] \
            if isinstance(val, list) else ref[entries[0][0]]
    t2.outputs = outs2
    gmain, _, gfeed, gnames = optest._grad_program(t2, s["grad"])
    assert any(o.type == op + "_grad" for o in gmain.desc.blocks[0].ops)
    g_ref = optest._run_on(jfluid.CPUPlace(), gmain, gfeed, gnames)
    g_got = run_in_port(gmain, gfeed, gnames)
    for n, a in zip(gnames, g_ref):
        _check(n, a, g_got[n], s["tol"])


@pytest.mark.parametrize("variant", [
    ("pool2d", {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
                "paddings": [1, 1], "exclusive": True}),
    ("pool2d", {"pooling_type": "avg", "ksize": [3, 3], "strides": [2, 2],
                "paddings": [1, 1], "exclusive": False}),
    ("pool2d", {"pooling_type": "avg", "global_pooling": True,
                "data_format": "NHWC"}),
    ("conv2d", {"strides": [2, 2], "paddings": [1, 1],
                "data_format": "NHWC", "filter_format": "HWIO"}),
    ("batch_norm", {"data_layout": "NHWC"}),
    ("batch_norm", {"is_test": True}),
    ("momentum", {"use_nesterov": True}),
    ("fused_conv2d_bn_act", {"is_test": True}),
    ("fused_conv2d_bn_act", {"act": "", "strides": [2, 2]}),
])
def test_op_variant_replays(variant):
    """The spec's op with other attrs: the layouts the NHWC pass pins,
    avg pooling (exclusive or not, padded, global), test mode."""
    op, attrs = variant
    s = optest.SPECS[op]
    t = optest._make_optest(op, s)
    t.attrs = dict(s["attrs"], **attrs)
    if attrs.get("data_format") == "NHWC" or \
            attrs.get("data_layout") == "NHWC":
        slot = "Input" if op == "conv2d" else "X"
        t.inputs = dict(t.inputs, **{slot: np.ascontiguousarray(
            t.inputs[slot].transpose(0, 2, 3, 1))})
        if op == "conv2d":
            t.inputs["Filter"] = np.ascontiguousarray(
                t.inputs["Filter"].transpose(2, 3, 1, 0))
    # test mode writes no ConvOut
    names = [n for n in optest._fetch_names(t)
             if not (attrs.get("is_test") and n == "ConvOut")]
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)
    for n in names:
        _check(n, ref[n], got[n], s["tol"])


def test_gaussian_random_replays_its_spec():
    """A random op cannot match the JAX package's numbers: its shape,
    dtype and moments must, and a seeded draw repeats."""
    s = optest.SPECS["gaussian_random"]
    t = optest._make_optest("gaussian_random", s)
    t.attrs = dict(s["attrs"], shape=[256, 64], mean=0.5, std=2.0)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)["Out"]
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)["Out"]
    assert got.shape == ref.shape and got.dtype == ref.dtype
    # 16384 draws: the sample mean's standard error is 2 / 128
    assert abs(got.mean() - 0.5) < 0.06 and abs(got.std() - 2.0) < 0.06
    t.attrs = dict(t.attrs, seed=17)
    main, _, feed = t._build()
    a = run_in_port(main, feed, names)["Out"]
    b = run_in_port(main, feed, names)["Out"]
    np.testing.assert_array_equal(a, b)


def test_fused_op_force_xla_raises_on_cuda_only():
    """``force_xla`` selects the reference's XLA branch; on the CPU the
    port's plain version is that branch, on the card there is only K6."""
    s = optest.SPECS["fused_conv2d_bn_act"]
    t = optest._make_optest("fused_conv2d_bn_act", s)
    t.attrs = dict(s["attrs"], force_xla=True)
    main, _, feed = t._build()
    got = run_in_port(main, feed, ["Y"])["Y"]
    assert got.shape == (2, 8, 8, 4)


# ------------------------------------------------- K6's plain version

# (h, ci, co, k, stride, pad): the ResNet stage shapes in miniature --
# 3x3 s1 residual stage, 3x3 s2 downsample, 7x7 s2 stem, 1x1 s1 and s2
STAGES = [(8, 4, 8, 3, 1, 1), (8, 4, 8, 3, 2, 1), (12, 3, 8, 7, 2, 3),
          (8, 8, 16, 1, 1, 0), (8, 8, 16, 1, 2, 0)]
MODES = ["stats", "plain", "affine", "affine_res_relu", "res_relu",
         "stats_affine_res_relu"]


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("mode", MODES)
def test_plain_conv_stage_matches_the_pallas_kernel(stage, mode):
    h, ci, co, k, s, p = stage
    rng = np.random.RandomState(0)
    x = rng.randn(2, h, h, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * 0.2).astype(np.float32)
    ho = (h + 2 * p - k) // s + 1
    kw = {}
    if "affine" in mode:
        kw["affine"] = ((rng.rand(co) + 0.5).astype(np.float32),
                        rng.randn(co).astype(np.float32))
    if "res" in mode:
        kw["residual"] = rng.randn(2, ho, ho, co).astype(np.float32)
    if "relu" in mode:
        kw["act"] = "relu"
    stats = "stats" in mode

    def conv(mod, arr, **extra):
        args = {n: (tuple(arr(t) for t in v) if n == "affine" else
                    arr(v) if n == "residual" else v)
                for n, v in kw.items()}
        return mod.conv2d_nhwc(arr(x), arr(w), (s, s), (p, p), stats=stats,
                               **args, **extra)

    want = conv(jconv, jnp.asarray, interpret=True)
    got = conv(tconv, torch.from_numpy)
    if not stats:
        want, got = (want,), (got,)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]),
                               rtol=1e-4, atol=1e-4)
    for g, r in zip(got[1:], want[1:]):     # the stats: sums over N*Ho*Wo
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-3,
                                   atol=1e-3)


def test_fused_reference_matches_the_references():
    rng = np.random.RandomState(1)
    h, ci, co, k, s, p = 8, 4, 8, 3, 1, 1
    arrs = dict(x=rng.randn(2, h, h, ci), w=rng.randn(k, k, ci, co) * 0.2,
                scale=rng.rand(co) + 0.5, bias=rng.randn(co),
                mean=rng.randn(co) * 0.1, var=rng.rand(co) + 0.5,
                residual=rng.randn(2, h, h, co))
    arrs = {n: v.astype(np.float32) for n, v in arrs.items()}
    kw = dict(strides=(s, s), paddings=(p, p), eps=1e-5, act="relu")
    want = jconv.fused_conv_bn_act_reference(
        **{n: jnp.asarray(v) for n, v in arrs.items()}, **kw)
    got = tconv.fused_conv_bn_act_reference(
        **{n: torch.from_numpy(v) for n, v in arrs.items()}, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_conv_stage_rejects_bad_operands():
    x = torch.zeros(1, 4, 4, 3)
    with pytest.raises(ValueError, match="channels"):
        tconv.conv2d_nhwc(x, torch.zeros(3, 3, 4, 8))
    with pytest.raises(ValueError, match="activation"):
        tconv.conv2d_nhwc(x, torch.zeros(3, 3, 3, 8), act="gelu")
    with pytest.raises(ValueError, match="residual"):
        tconv.conv2d_nhwc(x, torch.zeros(3, 3, 3, 8),
                          residual=torch.zeros(1, 4, 4, 8))
    with pytest.raises(ValueError, match="device"):
        tconv.conv2d_nhwc(x.to("meta"), torch.zeros(3, 3, 3, 8,
                                                    device="meta"))


# ------------------------------------------------- shape inference

@pytest.mark.parametrize("op", RESNET_OPS)
def test_meta_shape_inference_matches_jax(op):
    """Build-time shape inference of each new op (``infer_shape`` where
    registered, else the lowering on meta tensors) infers what the JAX
    package's abstract evaluation does, -1 batch dims included."""
    from paddle_tpu.core import lowering as jlow
    from paddle_tpu.core import types as jtypes
    from paddle_tpu_torch.core import lowering as tlow
    from paddle_tpu_torch.core import types as ttypes

    t = optest._make_optest(op, optest.SPECS[op])
    main, _, _ = t._build()
    block = main.desc.blocks[0]
    op0 = block.ops[0]
    for slot in ("X", "Input", "Indices", "Label"):
        for name in op0.inputs.get(slot, []):
            vd = block.vars[name]
            vd.shape = (-1,) + tuple(vd.shape[1:])
    want = jlow.infer_op_outputs(main.desc, block, op0)
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    tblock = prog.desc.blocks[0]
    got = tlow.infer_op_outputs(prog.desc, tblock, tblock.ops[0])
    assert sorted(got) == sorted(want)
    for n, (shape, dtype) in want.items():
        assert got[n][0] == tuple(shape), n
        assert ttypes.np_dtype_to_proto(got[n][1]) == \
            jtypes.np_dtype_to_proto(dtype), n
