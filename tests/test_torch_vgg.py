"""VGG16-BN (``models/vgg.py``, the bench entry's ``vgg``) and the ops it
brings, in the port against the JAX package, on the CPU.

- ``matmul`` (transposes and ``alpha``) and adaptive ``pool2d`` (max
  and avg, NCHW and NHWC) replay their ``SPECS`` entries at the spec's
  tolerance, forward and grad;
- ``vgg.get_model`` builds the reference's ProgramDesc, byte for byte
  (the same op list); SGD, nets and the dropout layer included;
- three Adam steps of cifar10 VGG16-BN at batch 2, from the reference's
  startup values, with the reference's dropout masks put in through
  ``ops/random.keep_mask`` (each dropout op's Mask, fetched from the
  reference's step): the step-1 loss at rtol 1e-4, the step-1
  gradients within twice the reference's own distance from a float64
  step, the later losses within 10 % (the test's docstring says why).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import vgg as jvgg
from paddle_tpu_torch.fluid.io import set_scope_arrays
from paddle_tpu_torch.models import vgg as tvgg
from paddle_tpu_torch.ops import random as prandom
from test_torch_ops import optest, replay_spec

STEPS = 3
BATCH = 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("attrs", [
    {}, {"transpose_X": True}, {"transpose_Y": True, "alpha": 0.5}])
def test_matmul_replays_its_spec(attrs):
    s = optest.SPECS["matmul"]
    x, y = s["inputs"]["X"], s["inputs"]["Y"]
    inputs = {"X": np.ascontiguousarray(x.swapaxes(-1, -2))
              if attrs.get("transpose_X") else x,
              "Y": np.ascontiguousarray(y.swapaxes(-1, -2))
              if attrs.get("transpose_Y") else y}
    replay_spec("matmul", dict(s, inputs=inputs,
                               attrs=dict(s["attrs"], **attrs)))


@pytest.mark.parametrize("ptype", ["max", "avg"])
@pytest.mark.parametrize("layout", ["NCHW", "NHWC"])
def test_adaptive_pool2d_replays_its_spec(ptype, layout):
    """``SPECS["pool2d"]`` with ``adaptive=True``: its [2, 3, 8, 8]
    input pooled to 2 x 2 bins (ksize), in NCHW and, transposed, in
    NHWC."""
    s = optest.SPECS["pool2d"]
    x = s["inputs"]["X"]
    attrs = dict(s["attrs"], adaptive=True, pooling_type=ptype)
    if layout == "NHWC":
        x = np.ascontiguousarray(x.transpose(0, 2, 3, 1))
        attrs["data_format"] = "NHWC"
    replay_spec("pool2d", dict(s, inputs={"X": x}, attrs=attrs))


def build(fluid, module, data_set="cifar10"):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, (data, label), _ = module.get_model(data_set=data_set)
    return main, startup, loss


@pytest.mark.parametrize("data_set", ["cifar10", "flowers"])
def test_vgg_serializes_as_the_reference(data_set):
    jmain, jstart, _ = build(jfluid, jvgg, data_set)
    tmain, tstart, _ = build(tfluid, tvgg, data_set)
    ops = [op.type for op in tmain.desc.blocks[0].ops]
    assert ops == [op.type for op in jmain.desc.blocks[0].ops]
    assert ops.count("dropout") == 10 and ops.count("dropout_grad") == 10
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()


def _masks_of(main):
    """The Mask vars of the block's dropout ops, in op order."""
    return [op.output("Mask")[0] for op in main.desc.blocks[0].ops
            if op.type == "dropout"]


def _grads_of(main):
    return [p.name + "@GRAD" for p in main.all_parameters()
            if p.name + "@GRAD" in main.desc.blocks[0].vars]


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = float(np.linalg.norm(a - b))
    return d / max(float(np.linalg.norm(b)), 1e-30) if d else 0.0


def test_vgg_trains_as_the_reference_with_its_masks(monkeypatch):
    """Three Adam steps from the reference's startup values with its
    masks.  Batch norm over two images makes the step ill-conditioned:
    moving the input by one float32 ulp moves the port's own weight
    gradients by ~0.2-1 % (relative Frobenius norm), and the reference's
    CPU convolution gradients sit ~1 % from a float64 step at this
    model's block 3 (the port's ~1e-5; measured at batch 8, where the
    spread is 1e-5).  So the step-1 loss is held at rtol 1e-4, and
    every step-1 gradient within twice the reference's distance (or
    1e-4, the larger) from a float64 step of the same program
    (relative Frobenius norm), and so within three times it of the
    reference's gradient; a bias under batch norm, whose exact
    gradient is 0, below 1e-4.  Past step 1 the reference's error moves its
    trajectory: the losses of steps 2 and 3 are held to 10 % (5.5 %
    apart at step 3 here)."""
    jmain, jstart, jloss = build(jfluid, jvgg)
    masks, grads = _masks_of(jmain), _grads_of(jmain)
    jmain.random_seed = 1
    rng = np.random.RandomState(0)
    feeds = [{"data": rng.rand(BATCH, 3, 32, 32).astype(np.float32),
              "label": rng.randint(0, 10, (BATCH, 1)).astype(np.int64)}
             for _ in range(STEPS)]
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    init = {n: np.array(jscope.find_var(n)) for n in persist}
    want, want_g, step_masks = [], None, []
    for f in feeds:
        out = jexe.run(jmain, feed=f, fetch_list=[jloss] + masks + grads,
                       scope=jscope)
        want.append(float(np.ravel(out[0])[0]))
        step_masks.append(dict(zip(masks, out[1:1 + len(masks)])))
        if want_g is None:
            want_g = dict(zip(grads, out[1 + len(masks):]))

    current = {}

    def reference_keep(ctx, shape, keep_prob, seed=0):
        m = current[ctx.op.output("Mask")[0]]
        assert m.shape == tuple(shape)
        return torch.from_numpy(np.array(m != 0))

    monkeypatch.setattr(prandom, "keep_mask", reference_keep)
    tmain, _, tloss = build(tfluid, tvgg)
    exe = tfluid.Executor(tfluid.CPUPlace())

    def port(feeds):
        scope = tfluid.Scope()
        set_scope_arrays(scope, init, "cpu")
        losses, first = [], None
        for f, m in zip(feeds, step_masks):
            current.clear()
            current.update(m)
            out = exe.run(tmain, feed=f, fetch_list=[tloss] + grads,
                          scope=scope)
            losses.append(float(np.ravel(out[0])[0]))
            if first is None:
                first = dict(zip(grads, out[1:]))
        return losses, first

    got, got_g = port(feeds)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-4)
    # steps 2 and 3 carry the reference's own ~1 % gradient error
    # through Adam and batch norm over two images: held loosely
    np.testing.assert_allclose(got[1:], want[1:], rtol=0.1)
    assert all(np.isfinite(got))
    # step 1's gradients against a float64 step of the same program
    tmain = _as_float64(tmain)
    scope = tfluid.Scope()
    set_scope_arrays(scope, {n: v.astype(np.float64)
                             if v.dtype == np.float32 else v
                             for n, v in init.items()}, "cpu")
    current.clear()
    current.update(step_masks[0])
    out = exe.run(tmain, feed={k: v.astype(np.float64)
                               if v.dtype == np.float32 else v
                               for k, v in feeds[0].items()},
                  fetch_list=grads, scope=scope)
    exact = dict(zip(grads, out))
    for g in grads:
        if np.abs(exact[g]).max() < 1e-4:
            # a bias under batch norm: its exact gradient is 0
            assert np.abs(got_g[g]).max() < 1e-4, g
            continue
        gap, ref_err = _rel(got_g[g], want_g[g]), _rel(want_g[g], exact[g])
        bar = max(1e-4, ref_err)
        assert _rel(got_g[g], exact[g]) <= 2 * bar, (g, ref_err)
        assert gap <= 3 * bar, (g, gap, ref_err)


def _as_float64(main):
    """A copy of ``main`` whose float32 vars and fills are float64."""
    from paddle_tpu_torch.core.types import DataType

    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    for vd in prog.desc.blocks[0].vars.values():
        if vd.dtype == DataType.FP32:
            vd.dtype = DataType.FP64
    for op in prog.desc.blocks[0].ops:
        if op.attr("dtype", None) == DataType.FP32:
            op.set_attr("dtype", DataType.FP64)
    return prog
