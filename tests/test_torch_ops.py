"""The port's ops replay the JAX package's op tests.

For each op of the transformer LM's training step (and the ops the
gradient heads of those tests add), the one-op program of its
``SPECS`` entry in ``tools/tpu_optest.py`` is built with
``paddle_tpu.fluid``; its desc is serialized, parsed by the port and run
there, and every output is held against the JAX package's run of the
same desc at the spec's own tolerance.  Where the spec has ``grad``,
the same is done for its gradient program (``_grad_program``: weighted
scalar head + ``calc_gradient``), which runs the ops' ``*_grad``
lowerings.
"""
import importlib.util
import os

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu_torch.core.scope import Scope as PortScope

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location(
    "tpu_optest", os.path.join(REPO, "tools", "tpu_optest.py"))
optest = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(optest)

# the op types of the transformer LM's step, plus the optest grad heads'
SLICE_OPS = ["elementwise_add", "relu", "mul", "sum", "mean", "reshape",
             "transpose", "fill_constant", "lookup_table",
             "lookup_table_grad", "layer_norm",
             "softmax_with_cross_entropy", "adam", "ring_attention",
             "assign", "elementwise_mul", "reduce_sum"]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def run_in_port(main, feed, fetch_names):
    """Run a ``paddle_tpu.fluid`` program's desc in the port on the CPU."""
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    exe = tfluid.Executor(tfluid.CPUPlace())
    outs = exe.run(prog, feed=feed, fetch_list=fetch_names,
                   scope=PortScope())
    return dict(zip(fetch_names, outs))


def _check(name, ref, got, tol):
    err = optest._compare(name, ref, got, *tol)
    assert err is None, err


@pytest.mark.parametrize("op", SLICE_OPS)
def test_op_replays_its_spec(op):
    replay_spec(op)


def replay_spec(op):
    """Run ``op``'s SPECS entry (and its gradient program, where the
    spec has ``grad``) in both packages; hold every output at the
    spec's tolerance."""
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
    g_ref = optest._run_on(jfluid.CPUPlace(), gmain, gfeed, gnames)
    g_got = run_in_port(gmain, gfeed, gnames)
    for n, a in zip(gnames, g_ref):
        _check(n, a, g_got[n], s["tol"])


def test_uniform_random_replays_its_spec():
    """A random op cannot match the JAX package's numbers (another
    generator): its shape, dtype and range must, and a seeded draw
    repeats."""
    s = optest.SPECS["uniform_random"]
    t = optest._make_optest("uniform_random", s)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)["Out"]
    assert got.shape == ref["Out"].shape and got.dtype == ref["Out"].dtype
    assert got.min() >= s["attrs"]["min"] and got.max() < s["attrs"]["max"]
    assert np.unique(got).size == got.size
    t.attrs = dict(s["attrs"], seed=17)
    main, _, feed = t._build()
    a = run_in_port(main, feed, names)["Out"]
    b = run_in_port(main, feed, names)["Out"]
    np.testing.assert_array_equal(a, b)


def test_lookup_table_grad_sparse_raises():
    s = optest.SPECS["lookup_table_grad"]
    t = optest._make_optest("lookup_table_grad", s)
    t.attrs = dict(s["attrs"], is_sparse=True)
    main, _, feed = t._build()
    with pytest.raises(NotImplementedError, match="SelectedRows"):
        run_in_port(main, feed, optest._fetch_names(t))


def _sp_spec():
    s = optest.SPECS["ring_attention"]
    t = optest._make_optest("ring_attention", s)
    t.attrs = dict(s["attrs"], sp_axis="sp")
    return s, t


def test_ring_attention_sp_axis_raises():
    """With sp_axis set, a mesh whose batch axis (dp) is > 1 asks for
    data parallelism, which is not ported: the op raises."""
    from paddle_tpu_torch.core.executor_impl import ExecutorCore
    from paddle_tpu_torch.parallel import make_mesh

    _, t = _sp_spec()
    main, _, feed = t._build()
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    mesh = make_mesh({"dp": 2, "sp": 2}, ["cpu"] * 4)
    core = ExecutorCore(tfluid.CPUPlace(), mesh=mesh)
    with pytest.raises(NotImplementedError, match="ring_attention over "
                       "batch_axis='dp'"):
        core.run(prog.desc, PortScope(), 0, feed, optest._fetch_names(t))


def test_ring_attention_sp_axis_without_mesh_runs_dense():
    """With sp_axis set and no mesh, the op runs the dense path and
    replays its spec, as the JAX package's op does (the port used to
    raise here)."""
    s, t = _sp_spec()
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)
    for n in names:
        _check(n, ref[n], got[n], s["tol"])


@pytest.mark.parametrize("op", ["ring_attention", "mul", "layer_norm",
                                "transpose", "relu", "mean",
                                "softmax_with_cross_entropy"])
def test_meta_shape_inference_matches_jax(op):
    """Build-time shape inference on meta tensors infers what the JAX
    package's abstract evaluation does, -1 batch dims included."""
    from paddle_tpu.core import lowering as jlow
    from paddle_tpu_torch.core import lowering as tlow
    from paddle_tpu_torch.core import types as ttypes
    from paddle_tpu.core import types as jtypes

    s = optest.SPECS[op]
    t = optest._make_optest(op, s)
    main, _, _ = t._build()
    block = main.desc.blocks[0]
    op0 = block.ops[0]
    # activations (not weights) get a dynamic batch dim
    for slot in ("X", "Q", "K", "V", "Logits", "Label"):
        for name in op0.inputs.get(slot, []):
            vd = block.vars[name]
            vd.shape = (-1,) + tuple(vd.shape[1:])
    want = jlow.infer_op_outputs(main.desc, block, op0)
    prog = tfluid.Program.parse_from_string(main.desc.serialize_to_string())
    tblock = prog.desc.blocks[0]
    got = tlow.infer_op_outputs(prog.desc, tblock, tblock.ops[0])
    assert sorted(got) == sorted(want)
    for n, (shape, dtype) in want.items():
        assert got[n][0] == tuple(shape)
        assert ttypes.np_dtype_to_proto(got[n][1]) == \
            jtypes.np_dtype_to_proto(dtype)
