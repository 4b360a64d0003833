"""The port's fluid front-end and Executor against the JAX package's.

Programs built by ``paddle_tpu_torch.fluid`` serialize to the same
bytes as ``paddle_tpu.fluid``'s; the Executor runs a startup and a main
program on the CPU with the JAX package's feed contract; a scope's
values move across devices and frameworks as numpy arrays.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.core import executor_impl
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import transformer as ttransformer

SMALL = dict(vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layers=2,
             d_ff=64)


def build(fluid, module, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, feeds, _ = module.get_model(**{**SMALL, **kw})
    return main, startup, loss, feeds


@pytest.mark.parametrize("kw", [{}, {"n_layers": 1, "learning_rate": 0.01},
                                {"d_model": 64, "n_head": 4, "d_ff": 32}])
def test_transformer_desc_is_byte_identical(kw):
    jmain, jstart, _, _ = build(jfluid, jtransformer, **kw)
    tmain, tstart, _, _ = build(tfluid, ttransformer, **kw)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()


def test_desc_round_trips_through_the_port():
    jmain, _, _, _ = build(jfluid, jtransformer)
    data = jmain.desc.serialize_to_string()
    prog = tfluid.Program.parse_from_string(data)
    assert prog.desc.serialize_to_string() == data
    assert prog.clone().desc.serialize_to_string() == data


def test_program_ops_are_the_slice():
    tmain, tstart, _, _ = build(tfluid, ttransformer)
    assert {op.type for op in tstart.desc.blocks[0].ops} == \
        {"uniform_random", "fill_constant"}
    fwd = {op.type for op in tmain.desc.blocks[0].ops
           if not op.type.endswith("_grad")}
    assert fwd == {"lookup_table", "elementwise_add", "layer_norm", "mul",
                   "reshape", "transpose", "ring_attention", "relu",
                   "softmax_with_cross_entropy", "mean", "fill_constant",
                   "sum", "adam"}


@pytest.mark.parametrize("kw", [{"tp": True}, {"sp": True, "tp": True},
                                {"moe_experts": 2}, {"ep": True}])
def test_unported_model_options_raise(kw):
    """tp, sp+tp, moe_experts and ep build, and their programs run
    dense on a plain CPU Executor; a mesh whose tp or ep axis is larger
    than 1 asks for tensor or expert parallelism, which is not ported,
    and raises."""
    tmain, tstart, loss, _ = build(tfluid, ttransformer, **kw)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    out, = exe.run(tmain, feed=_feed(0), fetch_list=[loss], scope=scope)
    assert np.isfinite(out).all()
    axis = "tp" if kw.get("tp") else "ep"
    axes = {"sp": 2, axis: 2} if kw.get("sp") else {axis: 2}
    with pytest.raises(NotImplementedError, match="%s=2" % axis):
        tfluid.ParallelExecutor(use_cuda=False, mesh_axes=axes,
                                main_program=tmain, scope=scope)


def _feed(seed, batch=2):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, SMALL["vocab_size"],
                       (batch, SMALL["seq_len"] + 1)).astype(np.int64)
    return {"src": toks[:, :-1], "label": toks[:, 1:, None]}


def test_startup_is_seeded_and_inside_its_initializers():
    _, tstart, _, _ = build(tfluid, ttransformer)
    exe = tfluid.Executor(tfluid.CPUPlace())
    names = sorted(n for n, v in tstart.desc.blocks[0].vars.items()
                   if v.persistable)
    runs = []
    for _ in range(2):
        scope = tfluid.Scope()
        exe.run(tstart, scope=scope)
        runs.append(get_scope_arrays(scope, names))
    for n in names:
        np.testing.assert_array_equal(runs[0][n], runs[1][n])
    w = runs[0]["blk0_fc1.w_0"]                       # Xavier, 32 x 64
    limit = np.sqrt(6.0 / (32 + 64))
    assert w.shape == (32, 64) and np.abs(w).max() <= limit
    assert np.unique(w).size == w.size
    np.testing.assert_array_equal(runs[0]["blk0_fc1.b_0"], 0.0)
    np.testing.assert_array_equal(runs[0]["learning_rate_0"],
                                  np.float32([0.001]))


def test_executor_runs_startup_and_main_and_writes_back_persistables():
    tmain, tstart, loss, _ = build(tfluid, ttransformer)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    before = get_scope_arrays(scope, ["blk0_fc1.w_0", "pos_emb"])
    out, = exe.run(tmain, feed=_feed(0), fetch_list=[loss], scope=scope)
    assert out.shape == (1,) and np.isfinite(out).all()
    after = get_scope_arrays(scope, ["blk0_fc1.w_0", "pos_emb"])
    for n in before:
        assert not np.array_equal(before[n], after[n])
    # non-persistable values do not land in the scope
    assert not scope.has_var(loss.name)
    assert not scope.has_var("src")


def test_int64_feeds_stay_int64_and_out_of_range_raises():
    tmain, tstart, _, _ = build(tfluid, ttransformer)
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(tstart, scope=scope)
    feed = _feed(1)
    src, = exe.run(tmain, feed=feed, fetch_list=["src"], scope=scope)
    assert src.dtype == np.int64
    np.testing.assert_array_equal(src, feed["src"])
    bad = dict(feed, src=feed["src"] + 2 ** 31)
    with pytest.raises(ValueError, match="int32 range"):
        exe.run(tmain, feed=bad, scope=scope)


def test_free_plan_drops_values_after_their_last_reader():
    tmain, _, loss, _ = build(tfluid, ttransformer)
    block = tmain.desc.blocks[0]
    plan = executor_impl._free_plan(block, block.ops, {loss.name})
    dropped = {n: i for i, names in plan.items() for n in names}
    assert loss.name not in dropped
    assert not any(block.find_var_recursive(n).persistable
                   for n in dropped if block.find_var_recursive(n))
    # every activation is dropped, at the last op that touches it
    for n, i in dropped.items():
        assert all(n not in op.input_arg_names() + op.output_arg_names()
                   for op in block.ops[i + 1:])
    assert "src" in dropped and loss.name + "@GRAD" in dropped


def test_executor_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor()
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Executor(tfluid.CUDAPlace(0))
    with pytest.raises(RuntimeError, match="CUDA"):
        set_scope_arrays(tfluid.Scope(), {"x": np.zeros(2)})


def test_scope_arrays_round_trip():
    scope = tfluid.Scope()
    arrays = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
              "b": np.asarray([3], np.int64)}
    set_scope_arrays(scope, arrays, "cpu")
    assert isinstance(scope.find_var("a"), torch.Tensor)
    back = get_scope_arrays(scope, ["a", "b"])
    for n, a in arrays.items():
        assert back[n].dtype == a.dtype
        np.testing.assert_array_equal(back[n], a)
