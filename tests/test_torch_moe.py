"""The tensor-parallel and mixture-of-experts LM programs in the port
against the JAX package's, on the CPU at a small size (vocab 64,
sequence 16, d_model 32, 2 heads, 2 layers, d_ff 64, batch 2).

``tp`` only annotates the block weights' sharding, and ``moe_experts``
swaps the second layer's FFN for a top-1 ``moe_ffn`` block (its expert
weights sharded over ``ep`` with ``ep``).  Off a mesh both packages run
these programs dense, so the port builds the same bytes and trains to
the same losses.  The reference's startup program draws the parameters;
they are carried into the port's scope as numpy arrays.  Tolerances,
with their reasons:

- loss at each of 3 Adam steps: rtol 1e-4 (the same f32 math in another
  order);
- every parameter after step 3: atol 1e-4, 3 % of the 3e-3 that three
  Adam steps at lr 1e-3 can move a weight;
- ``moe_ffn`` alone: its ``SPECS`` entry's own tolerances.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.core.executor_impl import ExecutorCore
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parallel import make_mesh
from test_torch_ops import replay_spec

SMALL = dict(vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layers=2,
             d_ff=64)
STEPS = 3
OPTIONS = {"tp": {"tp": True}, "sp_tp": {"sp": True, "tp": True},
           "moe": {"moe_experts": 2},
           "moe_ep": {"moe_experts": 2, "ep": True}, "ep": {"ep": True}}


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def build(fluid, module, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = module.get_model(**SMALL, **kw)
    return main, startup, loss


def feeds(seed, batch=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.randint(0, SMALL["vocab_size"],
                           (batch, SMALL["seq_len"] + 1)).astype(np.int64)
        out.append({"src": toks[:, :-1], "label": toks[:, 1:, None]})
    return out


@pytest.mark.parametrize("name", list(OPTIONS))
def test_desc_is_byte_identical(name):
    jmain, jstart, _ = build(jfluid, jtransformer, **OPTIONS[name])
    tmain, tstart, _ = build(tfluid, ttransformer, **OPTIONS[name])
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()


def test_moe_program_alternates_ffn_and_moe_blocks():
    tmain, _, _ = build(tfluid, ttransformer, moe_experts=2, ep=True)
    moe = [op for op in tmain.desc.blocks[0].ops if op.type == "moe_ffn"]
    assert len(moe) == 1                          # layer 1 of 2
    assert moe[0].inputs["W1"] == ["blk1_w1"]
    assert tmain.desc.var_shardings["blk1_w1"] == ("ep", None, None)
    assert "blk1_fc1.w_0" not in tmain.desc.blocks[0].vars
    assert "blk0_fc1.w_0" in tmain.desc.blocks[0].vars


def _train(**kw):
    jmain, jstart, jloss = build(jfluid, jtransformer, **kw)
    tmain, _, tloss = build(tfluid, ttransformer, **kw)
    params = sorted(p.name for p in jmain.all_parameters())
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    jscope, tscope = JScope(), tfluid.Scope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    texe = tfluid.Executor(tfluid.CPUPlace())
    with jfluid.scope_guard(jscope):
        jexe.run(jstart)
    set_scope_arrays(tscope, {n: np.asarray(jscope.find_var(n))
                              for n in persist}, "cpu")
    losses = {"jax": [], "port": []}
    for feed in feeds(0):
        with jfluid.scope_guard(jscope):
            losses["jax"].append(jexe.run(jmain, feed=feed,
                                          fetch_list=[jloss])[0])
        losses["port"].append(texe.run(tmain, feed=feed,
                                       fetch_list=[tloss], scope=tscope)[0])
    final = {"jax": {n: np.asarray(jscope.find_var(n)) for n in params},
             "port": get_scope_arrays(tscope, params)}
    return params, losses, final


@pytest.fixture(scope="module", params=["tp", "moe", "moe_ep"])
def trained(request):
    return (request.param,) + _train(**OPTIONS[request.param])


def test_losses_track_the_reference(trained):
    name, _, losses, _ = trained
    for step, (j, p) in enumerate(zip(losses["jax"], losses["port"])):
        np.testing.assert_allclose(p, j, rtol=1e-4,
                                   err_msg="%s loss at step %d"
                                   % (name, step))


def test_parameters_track_the_reference(trained):
    name, params, _, final = trained
    if name.startswith("moe"):
        assert {"blk1_router", "blk1_w1", "blk1_w2"} <= set(params)
    for p in params:
        np.testing.assert_allclose(final["port"][p], final["jax"][p],
                                   atol=1e-4, rtol=0,
                                   err_msg="%s %s" % (name, p))


def test_moe_ffn_replays_its_spec():
    replay_spec("moe_ffn")


@pytest.mark.parametrize("name,axes,match", [
    ("moe_ep", {"ep": 2}, r"moe_ffn over ep_axis='ep' \(size 2\).*item 10"),
    ("tp", {"tp": 2}, r"ring_attention over head_axis='tp'"),
    ("sp_tp", {"sp": 2, "tp": 2}, r"ring_attention over head_axis='tp'"),
])
def test_op_raises_on_a_parallel_mesh_axis(name, axes, match):
    """Run through the executor core on a mesh, the op that would shard
    over the tp or ep axis refuses it (the ParallelExecutor refuses the
    axis before that: test_torch_executor)."""
    tmain, tstart, loss = build(tfluid, ttransformer, **OPTIONS[name])
    scope = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(tstart, scope=scope)
    n = int(np.prod(list(axes.values())))
    core = ExecutorCore(tfluid.CPUPlace(),
                        mesh=make_mesh(axes, ["cpu"] * n))
    with pytest.raises(NotImplementedError, match=match):
        core.run(tmain.desc, scope, 0, feeds(1)[0], [loss.name])


def test_moe_ffn_runs_dense_on_an_ep_axis_of_one():
    tmain, tstart, loss = build(tfluid, ttransformer, moe_experts=2,
                                ep=True)
    feed = feeds(2)[0]
    got = []
    for mesh in (None, make_mesh({"ep": 1}, ["cpu"])):
        scope = tfluid.Scope()
        tfluid.Executor(tfluid.CPUPlace()).run(tstart, scope=scope)
        core = ExecutorCore(tfluid.CPUPlace(), mesh=mesh)
        got.append(core.run(tmain.desc, scope, 0, feed, [loss.name])[0])
    np.testing.assert_array_equal(np.asarray(got[0]), np.asarray(got[1]))
