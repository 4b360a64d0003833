"""Sequence-parallel training of the transformer LM (``get_model(sp=True)``)
in the port against the JAX package, on the CPU at a small size (vocab
64, sequence 16, d_model 32, 2 heads, 2 layers, d_ff 64, batch 2).

- The sp program's main and startup descs serialize to the JAX
  package's bytes.
- On a plain ``Executor(CPUPlace())`` (no mesh) the sp program runs
  dense, as the JAX package runs it: the same loss.
- Under ``ParallelExecutor(mesh_axes={"sp": p})``, p = 2 and 4, its
  attention is the ring over p CPU shards; 3 Adam steps from the JAX
  package's startup scope (carried over as numpy arrays: the two draw
  different random numbers) track the JAX package's
  ``ParallelExecutor(use_tpu=False, mesh_axes=...)`` on p host devices.
  Losses at rtol 1e-4 (the same f32 math in another order); every
  parameter after step 3 at atol 1e-4, 3 % of the 3e-3 that three Adam
  steps at lr 1e-3 can move a weight.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import transformer as ttransformer
from paddle_tpu_torch.parallel import ring as tring

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = dict(vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layers=2,
             d_ff=64)
STEPS = 3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def build(fluid, module):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = module.get_model(sp=True, **SMALL)
    return main, startup, loss


def feeds(seed, batch=2):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(STEPS):
        toks = rng.randint(0, SMALL["vocab_size"],
                           (batch, SMALL["seq_len"] + 1)).astype(np.int64)
        out.append({"src": toks[:, :-1], "label": toks[:, 1:, None]})
    return out


@pytest.fixture(scope="module")
def jax_start():
    """The JAX package's sp program and its startup scope's arrays."""
    jmain, jstart, jloss = build(jfluid, jtransformer)
    jscope = JScope()
    with jfluid.scope_guard(jscope):
        jfluid.Executor(jfluid.CPUPlace()).run(jstart)
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    return jmain, jloss, {n: np.array(jscope.find_var(n)) for n in persist}


def _jax_scope(arrays):
    scope = JScope()
    for name, arr in arrays.items():
        scope.set(name, arr.copy())
    return scope


def test_sp_descs_match_the_reference():
    jmain, jstart, _ = build(jfluid, jtransformer)
    tmain, tstart, _ = build(tfluid, ttransformer)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    ops = [op.type for op in tmain.desc.blocks[0].ops]
    assert ops.count("sharding_constraint") == 1
    assert all(op.attr("sp_axis") == "sp" for op in tmain.desc.blocks[0].ops
               if op.type in ("ring_attention", "ring_attention_grad"))


def test_sp_program_runs_dense_on_a_plain_executor(jax_start):
    """No mesh: the sp program runs the dense flash path, as in the JAX
    package (the port used to refuse sp at build time)."""
    jmain, jloss, arrays = jax_start
    feed = feeds(1)[0]
    jscope = _jax_scope(arrays)
    with jfluid.scope_guard(jscope):
        want, = jfluid.Executor(jfluid.CPUPlace()).run(
            jmain, feed=feed, fetch_list=[jloss])
    tmain, _, tloss = build(tfluid, ttransformer)
    tscope = tfluid.Scope()
    set_scope_arrays(tscope, arrays, "cpu")
    got, = tfluid.Executor(tfluid.CPUPlace()).run(
        tmain, feed=feed, fetch_list=[tloss], scope=tscope)
    np.testing.assert_allclose(got, want, rtol=1e-4)


@pytest.mark.parametrize("p", [2, 4])
def test_sp_parallel_executor_tracks_the_reference(jax_start, p,
                                                   monkeypatch):
    jmain, jloss, arrays = jax_start
    params = sorted(v.name for v in jmain.all_parameters())
    jscope = _jax_scope(arrays)
    jpe = jfluid.ParallelExecutor(use_tpu=False, loss_name=jloss.name,
                                  main_program=jmain, scope=jscope,
                                  mesh_axes={"sp": p})
    want = [np.asarray(jpe.run(fetch_list=[jloss], feed=f)[0])
            for f in feeds(2)]
    jfinal = {n: np.asarray(jscope.find_var(n)) for n in params}

    folds = []
    fold = tring.flash_attention_chunk

    def counted(*a, **kw):
        folds.append(kw["causal"])
        return fold(*a, **kw)

    monkeypatch.setattr(tring, "flash_attention_chunk", counted)
    tmain, _, tloss = build(tfluid, ttransformer)
    tscope = tfluid.Scope()
    set_scope_arrays(tscope, arrays, "cpu")
    pe = tfluid.ParallelExecutor(use_cuda=False, loss_name=tloss.name,
                                 main_program=tmain, scope=tscope,
                                 mesh_axes={"sp": p})
    assert pe.device_count == p
    got = [pe.run(fetch_list=[tloss], feed=f)[0] for f in feeds(2)]
    # the ring ran: p(p+1)/2 folds per layer and step
    assert len(folds) == STEPS * SMALL["n_layers"] * p * (p + 1) // 2
    for step, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   err_msg="loss at step %d" % step)
    final = get_scope_arrays(tscope, params)
    for name in params:
        np.testing.assert_allclose(final[name], jfinal[name], atol=1e-4,
                                   rtol=0, err_msg=name)


def test_parallel_executor_refuses_what_is_not_ported():
    main, _, loss = build(tfluid, ttransformer)
    for axes in ({"dp": 2}, {"dp": 2, "sp": 2}, {"tp": 2}):
        with pytest.raises(NotImplementedError, match="ported"):
            tfluid.ParallelExecutor(use_cuda=False, main_program=main,
                                    mesh_axes=axes)
    with pytest.raises(NotImplementedError, match="multi-host"):
        tfluid.ParallelExecutor(use_cuda=False, main_program=main,
                                num_trainers=2, trainer_id=1)
    for knob in ("exec_strategy", "build_strategy"):
        with pytest.raises(NotImplementedError, match="strategy"):
            tfluid.ParallelExecutor(use_cuda=False, main_program=main,
                                    **{knob: object()})
    pe = tfluid.ParallelExecutor(use_cuda=False, main_program=main)
    assert pe.mesh.shape == {"dp": 1}


def test_parallel_executor_on_cuda_never_falls_back(monkeypatch):
    """use_cuda=True, the default, lays the mesh over the cards only:
    without CUDA, or with fewer cards than the mesh needs, it raises."""
    main, _, _ = build(tfluid, ttransformer)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.ParallelExecutor(use_cuda=True, main_program=main,
                                mesh_axes={"sp": 2})
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.ParallelExecutor(main_program=main, mesh_axes={"sp": 2})
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 2 devices, have 1"):
        tfluid.ParallelExecutor(use_cuda=True, main_program=main,
                                mesh_axes={"sp": 2})
