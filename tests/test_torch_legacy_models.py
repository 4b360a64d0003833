"""AlexNet, GoogLeNet (the bench entry's ``alexnet`` / ``googlenet``) and
the word2vec book model in the port against the JAX package, on the CPU.

- each ``get_model`` builds the reference's ProgramDesc, main and
  startup, byte for byte;
- AlexNet and GoogLeNet at 224 x 224, batch 2, two Momentum steps from
  the reference's startup values with its dropout masks put in through
  ``ops/random.keep_mask``: the losses at rtol 1e-5 (step 1) and 1e-3
  (step 2), and every step-1 parameter gradient within twice the
  reference's own distance from a float64 step of the same program, or
  1e-4, whichever is larger (relative Frobenius norm), as
  ``test_torch_vgg.py`` holds VGG16-BN: the first convolutions' f32
  gradients sit up to 2.6e-3 (the reference) and 3.1e-3 (the port)
  from float64, sums through the whole network.  Step 2 carries that
  error: the
  reference's own step-2 loss moves by 8e-5 when its startup values
  move one ulp, and by 1e-4 when the same step also fetches the
  gradients (XLA fuses it otherwise), hence 1e-3 there;
- word2vec (is_sparse ``shared_w``, SGD) for 3 steps on a 5-gram
  batch: losses and every persistable within 1e-6.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import alexnet as jalex
from paddle_tpu.models import googlenet as jgoog
from paddle_tpu.models import word2vec as jw2v
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.models import alexnet as talex
from paddle_tpu_torch.models import googlenet as tgoog
from paddle_tpu_torch.models import word2vec as tw2v
from paddle_tpu_torch.ops import random as prandom
from test_torch_vgg import _as_float64, _grads_of, _masks_of, _rel

MODELS = {"alexnet": (jalex, talex), "googlenet": (jgoog, tgoog)}
BATCH = 2
STEPS = 2


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _build(fluid, module, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = module.get_model(**kw)
    return main, startup, loss


@pytest.mark.parametrize("model", sorted(MODELS))
def test_model_trains_as_the_reference_with_its_masks(model, monkeypatch):
    jmod, tmod = MODELS[model]
    jmain, jstart, jloss = _build(jfluid, jmod)
    tmain, tstart, tloss = _build(tfluid, tmod)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    ops = [op.type for op in tmain.desc.blocks[0].ops]
    assert ops.count("lrn") == 2 and "lrn_grad" in ops
    masks, grads = _masks_of(jmain), _grads_of(jmain)
    rng = np.random.RandomState(0)
    feeds = [{"data": rng.rand(BATCH, 3, 224, 224).astype(np.float32),
              "label": rng.randint(0, 102, (BATCH, 1)).astype(np.int64)}
             for _ in range(STEPS)]
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=jscope)
    init = {v.name: np.array(jscope.find_var(v.name))
            for v in jmain.list_vars() if v.persistable}
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
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    set_scope_arrays(scope, init, "cpu")
    got, got_g = [], None
    for f, m in zip(feeds, step_masks):
        current.clear()
        current.update(m)
        out = exe.run(tmain, feed=f, fetch_list=[tloss] + grads, scope=scope)
        got.append(float(np.ravel(out[0])[0]))
        if got_g is None:
            got_g = dict(zip(grads, out[1:]))
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    np.testing.assert_allclose(got[1], want[1], rtol=1e-3)
    # step 1's gradients against a float64 step of the same program
    scope = tfluid.Scope()
    set_scope_arrays(scope, {n: v.astype(np.float64)
                             if v.dtype == np.float32 else v
                             for n, v in init.items()}, "cpu")
    current.clear()
    current.update(step_masks[0])
    out = exe.run(_as_float64(tmain), feed={
        k: v.astype(np.float64) if v.dtype == np.float32 else v
        for k, v in feeds[0].items()}, fetch_list=grads, scope=scope)
    for g, exact in zip(grads, out):
        gap, ref_err = _rel(got_g[g], want_g[g]), _rel(want_g[g], exact)
        bar = max(1e-4, ref_err)
        assert _rel(got_g[g], exact) <= 2 * bar, (g, ref_err)
        assert gap <= 3 * bar, (g, gap, ref_err)


def test_word2vec_tracks_the_reference():
    """The 5-gram model (dict 50, embeddings 8, hidden 16) for 3 SGD
    steps: ``shared_w``'s gradient a SelectedRows summed over the four
    lookups."""
    kw = dict(dict_size=50, embed_size=8, hidden_size=16,
              learning_rate=0.1)
    jmain, jstart, jloss = _build(jfluid, jw2v, **kw)
    tmain, tstart, tloss = _build(tfluid, tw2v, **kw)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    ops = tmain.desc.blocks[0].ops
    assert sum(op.type == "lookup_table_grad" and
               op.attrs["is_sparse"].value for op in ops) == 4
    rng = np.random.RandomState(3)
    names = ("firstw", "secondw", "thirdw", "forthw", "nextw")
    feeds = [{n: rng.randint(0, 50, (8, 1)).astype(np.int64)
              for n in names} for _ in range(3)]
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    persist = sorted(v.name for v in jmain.list_vars() if v.persistable)
    ts = tfluid.Scope()
    set_scope_arrays(ts, {n: np.array(js.find_var(n)) for n in persist},
                     "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    for f in feeds:
        a = jexe.run(jmain, feed=f, fetch_list=[jloss], scope=js)[0]
        b = exe.run(tmain, feed=f, fetch_list=[tloss], scope=ts)[0]
        np.testing.assert_allclose(b, a, rtol=1e-6, atol=1e-6)
    tp = get_scope_arrays(ts, persist)
    for n in persist:
        np.testing.assert_allclose(tp[n], np.asarray(js.find_var(n)),
                                   rtol=1e-6, atol=1e-6, err_msg=n)
