"""Dropout and the random stream of the port against the JAX package, on
the CPU.

torch's generators and jax.random never agree, so the draws are held by
their statistics and the reference's seed semantics, never bit for bit
across the packages; everything deterministic is held exactly:

- ``dropout_grad`` replays its ``SPECS`` entry; ``Out == X * Mask`` in
  both implementations, "upscale_in_train"'s mask is
  "downgrade_in_infer"'s over 1 - p at one seed, and the test-mode
  outputs (``is_test`` and a program cloned for test) equal the
  reference's;
- the keep rate is within 5 sigma of 1 - p; a run-seeded mask differs
  from step to step, an explicit ``seed`` draws the same mask at every
  step and the same in the fused and unfused programs;
- the fused chain of ``tests/test_matmul_fused.py`` with dropout, its
  masks put in through ``ops/random.keep_mask`` from the reference's
  key, tracks the reference's losses and parameters at that test's
  tolerances, fused and unfused;
- ``run_prepared`` and ``run()`` draw the same numbers: 24 steps of
  ``tests/test_prepared_executor.py``'s dropout MLP bit for bit, and
  ``uniform_random``, ``gaussian_random`` and dropout from one stream.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.core.types import DataType
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.ops import random as prandom
from test_torch_ops import optest, replay_spec, run_in_port

P = 0.3


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def test_dropout_grad_replays_its_spec():
    replay_spec("dropout_grad")


def _dropout_program(fluid, x_shape, p=P, impl=None, is_test=False,
                     seed=None):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=list(x_shape[1:]),
                              dtype="float32")
        out = fluid.layers.dropout(x, dropout_prob=p, is_test=is_test,
                                   seed=seed)
    op = main.global_block().ops[-1]
    if impl is not None:
        op.desc.set_attr("dropout_implementation", impl)
    return main, out.name, op.desc.output("Mask")[0]


def _run(fluid, main, feed, fetch, scope=None):
    exe = fluid.Executor(fluid.CPUPlace())
    if fluid is jfluid:
        return exe.run(main, feed=feed, fetch_list=fetch,
                       scope=scope or JScope())
    return exe.run(main, feed=feed, fetch_list=fetch,
                   scope=scope or tfluid.Scope())


def _x(shape, seed=0):
    return np.random.RandomState(seed).uniform(0.5, 2.0, shape).astype(
        np.float32)


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
def test_out_is_x_times_mask(impl):
    x = _x((16, 32))
    main, out, mask = _dropout_program(tfluid, x.shape, impl=impl)
    o, m = _run(tfluid, main, {"x": x}, [out, mask])
    np.testing.assert_array_equal(o, x * m)
    keep = 1.0 if impl == "downgrade_in_infer" else 1.0 / (1.0 - P)
    assert set(np.unique(m).tolist()) <= {0.0, np.float32(keep)}
    # the reference's Mask takes the same two values
    jmain, jout, jmask = _dropout_program(jfluid, x.shape, impl=impl)
    jo, jm = _run(jfluid, jmain, {"x": x}, [jout, jmask])
    np.testing.assert_array_equal(jo, x * jm)
    assert set(np.unique(jm).tolist()) <= {0.0, np.float32(keep)}


def test_upscale_is_downgrade_over_keep_at_one_seed():
    x = _x((16, 32))
    got = {}
    for impl in ("downgrade_in_infer", "upscale_in_train"):
        main, out, mask = _dropout_program(tfluid, x.shape, impl=impl,
                                           seed=5)
        got[impl] = _run(tfluid, main, {"x": x}, [out, mask])
    down, up = got["downgrade_in_infer"], got["upscale_in_train"]
    np.testing.assert_array_equal(up[1], down[1] / np.float32(1.0 - P))
    np.testing.assert_array_equal(up[0], x * up[1])


@pytest.mark.parametrize("impl", ["downgrade_in_infer", "upscale_in_train"])
@pytest.mark.parametrize("how", ["is_test", "clone_for_test"])
def test_test_mode_matches_the_reference(impl, how):
    """Inference: X * (1 - p) ("downgrade_in_infer") or X, Mask ones,
    by the op's attr or by running a program cloned for test (the
    executor's mode)."""
    x = _x((8, 12))
    outs = []
    for fluid in (jfluid, tfluid):
        main, out, mask = _dropout_program(fluid, x.shape, impl=impl,
                                           is_test=how == "is_test")
        if how == "clone_for_test":
            main = main.clone(for_test=True)
            # the clone flips is_test; put it back, so the mode decides
            main.desc.blocks[0].ops[-1].set_attr("is_test", False)
        outs.append(_run(fluid, main, {"x": x}, [out, mask]))
    (jo, jm), (o, m) = outs
    np.testing.assert_array_equal(m, np.ones_like(x))
    np.testing.assert_array_equal(jm, m)
    np.testing.assert_allclose(o, jo, rtol=1e-6, atol=0)
    want = x if impl == "upscale_in_train" else x * np.float32(1.0 - P)
    np.testing.assert_array_equal(o, want)


def _keep_within_5_sigma(mask, keep):
    n = mask.size
    rate = float((mask != 0).mean())
    sigma = np.sqrt(keep * (1 - keep) / n)
    assert abs(rate - keep) < 5 * sigma, (rate, keep, sigma)


def test_keep_rate_and_run_seeded_masks_differ_between_steps():
    """Both packages keep 1 - p of the elements, within 5 sigma; a
    run-seeded mask is new at every step, in both."""
    x = _x((256, 256))
    for fluid in (jfluid, tfluid):
        main, out, mask = _dropout_program(fluid, x.shape)
        main.random_seed = 3
        scope = JScope() if fluid is jfluid else tfluid.Scope()
        masks = [_run(fluid, main, {"x": x}, [mask], scope)[0]
                 for _ in range(3)]
        for m in masks:
            _keep_within_5_sigma(m, 1.0 - P)
        assert not np.array_equal(masks[0], masks[1])
        assert not np.array_equal(masks[1], masks[2])


def _fused_chain(fluid, seed, fuse, d=16):
    """mul -> bias -> gelu -> dropout(seed) -> residual, fused (K4 +
    the mask in torch) or not."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4, d], dtype="float32")
        h = fluid.layers.fc(x, size=d, num_flatten_dims=2, act="gelu")
        h = fluid.layers.dropout(h, dropout_prob=P, seed=seed)
        out = fluid.layers.elementwise_add(x, h)
        loss = fluid.layers.reduce_sum(out)
        if fuse:
            counts = fluid.transpiler.TransformerFuseTranspiler().transpile(
                main)
            assert counts.get("matmul_bias_act"), counts
    masks = [op.output("Mask")[0] for op in main.global_block().ops
             if op.type in ("dropout", "fused_matmul_bias_act")]
    return main, startup, loss, masks


def test_explicit_seed_is_the_same_mask_every_step_fused_or_not():
    """seed=11: the same mask at every step, and the fused op's the
    unfused dropout's; seed 0 (run-seeded): a new one every step."""
    x = _x((2, 4, 16))
    got = {}
    for fuse in (False, True):
        for seed in (11, None):
            main, startup, loss, masks = _fused_chain(tfluid, seed, fuse)
            main.random_seed = 9
            scope = tfluid.Scope()
            exe = tfluid.Executor(tfluid.CPUPlace())
            exe.run(startup, scope=scope)
            got[fuse, seed] = [exe.run(main, feed={"x": x},
                                       fetch_list=masks, scope=scope)[0]
                               for _ in range(3)]
    for fuse in (False, True):
        a, b, c = got[fuse, 11]
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, c)
        a, b, _ = got[fuse, None]
        assert not np.array_equal(a, b)
    np.testing.assert_array_equal(got[False, 11][0], got[True, 11][0])
    _keep_within_5_sigma(np.concatenate(got[True, None]), 1.0 - P)


def _reference_keep(seed, keep_prob, shape):
    """The reference's keep draw for an explicit seed
    (``jax.random.bernoulli(PRNGKey(seed), ...)``)."""
    return np.asarray(jax.random.bernoulli(jax.random.PRNGKey(seed),
                                           keep_prob, tuple(shape)))


def with_reference_keep(ctx, shape, keep_prob, seed=0):
    assert seed, "the chain's dropout has an explicit seed"
    return torch.from_numpy(_reference_keep(seed, keep_prob, shape).copy()).to(
        ctx.device)


@pytest.mark.parametrize("act", ["", "gelu"])
@pytest.mark.parametrize("fuse", [False, True])
def test_fused_chain_with_the_reference_masks_tracks_it(monkeypatch, act,
                                                        fuse):
    """``tests/test_matmul_fused.py``'s dropout cases (fc -> act ->
    dropout(0.3, seed=11) -> residual, SGD 0.05, 3 steps), the port's
    masks replaced by the reference's in ``keep_mask``: losses rtol =
    atol = 2e-4, post-step parameters rtol 1e-4, atol 4e-7; with gelu
    atol 1e-6, since the reference's own gelu gradient on the CPU
    (XLA's tanh) lies up to 3.5e-6 from the float64 value, the port's
    1.0e-6 (on 1e5 N(0, 2) points), and 3 SGD steps at 0.05 carry that
    into the parameters (6.2e-7 at most here)."""
    monkeypatch.setattr(prandom, "keep_mask", with_reference_keep)
    b, t, d = 2, 8, 128

    def build(fluid, transpile):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[t, d], dtype="float32")
            x.stop_gradient = False
            h = fluid.layers.fc(x, size=d, num_flatten_dims=2,
                                act=act or None, name="up")
            h = fluid.layers.dropout(h, dropout_prob=0.3, seed=11)
            loss = fluid.layers.reduce_sum(
                fluid.layers.elementwise_add(x, h))
            if transpile:
                counts = fluid.transpiler.TransformerFuseTranspiler() \
                    .transpile(main)
                assert counts.get("matmul_bias_act"), counts
            fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return main, startup, loss

    feed = {"x": np.random.RandomState(3).randn(b, t, d).astype(np.float32)}
    jmain, jstartup, jloss = build(jfluid, False)
    jscope = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstartup, scope=jscope)
    params = [p.name for p in jmain.all_parameters()]
    init = {n: np.array(jscope.find_var(n)) for n in params}
    want = [float(np.ravel(jexe.run(jmain, feed=feed, fetch_list=[jloss],
                                    scope=jscope)[0])[0]) for _ in range(3)]
    main, startup, loss = build(tfluid, fuse)
    ops = [op.type for op in main.desc.blocks[0].ops]
    assert ("fused_matmul_bias_act" in ops) is fuse
    assert ("dropout" in ops) is not fuse
    scope = tfluid.Scope()
    exe = tfluid.Executor(tfluid.CPUPlace())
    exe.run(startup, scope=scope)
    set_scope_arrays(scope, init, "cpu")
    got = [float(np.ravel(exe.run(main, feed=feed, fetch_list=[loss],
                                  scope=scope)[0])[0]) for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=2e-4)
    post = get_scope_arrays(scope, params)
    for n in params:
        np.testing.assert_allclose(post[n], np.array(jscope.find_var(n)),
                                   rtol=1e-4, atol=1e-6 if act else 4e-7,
                                   err_msg=n)


def _build_mlp(fluid):
    """``tests/test_prepared_executor.py``'s ``_build_mlp(dropout=True)``:
    fc -> tanh -> dropout(0.3) -> fc -> mse, Adam 0.01."""
    x = fluid.layers.data(name="x", shape=[8], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="float32")
    h = fluid.layers.fc(x, size=16, act="tanh")
    h = fluid.layers.dropout(h, dropout_prob=0.3)
    pred = fluid.layers.fc(h, size=1)
    loss = fluid.layers.mean(fluid.layers.square_error_cost(pred, y))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def test_run_prepared_matches_run_exact():
    """The reference's ``test_run_prepared_matches_run_exact`` in the
    port: 24 steps of the dropout MLP, prepared against run(), identical
    losses and persistables; training progressed (the last 8 steps'
    mean loss below the first 8's)."""
    rng = np.random.RandomState(0)
    xs = [rng.randn(4, 8).astype(np.float32) for _ in range(24)]
    # a learnable target, so that the losses fall
    feeds = [{"x": x, "y": x[:, :4].sum(axis=1, keepdims=True) / 2}
             for x in xs]
    out = {}
    for prepared in (False, True):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup), \
                tfluid.unique_name.guard():
            loss = _build_mlp(tfluid)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        torch.manual_seed(0)
        exe.run(startup, scope=scope)
        if prepared:
            with exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                             scope=scope) as prep:
                losses = [prep.run_prepared(f, return_numpy=True)[0]
                          for f in feeds]
        else:
            losses = [exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0] for f in feeds]
        persist = [v.name for v in main.list_vars() if v.persistable]
        out[prepared] = losses, get_scope_arrays(scope, persist)
    (la, pa), (lb, pb) = out[False], out[True]
    assert len(pa) >= 8
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    for n in pa:
        np.testing.assert_array_equal(pa[n], pb[n], err_msg=n)
    # training progressed (each step is another random batch)
    lb = [float(np.ravel(x)[0]) for x in lb]
    assert np.mean(lb[-8:]) < np.mean(lb[:8])


def _three_draws(fluid):
    """uniform_random, dropout and gaussian_random in one block."""
    block = fluid.default_main_program().global_block()
    u = block.create_var(name="u", shape=[64], dtype="float32")
    block.append_op(type="uniform_random", outputs={"Out": [u]},
                    attrs={"shape": [64], "min": -1.0, "max": 1.0,
                           "dtype": DataType.FP32})
    d = fluid.layers.dropout(u, dropout_prob=0.5)
    g = block.create_var(name="g", shape=[64], dtype="float32")
    block.append_op(type="gaussian_random", outputs={"Out": [g]},
                    attrs={"shape": [64], "mean": 0.0, "std": 1.0,
                           "dtype": DataType.FP32})
    return ["u", d.name, "g"]


def test_random_ops_draw_from_one_stream():
    """The three draws of a step come from the step's stream: prepared
    and run() see the same numbers at every step, and every step's are
    new."""
    out = {}
    for prepared in (False, True):
        main, startup = tfluid.Program(), tfluid.Program()
        with tfluid.program_guard(main, startup), \
                tfluid.unique_name.guard():
            fetch = _three_draws(tfluid)
        main.random_seed = 13
        scope = tfluid.Scope()
        exe = tfluid.Executor(tfluid.CPUPlace())
        if prepared:
            prep = exe.prepare(main, feed_specs={}, fetch_list=fetch,
                               scope=scope)
            out[prepared] = [prep.run_prepared(return_numpy=True)
                             for _ in range(4)]
        else:
            out[prepared] = [exe.run(main, fetch_list=fetch, scope=scope)
                             for _ in range(4)]
    for a, b in zip(out[False], out[True]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    steps = out[True]
    for i in range(3):
        assert not np.array_equal(steps[i][0], steps[i + 1][0])
        assert not np.array_equal(steps[i][2], steps[i + 1][2])
    # the dropout draws after the uniform one, from the same generator:
    # the uniform numbers of a step are not the dropout's
    assert not np.array_equal(steps[0][0], steps[0][2])


def test_dropout_spec_out_and_mask_shapes():
    """The dropout SPECS entry (upscale_in_train, p = 0.5) through both
    packages: the same shapes and dtypes, Out == X * Mask, and the
    mask's two values."""
    s = optest.SPECS["dropout"]
    t = optest._make_optest("dropout", s)
    names = optest._fetch_names(t)
    ref = t.run_outputs(jfluid.CPUPlace(), fetch_names=names)
    main, _, feed = t._build()
    got = run_in_port(main, feed, names)
    x = s["inputs"]["X"]
    for n in names:
        assert got[n].shape == ref[n].shape and got[n].dtype == ref[n].dtype
    np.testing.assert_array_equal(got["Out"], x * got["Mask"])
    assert set(np.unique(got["Mask"]).tolist()) <= {0.0, 2.0}
