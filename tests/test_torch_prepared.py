"""The port's prepared step (``Executor.prepare`` / ``run_prepared`` /
``sync_scope``) on the CPU, against the JAX package's prepared path and
against the port's own ``run()``.

- Trajectories: the LM (vocab 64, sequence 16, d_model 32, 2 heads, 2
  layers, d_ff 64, batch 2; unfused, fused-block, and fused-block under
  ``Float16Transpiler``) and ResNet cifar10 depth 8 at batch 4 (NCHW,
  and NHWC fused-stage), 3 ``run_prepared`` steps each from the
  reference's startup parameters.  Against the reference's
  ``Executor(CPUPlace()).prepare(...)`` on the same program at the bars
  the trajectory tests use (``tests/test_torch_train.py``,
  ``test_torch_resnet.py``, ``test_torch_lm_amp.py``): f32 losses rtol
  1e-4 (the same f32 math in another order), LM parameters atol 1e-4,
  ResNet persistables max |drift| < 5e-4, AMP losses rtol 1e-2.
  Against the port's own ``run()``: bit for bit, losses and every
  persistable.
- The contract cases of ``tests/test_prepared_executor.py``, each
  written for the port (its op set: an fc-relu-fc softmax cross-entropy
  MLP under Adam or Momentum, ``scale`` and ``assign`` ops appended to
  the block) and run in both packages: the port's prepared step equals
  its ``run()`` bit for bit, and the two packages agree (losses rtol
  1e-4, persistables atol 1e-5, the same f32 math in another order)
  or, for errors, raise alike.
- ``PreparedShapeMismatch`` on a drifted batch, and the bench entry's
  fallback to ``run()`` on it; a refused step draws no seed, so the
  ``run()`` that takes its batch draws what ``run()`` alone would.
- The port's own rules: one plan a program for ``run()`` and
  ``prepare()`` whatever the batch; a flag the lowering reads changed
  after ``prepare()`` raises; the refusals of a step a CUDA graph cannot
  replay (``Uncapturable``), which ``ParallelExecutor`` takes as its cue
  to run ``run()``.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.models import resnet as jresnet
from paddle_tpu.models import transformer as jtransformer
from paddle_tpu_torch.core.executor_impl import (ExecutorCore,
                                                 PreparedShapeMismatch,
                                                 Uncapturable)
from paddle_tpu_torch.core.flags import FLAGS
from paddle_tpu_torch.core.types import DataType
from paddle_tpu_torch.fluid.io import set_scope_arrays
from paddle_tpu_torch.models import resnet as tresnet
from paddle_tpu_torch.models import transformer as ttransformer

STEPS = 3
N_FEAT, N_CLASS = 8, 4
LM = dict(vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layers=2,
          d_ff=64)
OIHW_TO_HWIO = (2, 3, 1, 0)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# ------------------------------------------------------------ packages

class Pkg:
    """One package's fluid, scope and array moves, so that a scenario
    reads the same in both."""

    def __init__(self, name):
        self.name = name
        self.fluid = jfluid if name == "jax" else tfluid

    def scope(self, parent=None):
        if parent is not None:
            return parent.new_scope()
        return JScope() if self.name == "jax" else tfluid.Scope()

    def exe(self):
        return self.fluid.Executor(self.fluid.CPUPlace())

    def load(self, scope, arrays):
        if self.name == "jax":
            for n, v in arrays.items():
                scope.set(n, np.array(v))
        else:
            set_scope_arrays(scope, arrays, "cpu")

    def read(self, scope, name):
        return np.array(self.fluid.fetch_var(name, scope=scope))

    def persistables(self, main, scope):
        return {v.name: self.read(scope, v.name) for v in main.list_vars()
                if v.persistable}


JAX, PORT = Pkg("jax"), Pkg("port")


def _programs(pkg, model_fn, **kw):
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = model_fn(fluid, **kw)
    return main, startup, out


def _init(model_fn, **kw):
    """The reference's startup values of every persistable of the
    program ``model_fn`` makes (the two packages draw different random
    numbers)."""
    main, startup, _ = _programs(JAX, model_fn, **kw)
    scope = JScope()
    JAX.exe().run(startup, scope=scope)
    return {v.name: np.array(scope.find_var(v.name))
            for v in main.list_vars()
            if v.persistable and scope.has_var(v.name)}


def _mlp(fluid, optimizer="adam"):
    x = fluid.layers.data(name="x", shape=[N_FEAT], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(x, size=16, act="relu")
    logits = fluid.layers.fc(h, size=N_CLASS)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, y))
    if optimizer == "adam":
        fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    else:
        fluid.optimizer.Momentum(learning_rate=0.1,
                                 momentum=0.9).minimize(loss)
    return loss


def _feeds(n, batch=4, seed=0):
    """Batches of a learnable task: the label is the largest of the
    first N_CLASS features."""
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        x = rng.randn(batch, N_FEAT).astype(np.float32)
        y = x[:, :N_CLASS].argmax(axis=1)[:, None].astype(np.int64)
        out.append({"x": x, "y": y})
    return out


def _close(got, want, what):
    """The port against the reference: the same f32 math in another
    order."""
    for k in want:
        np.testing.assert_allclose(np.asarray(got[k]), np.asarray(want[k]),
                                   rtol=1e-4, atol=1e-5,
                                   err_msg="%s %s" % (what, k))


def _equal(got, want, what):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]),
                                      err_msg="%s %s" % (what, k))


def _losses(outs):
    return {i: np.asarray(o) for i, o in enumerate(outs)}


# --------------------------------------------------------- trajectories

def _lm(fluid, amp=False, **kw):
    module = jtransformer if fluid is jfluid else ttransformer
    loss, _, _ = module.get_model(**LM, **kw)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(
            fluid.default_main_program())
    return loss


def _resnet(fluid, **kw):
    module = jresnet if fluid is jfluid else tresnet
    loss, _, _ = module.get_model(data_set="cifar10", depth=8, **kw)
    return loss


def _lm_feeds():
    """One batch, fed at every step (the loss must fall)."""
    toks = np.random.RandomState(0).randint(
        0, LM["vocab_size"], (2, LM["seq_len"] + 1)).astype(np.int64)
    return [{"src": toks[:, :-1], "label": toks[:, 1:, None]}] * STEPS


def _resnet_feeds():
    rng = np.random.RandomState(0)
    return [{"data": rng.rand(4, 3, 32, 32).astype(np.float32),
             "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}] * STEPS


def _hwio(arrays, main):
    """The NCHW startup's arrays, filters transposed HWIO where the
    program stores them so."""
    block = main.desc.blocks[0]
    out = {}
    for name, v in arrays.items():
        shape = tuple(block.vars[name].shape)
        if v.ndim == 4 and v.shape != shape:
            v = np.ascontiguousarray(np.transpose(v, OIHW_TO_HWIO))
        out[name] = v
    return out


TRAJECTORIES = {
    "lm": (_lm, {}, _lm_feeds),
    "lm_fused": (_lm, {"fuse_transformer": True}, _lm_feeds),
    "lm_fused_amp": (_lm, {"fuse_transformer": True, "amp": True},
                     _lm_feeds),
    "resnet_nchw": (_resnet, {"data_format": "NCHW"}, _resnet_feeds),
    "resnet_nhwc_fused": (_resnet, {"data_format": "NHWC",
                                    "fused_stages": True}, _resnet_feeds),
}


def _trajectory(pkg, model_fn, kw, feeds, init, prepared):
    main, _, loss = _programs(pkg, model_fn, **kw)
    init = _hwio(init, main)
    scope = pkg.scope()
    pkg.load(scope, init)
    exe = pkg.exe()
    if prepared:
        with exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                         scope=scope) as prep:
            losses = [np.asarray(prep.run_prepared(f)[0], np.float32)
                      if pkg is JAX else
                      np.asarray(prep.run_prepared(f, return_numpy=True)[0])
                      for f in feeds]
    else:
        losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in feeds]
    return ([float(np.ravel(x)[0]) for x in losses],
            {n: pkg.read(scope, n) for n in init})


@pytest.fixture(scope="module")
def trajectories():
    out = {}
    for name, (model_fn, kw, make_feeds) in TRAJECTORIES.items():
        base = dict(kw, data_format="NCHW", fused_stages=False) \
            if model_fn is _resnet else {}
        init = _init(model_fn, **base)
        feeds = make_feeds()
        out[name] = {
            "jax": _trajectory(JAX, model_fn, kw, feeds, init, True),
            "port": _trajectory(PORT, model_fn, kw, feeds, init, True),
            "port_run": _trajectory(PORT, model_fn, kw, feeds, init, False)}
    return out


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_prepared_trajectory_tracks_the_references(trajectories, name):
    got_l, got_p = trajectories[name]["port"]
    want_l, want_p = trajectories[name]["jax"]
    amp = TRAJECTORIES[name][1].get("amp", False)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-2 if amp else 1e-4)
    assert got_l[-1] < got_l[0]
    if amp:
        assert {v.dtype for v in got_p.values()
                if v.dtype.kind == "f"} == {np.dtype(np.float32)}
        return
    for n, w in want_p.items():
        g = got_p[n]
        if w.dtype.kind != "f":
            continue
        if name.startswith("lm"):
            np.testing.assert_allclose(g, w, atol=1e-4, rtol=0, err_msg=n)
        else:
            assert float(np.abs(g - w).max()) < 5e-4, n


@pytest.mark.parametrize("name", list(TRAJECTORIES))
def test_prepared_trajectory_is_run_bit_for_bit(trajectories, name):
    got_l, got_p = trajectories[name]["port"]
    want_l, want_p = trajectories[name]["port_run"]
    assert got_l == want_l
    _equal(got_p, want_p, name)


# ------------------------------------------------------ contract cases

def _both(scenario):
    """``scenario(pkg)`` in both packages: (port, reference)."""
    return scenario(PORT), scenario(JAX)


def test_run_prepared_matches_run_exactly():
    init = _init(_mlp)
    feeds = _feeds(8)

    def scenario(pkg, prepared):
        main, _, loss = _programs(pkg, _mlp)
        scope = pkg.scope()
        pkg.load(scope, init)
        exe = pkg.exe()
        if prepared:
            with exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                             scope=scope) as prep:
                losses = [np.asarray(prep.run_prepared(f)[0])
                          for f in feeds]
        else:
            losses = [exe.run(main, feed=f, fetch_list=[loss],
                              scope=scope)[0] for f in feeds]
        return _losses(losses), pkg.persistables(main, scope)

    got, want = _both(lambda pkg: scenario(pkg, True))
    by_run = scenario(PORT, False)
    assert len(got[1]) >= 8     # params, Adam moments, beta pows, lr
    _equal(got[0], by_run[0], "loss")
    _equal(got[1], by_run[1], "persistable")
    _close(got[0], want[0], "loss")
    _close(got[1], want[1], "persistable")
    assert got[0][len(feeds) - 1] < got[0][0]


def _random_block(fluid):
    """A main block that draws: uniform noise added to a persistable."""
    w = fluid.layers.create_global_var([4], 0.0, "float32",
                                       persistable=True, name="rand_w")
    block = fluid.default_main_program().global_block()
    noise = block.create_var(name="noise", shape=[4], dtype="float32")
    block.append_op(type="uniform_random", outputs={"Out": [noise]},
                    attrs={"shape": [4], "min": -1.0, "max": 1.0,
                           "dtype": DataType.FP32})
    block.append_op(type="elementwise_add", inputs={"X": [w], "Y": [noise]},
                    outputs={"Out": [w]})
    return w


def test_prepared_cpu_step_draws_what_run_draws():
    """A prepared CPU step takes run()'s seed at that step (the per-scope
    run counter), so its random ops draw the same numbers."""
    outs = {}
    for prepared in (False, True):
        main, startup, w = _programs(PORT, _random_block)
        main.random_seed = 7
        scope = PORT.scope()
        exe = PORT.exe()
        exe.run(startup, scope=scope)
        if prepared:
            prep = exe.prepare(main, fetch_list=[w], scope=scope)
            outs[prepared] = [prep.run_prepared(return_numpy=True)[0]
                              for _ in range(STEPS)]
        else:
            outs[prepared] = [exe.run(main, fetch_list=[w], scope=scope)[0]
                              for _ in range(STEPS)]
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(a, b)
    assert not np.array_equal(outs[True][0], outs[True][1])


def test_run_and_run_prepared_interleave():
    init = _init(_mlp)
    feeds = _feeds(8, seed=3)

    def scenario(pkg, mid_run=True):
        main, _, loss = _programs(pkg, _mlp)
        scope = pkg.scope()
        pkg.load(scope, init)
        exe = pkg.exe()
        prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                           scope=scope)
        for i, f in enumerate(feeds):
            if i == 4 or not mid_run:
                exe.run(main, feed=f, fetch_list=[loss], scope=scope)
            else:
                prep.run_prepared(f)
        prep.sync_scope()
        return pkg.persistables(main, scope)

    got, want = _both(scenario)
    _equal(got, scenario(PORT, mid_run=False), "persistable")
    _close(got, want, "persistable")


def test_direct_scope_read_sees_prepared_state():
    init = _init(_mlp)
    feeds = _feeds(4, seed=11)

    def scenario(pkg, prepared=True):
        main, _, loss = _programs(pkg, _mlp)
        scope = pkg.scope()
        pkg.load(scope, init)
        exe = pkg.exe()
        if prepared:
            prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                               scope=scope)
            for f in feeds:
                prep.run_prepared(f)
            assert prep._prep._dirty
        else:
            for f in feeds:
                exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        # no sync_scope: the read itself flushes
        return pkg.persistables(main, scope)

    got, want = _both(scenario)
    _equal(got, scenario(PORT, prepared=False), "persistable")
    _close(got, want, "persistable")


def test_external_scope_write_wins_over_device_state():
    init = _init(_mlp)
    feeds = _feeds(4, seed=5)

    def scenario(pkg, prepared=True):
        main, _, loss = _programs(pkg, _mlp)
        wname = next(v.name for v in main.list_vars()
                     if v.persistable and v.name.endswith(".w_0"))
        # the shape from the desc: a read would flush first
        new_w = np.full(tuple(main.global_block().vars[wname].shape), 0.25,
                        np.float32)
        scope = pkg.scope()
        pkg.load(scope, init)
        exe = pkg.exe()
        prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                           scope=scope) if prepared else None

        def step(f):
            if prep is not None:
                prep.run_prepared(f)
            else:
                exe.run(main, feed=f, fetch_list=[loss], scope=scope)

        step(feeds[0])
        pkg.load(scope, {wname: new_w})     # external write while dirty
        for f in feeds[1:]:
            step(f)
        return pkg.persistables(main, scope)

    got, want = _both(scenario)
    _equal(got, scenario(PORT, prepared=False), "persistable")
    _close(got, want, "persistable")


def test_parent_scope_reader_sees_child_prepared_state():
    init = _init(_mlp)
    feeds = _feeds(4, seed=9)

    def scenario(pkg):
        main, _, loss = _programs(pkg, _mlp)
        parent = pkg.scope()
        pkg.load(parent, init)              # persistables in the parent
        child = pkg.scope(parent)
        prep = pkg.exe().prepare(main, feed_specs=feeds[0],
                                 fetch_list=[loss], scope=child)
        for f in feeds:
            prep.run_prepared(f)
        # no sync, and the read starts at the parent
        return pkg.persistables(main, parent)

    def by_run():
        main, _, loss = _programs(PORT, _mlp)
        scope = PORT.scope()
        PORT.load(scope, init)
        for f in feeds:
            PORT.exe().run(main, feed=f, fetch_list=[loss], scope=scope)
        return PORT.persistables(main, scope)

    got, want = _both(scenario)
    _equal(got, by_run(), "persistable")
    _close(got, want, "persistable")


def test_stale_program_raises_and_parallel_executor_prepares_again():
    init = _init(_mlp)
    feeds = _feeds(3, seed=13)

    def scenario(pkg):
        main, _, loss = _programs(pkg, _mlp)
        scope = pkg.scope()
        pkg.load(scope, init)
        prep = pkg.exe().prepare(main, feed_specs=feeds[0],
                                 fetch_list=[loss], scope=scope)
        prep.run_prepared(feeds[0])
        main.desc.bump_version()
        assert prep.is_stale
        with pytest.raises(RuntimeError, match="mutated"):
            prep.run_prepared(feeds[1])
        prep.sync_scope()

        scope2 = pkg.scope()
        pkg.load(scope2, init)
        kw = {"use_tpu": False} if pkg is JAX else {"use_cuda": False}
        pe = pkg.fluid.ParallelExecutor(loss_name=loss.name,
                                        main_program=main, scope=scope2,
                                        num_devices=1, **kw)
        l0 = pe.run(feed=feeds[0], fetch_list=[loss])[0]
        first = dict(pe._prepared)
        main.desc.bump_version()
        l1 = pe.run(feed=feeds[1], fetch_list=[loss])[0]   # prepared again
        again = dict(pe._prepared)
        assert list(first) == list(again)
        assert all(again[k] is not first[k] for k in again)
        return _losses([l0, l1])

    got, want = _both(scenario)
    _close(got, want, "loss")


def _counter(fluid):
    w = fluid.layers.create_global_var([4], 0.0, "float32",
                                       persistable=True, name="nf_w")
    fluid.default_main_program().global_block().append_op(
        type="scale", inputs={"X": [w]}, outputs={"Out": [w]},
        attrs={"scale": 1.0, "bias": 1.0})
    return w


def test_prepare_without_feed_specs():
    def scenario(pkg):
        main, startup, w = _programs(pkg, _counter)
        scope = pkg.scope()
        exe = pkg.exe()
        exe.run(startup, scope=scope)
        prep = exe.prepare(main, fetch_list=["nf_w"], scope=scope)
        for _ in range(3):
            out = prep.run_prepared()
        return np.asarray(out[0])

    got, want = _both(scenario)
    np.testing.assert_array_equal(got, np.full((4,), 3.0, np.float32))
    np.testing.assert_array_equal(got, want)


def test_external_write_to_read_only_state_not_masked_by_flush():
    """A learning rate set to 0 while the program is dirty survives the
    flushing read, and the following steps leave the weight alone."""
    init = _init(_mlp, optimizer="momentum")
    feed = _feeds(1)[0]

    def scenario(pkg):
        main, _, loss = _programs(pkg, _mlp, optimizer="momentum")
        lr = next(v.name for v in main.list_vars()
                  if v.persistable and "learning_rate" in v.name)
        wname = next(v.name for v in main.list_vars()
                     if v.persistable and v.name.endswith(".w_0"))
        scope = pkg.scope()
        pkg.load(scope, init)
        prep = pkg.exe().prepare(main, feed_specs=feed, fetch_list=[loss],
                                 scope=scope)
        prep.run_prepared(feed)                           # dirty
        pkg.load(scope, {lr: np.zeros((1,), np.float32)})
        w_after = pkg.read(scope, wname)                  # flushes
        prep.run_prepared(feed)
        prep.run_prepared(feed)
        prep.sync_scope()
        np.testing.assert_array_equal(pkg.read(scope, wname), w_after)
        return {"w": w_after}

    got, want = _both(scenario)
    _close(got, want, "weight")


def _fed_counter(fluid):
    w = fluid.layers.create_global_var([4], 0.0, "float32",
                                       persistable=True, name="fed_w")
    fluid.default_main_program().global_block().append_op(
        type="scale", inputs={"X": [w]}, outputs={"Out": [w]},
        attrs={"scale": 1.0, "bias": 1.0})
    return w


def test_fed_written_persistable_feed_wins():
    feeds = [{"fed_w": np.full((4,), 10.0 * k, np.float32)}
             for k in range(4)]

    def scenario(pkg, prepared=True):
        main, startup, _ = _programs(pkg, _fed_counter)
        scope = pkg.scope()
        exe = pkg.exe()
        exe.run(startup, scope=scope)
        if prepared:
            prep = exe.prepare(main, feed_specs=feeds[0],
                               fetch_list=["fed_w"], scope=scope)
            outs = [np.asarray(prep.run_prepared(f)[0]) for f in feeds]
        else:
            outs = [exe.run(main, feed=f, fetch_list=["fed_w"],
                            scope=scope)[0] for f in feeds]
        return _losses(outs), {"fed_w": pkg.read(scope, "fed_w")}

    got, want = _both(scenario)
    by_run = scenario(PORT, prepared=False)
    for k, f in enumerate(feeds):                   # each step: feed + 1
        np.testing.assert_array_equal(got[0][k], f["fed_w"] + 1)
    _equal(got[0], by_run[0], "out")
    _equal(got[1], by_run[1], "fed_w")
    _equal(got[0], want[0], "out")
    _equal(got[1], want[1], "fed_w")


def _probe(fluid):
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    probe = fluid.layers.create_global_var([1], 0.0, "float32",
                                           persistable=True, name="probe")
    m = fluid.layers.mean(x)
    fluid.default_main_program().global_block().append_op(
        type="assign", inputs={"X": [m]}, outputs={"Out": [probe]})
    return probe


def test_external_write_to_write_only_persistable_wins():
    marker = np.full((1,), 123.0, np.float32)

    def scenario(pkg):
        main, startup, _ = _programs(pkg, _probe)
        scope = pkg.scope()
        exe = pkg.exe()
        exe.run(startup, scope=scope)
        prep = exe.prepare(main, feed_specs=["x"], fetch_list=[],
                           scope=scope)
        prep.run_prepared({"x": np.ones((2, 4), np.float32)})   # dirty
        pkg.load(scope, {"probe": marker})
        seen = pkg.read(scope, "probe")         # flushes: ours loses
        prep.run_prepared({"x": np.full((2, 4), 8.0, np.float32)})
        prep.sync_scope()
        return {"seen": seen, "after": pkg.read(scope, "probe")}

    got, want = _both(scenario)
    np.testing.assert_array_equal(got["seen"], marker)
    np.testing.assert_array_equal(got["after"], np.full((1,), 8.0,
                                                        np.float32))
    _equal(got, want, "probe")


def test_prepare_rejects_host_ops():
    """A block with a host op: prepare() raises ValueError (callers fall
    back to run()), as the reference's does for its Print op."""
    errors = {}
    for pkg in (PORT, JAX):
        fluid = pkg.fluid
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[2], dtype="float32")
            y = fluid.layers.scale(x, scale=2.0)
            fluid.layers.Print(y)
        scope = pkg.scope()
        exe = pkg.exe()
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match="host op") as err:
            exe.prepare(main, feed_specs=["x"], fetch_list=[y], scope=scope)
        errors[pkg.name] = err.value
    assert "print" in str(errors["port"])


def test_prepared_feed_name_errors():
    init = _init(_mlp)
    feed = _feeds(1)[0]
    for pkg in (PORT, JAX):
        main, _, loss = _programs(pkg, _mlp)
        scope = pkg.scope()
        pkg.load(scope, init)
        prep = pkg.exe().prepare(main, feed_specs=feed, fetch_list=[loss],
                                 scope=scope)
        with pytest.raises(KeyError, match="expects feed"):
            prep.run_prepared({"x": feed["x"]})     # 'y' missing
        lr = next(v.name for v in main.list_vars()
                  if v.persistable and "learning_rate" in v.name)
        with pytest.raises(ValueError, match="device-resident"):
            prep.run_prepared(dict(feed, **{lr: np.ones(1, np.float32)}))


# ------------------------------------------------- shapes and the bench

def test_drifted_batch_raises_shape_mismatch_and_run_takes_it():
    """With a sample feed the prepared step's shapes are fixed (on a
    card, those of its captured graph): another batch size raises
    PreparedShapeMismatch, a ValueError, and run() takes that batch from
    the flushed state; prepared from feed names alone, the CPU step
    takes any batch."""
    init = _init(_mlp)
    feeds = _feeds(2) + _feeds(1, batch=3, seed=1)
    main, _, loss = _programs(PORT, _mlp)

    def drive(feed_specs):
        scope = PORT.scope()
        PORT.load(scope, init)
        exe = PORT.exe()
        prep = exe.prepare(main, feed_specs=feed_specs, fetch_list=[loss],
                           scope=scope)
        losses = [prep.run_prepared(f, return_numpy=True)[0]
                  for f in feeds[:2]]
        return exe, scope, prep, losses

    exe, scope, prep, losses = drive(feeds[0])
    with pytest.raises(PreparedShapeMismatch, match="shape"):
        prep.run_prepared(feeds[2])
    assert issubclass(PreparedShapeMismatch, ValueError)
    losses.append(exe.run(main, feed=feeds[2], fetch_list=[loss],
                          scope=scope)[0])
    exe, scope, prep, names_only = drive(["x", "y"])
    names_only.append(prep.run_prepared(feeds[2], return_numpy=True)[0])
    _equal(_losses(losses), _losses(names_only), "loss")


def test_bench_entry_falls_back_to_run_on_a_drifted_batch(monkeypatch):
    """The bench entry's loop (bench.py's): a batch of another shape
    syncs the prepared state and runs through run() from then on; the
    losses are the run()-only loop's, bit for bit."""
    from paddle_tpu_torch.tools import bench

    feeds = _feeds(2) + _feeds(1, batch=3, seed=1)
    out = {}
    for prepared in ("1", "0"):
        monkeypatch.setenv("BENCH_PREPARED", prepared)
        # the port's startup is seeded: both loops start alike
        main, startup, loss = _programs(PORT, _mlp)
        out[prepared] = bench._train(tfluid, tfluid.CPUPlace(), main,
                                     startup, loss, feeds, 3)
    losses, step_ms, dtypes, prepared_steps = out["1"]
    assert prepared_steps == 2 and len(step_ms) == 3
    assert dtypes == ["float32"]
    assert out["0"][3] == 0
    assert losses == out["0"][0]


def _random_fed_block(fluid):
    """A fed block that draws: uniform noise (fetched) added to a
    persistable, and the mean of the feed."""
    w = _random_block(fluid)
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    return ["noise", fluid.layers.mean(x).name, w.name]


def test_refused_step_draws_no_seed_so_run_draws_what_run_draws():
    """A drifted batch refused by the prepared step (PreparedShapeMismatch)
    draws no seed: the run() that takes it, and the prepared steps after
    it, draw what a run()-only loop draws at each step, driven by hand
    and through ParallelExecutor's fallback."""
    feeds = [{"x": np.full((b, 4), float(b), np.float32)}
             for b in (2, 3, 2, 2)]

    def drive(how):
        main, startup, fetch = _programs(PORT, _random_fed_block)
        main.random_seed = 11
        scope = PORT.scope()
        exe = PORT.exe()
        exe.run(startup, scope=scope)
        if how == "pe":
            pe = tfluid.ParallelExecutor(use_cuda=False, main_program=main,
                                         scope=scope)
            out = [pe.run(fetch, feed=f) for f in feeds]
            assert len(pe._prepared) == 1
            return out
        if how == "run":
            return [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                    for f in feeds]
        prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=fetch,
                           scope=scope)
        out = []
        for f in feeds:
            try:
                out.append(prep.run_prepared(f, return_numpy=True))
            except PreparedShapeMismatch:
                prep.sync_scope()
                out.append(exe.run(main, feed=f, fetch_list=fetch,
                                   scope=scope))
        return out

    want = drive("run")
    for how in ("prepared", "pe"):
        got = drive(how)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b, err_msg=how)
    assert not np.array_equal(want[0][0], want[1][0])


def test_run_and_prepare_share_one_plan_whatever_the_batch():
    """The plan depends on no feed shape and no flag: run() at two batch
    sizes and prepare() use one cache entry."""
    init = _init(_mlp)
    main, _, loss = _programs(PORT, _mlp)
    scope = PORT.scope()
    PORT.load(scope, init)
    exe = PORT.exe()
    for batch in (4, 3):
        exe.run(main, feed=_feeds(1, batch=batch)[0], fetch_list=[loss],
                scope=scope)
    with exe.prepare(main, feed_specs=_feeds(1)[0], fetch_list=[loss],
                     scope=scope) as prep:
        prep.run_prepared(_feeds(1)[0])
    assert len(exe._core._cache) == 1


def test_a_flag_changed_after_prepare_raises():
    """The prepared step keeps the lowering's flags of prepare() (a
    captured graph bakes them in): a step after one changed raises
    RuntimeError, before it draws a seed, on the CPU as on a card."""
    init = _init(_mlp)
    main, _, loss = _programs(PORT, _mlp)
    scope = PORT.scope()
    PORT.load(scope, init)
    prep = PORT.exe().prepare(main, feed_specs=_feeds(1)[0],
                              fetch_list=[loss], scope=scope)
    prep.run_prepared(_feeds(1)[0])
    counter = scope._rng_counter
    before = FLAGS.bn_bf16
    FLAGS.bn_bf16 = not before
    try:
        with pytest.raises(RuntimeError, match="prepare again"):
            prep.run_prepared(_feeds(1)[0])
    finally:
        FLAGS.bn_bf16 = before
    assert scope._rng_counter == counter
    prep.run_prepared(_feeds(1)[0])


def _assign_value_block(fluid):
    w = fluid.layers.create_global_var([3], 0.0, "float32",
                                       persistable=True, name="av_w")
    block = fluid.default_main_program().global_block()
    c = block.create_var(name="av_c", shape=[3], dtype="float32")
    block.append_op(type="assign_value", outputs={"Out": [c]},
                    attrs={"shape": [3], "dtype": DataType.FP32,
                           "fp32_values": [1.0, 2.0, 3.0]})
    block.append_op(type="elementwise_add", inputs={"X": [w], "Y": [c]},
                    outputs={"Out": [w]})
    return w


@pytest.mark.parametrize("block,match", [
    (_random_block, "item 2"), (_assign_value_block, "assign_value")])
def test_a_step_a_graph_cannot_replay_is_uncapturable(block, match):
    """The refusals prepare() makes on a card, from the block's plan:
    assign_value (a copy from host memory each step); Uncapturable is a
    NotImplementedError.  A random op was refused until ROADMAP queue 1
    item 2 gave the captured step its random stream (a replay draws
    afresh, ``lowering.RandomStream``): it is not refused now."""
    main, _, w = _programs(PORT, block)
    core = ExecutorCore(tfluid.CPUPlace())
    entry = core._entry(main.desc, 0, [w.name])
    assert issubclass(Uncapturable, NotImplementedError)
    if block is _random_block:
        core._refuse_uncapturable(entry)
        return
    with pytest.raises(Uncapturable, match=match):
        core._refuse_uncapturable(entry)


def test_parallel_executor_runs_an_uncapturable_program_through_run(
        monkeypatch):
    """prepare() refusing a step a graph cannot replay (here with the
    card's refusals applied on the CPU: assign_value's, since random
    ops are captured now) sends ParallelExecutor to run(), once for the
    signature: its steps update what run()'s do."""
    real, calls = ExecutorCore.prepare, []

    def as_on_a_card(self, program, feed_specs, fetch_list, scope=None,
                     block_id=0):
        calls.append(program)
        self._refuse_uncapturable(
            self._entry(program, block_id, list(fetch_list)))
        return real(self, program, feed_specs, fetch_list, scope, block_id)

    out = {}
    for how in ("pe", "run"):
        main, startup, w = _programs(PORT, _assign_value_block)
        main.random_seed = 5
        scope = PORT.scope()
        exe = PORT.exe()
        exe.run(startup, scope=scope)
        if how == "pe":
            monkeypatch.setattr(ExecutorCore, "prepare", as_on_a_card)
            pe = tfluid.ParallelExecutor(use_cuda=False, main_program=main,
                                         scope=scope)
            out[how] = [pe.run([w.name])[0] for _ in range(STEPS)]
            assert not pe._prepared and len(pe._unpreparable) == 1
            monkeypatch.setattr(ExecutorCore, "prepare", real)
        else:
            out[how] = [exe.run(main, fetch_list=[w], scope=scope)[0]
                        for _ in range(STEPS)]
    assert len(calls) == 1
    for a, b in zip(out["pe"], out["run"]):
        np.testing.assert_array_equal(a, b)
