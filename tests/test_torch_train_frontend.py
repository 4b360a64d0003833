"""The training front end of the port against the JAX package, on the
CPU: learning-rate schedules, regularizers, gradient clips, the other
optimizers, ModelAverage and the other initializers.

- For each optimizer (Adamax, DecayedAdagrad, Adadelta, RMSProp, Ftrl,
  and Momentum under a per-parameter learning rate), regularizer (L1 /
  L2 on the optimizer and on a ``ParamAttr``, L2 on a SelectedRows
  gradient), clip (by value, by norm, by global norm in one group and
  in two) and schedule (the six decays, staircase and cycling forms
  included): the same layer calls build the same ProgramDesc, main and
  startup, byte for byte; and from the reference's startup values four
  steps of a small fc program follow its losses, learning rates and
  persistables within 1e-6 or twice the reference's own spread (its
  run from startup values one f32 ulp up), whichever is larger.
- ``piecewise_decay`` crosses its boundaries; the noam learning rate
  equals its float64 formula within one f32 ulp; the step counter goes
  through a mid-loop checkpoint and the resumed run continues the
  schedule bit for bit.
- A two-layer narrow LM built from the reference's public API
  (``transformer_lm``, ``softmax_with_cross_entropy``, ``mean``,
  ``GradientClipByGlobalNorm``, ``noam_decay``, ``L2Decay``, Adam), 3
  steps in f32 (losses rtol 1e-5) and under bf16 AMP (rtol 1e-2, as
  ``test_torch_lm_amp.py``), and its prepared step bit for bit with
  ``run()``.
- ModelAverage: its accumulators against a float64 replay of the
  reference op's window rule, ``apply`` (the average) and ``restore``
  (the trained parameters, bit for bit).
- MSRA, Bilinear and NumpyArray initializers: the reference's startup
  descs; the deterministic ones its values.
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

STEPS = 4
TOL = 1e-6
COUNTER = "@LR_DECAY_COUNTER@"


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


# --- the small fc program ------------------------------------------------

def _opt(kind, **kw):
    return lambda f, lr, reg: getattr(f.optimizer, kind)(
        learning_rate=lr, regularization=reg, **kw)


OPTIMIZERS = {
    "adamax": _opt("Adamax"),
    "decayed_adagrad": _opt("DecayedAdagrad"),
    "adadelta": _opt("Adadelta"),
    "rmsprop": _opt("RMSProp", momentum=0.5),
    "ftrl": _opt("Ftrl", l1=0.01, l2=0.01),
    "adam": _opt("Adam"),
    "momentum": _opt("Momentum", momentum=0.9),
}
SCHEDULES = {
    "exponential": lambda L: L.exponential_decay(0.05, 2, 0.5),
    "exponential_staircase": lambda L: L.exponential_decay(
        0.05, 2, 0.5, staircase=True),
    "natural_exp": lambda L: L.natural_exp_decay(0.05, 2, 0.5),
    "inverse_time": lambda L: L.inverse_time_decay(0.05, 2, 0.5,
                                                   staircase=True),
    "polynomial": lambda L: L.polynomial_decay(0.05, 3, 0.001, power=2.0),
    "polynomial_cycle": lambda L: L.polynomial_decay(0.05, 2, 0.001,
                                                     cycle=True),
    "piecewise": lambda L: L.piecewise_decay([2, 3], [0.05, 0.02, 0.01]),
    "noam": lambda L: L.noam_decay(16, 3, learning_rate=0.05),
}
CLIPS = {
    "by_value": lambda f: f.clip.GradientClipByValue(0.02),
    "by_norm": lambda f: f.clip.GradientClipByNorm(0.05),
    "by_global_norm": lambda f: f.clip.GradientClipByGlobalNorm(0.05),
}
REGULARIZERS = {
    "l2": lambda f: f.regularizer.L2Decay(0.05),
    "l1": lambda f: f.regularizer.L1Decay(0.05),
}


def _fc(fluid, opt="adam", lr=0.01, clip=None, reg=None, param_reg=None,
        param_lr=1.0, groups=False, sparse=False):
    """x [8] (and with ``sparse`` an is_sparse embedding of ids) -> fc 16
    tanh -> fc 1, squared error; returns (loss, the learning-rate var
    or None)."""
    L = fluid.layers
    x = L.data(name="x", shape=[8], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    if sparse:
        ids = L.data(name="ids", shape=[1], dtype="int64")
        emb = L.embedding(ids, size=[20, 8], is_sparse=True)
        x = L.elementwise_add(x, L.reshape(emb, [-1, 8]))
    attr = fluid.ParamAttr(
        regularizer=param_reg(fluid) if param_reg else None,
        learning_rate=param_lr)
    h = L.fc(x, size=16, act="tanh", param_attr=attr)
    p = L.fc(h, size=1)
    loss = L.mean(L.square_error_cost(p, y))
    if clip is not None:
        params = fluid.default_main_program().global_block().all_parameters()
        if groups:      # the first fc in one group, the rest in another
            fluid.clip.set_gradient_clip(
                fluid.clip.GradientClipByGlobalNorm(0.03, "first"),
                param_list=params[:2])
            fluid.clip.set_gradient_clip(clip(fluid),
                                         param_list=params[2:])
        else:
            fluid.clip.set_gradient_clip(clip(fluid))
    lr_var = lr(L) if callable(lr) else None
    OPTIMIZERS[opt](fluid, lr_var if lr_var is not None else lr,
                    reg(fluid) if reg else None).minimize(loss)
    return loss, lr_var


def _build(fluid, fn, **kw):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = fn(fluid, **kw)
    return main, startup, out


def _feeds(n, sparse=False, seed=0):
    rng = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        f = {"x": rng.randn(4, 8).astype(np.float32),
             "y": rng.randn(4, 1).astype(np.float32)}
        if sparse:      # a duplicate id in every batch
            ids = rng.randint(0, 20, (4, 1))
            ids[1] = ids[0]
            f["ids"] = ids.astype(np.int64)
        out.append(f)
    return out


def _persist(main):
    return sorted(n for n, v in main.desc.blocks[0].vars.items()
                  if v.persistable)


def _reference_run(jmain, jstart, fetch, feeds, nudge=False):
    """The reference's run from its startup values (with ``nudge``, the
    float persistables but the learning rates and the step counter one
    f32 ulp up); returns (fetches a step, final persistables, startup
    values)."""
    js = JScope()
    exe = jfluid.Executor(jfluid.CPUPlace())
    exe.run(jstart, scope=js)
    init = {n: np.array(js.find_var(n)) for n in _persist(jmain)
            if js.has_var(n)}
    if nudge:
        for n, v in init.items():
            if v.dtype == np.float32 and "learning_rate" not in n \
                    and n != COUNTER:
                js.set(n, np.nextafter(v, np.float32(np.inf)))
    outs = [[np.asarray(a) for a in exe.run(jmain, feed=f,
                                            fetch_list=fetch, scope=js)]
            for f in feeds]
    return outs, {n: np.asarray(js.find_var(n)) for n in init}, init


def _track(fn, sparse=False, **kw):
    """Build ``fn`` in both packages (the same descs), run STEPS steps
    in each from the reference's startup values, and hold the port to
    the reference within max(TOL, twice the reference's own spread)."""
    jmain, jstart, (jloss, jlr) = _build(jfluid, fn, sparse=sparse, **kw)
    tmain, tstart, (tloss, tlr) = _build(tfluid, fn, sparse=sparse, **kw)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    fetch = [jloss.name] + ([jlr.name] if jlr is not None else [])
    feeds = _feeds(STEPS, sparse)
    want, jp, init = _reference_run(jmain, jstart, fetch, feeds)
    moved, mp, _ = _reference_run(jmain, jstart, fetch, feeds, nudge=True)
    ts = tfluid.Scope()
    set_scope_arrays(ts, init, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [exe.run(tmain, feed=f, fetch_list=fetch, scope=ts)
           for f in feeds]
    for k, (w, m, g) in enumerate(zip(want, moved, got)):
        for i, (a, b, c) in enumerate(zip(w, m, g)):
            bar = max(TOL, 2 * float(np.abs(b.astype(np.float64) - a).max()))
            np.testing.assert_allclose(c, a, rtol=bar, atol=bar,
                                       err_msg="step %d fetch %d" % (k, i))
    tp = get_scope_arrays(ts, list(jp))
    for n in jp:
        bar = max(TOL, 2 * float(np.abs(mp[n].astype(np.float64)
                                        - jp[n]).max(initial=0.0)))
        np.testing.assert_allclose(tp[n], jp[n], rtol=bar, atol=bar,
                                   err_msg=n)
    return tmain, want, got


@pytest.mark.parametrize("opt", sorted(OPTIMIZERS))
def test_optimizer_tracks_the_reference(opt):
    """Momentum under a per-parameter learning rate (the ``scale`` op
    on the global one); the others as they are."""
    main, _, _ = _track(_fc, opt=opt, param_lr=2.0 if opt == "momentum"
                        else 1.0)
    ops = [op.type for op in main.desc.blocks[0].ops]
    assert ops.count(opt) == 4
    assert ("scale" in ops) is (opt == "momentum")


@pytest.mark.parametrize("reg,where", [("l2", "optimizer"),
                                       ("l1", "optimizer"),
                                       ("l2", "param_attr"),
                                       ("l1", "param_attr_over_l2")])
def test_regularizer_tracks_the_reference(reg, where):
    """A ParamAttr's regularizer wins over the optimizer's (L1 on the
    first fc's weight, L2 on the rest)."""
    kw = {}
    if where == "optimizer":
        kw["reg"] = REGULARIZERS[reg]
    elif where == "param_attr":
        kw["param_reg"] = REGULARIZERS[reg]
    else:
        kw.update(reg=REGULARIZERS["l2"], param_reg=REGULARIZERS[reg])
    main, _, _ = _track(_fc, opt="momentum", **kw)
    ops = [op.type for op in main.desc.blocks[0].ops]
    n_reg = 1 if where == "param_attr" else 4
    assert sum(op.endswith("@REGULARIZED") for op in
               [n for o in main.desc.blocks[0].ops if o.type == "sum"
                for n in o.output_arg_names()]) == n_reg
    assert ops.count("sign") == (0 if reg == "l2" else 1 if
                                 where != "optimizer" else 4)


def test_l2_decay_of_a_selected_rows_gradient():
    """An is_sparse embedding under L2Decay and SGD: the decay's ``sum``
    densifies the SelectedRows gradient, as the reference's does."""
    main, _, _ = _track(_fc, opt="momentum", reg=REGULARIZERS["l2"],
                        sparse=True)
    ops = main.desc.blocks[0].ops
    table = [op for op in ops if op.type == "lookup_table_grad"]
    assert table and table[0].attrs["is_sparse"].value


@pytest.mark.parametrize("clip", sorted(CLIPS) + ["by_global_norm_groups"])
def test_clip_tracks_the_reference(clip):
    groups = clip.endswith("_groups")
    main, _, _ = _track(_fc, opt="adam", lr=0.05,
                        clip=CLIPS[clip.replace("_groups", "")],
                        groups=groups)
    ops = [op.type for op in main.desc.blocks[0].ops]
    if clip.startswith("by_global_norm"):
        # per gradient square -> reduce_sum; a group's sum, sqrt, max,
        # div; an elementwise_mul on each gradient
        # (and the loss's square)
        assert ops.count("square") == 5 and ops.count("reduce_sum") == 4
        assert ops.count("sqrt") == (2 if groups else 1)
        assert ops.count("elementwise_mul") == 4
    else:
        assert ops.count("clip" if clip == "by_value" else
                         "clip_by_norm") == 4


def test_error_clip_by_value_appends_the_references_op():
    def fn(fluid):
        x = fluid.layers.data(name="x", shape=[3], dtype="float32")
        y = fluid.layers.scale(x, 2.0)
        fluid.clip.ErrorClipByValue(0.5)._append_clip_op(
            fluid.default_main_program().global_block(), y.name)
        return y

    jmain = _build(jfluid, fn)[0]
    tmain = _build(tfluid, fn)[0]
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tmain.desc.blocks[0].ops[-1].type == "clip"
    assert tfluid.clip.error_clip_callback(None, None) is None


@pytest.mark.parametrize("schedule", sorted(SCHEDULES))
def test_schedule_tracks_the_reference(schedule):
    """The learning rate each step (fetched) and the training under it;
    the counter is prepended to the block and counts the runs."""
    main, want, got = _track(_fc, opt="momentum",
                             lr=SCHEDULES[schedule])
    ops = main.desc.blocks[0].ops
    assert ops[0].type == "increment" and \
        ops[0].input("X") == [COUNTER] == ops[0].output("Out")
    assert main.desc.blocks[0].vars[COUNTER].persistable


def test_piecewise_decay_crosses_its_boundaries():
    """values[sum(step >= b)]: 0.05 at steps 1, 0.02 at 2, 0.01 from 3,
    in both packages; its table is one assign_value op."""
    main, want, got = _track(_fc, opt="momentum", lr=SCHEDULES["piecewise"])
    lrs = [float(g[1][0]) for g in got]
    assert lrs == [np.float32(v) for v in (0.05, 0.02, 0.01, 0.01)]
    assert [op.type for op in main.desc.blocks[0].ops].count(
        "assign_value") == 1


def test_noam_decay_is_its_formula_within_one_ulp():
    """d**-0.5 * min(s**-0.5, warmup**-1.5 * s), s = 1 at the first run
    (the increment comes first), against float64 on the host."""
    _, _, got = _track(_fc, opt="momentum", lr=SCHEDULES["noam"])
    for s, g in enumerate(got, 1):
        want = 0.05 * 16 ** -0.5 * min(s ** -0.5, 3 ** -1.5 * s)
        lr = np.float32(g[1][0])
        assert abs(float(lr) - want) <= float(np.spacing(np.float32(want)))


def test_the_counter_goes_through_a_mid_loop_checkpoint(tmp_path):
    """Two prepared steps, save_checkpoint, two more; a fresh scope that
    loads the checkpoint runs the last two again: the counter, the
    learning rates and every persistable bit for bit."""
    main, startup, (loss, lr) = _build(tfluid, _fc, opt="adam",
                                       lr=SCHEDULES["noam"])
    feeds = _feeds(4)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss, lr],
                       scope=scope)
    first = [prep.run_prepared(f, return_numpy=True) for f in feeds[:2]]
    ckpt = str(tmp_path / "ckpt")
    with tfluid.scope_guard(scope):
        tfluid.io.save_checkpoint(exe, ckpt, main_program=main)
    rest = [prep.run_prepared(f, return_numpy=True) for f in feeds[2:]]
    prep.sync_scope()
    done = get_scope_arrays(scope, _persist(main))
    assert done[COUNTER][0] == 4.0
    scope2 = tfluid.Scope()
    exe.run(startup, scope=scope2)
    with tfluid.scope_guard(scope2):
        tfluid.io.load_checkpoint(exe, ckpt, main_program=main)
    assert get_scope_arrays(scope2, [COUNTER])[COUNTER][0] == 2.0
    again = [exe.run(main, feed=f, fetch_list=[loss, lr], scope=scope2)
             for f in feeds[2:]]
    for a, b in zip(rest, again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert float(first[1][1][0]) != float(rest[0][1][0])
    redo = get_scope_arrays(scope2, _persist(main))
    for n in done:
        np.testing.assert_array_equal(redo[n], done[n], err_msg=n)


# --- the LM under noam + global-norm clip + L2 ----------------------------

LM = dict(vocab_size=64, seq_len=16, d_model=32, n_head=2, n_layers=2,
          d_ff=64)
LM_RTOL = {False: 1e-5, True: 1e-2}


def sched_lm(fluid, transformer, cfg, schedule="noam", fuse=False):
    """The flagship LM's training program under a schedule, built with
    the reference's public API: ``transformer_lm``,
    ``softmax_with_cross_entropy``, ``mean``, a global-norm clip of 1.0,
    Adam with L2Decay(1e-4) over ``noam_decay(d_model, 4000)`` or
    ``piecewise_decay([2, 4], [1e-3, 5e-4, 2.5e-4])``, with ``fuse``
    the fused-block program (the fuse pass before ``minimize``); returns
    (loss, learning rate)."""
    L = fluid.layers
    seq = cfg["seq_len"]
    src = L.data(name="src", shape=[seq], dtype="int64")
    label = L.data(name="label", shape=[seq, 1], dtype="int64")
    logits = transformer.transformer_lm(
        src, cfg["vocab_size"], seq, cfg["d_model"], cfg["n_head"],
        cfg["n_layers"], cfg["d_ff"])
    loss = L.mean(L.softmax_with_cross_entropy(logits, label))
    if fuse:
        fluid.transpiler.TransformerFuseTranspiler().transpile(
            fluid.default_main_program())
    fluid.clip.set_gradient_clip(
        fluid.clip.GradientClipByGlobalNorm(clip_norm=1.0))
    if schedule == "noam":
        lr = L.noam_decay(cfg["d_model"], 4000)
    else:
        lr = L.piecewise_decay([2, 4], [1e-3, 5e-4, 2.5e-4])
    fluid.optimizer.Adam(learning_rate=lr,
                         regularization=fluid.regularizer.L2Decay(1e-4)
                         ).minimize(loss)
    return loss, lr


def _lm_feed(seed=0, batch=2):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, LM["vocab_size"],
                       (batch, LM["seq_len"] + 1)).astype(np.int64)
    return {"src": toks[:, :-1], "label": toks[:, 1:, None]}


@pytest.mark.parametrize("amp", [False, True], ids=["f32", "amp"])
def test_lm_under_noam_clip_and_l2_tracks_the_reference(amp):
    from paddle_tpu.models import transformer as jtr
    from paddle_tpu_torch.models import transformer as ttr

    progs = {}
    for fluid, mod in ((jfluid, jtr), (tfluid, ttr)):
        main, startup, (loss, lr) = _build(
            fluid, lambda f: sched_lm(f, mod, LM))
        if amp:
            fluid.transpiler.Float16Transpiler().transpile(main)
        progs[fluid] = (main, startup, loss, lr)
    jmain, jstart, jloss, jlr = progs[jfluid]
    tmain, tstart, tloss, tlr = progs[tfluid]
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    feeds = [_lm_feed()] * 3
    fetch = [jloss.name, jlr.name]
    want, jp, init = _reference_run(jmain, jstart, fetch, feeds)
    ts = tfluid.Scope()
    set_scope_arrays(ts, init, "cpu")
    exe = tfluid.Executor(tfluid.CPUPlace())
    got = [exe.run(tmain, feed=f, fetch_list=fetch, scope=ts)
           for f in feeds]
    np.testing.assert_allclose([g[0][0] for g in got],
                               [w[0][0] for w in want], rtol=LM_RTOL[amp])
    for s, g in enumerate(got, 1):
        lr = 32 ** -0.5 * min(s ** -0.5, 4000 ** -1.5 * s)
        assert abs(float(g[1][0]) - lr) <= float(np.spacing(np.float32(lr)))
    assert got[-1][0][0] < got[0][0][0]
    tp = get_scope_arrays(ts, [COUNTER])
    assert tp[COUNTER][0] == 3.0 == jp[COUNTER][0]
    # the prepared step is run()'s, bit for bit
    ts2 = tfluid.Scope()
    set_scope_arrays(ts2, init, "cpu")
    prep = exe.prepare(tmain, feed_specs=feeds[0], fetch_list=fetch,
                       scope=ts2)
    for f, g in zip(feeds, got):
        for a, b in zip(prep.run_prepared(f, return_numpy=True), g):
            np.testing.assert_array_equal(a, b)
    prep.sync_scope()
    names = _persist(tmain)
    a, b = get_scope_arrays(ts2, names), get_scope_arrays(ts, names)
    for n in names:
        np.testing.assert_array_equal(a[n], b[n], err_msg=n)


def test_lm_under_piecewise_decay_crosses_both_boundaries():
    """The fused-block LM under AMP with piecewise_decay([2, 4], ...):
    five prepared steps bit for bit with run(), their learning rates
    1e-3, 5e-4, 5e-4, 2.5e-4, 2.5e-4 (the table a device constant)."""
    from paddle_tpu_torch.models import transformer as ttr

    main, startup, (loss, lr) = _build(
        tfluid, lambda f: sched_lm(f, ttr, LM, schedule="piecewise",
                                   fuse=True))
    tfluid.transpiler.Float16Transpiler().transpile(main)
    exe = tfluid.Executor(tfluid.CPUPlace())
    out = {}
    for how in ("prepared", "run"):
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        if how == "prepared":
            prep = exe.prepare(main, feed_specs=_lm_feed(),
                               fetch_list=[loss, lr], scope=scope)
            out[how] = [prep.run_prepared(_lm_feed(), return_numpy=True)
                        for _ in range(5)]
        else:
            out[how] = [exe.run(main, feed=_lm_feed(),
                                fetch_list=[loss, lr], scope=scope)
                        for _ in range(5)]
    assert [float(o[1][0]) for o in out["run"]] == [
        np.float32(v) for v in (1e-3, 5e-4, 5e-4, 2.5e-4, 2.5e-4)]
    for a, b in zip(out["prepared"], out["run"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# --- ModelAverage ----------------------------------------------------------

def _accumulate(state, param, window, lo, hi):
    """The reference op's window rule (average_accumulates), in float64."""
    s1, s2, s3, n_acc, old, n_upd = state
    n_acc, n_upd = n_acc + 1, n_upd + 1
    s1 = s1 + param
    w = max(min(n_upd * window, float(hi)), float(lo))
    if n_acc >= w:
        s2, s1, old, n_acc = s2 + s1, np.zeros_like(s1), old + n_acc, 0
    if old >= 2.0 * w:
        s3, s2, old = s2, np.zeros_like(s2), n_acc
    return s1, s2, s3, n_acc, old, n_upd


def test_model_average_accumulates_applies_and_restores():
    def fn(fluid):
        loss, _ = _fc(fluid, opt="momentum", lr=0.05)
        avg = fluid.optimizer.ModelAverage(0.5, min_average_window=2,
                                           max_average_window=3)
        return loss, avg

    main, startup, (loss, avg) = _build(tfluid, fn)
    ops = main.desc.blocks[0].ops
    acc_ops = [op for op in ops if op.type == "average_accumulates"]
    params = [p.name for p in main.all_parameters()]
    assert [op.input("Param")[0] for op in acc_ops] == params
    assert all(op.role & 0x0002 for op in acc_ops)     # Optimize
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(startup, scope=scope)
    state = {p: None for p in params}
    for f in _feeds(5):
        exe.run(main, feed=f, fetch_list=[loss], scope=scope)
        vals = get_scope_arrays(scope, params)
        for p in params:
            st = state[p] or (0.0, 0.0, 0.0, 0, 0, 0)
            state[p] = _accumulate(st, vals[p].astype(np.float64), 0.5,
                                   2, 3)
    trained = get_scope_arrays(scope, params)
    with tfluid.scope_guard(scope):
        with avg.apply(exe):
            applied = get_scope_arrays(scope, params)
        restored = get_scope_arrays(scope, params)
        with avg.apply(exe, need_restore=False):
            pass
        kept = get_scope_arrays(scope, params)
        avg.restore(exe)
    for p in params:
        s1, s2, s3, n_acc, old, _ = state[p]
        want = (s1 + s2 + s3) / (n_acc + old)
        np.testing.assert_allclose(applied[p], want, rtol=1e-6, atol=1e-7,
                                   err_msg=p)
        np.testing.assert_array_equal(kept[p], applied[p])
        np.testing.assert_array_equal(restored[p], trained[p])
        np.testing.assert_array_equal(
            get_scope_arrays(scope, [p])[p], trained[p])


# --- initializers ----------------------------------------------------------

INITS = {
    "msra_uniform": lambda f: f.initializer.MSRA(),
    "msra_normal": lambda f: f.initializer.MSRAInitializer(uniform=False),
    "bilinear": lambda f: f.initializer.Bilinear(),
    "numpy": lambda f: f.initializer.NumpyArrayInitializer(
        np.arange(2 * 3 * 4 * 4, dtype=np.float32).reshape(2, 3, 4, 4)),
}


@pytest.mark.parametrize("init", sorted(INITS))
def test_initializer_builds_the_references_startup(init):
    def fn(fluid):
        return fluid.layers.create_parameter(
            [2, 3, 4, 4], "float32", name="w",
            default_initializer=INITS[init](fluid))

    jmain, jstart, _ = _build(jfluid, fn)
    tmain, tstart, _ = _build(tfluid, fn)
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    js = JScope()
    jfluid.Executor(jfluid.CPUPlace()).run(jstart, scope=js)
    ts = tfluid.Scope()
    tfluid.Executor(tfluid.CPUPlace()).run(tstart, scope=ts)
    got = get_scope_arrays(ts, ["w"])["w"]
    want = np.asarray(js.find_var("w"))
    assert got.shape == want.shape == (2, 3, 4, 4)
    if init in ("bilinear", "numpy"):
        np.testing.assert_array_equal(got, want)
    elif init == "msra_uniform":
        limit = np.sqrt(6.0 / 48)
        assert np.abs(got).max() <= limit and got.std() > limit / 4
    else:
        assert 0.5 * np.sqrt(2 / 48) < got.std() < 1.5 * np.sqrt(2 / 48)


def test_the_front_end_exports_the_references_names():
    """Every optimizer, regularizer, clip, schedule and initializer name
    of the reference, and the layers of every module but detection."""
    for mod in ("optimizer", "regularizer", "clip", "initializer"):
        assert getattr(tfluid, mod).__all__ == getattr(jfluid, mod).__all__
    from paddle_tpu.fluid.layers import learning_rate_scheduler as jlr
    from paddle_tpu_torch.fluid.layers import learning_rate_scheduler as tlr

    assert tlr.__all__ == jlr.__all__
    for name in tlr.__all__:
        assert getattr(tfluid.layers, name) is getattr(tlr, name)
    from paddle_tpu.fluid.layers import nn as jnn
    from paddle_tpu_torch.fluid.layers import nn as tnn

    assert tnn.__all__ == jnn.__all__ and len(tnn.__all__) == 89
    assert tfluid.layers.ops._GENERATED == [
        n for n in jfluid.layers.ops._GENERATED
        if n in tfluid.layers.ops._GENERATED]
    assert hasattr(tfluid.layers, "square") and \
        hasattr(jfluid.layers, "square")


def test_a_prepared_step_makes_its_constants_once():
    """assign_value and fill hold their values in their attrs: the
    prepared step makes each one's tensor once, at prepare(), and every
    step reads it (on a card the replay copies nothing from the host);
    the steps equal run()'s."""
    from paddle_tpu_torch.core.types import DataType

    def fn(fluid):
        w = fluid.layers.create_global_var([2, 2], 0.0, "float32",
                                           persistable=True, name="cw")
        block = fluid.default_main_program().global_block()
        a = block.create_var(name="ca", shape=[2, 2], dtype="float32")
        f = block.create_var(name="cf", shape=[2, 2], dtype="float32")
        block.append_op(type="assign_value", outputs={"Out": [a]},
                        attrs={"shape": [2, 2], "dtype": DataType.FP32,
                               "fp32_values": [1.0, 2.0, 3.0, 4.0]})
        block.append_op(type="fill", outputs={"Out": [f]},
                        attrs={"shape": [2, 2], "dtype": DataType.FP32,
                               "value": [0.5, 0.25, 0.125, 1.0]})
        s = fluid.layers.elementwise_mul(a, f)
        block.append_op(type="elementwise_add", inputs={"X": [w], "Y": [s]},
                        outputs={"Out": [w]})
        return w

    main, startup, w = _build(tfluid, fn)
    exe = tfluid.Executor(tfluid.CPUPlace())
    out = {}
    for how in ("prepared", "run"):
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        if how == "prepared":
            prep = exe.prepare(main, feed_specs={}, fetch_list=[w],
                               scope=scope)
            consts = prep._prep._step._constants
            assert len(consts) == 2
            out[how] = [prep.run_prepared({}, return_numpy=True)[0]
                        for _ in range(3)]
            assert prep._prep._step._constants is consts
        else:
            out[how] = [exe.run(main, fetch_list=[w], scope=scope)[0]
                        for _ in range(3)]
    step = np.float32([[0.5, 0.5], [0.375, 4.0]])
    for k, (a, b) in enumerate(zip(out["prepared"], out["run"])):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, (k + 1) * step)
