"""Sub-blocks and control flow in the port against the JAX package, on
the CPU, at small sizes.

- one case for each of tests/test_control_flow.py's 13 tests: the same
  program built by both packages (byte for byte the same ProgramDesc),
  the same seeds and feeds, the port's outputs within 1e-6 of the
  reference's (losses over every training step too), integer and bool
  outputs exact and in the reference's dtype;
- each TensorArray op, ``lod_array_length`` / ``max_sequence_len`` in
  the reference's int32, ``conditional_block``'s zero-filled false
  branch (its shape from a run of the true branch on ``meta`` tensors),
  the compare, logical, ``increment``, ``fill_constant_batch_size_like``
  and ``fill_zeros_like`` ops and the added elementwise ops (forward and
  gradient), against the reference op by op;
- ``recurrent`` with ``reverse`` and with ``masked``, forward and every
  gradient, against the reference;
- a DynamicRNN under the Float16Transpiler (bf16 AMP), where
  ``_match_dtype`` pins the f32 carry;
- a random op in a ``recurrent`` body is refused, and ``prepare()``'s
  refusal of host-read control flow walks sub-blocks at any depth (the
  card's graph capture refuses them; on the CPU ``prepare()`` runs
  them).
"""
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

TOL = 1e-6


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _build(fluid, body):
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        out = body(fluid, fluid.layers)
    return main, startup, out


def _names(xs):
    return [x if isinstance(x, str) else x.name for x in xs]


def _run_both(body, feeds=(None,), fetch_of=lambda out: out, spread=False):
    """Build ``body`` in both packages (the same ProgramDesc), run the
    JAX package's startup, copy its persistables into the port's scope,
    and run every feed in ``feeds`` (a callable (fluid, main) -> feed
    dict, or None) through both; returns ([reference fetches],
    [port fetches]) a step, and the two scopes' persistables.  With
    ``spread``, also the reference's own spread (``_ulp_spread``)."""
    jmain, jstart, jout = _build(jfluid, body)
    tmain, tstart, tout = _build(tfluid, body)
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert tstart.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    jnames, tnames = _names(fetch_of(jout)), _names(fetch_of(tout))
    assert jnames == tnames
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    ts = tfluid.Scope()
    set_scope_arrays(ts, {n: np.asarray(js.find_var(n)) for n in persist},
                     "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    want, got = [], []
    for f in feeds:
        jf = f(jfluid, jmain) if f else None
        tf = f(tfluid, tmain) if f else None
        want.append(jexe.run(jmain, feed=jf, fetch_list=jnames, scope=js))
        got.append(texe.run(tmain, feed=tf, fetch_list=tnames, scope=ts))
    jp = {n: np.asarray(js.find_var(n)) for n in persist}
    tp = get_scope_arrays(ts, persist)
    if not spread:
        return want, got, jp, tp
    return want, got, jp, tp, _ulp_spread(jmain, jstart, jnames, feeds,
                                          want, jp)


def _ulp_spread(jmain, jstart, jnames, feeds, want, jp):
    """The reference's own f32 spread over a training run: the same
    steps again from its startup values moved up one ulp (the float
    persistables but the learning rate).  Returns ([each step's loss
    tolerance: twice the largest relative loss spread up to that step,
    never below TOL], {persistable: its absolute tolerance, twice its
    largest spread, never below TOL}); a long run at a high learning
    rate turns chaotic, and from there no bar tighter than its own
    spread holds two correct implementations together."""
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    for n in jp:
        v = np.asarray(js.find_var(n))
        if v.dtype == np.float32 and "learning_rate" not in n:
            js.set(n, np.nextafter(v, np.float32(np.inf)))
    bars, worst = [], 0.0
    for f, w in zip(feeds, want):
        m = jexe.run(jmain, feed=f(jfluid, jmain) if f else None,
                     fetch_list=jnames, scope=js)
        a, b = float(np.ravel(m[0])[0]), float(np.ravel(w[0])[0])
        worst = max(worst, abs(a - b) / abs(b))
        bars.append(max(TOL, 2 * worst))
    moved = {n: np.asarray(js.find_var(n)) for n in jp}
    return bars, {n: max(TOL, 2 * float(np.abs(
        moved[n].astype(np.float64) - jp[n]).max(initial=0.0)))
        for n in jp}


def _agree_trained(want, got, jp, tp, bars):
    """A training run's losses, step by step, and its final persistables
    within the reference's own spread (``_ulp_spread``)."""
    loss_bars, param_bars = bars
    for k, (w, g) in enumerate(zip(want, got)):
        a, b = float(np.ravel(g[0])[0]), float(np.ravel(w[0])[0])
        assert abs(a - b) <= loss_bars[k] * abs(b), (k, a, b, loss_bars[k])
    for n in jp:
        np.testing.assert_allclose(tp[n], jp[n], rtol=0, atol=param_bars[n],
                                   err_msg=n)


def _agree(want, got, tol=TOL):
    for step, (ws, gs) in enumerate(zip(want, got)):
        for i, (w, g) in enumerate(zip(ws, gs)):
            w = np.asarray(w)
            assert g.shape == w.shape, (step, i, g.shape, w.shape)
            if w.dtype.kind in "biu":
                assert g.dtype == w.dtype, (step, i, g.dtype, w.dtype)
                np.testing.assert_array_equal(g, w, err_msg=str((step, i)))
            else:
                np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                           err_msg=str((step, i)))


# ---------------------------------------------------------------------------
# tests/test_control_flow.py, case for case
# ---------------------------------------------------------------------------

def _while_sum(fluid, L):
    i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    n = L.fill_constant(shape=[1], dtype="float32", value=10.0)
    s = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    cond = L.less_than(x=i, y=n)
    w = L.While(cond=cond)
    with w.block():
        s2 = L.elementwise_add(x=s, y=i)
        L.assign(s2, s)
        L.increment(x=i, value=1.0, in_place=True)
        L.less_than(x=i, y=n, cond=cond)
    return [s, i, cond]


def _while_with_array(fluid, L):
    i = L.fill_constant(shape=[1], dtype="int64", value=0)
    n = L.fill_constant(shape=[1], dtype="int64", value=5)
    x = L.fill_constant(shape=[3], dtype="float32", value=1.0)
    arr = L.create_array("float32", element_shape=[3], capacity=8)
    cond = L.less_than(x=i, y=n)
    w = L.While(cond=cond)
    with w.block():
        xi = L.scale(x=x, scale=2.0)
        L.array_write(xi, i, array=arr)
        L.increment(x=i, value=1.0, in_place=True)
        L.less_than(x=i, y=n, cond=cond)
    j = L.fill_constant(shape=[1], dtype="int64", value=3)
    return [L.array_read(arr, j), L.array_length(arr)]


def _array_outside_loop(fluid, L):
    x = L.fill_constant(shape=[2], dtype="float32", value=7.0)
    i0 = L.fill_constant(shape=[1], dtype="int64", value=0)
    i1 = L.fill_constant(shape=[1], dtype="int64", value=1)
    arr = L.array_write(x, i0)
    y = L.scale(x=x, scale=0.5)
    L.array_write(y, i1, array=arr)
    return [L.array_read(arr, i0), L.array_read(arr, i1)]


def _lazy_array(fluid, L):
    x = L.fill_constant(shape=[3], dtype="float32", value=4.0)
    arr = L.create_array("float32")
    i0 = L.fill_constant(shape=[1], dtype="int64", value=0)
    L.array_write(x, i0, array=arr)
    return [L.array_read(arr, i0)]


def _static_accumulator(fluid, L):
    x = L.data(name="x", shape=[4, 3], dtype="float32",
               append_batch_size=True)
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h = rnn.memory(shape=[3], batch_ref=x, init_value=0.0)
        h_new = L.elementwise_add(x=h, y=x_t)
        rnn.update_memory(h, h_new)
        rnn.step_output(h_new)
    return [rnn()]


def _static_rnn_trains(fluid, L):
    x = L.data(name="x", shape=[5, 4], dtype="float32")
    y = L.data(name="y", shape=[2], dtype="float32")
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h = rnn.memory(shape=[8], batch_ref=x)
        h_new = L.fc(input=[x_t, h], size=8, act="tanh", bias_attr=True)
        rnn.update_memory(h, h_new)
        rnn.step_output(h_new)
    out = rnn()
    pred = L.fc(input=L.reduce_mean(out, dim=1), size=2)
    loss = L.mean(L.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return [loss]


def _dynamic_accumulator(fluid, L):
    x = L.data(name="x", shape=[1], dtype="float32", lod_level=1)
    rnn = L.DynamicRNN()
    with rnn.block():
        x_t = rnn.step_input(x)
        h = rnn.memory(shape=[1], batch_ref=x, init_value=0.0)
        h_new = L.elementwise_add(x=h, y=x_t)
        rnn.update_memory(h, h_new)
        rnn.output(h_new)
    return [rnn(), rnn.final_states[0]]


def _ifelse_trains(fluid, L):
    x = L.data(name="x", shape=[4], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    row_sum = L.reduce_sum(x, dim=1, keep_dim=True)
    cond = L.greater_than(row_sum, zero)
    ie = L.IfElse(cond)
    with ie.true_block():
        xt = ie.input(x)
        ie.output(L.fc(input=xt, size=1,
                       param_attr=fluid.ParamAttr(name="w_shared")))
    with ie.false_block():
        xf = ie.input(x)
        ie.output(L.scale(L.fc(input=xf, size=1,
                               param_attr=fluid.ParamAttr(name="w_shared")),
                          scale=-1.0))
    pred = ie()
    loss = L.mean(L.square_error_cost(pred, y))
    fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
    return [loss, pred]


def _switch(fluid, L):
    step = L.data(name="step", shape=[1], dtype="float32",
                  append_batch_size=False)
    lr = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    b1 = L.fill_constant(shape=[1], dtype="float32", value=5.0)
    b2 = L.fill_constant(shape=[1], dtype="float32", value=10.0)
    sw = L.Switch()
    with sw.case(L.less_than(step, b1)):
        L.assign(L.fill_constant(shape=[1], dtype="float32", value=1.0), lr)
    with sw.case(L.less_than(step, b2)):
        L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.5), lr)
    with sw.default():
        L.assign(L.fill_constant(shape=[1], dtype="float32", value=0.1), lr)
    return [lr]


def _conditional_scalar(fluid, L):
    flag = L.data(name="flag", shape=[1], dtype="float32",
                  append_batch_size=False)
    zero = L.fill_constant(shape=[1], dtype="float32", value=0.0)
    out = L.fill_constant(shape=[1], dtype="float32", value=-1.0)
    cond = L.greater_than(flag, zero)
    cb = L.ConditionalBlock([cond])
    with cb.block():
        L.assign(L.scale(x=flag, scale=10.0), out)
    return [out]


def _lod_round_trip(fluid, L):
    x = L.data(name="x", shape=[2], dtype="float32", lod_level=1)
    table = L.lod_rank_table(x)
    arr = L.lod_tensor_to_array(x, table)
    back = L.array_to_lod_tensor(arr, table)
    return [back, L.max_sequence_len(table), table]


def _seq2seq(fluid, L):
    mod = __import__(fluid.__name__.split(".")[0]
                     + ".models.rnn_encoder_decoder", fromlist=["get_model"])
    loss, feeds, _ = mod.get_model(src_dict_dim=40, trg_dict_dim=40,
                                   emb_dim=24, hidden_dim=24,
                                   learning_rate=5e-3)
    return [loss], feeds


def _feeder(slots_of, rows_of):
    def feed(fluid, main):
        slots = [main.global_block().var(n) for n in slots_of]
        return fluid.DataFeeder(slots, program=main).feed(rows_of())
    return feed


def _dense(d):
    return lambda fluid, main: d


def test_while_sum():
    want, got, _, _ = _run_both(_while_sum)
    _agree(want, got)
    assert float(got[0][0][0]) == 45.0 and float(got[0][1][0]) == 10.0
    assert not bool(got[0][2].ravel()[0])


def test_while_with_array():
    want, got, _, _ = _run_both(_while_with_array)
    _agree(want, got)
    np.testing.assert_array_equal(got[0][0], np.full(3, 2.0, np.float32))
    assert got[0][1].dtype == np.int32 and int(got[0][1][0]) == 5


def test_array_read_write_outside_loop():
    want, got, _, _ = _run_both(_array_outside_loop)
    _agree(want, got)
    np.testing.assert_array_equal(got[0][1], np.full(2, 3.5, np.float32))


def test_create_array_lazy_sizing():
    want, got, _, _ = _run_both(_lazy_array)
    _agree(want, got)


def test_static_rnn_accumulator():
    xv = np.random.RandomState(0).randn(2, 4, 3).astype(np.float32)
    want, got, _, _ = _run_both(_static_accumulator, [_dense({"x": xv})])
    _agree(want, got)
    np.testing.assert_allclose(got[0][0], np.cumsum(xv, axis=1), rtol=1e-5)


def test_static_rnn_trains():
    """30 SGD steps through the recurrent op's replayed gradient: every
    step's loss and the final parameters as the reference's."""
    rng = np.random.RandomState(1)
    xv = rng.randn(8, 5, 4).astype(np.float32)
    yv = np.stack([xv.sum((1, 2)), xv.mean((1, 2))], 1).astype(np.float32)
    want, got, jp, tp, bars = _run_both(
        _static_rnn_trains, [_dense({"x": xv, "y": yv})] * 30, spread=True)
    _agree_trained(want, got, jp, tp, bars)
    # the first 15 steps, before lr 0.1 turns the run chaotic, at TOL
    _agree(want[:15], got[:15])
    assert got[-1][0][0] < got[0][0][0] * 0.5


def test_dynamic_rnn_masked_accumulator():
    rows = [[1.0, 2.0, 3.0], [4.0, 5.0], [6.0]]
    want, got, _, _ = _run_both(
        _dynamic_accumulator,
        [_feeder(["x"], lambda: [(r,) for r in rows])])
    _agree(want, got)
    np.testing.assert_allclose(got[0][1].ravel(), [6.0, 9.0, 6.0])
    # outputs zero past each row's length
    assert got[0][0][1, 2:].max(initial=0.0) == 0.0


def test_ifelse_trains():
    rng = np.random.RandomState(0)
    xv = rng.randn(32, 4).astype(np.float32)
    yv = np.abs(xv.sum(1, keepdims=True)).astype(np.float32)
    want, got, jp, tp, bars = _run_both(
        _ifelse_trains, [_dense({"x": xv, "y": yv})] * 40, spread=True)
    _agree_trained(want, got, jp, tp, bars)
    _agree(want[:1], got[:1])
    assert got[-1][0][0] < got[0][0][0] * 0.3


@pytest.mark.parametrize("sv,expect", [(2.0, 1.0), (7.0, 0.5),
                                       (20.0, 0.1)])
def test_switch_piecewise(sv, expect):
    want, got, _, _ = _run_both(
        _switch, [_dense({"step": np.array([sv], np.float32)})])
    _agree(want, got)
    np.testing.assert_allclose(float(got[0][0][0]), expect, rtol=1e-6)


def test_conditional_block_scalar():
    want, got, _, _ = _run_both(
        _conditional_scalar,
        [_dense({"flag": np.array([v], np.float32)}) for v in (3.0, -3.0)])
    _agree(want, got)
    assert float(got[0][0][0]) == 30.0 and float(got[1][0][0]) == -1.0


def test_lod_tensor_array_round_trip():
    rows = [[[1.0, 1.5], [2.0, 2.5]], [[3.0, 3.5]]]
    want, got, _, _ = _run_both(
        _lod_round_trip, [_feeder(["x"], lambda: [(r,) for r in rows])])
    _agree(want, got)
    b, m, table = got[0]
    np.testing.assert_array_equal(b[0, :2], [[1.0, 1.5], [2.0, 2.5]])
    assert m.dtype == np.int32 and table.dtype == np.int32
    np.testing.assert_array_equal(table, [2, 1])


def test_rnn_encoder_decoder_book_model():
    """The book's seq2seq (the DynamicRNN decoder) on the identity task:
    60 Adam steps, every loss as the reference's, and the loss falls."""
    rng = np.random.RandomState(0)
    batches = []
    for _ in range(60):
        b = []
        for _ in range(8):
            src = rng.randint(2, 38, rng.randint(3, 8)).tolist()
            b.append((src, src, src))
        batches.append(b)
    names = ["source_sequence", "target_sequence", "label_sequence"]
    want, got, jp, tp, bars = _run_both(
        _seq2seq, [_feeder(names, lambda b=b: b) for b in batches],
        fetch_of=lambda out: out[0], spread=True)
    _agree_trained(want, got, jp, tp, bars)
    _agree(want[:1], got[:1])
    assert got[-1][0][0] < got[0][0][0] - 1.0


def test_array_read_propagates_element_shape():
    def body(fluid, L):
        counter = L.fill_constant([1], "int64", 0)
        limit = L.fill_constant([1], "int64", 3)
        x0 = L.fill_constant([2, 6], "float32", 1.0)
        arr = L.array_write(x0, i=counter, capacity=5)
        cond = L.less_than(x=counter, y=limit)
        w = L.While(cond=cond)
        with w.block():
            cur = L.array_read(arr, i=counter)
            assert tuple(cur.shape) == (2, 6)
            h = L.fc(cur, size=3, bias_attr=False,
                     param_attr=fluid.ParamAttr(name="aw"))
            L.increment(counter)
            L.array_write(h, i=counter, array=arr)
            L.less_than(x=counter, y=limit, cond=cond)
        a2 = L.create_array("float32", element_shape=[4, 8])
        r = L.array_read(a2, i=L.fill_constant([1], "int64", 0))
        assert tuple(r.shape) == (4, 8)

    # a build-time check, as the reference's (the program is not run)
    jmain, jstart, _ = _build(jfluid, body)
    main, start, _ = _build(tfluid, body)
    assert main.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    assert start.desc.serialize_to_string() == \
        jstart.desc.serialize_to_string()
    assert tuple(main.global_block().var("aw").shape) == (6, 3)


# ---------------------------------------------------------------------------
# the ops, one by one
# ---------------------------------------------------------------------------

# the ops this slice adds that tools/tpu_optest.py has a spec for
SPEC_OPS = ["less_than", "less_equal", "greater_than", "greater_equal",
            "equal", "not_equal", "logical_and", "logical_or",
            "logical_xor", "logical_not", "increment", "is_empty",
            "fill_constant_batch_size_like", "fill_zeros_like",
            "elementwise_sub", "elementwise_div", "elementwise_max",
            "elementwise_min", "elementwise_pow", "reduce_mean"]


@pytest.mark.parametrize("op", SPEC_OPS)
def test_op_replays_its_spec(op):
    from test_torch_ops import replay_spec

    replay_spec(op)


def _array_ops(fluid, L):
    """Every TensorArray op: writes at device indices (one past the
    capacity, clamped into the last slot), reads (one clamped), the
    length, and the LoD bookkeeping ops."""
    x = L.data(name="x", shape=[3], dtype="float32", lod_level=1)
    idx = [L.fill_constant([1], "int64", v) for v in (0, 1, 3, 9)]
    v = L.fill_constant(shape=[2], dtype="float32", value=1.5)
    arr = L.create_array("float32", element_shape=[2], capacity=4)
    for k, i in enumerate(idx):
        L.array_write(L.scale(v, scale=float(k + 1)), i, array=arr)
    reads = [L.array_read(arr, i) for i in idx]
    table = L.lod_rank_table(x)
    seq = L.lod_tensor_to_array(x, table)
    back = L.array_to_lod_tensor(seq, table)
    shrunk = L.shrink_memory(back, idx[0], table)
    reordered = L.reorder_lod_tensor_by_rank(shrunk, table)
    zero = L.fill_constant([1], "float32", 0.0)
    mask = L.greater_than(L.reduce_sum(
        L.sequence_last_step(x), dim=1, keep_dim=True), zero)
    t_half, f_half = L.split_lod_tensor(L.sequence_last_step(x), mask)
    merged = L.merge_lod_tensor(L.scale(t_half, scale=2.0),
                                L.scale(f_half, scale=-1.0), t_half, mask)
    return reads + [L.array_length(arr), L.array_length(seq), table,
                    L.max_sequence_len(table), back, reordered, merged,
                    L.is_empty(x)]


def test_array_and_lod_ops_match_the_reference():
    rng = np.random.RandomState(3)
    rows = [[rng.randn(3).tolist() for _ in range(n)] for n in (4, 1, 6)]
    want, got, _, _ = _run_both(
        _array_ops, [_feeder(["x"], lambda: [(r,) for r in rows])])
    _agree(want, got)
    g = got[0]
    # index 9 lands in the last slot (capacity 4), as the reference's
    # clamped dynamic update, and the length counts up to it
    np.testing.assert_array_equal(g[3], np.full(2, 6.0, np.float32))
    assert g[4].dtype == np.int32 and int(g[4][0]) == 10
    assert g[7].dtype == np.int32 and int(g[7][0]) == 6


def _cond_no_prior(fluid, L):
    flag = L.data(name="flag", shape=[1], dtype="float32",
                  append_batch_size=False)
    x = L.data(name="x", shape=[2, 3], dtype="float32",
               append_batch_size=False)
    y = fluid.default_main_program().global_block().create_var(
        name="y", dtype="float32", shape=[2, 3])
    cond = L.greater_than(flag, L.fill_constant([1], "float32", 0.0))
    with L.ConditionalBlock([cond]).block():
        L.assign(L.scale(x, scale=2.0), y)
    return [y]


def test_conditional_block_false_branch_is_zeros_of_the_true_shape(
        monkeypatch):
    """An output the false branch leaves without a prior value is zeros
    of the true branch's shape and dtype, as the reference's
    ``jax.eval_shape``: the port takes them from a run of the true
    branch on meta tensors (``branch_specs``), which reads no data."""
    from paddle_tpu_torch.ops import control_flow

    seen = []
    real = control_flow.branch_specs

    def spy(ctx, block_idx, env):
        out = real(ctx, block_idx, env)
        seen.append({n: v.device.type for n, v in out.items()
                     if isinstance(v, torch.Tensor)})
        return out

    monkeypatch.setattr(control_flow, "branch_specs", spy)
    xv = np.arange(6, dtype=np.float32).reshape(2, 3)
    want, got, _, _ = _run_both(
        _cond_no_prior,
        [_dense({"flag": np.array([v], np.float32), "x": xv})
         for v in (-1.0, 2.0)])
    _agree(want, got)
    np.testing.assert_array_equal(got[0][0], np.zeros((2, 3), np.float32))
    np.testing.assert_array_equal(got[1][0], 2 * xv)
    # the false step asked the meta run, the true step did not
    assert len(seen) == 1 and seen[0]["y"] == "meta"


def _rnn_with_grads(fluid, L, masked, reverse):
    if masked:
        x = L.data(name="x", shape=[6], dtype="float32", lod_level=1)
        rnn = L.DynamicRNN()
        guard = rnn.block()
    else:
        x = L.data(name="x", shape=[5, 6], dtype="float32")
        rnn = L.StaticRNN()
        guard = rnn.step()
    x.stop_gradient = False
    rnn._reverse = reverse
    with guard:
        x_t = rnn.step_input(x)
        h = rnn.memory(shape=[4], batch_ref=x)
        h_new = L.fc(input=[x_t, h], size=4, act="tanh")
        rnn.update_memory(h, h_new)
        rnn.output(h_new)
    out = rnn()
    loss = L.mean(L.elementwise_add(out, L.scale(out, scale=0.5)))
    fluid.backward.append_backward(loss)
    main = fluid.default_main_program()
    return [out, rnn.final_states[0], "x@GRAD"] + sorted(
        p.name + "@GRAD" for p in main.all_parameters())


@pytest.mark.parametrize("masked,reverse", [(False, False), (False, True),
                                            (True, False), (True, True)])
def test_recurrent_forward_and_every_gradient(masked, reverse):
    """StaticRNN (unmasked) and DynamicRNN (masked past each row's
    length), forward and back to front: the outputs, the final state,
    and every output of recurrent_grad (the input's and each
    parameter's gradient) as the reference's."""
    rng = np.random.RandomState(5 + masked + 2 * reverse)
    if masked:
        rows = [rng.randn(n, 6).astype(np.float32).tolist()
                for n in (5, 2, 7)]
        feed = _feeder(["x"], lambda: [(r,) for r in rows])
    else:
        feed = _dense({"x": rng.randn(3, 5, 6).astype(np.float32)})

    def body(fluid, L):
        return _rnn_with_grads(fluid, L, masked, reverse)

    want, got, _, _ = _run_both(body, [feed])
    _agree(want, got, tol=1e-5)
    main, _, _ = _build(tfluid, body)
    assert [op.type for op in main.desc.blocks[0].ops].count(
        "recurrent_grad") == 1
    if masked:
        out = got[0][0]
        for i, n in enumerate((5, 2, 7)):
            assert np.abs(out[i, n:]).max(initial=0.0) == 0.0


def _dyn_rnn_classifier(fluid, L):
    x = L.data(name="x", shape=[6], dtype="float32", lod_level=1)
    y = L.data(name="y", shape=[1], dtype="int64")
    rnn = L.DynamicRNN()
    with rnn.block():
        x_t = rnn.step_input(x)
        h = rnn.memory(shape=[8], value=0.0)
        h_new = L.fc(input=[x_t, h], size=8, act="tanh")
        rnn.update_memory(h, h_new)
        rnn.output(h_new)
    last = L.sequence_last_step(rnn())
    pred = L.fc(input=last, size=2, act="softmax")
    loss = L.mean(L.cross_entropy(input=pred, label=y))
    fluid.optimizer.Adagrad(learning_rate=0.01).minimize(loss)
    return [loss, rnn.final_states[0], rnn()]


def test_dynamic_rnn_under_amp_pins_the_f32_carry():
    """Under the Float16Transpiler the body's products run in bf16 while
    the carried state stays f32 (``_match_dtype``), as in the reference:
    3 steps' losses at test_torch_amp.py's LOSS_RTOL, the final state
    f32 and the masked outputs f32 in both."""
    from test_torch_amp import LOSS_RTOL

    rng = np.random.RandomState(7)
    batches = [[(rng.randn(n, 6).astype(np.float32).tolist(),
                 [int(rng.randint(2))]) for n in (3, 6, 2, 5)]
               for _ in range(3)]
    res = {}
    for name, fluid in (("jax", jfluid), ("port", tfluid)):
        main, start, out = _build(fluid, _dyn_rnn_classifier)
        fluid.transpiler.Float16Transpiler().transpile(main)
        res[name] = (main, start, [v.name for v in out])
    (jmain, jstart, names), (tmain, _, _) = res["jax"], res["port"]
    assert tmain.desc.serialize_to_string() == \
        jmain.desc.serialize_to_string()
    js = JScope()
    jexe = jfluid.Executor(jfluid.CPUPlace())
    jexe.run(jstart, scope=js)
    persist = sorted(n for n, v in jmain.desc.blocks[0].vars.items()
                     if v.persistable)
    ts = tfluid.Scope()
    set_scope_arrays(ts, {n: np.asarray(js.find_var(n)) for n in persist},
                     "cpu")
    texe = tfluid.Executor(tfluid.CPUPlace())
    slots = ["x", "y"]
    for b in batches:
        jf = jfluid.DataFeeder([jmain.global_block().var(n) for n in slots],
                               program=jmain).feed(b)
        tf = tfluid.DataFeeder([tmain.global_block().var(n) for n in slots],
                               program=tmain).feed(b)
        j = jexe.run(jmain, feed=jf, fetch_list=names, scope=js,
                     return_numpy=False)
        t = texe.run(tmain, feed=tf, fetch_list=names, scope=ts,
                     return_numpy=False)
        np.testing.assert_allclose(float(t[0].float().ravel()[0]),
                                   float(np.asarray(j[0]).ravel()[0]),
                                   rtol=LOSS_RTOL)
        assert [str(v.dtype).replace("torch.", "") for v in t[1:]] == \
            [np.dtype(v.dtype).name for v in j[1:]] == ["float32"] * 2


def test_random_op_in_a_recurrent_body_is_refused():
    """A dropout in a StaticRNN body: the port refuses it (its gradient
    would replay the body and draw again); outside the body it runs."""
    def body(fluid, L):
        x = L.data(name="x", shape=[4, 3], dtype="float32")
        rnn = L.StaticRNN()
        with rnn.step():
            x_t = rnn.step_input(x)
            h = rnn.memory(shape=[3], batch_ref=x)
            h_new = L.dropout(L.elementwise_add(h, x_t), dropout_prob=0.5)
            rnn.update_memory(h, h_new)
            rnn.step_output(h_new)
        return [rnn()]

    main, start, out = _build(tfluid, body)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(start, scope=scope)
    with pytest.raises(NotImplementedError, match=r"random op\(s\) "
                       r"\['dropout'\] in the body"):
        exe.run(main, feed={"x": np.ones((2, 4, 3), np.float32)},
                fetch_list=out, scope=scope)


def _nested(fluid, L, kind):
    """A StaticRNN whose body holds a ``kind`` control-flow op."""
    x = L.data(name="x", shape=[4, 3], dtype="float32")
    rnn = L.StaticRNN()
    with rnn.step():
        x_t = rnn.step_input(x)
        h = rnn.memory(shape=[3], batch_ref=x)
        h_new = L.elementwise_add(h, x_t)
        if kind == "conditional_block":
            cond = L.greater_than(L.reduce_sum(x_t),
                                  L.fill_constant([1], "float32", 0.0))
            with L.ConditionalBlock([cond]).block():
                L.assign(L.scale(h_new, scale=0.5), h_new)
        elif kind == "while":
            i = L.fill_constant([1], "float32", 0.0)
            n = L.fill_constant([1], "float32", 2.0)
            cond = L.less_than(i, n)
            with L.While(cond=cond).block():
                L.assign(L.scale(h_new, scale=0.5), h_new)
                L.increment(i, value=1.0)
                L.less_than(i, n, cond=cond)
        else:
            L.assign(np.ones((2, 3), np.float32), h_new)
        rnn.update_memory(h, h_new)
        rnn.step_output(h_new)
    return [rnn()]


@pytest.mark.parametrize("kind", ["conditional_block", "while",
                                  "assign_value"])
def test_nested_control_flow_runs_and_prepare_refuses_it_on_a_card(kind):
    """A conditional_block, a while and an assign_value inside a
    recurrent body: run() gives the reference's outputs, and the card's
    prepare() refusal (which reads the block's plan) finds the first
    two in the sub-block; an assign_value there is no longer refused
    (the prepared step reads a device constant made at prepare(), and
    its steps are run()'s bit for bit); a DynamicRNN alone is
    capturable."""
    from paddle_tpu_torch.core.executor_impl import (ExecutorCore,
                                                      Uncapturable)

    def body(fluid, L):
        return _nested(fluid, L, kind)

    xv = np.random.RandomState(9).randn(2, 4, 3).astype(np.float32)
    want, got, _, _ = _run_both(body, [_dense({"x": xv})])
    _agree(want, got)
    core = ExecutorCore(tfluid.CPUPlace())
    main, startup, out = _build(tfluid, body)
    entry = core._entry(main.desc, 0, [out[0].name])
    if kind == "assign_value":
        core._refuse_uncapturable(entry)
        exe = tfluid.Executor(tfluid.CPUPlace())
        scope = tfluid.Scope()
        exe.run(startup, scope=scope)
        prep = exe.prepare(main, feed_specs={"x": xv}, fetch_list=out,
                           scope=scope)
        for _ in range(2):
            a = prep.run_prepared({"x": xv}, return_numpy=True)[0]
            b = exe.run(main, feed={"x": xv}, fetch_list=out,
                        scope=scope)[0]
            np.testing.assert_array_equal(a, b)
            np.testing.assert_array_equal(a, got[0][0])
    else:
        with pytest.raises(Uncapturable, match=kind):
            core._refuse_uncapturable(entry)
    main, _, out = _build(tfluid, _dyn_rnn_classifier)
    core._refuse_uncapturable(core._entry(main.desc, 0, [out[0].name]))


def test_a_body_sees_only_what_the_reference_puts_in_its_env(monkeypatch):
    """A DynamicRNN body's env is a fresh dict of the op's Parameters,
    step slices and states, as the reference's scan step builds it: no
    outer value and no outer '@LEN' (the step slice's own '@LEN' would
    be a [N] vector beside an [N, ...] value the body must not mask)."""
    from paddle_tpu_torch.ops import control_flow

    seen = []
    real = control_flow._run_block

    def spy(ctx, block_idx, env):
        seen.append(sorted(env))
        return real(ctx, block_idx, env)

    monkeypatch.setattr(control_flow, "_run_block", spy)
    main, start, out = _build(tfluid, _dyn_rnn_classifier)
    op = next(o for o in main.desc.blocks[0].ops if o.type == "recurrent")
    want = sorted(op.inputs["Parameters"]
                  + op.attrs["step_input_names"].value
                  + op.attrs["state_in_names"].value)
    exe = tfluid.Executor(tfluid.CPUPlace())
    scope = tfluid.Scope()
    exe.run(start, scope=scope)
    rows = [(np.ones((n, 6), np.float32).tolist(), [1]) for n in (3, 5)]
    feed = tfluid.DataFeeder([main.global_block().var("x"),
                              main.global_block().var("y")],
                             program=main).feed(rows)
    exe.run(main, feed=feed, fetch_list=[out[0]], scope=scope)
    # 8 forward steps (T padded to 8) and 8 in recurrent_grad's replay
    assert len(seen) == 16 and all(keys == want for keys in seen)
    assert not any("@LEN" in k for k in want)
