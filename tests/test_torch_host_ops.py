"""The port's host ops (``ops/io_ops.py``) and the executor's host-op
runtime (``core/executor_impl.py``: prelude, postlude, the op-by-op
path, all-host programs) against the JAX package's, on the CPU.

Every program here runs in both packages from the same values; the
fetches agree within rtol 1e-5 (the same f32 math in another order;
``tests/test_io_checkpoint.py``'s bar) and, against the port's own
program without its host ops, bit for bit.  Each host op runs once a
run (the printed lines are counted).
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.core.registry import get_op_info
from paddle_tpu_torch.fluid.io import set_scope_arrays

N_FEAT = 4
HOST_OPS = ("feed", "fetch", "save", "load", "save_combine", "load_combine",
            "print", "delete_var")


def _fluid(name):
    return jfluid if name == "jax" else tfluid


def _scope(name):
    return JScope() if name == "jax" else tfluid.Scope()


def _exe(name):
    return _fluid(name).Executor(_fluid(name).CPUPlace())


def _read(name, scope, var):
    val = scope.find_var(var)
    return np.array(val) if name == "jax" else val.numpy()


def _x(seed=0, rows=3):
    return np.random.RandomState(seed).randn(rows, N_FEAT).astype(
        np.float32)


def _net(fluid, prints=(), tail=False):
    """x -> fc(relu) -> fc -> mean, a Print after the layers named in
    ``prints`` ("h": between device ops; ``tail``: after the last)."""
    x = fluid.layers.data(name="x", shape=[N_FEAT], dtype="float32")
    h = fluid.layers.fc(x, size=5, act="relu",
                        param_attr=fluid.ParamAttr(name="w1"),
                        bias_attr=fluid.ParamAttr(name="b1"))
    if "h" in prints:
        fluid.layers.Print(h, message="h")
    y = fluid.layers.fc(h, size=2, param_attr=fluid.ParamAttr(name="w2"),
                        bias_attr=fluid.ParamAttr(name="b2"))
    out = fluid.layers.mean(y)
    if tail:
        fluid.layers.Print(y, message="y")
    return h, y, out


def _programs(name, **kw):
    fluid = _fluid(name)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        outs = _net(fluid, **kw)
    return main, startup, outs


PARAMS = {"w1": np.random.RandomState(1).randn(N_FEAT, 5).astype(np.float32),
          "b1": np.random.RandomState(2).randn(5).astype(np.float32),
          "w2": np.random.RandomState(3).randn(5, 2).astype(np.float32),
          "b2": np.random.RandomState(4).randn(2).astype(np.float32)}


def _load_params(name, scope):
    if name == "jax":
        for k, v in PARAMS.items():
            scope.set(k, v.copy())
    else:
        set_scope_arrays(scope, PARAMS, "cpu")


def _run(name, capsys, **kw):
    main, startup, (h, y, out) = _programs(name, **kw)
    scope, exe = _scope(name), _exe(name)
    exe.run(startup, scope=scope)
    _load_params(name, scope)
    capsys.readouterr()
    got = exe.run(main, feed={"x": _x()}, fetch_list=[h, y, out],
                  scope=scope)
    lines = [ln for ln in capsys.readouterr().out.splitlines()
             if ln.startswith(("h\t", "y\t"))]
    return [np.asarray(g) for g in got], lines


def test_the_host_ops_are_registered_as_the_references():
    from paddle_tpu.core.registry import get_op_info as jinfo

    for op in HOST_OPS:
        assert get_op_info(op).host_op and jinfo(op).host_op, op
        assert get_op_info(op).grad_maker is None


@pytest.mark.parametrize("where", ["postlude", "between", "both"])
def test_print_gives_the_fetches_of_the_program_without_it(where, capsys):
    """A Print after the last device op runs as the postlude, reading a
    temporary the block computed (handed over, not put in the scope); a
    Print between device ops makes the block run op by op.  Each prints
    once, as the reference's; the fetches are those of the program
    without Print, bit for bit, and the reference's within 1e-5."""
    kw = {"prints": ("h",) if where != "postlude" else (),
          "tail": where != "between"}
    plain, _ = _run("port", capsys)
    got, lines = _run("port", capsys, **kw)
    want, jlines = _run("jax", capsys, **kw)
    for g, p, w in zip(got, plain, want):
        np.testing.assert_array_equal(g, p)
        np.testing.assert_allclose(g, w, rtol=1e-5)
    assert [ln.split("\t")[:3] for ln in lines] == \
        [ln.split("\t")[:3] for ln in jlines]
    assert len(lines) == len(kw["prints"]) + kw["tail"]


def test_a_postlude_print_does_not_put_its_temporary_in_the_scope(capsys):
    main, startup, (h, y, out) = _programs("port", tail=True)
    scope, exe = _scope("port"), _exe("port")
    exe.run(startup, scope=scope)
    exe.run(main, feed={"x": _x()}, fetch_list=[out], scope=scope)
    assert not scope.has_var(y.name)
    assert capsys.readouterr().out.startswith("y\tshape=(3, 2)\t"
                                              "dtype=float32\tdata=")


def _with_load_postlude(name, path):
    """y = scale(x), then a load op of "w" after it: a postlude that
    writes a value the run returns."""
    fluid = _fluid(name)
    main = fluid.Program()
    with fluid.program_guard(main), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[N_FEAT], dtype="float32")
        y = fluid.layers.scale(x, scale=3.0)
        blk = main.global_block()
        blk.create_var(name="w", shape=[N_FEAT, 5], dtype="float32",
                       persistable=True)
        blk.append_op(type="load", inputs={}, outputs={"Out": ["w"]},
                      attrs={"file_path": path}, infer_shape=False)
    return main, y


def test_a_postlude_that_produces_a_fetch(tmp_path):
    from paddle_tpu.utils import serialization as jser

    path = str(tmp_path / "w")
    jser.save_tensor(path, PARAMS["w1"])
    out = {}
    for name in ("jax", "port"):
        main, y = _with_load_postlude(name, path)
        scope = _scope(name)
        got = _exe(name).run(main, feed={"x": _x()}, fetch_list=[y, "w"],
                             scope=scope)
        out[name] = [np.asarray(g) for g in got]
        np.testing.assert_array_equal(_read(name, scope, "w"), PARAMS["w1"])
    np.testing.assert_array_equal(out["port"][1], PARAMS["w1"])
    np.testing.assert_allclose(out["port"][0], out["jax"][0], rtol=1e-5)
    np.testing.assert_array_equal(out["port"][0], _x() * 3.0)


def _mixed_load(name, path):
    """scale(x) -> load "w" -> mul(y, w): a load between device ops, read
    by the op after it (the op-by-op path)."""
    fluid = _fluid(name)
    main = fluid.Program()
    with fluid.program_guard(main), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[N_FEAT], dtype="float32")
        y = fluid.layers.scale(x, scale=2.0)
        blk = main.global_block()
        blk.create_var(name="w", shape=[N_FEAT, 5], dtype="float32",
                       persistable=True)
        blk.append_op(type="load", inputs={}, outputs={"Out": ["w"]},
                      attrs={"file_path": path}, infer_shape=False)
        z = fluid.layers.fc(y, size=5, bias_attr=False,
                            param_attr=fluid.ParamAttr(name="w"))
    return main, z


def test_a_load_between_device_ops_is_what_the_next_op_reads(tmp_path):
    from paddle_tpu.utils import serialization as jser

    path = str(tmp_path / "w")
    jser.save_tensor(path, PARAMS["w1"])
    out = {}
    for name in ("jax", "port"):
        main, z = _mixed_load(name, path)
        scope = _scope(name)
        # a stale value in the scope: the load replaces it before the fc
        if name == "jax":
            scope.set("w", np.zeros((N_FEAT, 5), np.float32))
        else:
            set_scope_arrays(scope, {"w": np.zeros((N_FEAT, 5),
                                                   np.float32)}, "cpu")
        out[name] = np.asarray(_exe(name).run(
            main, feed={"x": _x()}, fetch_list=[z], scope=scope)[0])
    np.testing.assert_allclose(out["port"], (_x() * 2.0) @ PARAMS["w1"],
                               rtol=1e-5)
    np.testing.assert_allclose(out["port"], out["jax"], rtol=1e-5)


def test_host_ops_in_the_op_by_op_path_run_once(monkeypatch, tmp_path):
    """Every op of a mixed block runs once: host ops are not also run as
    a prelude or postlude around the op-by-op pass."""
    from paddle_tpu_torch.core import executor_impl

    calls = []
    real = executor_impl._run_host_op

    def counting(executor, op, scope, feed, env=None):
        calls.append(op.type)
        return real(executor, op, scope, feed, env)

    monkeypatch.setattr(executor_impl, "_run_host_op", counting)
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        main.global_block().append_op(
            type="feed", inputs={}, outputs={"Out": ["x"]},
            attrs={"col": 0}, infer_shape=False)
        h, y, out = _net(tfluid, prints=("h",), tail=True)
        main.global_block().append_op(
            type="fetch", inputs={"X": [out.name]}, outputs={},
            attrs={"col": 0}, infer_shape=False)
    scope = _scope("port")
    exe = _exe("port")
    exe.run(startup, scope=scope)
    calls.clear()
    exe.run(main, feed={"x": _x()}, fetch_list=[out], scope=scope)
    assert calls == ["feed", "print", "print", "fetch"]


def test_an_all_host_program_builds_no_plan_and_draws_no_seed(tmp_path):
    """A save program: every op a host op, nothing for the device; the
    scope's run counter does not move (in neither package: the
    reference's counter moves only when it compiles)."""
    for name in ("jax", "port"):
        fluid = _fluid(name)
        main, startup, _ = _programs(name)
        scope, exe = _scope(name), _exe(name)
        exe.run(startup, scope=scope)
        _load_params(name, scope)
        before = getattr(scope, "_rng_counter", 0)
        cache = len(getattr(exe, "_core", exe)._cache) \
            if name == "port" else None
        with fluid.scope_guard(scope):
            fluid.io.save_params(exe, str(tmp_path / name), main)
        assert getattr(scope, "_rng_counter", 0) == before, name
        if name == "port":
            assert len(exe._core._cache) == cache
    for f in sorted(PARAMS):
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "port" / f).read_bytes()


def test_delete_var_erases_from_the_scope():
    for name in ("jax", "port"):
        fluid = _fluid(name)
        main = fluid.Program()
        with fluid.program_guard(main):
            blk = main.global_block()
            for n in ("w1", "b1"):
                blk.create_var(name=n, shape=PARAMS[n].shape,
                               dtype="float32", persistable=True)
            blk.append_op(type="delete_var", inputs={"X": ["w1", "b1"]},
                          outputs={}, infer_shape=False)
        scope = _scope(name)
        _load_params(name, scope)
        version = scope._version
        _exe(name).run(main, scope=scope)
        assert not scope.has_var("w1") and not scope.has_var("b1")
        assert scope.has_var("w2")
        assert scope._version == version + 1
        # erasing what is gone moves nothing
        _exe(name).run(main, scope=scope)
        assert scope._version == version + 1


@pytest.mark.parametrize("where", ["postlude", "between"])
def test_prepare_refuses_host_ops_with_value_error(where):
    """The prepared step runs the whole block on the device: a block
    with a host op is refused with ValueError in both packages, and
    run() takes it."""
    kw = {"prints": ("h",)} if where == "between" else {"tail": True}
    for name in ("jax", "port"):
        main, startup, (h, y, out) = _programs(name, **kw)
        scope, exe = _scope(name), _exe(name)
        exe.run(startup, scope=scope)
        with pytest.raises(ValueError, match="host op"):
            exe.prepare(main, feed_specs={"x": _x()}, fetch_list=[out],
                        scope=scope)


def test_feed_op_puts_the_value_on_the_executors_device():
    """An inference program's feed ops (the prelude) write the fed value
    into the scope, as a tensor on the executor's device (the reference
    writes a numpy array); the core reads the feed itself."""
    main = tfluid.Program()
    with tfluid.program_guard(main):
        main.global_block().append_op(
            type="feed", inputs={}, outputs={"Out": ["x"]},
            attrs={"col": 0}, infer_shape=False)
        x = main.global_block().create_var(name="x", shape=[-1, N_FEAT],
                                           dtype="float32")
        y = tfluid.layers.scale(x, scale=2.0)
    scope = _scope("port")
    got, = _exe("port").run(main, feed={"x": _x()}, fetch_list=[y],
                            scope=scope)
    np.testing.assert_array_equal(got, _x() * 2.0)
    val = scope.find_var("x")
    assert val.device.type == "cpu"
    np.testing.assert_array_equal(val.numpy(), _x())


def test_print_reads_bf16_and_names_its_dtype(capsys):
    import torch

    main = tfluid.Program()
    with tfluid.program_guard(main):
        v = main.global_block().create_var(name="v", shape=[2],
                                           dtype="bfloat16",
                                           persistable=True)
        tfluid.layers.Print(v, message="v", summarize=-1)
    scope = _scope("port")
    scope.set("v", torch.tensor([1.5, -2.0], dtype=torch.bfloat16))
    _exe("port").run(main, scope=scope)
    line = capsys.readouterr().out
    assert line.startswith("v\tshape=(2,)\tdtype=bfloat16\tdata=[ 1.5 -2. ]")
