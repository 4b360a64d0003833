"""The port's persistence (``paddle_tpu_torch/utils/serialization.py``,
``fluid/io.py``) against the JAX package's, on the CPU.

- The tensor format: for f32, f64, int64, int32, bool, bf16 and a 0-d
  value both packages write the same bytes, from numpy and (the port)
  from torch, and each reads the other's bit for bit; the combined file
  too.  A 0-d value is stored with dims [1] in both (the reference's
  ``np.ascontiguousarray`` gives it one dimension) and reads back so.
- ``save_*`` / ``load_*``: a directory either package wrote loads in
  the other bit for bit, one file a variable and combined, and the
  files the two write for the same values are the same bytes.
- ``save_inference_model``: the same ``__model__`` bytes; each package
  runs the other's inference directory, outputs within rtol 1e-5 (the
  same f32 math in another order; ``tests/test_io_checkpoint.py``'s bar).
- Checkpoints: the five cases of ``tests/test_io_checkpoint.py`` written
  for the port, and a checkpoint one package writes that the other
  resumes: 3 SGD steps on in both, losses within rtol 1e-4
  (``tests/test_torch_train.py``'s bar).
- The prepared loop: a save after ``run_prepared`` steps, with no
  ``sync_scope`` by hand, writes the state after the last step; a load
  into the scope of a live prepared program is what its next step
  reads; both bit for bit against the port's own ``run()``.
"""
import os

import ml_dtypes
import numpy as np
import pytest
import torch

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu.utils import serialization as jser
from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
from paddle_tpu_torch.utils import serialization as tser

N_FEAT, N_CLASS = 4, 3
STEPS = 3


def _values():
    rng = np.random.RandomState(0)
    return {
        "f32": rng.randn(3, 4).astype(np.float32),
        "f64": rng.randn(5).astype(np.float64),
        "int64": rng.randint(-2 ** 40, 2 ** 40, (2, 3)).astype(np.int64),
        "int32": rng.randint(-9, 9, (7,)).astype(np.int32),
        "bool": rng.rand(2, 2, 2) > 0.5,
        "bf16": rng.randn(4, 8).astype(ml_dtypes.bfloat16),
        "0-d": np.asarray(np.float32(2.5)),
    }


def _to_torch(a):
    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a))


def _to_numpy(t):
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _same(got, want):
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("kind", sorted(_values()))
def test_tensor_files_are_the_same_bytes_both_ways(kind, tmp_path):
    a = _values()[kind]
    want = jser.tensor_to_bytes(a)
    assert tser.tensor_to_bytes(a) == want
    assert tser.tensor_to_bytes(_to_torch(a)) == want
    stored = a.reshape(a.shape or (1,))
    # the port reads the reference's file, as numpy and as torch
    jser.save_tensor(str(tmp_path / "j"), a)
    _same(tser.load_tensor(str(tmp_path / "j")), stored)
    t = tser.load_tensor(str(tmp_path / "j"), as_torch=True)
    assert isinstance(t, torch.Tensor) and t.device.type == "cpu"
    _same(_to_numpy(t), stored)
    # the reference reads the port's file, written from torch
    n = tser.save_tensor(str(tmp_path / "t"), _to_torch(a))
    assert n == len(want) == os.path.getsize(tmp_path / "t")
    _same(jser.load_tensor(str(tmp_path / "t")), stored)


def test_bf16_goes_through_torch_without_ml_dtypes(monkeypatch):
    """bf16 is written from an int16 view and read back as
    torch.bfloat16 without ml_dtypes; a numpy read needs it."""
    import paddle_tpu_torch.core.types as ttypes

    a = _values()["bf16"]
    want = jser.tensor_to_bytes(a)
    monkeypatch.setattr(ttypes, "_BF16", None)
    monkeypatch.setattr(ttypes, "_PROTO_TO_NP", {
        k: v for k, v in ttypes._PROTO_TO_NP.items()
        if k != ttypes.DataType.BF16})
    assert tser.tensor_to_bytes(_to_torch(a)) == want
    t, end = tser.tensor_from_bytes(want, as_torch=True)
    assert end == len(want) and t.dtype == torch.bfloat16
    _same(_to_numpy(t), a)
    with pytest.raises(TypeError, match="ml_dtypes"):
        tser.tensor_from_bytes(want)


def test_combined_file_is_the_same_bytes_both_ways(tmp_path):
    items = sorted(_values().items())
    jser.save_combined(str(tmp_path / "j"), items)
    tser.save_combined(str(tmp_path / "t"),
                       [(k, _to_torch(v)) for k, v in items])
    assert (tmp_path / "j").read_bytes() == (tmp_path / "t").read_bytes()
    for (kg, g), (kw, w) in zip(
            tser.load_combined(str(tmp_path / "j"), as_torch=True), items):
        assert kg == kw
        _same(_to_numpy(g), w.reshape(w.shape or (1,)))
    for (kg, g), (kw, w) in zip(jser.load_combined(str(tmp_path / "t")),
                                items):
        assert kg == kw
        _same(g, w.reshape(w.shape or (1,)))


# ------------------------------------------------------- save and load

class Pkg:
    def __init__(self, name):
        self.name = name
        self.fluid = jfluid if name == "jax" else tfluid

    def scope(self):
        return JScope() if self.name == "jax" else tfluid.Scope()

    def exe(self):
        return self.fluid.Executor(self.fluid.CPUPlace())

    def load(self, scope, arrays):
        if self.name == "jax":
            for n, v in arrays.items():
                scope.set(n, np.array(v))
        else:
            set_scope_arrays(scope, arrays, "cpu")

    def read(self, scope, names):
        if self.name == "jax":
            return {n: np.array(scope.find_var(n)) for n in names}
        return get_scope_arrays(scope, names)


JAX, PORT = Pkg("jax"), Pkg("port")
PKGS = {"jax": JAX, "port": PORT}


def _build(pkg):
    fluid = pkg.fluid
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[N_FEAT], dtype="float32")
        y = fluid.layers.fc(x, size=N_CLASS, act="softmax",
                            param_attr=fluid.ParamAttr(name="fc_w"),
                            bias_attr=fluid.ParamAttr(name="fc_b"))
        loss = fluid.layers.mean(y)
        fluid.optimizer.SGD(0.1).minimize(loss)
    return main, startup, x, y, loss


def _persist(main):
    return sorted(v.name for v in main.list_vars() if v.persistable)


def _init():
    """The reference's startup values (the packages draw different
    random numbers)."""
    main, startup, *_ = _build(JAX)
    scope = JScope()
    JAX.exe().run(startup, scope=scope)
    return JAX.read(scope, _persist(main))


def _feed(seed=0):
    return {"x": np.random.RandomState(seed).randn(2, N_FEAT)
            .astype(np.float32)}


def _save(pkg, how, dirname, init):
    main, startup, *_ = _build(pkg)
    scope, exe = pkg.scope(), pkg.exe()
    with pkg.fluid.scope_guard(scope):
        exe.run(startup)
        pkg.load(scope, init)
        io = pkg.fluid.io
        if how == "params":
            io.save_params(exe, dirname, main)
        elif how == "vars":
            io.save_vars(exe, dirname, main, vars=["fc_w"])
        else:
            io.save_persistables(
                exe, dirname, main,
                filename="all" if how == "combined" else None)
    return main


def _load(pkg, how, dirname):
    main, startup, *_ = _build(pkg)
    scope, exe = pkg.scope(), pkg.exe()
    with pkg.fluid.scope_guard(scope):
        exe.run(startup)
        io = pkg.fluid.io
        if how == "params":
            io.load_params(exe, dirname, main)
        elif how == "vars":
            io.load_vars(exe, dirname, main, vars=["fc_w"])
        else:
            io.load_persistables(
                exe, dirname, main,
                filename="all" if how == "combined" else None)
    return scope


@pytest.mark.parametrize("how", ["persistables", "combined", "params",
                                 "vars"])
@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_directory_either_package_writes_loads_in_the_other(
        writer, reader, how, tmp_path):
    init = {k: v + 1.0 for k, v in _init().items()}   # not the startup's
    _save(PKGS[writer], how, str(tmp_path / "w"), init)
    _save(PKGS[reader], how, str(tmp_path / "r"), init)
    names = sorted(os.listdir(tmp_path / "w"))
    assert names == sorted(os.listdir(tmp_path / "r"))
    for n in names:
        assert (tmp_path / "w" / n).read_bytes() == \
            (tmp_path / "r" / n).read_bytes(), n
    scope = _load(PKGS[reader], how, str(tmp_path / "w"))
    loaded = {"vars": ["fc_w"], "params": ["fc_b", "fc_w"]}.get(
        how, sorted(init))
    got = PKGS[reader].read(scope, loaded)
    for n in loaded:
        _same(got[n], init[n])
    if reader == "port":
        for n in loaded:
            t = scope.find_var(n)
            assert isinstance(t, torch.Tensor) and t.device.type == "cpu"


def test_load_keeps_the_files_dtype_and_the_executors_device(tmp_path):
    """A load puts the file's tensor on the executor's device in the
    file's dtype (bf16 included), through Scope.set (the write version
    moves)."""
    fluid = tfluid
    prog = fluid.Program()
    with fluid.program_guard(prog):
        blk = prog.global_block()
        for name, dtype in (("a", "bfloat16"), ("b", "int64")):
            blk.create_var(name=name, shape=[2, 3], dtype=dtype,
                           persistable=True)
    scope = fluid.Scope()
    vals = {"a": torch.randn(2, 3).to(torch.bfloat16),
            "b": torch.arange(6, dtype=torch.int64).reshape(2, 3)}
    for n, v in vals.items():
        scope.set(n, v)
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, str(tmp_path / "d"), prog)
        fluid.io.save_persistables(exe, str(tmp_path / "c"), prog,
                                   filename="all")
    for combined in (False, True):
        fresh = fluid.Scope()
        with fluid.scope_guard(fresh):
            fluid.io.load_persistables(
                exe, str(tmp_path / ("c" if combined else "d")), prog,
                filename="all" if combined else None)
        for n, v in vals.items():
            got = fresh.find_var(n)
            assert got.dtype == v.dtype and got.device == exe.device
            assert torch.equal(got, v)
            assert fresh._write_versions[n] > 0


# --------------------------------------------------- inference models

@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_inference_model_crosses_the_packages(writer, reader, tmp_path):
    init = _init()
    xs = _feed(1)["x"]
    out = {}
    for name in ("jax", "port"):
        pkg = PKGS[name]
        main, startup, x, y, _ = _build(pkg)
        scope, exe = pkg.scope(), pkg.exe()
        with pkg.fluid.scope_guard(scope):
            exe.run(startup)
            pkg.load(scope, init)
            out[name], = exe.run(main.clone(for_test=True),
                                 feed={"x": xs}, fetch_list=[y])
            pkg.fluid.io.save_inference_model(str(tmp_path / name), ["x"],
                                              [y], exe, main)
    assert (tmp_path / "jax" / "__model__").read_bytes() == \
        (tmp_path / "port" / "__model__").read_bytes()
    pkg = PKGS[reader]
    scope, exe = pkg.scope(), pkg.exe()
    with pkg.fluid.scope_guard(scope):
        prog, feed_names, fetch_vars = pkg.fluid.io.load_inference_model(
            str(tmp_path / writer), exe)
        assert feed_names == ["x"]
        assert [op.type for op in prog.desc.blocks[0].ops][::len(
            prog.desc.blocks[0].ops) - 1] == ["feed", "fetch"]
        got, = exe.run(prog, feed={"x": xs}, fetch_list=fetch_vars)
    np.testing.assert_allclose(np.asarray(got), out[writer], rtol=1e-5)
    np.testing.assert_allclose(np.asarray(got), out[reader], rtol=1e-5)


def test_aot_feed_specs_is_refused_before_writing(tmp_path):
    """``aot_feed_specs`` writes the port's exported program beside the
    model (``inference/aot.py``); what is still refused, before any
    artifact is written, is a program with host ops besides its feed and
    fetch ops."""
    from paddle_tpu_torch.inference import aot

    main, startup, x, y, _ = _build(PORT)
    scope, exe = PORT.scope(), PORT.exe()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        tfluid.io.save_inference_model(
            str(tmp_path / "m"), ["x"], [y], exe, main,
            aot_feed_specs={"x": ((2, N_FEAT), "float32")})
        host = main.clone(for_test=True)
        with tfluid.program_guard(host):
            tfluid.layers.Print(host.global_block().var(y.name))
        (tmp_path / "h").mkdir()
        with pytest.raises(ValueError, match="host ops"):
            aot.save_aot(str(tmp_path / "h"), host,
                         {"x": ((2, N_FEAT), "float32")}, [y.name], scope,
                         tfluid.CPUPlace())
    assert (tmp_path / "m" / aot.AOT_PROGRAM).exists()
    assert (tmp_path / "m" / aot.AOT_META).exists()
    assert not os.listdir(tmp_path / "h")


def test_get_inference_program_is_the_references():
    progs = []
    for pkg in (JAX, PORT):
        main, _, _, y, _ = _build(pkg)
        with pkg.fluid.program_guard(main):
            progs.append(pkg.fluid.io.get_inference_program(y)
                         .serialize_to_string())
    assert progs[0] == progs[1]


# ------------------------------------------------------- checkpoints
# (tests/test_io_checkpoint.py's five cases, written for the port)

def test_save_load_persistables(tmp_path):
    main, startup, *_ = _build(PORT)
    exe, scope = PORT.exe(), PORT.scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        w_before = scope.find_var("fc_w").clone()
        tfluid.io.save_persistables(exe, str(tmp_path / "model"), main)
        scope.set("fc_w", torch.zeros_like(w_before))
        tfluid.io.load_persistables(exe, str(tmp_path / "model"), main)
        assert torch.equal(scope.find_var("fc_w"), w_before)


def test_save_load_combined(tmp_path):
    main, startup, *_ = _build(PORT)
    exe, scope = PORT.exe(), PORT.scope()
    with tfluid.scope_guard(scope):
        exe.run(startup)
        w_before = scope.find_var("fc_w").clone()
        tfluid.io.save_persistables(exe, str(tmp_path / "model"), main,
                                    filename="all_params")
        assert os.path.exists(tmp_path / "model" / "all_params")
        scope.set("fc_w", torch.zeros_like(w_before))
        tfluid.io.load_persistables(exe, str(tmp_path / "model"), main,
                                    filename="all_params")
        assert torch.equal(scope.find_var("fc_w"), w_before)


def test_inference_model_roundtrip(tmp_path):
    main, startup, x, y, _ = _build(PORT)
    exe, scope = PORT.exe(), PORT.scope()
    xs = np.random.RandomState(0).randn(2, N_FEAT).astype(np.float32)
    with tfluid.scope_guard(scope):
        exe.run(startup)
        want, = exe.run(main.clone(for_test=True), feed={"x": xs},
                        fetch_list=[y])
        tfluid.io.save_inference_model(str(tmp_path / "infer"), ["x"], [y],
                                       exe, main)
    with tfluid.scope_guard(PORT.scope()):
        prog, feed_names, fetch_vars = tfluid.io.load_inference_model(
            str(tmp_path / "infer"), exe)
        assert feed_names == ["x"]
        got, = exe.run(prog, feed={"x": xs}, fetch_list=fetch_vars)
    np.testing.assert_array_equal(got, want)


def test_checkpoint_serial_dirs(tmp_path):
    main, startup, *_ = _build(PORT)
    exe, scope = PORT.exe(), PORT.scope()
    ckpt = str(tmp_path / "ckpt")
    with tfluid.scope_guard(scope):
        exe.run(startup)
        for i in range(5):
            serial = tfluid.io.save_checkpoint(
                exe, ckpt, trainer_args={"step": i}, main_program=main)
        assert serial == 4
        assert sorted(os.listdir(ckpt)) == ["checkpoint_2", "checkpoint_3",
                                            "checkpoint_4"]
        assert tfluid.io.get_latest_checkpoint_serial(ckpt) == 4
        w = scope.find_var("fc_w").clone()
        scope.set("fc_w", torch.zeros_like(w))
        assert tfluid.io.load_checkpoint(exe, ckpt, main_program=main) == 4
        assert torch.equal(scope.find_var("fc_w"), w)
        assert tfluid.io.load_trainer_args(ckpt, 4, 0)["step"] == 4
    tfluid.io.clean_checkpoint(ckpt, delete_dir=True)
    assert not os.path.exists(ckpt)


def test_checkpoint_missing_success_marker_skipped(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    for serial, complete in [(0, True), (1, True), (2, False)]:
        model = os.path.join(ckpt, "checkpoint_%d" % serial, "__model__")
        os.makedirs(model)
        if complete:
            with open(os.path.join(model, "_SUCCESS"), "w") as f:
                f.write("0")
    assert tfluid.io.get_latest_checkpoint_serial(ckpt) == 1
    empty = str(tmp_path / "empty")
    os.makedirs(os.path.join(empty, "checkpoint_7", "__model__"))
    assert tfluid.io.get_latest_checkpoint_serial(empty) == -1
    assert tfluid.io.get_latest_checkpoint_serial(str(tmp_path / "no")) \
        == -1
    with pytest.raises(ValueError, match="no checkpoint"):
        tfluid.io.load_checkpoint(PORT.exe(), empty)


def test_scroll_delete_keep_last_3_non_contiguous(tmp_path):
    from paddle_tpu_torch.fluid.io import _scroll_delete

    ckpt = str(tmp_path / "ckpt")
    for serial in (1, 4, 9, 12):
        model = os.path.join(ckpt, "checkpoint_%d" % serial, "__model__")
        os.makedirs(model)
        with open(os.path.join(model, "_SUCCESS"), "w") as f:
            f.write("0")
    stray = os.path.join(ckpt, "checkpoint_7")   # a file, not a dir
    with open(stray, "w") as f:
        f.write("torn tmp junk")
    _scroll_delete(ckpt, max_num_checkpoints=3)
    kept = sorted(d for d in os.listdir(ckpt)
                  if os.path.isdir(os.path.join(ckpt, d)))
    assert kept == ["checkpoint_12", "checkpoint_4", "checkpoint_9"]
    assert os.path.exists(stray)
    assert tfluid.io.get_latest_checkpoint_serial(ckpt) == 12


def _sgd_steps(pkg, main, loss, scope, exe, n, seed):
    out = []
    for i in range(n):
        out.append(float(np.ravel(exe.run(
            main, feed=_feed(seed + i), fetch_list=[loss],
            scope=scope)[0])[0]))
    return out


@pytest.mark.parametrize("writer,reader", [("jax", "port"),
                                           ("port", "jax")])
def test_a_checkpoint_one_package_writes_the_other_resumes(
        writer, reader, tmp_path):
    """``writer`` takes 2 SGD steps and saves a checkpoint; ``reader``
    resumes from it in a fresh scope and takes 3 more, as ``writer``
    does without stopping: losses within rtol 1e-4, the checkpoint's
    values bit for bit."""
    init = _init()
    ckpt = str(tmp_path / "ckpt")
    pw = PKGS[writer]
    main, startup, _, _, loss = _build(pw)
    scope, exe = pw.scope(), pw.exe()
    with pw.fluid.scope_guard(scope):
        exe.run(startup)
        pw.load(scope, init)
        _sgd_steps(pw, main, loss, scope, exe, 2, 0)
        saved = pw.read(scope, _persist(main))
        serial = pw.fluid.io.save_checkpoint(
            exe, ckpt, trainer_args={"epoch_id": 0, "step_id": 2},
            main_program=main)
        want = _sgd_steps(pw, main, loss, scope, exe, STEPS, 2)
    pr = PKGS[reader]
    main, startup, _, _, loss = _build(pr)
    scope, exe = pr.scope(), pr.exe()
    with pr.fluid.scope_guard(scope):
        exe.run(startup)
        assert pr.fluid.io.load_checkpoint(exe, ckpt,
                                           main_program=main) == serial
        assert pr.fluid.io.load_trainer_args(ckpt, serial, 0) == \
            {"epoch_id": 0, "step_id": 2}
        got_state = pr.read(scope, _persist(main))
        got = _sgd_steps(pr, main, loss, scope, exe, STEPS, 2)
    for n in saved:
        _same(got_state[n], saved[n])
    np.testing.assert_allclose(got, want, rtol=1e-4)


# --------------------------------------------------- the prepared loop

def _mlp(fluid):
    x = fluid.layers.data(name="x", shape=[N_FEAT], dtype="float32")
    y = fluid.layers.data(name="y", shape=[1], dtype="int64")
    h = fluid.layers.fc(x, size=8, act="relu")
    logits = fluid.layers.fc(h, size=N_CLASS)
    loss = fluid.layers.mean(
        fluid.layers.softmax_with_cross_entropy(logits, y))
    fluid.optimizer.Adam(learning_rate=0.01).minimize(loss)
    return loss


def _mlp_feed(i):
    rng = np.random.RandomState(i)
    x = rng.randn(4, N_FEAT).astype(np.float32)
    return {"x": x, "y": x[:, :N_CLASS].argmax(1)[:, None].astype(np.int64)}


def _mlp_programs():
    main, startup = tfluid.Program(), tfluid.Program()
    with tfluid.program_guard(main, startup), tfluid.unique_name.guard():
        loss = _mlp(tfluid)
    return main, startup, loss


def _run_steps(exe, main, loss, scope, steps):
    return [exe.run(main, feed=_mlp_feed(i), fetch_list=[loss],
                    scope=scope)[0] for i in steps]


def test_a_save_in_a_prepared_loop_writes_the_state_after_its_last_step(
        tmp_path):
    main, startup, loss = _mlp_programs()
    exe = PORT.exe()
    init_scope = PORT.scope()
    exe.run(startup, scope=init_scope)
    names = _persist(main)
    init = get_scope_arrays(init_scope, names)
    ref = PORT.scope()
    set_scope_arrays(ref, init, "cpu")
    want = _run_steps(exe, main, loss, ref, range(6))
    want_mid = None
    scope = PORT.scope()
    set_scope_arrays(scope, init, "cpu")
    prep = exe.prepare(main, feed_specs=_mlp_feed(0), fetch_list=[loss],
                       scope=scope)
    got = []
    for i in range(6):
        got.append(prep.run_prepared(_mlp_feed(i), return_numpy=True)[0])
        if i == 2:
            with tfluid.scope_guard(scope):
                tfluid.io.save_checkpoint(exe, str(tmp_path / "ckpt"),
                                          main_program=main)
            assert prep._prep._dirty is False   # the save synced it
            mid = PORT.scope()
            set_scope_arrays(mid, init, "cpu")
            _run_steps(exe, main, loss, mid, range(3))
            want_mid = get_scope_arrays(mid, names)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    files = tmp_path / "ckpt" / "checkpoint_0" / "__model__"
    for n in names:
        _same(tser.load_tensor(str(files / n)), want_mid[n])


def test_a_load_into_a_live_prepared_programs_scope_restages_it(tmp_path):
    main, startup, loss = _mlp_programs()
    exe = PORT.exe()
    scope = PORT.scope()
    exe.run(startup, scope=scope)
    names = _persist(main)
    init = get_scope_arrays(scope, names)
    with tfluid.scope_guard(scope):
        tfluid.io.save_persistables(exe, str(tmp_path / "init"), main)
    prep = exe.prepare(main, feed_specs=_mlp_feed(0), fetch_list=[loss],
                       scope=scope)
    first = [prep.run_prepared(_mlp_feed(i), return_numpy=True)[0]
             for i in range(3)]
    with tfluid.scope_guard(scope):
        tfluid.io.load_persistables(exe, str(tmp_path / "init"), main)
    again = [prep.run_prepared(_mlp_feed(i), return_numpy=True)[0]
             for i in range(3)]
    for a, b in zip(first, again):
        np.testing.assert_array_equal(a, b)
    prep.sync_scope()
    ref = PORT.scope()
    set_scope_arrays(ref, init, "cpu")
    _run_steps(exe, main, loss, ref, range(3))
    want = get_scope_arrays(ref, names)
    got = get_scope_arrays(scope, names)
    for n in names:
        _same(got[n], want[n])


def test_a_load_of_another_shape_into_a_captured_state_raises():
    """StepGraph.load_state copies into the static tensors; once a graph
    is captured a shape or dtype that differs raises
    PreparedShapeMismatch rather than reallocating (the CPU has no
    graph: it takes the new tensor, as run() would)."""
    from paddle_tpu_torch.core.executor_impl import PreparedShapeMismatch

    main, startup, loss = _mlp_programs()
    exe = PORT.exe()
    scope = PORT.scope()
    exe.run(startup, scope=scope)
    prep = exe.prepare(main, feed_specs=_mlp_feed(0), fetch_list=[loss],
                       scope=scope)
    prep.run_prepared(_mlp_feed(0))
    step = prep._prep._step
    step._captures[()] = object()     # as after a capture on a card
    w = next(n for n in step.state if n.endswith(".w_0"))
    with pytest.raises(PreparedShapeMismatch, match="prepare again"):
        step.load_state(w, torch.zeros(1, dtype=torch.float64))
