"""The port's high-level API (``fluid/trainer.py``, ``inferencer.py``,
``data_feeder.py``, ``reader/``, ``models/mnist.py``) against the JAX
package's, on the CPU.

- The three cases of ``tests/test_trainer.py`` written for the port,
  with numpy readers (the reference's fit_a_line case reads
  ``dataset.uci_housing``, which downloads: here a seeded linear
  problem of its shape, 13 features).
- Both packages' Trainers on one linear model whose parameters start
  constant: losses step by step within rtol 1e-4 (the same f32 math in
  another order; ``tests/test_torch_train.py``'s bar), and so after a
  kill and a resume.
- ``models/mnist.py``'s net through the port's Trainer from the
  parameters the JAX package's ``Trainer.save_params`` wrote (through
  ``param_path``): 3 Adam steps within rtol 1e-4 of the reference's.
- The Trainer's prepared step falls back to ``run()`` on ValueError (a
  host op) and Uncapturable, bit for bit with the prepared losses; the
  place defaults to ``CUDAPlace(0)`` and raises without a card.
- The readers and ``DataFeeder`` give what the reference's give.
"""
import os
import random
import shutil

import numpy as np
import pytest
import torch

import paddle_tpu as jpt
import paddle_tpu.fluid as jfluid
import paddle_tpu_torch as tpt
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu import reader as jreader
from paddle_tpu.models import mnist as jmnist
from paddle_tpu_torch import reader as treader
from paddle_tpu_torch.models import mnist as tmnist

LR = 0.05
N_FEAT = 8
_W = np.random.RandomState(3).randn(N_FEAT, 1).astype(np.float32)


def _train_func(fluid):
    def train_func():
        x = fluid.layers.data(name="x", shape=[N_FEAT], dtype="float32")
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = fluid.layers.fc(
            x, size=1,
            param_attr=fluid.ParamAttr(
                name="w", initializer=fluid.initializer.
                ConstantInitializer(0.0)),
            bias_attr=fluid.ParamAttr(
                name="b", initializer=fluid.initializer.
                ConstantInitializer(0.0)))
        return [fluid.layers.mean(fluid.layers.square_error_cost(pred, y))]

    return train_func


def _infer_func(fluid):
    def infer_func():
        x = fluid.layers.data(name="x", shape=[N_FEAT], dtype="float32")
        return fluid.layers.fc(
            x, size=1, param_attr=fluid.ParamAttr(name="w"),
            bias_attr=fluid.ParamAttr(name="b"))

    return infer_func


def _opt_func(fluid):
    return lambda: fluid.optimizer.SGD(learning_rate=LR)


def _reader(pt, n=48, seed=0):
    def r():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            x = rng.randn(N_FEAT).astype(np.float32)
            yield (x, (x @ _W).astype(np.float32))

    return pt.batch(r, 8)


def _metric(ev):
    return float(np.ravel(ev.metrics[0])[0])


def test_trainer_events_and_test_and_infer(tmp_path):
    events = []
    losses = []

    def handler(ev):
        events.append(type(ev).__name__)
        if isinstance(ev, tfluid.EndStepEvent) and ev.metrics:
            losses.append(_metric(ev))

    t = tfluid.Trainer(train_func=_train_func(tfluid),
                       optimizer_func=_opt_func(tfluid),
                       place=tfluid.CPUPlace())
    t.train(num_epochs=2, event_handler=handler, reader=_reader(tpt),
            feed_order=["x", "y"])
    assert events[0] == "BeginEpochEvent"
    assert events[-1] == "EndEpochEvent"
    assert events.count("BeginEpochEvent") == 2
    assert events.count("BeginStepEvent") == \
        events.count("EndStepEvent") == 12
    assert losses[-1] < losses[0] * 0.5

    test_metrics = t.test(reader=_reader(tpt, seed=1), feed_order=["x", "y"])
    assert len(test_metrics) == 1 and test_metrics[0] < losses[0]

    d = str(tmp_path / "params")
    t.save_params(d)
    inf = tfluid.Inferencer(infer_func=_infer_func(tfluid), param_path=d,
                            place=tfluid.CPUPlace())
    xv = np.ones((4, N_FEAT), np.float32)
    out, = inf.infer({"x": xv})
    w, b = inf.scope.find_var("w").numpy(), inf.scope.find_var("b").numpy()
    np.testing.assert_allclose(np.asarray(out), xv @ w + b, rtol=1e-5)
    with pytest.raises(ValueError, match="dict"):
        inf.infer([xv])


class Killed(Exception):
    pass


def _run(fluid, pt, ckpt, kill_at=None, num_epochs=3):
    seen = []

    def handler(ev):
        if isinstance(ev, fluid.EndStepEvent):
            seen.append((ev.epoch, ev.step, _metric(ev)))
            if kill_at is not None and (ev.epoch, ev.step) == kill_at:
                raise Killed()     # a crash: the checkpoints survive

    cfg = fluid.CheckpointConfig(checkpoint_dir=ckpt, epoch_interval=1,
                                 step_interval=2)
    t = fluid.Trainer(train_func=_train_func(fluid),
                      optimizer_func=_opt_func(fluid),
                      place=fluid.CPUPlace(), checkpoint_config=cfg)
    try:
        t.train(num_epochs=num_epochs, event_handler=handler,
                reader=_reader(pt), feed_order=["x", "y"])
    except Killed:
        pass
    return seen


def test_trainer_checkpoint_kill_and_resume(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    base = _run(tfluid, tpt, ckpt)
    assert not [d for d in os.listdir(ckpt) if d.startswith("checkpoint")]
    shutil.rmtree(ckpt, ignore_errors=True)
    first = _run(tfluid, tpt, ckpt, kill_at=(1, 2))
    assert first[-1][:2] == (1, 2)
    # the checkpoint of (1, 2) holds its update: the resume starts at
    # (1, 3), and from there the losses are the uninterrupted run's
    second = _run(tfluid, tpt, ckpt)
    resumed = {(e, s): v for e, s, v in second}
    assert (0, 0) not in resumed
    assert (1, 2) not in resumed
    assert min(resumed) == (1, 3)
    baseline = {(e, s): v for e, s, v in base}
    for key in resumed:
        assert resumed[key] == baseline[key], key


@pytest.mark.parametrize("kill_at", [None, (1, 2)])
def test_trainer_losses_follow_the_references_step_by_step(kill_at,
                                                           tmp_path):
    """The same linear model (constant initial parameters) through both
    packages' Trainers, uninterrupted and after a kill and a resume:
    losses within rtol 1e-4 at every step."""
    out = {}
    for name, fluid, pt in (("jax", jfluid, jpt), ("port", tfluid, tpt)):
        ckpt = str(tmp_path / name)
        if kill_at is None:
            out[name] = _run(fluid, pt, ckpt)
        else:
            first = _run(fluid, pt, ckpt, kill_at=kill_at)
            out[name] = first + _run(fluid, pt, ckpt)
    assert [k[:2] for k in out["port"]] == [k[:2] for k in out["jax"]]
    np.testing.assert_allclose([v for *_, v in out["port"]],
                               [v for *_, v in out["jax"]], rtol=1e-4)


def test_trainer_checkpoint_crosses_the_packages(tmp_path):
    """A run the JAX package's Trainer checkpointed and was killed in
    resumes in the port's Trainer, and the reverse, on the uninterrupted
    reference's losses (rtol 1e-4)."""
    base = {(e, s): v for e, s, v in _run(jfluid, jpt,
                                          str(tmp_path / "base"))}
    for writer, reader in (((jfluid, jpt), (tfluid, tpt)),
                           ((tfluid, tpt), (jfluid, jpt))):
        ckpt = str(tmp_path / ("ckpt_%s" % writer[0].__name__))
        _run(*writer, ckpt, kill_at=(1, 2))
        resumed = _run(*reader, ckpt)
        assert resumed[0][:2] == (1, 3)
        for e, s, v in resumed:
            np.testing.assert_allclose(v, base[(e, s)], rtol=1e-4,
                                       err_msg=str((e, s)))


def test_trainer_stop_cleans_its_checkpoints(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    cfg = tfluid.CheckpointConfig(checkpoint_dir=ckpt, step_interval=1)
    t = tfluid.Trainer(train_func=_train_func(tfluid),
                       optimizer_func=_opt_func(tfluid),
                       place=tfluid.CPUPlace(), checkpoint_config=cfg)
    steps = []

    def handler(ev):
        if isinstance(ev, tfluid.EndStepEvent):
            steps.append(ev.step)
            assert tfluid.io.get_latest_checkpoint_serial(ckpt) >= 0
            if ev.step == 2:
                t.stop()

    t.train(num_epochs=2, event_handler=handler, reader=_reader(tpt),
            feed_order=["x", "y"])
    assert steps == [0, 1, 2]
    assert tfluid.io.get_latest_checkpoint_serial(ckpt) == -1


def _synthetic_housing(seed, n):
    """uci_housing's shape: 13 features, one target, from a seeded
    linear model with noise."""
    rng = np.random.RandomState(seed)
    w = np.random.RandomState(99).randn(13, 1).astype(np.float32)

    def r():
        for _ in range(n):
            x = rng.randn(13).astype(np.float32)
            yield x, (x @ w + 0.1 * rng.randn(1)).astype(np.float32)

    return r


def test_trainer_fit_a_line(tmp_path):
    """The high-level-api fit_a_line chapter: Trainer, an EndEpoch
    test() gate, then the Inferencer."""

    def train_func():
        x = tfluid.layers.data(name="x", shape=[13], dtype="float32")
        y = tfluid.layers.data(name="y", shape=[1], dtype="float32")
        pred = tfluid.layers.fc(x, size=1, act=None,
                                param_attr=tfluid.ParamAttr(name="fw"),
                                bias_attr=tfluid.ParamAttr(name="fb"))
        return [tfluid.layers.mean(
            tfluid.layers.square_error_cost(input=pred, label=y))]

    def infer_func():
        x = tfluid.layers.data(name="x", shape=[13], dtype="float32")
        return tfluid.layers.fc(x, size=1, act=None,
                                param_attr=tfluid.ParamAttr(name="fw"),
                                bias_attr=tfluid.ParamAttr(name="fb"))

    trainer = tfluid.Trainer(
        train_func=train_func,
        optimizer_func=lambda: tfluid.optimizer.SGD(learning_rate=0.01),
        place=tfluid.CPUPlace())
    test_losses = []

    def handler(ev):
        if isinstance(ev, tfluid.EndEpochEvent):
            test_losses.append(trainer.test(
                reader=tpt.batch(_synthetic_housing(1, 96), 32),
                feed_order=["x", "y"])[0])

    trainer.train(num_epochs=12, event_handler=handler,
                  reader=tpt.batch(_synthetic_housing(0, 384), 32),
                  feed_order=["x", "y"])
    assert test_losses[-1] < test_losses[0] * 0.5, test_losses[:3]
    param_path = str(tmp_path / "fit_a_line")
    trainer.save_params(param_path)
    inferencer = tfluid.Inferencer(infer_func=infer_func,
                                   param_path=param_path,
                                   place=tfluid.CPUPlace())
    batch = np.stack([s[0] for s in _synthetic_housing(1, 8)()])
    preds = np.asarray(inferencer.infer({"x": batch})[0])
    assert preds.shape == (8, 1) and np.isfinite(preds).all()


def test_trainer_save_inference_model_matches_its_test_program(tmp_path):
    t = tfluid.Trainer(train_func=_train_func(tfluid),
                       optimizer_func=_opt_func(tfluid),
                       place=tfluid.CPUPlace())
    t.train(num_epochs=1, event_handler=lambda ev: None,
            reader=_reader(tpt), feed_order=["x", "y"])
    d = str(tmp_path / "inf")
    t.save_inference_model(d, ["x", "y"], [0])
    xs = np.random.RandomState(5).randn(3, N_FEAT).astype(np.float32)
    ys = np.random.RandomState(6).randn(3, 1).astype(np.float32)
    exe = tfluid.Executor(tfluid.CPUPlace())
    want, = exe.run(t.test_program, feed={"x": xs, "y": ys},
                    fetch_list=[t.train_func_outputs[0]], scope=t.scope)
    with tfluid.scope_guard(tfluid.Scope()):
        prog, feeds, fetches = tfluid.io.load_inference_model(d, exe)
        got, = exe.run(prog, feed={"x": xs, "y": ys}, fetch_list=fetches)
    assert feeds == ["x", "y"]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------- the fallbacks

def _prepared_and_run_losses(monkeypatch, tail_print=False, refuse=None):
    if refuse is not None:
        from paddle_tpu_torch.core import executor_impl

        def prepare(*a, **k):
            raise refuse("refused for the test")

        monkeypatch.setattr(executor_impl.ExecutorCore, "prepare", prepare)

    def train_func():
        outs = _train_func(tfluid)()
        if tail_print:
            tfluid.layers.Print(outs[0], message="loss", summarize=0)
        return outs

    t = tfluid.Trainer(train_func=train_func,
                       optimizer_func=_opt_func(tfluid),
                       place=tfluid.CPUPlace())
    seen = []
    t.train(num_epochs=1,
            event_handler=lambda ev: seen.append(_metric(ev))
            if isinstance(ev, tfluid.EndStepEvent) else None,
            reader=_reader(tpt), feed_order=["x", "y"])
    return seen, t


@pytest.mark.parametrize("cause", ["host_op", "uncapturable"])
def test_trainer_runs_what_prepare_refuses_through_run(cause, monkeypatch,
                                                       capsys):
    from paddle_tpu_torch.core.executor_impl import Uncapturable

    want, _ = _prepared_and_run_losses(monkeypatch)
    if cause == "host_op":
        got, _ = _prepared_and_run_losses(monkeypatch, tail_print=True)
        out = capsys.readouterr().out
        assert out.count("loss\tshape=") == len(got) == 6
    else:
        got, _ = _prepared_and_run_losses(monkeypatch, refuse=Uncapturable)
    assert got == want


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_trainer_and_inferencer_default_to_the_card(monkeypatch, tmp_path):
    """No place: CUDAPlace(0), which raises without a card; the port
    never drops to the CPU by itself."""
    from paddle_tpu_torch.fluid.trainer import check_and_get_place

    assert check_and_get_place(None) == tfluid.CUDAPlace(0)
    assert check_and_get_place(tfluid.CPUPlace()) == tfluid.CPUPlace()
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Trainer(train_func=_train_func(tfluid),
                       optimizer_func=_opt_func(tfluid))
    with pytest.raises(RuntimeError, match="CUDA"):
        tfluid.Inferencer(infer_func=_infer_func(tfluid),
                          param_path=str(tmp_path))


def test_training_role_is_not_ported(monkeypatch):
    monkeypatch.setenv("PADDLE_TRAINING_ROLE", "TRAINER")
    with pytest.raises(NotImplementedError, match="item 10"):
        tfluid.Trainer(train_func=_train_func(tfluid),
                       optimizer_func=_opt_func(tfluid),
                       place=tfluid.CPUPlace())


def test_optimizer_func_must_return_an_optimizer():
    with pytest.raises(TypeError, match="Optimizer"):
        tfluid.Trainer(train_func=_train_func(tfluid),
                       optimizer_func=lambda: None,
                       place=tfluid.CPUPlace())


# ------------------------------------------------------------ mnist

def _mnist_train_func(fluid, module):
    def train_func():
        images = fluid.layers.data(name="pixel", shape=[1, 28, 28],
                                   dtype="float32")
        label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        predict = module.cnn_model(images)
        cost = fluid.layers.cross_entropy(input=predict, label=label)
        avg_cost = fluid.layers.mean(cost)
        acc = fluid.layers.accuracy(input=predict, label=label)
        return [avg_cost, acc]

    return train_func


def _mnist_reader(pt):
    def r():
        rng = np.random.RandomState(7)
        for _ in range(3 * 8):
            yield (rng.rand(1, 28, 28).astype(np.float32),
                   rng.randint(0, 10, (1,)).astype(np.int64))

    return pt.batch(r, 8)


def test_mnist_follows_the_references_trajectory_from_its_saved_params(
        tmp_path):
    """The JAX package's Trainer writes its startup parameters
    (save_params); both packages' Trainers load them through
    ``param_path`` and take 3 Adam steps: losses within rtol 1e-4."""
    params = str(tmp_path / "params")
    losses = {}
    for name, fluid, pt, module in (("jax", jfluid, jpt, jmnist),
                                    ("port", tfluid, tpt, tmnist)):
        if name == "jax":
            jfluid.Trainer(
                train_func=_mnist_train_func(fluid, module),
                optimizer_func=lambda: jfluid.optimizer.Adam(
                    learning_rate=0.001),
                place=jfluid.CPUPlace()).save_params(params)
        t = fluid.Trainer(
            train_func=_mnist_train_func(fluid, module),
            optimizer_func=lambda: fluid.optimizer.Adam(
                learning_rate=0.001, beta1=0.9, beta2=0.999),
            param_path=params, place=fluid.CPUPlace())
        seen = []
        t.train(num_epochs=1,
                event_handler=lambda ev: seen.append(_metric(ev))
                if isinstance(ev, fluid.EndStepEvent) else None,
                reader=_mnist_reader(pt), feed_order=["pixel", "label"])
        losses[name] = seen
    assert len(losses["port"]) == 3
    np.testing.assert_allclose(losses["port"], losses["jax"], rtol=1e-4)


def test_mnist_desc_serializes_as_the_references():
    out = []
    for fluid, module in ((jfluid, jmnist), (tfluid, tmnist)):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            module.get_model()
        out.append((main.serialize_to_string(),
                    startup.serialize_to_string()))
    assert out[0] == out[1]


# -------------------------------------------- DataFeeder and readers

def test_data_feeder_feeds_what_the_references_feeds():
    out = []
    samples = [(np.arange(6, dtype=np.float64) + i, [i]) for i in range(4)]
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.program_guard(main):
            x = fluid.layers.data(name="x", shape=[2, 3], dtype="float32")
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            feeder = fluid.DataFeeder(feed_list=[x, "y"], program=main)
        out.append(feeder.feed(samples))
    assert sorted(out[0]) == sorted(out[1]) == ["x", "y"]
    for k in out[0]:
        assert out[1][k].dtype == out[0][k].dtype
        np.testing.assert_array_equal(out[1][k], out[0][k])
    assert out[1]["x"].shape == (4, 2, 3)


def test_data_feeder_refuses_a_ragged_slot():
    """(Its name is kept from when a ragged slot raised.)  A lod_level 1
    slot beside a dense one builds the reference's LoDTensor: the same
    flat int64 data and offsets; a feed_list entry that is no Variable
    still raises."""
    from paddle_tpu_torch.core.lod import LoDTensor

    samples = [([1, 2], [0]), ([3], [1]), ([4, 5, 6], [0])]
    out = []
    for fluid in (jfluid, tfluid):
        main = fluid.Program()
        with fluid.program_guard(main):
            w = fluid.layers.data(name="w", shape=[1], dtype="int64",
                                  lod_level=1)
            y = fluid.layers.data(name="y", shape=[1], dtype="int64")
            out.append(fluid.DataFeeder(feed_list=[w, y],
                                        program=main).feed(samples))
    assert isinstance(out[1]["w"], LoDTensor)
    assert out[1]["w"].lod == out[0]["w"].lod == [[0, 2, 3, 6]]
    np.testing.assert_array_equal(out[1]["w"].data, out[0]["w"].data)
    assert out[1]["w"].data.dtype == np.int64
    np.testing.assert_array_equal(out[1]["y"], out[0]["y"])
    with pytest.raises(TypeError):
        tfluid.DataFeeder(feed_list=[3], program=main)


def _drain(reader):
    return [np.asarray(s).tolist() if isinstance(s, np.ndarray) else s
            for s in reader()]


def test_readers_give_what_the_references_give(tmp_path):
    arr = np.arange(20).reshape(10, 2)
    path = tmp_path / "lines.txt"
    path.write_text("a\nb b\n\nc\n")

    def build(pt, rd):
        src = rd.creator.np_array(arr)
        ints = rd.creator.np_array(arr[:, 0].tolist())
        lines = rd.creator.text_file(str(path))
        return {
            "np_array": src,
            "text_file": lines,
            "map": rd.map_readers(lambda a, b: int(a.sum() + b.sum()), src,
                                  src),
            "chain": rd.chain(src, src),
            "compose": rd.compose(ints, rd.map_readers(lambda a: (a, 1),
                                                       ints)),
            "firstn": rd.firstn(src, 3),
            "buffered": rd.buffered(src, 2),
            "cache": rd.cache(src),
            "xmap": rd.xmap_readers(lambda a: int(a[0]) * 2, src, 3, 4,
                                    order=True),
            "batch": pt.batch(src, 4),
            "batch_tail": pt.batch(src, 4, drop_last=False),
        }

    got, want = build(tpt, treader), build(jpt, jreader)
    for k in want:
        g, w = _drain(got[k]), _drain(want[k])
        assert repr(g) == repr(w), k
    for pt, rd in ((tpt, treader), (jpt, jreader)):
        random.seed(3)
        a = _drain(rd.shuffle(rd.creator.np_array(arr), 4))
        if rd is treader:
            shuffled = a
        else:
            assert a == shuffled
    ints = treader.creator.np_array(list(range(5)))
    bad = treader.compose(ints, treader.firstn(ints, 2))
    with pytest.raises(treader.ComposeNotAligned):
        _drain(bad)
