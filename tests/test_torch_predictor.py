"""The port's predictor API (``paddle_tpu_torch/inference``) against the
JAX package's (``paddle_tpu/inference``), on the CPU.

The reference's cases (tests/test_predictor.py) for the port, and:

- a model directory the JAX package saved is loaded and run by the
  port's predictor, and the reverse;
- NativeConfig's and AnalysisConfig's outputs (the BN fold; bf16) agree
  with the reference predictor's on the same directory: within 1e-5 in
  f32 (the same f32 math summed in another order), within 2**-7 (two
  bf16 ulps, tests/test_torch_amp.py's bar) in bf16;
- the config defaults to the card (``use_gpu=True``, ``use_tpu`` its
  alias): the CPU is asked for with ``use_gpu=False``.
"""
import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu.inference as jinf
import paddle_tpu_torch.fluid as tfluid
import paddle_tpu_torch.inference as tinf
from paddle_tpu.core.scope import Scope as JScope
from paddle_tpu_torch.fluid.io import set_scope_arrays

AMP_TOL = 2 ** -7


def _fluid(pkg):
    return jfluid if pkg == "jax" else tfluid


def _build(fluid):
    main, startup = fluid.Program(), fluid.Program()
    layers = fluid.layers
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        img = layers.data(name="img", shape=[3, 8, 8], dtype="float32")
        conv = layers.conv2d(img, num_filters=4, filter_size=3, padding=1,
                             bias_attr=True)
        bn = layers.batch_norm(conv, is_test=True)
        out = layers.fc(layers.relu(bn), size=5, act="softmax")
    return main, startup, out


def _init():
    """The reference's startup values, BN statistics made non-trivial."""
    main, startup, _ = _build(jfluid)
    scope = JScope()
    jfluid.Executor(jfluid.CPUPlace()).run(startup, scope=scope)
    vals = {v.name: np.array(scope.find_var(v.name))
            for v in main.list_vars() if v.persistable}
    rng = np.random.RandomState(1)
    op = [o for o in main.desc.blocks[0].ops if o.type == "batch_norm"][0]
    vals[op.inputs["Mean"][0]] = rng.randn(4).astype(np.float32) * 0.1
    vals[op.inputs["Variance"][0]] = (rng.rand(4) + 0.5).astype(np.float32)
    return vals


def _save(pkg, dirname, init):
    """Save the model with ``pkg``; returns (input, the executor's
    output)."""
    fluid = _fluid(pkg)
    main, startup, out = _build(fluid)
    scope = JScope() if pkg == "jax" else tfluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        if pkg == "jax":
            for n, v in init.items():
                scope.set(n, np.array(v))
        else:
            set_scope_arrays(scope, init, "cpu")
        fluid.io.save_inference_model(dirname, ["img"], [out], exe,
                                      main_program=main)
        xv = np.random.RandomState(0).rand(2, 3, 8, 8).astype(np.float32)
        want, = exe.run(main, feed={"img": xv}, fetch_list=[out])
    return xv, np.asarray(want)


def _port(config_cls, d, **kw):
    return tinf.create_paddle_predictor(config_cls(model_dir=d,
                                                   use_gpu=False, **kw))


def _ref(config_cls, d, **kw):
    return jinf.create_paddle_predictor(config_cls(model_dir=d, **kw))


def test_native_predictor_matches_executor(tmp_path):
    d = str(tmp_path / "model")
    xv, want = _save("port", d, _init())
    pred = _port(tinf.NativeConfig, d)
    outs = pred.run([tinf.PaddleTensor(name="img", data=xv)])
    assert len(outs) == 1
    np.testing.assert_allclose(outs[0].data, want, rtol=1e-5, atol=1e-6)
    # dict-feed form and positional (unnamed) form
    np.testing.assert_allclose(pred.run({"img": xv})[0].data, want,
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        pred.Run([tinf.PaddleTensor(data=xv)])[0].data, want, rtol=1e-5,
        atol=1e-6)


def test_analysis_predictor_folds_bn(tmp_path):
    d = str(tmp_path / "model")
    xv, want = _save("port", d, _init())
    pred = _port(tinf.AnalysisConfig, d, fold_batch_norm=True)
    assert not any(op.type == "batch_norm"
                   for op in pred.program.desc.blocks[0].ops)
    np.testing.assert_allclose(pred.run({"img": xv})[0].data, want,
                               rtol=1e-4, atol=1e-5)


def test_predictor_clone_shares_weights(tmp_path):
    d = str(tmp_path / "model")
    xv, want = _save("port", d, _init())
    pred = _port(tinf.NativeConfig, d)
    clone = pred.Clone()
    assert clone.scope is pred.scope and clone.exe is pred.exe
    assert clone.program is pred.program and clone.aot is pred.aot
    np.testing.assert_allclose(clone.run({"img": xv})[0].data, want,
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError, match="missing feeds"):
        pred.run({})


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("config", ["native", "analysis"])
def test_predictors_agree_across_the_packages(writer, config, tmp_path):
    """A directory either package wrote, served by both packages'
    predictors: the port's output within 1e-5 of the reference's."""
    d = str(tmp_path / writer)
    xv, _ = _save(writer, d, _init())
    cls = {"native": (tinf.NativeConfig, jinf.NativeConfig),
           "analysis": (tinf.AnalysisConfig, jinf.AnalysisConfig)}[config]
    got = _port(cls[0], d).run({"img": xv})[0].data
    want = np.asarray(_ref(cls[1], d).run({"img": xv})[0].data)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_bf16_predictor_agrees_with_the_references(tmp_path):
    d = str(tmp_path / "model")
    xv, f32 = _save("port", d, _init())
    pred = _port(tinf.AnalysisConfig, d, use_bf16=True)
    assert pred.program.desc.amp_bf16 and pred.aot is None
    got = pred.run({"img": xv})[0].data
    want = np.asarray(_ref(jinf.AnalysisConfig, d, use_bf16=True)
                      .run({"img": xv})[0].data)
    np.testing.assert_allclose(got, want, rtol=AMP_TOL, atol=AMP_TOL)
    np.testing.assert_allclose(got, f32, rtol=0.05, atol=0.05)


def test_config_defaults_to_the_card(monkeypatch, tmp_path):
    import torch

    cfg = tinf.NativeConfig(model_dir="m")
    assert cfg.use_gpu is True and cfg.use_tpu is True
    assert tinf.NativeConfig(model_dir="m", use_tpu=False).use_gpu is False
    assert tinf.AnalysisConfig("m", use_gpu=False).use_tpu is False
    d = str(tmp_path / "model")
    _save("port", d, _init())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.create_paddle_predictor(tinf.NativeConfig(model_dir=d))
