"""AOT inference export in the port (``paddle_tpu_torch/inference/aot.py``)
against the JAX package's contract (tests/test_inference_aot.py), on the
CPU.

``save_inference_model(aot_feed_specs=...)`` writes block 0 as a
``torch.export`` program beside the model; a predictor loads and runs it
with zero op lowerings (``core/lowering.LOWERINGS``), bit for bit with
the port's executor path (the same ops in the same order).  A platform
mismatch, the JAX package's ``__aot__.pkl`` alone, or a corrupt artifact
is a counted fallback (``FALLBACK_COUNT``, ``FALLBACKS``) that still
serves right outputs; a program with host ops is refused.  The
reference's persist-slot / ``_run_lock`` contract holds.  A fused-LM
inference program reaches K1, K4 and K5 through their custom ops
(``kernels/custom_ops.py``), exports and reloads.
"""
import json
import os
import subprocess
import sys
import threading
import warnings

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch import inference as inf
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.inference import aot

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _native(d, **kw):
    return inf.create_paddle_predictor(
        inf.NativeConfig(model_dir=d, use_gpu=False, **kw))


def _build_fc(fl):
    main, startup = fl.Program(), fl.Program()
    with fl.program_guard(main, startup), fl.unique_name.guard():
        x = fl.layers.data(name="x", shape=[6], dtype="float32")
        h = fl.layers.fc(x, size=5, act="tanh")
        out = fl.layers.fc(h, size=3, act="softmax")
    return main, startup, out


def _build_and_save(d, fl=fluid, specs=((4, 6), "float32")):
    """The reference's fc model, saved by ``fl``'s package with the AOT
    spec; returns (input, the executor path's output)."""
    main, startup, out = _build_fc(fl)
    scope = fl.Scope() if fl is fluid else \
        __import__("paddle_tpu.core.scope", fromlist=["Scope"]).Scope()
    exe = fl.Executor(fl.CPUPlace())
    with fl.scope_guard(scope):
        exe.run(startup)
        fl.io.save_inference_model(d, ["x"], [out], exe, main_program=main,
                                   aot_feed_specs={"x": specs})
        xs = np.linspace(-1, 1, 24).astype(np.float32).reshape(4, 6)
        ref, = exe.run(main.clone(for_test=True), feed={"x": xs},
                       fetch_list=[out])
    return xs, np.asarray(ref)


def _build_and_save_bn(d):
    """conv + BN model: its test-mode batch_norm writes its running
    statistics back (the persist slots)."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[2, 8, 8], dtype="float32")
        c = fluid.layers.conv2d(x, num_filters=3, filter_size=3, padding=1)
        b = fluid.layers.batch_norm(c)
        out = fluid.layers.reduce_mean(b, dim=[2, 3])
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(
            d, ["x"], [out], exe, main_program=main,
            aot_feed_specs={"x": ((2, 2, 8, 8), "float32")})
        xs = np.linspace(-1, 1, 256).astype(np.float32).reshape(2, 2, 8, 8)
        ref, = exe.run(main.clone(for_test=True), feed={"x": xs},
                       fetch_list=[out])
    return xs, np.asarray(ref)


def test_aot_artifacts_written(tmp_path):
    d = str(tmp_path / "m")
    _build_and_save(d)
    assert os.path.exists(os.path.join(d, aot.AOT_PROGRAM))
    with open(os.path.join(d, aot.AOT_META)) as f:
        meta = json.load(f)
    assert meta["specs"] == {"x": [[4, 6], "float32"]}
    assert meta["platform"] == "cpu" and meta["fetch"] == ["fc_1.tmp_2"]
    assert meta["input_names"][0] == "x" and meta["persists"] == []
    # the JAX package's artifact names are left free
    assert not os.path.exists(os.path.join(d, "__aot__.pkl"))


FRESH = """
import json, sys
import numpy as np
from paddle_tpu_torch import inference as inf
from paddle_tpu_torch.core import lowering
pred = inf.create_paddle_predictor(
    inf.NativeConfig(model_dir=sys.argv[1], use_gpu=False))
x = np.asarray(json.loads(sys.argv[2]), np.float32)
out = pred.run({"x": x})[0].data
print(json.dumps({"aot": pred.aot is not None,
                  "lowerings": lowering.LOWERINGS,
                  "jax": "jax" in sys.modules,
                  "out": out.tobytes().hex()}))
"""


def test_aot_serves_fresh_process_no_lowering(tmp_path):
    d = str(tmp_path / "m")
    xs, _ = _build_and_save(d)
    want = _native(d, use_aot=False).run({"x": xs})[0].data
    proc = subprocess.run(
        [sys.executable, "-c", FRESH, d, json.dumps(xs.tolist())],
        capture_output=True, text=True, timeout=240,
        env=dict(os.environ, PYTHONPATH=REPO, JAX_PLATFORMS="cpu"))
    assert proc.returncode == 0, proc.stderr[-3000:]
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["aot"], "predictor did not load the exported program"
    assert got["lowerings"] == 0, "fresh process lowered %d ops" \
        % got["lowerings"]
    assert not got["jax"]
    assert bytes.fromhex(got["out"]) == want.tobytes()


def test_aot_spec_mismatch_falls_back(tmp_path):
    """A feed whose shape differs from the exported spec is served by
    the executor path, with right results; the exported batch still
    goes through the program, lowering nothing."""
    d = str(tmp_path / "m")
    xs, ref = _build_and_save(d)
    pred = _native(d)
    assert pred.aot is not None
    out = pred.run({"x": np.vstack([xs, xs])})   # batch 8 != 4
    np.testing.assert_allclose(out[0].data[:4], ref, atol=1e-6)
    np.testing.assert_allclose(out[0].data[4:], ref, atol=1e-6)
    n0 = lowering.LOWERINGS
    np.testing.assert_array_equal(pred.run({"x": xs})[0].data, ref)
    assert lowering.LOWERINGS == n0


def test_aot_bn_model_repeat_runs(tmp_path):
    """The written persistables go back into the staged slots between
    calls: repeated runs through the same program stay right."""
    d = str(tmp_path / "m")
    xs, ref = _build_and_save_bn(d)
    pred = _native(d)
    assert pred.aot is not None and pred.aot._persist_slots
    for _ in range(3):
        np.testing.assert_allclose(pred.run({"x": xs})[0].data, ref,
                                   atol=1e-5)


def test_aot_concurrent_cloned_predictors(tmp_path):
    """clone() shares the AotExecutable; four threads serving through it
    at once all get right answers."""
    d = str(tmp_path / "m")
    xs, ref = _build_and_save_bn(d)
    pred = _native(d)
    assert pred.aot is not None
    preds = [pred] + [pred.clone() for _ in range(3)]
    errors = []

    def serve(p):
        try:
            for _ in range(8):
                np.testing.assert_allclose(p.run({"x": xs})[0].data, ref,
                                           atol=1e-5)
        except Exception as e:
            errors.append(e)

    ts = [threading.Thread(target=serve, args=(p,)) for p in preds]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    assert not any(t.is_alive() for t in ts), "serve thread hung"
    assert not errors, errors[0]


def test_aot_lock_skipped_without_persists(tmp_path):
    """A program that writes no persistable takes no lock: run()
    completes while another thread HOLDS it."""
    d = str(tmp_path / "m")
    xs, ref = _build_and_save(d)
    pred = _native(d)
    assert pred.aot is not None and pred.aot._persist_slots == []
    done = threading.Event()
    out = {}

    def serve():
        out["v"] = pred.run({"x": xs})
        done.set()

    with pred.aot._run_lock:
        t = threading.Thread(target=serve, daemon=True)
        t.start()
        assert done.wait(60), "persist-free run() blocked on _run_lock"
    t.join(30)
    np.testing.assert_allclose(out["v"][0].data, ref, atol=1e-6)


def test_aot_lock_still_serializes_persist_writeback(tmp_path):
    """A program WITH written persistables keeps taking the lock."""
    d = str(tmp_path / "m")
    xs, _ = _build_and_save_bn(d)
    pred = _native(d)
    assert pred.aot is not None and pred.aot._persist_slots
    done = threading.Event()

    def serve():
        pred.run({"x": xs})
        done.set()

    with pred.aot._run_lock:
        t = threading.Thread(target=serve, daemon=True)
        t.start()
        assert not done.wait(0.5), \
            "run() with written persistables skipped _run_lock"
    assert done.wait(60)
    t.join(30)


def test_aot_load_fallback_counted(tmp_path):
    """A corrupt artifact and a platform mismatch each count a fallback
    with its reason, and the predictor still serves right outputs."""
    d = str(tmp_path / "m")
    xs, ref = _build_and_save(d)
    with open(os.path.join(d, aot.AOT_PROGRAM), "wb") as f:
        f.write(b"PK\x03\x04 garbage")
    before = aot.FALLBACK_COUNT
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        assert aot.load_aot(d, fluid.Scope(), fluid.CPUPlace()) is None
    assert aot.FALLBACK_COUNT == before + 1
    assert aot.FALLBACKS[-1]["reason"] == "load_error"
    assert aot.FALLBACKS[-1]["dir"] == d
    d2 = str(tmp_path / "m2")
    _build_and_save(d2)
    meta_path = os.path.join(d2, aot.AOT_META)
    with open(meta_path) as f:
        meta = json.load(f)
    meta["platform"] = "cuda"
    with open(meta_path, "w") as f:
        json.dump(meta, f)
    pred = _native(d2)
    assert pred.aot is None
    assert aot.FALLBACK_COUNT == before + 2
    assert aot.FALLBACKS[-1]["reason"] == "platform_mismatch"
    np.testing.assert_allclose(pred.run({"x": xs})[0].data, ref, atol=1e-6)


def test_jax_artifact_is_a_counted_fallback(tmp_path):
    """A directory the JAX package saved with aot_feed_specs holds its
    ``__aot__.pkl`` and none of the port's: the port's predictor counts a
    fallback and serves through the executor, within 1e-5 of the
    reference's output."""
    d = str(tmp_path / "m")
    xs, ref = _build_and_save(d, fl=jfluid)
    assert os.path.exists(os.path.join(d, "__aot__.pkl"))
    before = aot.FALLBACK_COUNT
    pred = _native(d)
    assert pred.aot is None
    assert aot.FALLBACK_COUNT == before + 1
    assert aot.FALLBACKS[-1]["reason"] == "jax_artifact"
    np.testing.assert_allclose(pred.run({"x": xs})[0].data, ref, rtol=1e-5,
                               atol=1e-6)


def test_aot_skipped_under_analysis_passes(tmp_path):
    """AnalysisConfig's BN fold mutates the parameter scope: the exported
    program (traced from the unfolded one) is not served against it."""
    d = str(tmp_path / "m")
    xs, ref = _build_and_save_bn(d)
    pred = inf.create_paddle_predictor(
        inf.AnalysisConfig(model_dir=d, use_gpu=False))
    assert pred.aot is None
    np.testing.assert_allclose(pred.run({"x": xs})[0].data, ref, atol=1e-4)


def test_host_op_program_is_refused(tmp_path):
    main, startup, out = _build_fc(fluid)
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        fluid.Executor(fluid.CPUPlace()).run(startup)
    prog = main.clone(for_test=True)
    with fluid.program_guard(prog):
        fluid.layers.Print(prog.global_block().var(out.name))
    for build in (aot.save_aot, aot.build_aot):
        args = (prog, {"x": ((4, 6), "float32")}, [out.name], scope,
                fluid.CPUPlace())
        with pytest.raises(ValueError, match="host ops"):
            build(str(tmp_path), *args) if build is aot.save_aot \
                else build(*args)
    assert not os.listdir(tmp_path)


def test_build_aot_bucket_matches_executor(tmp_path):
    """build_aot (the serving tier's bucket) over the prepared step:
    its specs, bit for bit the executor path's output, the written
    persistables kept in its own state (the scope untouched)."""
    d = str(tmp_path / "m")
    xs, ref = _build_and_save_bn(d)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        prog, _, fetches = fluid.io.load_inference_model(d, exe)
        want, = exe.run(prog, feed={"x": xs}, fetch_list=fetches)
    versions = dict(scope._write_versions)
    bucket = aot.build_aot(prog, {"x": ((2, 2, 8, 8), np.float32)},
                           [v.name for v in fetches], scope,
                           fluid.CPUPlace())
    assert bucket.matches({"x": xs}) and not bucket.matches({"x": xs[:1]})
    assert bucket.build_seconds > 0 and bucket.graphs == 0
    for _ in range(2):
        np.testing.assert_array_equal(bucket.run({"x": xs})[0], want)
    assert dict(scope._write_versions) == versions
    np.testing.assert_allclose(want, ref, atol=1e-5)


def _fused_lm_program():
    """The fused transformer LM's inference program (fused_qkv_matmul,
    fused_matmul_bias_act, fused_add_ln, ring_attention) at a small
    width; returns (main, startup, logits name)."""
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        transformer.get_model(vocab_size=64, seq_len=16, d_model=32,
                              n_head=2, n_layers=2, d_ff=64,
                              fuse_transformer=True)
    logits = [op.input("Logits")[0] for op in main.desc.blocks[0].ops
              if op.type == "softmax_with_cross_entropy"][0]
    return main, startup, logits


def test_fused_lm_exports_through_the_custom_ops(tmp_path):
    import torch

    d = str(tmp_path / "lm")
    main, startup, logits = _fused_lm_program()
    types = {op.type for op in main.desc.blocks[0].ops}
    assert {"fused_qkv_matmul", "fused_matmul_bias_act", "fused_add_ln",
            "ring_attention"} <= types
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    src = np.random.RandomState(3).randint(0, 64, (2, 16)).astype(np.int64)
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(
            d, ["src"], [main.global_block().var(logits)], exe,
            main_program=main, aot_feed_specs={"src": ((2, 16), "int64")})
    ep = torch.export.load(os.path.join(d, aot.AOT_PROGRAM))
    called = {str(n.target) for n in ep.graph.nodes
              if n.op == "call_function"}
    for op in ("flash_fwd", "matmul_epilogue", "add_ln"):
        assert any("paddle_tpu_torch.%s" % op in c for c in called), op
    pred = _native(d)
    assert pred.aot is not None
    n0 = lowering.LOWERINGS
    got = pred.run({"src": src})[0].data
    assert lowering.LOWERINGS == n0
    want = _native(d, use_aot=False).run({"src": src})[0].data
    assert got.shape == (2, 16, 64)
    np.testing.assert_array_equal(got, want)
