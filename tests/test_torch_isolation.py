"""paddle_tpu_torch stands alone: no module of the port, and not
chip_smoke.py, imports jax or paddle_tpu; entry points (the generative
and predict tiers, the predictor) default to CUDA and raise without it
unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from paddle_tpu_torch import resolve_device
from paddle_tpu_torch.serving import (GenerativeEngine, InferenceServer,
                                      tiny_lm)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "paddle_tpu")


def _port_files():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "paddle_tpu_torch")):
        out.extend(os.path.join(root, f) for f in files
                   if f.endswith(".py"))
    return sorted(out)


def _imports(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif isinstance(node, ast.Call) and \
                getattr(node.func, "id", None) == "__import__":
            for arg in node.args[:1]:
                if isinstance(arg, ast.Constant):
                    yield str(arg.value)


def test_port_imports_neither_jax_nor_paddle_tpu():
    files = _port_files()
    assert len(files) > 10, files
    rel = {os.path.relpath(f, REPO) for f in files}
    for mod in ("analysis/defuse.py", "fluid/transpiler/pass_framework.py",
                "fluid/transpiler/layout_transpiler.py",
                "fluid/transpiler/transformer_fuse.py", "ops/fused_ops.py",
                "kernels/matmul_fused.py", "kernels/conv_fused.py",
                "models/resnet.py", "ops/metric.py",
                "fluid/layers/metric_op.py", "parallel/__init__.py",
                "parallel/mesh.py", "parallel/api.py", "parallel/ring.py",
                "fluid/parallel_executor.py", "kernels/fused.py",
                "dataset/common.py", "dataset/wmt14.py",
                "dataset/movielens.py", "dataset/conll05.py",
                "ops/crf_ctc.py", "ops/beam_search.py", "ops/detection.py",
                "ops/misc.py", "fluid/layers/detection.py",
                "fluid/metrics.py", "fluid/evaluator.py",
                "fluid/average.py", "inference/__init__.py",
                "inference/aot.py", "kernels/custom_ops.py",
                "fluid/transpiler/inference_transpiler.py",
                "fluid/transpiler/memory_optimization_transpiler.py",
                "serving/engine.py", "serving/batcher.py",
                "serving/wire.py"):
        assert "paddle_tpu_torch/" + mod in rel, mod
    bad = []
    for path in files:
        for mod in _imports(path):
            if mod.split(".")[0] in FORBIDDEN:
                bad.append("%s imports %s" % (os.path.relpath(path, REPO),
                                              mod))
    assert not bad, bad


def _no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_load_generative_without_cuda_raises(monkeypatch):
    _no_cuda(monkeypatch)
    cfg, params = tiny_lm(7, vocab=64, d_model=32, n_heads=2, n_layers=1,
                          d_ff=64, block_size=8, max_blocks=8, max_batch=4)
    with InferenceServer() as srv:
        with pytest.raises(RuntimeError, match="CUDA"):
            srv.load_generative("g", cfg, params, kv_blocks=8)
        assert srv.models() == []
    with pytest.raises(RuntimeError, match="CUDA"):
        GenerativeEngine(cfg, params, kv_blocks=8, warm=False)


def test_resolve_device(monkeypatch):
    assert resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError):
        resolve_device("meta")
    _no_cuda(monkeypatch)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()


def test_chip_smoke_alone_exits_nonzero(tmp_path):
    """Copied into a directory that holds nothing else of the repo (or
    run without a card), the script fails and prints no result."""
    src = os.path.join(REPO, "chip_smoke.py")
    dst = tmp_path / "chip_smoke.py"
    dst.write_text(open(src).read())
    proc = subprocess.run([sys.executable, str(dst)], cwd=str(tmp_path),
                          capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


RESNET_STANDALONE = """
import sys
for mod in ("jax", "jaxlib", "google.protobuf", "paddle_tpu"):
    sys.modules[mod] = None       # any import of them now fails
import math
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import resnet

main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    loss, _, _ = resnet.get_model(data_set="cifar10", depth=8,
                                  input_dtype="uint8", data_format="NHWC",
                                  fused_stages=True)
assert any(o.type == "fused_conv2d_bn_act" for o in main.desc.blocks[0].ops)
scope = fluid.Scope()
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup, scope=scope)
rng = np.random.RandomState(0)
feed = {"data": rng.randint(0, 256, (4, 3, 32, 32)).astype(np.uint8),
        "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                        scope=scope)[0][0]) for _ in range(2)]
assert all(math.isfinite(x) for x in losses), losses
assert losses[1] < losses[0], losses
print("OK", losses)
"""


def test_fused_resnet_trains_without_jax_or_protobuf():
    """The card's machine has neither: build the fused-stage ResNet with
    the uint8 front-end and train 2 steps with both made unimportable."""
    proc = subprocess.run([sys.executable, "-c", RESNET_STANDALONE],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout


SP_STANDALONE = """
import sys
for mod in ("jax", "jaxlib", "google.protobuf", "paddle_tpu"):
    sys.modules[mod] = None       # any import of them now fails
import math
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import transformer

main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    loss, _, _ = transformer.get_model(vocab_size=64, seq_len=16, d_model=32,
                                       n_head=2, n_layers=2, d_ff=64,
                                       sp=True)
scope = fluid.Scope()
fluid.Executor(fluid.CPUPlace()).run(startup, scope=scope)
pe = fluid.ParallelExecutor(use_cuda=False, loss_name=loss.name,
                            main_program=main, scope=scope,
                            mesh_axes={"sp": 4})
toks = np.random.RandomState(0).randint(0, 64, (2, 17))
feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
losses = [float(pe.run(fetch_list=[loss], feed=feed)[0][0])
          for _ in range(2)]
assert all(math.isfinite(x) for x in losses), losses
assert losses[1] < losses[0], losses
print("OK", losses)
"""


def test_sp_lm_trains_without_jax_or_protobuf():
    """The sequence-parallel LM on a 4-shard CPU mesh, 2 steps through
    ParallelExecutor, with jax, protobuf and paddle_tpu unimportable."""
    proc = subprocess.run([sys.executable, "-c", SP_STANDALONE],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout


MOE_STANDALONE = """
import sys
for mod in ("jax", "jaxlib", "google.protobuf", "paddle_tpu"):
    sys.modules[mod] = None       # any import of them now fails
import math
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.models import transformer

main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    loss, _, _ = transformer.get_model(vocab_size=64, seq_len=16, d_model=32,
                                       n_head=2, n_layers=2, d_ff=64,
                                       tp=True, moe_experts=2, ep=True)
scope = fluid.Scope()
exe = fluid.Executor(fluid.CPUPlace())
exe.run(startup, scope=scope)
toks = np.random.RandomState(0).randint(0, 64, (2, 17))
feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                        scope=scope)[0][0]) for _ in range(2)]
assert all(math.isfinite(x) for x in losses), losses
assert losses[1] < losses[0], losses
print("OK", losses)
"""


def test_tp_moe_lm_trains_without_jax_or_protobuf():
    """The tp + moe + ep LM, 2 dense steps on a plain CPU Executor, with
    jax, protobuf and paddle_tpu unimportable."""
    proc = subprocess.run([sys.executable, "-c", MOE_STANDALONE],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout


def _save_fc(dirname, aot_batch=None):
    """A little fc model the port saves on the CPU (with its exported
    program for batch ``aot_batch``)."""
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        y = fluid.layers.fc(x, size=3, act="softmax")
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CPUPlace())
    with fluid.scope_guard(scope):
        exe.run(startup)
        fluid.io.save_inference_model(
            dirname, ["x"], [y], exe, main_program=main,
            aot_feed_specs={"x": ((aot_batch, 4), "float32")}
            if aot_batch else None)


def test_predict_tier_defaults_to_the_card(monkeypatch, tmp_path):
    """create_paddle_predictor, InferenceServer.load and ModelEngine run
    on the card unless asked for the CPU: without one they raise, and
    with the CPU asked for they serve."""
    import numpy as np

    from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                            create_paddle_predictor)
    from paddle_tpu_torch.serving import ModelEngine

    d = str(tmp_path / "m")
    _save_fc(d, aot_batch=2)
    _no_cuda(monkeypatch)
    for cfg in (NativeConfig(model_dir=d), AnalysisConfig(d)):
        with pytest.raises(RuntimeError, match="CUDA"):
            create_paddle_predictor(cfg)
    with InferenceServer() as srv:
        with pytest.raises(RuntimeError, match="CUDA"):
            srv.load("m", d)
        assert srv.models() == []
    with pytest.raises(RuntimeError, match="CUDA"):
        ModelEngine(d)
    x = np.ones((2, 4), np.float32)
    pred = create_paddle_predictor(NativeConfig(model_dir=d, use_gpu=False))
    assert pred.aot is not None and pred.run({"x": x})[0].data.shape == (2, 3)
    assert ModelEngine(d, device="cpu", max_batch=2).warm_buckets == [1, 2]
    with InferenceServer(device="cpu", max_batch=2) as srv:
        srv.load("m", d)
        assert srv.predict("m", {"x": x}, timeout=60)


PREDICT_STANDALONE = """
import sys
for mod in ("jax", "jaxlib", "paddle_tpu"):
    sys.modules[mod] = None       # any import of them now fails
import numpy as np
import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.core import lowering
from paddle_tpu_torch.inference import (AnalysisConfig, NativeConfig,
                                        create_paddle_predictor)
from paddle_tpu_torch.serving import InferenceServer, PredictClient

d = sys.argv[1]
main, startup = fluid.Program(), fluid.Program()
with fluid.program_guard(main, startup), fluid.unique_name.guard():
    x = fluid.layers.data(name="x", shape=[4], dtype="float32")
    h = fluid.layers.batch_norm(fluid.layers.fc(x, size=8), is_test=True)
    y = fluid.layers.fc(h, size=3, act="softmax")
scope = fluid.Scope()
exe = fluid.Executor(fluid.CPUPlace())
with fluid.scope_guard(scope):
    exe.run(startup)
    fluid.io.save_inference_model(d, ["x"], [y], exe, main_program=main,
                                  aot_feed_specs={"x": ((2, 4), "float32")})
xs = np.random.RandomState(0).randn(2, 4).astype(np.float32)
pred = create_paddle_predictor(NativeConfig(model_dir=d, use_gpu=False))
n0 = lowering.LOWERINGS
got = pred.run({"x": xs})[0].data
assert pred.aot is not None and lowering.LOWERINGS == n0
ana = create_paddle_predictor(AnalysisConfig(d, use_gpu=False))
assert np.allclose(ana.run({"x": xs})[0].data, got, atol=1e-5)
with InferenceServer(device="cpu", max_batch=2) as srv:
    srv.load("m", d)
    port = srv.start_endpoint()
    with PredictClient("127.0.0.1", port, timeout=60) as cli:
        out = next(iter(cli.predict("m", {"x": xs}).values()))
assert np.array_equal(out, got)
print("OK", got.shape)
"""


def test_predict_tier_runs_without_jax(tmp_path):
    """Save with the exported program, predict (native and analysis) and
    serve over the socket with jax and paddle_tpu unimportable (the
    model file is a protobuf message: protobuf stays)."""
    proc = subprocess.run([sys.executable, "-c", PREDICT_STANDALONE,
                           str(tmp_path / "m")],
                          cwd=REPO, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ, PYTHONPATH=REPO))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.startswith("OK"), proc.stdout
