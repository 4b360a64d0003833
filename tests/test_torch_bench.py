"""The port's bench entry (``python3 -m paddle_tpu_torch.tools.bench``) on
the CPU at tiny dims, in subprocesses: ResNet depth 8 on cifar10, batch
4, 2 iterations, AMP off and on, NCHW and NHWC fused, and the LM with
AMP off and on, the fused-block program under AMP too, each through the
prepared step (``bench.py``'s default), and the ResNet and the LM once
with ``BENCH_PREPARED=0`` (``run()``).  Each run exits 0 and prints one
parseable JSON last line with ``bench.py``'s fields; each refusal exits
non-zero with its reason.  The LM, the secondary metric
included, takes ``BENCH_AMP`` with ``bench.py``'s default: on on the
card, off on the CPU.
"""
import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 300
FIELDS = ("metric", "value", "unit", "vs_baseline", "tflops", "mfu", "amp",
          "prepared", "step_ms_p50", "step_ms_p90", "step_ms_p99",
          "device", "secondary", "fused_stages", "losses", "param_dtypes")
RESNET = {"BENCH_DEPTH": "8", "BENCH_DATASET": "cifar10",
          "BENCH_BATCH": "4", "BENCH_ITERS": "2"}
RUNS = {("resnet50", amp, layout): dict(RESNET, BENCH_AMP=amp,
                                        BENCH_LAYOUT=layout)
        for amp in ("0", "1") for layout in ("NCHW", "NHWC")}
RUNS[("transformer", "0", None)] = {"BENCH_MODEL": "transformer",
                                    "BENCH_ITERS": "2"}
RUNS[("transformer", "1", None)] = {"BENCH_MODEL": "transformer",
                                    "BENCH_ITERS": "2", "BENCH_AMP": "1"}
RUNS[("transformer", "1", "fused")] = {
    "BENCH_MODEL": "transformer", "BENCH_ITERS": "2", "BENCH_AMP": "1",
    "BENCH_FUSED_TRANSFORMER": "1"}
# run() instead of the prepared step
RUNS[("resnet50", "0", "NCHW", "run")] = dict(RESNET, BENCH_AMP="0",
                                             BENCH_LAYOUT="NCHW",
                                             BENCH_PREPARED="0")
RUNS[("transformer", "0", None, "run")] = {
    "BENCH_MODEL": "transformer", "BENCH_ITERS": "2", "BENCH_PREPARED": "0"}


def _env(extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_DEVICE="cpu", OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + env.get("PYTHONPATH", ""))
    env.update(extra)
    return env


def _start(extra):
    return subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.tools.bench"], cwd=REPO,
        env=_env(extra), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.fixture(scope="module")
def runs():
    """Every run started at once, then waited for: {key: (rc, stdout,
    stderr)}."""
    procs = {key: _start(extra) for key, extra in RUNS.items()}
    out = {}
    try:
        for key, p in procs.items():
            stdout, stderr = p.communicate(timeout=TIMEOUT)
            out[key] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
    return out


def _last_json(stdout):
    return json.loads(stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("key", list(RUNS), ids=lambda k: "-".join(
    str(x) for x in k))
def test_bench_prints_one_json_line(runs, key):
    rc, stdout, stderr = runs[key]
    assert rc == 0, stderr[-2000:]
    out = _last_json(stdout)
    assert all(f in out for f in FIELDS), sorted(set(FIELDS) - set(out))
    model, amp, layout = key[:3]
    prepared = key[3:] != ("run",)
    assert out["amp"] is (amp == "1")
    assert out["prepared"] is prepared and out["device"] == "cpu"
    assert out["prepared_steps"] == (2 if prepared else 0)
    assert out["value"] > 0 and out["secondary"] is None
    # no device metric from a CPU run
    assert out["tflops"] is None and out["mfu"] is None
    assert out["losses_finite"] and out["param_dtypes"] == ["float32"]
    assert out["step_ms_p50"] <= out["step_ms_p90"] <= out["step_ms_p99"]
    if model == "resnet50":
        assert out["unit"] == "images/sec"
        assert out["metric"] == "resnet50_cifar10_train_bs4" + (
            "_bf16" if amp == "1" else "")
        assert out["vs_baseline"] == pytest.approx(out["value"] / 81.69)
        assert out["data_format"] == layout
        assert out["fused_stages"] == (9 if layout == "NHWC" else 0)
        assert out["bn_bf16"] is (amp == "1")
        assert len(out["losses"]) == 3
    else:
        assert out["unit"] == "tokens/sec"
        assert out["metric"] == "transformer_lm_d64_L2_train_bs2_seq128" + (
            "_bf16" if amp == "1" else "")
        # the fused-block program: L QKV, 3L + 1 matmul stages, 2L seams
        assert out["fused_stages"] == (2 + 7 + 4 if layout == "fused"
                                       else 0)


@pytest.mark.parametrize("extra,reason", [
    ({"BENCH_MODEL": "vgg"}, "ROADMAP queue 1 items 2 and 3e"),
    ({"BENCH_MODEL": "resnet32"}, "ROADMAP queue 1 item 3e"),
    ({"BENCH_FAKE": "0"}, "no flowers reader")])
def test_bench_refusals_raise(monkeypatch, extra, reason):
    from paddle_tpu_torch.tools import bench

    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in dict(extra, BENCH_DEVICE="cpu").items():
        monkeypatch.setenv(k, v)
    with pytest.raises(NotImplementedError, match=reason):
        bench.main()


def test_a_refusal_exits_non_zero():
    p = _start({"BENCH_MODEL": "lstm"})
    stdout, stderr = p.communicate(timeout=TIMEOUT)
    assert p.returncode != 0 and stdout.strip() == ""
    assert "NotImplementedError" in stderr and "ROADMAP" in stderr


def test_no_card_and_no_cpu_request_fails():
    """A measurement that finds no card fails; the CPU runs only when
    asked for."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = _start({"BENCH_DEVICE": "cuda"})
    stdout, stderr = p.communicate(timeout=TIMEOUT)
    assert p.returncode != 0 and stdout.strip() == ""
    assert "no CUDA card" in stderr


@pytest.mark.parametrize("env,on_card,want", [
    ({}, True, True), ({}, False, False), ({"BENCH_AMP": "0"}, True, False),
    ({"BENCH_AMP": "1"}, False, True)])
def test_lm_amp_is_bench_py_default(monkeypatch, env, on_card, want):
    """bench.py's ``transformer_bench`` reads BENCH_AMP with the
    accelerator default: bf16 on the card unless BENCH_AMP=0."""
    from paddle_tpu_torch.tools import bench

    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    assert bench.lm_amp(on_card) is want


@pytest.mark.parametrize("amp", ["0", "1"])
def test_secondary_lm_takes_bench_amp(monkeypatch, amp):
    """The secondary metric (the flagship LM after the ResNet headline)
    trains under AMP as BENCH_AMP says, as bench.py's does; the steps
    themselves are stubbed out (the flagship does not fit a CPU test)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.tools import bench

    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    monkeypatch.setenv("BENCH_AMP", amp)
    seen = {}

    def train(fluid_, place, main, startup, loss, feeds, iters):
        seen["amp_bf16"] = bool(main.desc.amp_bf16)
        seen["batch"] = feeds[0][sorted(feeds[0])[0]].shape
        return [2.0, 1.0], [1.0] * iters, ["float32"], iters

    monkeypatch.setattr(bench, "_train", train)
    out = bench.transformer_bench(fluid.CPUPlace(), False, secondary=True)
    assert out["amp"] is (amp == "1") and seen["amp_bf16"] is (amp == "1")
    assert out["metric"] == "transformer_lm_d1024_L6_train_bs16_seq2048" + (
        "_bf16" if amp == "1" else "")
    assert seen["batch"][0] == 16
