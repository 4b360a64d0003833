"""The port's bench entry (``python3 -m paddle_tpu_torch.tools.bench``) on
the CPU at tiny dims, in subprocesses: ResNet depth 8 on cifar10, batch
4, 2 iterations, AMP off and on, NCHW and NHWC fused, and the LM with
AMP off and on, the fused-block program under AMP too, each through the
prepared step (``bench.py``'s default), and the ResNet and the LM once
with ``BENCH_PREPARED=0`` (``run()``); the stacked dynamic LSTM at
``bench.py``'s CPU sizes (batch 4, hidden 32, 16 tokens, 3 iterations)
on ragged feeds, prepared; AlexNet and GoogLeNet at ``bench.py``'s CPU
shrink (224 x 224 flowers, batch 4, 2 iterations).  Each run exits 0
and prints one
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
RUNS[("lstm", "0", None)] = {"BENCH_MODEL": "lstm"}
# bench.py's CPU shrink of the legacy models: 224 x 224 flowers, batch
# <= 4, <= 2 iterations
RUNS[("alexnet", "0", None)] = {"BENCH_MODEL": "alexnet"}
RUNS[("googlenet", "0", None)] = {"BENCH_MODEL": "googlenet"}
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
    iters = 3 if model == "lstm" else 2
    assert out["prepared_steps"] == (iters if prepared else 0)
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
    elif model in ("alexnet", "googlenet"):
        assert out["unit"] == "images/sec"
        assert out["metric"] == model + "_flowers_train_bs4"
        baseline = 626.53 if model == "alexnet" else 269.50
        assert out["vs_baseline"] == pytest.approx(out["value"] / baseline)
        assert out["data_format"] == "NCHW" and out["fused_stages"] == 0
        assert len(out["losses"]) == 3
    elif model == "lstm":
        assert out["unit"] == "ms/batch"
        assert out["metric"] == "stacked_lstm_train_bs4_h32_seq16"
        # bench.py's baseline counts at batch 64, hidden 512 only
        assert out["vs_baseline"] == 0.0 and out["examples_per_sec"] > 0
        assert len(out["losses"]) == 4 and out["losses"][-1] < \
            out["losses"][0]
    else:
        assert out["unit"] == "tokens/sec"
        assert out["metric"] == "transformer_lm_d64_L2_train_bs2_seq128" + (
            "_bf16" if amp == "1" else "")
        # the fused-block program: L QKV, 3L + 1 matmul stages, 2L seams
        assert out["fused_stages"] == (2 + 7 + 4 if layout == "fused"
                                       else 0)


# the models a ROADMAP item refused until it was done: they now run
PORTED_SINCE = {"vgg": "vgg_cifar10_train_bs2",
                "resnet32": "resnet32_cifar10_train_bs2"}


@pytest.mark.parametrize("extra,reason", [
    ({"BENCH_MODEL": "vgg"}, "ROADMAP queue 1 items 2 and 3e"),
    ({"BENCH_MODEL": "resnet32"}, "ROADMAP queue 1 item 3e"),
    ({"BENCH_FAKE": "0"}, "no flowers reader")])
def test_bench_refusals_raise(monkeypatch, capsys, extra, reason):
    """A refusal raises with its reason.  ``vgg`` and ``resnet32`` were
    refused until ``reason`` (dropout, the other models) was done: they
    now run on the CPU at batch 2 (VGG16-BN NCHW with its dropout
    layers; the cifar ResNet at depth 32), prepared, and print one JSON
    line with bench.py's metric name."""
    from paddle_tpu_torch.core.flags import FLAGS
    from paddle_tpu_torch.tools import bench

    for k in [k for k in os.environ if k.startswith("BENCH_")]:
        monkeypatch.delenv(k)
    for k, v in dict(extra, BENCH_DEVICE="cpu").items():
        monkeypatch.setenv(k, v)
    model = extra.get("BENCH_MODEL")
    if model not in PORTED_SINCE:
        with pytest.raises(NotImplementedError, match=reason):
            bench.main()
        return
    monkeypatch.setattr(FLAGS, "bn_bf16", FLAGS.bn_bf16)
    monkeypatch.setenv("BENCH_BATCH", "2")
    monkeypatch.setenv("BENCH_ITERS", "2")
    assert bench.main() == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert all(f in out for f in FIELDS), sorted(set(FIELDS) - set(out))
    assert out["metric"] == PORTED_SINCE[model]
    assert out["unit"] == "images/sec" and out["value"] > 0
    assert out["prepared"] is True and out["prepared_steps"] == 2
    assert out["losses_finite"] and out["secondary"] is None
    assert out["data_format"] == "NCHW" and out["param_dtypes"] == \
        ["float32"]
    baseline = 30.44 if model == "vgg" else 81.69
    assert out["vs_baseline"] == pytest.approx(out["value"] / baseline)


def test_a_refusal_exits_non_zero():
    """(``lstm`` ran into a refusal until ragged feeds were ported, and
    ``alexnet`` until lrn was: the reader refusal of ``BENCH_FAKE=0``
    still does.)"""
    p = _start({"BENCH_FAKE": "0"})
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
