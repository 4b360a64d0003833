"""The port's bench entry: ``bench.py``'s headline training benchmark
over ``paddle_tpu_torch``.

    python3 -m paddle_tpu_torch.tools.bench                 # on the card
    BENCH_DEVICE=cpu BENCH_DEPTH=8 BENCH_BATCH=4 BENCH_ITERS=2 \\
        python3 -m paddle_tpu_torch.tools.bench            # CPU smoke

It reads ``bench.py``'s knobs with its accelerator defaults on the card
and its CPU defaults with ``BENCH_DEVICE=cpu`` (the only way to run
without a card):

- ``BENCH_MODEL`` resnet50 (default) | resnet32 | vgg | alexnet |
  googlenet | transformer | lstm (every model ``bench.py`` takes);
- the image models (ResNet, VGG16-BN, AlexNet, GoogLeNet):
  ``BENCH_BATCH`` (256; CPU 16),
  ``BENCH_ITERS`` (60; 5), ``BENCH_DATASET`` (flowers; cifar10: as in
  ``bench.py``, resnet32 is the cifar ResNet and needs cifar10),
  ``BENCH_DEPTH`` (ResNet: 50 or 32 by model),
  ``BENCH_LAYOUT`` (NCHW, or ``FLAGS_conv_layout``),
  ``BENCH_FUSED_STAGES``, ``BENCH_AMP`` (1 on the card; 0),
  ``BENCH_BN_BF16`` (follows AMP); AlexNet and GoogLeNet take 224 x 224
  flowers whatever ``BENCH_DATASET`` says, and on the CPU at most
  batch 4 and 2 iterations, as ``bench.py:522-527``;
- LM: ``BENCH_BATCH`` (16; 2), ``BENCH_SEQ`` (2048; 128),
  ``BENCH_ITERS`` (30; 3), ``BENCH_DMODEL`` (1024; 64),
  ``BENCH_LAYERS`` (6; 2), ``BENCH_HEADS`` (8; 4), ``BENCH_AMP`` (1 on
  the card; 0), ``BENCH_FUSED_TRANSFORMER`` (the fused-block program);
- lstm (the stacked dynamic LSTM, ``bench.py``'s ``lstm_bench``, on
  ragged feeds of ``BENCH_SEQ`` tokens a sequence): ``BENCH_BATCH``
  (64; 4), ``BENCH_HIDDEN`` (512; 32), ``BENCH_SEQ`` (80; 16),
  ``BENCH_ITERS`` (30; 3), ``BENCH_AMP`` (1 on the card; 0); a
  5000-word vocabulary, 3 stacks, Adam 2e-3; ms/batch;
- ``BENCH_SECONDARY`` (1 on the card; 0): after the ResNet-50 headline,
  the flagship LM as ``bench.py``'s secondary metric, at
  ``BENCH_AMP``'s accelerator default as ``bench.py``'s (bf16 on the
  card);
- ``BENCH_PEAK_TFLOPS``: the peak ``mfu`` is taken against (989.4, an
  H100 SXM's dense bf16 rate).

The timed loop is ``bench.py``'s: with ``BENCH_PREPARED`` (default 1)
it trains through ``Executor.prepare`` / ``run_prepared`` (on the card
one CUDA graph replay a step), falling back to ``run()`` for a program
with host ops (``ValueError``) and, after ``sync_scope()``, for a batch
whose shape differs from the prepared one (``PreparedShapeMismatch``);
``BENCH_PREPARED=0`` times ``run()``.  The JSON's ``prepared`` is true
when every timed step was prepared, and ``prepared_steps`` counts them.

Where it departs from ``bench.py`` (each visible in the JSON):

- data is synthetic, drawn from a seed at ``bench.py``'s shapes (uint8
  images for ResNet-50, as in its real-data mode; float32 for the other
  image models, as its fake data), fed from the host each step:
  ``BENCH_FAKE=0`` raises, since the port has no flowers reader and no
  ``DeviceLoader`` (ROADMAP queue 1 item 11).

Each timed step ends with the loss fetch, which waits for the card, so
``step_ms_p50/p90/p99`` are device-honest.  The last line of standard
output is one JSON object: ``metric``, ``value``, ``unit``,
``vs_baseline`` (value / ``bench.py``'s baseline: 81.69 for ResNet,
30.44 for VGG, 626.53 for AlexNet, 269.50 for GoogLeNet; the LSTM's
184 ms / value at batch 64, hidden 512, else 0, with
``examples_per_sec``), ``tflops`` (at 224 x 224: ``bench.py``'s 12.3e9
FLOPs a training image of ResNet-50, 46.5e9 of VGG16; the LM:
``bench.py``'s 6 N_params + 6 L d_model T FLOPs a token; AlexNet,
GoogLeNet and the LSTM: null, as in ``bench.py``) and ``mfu`` (on the
card under AMP only; else null), ``amp``, ``data_format``,
``fused_stages``, ``prepared``, ``prepared_steps``, the step
percentiles, ``device`` (the card's name and power limit from
nvidia-smi, or "cpu"), ``secondary``, and the run's losses and
parameter dtypes.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

import numpy as np

TRAIN_FLOPS_PER_IMG_224 = 12.3e9    # bench.py:54, forward + backward
TRAIN_FLOPS_PER_IMG_VGG16_224 = 46.5e9  # bench.py:55
RESNET50_BASELINE = 81.69           # bench.py:29-31, images/s
VGG_BASELINE = 30.44                # bench.py:770-774, images/s
ALEXNET_BASELINE = 626.53           # bench.py:775-776, images/s
GOOGLENET_BASELINE = 269.50         # bench.py:777-778, images/s
DEFAULT_PEAK_TFLOPS = 989.4         # H100 SXM, dense bf16
SEED = 0
LSTM_BASELINE_MS = 184.0            # bench.py:405-408, ms/batch (K40m)
IMAGE_MODELS = ("resnet50", "resnet32", "vgg", "alexnet", "googlenet")


def _env(name, card, cpu, on_card):
    return os.environ.get(name, card if on_card else cpu)


def _flag(name, default):
    return os.environ.get(name, "1" if default else "0") == "1"


def device_line(on_card):
    """The card's name and power limit, as nvidia-smi reports them, or
    'cpu'."""
    if not on_card:
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))]


def _place():
    """(place, on_card): the card unless BENCH_DEVICE=cpu."""
    import torch

    import paddle_tpu_torch.fluid as fluid

    dev = os.environ.get("BENCH_DEVICE", "cuda")
    if dev == "cpu":
        return fluid.CPUPlace(), False
    if dev != "cuda":
        raise ValueError("BENCH_DEVICE must be cuda or cpu, got %r" % dev)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card (BENCH_DEVICE=cpu runs on the "
                           "CPU)")
    from paddle_tpu_torch import resolve_device

    resolve_device("cuda")          # f32 cuBLAS / cuDNN without TF32
    return fluid.CUDAPlace(0), True


def _train(fluid, place, main, startup, loss, feeds, iters):
    """Startup, 1 warm-up step and ``iters`` timed steps, step ``i`` on
    ``feeds[i % len(feeds)]`` (the warm-up on ``feeds[0]``), through the
    prepared step unless ``BENCH_PREPARED=0`` (``bench.py``'s loop);
    each step ends with the loss fetch.  Returns (losses, step ms,
    parameter dtypes, timed steps that were prepared)."""
    from paddle_tpu_torch.core.executor_impl import PreparedShapeMismatch

    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    prepared = None
    if os.environ.get("BENCH_PREPARED", "1") == "1":
        try:
            prepared = exe.prepare(main, feed_specs=feeds[0],
                                   fetch_list=[loss], scope=scope)
        except ValueError:
            prepared = None     # host ops in the block: run()

    def step(feed):
        nonlocal prepared
        if prepared is not None:
            try:
                return prepared.run_prepared(feed, return_numpy=True), 1
            except PreparedShapeMismatch:
                # a batch of another shape: the state goes back to the
                # scope, and run() takes the rest of the loop
                prepared.sync_scope()
                prepared = None
        return exe.run(main, feed=feed, fetch_list=[loss], scope=scope), 0

    losses = [float(step(feeds[0])[0][0].ravel()[0])]
    step_ms, prepared_steps = [], 0
    for i in range(iters):
        t0 = time.perf_counter()
        out, was_prepared = step(feeds[i % len(feeds)])
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(out[0].ravel()[0]))
        prepared_steps += was_prepared
    if prepared is not None:
        prepared.sync_scope()
    dtypes = sorted({str(scope.find_var(p.name).dtype).replace(
        "torch.", "") for p in main.all_parameters()})
    return losses, step_ms, dtypes, prepared_steps


def _common(losses, step_ms, dtypes, prepared_steps, amp, on_card):
    return {"amp": amp, "prepared": prepared_steps == len(step_ms),
            "prepared_steps": prepared_steps, "fake_data": True,
            "step_ms_p50": _pct(step_ms, 0.5),
            "step_ms_p90": _pct(step_ms, 0.9),
            "step_ms_p99": _pct(step_ms, 0.99),
            "step_ms": step_ms, "losses": losses,
            "losses_finite": all(math.isfinite(x) for x in losses),
            "param_dtypes": dtypes, "device": device_line(on_card)}


def lm_amp(on_card):
    """Whether the LM trains under bf16 AMP: ``BENCH_AMP``, by default on
    the card and off on the CPU (``bench.py``'s ``transformer_bench``,
    its secondary included)."""
    return _flag("BENCH_AMP", on_card)


def _peak_tflops():
    return float(os.environ.get("BENCH_PEAK_TFLOPS", DEFAULT_PEAK_TFLOPS))


def transformer_bench(place, on_card, secondary=False):
    """The transformer LM, bench.py's ``transformer_bench``: tokens/s."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.flags import FLAGS
    from paddle_tpu_torch.models import transformer

    if secondary:
        bs, seq, iters, d_model, n_layers, n_head = 16, 2048, 10, 1024, 6, 8
    else:
        bs = int(_env("BENCH_BATCH", "16", "2", on_card))
        seq = int(_env("BENCH_SEQ", "2048", "128", on_card))
        iters = int(_env("BENCH_ITERS", "30", "3", on_card))
        d_model = int(_env("BENCH_DMODEL", "1024", "64", on_card))
        n_layers = int(_env("BENCH_LAYERS", "6", "2", on_card))
        n_head = int(_env("BENCH_HEADS", "8", "4", on_card))
    amp = lm_amp(on_card)
    if os.environ.get("BENCH_FUSED_TRANSFORMER") is not None:
        FLAGS.transformer_fuse = os.environ["BENCH_FUSED_TRANSFORMER"] == "1"
    vocab = 8192
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, (src, label), _ = transformer.get_model(
            vocab_size=vocab, seq_len=seq, d_model=d_model, n_head=n_head,
            n_layers=n_layers, d_ff=4 * d_model)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    rng = np.random.RandomState(SEED)
    feed = {src.name: rng.randint(0, vocab, (bs, seq)).astype(np.int64),
            label.name: rng.randint(0, vocab, (bs, seq, 1)).astype(np.int64)}
    losses, step_ms, dtypes, prepared = _train(fluid, place, main, startup,
                                               loss, [feed], iters)
    fused = [op.type for op in main.desc.blocks[0].ops
             if op.type.startswith("fused_") and not op.type.endswith("_grad")]
    counts = {t: fused.count(t) for t in sorted(set(fused))}
    tokens_per_s = bs * seq * iters / (sum(step_ms) / 1e3)
    out = {"metric": "transformer_lm_d%d_L%d_train_bs%d_seq%d%s" % (
               d_model, n_layers, bs, seq, "_bf16" if amp else ""),
           "value": tokens_per_s, "unit": "tokens/sec",
           "vs_baseline": 0.0,      # bench.py has no LM baseline
           **_common(losses, step_ms, dtypes, prepared, amp, on_card),
           "fused_stages": len(fused), "fused_stage_counts": counts,
           "tflops": None, "mfu": None}
    if on_card:
        # bench.py's count: 6 N_params a token plus causal attention
        n_params = sum(int(np.prod(p.shape))
                       for p in main.global_block().all_parameters())
        flops_tok = 6.0 * n_params + 6.0 * n_layers * d_model * seq
        out["params_m"] = n_params / 1e6
        out["tflops"] = tokens_per_s * flops_tok / 1e12
        if amp:     # against the bf16 peak the run targets
            out["mfu"] = out["tflops"] / _peak_tflops()
            out["peak_tflops"] = _peak_tflops()
    return out


def resnet_bench(place, on_card, model="resnet50"):
    """An image model, bench.py's headline loop: ResNet-50 (the
    headline), resnet32, VGG16-BN (``vgg``), AlexNet or GoogLeNet (the
    last three NCHW, as bench.py runs them); images/s."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.flags import FLAGS
    from paddle_tpu_torch.models import alexnet, googlenet, resnet, vgg

    batch = int(_env("BENCH_BATCH", "256", "16", on_card))
    iters = int(_env("BENCH_ITERS", "60", "5", on_card))
    data_set = _env("BENCH_DATASET", "flowers", "cifar10", on_card)
    legacy = model in ("alexnet", "googlenet")
    if legacy:
        # bench.py:522-527: 224 x 224 only (GoogLeNet's final 7 x 7
        # pool needs it); the CPU shrinks the batch and the iterations
        data_set = "flowers"
        if not on_card:
            batch, iters = min(batch, 4), min(iters, 2)
    amp = _flag("BENCH_AMP", on_card)
    FLAGS.bn_bf16 = _flag("BENCH_BN_BF16", amp)
    data_format = os.environ.get("BENCH_LAYOUT",
                                 FLAGS.conv_layout or "NCHW").upper()
    if os.environ.get("BENCH_FUSED_STAGES") is not None:
        FLAGS.conv_fused_stages = os.environ["BENCH_FUSED_STAGES"] == "1"
    depth = int(os.environ.get("BENCH_DEPTH", "0"))
    uint8 = model == "resnet50"     # bench.py's real-data input
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == "vgg":
            loss, (data, label), _ = vgg.get_model(data_set=data_set)
        elif legacy:
            mod = alexnet if model == "alexnet" else googlenet
            loss, (data, label), _ = mod.get_model()
        else:
            loss, (data, label), _ = resnet.get_model(
                data_set=data_set,
                depth=depth or (50 if model == "resnet50" else 32),
                input_dtype="uint8" if uint8 else "float32",
                data_format=data_format)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    rng = np.random.RandomState(SEED)
    classes = 10 if data_set == "cifar10" else \
        102 if data_set == "flowers" else 1000
    shape = [batch] + list(data.shape[1:])
    feed = {data.name: rng.randint(0, 256, shape).astype(np.uint8)
            if uint8 else rng.rand(*shape).astype(np.float32),
            label.name: rng.randint(0, classes, (batch, 1)).astype(np.int64)}
    losses, step_ms, dtypes, prepared = _train(fluid, place, main, startup,
                                               loss, [feed], iters)
    images_per_s = batch * iters / (sum(step_ms) / 1e3)
    ops = main.desc.blocks[0].ops
    baseline = {"vgg": VGG_BASELINE, "alexnet": ALEXNET_BASELINE,
                "googlenet": GOOGLENET_BASELINE}.get(model,
                                                     RESNET50_BASELINE)
    out = {"metric": "%s_%s_train_bs%d%s" % (
               model, data_set, batch, "_bf16" if amp else ""),
           "value": images_per_s, "unit": "images/sec",
           "vs_baseline": images_per_s / baseline,
           **_common(losses, step_ms, dtypes, prepared, amp, on_card),
           "bn_bf16": bool(FLAGS.bn_bf16),
           "data_format": "NHWC" if any(
               op.attr("data_format", op.attr("data_layout", "NCHW"))
               == "NHWC" for op in ops) else "NCHW",
           "fused_stages": sum(op.type == "fused_conv2d_bn_act"
                               for op in ops),
           "tflops": None, "mfu": None}
    if depth and model in ("resnet50", "resnet32"):
        out["depth"] = depth
    per_img = {"resnet50": TRAIN_FLOPS_PER_IMG_224,
               "vgg": TRAIN_FLOPS_PER_IMG_VGG16_224}.get(model)
    if on_card and data_set in ("flowers", "imagenet") and per_img and \
            (model == "vgg" or depth in (0, 50)):
        out["tflops"] = images_per_s * per_img / 1e12
        if amp:     # against the bf16 peak the run targets
            out["mfu"] = out["tflops"] / _peak_tflops()
            out["peak_tflops"] = _peak_tflops()
    return out


def lstm_bench(place, on_card):
    """The stacked dynamic LSTM, bench.py's ``lstm_bench``: a batch of
    ``BENCH_BATCH`` ragged sequences of ``BENCH_SEQ`` seeded tokens (one
    bucket), trained through the prepared step; ms/batch."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import stacked_dynamic_lstm

    bs = int(_env("BENCH_BATCH", "64", "4", on_card))
    hidden = int(_env("BENCH_HIDDEN", "512", "32", on_card))
    seq = int(_env("BENCH_SEQ", "80", "16", on_card))
    iters = int(_env("BENCH_ITERS", "30", "3", on_card))
    amp = _flag("BENCH_AMP", on_card)
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, (words, label), _ = stacked_dynamic_lstm.get_model(
            dict_dim=5000, hidden_dim=hidden)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    rng = np.random.RandomState(SEED)
    feeder = fluid.DataFeeder([words, label], program=main)
    feed = feeder.feed([(rng.randint(0, 5000, seq).tolist(),
                         [int(rng.randint(2))]) for _ in range(bs)])
    losses, step_ms, dtypes, prepared = _train(fluid, place, main, startup,
                                               loss, [feed], iters)
    ms = sum(step_ms) / len(step_ms)
    return {"metric": "stacked_lstm_train_bs%d_h%d_seq%d%s" % (
                bs, hidden, seq, "_bf16" if amp else ""),
            "value": ms, "unit": "ms/batch",
            # indicative, as in bench.py: its baseline is a 2-layer
            # stack on a K40m, and it counts only at its bs / hidden
            "vs_baseline": LSTM_BASELINE_MS / ms
            if (bs, hidden) == (64, 512) else 0.0,
            "examples_per_sec": bs * iters / (sum(step_ms) / 1e3),
            **_common(losses, step_ms, dtypes, prepared, amp, on_card),
            "fused_stages": 0, "tflops": None, "mfu": None}


def main():
    model = os.environ.get("BENCH_MODEL", "resnet50")
    if model not in IMAGE_MODELS + ("transformer", "lstm"):
        raise SystemExit("BENCH_MODEL must be resnet50|resnet32|vgg|"
                         "alexnet|googlenet|transformer|lstm, got %r"
                         % model)
    if os.environ.get("BENCH_FAKE", "1") != "1":
        raise NotImplementedError(
            "BENCH_FAKE=0: the port has no flowers reader and no "
            "DeviceLoader (ROADMAP queue 1 item 11), and nothing may be "
            "downloaded; the bench runs on seeded synthetic data")
    place, on_card = _place()
    if model == "transformer":
        out = dict(transformer_bench(place, on_card), secondary=None)
    elif model == "lstm":
        out = dict(lstm_bench(place, on_card), secondary=None)
    else:
        out = resnet_bench(place, on_card, model)
        # as bench.py: the secondary follows the ResNet-50 headline only
        out["secondary"] = transformer_bench(place, on_card, secondary=True) \
            if _flag("BENCH_SECONDARY", on_card) and model == "resnet50" \
            else None
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
