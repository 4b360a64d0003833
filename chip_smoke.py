#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  — nvidia-smi name and power limit, torch and CUDA versions;
2. build   — nvcc build of every kernel under paddle_tpu_torch/kernels/csrc;
3. kernels — each kernel against its plain PyTorch version on the card,
             at the serving and training paths' shapes, with times (CUDA
             events, median of 25, L2 flushed before each launch) beside
             the plain version, a PyTorch library yardstick and the
             card's bound (the f32 matrix-product kernels K1-K4, K6 and
             K9 against split-TF32 tensor-core products, K8 against the
             two-MMA split its exact int8 weights allow, the rest
             against f32 FMAs; ``ops_rate`` says which); K4 also at
             every epilogue variant on ragged shapes; each K4, K6 and
             K8 row's ``form`` names the form it ran;
4. serve_f32  — the flagship LM (vocab 8192, d_model 1024, 8 heads,
             6 layers, d_ff 4096, max_seq 2048) served through
             InferenceServer.load_generative/generate, some requests
             arriving mid-decode; tokens and final logits checked
             against dense_forward (no paging, no kernels);
5. serve_int8 — the same with quant='int8';
6. batch_invariance — one prompt solo vs inside a batch of 16
             (information, not a gate);
7. train_f32 — the same LM as a fluid Program (models/transformer
             get_model: Adam lr 1e-3, sequence 2048, batch 16) built by
             paddle_tpu_torch.fluid and run by Executor(CUDAPlace(0)):
             the startup program, then 1 warm-up and 5 timed steps on
             one fixed batch; every loss finite, the last below the
             first, K1/K2/K3 launched 6 times a step each;
8. train_oracle — one step at full width, depth 1, batch 1 on the card
             against the same program on Executor(CPUPlace()) (the
             plain versions) from the same parameters: loss and every
             parameter gradient;
9. train_fused — phase 7 for the fused-block program
             (get_model(fuse_transformer=True), FLAGS_transformer_fuse):
             K1/K2/K3 6 times a step each, the fused matmul epilogue K4
             25 times (6 QKV + 6 x 3 + lm_head), add + LayerNorm K5 12
             times (2 a layer);
10. train_fused_oracle — phase 8 for the fused-block program;
11. infer_resnet_fused — ResNet-50 (models/resnet get_model: flowers,
             224 x 224, 102 classes, uint8 images cast and scaled on the
             card) as the is_test NHWC fused-stage program
             (FLAGS_conv_layout=NHWC): one forward at batch 256 launches
             the conv-stage kernel K6 53 times with its full epilogue
             (BN affine, residual, relu); its softmax is held against
             the NCHW is_test program's on the card from the same
             parameters, whose BN running statistics are the batch's own;
12. train_resnet — the NCHW training program (Momentum 0.9, lr 0.01)
             through Executor(CUDAPlace(0)): startup, 1 warm-up and 5
             timed steps on one fixed uint8 batch of 256; every loss
             finite, the last below the first, no K6 launch;
13. train_resnet_fused — phase 12 for the NHWC fused-stage program: K6
             53 times a step, in its statistics form;
14. train_resnet_fused_oracle — one step of the fused program at depth
             50, batch 2, on the card against Executor(CPUPlace()) from
             the same parameters: loss and every parameter gradient,
             the gradients (worst and median) to twice the CPU's own
             spread when one ulp is added to every filter, that spread
             itself at most 5 %;
15. train_sp — phase 7's LM as the sequence-parallel program
             (get_model(sp=True)) through ExecutorCore on the mesh
             make_mesh({"sp": 4}, [cuda:0] * 4), the 4 ring shards laid
             on the one card: every ring_attention runs the ring, K9 60
             times a step (6 layers x 10 live folds), K2 and K3 60
             times, K1 never; the dense program's loss from the same
             parameters and batch beside it, for information;
16. train_sp_oracle — one sp step at full width, depth 1, batch 1 on
             the card against the same step on a 4-shard CPU mesh
             (ExecutorCore(CPUPlace(), mesh=[cpu] * 4)) and against the
             dense program's step on the card, from the same parameters,
             at phase 8's bars.

Phase 3 holds K8 against its plain version at the flagship layer's
four projections at every decode bucket M = 1..16 (the decode kernel,
``form`` "decode") and at the prefill buckets M = 1024 and 2048 (the
split-TF32 GEMM tile of csrc/gemm_tile.cuh: "tile 128x64" where its
blocks give every SM one, else "tile 64x64"), and checks that prefill
rows are batch-invariant (64-row calls give the M = 1024 call's rows
bit for bit); K4 at the fused step's five projections at M = 16 x 2048
(all "tile 128x64"); K6 (an implicit GEMM on the same tile, all "tile
128x64") against its plain version at each of the path's 20 conv shapes at batch 256 (statistics form; the five heaviest
also with affine + residual + relu) and at every epilogue combination
on ragged shapes and at the path's widths (K = 4608, a Co = 64 3x3
stage at 56 x 56, the stem at 224 x 224); K9 at the ring's shard
[16, 8, 512, 128] (the diagonal causal fold, a non-causal fold from a
carry seeded by an earlier one, a half-masked and a wholly masked
block, the last bit-identical to its carry); K2/K3 at that shape,
non-causal and the causal diagonal; K10, which no path runs, at the
LM's logits [32768, 8192].  K7 (each row's live pages in spans of
``paged_span_pages()`` pages, streamed through a cp.async ring, the spans
folded in order by a second launch) at the decode batch B = 16, NB =
128 over a 512-page pool with mixed lengths (its bytes bound counts a
page that two rows share once), whose rows must be bit for
bit the same computed alone in their own block-count bucket (a gate,
``rows_invariant``), and on distinct pages (a pool of B x NB + 1) at
B = 1 with 2048 tokens, B = 16 with 1024 each, B = 4 at NB = 64 with
16-1024 and B = 16 at NB = 8 with at most 128 (one span a row).

Then the kernels' summary line, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  Any failed phase exits non-zero
without that line; so does a run without CUDA or outside the repository.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time
import traceback

# kernel vs plain tolerance: both sides accumulate in float32 in a
# different order; |err| <= ATOL + RTOL * |plain|
ATOL = RTOL = 1e-4
# end-to-end logits after 6 layers of float32 math whose sums run in a
# different order (kernels vs dense plain attention, tiles vs cuBLAS)
LOGIT_TOL = 1e-3
# card vs CPU training step (train_oracle), the same f32 math summed in
# another order through one transformer layer: loss to ORACLE_LOSS_RTOL
# relative; each gradient to ORACLE_GRAD_RTOL in relative Frobenius
# norm, ||card - cpu|| / ||cpu||.  Not elementwise: a pre-activation
# within rounding of 0 takes relu's other branch on one side (counted as
# relu_flips), which moves single gradient elements by a whole term of
# their sum (percents of the largest |value|) and the tensor's norm by
# about 1/sqrt(tokens * d_ff / 2) ~ 5e-4 per flip
ORACLE_LOSS_RTOL = 1e-5
ORACLE_GRAD_RTOL = 1e-2
# K6's per-channel sums over N*Ho*Wo pixels are sums of values near 0:
# each is held to conv_fused.STATS_RTOL (1e-6) of the sum of its terms'
# magnitudes, against a float64 sum of K6's own raw conv output, which
# the output check holds to the plain version (conv_fused.stats_error)
# the ResNet card-vs-CPU step (train_resnet_fused_oracle): 53 conv
# stages of f32 sums in another order (K6 vs the CPU's conv), each
# renormalized by its BN; loss to 1e-4 relative.  At depth 50 the
# step's gradients are chaotic at f32 resolution: on the CPU alone, one
# ulp added to every filter flips relu outputs and moves the gradients
# by percents in relative Frobenius norm.  So the CPU runs twice, from
# the parameters and from that one-ulp step, and every card gradient is
# held to RESNET_ORACLE_SPREAD times the CPU's own worst spread (never
# below ORACLE_GRAD_RTOL), and the median gradient to that multiple of
# the CPU's median spread: a wrong grad is off by O(1), f32 reordering
# by the spread.  A spread above RESNET_ORACLE_SPREAD_MAX fails the
# phase, so no unstable step can raise the bar without limit (the
# readings: 3.2 % worst, 2.3 % median)
RESNET_ORACLE_LOSS_RTOL = 1e-4
RESNET_ORACLE_SPREAD = 2.0
RESNET_ORACLE_SPREAD_MAX = 0.05
# infer_resnet_fused: the fused program's softmax probabilities against
# the NCHW program's on the card (K6 vs cuDNN, 53 f32 conv stages)
INFER_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
F32_FLOPS = 67e12              # H100 SXM float32, non-tensor-core peak
# float32-accurate products on the tensor cores: split-TF32 spends three
# TF32 MMAs (hi*hi, hi*lo, lo*hi) on each, at 494.7 TFLOP/s dense TF32
SPLIT_TF32_FLOPS = 494.7e12 / 3
# the f32 matrix-product kernels, bound by SPLIT_TF32_FLOPS (the least
# time the card takes for float32-accurate products, whether or not the
# kernel uses the tensor cores yet); the others by F32_FLOPS
PRODUCT_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv",
                   "matmul_epilogue", "conv_stage", "flash_chunk")
# K8's int8 weights are exact in TF32 (8 bits fit its 10-bit mantissa),
# so only the f32 activations split: two MMAs (hi*w, lo*w) a product
INT8W_SPLIT_TF32_FLOPS = 494.7e12 / 2
SEED = 0


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


class Timer:
    """Median CUDA-event device time of single calls, the L2 cache
    flushed before each one, as a serving step finds it.  The flush
    READS a 64 MiB buffer: a write would leave dirty lines whose
    write-back lands inside the next timed call.  A spin kernel then
    keeps the card busy while the host enqueues the call, so the host's
    launch overhead is not counted as device time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.ones(16 << 20, dtype=torch.float32,
                                device="cuda")

    def __call__(self, fn, iters=25, warmup=3):
        torch = self.torch
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.sum()
            torch.cuda._sleep(2_000_000)      # ~1 ms of spinning
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def conv_min_flops(n, shp):
    """The fewest operations a known algorithm needs for one conv shape,
    counted for its bound.  3x3 stride 1: Winograd F(4x4, 3x3) (Lavin and
    Gray, "Fast Algorithms for Convolutional Neural Networks", 2016)
    multiplies 36 transformed terms per 4x4 output tile and (Ci, Co)
    pair where the direct conv does 16 * 9, so a quarter of the direct
    count, its transforms and partial edge tiles left out so the bound
    stays below what that algorithm can do.  Else (1x1, the strided 7x7
    stem) the direct count."""
    h, ci, co, k, s, p = shp
    if k == 3 and s == 1:
        return conv_flops(n, shp) // 4
    return conv_flops(n, shp)


def bound_ms(nbytes, flops, rate):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / rate * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def ops_rate(name):
    """(name, FLOP/s) of the peak a kernel's operations are held to."""
    if name in PRODUCT_KERNELS:
        return "split-tf32", SPLIT_TF32_FLOPS
    if name == "matmul_int8":
        return "split-tf32-int8w", INT8W_SPLIT_TF32_FLOPS
    return "f32", F32_FLOPS


def compare(torch, got, want):
    err = (got.double() - want.double()).abs()
    ok = bool((err <= ATOL + RTOL * want.double().abs()).all())
    return float(err.max()), ok


# ---------------------------------------------------------------------------
# phase 3: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_kernels(torch, timer):
    import numpy as np
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.flash_attention import (
        attention_reference, flash_attention_bwd,
        flash_attention_bwd_reference, flash_attention_fwd_lse,
        flash_bwd_dkv, flash_bwd_dq)
    from paddle_tpu_torch.kernels.fused import (
        fused_softmax_cross_entropy, softmax_ce_reference)
    from paddle_tpu_torch.kernels.conv_fused import (
        conv2d_nhwc, conv2d_nhwc_reference, conv_stage_tile)
    from paddle_tpu_torch.kernels.matmul_fused import (
        add_ln, add_ln_reference, dequantize_weight, matmul_epilogue,
        matmul_epilogue_reference, matmul_int8_dequant,
        matmul_int8_reference, quantize_weight, tile_form)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    rows, bad = [], []

    def record(name, shape, err, ok, ms, plain_ms, lib_ms, nbytes, flops):
        rate_name, rate = ops_rate(name)
        b_ms, by = bound_ms(nbytes, flops, rate)
        rows.append({"kernel": name, "shape": shape, "max_abs_err": err,
                     "ok": ok, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": by, "ops_rate": rate_name})
        if not ok:
            bad.append("%s %s (max abs err %g)" % (name, shape, err))
        return rows[-1]

    # K1: causal prefill attention [1, 8, S, 128] and the training
    # step's [16, 8, 2048, 128]
    h, d = 8, 128
    scale = 1.0 / math.sqrt(d)
    for b_, s in ((1, 16), (1, 256), (1, 2048), (16, 2048)):
        q, k, v = (torch.randn(b_, h, s, d, device=dev, generator=gen)
                   for _ in range(3))
        out, lse = flash_attention_fwd_lse(q, k, v, causal=True)
        ref_out, ref_lse = attention_reference(q, k, v, scale, True)
        e1, ok1 = compare(torch, out, ref_out)
        e2, ok2 = compare(torch, lse, ref_lse)
        del out, lse, ref_out, ref_lse
        record("flash_fwd", "[%d,8,%d,128] causal" % (b_, s), max(e1, e2),
               ok1 and ok2,
               timer(lambda: flash_attention_fwd_lse(q, k, v, causal=True)),
               timer(lambda: attention_reference(q, k, v, scale, True)),
               timer(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)),
               4 * b_ * (4 * h * s * d + h * s),
               4 * b_ * h * d * s * (s + 1) // 2)
        del q, k, v

    # K2/K3: flash backward from the saved lse at the training step's
    # shape [16, 8, 2048, 128] and a short one; the yardstick is the
    # backward of F.scaled_dot_product_attention from a saved forward
    for b_, s in ((1, 256), (16, 2048)):
        q, k, v, do = (torch.randn(b_, h, s, d, device=dev, generator=gen)
                       for _ in range(4))
        out, lse = attention_reference(q, k, v, scale, True)
        delta = (do * out).sum(-1)
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, scale,
                                             True)
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
        errs = [compare(torch, a, w) for a, w in zip(got, want)]
        plain_ms = timer(lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, do, scale, True), iters=5)
        del got, want
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_ms = timer(lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do, retain_graph=True))
        del o_lib, qg, kg, vg
        shape = "[%d,8,%d,128] causal" % (b_, s)
        tile = b_ * h * d * s * (s + 1) // 2 * 2     # one causal product
        io = 4 * b_ * h * s * d
        record("flash_bwd_dq", shape, errs[0][0], errs[0][1],
               timer(lambda: flash_bwd_dq(q, k, v, do, lse, delta, scale,
                                          True)),
               plain_ms, lib_ms, 5 * io + 8 * b_ * h * s, 3 * tile)
        record("flash_bwd_dkv", shape, max(errs[1][0], errs[2][0]),
               errs[1][1] and errs[2][1],
               timer(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, scale,
                                           True)),
               plain_ms, lib_ms, 6 * io + 8 * b_ * h * s, 4 * tile)
        del q, k, v, do, out, lse, delta
    torch.cuda.empty_cache()

    check_ring_kernels(torch, timer, gen, record, bad)

    # K10: the LM's logits [16 * 2048, 8192] (no path runs it); the
    # yardstick is F.cross_entropy(reduction="none")
    n, c = TRAIN_BATCH * TRAIN_LM["seq_len"], TRAIN_LM["vocab_size"]
    logits = torch.randn(n, c, device=dev, generator=gen) * 3
    labels = torch.randint(0, c, (n,), device=dev, generator=gen)
    err, ok = compare(torch, fused_softmax_cross_entropy(logits, labels),
                      softmax_ce_reference(logits, labels))
    record("fused_ce", "[%d,%d]" % (n, c), err, ok,
           timer(lambda: fused_softmax_cross_entropy(logits, labels)),
           timer(lambda: softmax_ce_reference(logits, labels)),
           timer(lambda: F.cross_entropy(logits, labels, reduction="none")),
           4 * n * c + 8 * n + 4 * n, 4 * n * c)
    del logits, labels
    torch.cuda.empty_cache()

    # K7: paged decode; K8 below draws from the same rng after it
    rng = np.random.RandomState(SEED)
    check_paged(torch, timer, gen, rng, record, bad)

    # K8: int8-weight projections of the flagship layer, at every decode
    # batch bucket (M = 1..16, each its own instantiation), at the largest
    # prefill bucket the serve phase pads to (M = 1024) and at M = 2048
    for kk, n in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)):
        w = (rng.randn(kk, n) * 0.1).astype(np.float32)
        qn, sn, chunk = quantize_weight(w)
        wq = torch.from_numpy(qn).to(dev)
        sc = torch.from_numpy(sn).to(dev)
        wd = dequantize_weight(wq, sc, chunk)
        for m in (1, 2, 4, 8, 16, 1024, 2048):
            x = torch.randn(m, kk, device=dev, generator=gen)
            out = matmul_int8_dequant(x, wq, sc, chunk)
            err, ok = compare(torch, out,
                              matmul_int8_reference(x, wq, sc, chunk))
            record("matmul_int8", "M=%d K=%d N=%d" % (m, kk, n), err, ok,
                   timer(lambda: matmul_int8_dequant(x, wq, sc, chunk)),
                   timer(lambda: matmul_int8_reference(x, wq, sc, chunk)),
                   timer(lambda: torch.matmul(x, wd)),
                   4 * m * kk + kk * n + 4 * (kk // chunk) * n + 4 * m * n,
                   2 * m * kk * n)
            rows[-1]["form"] = tile_form("matmul_int8", m, n)
            if m == 1024:
                # prefill rows are batch-invariant: 64-row calls (the
                # Small form) give the M = 1024 call's rows bit for bit
                inv = all(torch.equal(
                    matmul_int8_dequant(x[r0:r0 + 64].contiguous(), wq, sc,
                                        chunk), out[r0:r0 + 64])
                    for r0 in (0, 512, 960))
                rows[-1]["prefill_rows_invariant"] = inv
                if not inv:
                    bad.append("matmul_int8 K=%d N=%d: rows of M=64 calls "
                               "differ from the M=1024 call's" % (kk, n))
    # the epilogue the engine does not use: bias, tanh-gelu, residual
    x = torch.randn(16, kk, device=dev, generator=gen)
    bias = torch.randn(n, device=dev, generator=gen)
    res = torch.randn(16, n, device=dev, generator=gen)
    err, ok = compare(
        torch, matmul_int8_dequant(x, wq, sc, chunk, bias, res, "gelu"),
        matmul_int8_reference(x, wq, sc, chunk, bias, res, "gelu"))
    if not ok:
        bad.append("matmul_int8 epilogue (max abs err %g)" % err)
    del x, bias, res, wq, sc, wd
    torch.cuda.empty_cache()

    # K4: the fused training step's five projections at M = 16 * 2048
    # tokens, each with its epilogue; the yardstick is torch.addmm
    # (torch.matmul for the bias-free QKV; fc1's relu not included)
    m = TRAIN_BATCH * TRAIN_LM["seq_len"]
    for what, kk, n, with_bias, act in FUSED_MATMULS:
        x = torch.randn(m, kk, device=dev, generator=gen)
        w = torch.randn(kk, n, device=dev, generator=gen) * kk ** -0.5
        bias = torch.randn(n, device=dev, generator=gen) if with_bias \
            else None
        err, ok = compare(torch, matmul_epilogue(x, w, bias, None, act),
                          matmul_epilogue_reference(x, w, bias, None,
                                                    act)[0])
        record("matmul_epilogue", "%s M=%d K=%d N=%d" % (what, m, kk, n),
               err, ok,
               timer(lambda: matmul_epilogue(x, w, bias, None, act)),
               timer(lambda: matmul_epilogue_reference(x, w, bias, None,
                                                       act)),
               timer(lambda: torch.addmm(bias, x, w) if with_bias
                     else torch.matmul(x, w)),
               4 * (m * kk + kk * n + m * n + (n if with_bias else 0)),
               2 * m * kk * n)
        rows[-1]["form"] = tile_form("matmul_epilogue", m, n)
        del x, w, bias
    # every epilogue (act x bias x residual x pre) on ragged M and N,
    # float4 (N % 4 == 0) and scalar (N % 4 != 0) instantiations
    for m_, kk, n in ((1000, 1024, 1000), (333, 256, 1001)):
        x = torch.randn(m_, kk, device=dev, generator=gen)
        w = torch.randn(kk, n, device=dev, generator=gen) * kk ** -0.5
        bias = torch.randn(n, device=dev, generator=gen)
        res = torch.randn(m_, n, device=dev, generator=gen)
        for act in ("", "relu", "gelu"):
            for b_, r_ in ((None, None), (bias, None), (bias, res),
                           (None, res)):
                out, pre = matmul_epilogue(x, w, b_, r_, act,
                                           save_preact=True)
                want, want_pre = matmul_epilogue_reference(x, w, b_, r_,
                                                           act)
                for got_, want_, part in ((out, want, "out"),
                                          (pre, want_pre, "pre")):
                    err, ok = compare(torch, got_, want_)
                    if not ok:
                        bad.append("matmul_epilogue M=%d K=%d N=%d act=%r "
                                   "bias=%s residual=%s %s (max abs err "
                                   "%g)" % (m_, kk, n, act, b_ is not None,
                                            r_ is not None, part, err))

    # K5: the fused step's residual add + LayerNorm, [16 * 2048, 1024]
    # with scale and bias; the yardstick is two calls, x + y then
    # F.layer_norm
    d = TRAIN_LM["d_model"]
    x, y = (torch.randn(m, d, device=dev, generator=gen) for _ in range(2))
    scale = torch.rand(d, device=dev, generator=gen) + 0.5
    bias = torch.randn(d, device=dev, generator=gen)
    errs = [compare(torch, a, b_) for a, b_ in
            zip(add_ln(x, y, scale, bias),
                add_ln_reference(x, y, scale, bias))]
    record("add_ln", "[%d,%d] affine" % (m, d), max(e for e, _ in errs),
           all(ok for _, ok in errs),
           timer(lambda: add_ln(x, y, scale, bias)),
           timer(lambda: add_ln_reference(x, y, scale, bias)),
           timer(lambda: F.layer_norm(x + y, (d,), scale, bias)),
           4 * (4 * m * d + 2 * d + 2 * m), 8 * m * d)
    del x, y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()

    # K6: every conv stage of the ResNet-50 forward at batch 256, in the
    # training form (raw conv + per-channel sums); the five heaviest
    # (launches x FLOPs) also in the inference form (BN affine +
    # residual + relu).  The yardstick is F.conv2d on channels_last
    # tensors (cuDNN, TF32 off) plus the same epilogue in torch; the
    # bound counts the operations of conv_min_flops.
    nb = RESNET_BATCH
    shapes = conv_stage_shapes()
    heavy = sorted(shapes, key=lambda c: -shapes[c] * conv_flops(nb, c))[:5]
    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    fwd_err = 0.0
    for shp in sorted(shapes, key=lambda c: -shapes[c] * conv_flops(nb, c)):
        h, ci, co, k, s, p = shp
        ho = (h + 2 * p - k) // s + 1
        x = torch.randn(nb, h, h, ci, device=dev, generator=gen)
        w = torch.randn(k, k, ci, co, device=dev, generator=gen) * \
            (k * k * ci) ** -0.5
        xcl = x.permute(0, 3, 1, 2)                  # channels_last
        wcl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        a = torch.rand(co, device=dev, generator=gen) + 0.5
        b = torch.randn(co, device=dev, generator=gen)
        r = torch.randn(nb, ho, ho, co, device=dev, generator=gen)
        rcl = r.permute(0, 3, 1, 2)
        modes = [("stats", dict(stats=True))]
        if shp in heavy:
            modes.append(("affine+residual+relu",
                          dict(affine=(a, b), residual=r, act="relu")))
        for mode, kw in modes:
            def lib(kw=kw):
                y = F.conv2d(xcl, wcl, None, s, p)
                if kw.get("stats"):
                    return y, y.sum((0, 2, 3)), torch.square(y).sum(
                        (0, 2, 3))
                return torch.relu(y * a[:, None, None] + b[:, None, None]
                                  + rcl)

            got = conv2d_nhwc(x, w, (s, s), (p, p), **kw)
            want = conv2d_nhwc_reference(x, w, (s, s), (p, p), **kw)
            err, ok, rel = conv_compare(torch, got, want, x, w, s, p)
            del got, want
            # bytes: the rows of x the conv reads (a strided 1x1 skips
            # the rest), w, the output, and the sums or (a, b, residual)
            rows_x = min(h, ho * min(k, s) + max(k - s, 0))
            out_b = 4 * nb * ho * ho * co
            nbytes = 4 * (nb * rows_x * rows_x * ci + w.numel()) + out_b + (
                8 * co if mode == "stats" else 8 * co + out_b)
            row = {"ms": timer(lambda: conv2d_nhwc(x, w, (s, s), (p, p),
                                                   **kw)),
                   "plain_ms": timer(lambda: conv2d_nhwc_reference(
                       x, w, (s, s), (p, p), **kw)),
                   "library_ms": timer(lib)}
            record("conv_stage", "%s x%d %s" % (conv_shape_str(shp),
                                                shapes[shp], mode),
                   err, ok, row["ms"], row["plain_ms"], row["library_ms"],
                   nbytes, conv_min_flops(nb, shp))
            rows[-1]["stats_rel_err"] = rel
            rows[-1]["form"] = "tile %dx%d" % conv_stage_tile(
                nb * ho * ho, co)
            if mode == "stats":
                row["bound_ms"] = rows[-1]["bound_ms"]
                for key in fwd:
                    fwd[key] += shapes[shp] * row[key]
                fwd_err = max(fwd_err, err)
        del x, w, xcl, wcl, r, rcl
        torch.cuda.empty_cache()
    # the whole forward's K6 work: each shape's times by its launches
    rows.append({"kernel": "conv_stage", "shape": CONV_FWD,
                 "max_abs_err": fwd_err, "ok": True, **fwd,
                 "bound_by": "operations",
                 "ops_rate": ops_rate("conv_stage")[0]})
    # every epilogue combination on ragged shapes: M not a multiple of
    # the tile, the stem's 4-byte gather (Ci = 3, 7x7, stride 2, padding
    # 3, Co = 64) and a 16-byte-gather 3x3 stage; then at the path's
    # widths: K = 4608 with M = 196, a Co = 64 3x3 stage, the full stem
    for n_, h, ci, co, k, s, p in ((3, 23, 3, 64, 7, 2, 3),
                                   (2, 9, 64, 128, 3, 1, 1),
                                   (4, 7, 512, 512, 3, 1, 1),
                                   (2, 56, 64, 64, 3, 1, 1),
                                   (2, 224, 3, 64, 7, 2, 3)):
        ho = (h + 2 * p - k) // s + 1
        x = torch.randn(n_, h, h, ci, device=dev, generator=gen)
        w = torch.randn(k, k, ci, co, device=dev, generator=gen) * \
            (k * k * ci) ** -0.5
        ab = (torch.rand(co, device=dev, generator=gen) + 0.5,
              torch.randn(co, device=dev, generator=gen))
        r = torch.randn(n_, ho, ho, co, device=dev, generator=gen)
        for stats in (False, True):
            for affine in (None, ab):
                for res in (None, r):
                    for act in ("", "relu"):
                        kw = dict(stats=stats, affine=affine, residual=res,
                                  act=act)
                        err, ok, rel = conv_compare(
                            torch, conv2d_nhwc(x, w, (s, s), (p, p), **kw),
                            conv2d_nhwc_reference(x, w, (s, s), (p, p),
                                                  **kw), x, w, s, p)
                        if not ok:
                            bad.append(
                                "conv_stage N=%d %s stats=%s affine=%s "
                                "residual=%s act=%r (max abs err %g, stats "
                                "rel err %s)"
                                % (n_, conv_shape_str((h, ci, co, k, s, p)),
                                   stats, affine is not None,
                                   res is not None, act, err, rel))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return rows, bad


def check_ring_kernels(torch, timer, gen, record, bad):
    """K9 at the ring's shard of the training step at sp = 4, q, k, v
    [16, 8, 512, 128]: the diagonal causal fold from a fresh carry, a
    non-causal fold from the carry it left, a half-masked block
    (k_offset 256) and a wholly masked one (k_offset 512), which must
    leave its carry bit-identical; then K2/K3 at that shape, non-causal
    (the ring's off-diagonal backward steps) and causal (its diagonal).  K9's yardstick is SDPA over
    the same block with the same mask: not the same function (it
    normalizes and keeps no carry), a point of reference."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.flash_attention import (
        NEG_INF, attention_reference, chunk_update_reference,
        flash_attention_bwd_reference, flash_attention_chunk,
        flash_bwd_dkv, flash_bwd_dq)

    dev = "cuda"
    b, h, s, d = TRAIN_BATCH, TRAIN_LM["n_head"], \
        TRAIN_LM["seq_len"] // SP, TRAIN_LM["d_model"] // TRAIN_LM["n_head"]
    scale = 1.0 / math.sqrt(d)
    shape = "[%d,%d,%d,%d]" % (b, h, s, d)
    q, k, v, k2, v2 = (torch.randn(b, h, s, d, device=dev, generator=gen)
                       for _ in range(5))
    fresh = (torch.full((b, h, s), NEG_INF, device=dev),
             torch.zeros(b, h, s, device=dev),
             torch.zeros(b, h, s, d, device=dev))
    seeded = flash_attention_chunk(q, k, v, *fresh, causal=True)
    pos = torch.arange(s, device=dev)
    for what, kv, carry, causal, off in (
            ("diagonal causal", (k, v), fresh, True, 0),
            ("non-causal, seeded carry", (k2, v2), seeded, False, 0),
            ("causal k_offset %d (half masked)" % (s // 2), (k2, v2),
             fresh, True, s // 2),
            ("causal k_offset %d (wholly masked), seeded carry" % s,
             (k2, v2), seeded, True, s)):
        got = flash_attention_chunk(q, *kv, *carry, causal=causal,
                                    k_offset=off)
        want = chunk_update_reference(q, *kv, *carry, scale, causal, off)
        errs = [compare(torch, a, w_) for a, w_ in zip(got, want)]
        ok = all(o for _, o in errs)
        if causal and off >= s and not all(
                torch.equal(a, c_) for a, c_ in zip(got, carry)):
            bad.append("flash_chunk: a wholly masked block changed the "
                       "carry")
        del got, want
        # what this block's data needs: the scores to compute, the q rows
        # with a live key and the k/v rows with a live query, the carry
        # read and written whole (dead rows copy theirs through)
        mask = pos[:, None] >= off + pos[None, :] if causal else None
        live = int(mask.sum()) if causal else s * s
        rows_q = int(mask.any(1).sum()) if causal else s
        rows_k = int(mask.any(0).sum()) if causal else s
        record("flash_chunk", "%s %s" % (shape, what),
               max(e for e, _ in errs), ok,
               timer(lambda: flash_attention_chunk(
                   q, *kv, *carry, causal=causal, k_offset=off)),
               timer(lambda: chunk_update_reference(
                   q, *kv, *carry, scale, causal, off)),
               timer(lambda: F.scaled_dot_product_attention(
                   q, *kv, attn_mask=mask if off else None,
                   is_causal=causal and not off)),
               4 * (b * h * d * (rows_q + 2 * rows_k)
                    + 2 * (2 * b * h * s + b * h * s * d)),
               4 * b * h * d * live)
    del seeded, fresh, k2, v2

    # K2/K3 from the saved lse at the shard shape: non-causal (the ring's
    # off-diagonal steps) and causal (its diagonal step)
    do = torch.randn(b, h, s, d, device=dev, generator=gen)
    for causal, what in ((False, " non-causal"), (True, " diagonal causal")):
        out, lse = attention_reference(q, k, v, scale, causal)
        delta = (do * out).sum(-1)
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, scale,
                                             causal)
        got = (flash_bwd_dq(q, k, v, do, lse, delta, scale, causal),
               *flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal))
        errs = [compare(torch, a, w_) for a, w_ in zip(got, want)]
        plain_ms = timer(lambda: flash_attention_bwd_reference(
            q, k, v, out, lse, do, scale, causal), iters=5)
        del got, want
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal)
        lib_ms = timer(lambda: torch.autograd.grad(o_lib, (qg, kg, vg), do,
                                                   retain_graph=True))
        del o_lib, qg, kg, vg
        # one product over the scores the mask leaves live
        tile = 2 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
        io = 4 * b * h * s * d
        record("flash_bwd_dq", shape + what, errs[0][0], errs[0][1],
               timer(lambda: flash_bwd_dq(q, k, v, do, lse, delta, scale,
                                          causal)),
               plain_ms, lib_ms, 5 * io + 8 * b * h * s, 3 * tile)
        record("flash_bwd_dkv", shape + what,
               max(errs[1][0], errs[2][0]), errs[1][1] and errs[2][1],
               timer(lambda: flash_bwd_dkv(q, k, v, do, lse, delta, scale,
                                           causal)),
               plain_ms, lib_ms, 6 * io + 8 * b * h * s, 4 * tile)
        del out, lse, delta
    del q, k, v, do
    torch.cuda.empty_cache()


def check_paged(torch, timer, gen, rng, record, bad):
    """K7 at the decode batch B = 16, NB = 128, bs = 16 over a 512-page
    pool (q and pages drawn from ``gen``, tables and lengths from
    ``rng``), with the batch-invariance gate; then the distinct-page
    rows of check_paged_rows."""
    import numpy as np

    from paddle_tpu_torch.kernels.flash_attention import (
        paged_attention, paged_attention_reference)

    dev = "cuda"
    h, d = 8, 128
    scale = 1.0 / math.sqrt(d)
    b, nb, bs, n_pages = 16, 128, 16, 512
    q = torch.randn(b, h, d, device=dev, generator=gen)
    kp = torch.randn(n_pages, bs, h, d, device=dev, generator=gen)
    vp = torch.randn(n_pages, bs, h, d, device=dev, generator=gen)
    tables_np = rng.randint(1, n_pages, size=(b, nb)).astype(np.int32)
    tables = torch.from_numpy(tables_np).to(dev)
    lens_np = rng.randint(1, nb * bs + 1, size=b).astype(np.int32)
    lens_np[0], lens_np[1] = 1, nb * bs       # a padding row, a full row
    lens = torch.from_numpy(lens_np).to(dev)

    out = paged_attention(q, kp, vp, tables, lens)
    err, ok = compare(torch, out,
                      paged_attention_reference(q, kp, vp, tables, lens,
                                                scale))
    live_pos = int(lens_np.sum())
    row = record("paged_attention", "B=16 NB=128 bs=16 H=8 D=128", err,
                 ok, timer(lambda: paged_attention(q, kp, vp, tables, lens)),
                 timer(lambda: paged_attention_reference(q, kp, vp, tables,
                                                         lens, scale)),
                 timer(lambda: paged_library(torch, q, kp, vp, tables, lens,
                                             scale)),
                 paged_bytes(tables_np, lens_np, h, d),
                 4 * live_pos * h * d)
    # a row's output is batch-invariant: alone, in its own block-count
    # bucket, it is bit for bit its row of the B = 16, NB = 128 call
    inv = True
    for r0 in (0, 1, 7, 15):
        pages = -(-int(lens_np[r0]) // bs)
        nb_own = 1 << (pages - 1).bit_length()
        alone = paged_attention(q[r0:r0 + 1].contiguous(), kp, vp,
                                tables[r0:r0 + 1, :nb_own].contiguous(),
                                lens[r0:r0 + 1].contiguous())
        inv = inv and torch.equal(alone[0], out[r0])
    row["rows_invariant"] = inv
    if not inv:
        bad.append("paged_attention: a row alone differs from its row of "
                   "the B=16 NB=128 call")
    del q, kp, vp, tables, lens, out
    torch.cuda.empty_cache()
    check_paged_rows(torch, timer, record)


def paged_library(torch, q, kp, vp, tables, lens, scale):
    """K7's yardstick: gather every table slot's pages, two batched
    matmuls and a masked softmax."""
    b, nb = tables.shape
    _, bs, h, d = kp.shape
    kc = kp[tables.long()].reshape(b, nb * bs, h, d).permute(0, 2, 3, 1)
    vc = vp[tables.long()].reshape(b, nb * bs, h, d).transpose(1, 2)
    sc = torch.matmul(q.unsqueeze(2), kc).squeeze(2) * scale
    live = torch.arange(nb * bs, device=q.device)[None, None] < \
        lens.long()[:, None, None]
    p = torch.softmax(sc.masked_fill(~live, -1e30), dim=-1)
    return torch.matmul(p.unsqueeze(2), vc).squeeze(2)


def paged_bytes(tables_np, lens_np, h, d, bs=16):
    """K7's bytes, each read once: the K/V rows of the distinct (page,
    row in page) pairs that some row of the batch attends to (a page two
    rows share counts once), q and out, the tables and lengths."""
    b, nb = tables_np.shape
    live = set()
    for ids, n in zip(tables_np, lens_np):
        for pos in range(int(n)):
            live.add((int(ids[pos // bs]), pos % bs))
    return 4 * (2 * len(live) * h * d + 2 * b * h * d) + 4 * b * (nb + 1)


def check_paged_rows(torch, timer, record):
    """K7 at the shapes its split over pages is for, every live page a
    distinct page of a pool of B x NB + 1, so the bytes bound counts
    bytes that come from device memory: one row of 2048 tokens (B = 1,
    16 spans a head), profile_serve's batch (B = 16, 1024 tokens each),
    a small ragged batch (B = 4, NB = 64, 16-1024 tokens) and one span a
    row (B = 16, NB = 8, 1-128 tokens).  Its own seeds, so the other
    kernels' inputs stay as they were."""
    import numpy as np

    from paddle_tpu_torch.kernels.flash_attention import (
        paged_attention, paged_attention_reference)

    rng = np.random.RandomState(SEED + 7)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    h, d, bs = 8, 128, 16
    scale = d ** -0.5
    for what, nb, lens_np in (
            ("B=1 NB=128 2048 tokens", 128, np.array([2048])),
            ("B=16 NB=128 1024 tokens", 128, np.full(16, 1024)),
            ("B=4 NB=64 16-1024 tokens", 64, rng.randint(16, 1025, 4)),
            ("B=16 NB=8 1-128 tokens", 8, rng.randint(1, 129, 16))):
        b, n = len(lens_np), len(lens_np) * nb + 1
        q = torch.randn(b, h, d, device="cuda", generator=gen)
        kp = torch.randn(n, bs, h, d, device="cuda", generator=gen)
        vp = torch.randn(n, bs, h, d, device="cuda", generator=gen)
        ids = rng.permutation(np.arange(1, n)).reshape(b, nb)
        live = np.arange(nb)[None] < -(-lens_np[:, None] // bs)
        tables_np = np.where(live, ids, 0).astype(np.int32)
        tables = torch.from_numpy(tables_np).cuda()
        lens = torch.from_numpy(lens_np.astype(np.int32)).cuda()
        err, ok = compare(torch, paged_attention(q, kp, vp, tables, lens),
                          paged_attention_reference(q, kp, vp, tables, lens,
                                                    scale))
        record("paged_attention", what + ", distinct pages", err, ok,
               timer(lambda: paged_attention(q, kp, vp, tables, lens)),
               timer(lambda: paged_attention_reference(q, kp, vp, tables,
                                                       lens, scale)),
               timer(lambda: paged_library(torch, q, kp, vp, tables, lens,
                                           scale)),
               paged_bytes(tables_np, lens_np, h, d),
               4 * int(lens_np.sum()) * h * d)
        del q, kp, vp, tables, lens
    torch.cuda.empty_cache()


def conv_flops(n, shp):
    h, ci, co, k, s, p = shp
    ho = (h + 2 * p - k) // s + 1
    return 2 * n * ho * ho * co * k * k * ci


def conv_shape_str(shp):
    return "(H %d, Ci %d, Co %d, k %d, s %d, p %d)" % shp


def conv_compare(torch, got, want, x, w, s, p):
    """K6 against its plain version: the output elementwise (ATOL /
    RTOL); with stats, the per-channel sums by conv_fused.stats_error.
    Returns (max abs err, ok, worst stats error over sum |terms|)."""
    from paddle_tpu_torch.kernels.conv_fused import STATS_RTOL, stats_error

    if not isinstance(got, tuple):
        return compare(torch, got, want) + (None,)
    err, ok = compare(torch, got[0], want[0])
    s_err, rel = stats_error(x, w, (s, s), (p, p), got[1], got[2])
    return max(err, s_err), ok and rel <= STATS_RTOL, rel


# ---------------------------------------------------------------------------
# phases 4-6: serving
# ---------------------------------------------------------------------------

MAX_NEW = 32
# the kernels a serving run launches (the int8 tenant runs all three)
SERVE_KERNELS = ("flash_fwd", "paged_attention", "matmul_int8")


def _prompts(cfg, seed, lengths):
    import numpy as np

    rng = np.random.RandomState(seed)
    return [rng.randint(0, cfg.vocab, size=n).tolist() for n in lengths]


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(q * len(xs)))] if xs else None


def serve(torch, srv, name, prompts):
    """Generate for every prompt, the second half arriving while the
    first half decodes; returns (results, seconds, launches, calls).
    ``calls`` lists the K7 call of every decode step (one a layer) as
    [B, NB, context lengths of the real rows], B and NB the engine's
    power-of-2 buckets; a padding row attends over one position."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.serving.engine import pow2_bucket

    eng = srv.engine(name)
    half = len(prompts) // 2
    # one short request first: CUDA/cuBLAS first-call set-up is load
    # time, not any measured request's TTFT
    srv.generate(name, prompts[0][:16], 2).result(600)
    torch.cuda.synchronize()
    reset_launches()
    steps0, prefills0 = eng.decode_steps, eng.prefills
    calls, step = [], eng.decode_step

    def logged(blocks_list, lens_list, *args, **kw):
        cfg = eng.config
        calls.append(
            [pow2_bucket(len(blocks_list), cfg.max_batch),
             pow2_bucket(max(map(len, blocks_list)), cfg.max_blocks)]
            + [int(n) + 1 for n in lens_list])
        return step(blocks_list, lens_list, *args, **kw)

    eng.decode_step = logged
    try:
        t0 = time.perf_counter()
        futs = [srv.generate(name, p, MAX_NEW) for p in prompts[:half]]
        while eng.decode_steps == steps0 and not futs[0].done():
            time.sleep(0.001)
        futs += [srv.generate(name, p, MAX_NEW) for p in prompts[half:]]
        res = [f.result(600) for f in futs]
        secs = time.perf_counter() - t0
    finally:
        del eng.decode_step
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    launches["prefills"] = eng.prefills - prefills0
    launches["decode_steps"] = eng.decode_steps - steps0
    if any(len(r["tokens"]) != MAX_NEW for r in res):
        raise AssertionError("a request did not get %d tokens" % MAX_NEW)
    if eng.pool.used_blocks != 0:
        raise AssertionError("pool not drained: %d blocks used"
                             % eng.pool.used_blocks)
    return res, secs, launches, calls


def serve_summary(res, secs):
    ttft = [r["ttft_ms"] for r in res]
    itl = [x for r in res for x in r["itl_ms"]]
    n_tok = sum(len(r["tokens"]) for r in res)
    return {"requests": len(res), "tokens": n_tok,
            "tokens_per_s": n_tok / secs, "seconds": secs,
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p90": _pct(ttft, 0.9),
            "itl_ms_p50": _pct(itl, 0.5), "itl_ms_p90": _pct(itl, 0.9),
            "preempted": sum(r["preempted"] for r in res)}


def oracle_check(torch, eng, params, prompt, tokens):
    """The served tokens and the engine's final logits against
    dense_forward on the card.  A served token must be the dense
    argmax up to LOGIT_TOL (a near-tie may go either way); the final
    logits, from a replay of the request on the engine, must match the
    dense row within LOGIT_TOL."""
    from paddle_tpu_torch.serving import GenRequest, dense_forward

    n = len(prompt)
    dense = dense_forward(eng.config, params, prompt + tokens[:-1],
                          device=eng.device)[n - 1:]
    served = torch.tensor(tokens, device=dense.device)
    picked = dense[torch.arange(len(tokens), device=dense.device), served]
    gap = float((dense.max(dim=-1).values - picked).max())
    agree = int((dense.argmax(dim=-1) == served).sum())
    # replay on the engine itself (the tenant is idle): prefill, then
    # decode steps with logits, feeding the served tokens
    req = GenRequest(prompt, MAX_NEW, None, None)
    req.blocks = eng.pool.alloc(eng.pool.blocks_for(n + MAX_NEW))
    try:
        first = eng.prefill(req)
        logits = None
        for tok in tokens[:-1]:
            _, logits = eng.decode_step([req.blocks], [req.context_len],
                                        [tok], with_logits=True)
            req.context_len += 1
    finally:
        eng.free_sequence(req)
    final = torch.from_numpy(logits[0]).to(dense.device)
    err = float((final - dense[-1]).abs().max())
    ok = (gap <= LOGIT_TOL and err <= LOGIT_TOL
          and first == tokens[0])
    return {"dense_argmax_agree": agree, "of": len(tokens),
            "max_logit_gap_to_dense_argmax": gap,
            "final_logits_max_abs_err": err, "tolerance": LOGIT_TOL,
            "ok": ok}


# ---------------------------------------------------------------------------
# phases 7-8: training through the fluid Executor
# ---------------------------------------------------------------------------

TRAIN_LM = dict(vocab_size=8192, seq_len=2048, d_model=1024, n_head=8,
                n_layers=6, d_ff=4096, learning_rate=1e-3)
TRAIN_BATCH = 16
TRAIN_STEPS = 5
# kernels a training step launches, with their count per step (one per
# layer: ring_attention runs K1, ring_attention_grad K2 and K3)
TRAIN_KERNELS = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
# the fused program's kernels besides those: K4 for every projection,
# K5 for every residual add + LayerNorm seam
FUSED_KERNELS = ("matmul_epilogue", "add_ln")
# the fused program's projections (name, K, N, bias, act), each one K4
# launch per layer, lm_head once a step
# the sequence-parallel path: 4 ring shards on the one card; per layer
# and step 10 live chunk folds (K9) forward and 10 chunk backward steps
# (K2 + K3) at causal, p(p+1)/2 of p*p
SP = 4
SP_KERNELS = {"flash_chunk": SP * (SP + 1) // 2,
              "flash_bwd_dq": SP * (SP + 1) // 2,
              "flash_bwd_dkv": SP * (SP + 1) // 2}
FUSED_MATMULS = (("qkv", 1024, 3072, False, ""),
                 ("out_proj", 1024, 1024, True, ""),
                 ("fc1", 1024, 4096, True, "relu"),
                 ("fc2", 4096, 1024, True, ""),
                 ("lm_head", 1024, 8192, True, ""))


def train_launches_per_step(fuse):
    """{kernel: launches a training step must make}."""
    n = TRAIN_LM["n_layers"]
    want = {k: n for k in TRAIN_KERNELS}
    if fuse:
        want.update(matmul_epilogue=4 * n + 1, add_ln=2 * n)
    return want


def build_lm(fluid, **overrides):
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(**{**TRAIN_LM, **overrides})
    return main, startup, loss


def lm_batch(batch, seed):
    """One batch of next-token pairs from a seeded RandomState."""
    import numpy as np

    rng = np.random.RandomState(seed)
    toks = rng.randint(0, TRAIN_LM["vocab_size"],
                       (batch, TRAIN_LM["seq_len"] + 1)).astype(np.int64)
    return {"src": toks[:, :-1], "label": toks[:, 1:, None]}


def train(torch, fuse):
    """Startup, then 1 warm-up and TRAIN_STEPS timed steps of the
    flagship LM (the fused-block program with ``fuse``) on one fixed
    batch, through Executor(CUDAPlace(0))."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_lm(fluid, fuse_transformer=fuse)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = lm_batch(TRAIN_BATCH, SEED + 3)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)   # the fetch syncs
        losses.append(float(out[0][0]))
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_LM["seq_len"]
    p50 = _pct(step_ms, 0.5)
    want = train_launches_per_step(fuse)
    per_step = {k: launches[k] / TRAIN_STEPS for k in KERNELS}
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(per_step[k] == want.get(k, 0) for k in KERNELS))
    return {"phase": "train_fused" if fuse else "train_f32",
            "batch": TRAIN_BATCH, **TRAIN_LM,
            "startup_s": startup_s, "losses": losses, "step_ms": step_ms,
            "step_ms_p50": p50, "tokens_per_s": tokens / p50 * 1e3,
            "max_memory_allocated_bytes": peak,
            "launches_per_step": per_step,
            "launches_per_step_wanted": want, "launches": launches,
            "ok": ok}


def train_oracle(torch, fuse):
    """One step of the LM (the fused-block program with ``fuse``) at
    full width, depth 1, batch 1 on the card and, from the same
    parameters, on Executor(CPUPlace()): the loss and every parameter
    gradient."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    main, startup, loss = build_lm(fluid, n_layers=1, fuse_transformer=fuse)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    params = sorted(p.name for p in main.all_parameters())
    # where relu's branch is decided: the relu op's input, or in the
    # fused program (no relu op) the zero pattern of blk0_fc1's fused
    # Out, which is relu(pre) itself
    ops = main.desc.blocks[0].ops
    relu_in = ([op.output("Out")[0] for op in ops
                if op.type == "fused_matmul_bias_act"
                and op.input("W") == ["blk0_fc1.w_0"]] if fuse else
               [op.input("X")[0] for op in ops if op.type == "relu"])
    if len(relu_in) != 1:
        raise AssertionError("want one relu site, found %r" % relu_in)
    fetch = [loss.name] + [p + "@GRAD" for p in params] + relu_in
    feed = lm_batch(1, SEED + 4)
    got = fluid.Executor(fluid.CUDAPlace(0)).run(main, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=card)
    want = fluid.Executor(fluid.CPUPlace()).run(main, feed=feed,
                                                fetch_list=fetch,
                                                scope=host)
    return {"phase": "train_fused_oracle" if fuse else "train_oracle",
            "n_layers": 1, "batch": 1, "loss_card": float(got[0][0]),
            "loss_cpu": float(want[0][0]),
            **step_agreement(got, want, fetch[1:1 + len(params)])}


def step_agreement(got, want, grad_names):
    """One step's fetches ([loss, *grads, *relu inputs]) against a
    reference's: the loss to ORACLE_LOSS_RTOL, each gradient to
    ORACLE_GRAD_RTOL in relative Frobenius norm, relu flips counted."""
    import numpy as np

    n = len(grad_names)
    loss_err = abs(float(got[0][0]) - float(want[0][0])) / \
        abs(float(want[0][0]))
    grads = {}
    for name, a, b in zip(grad_names, got[1:], want[1:]):
        a, b = a.astype(np.float64), b.astype(np.float64)
        grads[name] = {
            "fro_rel": float(np.linalg.norm(a - b) / np.linalg.norm(b)),
            "max_abs_rel": float(np.abs(a - b).max() / np.abs(b).max())}
    flips = sum(int(((a > 0) != (b > 0)).sum())
                for a, b in zip(got[1 + n:], want[1 + n:]))
    worst = max(grads, key=lambda g: grads[g]["fro_rel"])
    ok = (math.isfinite(loss_err) and loss_err <= ORACLE_LOSS_RTOL
          and all(math.isfinite(g["fro_rel"])
                  and g["fro_rel"] <= ORACLE_GRAD_RTOL
                  for g in grads.values()))
    return {"loss_rel_err": loss_err, "relu_flips": flips,
            "worst_grad": worst, "grads": grads,
            "loss_tolerance": ORACLE_LOSS_RTOL,
            "grad_tolerance": ORACLE_GRAD_RTOL, "ok": ok}


# ---------------------------------------------------------------------------
# phases 15-16: sequence-parallel training on a 4-shard mesh
# ---------------------------------------------------------------------------

def sp_mesh(torch, device):
    from paddle_tpu_torch.parallel import make_mesh

    return make_mesh({"sp": SP}, [torch.device(device)] * SP)


def train_sp(torch):
    """Startup, then 1 warm-up and TRAIN_STEPS timed steps of the sp LM
    on one fixed batch through ExecutorCore(CUDAPlace(0)) on the 4-shard
    one-card mesh; the dense program's loss from the startup parameters
    and the same batch beside the warm-up's, for information."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.executor_impl import ExecutorCore
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_lm(fluid, sp=True)
    mesh = sp_mesh(torch, "cuda:0")
    core = ExecutorCore(fluid.CUDAPlace(0), mesh=mesh)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    core.run(startup.desc, scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = lm_batch(TRAIN_BATCH, SEED + 3)
    dmain, _, dloss = build_lm(fluid)
    dense = fluid.Scope()
    for name, v in main.desc.blocks[0].vars.items():
        if v.persistable and scope.has_var(name):
            dense.set(name, scope.find_var(name).clone())
    dense_loss = float(fluid.Executor(fluid.CUDAPlace(0)).run(
        dmain, feed=feed, fetch_list=[dloss], scope=dense)[0][0])
    del dense
    torch.cuda.empty_cache()
    losses = [float(core.run(main.desc, scope, 0, feed, [loss.name])[0][0])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms = []
    for _ in range(TRAIN_STEPS):
        t0 = time.perf_counter()
        out = core.run(main.desc, scope, 0, feed, [loss.name])
        step_ms.append((time.perf_counter() - t0) * 1e3)   # the fetch syncs
        losses.append(float(out[0][0]))
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    tokens = TRAIN_BATCH * TRAIN_LM["seq_len"]
    p50 = _pct(step_ms, 0.5)
    want = {k: TRAIN_LM["n_layers"] * n for k, n in SP_KERNELS.items()}
    per_step = {k: launches[k] / TRAIN_STEPS for k in KERNELS}
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(per_step[k] == want.get(k, 0) for k in KERNELS))
    return {"phase": "train_sp", "batch": TRAIN_BATCH, **TRAIN_LM,
            "mesh": {"axes": mesh.shape,
                     "logical_devices": [str(d_) for d_ in mesh.devices],
                     "physical_devices": len(set(mesh.devices))},
            "startup_s": startup_s, "losses": losses, "step_ms": step_ms,
            "step_ms_p50": p50, "tokens_per_s": tokens / p50 * 1e3,
            "max_memory_allocated_bytes": peak,
            "dense_loss_same_params_and_batch": dense_loss,
            "dense_vs_sp_first_loss_rel": abs(dense_loss - losses[0]) /
            abs(dense_loss), "information": ["dense_loss_same_params_"
                                             "and_batch"],
            "launches_per_step": per_step,
            "launches_per_step_wanted": want, "launches": launches,
            "ok": ok}


def train_sp_oracle(torch):
    """One sp step at full width, depth 1, batch 1 on the card's 4-shard
    mesh against the same step on a 4-shard CPU mesh, and against the
    dense program's step on the card, all from the same parameters."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.executor_impl import ExecutorCore
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_lm(fluid, n_layers=1, sp=True)
    dmain, _, _ = build_lm(fluid, n_layers=1)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    arrays = get_scope_arrays(card, persist)
    host, dense = fluid.Scope(), fluid.Scope()
    set_scope_arrays(host, arrays, "cpu")
    set_scope_arrays(dense, arrays, "cuda")
    params = sorted(p.name for p in main.all_parameters())
    relu_in = [op.input("X")[0] for op in main.desc.blocks[0].ops
               if op.type == "relu"]
    fetch = [loss.name] + [p + "@GRAD" for p in params] + relu_in
    feed = lm_batch(1, SEED + 4)
    reset_launches()
    got = ExecutorCore(fluid.CUDAPlace(0), mesh=sp_mesh(torch, "cuda:0")
                       ).run(main.desc, card, 0, feed, fetch)
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    want_cpu = ExecutorCore(fluid.CPUPlace(), mesh=sp_mesh(torch, "cpu")
                            ).run(main.desc, host, 0, feed, fetch)
    want_dense = fluid.Executor(fluid.CUDAPlace(0)).run(
        dmain, feed=feed, fetch_list=fetch, scope=dense)
    vs_cpu = step_agreement(got, want_cpu, fetch[1:1 + len(params)])
    vs_dense = step_agreement(got, want_dense, fetch[1:1 + len(params)])
    return {"phase": "train_sp_oracle", "n_layers": 1, "batch": 1,
            "sp": SP, "launches": launches,
            "loss_card": float(got[0][0]),
            "loss_cpu_sp": float(want_cpu[0][0]),
            "loss_card_dense": float(want_dense[0][0]),
            "vs_cpu_sp": vs_cpu, "vs_card_dense": vs_dense,
            "ok": (vs_cpu["ok"] and vs_dense["ok"]
                   and launches == dict(SP_KERNELS))}


# ---------------------------------------------------------------------------
# phases 11-14: ResNet-50 through the fluid Executor
# ---------------------------------------------------------------------------

RESNET = dict(data_set="flowers", depth=50, learning_rate=0.01,
              input_dtype="uint8")
RESNET_BATCH = 256
RESNET_STEPS = 5
RESNET_CONVS = 53      # conv stages: K6 launches a fused step or forward
RESNET_ORACLE_BATCH = 2
RESNET_PATHS = ("infer_resnet_fused", "train_resnet", "train_resnet_fused")
CONV_FWD = "ResNet-50 forward, batch 256, stats: 53 launches, 20 shapes"


def build_resnet(fluid, fused, is_test=False):
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = resnet.get_model(
            **RESNET, is_test=is_test,
            data_format="NHWC" if fused else "NCHW", fused_stages=fused)
    return main, startup, loss


def conv_stage_shapes():
    """{(H, Ci, Co, k, stride, pad): launches a forward} of the fused
    ResNet-50 program, read off its desc."""
    import paddle_tpu_torch.fluid as fluid

    main, _, _ = build_resnet(fluid, True, is_test=True)
    block = main.desc.blocks[0]
    shapes = {}
    for op in block.ops:
        if op.type != "fused_conv2d_bn_act":
            continue
        _, h, _, ci = block.vars[op.input("Input")[0]].shape
        k, _, _, co = block.vars[op.input("Filter")[0]].shape
        key = (h, ci, co, k, op.attr("strides")[0], op.attr("paddings")[0])
        shapes[key] = shapes.get(key, 0) + 1
    if sum(shapes.values()) != RESNET_CONVS:
        raise AssertionError("want %d conv stages, found %r"
                             % (RESNET_CONVS, shapes))
    return shapes


def resnet_batch(batch, seed):
    """One batch of uint8 images and labels from a seeded RandomState."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"data": rng.randint(0, 256, (batch, 3, 224, 224))
            .astype(np.uint8),
            "label": rng.randint(0, 102, (batch, 1)).astype(np.int64)}


def _hwio_for(arrays, main):
    """``arrays`` with each 4-D filter transposed OIHW -> HWIO where
    ``main`` stores it so."""
    import numpy as np

    block = main.desc.blocks[0]
    out = {}
    for name, v in arrays.items():
        vd = block.vars.get(name)
        if vd is None:
            continue
        if v.ndim == 4 and tuple(v.shape) != tuple(vd.shape):
            v = np.ascontiguousarray(np.transpose(v, (2, 3, 1, 0)))
        out[name] = v
    return out


def infer_resnet(torch):
    """The is_test fused forward at batch 256 against the NCHW is_test
    forward on the card, from the NCHW startup's parameters with each
    BN's running statistics set to this batch's own (fetched from one
    step of the NCHW training program), so both normalize as training
    does.  1 warm-up and RESNET_STEPS timed forwards of the fused
    program."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = resnet_batch(RESNET_BATCH, SEED + 6)
    tmain, tstart, _ = build_resnet(fluid, False)
    scope = fluid.Scope()
    exe.run(tstart, scope=scope)
    persist = sorted(n for n, v in tmain.desc.blocks[0].vars.items()
                     if v.persistable)
    params = get_scope_arrays(scope, persist)
    bns = [op for op in tmain.desc.blocks[0].ops if op.type == "batch_norm"]
    stats = exe.run(tmain, feed=feed, scope=scope,
                    fetch_list=[op.output("SavedMean")[0] for op in bns] +
                    [op.output("SavedVariance")[0] for op in bns])
    del scope
    for op, m, v in zip(bns, stats[:len(bns)], stats[len(bns):]):
        params[op.input("Mean")[0]] = m
        params[op.input("Variance")[0]] = v
    torch.cuda.empty_cache()

    probs = {}
    for fused in (False, True):
        main, _, _ = build_resnet(fluid, fused, is_test=True)
        softmax = [op.output("Out")[0] for op in main.desc.blocks[0].ops
                   if op.type == "softmax"]
        scope = fluid.Scope()
        set_scope_arrays(scope, _hwio_for(params, main), "cuda")
        reset_launches()
        probs[fused] = exe.run(main, feed=feed, fetch_list=softmax,
                               scope=scope)[0]
        if fused:
            first = KERNELS["conv_stage"].launches
            fwd_ms = []
            for _ in range(RESNET_STEPS):
                t0 = time.perf_counter()
                exe.run(main, feed=feed, fetch_list=softmax, scope=scope)
                fwd_ms.append((time.perf_counter() - t0) * 1e3)
            launches = {k: fn.launches for k, fn in KERNELS.items()}
        del scope
        torch.cuda.empty_cache()
    err = float(np.abs(probs[True] - probs[False]).max())
    top1 = int((probs[True].argmax(1) == probs[False].argmax(1)).sum())
    p50 = _pct(fwd_ms, 0.5)
    ok = (np.isfinite(probs[True]).all() and err <= INFER_TOL
          and first == RESNET_CONVS
          and launches["conv_stage"] == RESNET_CONVS * (1 + RESNET_STEPS)
          and all(launches[k] == 0 for k in KERNELS if k != "conv_stage"))
    return {"phase": "infer_resnet_fused", "batch": RESNET_BATCH, **RESNET,
            "forward_ms": fwd_ms, "forward_ms_p50": p50,
            "images_per_s": RESNET_BATCH / p50 * 1e3,
            "conv_stage_launches_per_forward": first,
            "softmax_max_abs_err_vs_nchw": err, "tolerance": INFER_TOL,
            "top1_agree_vs_nchw": [top1, RESNET_BATCH],
            "launches": launches, "ok": bool(ok)}


def train_resnet(torch, fused):
    """Startup, then 1 warm-up and RESNET_STEPS timed steps of ResNet-50
    (the NHWC fused-stage program with ``fused``) on one fixed uint8
    batch, through Executor(CUDAPlace(0))."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_resnet(fluid, fused)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    t0 = time.perf_counter()
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = resnet_batch(RESNET_BATCH, SEED + 5)
    losses = [float(exe.run(main, feed=feed, fetch_list=[loss],
                            scope=scope)[0][0])]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    step_ms = []
    for _ in range(RESNET_STEPS):
        t0 = time.perf_counter()
        out = exe.run(main, feed=feed, fetch_list=[loss], scope=scope)
        step_ms.append((time.perf_counter() - t0) * 1e3)   # the fetch syncs
        losses.append(float(out[0][0]))
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    p50 = _pct(step_ms, 0.5)
    want = {"conv_stage": RESNET_CONVS} if fused else {}
    per_step = {k: launches[k] / RESNET_STEPS for k in KERNELS}
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(per_step[k] == want.get(k, 0) for k in KERNELS))
    return {"phase": "train_resnet_fused" if fused else "train_resnet",
            "batch": RESNET_BATCH, **RESNET, "startup_s": startup_s,
            "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
            "images_per_s": RESNET_BATCH / p50 * 1e3,
            "max_memory_allocated_bytes": peak,
            "launches_per_step": per_step,
            "launches_per_step_wanted": want, "launches": launches,
            "ok": ok}


def resnet_oracle(torch, seed=SEED):
    """One step of the fused ResNet-50 at full width and depth, batch 2,
    on the card and, from the same parameters, on Executor(CPUPlace()),
    then on the CPU again with one ulp added to every filter (the
    step's own f32 spread): the loss and every parameter gradient; relu
    flips counted on the zero pattern of each relu stage's Y.  ``seed``
    draws the parameters and the batch."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_resnet(fluid, True)
    startup.random_seed = seed
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    arrays = get_scope_arrays(card, persist)
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    relu_y = [op.output("Y")[0] for op in main.desc.blocks[0].ops
              if op.type == "fused_conv2d_bn_act" and op.attr("act") == "relu"]
    fetch = [loss.name] + [p + "@GRAD" for p in params] + relu_y
    feed = resnet_batch(RESNET_ORACLE_BATCH, seed + 7)
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(main, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=card)
    k6 = KERNELS["conv_stage"].launches
    cpu = []
    for ulp in (False, True):
        host = fluid.Scope()
        set_scope_arrays(host, {
            k: np.nextafter(v, np.float32(np.inf)) if ulp and v.ndim == 4
            else v for k, v in arrays.items()}, "cpu")
        cpu.append(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=host))
    want, moved = cpu
    n = len(params)

    def fro_rel(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    def flips(xs, ys):
        return sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(xs, ys))

    loss_err = abs(float(got[0][0]) - float(want[0][0])) / \
        abs(float(want[0][0]))
    grads = {name: {"fro_rel": fro_rel(a, b), "cpu_ulp_fro_rel":
                    fro_rel(c, b)}
             for name, a, b, c in zip(fetch[1:1 + n], got[1:1 + n],
                                      want[1:1 + n], moved[1:1 + n])}
    spread = max(g["cpu_ulp_fro_rel"] for g in grads.values())
    tol = max(ORACLE_GRAD_RTOL, RESNET_ORACLE_SPREAD * spread)
    median = _pct([g["fro_rel"] for g in grads.values()], 0.5)
    median_spread = _pct([g["cpu_ulp_fro_rel"] for g in grads.values()], 0.5)
    median_tol = max(ORACLE_GRAD_RTOL, RESNET_ORACLE_SPREAD * median_spread)
    worst = max(grads, key=lambda g: grads[g]["fro_rel"])
    ok = (math.isfinite(loss_err) and loss_err <= RESNET_ORACLE_LOSS_RTOL
          and k6 == RESNET_CONVS
          and spread <= RESNET_ORACLE_SPREAD_MAX and median <= median_tol
          and all(math.isfinite(g["fro_rel"]) and g["fro_rel"] <= tol
                  for g in grads.values()))
    return {"phase": "train_resnet_fused_oracle", "depth": 50,
            "batch": RESNET_ORACLE_BATCH, "seed": seed,
            "conv_stage_launches": k6,
            "loss_card": float(got[0][0]), "loss_cpu": float(want[0][0]),
            "loss_cpu_ulp": float(moved[0][0]), "loss_rel_err": loss_err,
            "relu_flips": flips(got[1 + n:], want[1 + n:]),
            "relu_flips_cpu_ulp": flips(moved[1 + n:], want[1 + n:]),
            "relu_outputs": int(sum(a.size for a in want[1 + n:])),
            "worst_grad": worst, "worst_fro_rel": grads[worst]["fro_rel"],
            "median_fro_rel": median,
            "cpu_ulp_worst_fro_rel": spread,
            "cpu_ulp_median_fro_rel": median_spread,
            "cpu_ulp_tolerance": RESNET_ORACLE_SPREAD_MAX,
            "grads": grads, "loss_tolerance": RESNET_ORACLE_LOSS_RTOL,
            "grad_tolerance": tol, "median_grad_tolerance": median_tol,
            "ok": ok}


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        import paddle_tpu_torch  # noqa: F401
    except ImportError as e:
        print("chip_smoke: run from the repository root (%s)" % e,
              file=sys.stderr)
        return 2
    from paddle_tpu_torch import resolve_device
    from paddle_tpu_torch.kernels import KERNELS, _build
    from paddle_tpu_torch.serving import (FLAGSHIP_LM, InferenceServer,
                                          tiny_lm)

    resolve_device("cuda")      # pins float32 matmuls (no TF32)
    phase = "device"
    try:
        smi = nvidia_smi()
        emit({"phase": "device", "nvidia_smi": smi,
              "name": torch.cuda.get_device_name(0),
              "count": torch.cuda.device_count(),
              "torch": torch.__version__, "cuda": torch.version.cuda})

        phase = "build"
        t0 = time.perf_counter()
        report = _build.build_all()
        emit({"phase": "build", "seconds": time.perf_counter() - t0,
              "kernels": report})

        phase = "kernels"
        timer = Timer(torch)
        rows, bad = check_kernels(torch, timer)
        emit({"phase": "kernels", "atol": ATOL, "rtol": RTOL,
              "rows": rows})
        if bad:
            raise AssertionError("kernel disagrees with its plain "
                                 "version: " + "; ".join(bad))

        phase = "serve_f32"
        cfg, params = tiny_lm(SEED, **FLAGSHIP_LM)
        lengths = (16, 300, 1024, 64, 517, 33, 100, 800, 17, 256, 1000, 48)
        prompts = _prompts(cfg, SEED + 1, lengths)
        srv = InferenceServer(device="cuda")
        try:
            eng = srv.load_generative("f32", cfg, params, kv_blocks=512)
            res, secs, launches, calls = serve(torch, srv, "f32",
                                               prompts)
            for k in ("flash_fwd", "paged_attention"):
                if launches[k] <= 0:
                    raise AssertionError("%s never launched" % k)
            check = oracle_check(torch, eng, params, prompts[6],
                                 res[6]["tokens"])
            emit({"phase": "serve_f32", "launches": launches,
                  **serve_summary(res, secs), "oracle": check,
                  "paged_calls": calls})
            if not check["ok"]:
                raise AssertionError("f32 tenant disagrees with "
                                     "dense_forward")

            phase = "serve_int8"
            eng8 = srv.load_generative("int8", cfg, params, quant="int8",
                                       kv_blocks=512)
            res8, secs8, launches8, calls8 = serve(torch, srv, "int8",
                                                   prompts)
            if min(launches8[k] for k in SERVE_KERNELS) <= 0:
                raise AssertionError("a kernel never launched on the int8 "
                                     "tenant: %r" % launches8)
            agree = sum(a == b for r, r8 in zip(res, res8)
                        for a, b in zip(r["tokens"], r8["tokens"]))
            check8 = oracle_check(torch, eng8, eng8._params, prompts[6],
                                  res8[6]["tokens"])
            emit({"phase": "serve_int8", "launches": launches8,
                  **serve_summary(res8, secs8),
                  "token_agreement_with_f32": [agree,
                                               len(prompts) * MAX_NEW],
                  "oracle": check8, "paged_calls": calls8})
            if not check8["ok"]:
                raise AssertionError("int8 tenant disagrees with "
                                     "dense_forward over its own "
                                     "dequantized weights")

            phase = "batch_invariance"
            solo = srv.generate("f32", prompts[3], MAX_NEW).result(600)
            batch = _prompts(cfg, SEED + 2, [40 + 37 * i for i in range(15)])
            futs = [srv.generate("f32", p, MAX_NEW)
                    for p in [prompts[3]] + batch]
            in_batch = [f.result(600) for f in futs][0]
            emit({"phase": "batch_invariance", "information": True,
                  "identical": solo["tokens"] == in_batch["tokens"],
                  "solo": solo["tokens"], "in_batch_of_16":
                  in_batch["tokens"]})
        finally:
            srv.close()

        launches_train = {}
        for fuse in (False, True):
            phase = "train_fused" if fuse else "train_f32"
            torch.cuda.empty_cache()
            result = train(torch, fuse)
            emit(result)
            if not result["ok"]:
                raise AssertionError("%s failed its checks" % phase)
            launches_train[phase] = result["launches"]

            phase = "train_fused_oracle" if fuse else "train_oracle"
            torch.cuda.empty_cache()
            oracle = train_oracle(torch, fuse)
            emit(oracle)
            if not oracle["ok"]:
                raise AssertionError("%s: the card's training step "
                                     "disagrees with the CPU one" % phase)

        phase = "infer_resnet_fused"
        torch.cuda.empty_cache()
        result = infer_resnet(torch)
        emit(result)
        if not result["ok"]:
            raise AssertionError("%s failed its checks" % phase)
        launches_train[phase] = result["launches"]
        for fused in (False, True):
            phase = "train_resnet_fused" if fused else "train_resnet"
            torch.cuda.empty_cache()
            result = train_resnet(torch, fused)
            emit(result)
            if not result["ok"]:
                raise AssertionError("%s failed its checks" % phase)
            launches_train[phase] = result["launches"]

        phase = "train_resnet_fused_oracle"
        torch.cuda.empty_cache()
        oracle = resnet_oracle(torch)
        emit(oracle)
        if not oracle["ok"]:
            raise AssertionError("%s: the card's training step disagrees "
                                 "with the CPU one" % phase)

        phase = "train_sp"
        torch.cuda.empty_cache()
        result = train_sp(torch)
        emit(result)
        if not result["ok"]:
            raise AssertionError("%s failed its checks" % phase)
        launches_train[phase] = result["launches"]

        phase = "train_sp_oracle"
        torch.cuda.empty_cache()
        oracle = train_sp_oracle(torch)
        emit(oracle)
        if not oracle["ok"]:
            raise AssertionError("%s: the card's sp step disagrees with the "
                                 "CPU sp step or the dense card step"
                                 % phase)
    except Exception as e:
        emit({"phase": phase, "ok": False,
              "error": "%s: %s" % (type(e).__name__, e)})
        traceback.print_exc()
        return 1

    by_name = {}
    for r in rows:
        by_name.setdefault(r["kernel"], []).append(r)
    # one summary row per kernel, at its main path's shape: K1/K2/K3 at
    # the training step's attention, K7 at the full decode batch, K8 at
    # the full decode batch on the slower of the two largest projections
    # (w1 and w2 move the same bytes and FLOPs), K4 at the slowest of the
    # fused step's five projections, K5 at the fused step's seam, K6 as
    # the sum of the ResNet-50 forward's 53 launches, K9 at the slower of
    # the ring's diagonal and off-diagonal folds, K10 at the LM's logits
    m = TRAIN_BATCH * TRAIN_LM["seq_len"]
    shard = "[%d,%d,%d,%d]" % (TRAIN_BATCH, TRAIN_LM["n_head"],
                               TRAIN_LM["seq_len"] // SP,
                               TRAIN_LM["d_model"] // TRAIN_LM["n_head"])
    pick = {"flash_fwd": ["[16,8,2048,128] causal"],
            "flash_bwd_dq": ["[16,8,2048,128] causal"],
            "flash_bwd_dkv": ["[16,8,2048,128] causal"],
            "paged_attention": ["B=16 NB=128 bs=16 H=8 D=128"],
            "matmul_int8": ["M=16 K=1024 N=4096", "M=16 K=4096 N=1024"],
            "matmul_epilogue": ["%s M=%d K=%d N=%d" % (what, m, kk, n)
                                for what, kk, n, _, _ in FUSED_MATMULS],
            "add_ln": ["[%d,%d] affine" % (m, TRAIN_LM["d_model"])],
            "conv_stage": [CONV_FWD],
            "flash_chunk": [shard + " diagonal causal",
                            shard + " non-causal, seeded carry"],
            "fused_ce": ["[%d,%d]" % (m, TRAIN_LM["vocab_size"])]}
    csrc = "paddle_tpu_torch/kernels/csrc/"
    tpu = "paddle_tpu/kernels/"
    meta = {"flash_fwd": (csrc + "flash_fwd.cu",
                          tpu + "flash_attention.py:68"),
            "flash_bwd_dq": (csrc + "flash_bwd.cu",
                             tpu + "flash_attention.py:284"),
            "flash_bwd_dkv": (csrc + "flash_bwd.cu",
                              tpu + "flash_attention.py:307"),
            "paged_attention": (csrc + "paged_attention.cu",
                                tpu + "flash_attention.py:496"),
            "matmul_int8": (csrc + "matmul_int8.cu",
                            tpu + "matmul_fused.py:275"),
            "matmul_epilogue": (csrc + "matmul_fused.cu",
                                tpu + "matmul_fused.py:105"),
            "add_ln": (csrc + "matmul_fused.cu",
                       tpu + "matmul_fused.py:394"),
            "conv_stage": (csrc + "conv_fused.cu",
                           tpu + "conv_fused.py:73"),
            "flash_chunk": (csrc + "flash_chunk.cu",
                            tpu + "flash_attention.py:795"),
            "fused_ce": (csrc + "fused_ce.cu", tpu + "fused.py:29")}
    # launches: each kernel's count on its main path (train_f32 for the
    # flash training kernels, train_fused for K4/K5, train_resnet_fused
    # for K6, train_sp for K9, the int8 tenant's serve run, which runs
    # all three serving kernels, for the rest; K10 is on no path, so 0);
    # every path's count stands beside it
    summary = []
    for name in KERNELS:
        r = max((x for x in by_name[name] if x["shape"] in pick[name]),
                key=lambda x: x["ms"])
        path = ("train_resnet_fused" if name == "conv_stage" else
                "train_sp" if name == "flash_chunk" else
                None if name == "fused_ce" else
                "train_fused" if name in FUSED_KERNELS else
                "train_f32" if name in TRAIN_KERNELS else "serve_int8")
        by_path = {"serve_f32": launches.get(name, 0),
                   "serve_int8": launches8.get(name, 0),
                   **{p: c.get(name, 0) for p, c in launches_train.items()}}
        summary.append({
            "name": name, "route": "cuda", "source": meta[name][0],
            "replaces": meta[name][1],
            "launches": by_path[path] if path else 0,
            "launches_path": path, "launches_by_path": by_path,
            "max_abs_err": max(x["max_abs_err"] for x in by_name[name]),
            "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "ops_rate": r["ops_rate"],
            "library_ms": r["library_ms"], "shape": r["shape"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
