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
             against dense_forward (no paging, no kernels).  The load
             captures every warm bucket as a CUDA graph (5 decode
             buckets (B, 128), 8 prefill buckets 16..2048; ``load``: its
             seconds, the capture's, the memory reserved before and
             after, the warm keys); every prefill and decode step of
             the run must be a graph replay (a miss runs on a covering
             bucket while its own captures in the background), and
             ``paged_calls`` logs the bucket each decode step ran at.
             ``buckets``: one prefill replay at (256,) and one decode
             replay at (8, 128), their launches read from a
             torch.profiler trace by kernel symbol equal to those
             recorded at capture and to the path's (6 K1 a prefill, 6
             K7 calls a decode step, 24 K8 each under int8), and each
             replay equal to its step run eagerly, bit for bit;
5. serve_int8 — the same with quant='int8';
6. batch_invariance — one prompt solo vs inside a batch of 16
             (information, not a gate);
6a. serve_prefix — phase 4's LM, f32 and int8, each loaded again with
             prefix_cache=True (the suffix-prefill ladder 16..2048
             captured too) and served 12 prompts, the second six
             arriving mid-decode: eight share a 768-token system prefix
             (suffixes of 16-512 tokens), two share one of those up to a
             point inside a block (a COW copy), two are unrelated; phase
             4's tenant of the same quant serves the same traffic cold.
             Records the prefix hits, cached tokens, COW copies, index
             nodes, TTFT of both tenants, a suffix prefill's host ms
             (48 and 512 fresh tokens after the system prefix) beside
             the cold prefill of its prompt, the load and the reserved
             memory the ladder added.  Gates: every step a replay and
             some hit ran a suffix prefill; one suffix-prefill replay's
             traced launches (6 K7, no K1, 24 K8 under int8) equal to
             those recorded at capture, and the replay equal to its step
             run eagerly, bit for bit past the scratch block 0; the
             tokens the cold tenant's, where they differ a near-tie (the
             cold path's top-2 margin at that step under the largest
             |delta logit| between the two paths there: else a fault);
             the dense oracle on a hit request;
6b. serve_spec — phase 4's prompts through a speculative tenant (the
             reference's construction, profile_serve.spec_lm: the LM
             with layers 1-5's wo and w2 scaled by 0.002, an f32 draft
             of its layer 0, k = 8), f32 and int8 targets, each beside a
             plain tenant of the same target.  Records rounds, the accept
             rate, draft and verify seconds, tokens/s and ITL of both,
             one propose and one verify replay's ms at (8, 128, k) /
             (8, 128, k + 1).  Gates: every target and draft step a
             replay; the tokens the plain tenant's under the near-tie
             rule; per request, delivered <= 1 + sum(m_i + 1) <=
             delivered + k; a propose replay's traced launches (k K7)
             and a verify replay's (6 K7, 24 K8 under int8) equal to the
             recorded ones, each replay equal to its eager step;
6c. serve_fleet — phase 4's LM on the disaggregated fleet: one prefill
             worker p0 and two decode workers d0, d1 (FleetWorker, f32,
             512 blocks each, warm: p0's prefill ladder, each decode
             worker's whole (B, NB) grid and prefill ladder captured),
             sharing the card over a LocalTransport behind a
             FleetRouter.  Phase 4's 12 prompts (the second six
             arriving mid-decode): p0 prefills (K1), exports the pages,
             and migrates them (MigrateKV) to a decode worker, which
             imports them in place and decodes (K7).  Records tokens/s,
             router TTFT p50 / p90 beside serve_f32's, migrations, dups
             and failures, bytes a migration, export and import ms
             (each synchronised), send-to-ack ms, each worker's load,
             capture seconds and reserved memory, and the copies alone
             on idle engines (export, join, import, staging).  Gates: tokens
             identical to serve_f32's, request by request; every step a
             replay; every request migrated; d0's prefill and decode
             replays and a prefill replay on p0 traced by kernel symbol
             equal to the recorded launches and the path's, each equal
             to its eager step; a prompt's pages imported into d0 after
             its graphs were captured are read by those graphs' replays
             (tokens those of a local prefill, the page tensors' storage
             unchanged); one request over FleetEndpoint /
             SocketTransport on 127.0.0.1 identical; a torn migration
             (fleet_migrate_tear) named kv_migration:<id> and rolled
             back, the request completed by the decode worker's local
             generate, identical, no block stranded; the kill drill: d1
             killed while requests it owns are held in their prompt
             pass (a fleet_prefill delay past the router's lease), every
             request completed with identical tokens, one eviction, at
             least one re-prefill.  Every worker closed after;
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
             at phase 8's bars;
17. infer_resnet_fused_amp — phase 11's is_test fused program under bf16
             AMP (Float16Transpiler, FLAGS_bn_bf16=1): K6's bf16 form 53
             times a forward with its full epilogue, the f32 form never;
             its softmax held against the f32 fused is_test program's on
             the card from the same parameters to INFER_AMP_TOL;
18. train_resnet_amp — phase 12 under bf16 AMP (FLAGS_bn_bf16=1): no K6
             launch, every parameter still float32 after the steps;
19. train_resnet_fused_amp — phase 13 under bf16 AMP: K6's bf16 form 53
             times a step in its statistics form, the f32 form never;
20. train_resnet_fused_amp_oracle — phase 14 under bf16 AMP: the card
             against Executor(CPUPlace()), each fetched tensor (the loss,
             every stage's output, every parameter gradient) held to
             twice the CPU's own spread when every filter moves by one
             bf16 ulp either way (AMP_ORACLE_*);
21. train_amp — phase 7 under bf16 AMP (Float16Transpiler): the flash
             kernels' bf16 forms K1/K2/K3 6 times a step each, their f32
             forms never; every parameter still float32;
22. train_amp_oracle — one AMP step at full width, depth 1, batch 1 on
             the card against Executor(CPUPlace()) from the same
             parameters, each fetched tensor (the loss, the block's
             output, every parameter gradient) held to twice the CPU's
             own spread when every weight matrix moves by one bf16 ulp
             either way (AMP_ORACLE_*), as phase 20;
23. train_fused_amp — phase 9 under bf16 AMP: K1/K2/K3's bf16 forms 6
             times a step each, K4's bf16 form 25 times, K5's 12 times,
             no f32 form of K1-K5;
24. train_fused_amp_oracle — phase 22 for the fused-block program;
24a. train_sp_amp — phase 15 under bf16 AMP: the ring on bf16 Q/K/V,
             K9's bf16 form and K2/K3's bf16 forms 60 times a step each,
             no f32 form of K1/K2/K3/K9; every parameter still float32;
24b. train_sp_amp_oracle — one sp AMP step at full width, depth 1,
             batch 1 on the card's 4-shard mesh against the same step
             on a 4-shard CPU mesh and against the dense AMP program's
             step on the card, from the same parameters: each fetched
             tensor (the loss, the block's output, every parameter
             gradient) within twice the CPU sp step's own spread when
             every weight matrix moves by one bf16 ulp either way
             (AMP_ORACLE_*), as phase 22; 10 launches of each bf16 form;
25-28. train_resnet_amp_prepared, train_resnet_fused_amp_prepared,
             train_fused_amp_prepared, train_amp_prepared — phases 18,
             19, 23 and 21 through Executor.prepare / run_prepared, the
             step captured as one CUDA graph (core/step_graph.py) at the
             first step and replayed once a step: startup, prepare with
             the batch, 1 warm-up and the timed steps; each launches
             the kernels of its run() phase as often a step (the
             wrappers' calls recorded at capture and added per replay,
             and the launches TRACED_REPLAYS replays make, read from a
             torch.profiler trace by kernel symbol), and from
             one copied scope its 3 prepared steps agree with 3 run()
             steps on the losses and every persistable, bit for bit
             where run() is bit-identical run to run, else each tensor
             within twice run()'s own run-to-run spread (never below
             ORACLE_GRAD_RTOL); the step p50 and peak memory beside
             the run() phase's;
29. bench — the port's bench entry (python3 -m
             paddle_tpu_torch.tools.bench), prepared by default, at its
             default headline (ResNet-50, bf16 AMP, NCHW, batch 256,
             with its secondary, the flagship LM, which must be the bf16
             LM), then (information) with BENCH_PREPARED=0 (run()), and
             with BENCH_LAYOUT=NHWC (no secondary), each with
             BENCH_ITERS=10, then (information) at BENCH_AMP=0
             BENCH_LAYOUT=NHWC beside phase 13's step, then
             BENCH_MODEL=transformer at its card default (bf16),
             unfused and BENCH_FUSED_TRANSFORMER=1; each must exit 0
             with finite losses, the last below the first, float32
             parameters, under AMP an mfu, and every timed step
             prepared (``prepared`` true) but in the BENCH_PREPARED=0
             run.

Phases 18-29 (24a among them) each check that every loss is finite,
the last below the first, and every parameter still float32.

Phase 3 holds K8 against its plain version at the flagship layer's
four projections at every decode bucket M = 1..16 (the decode kernel,
``form`` "decode") and at the prefill buckets M = 1024 and 2048 (the
split-TF32 GEMM tile of csrc/gemm_tile.cuh: "tile 128x64" where its
blocks give every SM one, else "tile 64x64"), and checks that prefill
rows are batch-invariant (64-row calls give the M = 1024 call's rows
bit for bit); K4 at the fused step's five projections at M = 16 x 2048
(all "tile 128x64"); K6 (an implicit GEMM on the same tile, all
"mma.sync 128x64") against its plain version at each of the path's 20
conv shapes at batch 256 (statistics form; the five heaviest also with
affine + residual + relu) and at every epilogue combination
on ragged shapes and at the path's widths (K = 4608, a Co = 64 3x3
stage at 56 x 56, the stem at 224 x 224); K9 at the ring's shard
[16, 8, 512, 128] (the diagonal causal fold, a non-causal fold from a
carry seeded by an earlier one, a half-masked and a wholly masked
block, the last bit-identical to its carry), in f32 and in its bf16
form (``flash_chunk_bf16``: bf16 q, k, v, the f32 carry at ATOL /
RTOL, the wgmma forward of csrc/flash_bf16.cuh with its carry policy,
bound at the dense bf16 peak with its bytes counted at 2 bytes a q, k,
v element and 4 a carry element, bound_split_ms its 3 products as run);
K6's bf16 form
(``conv_stage_bf16``: for Ci % 8 == 0 the wgmma tile of
csrc/wgmma_gemm.cuh with x loaded by TMA's im2col mode, ``form``
"wgmma 128x128" or "wgmma 128x64"; the stem on the mma.sync tile,
"mma.sync 128x64"; held to one bf16 ulp of its plain version on Y and
to STATS_RTOL on the sums) at the same 20 shapes (statistics form; the
five heaviest also with the full epilogue), against F.conv2d on
channels_last bf16 (cuDNN) with the sums in torch, bound at the dense
bf16 peak, and at every epilogue combination on ragged shapes; K2/K3
and their bf16 forms at that shape, non-causal and the causal diagonal
(the ring's backward steps; bf16 within one ulp plus 2**-12 of max
|plain|); K10, which no path runs, at the
LM's logits [32768, 8192]; the bf16 forms of K1/K2/K3 at [1, 8, 256,
128] and [16, 8, 2048, 128] causal (out and the gradients within one
bf16 ulp of the plain value plus 2**-12 of the tensor's max |plain|, the
LSE at ATOL / RTOL; K1's bf16 form is the wgmma kernel of
flash_bf16.cuh (built in flash_fwd.cu), K2's and K3's those of
flash_bwd.cu; their bounds count
the function's products, and bound_split_ms those run with P and dS
split into hi + lo: K1 3, K2 4, K3 6), K4's
(the wgmma tile of csrc/wgmma_gemm.cuh) at the five
projections at M = 16 x 2048 and at every epilogue on ragged M, N and K
and at K = 4096 (out and pre within one ulp plus 1e-6 of max |Y| of the
plain version that rounds once), K5's at [32768, 1024] (Sum exact, out,
mean and var within one ulp), all bound at the dense bf16 peak with
2-byte elements.  The build phase fails if ptxas reports a spill in a
wgmma kernel (WGMMA_KERNELS).  K7 (each row's live pages in spans of
``paged_span_pages()`` pages, streamed through a cp.async ring, the spans
folded in order by a second launch) at the decode batch B = 16, NB =
128 over a 512-page pool with mixed lengths (its bytes bound counts a
page that two rows share once), whose rows must be bit for
bit the same computed alone in their own block-count bucket (a gate,
``rows_invariant``), and on distinct pages (a pool of B x NB + 1) at
B = 1 with 2048 tokens, B = 16 with 1024 each, B = 4 at NB = 64 with
16-1024 and B = 16 at NB = 8 with at most 128 (one span a row); at the
suffix prefill's shape (256 rows of one sequence over 645-900
positions) and the verify's (144 rows, 16 sequences of ~1,030, 9 rows
each); K8 also at M = 64 and 256 (the suffix and verify buckets).

Then the kernels' summary line, the nvidia-smi line, and as the last
line {"ok": true, "device": {...}}.  Any failed phase exits non-zero
without that line; so does a run without CUDA or outside the repository.
"""
from __future__ import annotations

import hashlib
import json
import math
import os
import re
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
# infer_resnet_fused_amp: the AMP is_test softmax against the f32 one on
# the card.  bf16 rounds every stage's activations to 2**-9, and 53
# stages at the seeded initialization carry that to the probabilities:
# on the CPU (paddle_tpu_torch/tools/amp_spread.py --infer-batch: depth
# 50, the batch's own BN statistics) the AMP softmax sits 0.037 (batch
# 4), 0.048 (batch 16) and 0.067 (batch 16, seed 1) from the f32 one at
# most; the bar is twice the largest reading
INFER_AMP_TOL = 0.13
# train_resnet_fused_amp_oracle: under bf16 one ulp on every filter
# moves the depth-50 step by percents at the first stages and by
# O(100 %) at the last stages and in the gradients (amp_spread.py at
# batch 2, seeds 0 and 1: loss 2.0-4.2 %, first stage 1.0 %, last 74-76
# %, gradients 166-181 % at worst and 139-141 % at the median, in
# relative Frobenius norm), so each
# fetched tensor is held to AMP_ORACLE_SPREAD times its own CPU spread
# (the larger of one ulp up and one ulp down), never below
# ORACLE_GRAD_RTOL; a loss spread above AMP_ORACLE_LOSS_SPREAD_MAX fails
# the phase
AMP_ORACLE_SPREAD = 2.0
AMP_ORACLE_LOSS_SPREAD_MAX = 0.05
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
# bf16 products on the tensor cores, dense (NVIDIA data sheet, H100 SXM)
BF16_FLOPS = 989.4e12
# the bf16 kernel forms, bound by BF16_FLOPS
BF16_KERNELS = ("conv_stage_bf16", "flash_fwd_bf16", "flash_bwd_dq_bf16",
                "flash_bwd_dkv_bf16", "matmul_epilogue_bf16", "add_ln_bf16",
                "flash_chunk_bf16")
# the flash kernels' bf16 forms against their plain versions: one bf16
# rounding of two f32 results that differ in summation order (and in
# the bf16 hi + lo split of P and dS, 2**-17 relative a term), so
# within one bf16 ulp of the plain value, plus 2**-12 of the tensor's
# max |plain| for values that are small sums of large terms
FLASH_BF16_FLOOR = 2.0 ** -12
# the symbols of the wgmma kernels (the bf16 forms of K4, K6, K1, K2,
# K3 and K9), whose accumulators must stay in registers: ptxas may report
# no spill
WGMMA_KERNELS = ("gemm_bf16_kernel", "conv_wgmma_kernel",
                 "flash_fwd_bf16_kernel", "flash_bwd_dq_bf16_kernel",
                 "flash_bwd_dkv_bf16_kernel", "flash_chunk_bf16_kernel")
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
    if name in BF16_KERNELS:
        return "bf16", BF16_FLOPS
    return "f32", F32_FLOPS


def compare(torch, got, want):
    if got.dtype == torch.bfloat16:
        return compare_bf16(torch, got, want)
    err = (got.double() - want.double()).abs()
    ok = bool((err <= ATOL + RTOL * want.double().abs()).all())
    return float(err.max()), ok


def compare_bf16(torch, got, want, floor=1e-6):
    """A bf16 output against its plain version: each value is one
    rounding of two f32 sums that differ only in order, so within one
    bf16 ulp of the plain value, plus ``floor`` of max |plain|."""
    from paddle_tpu_torch.kernels.conv_fused import within_bf16_ulp

    return within_bf16_ulp(got, want, floor)


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
    from paddle_tpu_torch.kernels.matmul_fused import (
        add_ln, add_ln_reference, dequantize_weight, matmul_epilogue,
        matmul_epilogue_reference, matmul_int8_dequant,
        matmul_int8_reference, quantize_weight, tile_form)

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    dev = "cuda"
    rows, bad = [], []

    def record(name, shape, err, ok, ms, plain_ms, lib_ms, nbytes, flops,
               split_flops=None):
        # split_flops: the operations as run where the kernel splits an
        # f32 operand into bf16 hi + lo, for bound_split_ms beside the
        # function's bound_ms
        rate_name, rate = ops_rate(name)
        b_ms, by = bound_ms(nbytes, flops, rate)
        rows.append({"kernel": name, "shape": shape, "max_abs_err": err,
                     "ok": ok, "ms": ms, "plain_ms": plain_ms,
                     "library_ms": lib_ms, "bound_ms": b_ms,
                     "bound_by": by, "ops_rate": rate_name})
        if split_flops is not None:
            rows[-1]["bound_split_ms"] = bound_ms(nbytes, split_flops,
                                                  rate)[0]
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
    check_slice18_rows(torch, timer, record)

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

    check_conv(torch, timer, gen, record, bad, rows, torch.float32)
    check_conv(torch, timer, gen, record, bad, rows, torch.bfloat16)
    check_lm_bf16(torch, timer, gen, record, bad)
    return rows, bad


def check_lm_bf16(torch, timer, gen, record, bad):
    """The bf16 forms of K1-K5 (the LM under AMP) at K1-K5's f32 rows'
    shapes: K1/K2/K3 at [1, 8, 256, 128] and [16, 8, 2048, 128] causal
    against SDPA in bf16 (and its backward); K4 at the fused step's five
    projections at M = 16 x 2048 against torch.addmm in bf16 plus the
    tail, and every epilogue on ragged shapes; K5 at [16 x 2048, 1024]
    against x + y and F.layer_norm in bf16.  The library calls are timed
    only."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.flash_attention import (
        attention_reference, flash_attention_bwd,
        flash_attention_bwd_reference, flash_bwd_dkv_bf16, flash_bwd_dq_bf16,
        flash_delta, flash_fwd_bf16)
    from paddle_tpu_torch.kernels.matmul_fused import (
        add_ln_bf16, add_ln_reference, apply_act, matmul_epilogue_bf16,
        matmul_epilogue_f32acc_reference)
    from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

    dev, bf = "cuda", torch.bfloat16
    h, d = 8, 128
    scale = 1.0 / math.sqrt(d)

    def flash_cmp(got, want):
        return compare_bf16(torch, got, want, FLASH_BF16_FLOOR)

    for b_, s in ((1, 256), (16, 2048)):
        shape = "[%d,8,%d,128] causal" % (b_, s)
        q, k, v, do = (torch.randn(b_, h, s, d, device=dev, generator=gen)
                       .to(bf) for _ in range(4))
        out, lse = flash_fwd_bf16(q, k, v, causal=True)
        ref_out, ref_lse = attention_reference(q, k, v, scale, True)
        e1, ok1 = flash_cmp(out, ref_out)
        e2, ok2 = compare(torch, lse, ref_lse)
        record("flash_fwd_bf16", shape, max(e1, e2), ok1 and ok2,
               timer(lambda: flash_fwd_bf16(q, k, v, causal=True)),
               timer(lambda: attention_reference(q, k, v, scale, True)),
               timer(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True)),
               2 * b_ * 4 * h * s * d + 4 * b_ * h * s,
               4 * b_ * h * d * s * (s + 1) // 2,
               6 * b_ * h * d * s * (s + 1) // 2)   # S, P_hi V, P_lo V
        del out, lse
        delta = flash_delta(do, ref_out)
        want = flash_attention_bwd_reference(q, k, v, ref_out, ref_lse, do,
                                             scale, True)
        got = flash_attention_bwd(q, k, v, ref_out, ref_lse, do,
                                  causal=True)
        errs = [flash_cmp(a, w) for a, w in zip(got, want)]
        plain_ms = timer(lambda: flash_attention_bwd_reference(
            q, k, v, ref_out, ref_lse, do, scale, True), iters=5)
        del got, want
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_ms = timer(lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do, retain_graph=True))
        del o_lib, qg, kg, vg
        tile = b_ * h * d * s * (s + 1) // 2 * 2     # one causal product
        io = 2 * b_ * h * s * d
        # the function's products (K2: S, dP, dS K; K3: S^T, dP^T, P^T dO,
        # dS^T Q), and as run, where P and dS split into bf16 hi + lo
        # take two exact products each
        record("flash_bwd_dq_bf16", shape, errs[0][0], errs[0][1],
               timer(lambda: flash_bwd_dq_bf16(q, k, v, do, ref_lse, delta,
                                               scale, True)),
               plain_ms, lib_ms, 5 * io + 8 * b_ * h * s, 3 * tile, 4 * tile)
        record("flash_bwd_dkv_bf16", shape, max(errs[1][0], errs[2][0]),
               errs[1][1] and errs[2][1],
               timer(lambda: flash_bwd_dkv_bf16(q, k, v, do, ref_lse, delta,
                                                scale, True)),
               plain_ms, lib_ms, 6 * io + 8 * b_ * h * s, 4 * tile, 6 * tile)
        del q, k, v, do, ref_out, ref_lse, delta
    torch.cuda.empty_cache()

    # K4: the fused step's five projections at M = 16 * 2048, bf16
    m = TRAIN_BATCH * TRAIN_LM["seq_len"]
    for what, kk, n, with_bias, act in FUSED_MATMULS:
        x = torch.randn(m, kk, device=dev, generator=gen).to(bf)
        w = (torch.randn(kk, n, device=dev, generator=gen)
             * kk ** -0.5).to(bf)
        bias = torch.randn(n, device=dev, generator=gen).to(bf) \
            if with_bias else None
        got = matmul_epilogue_bf16(x, w, bias, None, act)
        err, ok = compare_bf16(torch, got, matmul_epilogue_f32acc_reference(
            x, w, bias, None, act)[0])
        del got

        def lib(x=x, w=w, bias=bias, act=act):
            y = torch.addmm(bias, x, w) if bias is not None else \
                torch.matmul(x, w)
            return apply_act(y, act)

        record("matmul_epilogue_bf16", "%s M=%d K=%d N=%d" % (what, m, kk, n),
               err, ok,
               timer(lambda: matmul_epilogue_bf16(x, w, bias, None, act)),
               timer(lambda: matmul_epilogue_f32acc_reference(
                   x, w, bias, None, act)),
               timer(lib),
               2 * (m * kk + kk * n + m * n + (n if with_bias else 0)),
               2 * m * kk * n)
        del x, w, bias
    torch.cuda.empty_cache()
    # every epilogue (act x bias x residual, out and pre) on ragged M, N
    # and K (multiples of 8 but not of the 128 x 256 tile or the 64-deep
    # K tile), and at K = 4096
    for m_, kk, n in ((1000, 1024, 1000), (333, 264, 1000), (17, 72, 24),
                      (129, 72, 136), (255, 4096, 136)):
        x = torch.randn(m_, kk, device=dev, generator=gen).to(bf)
        w = (torch.randn(kk, n, device=dev, generator=gen)
             * kk ** -0.5).to(bf)
        bias = torch.randn(n, device=dev, generator=gen).to(bf)
        res = torch.randn(m_, n, device=dev, generator=gen).to(bf)
        for act in ("", "relu", "gelu"):
            for b_, r_ in ((None, None), (bias, None), (bias, res),
                           (None, res)):
                got = matmul_epilogue_bf16(x, w, b_, r_, act,
                                           save_preact=True)
                want = matmul_epilogue_f32acc_reference(x, w, b_, r_, act)
                for got_, want_, part in zip(got, want, ("out", "pre")):
                    err, ok = compare_bf16(torch, got_, want_)
                    if not ok:
                        bad.append("matmul_epilogue_bf16 M=%d K=%d N=%d "
                                   "act=%r bias=%s residual=%s %s (max abs "
                                   "err %g)" % (m_, kk, n, act,
                                                b_ is not None,
                                                r_ is not None, part, err))

    # K5: [16 * 2048, 1024] with scale and bias; Sum exact, the rest
    # within one bf16 ulp
    d = TRAIN_LM["d_model"]
    x, y = (torch.randn(m, d, device=dev, generator=gen).to(bf)
            for _ in range(2))
    scale = torch.rand(d, device=dev, generator=gen) + 0.5
    bias = torch.randn(d, device=dev, generator=gen)
    got = add_ln_bf16(x, y, scale, bias)
    want = add_ln_reference(x, y, scale, bias)
    err = max(float((a.float() - b_.float()).abs().max())
              for a, b_ in zip(got, want))
    ok = torch.equal(got[1], want[1]) and all(
        bool(((a.float() - b_.float()).abs() <= bf16_ulp(b_)).all())
        for a, b_ in zip((got[0], got[2], got[3]),
                         (want[0], want[2], want[3])))
    del got, want
    sb, bb = scale.to(bf), bias.to(bf)
    record("add_ln_bf16", "[%d,%d] affine" % (m, d), err, ok,
           timer(lambda: add_ln_bf16(x, y, scale, bias)),
           timer(lambda: add_ln_reference(x, y, scale, bias)),
           timer(lambda: F.layer_norm(x + y, (d,), sb, bb)),
           2 * (4 * m * d + 2 * m) + 4 * 2 * d, 8 * m * d)
    # ragged rows and D = 8 .. 1024
    for m_, d_ in ((77, 8), (50, 264), (1000, 1024)):
        x, y = (torch.randn(m_, d_, device=dev, generator=gen).to(bf)
                for _ in range(2))
        sc = torch.rand(d_, device=dev, generator=gen) + 0.5
        bi = torch.randn(d_, device=dev, generator=gen)
        for s_, b_ in ((sc, bi), (None, None)):
            got = add_ln_bf16(x, y, s_, b_)
            want = add_ln_reference(x, y, s_, b_)
            if not (torch.equal(got[1], want[1]) and all(
                    bool(((a.float() - w.float()).abs()
                          <= bf16_ulp(w)).all())
                    for a, w in zip((got[0], got[2], got[3]),
                                    (want[0], want[2], want[3])))):
                bad.append("add_ln_bf16 [%d,%d] affine=%s" % (
                    m_, d_, s_ is not None))
    del x, y
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


# K6's ragged shapes (N, H, Ci, Co, k, stride, pad), every epilogue
# combination: M not a multiple of the tile, the stem (Ci = 3: f32's
# 4-byte gather; bf16 padded to 4 channels for mma.sync's 8-byte one), a
# 16-byte-gather 3x3 stage, then the path's widths (K = 4608 with M =
# 196, a Co = 64 3x3 stage, the full stem); bf16 also Ci = 12 (its
# 8-byte gather), Ci = 40 (each tap's 64-channel im2col box past Ci), a
# strided 1x1 at ragged M, a 7 x 7 3x3 at K = 4608 and M = 98, and a
# Co = 64 1x1 at ragged M (the wgmma form's 128 x 64 tile)
CONV_RAGGED = {"float32": ((3, 23, 3, 64, 7, 2, 3), (2, 9, 64, 128, 3, 1, 1),
                           (4, 7, 512, 512, 3, 1, 1),
                           (2, 56, 64, 64, 3, 1, 1),
                           (2, 224, 3, 64, 7, 2, 3)),
               "bfloat16": ((3, 23, 3, 64, 7, 2, 3), (2, 9, 12, 64, 3, 1, 1),
                            (1, 5, 40, 256, 3, 1, 1),
                            (4, 7, 512, 512, 3, 1, 1),
                            (2, 224, 3, 64, 7, 2, 3),
                            (3, 9, 256, 512, 1, 2, 0),
                            (2, 7, 512, 512, 3, 1, 1),
                            (3, 11, 256, 64, 1, 1, 0))}


def check_conv(torch, timer, gen, record, bad, rows, dtype):
    """K6 in its ``dtype`` form (float32: split-TF32, ``conv_stage``;
    bfloat16: ``conv_stage_bf16``) at every conv stage of the ResNet-50
    forward at batch 256, in the training form (raw conv + per-channel
    sums); the five heaviest (launches x FLOPs) also in the inference
    form (BN affine + residual + relu); then every epilogue combination
    on CONV_RAGGED.  The yardstick is F.conv2d on channels_last tensors
    of ``dtype`` (cuDNN, TF32 off) plus the same epilogue and f32 sums in
    torch; the bound counts ``dtype``'s bytes and conv_min_flops at
    ``ops_rate``."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.conv_fused import (
        conv2d_nhwc, conv2d_nhwc_reference, conv_stage_form)

    bf16 = dtype == torch.bfloat16
    name = "conv_stage_bf16" if bf16 else "conv_stage"
    esize = 2 if bf16 else 4
    dev, nb = "cuda", RESNET_BATCH
    shapes = conv_stage_shapes()
    order = sorted(shapes, key=lambda c: -shapes[c] * conv_flops(nb, c))
    heavy = order[:5]
    fwd = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    fwd_err, bound_by = 0.0, {"bytes": 0.0, "operations": 0.0}
    for shp in order:
        h, ci, co, k, s, p = shp
        ho = (h + 2 * p - k) // s + 1
        x = torch.randn(nb, h, h, ci, device=dev, generator=gen).to(dtype)
        w = (torch.randn(k, k, ci, co, device=dev, generator=gen) *
             (k * k * ci) ** -0.5).to(dtype)
        xcl = x.permute(0, 3, 1, 2)                  # channels_last
        wcl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        a = torch.rand(co, device=dev, generator=gen) + 0.5
        b = torch.randn(co, device=dev, generator=gen)
        r = torch.randn(nb, ho, ho, co, device=dev, generator=gen).to(dtype)
        rcl = r.permute(0, 3, 1, 2)
        modes = [("stats", dict(stats=True))]
        if shp in heavy:
            modes.append(("affine+residual+relu",
                          dict(affine=(a, b), residual=r, act="relu")))
        for mode, kw in modes:
            def lib(kw=kw):
                y = F.conv2d(xcl, wcl, None, s, p)
                if kw.get("stats"):
                    return y, y.sum((0, 2, 3), dtype=torch.float32), \
                        torch.square(y.float()).sum((0, 2, 3))
                return torch.relu(y * a[:, None, None] + b[:, None, None]
                                  + rcl).to(dtype)

            got = conv2d_nhwc(x, w, (s, s), (p, p), **kw)
            want = conv2d_nhwc_reference(x, w, (s, s), (p, p), **kw)
            err, ok, rel = conv_compare(torch, got, want, x, w, s, p)
            del got, want
            # bytes: the rows of x the conv reads (a strided 1x1 skips
            # the rest), w, the output, and the sums or (a, b, residual)
            rows_x = min(h, ho * min(k, s) + max(k - s, 0))
            out_b = esize * nb * ho * ho * co
            nbytes = esize * (nb * rows_x * rows_x * ci + w.numel()) + \
                out_b + (8 * co if mode == "stats" else 8 * co + out_b)
            row = {"ms": timer(lambda: conv2d_nhwc(x, w, (s, s), (p, p),
                                                   **kw)),
                   "plain_ms": timer(lambda: conv2d_nhwc_reference(
                       x, w, (s, s), (p, p), **kw)),
                   "library_ms": timer(lib)}
            record(name, "%s x%d %s" % (conv_shape_str(shp), shapes[shp],
                                        mode),
                   err, ok, row["ms"], row["plain_ms"], row["library_ms"],
                   nbytes, conv_min_flops(nb, shp))
            rows[-1]["stats_rel_err"] = rel
            # the form the launcher ran (bf16 x is padded to 4 channels)
            rows[-1]["form"] = conv_stage_form(
                ci + (-ci) % 4 if bf16 else ci, co, dtype)
            if mode == "stats":
                row["bound_ms"] = rows[-1]["bound_ms"]
                for key in fwd:
                    fwd[key] += shapes[shp] * row[key]
                fwd_err = max(fwd_err, err)
                bound_by[rows[-1]["bound_by"]] += shapes[shp] * row[
                    "bound_ms"]
        del x, w, xcl, wcl, r, rcl
        torch.cuda.empty_cache()
    # the whole forward's K6 work: each shape's times by its launches;
    # its bound is bytes or operations as most of it is
    rows.append({"kernel": name, "shape": CONV_FWD_BF16 if bf16
                 else CONV_FWD, "max_abs_err": fwd_err, "ok": True, **fwd,
                 "bound_by": max(bound_by, key=bound_by.get),
                 "ops_rate": ops_rate(name)[0]})
    for n_, h, ci, co, k, s, p in CONV_RAGGED[str(dtype)[6:]]:
        ho = (h + 2 * p - k) // s + 1
        x = torch.randn(n_, h, h, ci, device=dev, generator=gen).to(dtype)
        w = (torch.randn(k, k, ci, co, device=dev, generator=gen) *
             (k * k * ci) ** -0.5).to(dtype)
        ab = (torch.rand(co, device=dev, generator=gen) + 0.5,
              torch.randn(co, device=dev, generator=gen))
        r = torch.randn(n_, ho, ho, co, device=dev, generator=gen).to(dtype)
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
                                "%s N=%d %s stats=%s affine=%s "
                                "residual=%s act=%r (max abs err %g, stats "
                                "rel err %s)"
                                % (name, n_,
                                   conv_shape_str((h, ci, co, k, s, p)),
                                   stats, affine is not None,
                                   res is not None, act, err, rel))
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def check_ring_kernels(torch, timer, gen, record, bad):
    """K9 at the ring's shard of the training step at sp = 4, q, k, v
    [16, 8, 512, 128], in f32 and (``flash_chunk_bf16``, the sp LM under
    AMP) on bf16 q/k/v with the f32 carry: the diagonal causal fold from
    a fresh carry, a non-causal fold from the carry it left, a
    half-masked block (k_offset 256) and a wholly masked one (k_offset
    512), which must leave its carry bit-identical; then K2/K3 at that
    shape, f32 and bf16, non-causal (the ring's off-diagonal backward
    steps) and causal (its diagonal).  K9's yardstick is SDPA over the
    same block with the same mask, in the operands' dtype: not the same
    function (it normalizes and keeps no carry), a point of
    reference."""
    import torch.nn.functional as F

    from paddle_tpu_torch.kernels.flash_attention import (
        NEG_INF, attention_reference, chunk_update_reference,
        flash_attention_bwd_reference, flash_attention_chunk,
        flash_bwd_dkv, flash_bwd_dq, flash_delta)

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
    pos = torch.arange(s, device=dev)
    for name, dt in (("flash_chunk", torch.float32),
                     ("flash_chunk_bf16", torch.bfloat16)):
        qx, kx, vx, k2x, v2x = (x.to(dt) for x in (q, k, v, k2, v2))
        seeded = flash_attention_chunk(qx, kx, vx, *fresh, causal=True)
        size = 2 if dt == torch.bfloat16 else 4
        for what, kv, carry, causal, off in (
                ("diagonal causal", (kx, vx), fresh, True, 0),
                ("non-causal, seeded carry", (k2x, v2x), seeded, False, 0),
                ("causal k_offset %d (half masked)" % (s // 2), (k2x, v2x),
                 fresh, True, s // 2),
                ("causal k_offset %d (wholly masked), seeded carry" % s,
                 (k2x, v2x), seeded, True, s)):
            got = flash_attention_chunk(qx, *kv, *carry, causal=causal,
                                        k_offset=off)
            want = chunk_update_reference(qx, *kv, *carry, scale, causal,
                                          off)
            errs = [compare(torch, a, w_) for a, w_ in zip(got, want)]
            ok = all(o for _, o in errs)
            if causal and off >= s and not all(
                    torch.equal(a, c_) for a, c_ in zip(got, carry)):
                bad.append("%s: a wholly masked block changed the carry"
                           % name)
            del got, want
            # what this block's data needs: the scores to compute, the q
            # rows with a live key and the k/v rows with a live query (in
            # the operands' dtype), the f32 carry read and written whole
            # (dead rows copy theirs through)
            mask = pos[:, None] >= off + pos[None, :] if causal else None
            live = int(mask.sum()) if causal else s * s
            rows_q = int(mask.any(1).sum()) if causal else s
            rows_k = int(mask.any(0).sum()) if causal else s
            record(name, "%s %s" % (shape, what), max(e for e, _ in errs),
                   ok,
                   timer(lambda: flash_attention_chunk(
                       qx, *kv, *carry, causal=causal, k_offset=off)),
                   timer(lambda: chunk_update_reference(
                       qx, *kv, *carry, scale, causal, off)),
                   timer(lambda: F.scaled_dot_product_attention(
                       qx, *kv, attn_mask=mask if off else None,
                       is_causal=causal and not off)),
                   size * b * h * d * (rows_q + 2 * rows_k)
                   + 4 * 2 * (2 * b * h * s + b * h * s * d),
                   4 * b * h * d * live,
                   # the bf16 form as run: S, P_hi V and P_lo V
                   6 * b * h * d * live if dt == torch.bfloat16 else None)
        del seeded
    del fresh, k2, v2

    # K2/K3 from the saved lse at the shard shape, f32 and bf16:
    # non-causal (the ring's off-diagonal steps) and causal (its diagonal
    # step); the bf16 forms within one bf16 ulp plus FLASH_BF16_FLOOR
    do = torch.randn(b, h, s, d, device=dev, generator=gen)
    for dt, suffix in ((torch.float32, ""), (torch.bfloat16, "_bf16")):
        qx, kx, vx, dox = (x.to(dt) for x in (q, k, v, do))
        for causal, what in ((False, " non-causal"),
                             (True, " diagonal causal")):
            out, lse = attention_reference(qx, kx, vx, scale, causal)
            delta = flash_delta(dox, out)
            want = flash_attention_bwd_reference(qx, kx, vx, out, lse, dox,
                                                 scale, causal)
            got = (flash_bwd_dq(qx, kx, vx, dox, lse, delta, scale, causal),
                   *flash_bwd_dkv(qx, kx, vx, dox, lse, delta, scale,
                                  causal))
            errs = [compare_bf16(torch, a, w_, FLASH_BF16_FLOOR) if suffix
                    else compare(torch, a, w_) for a, w_ in zip(got, want)]
            plain_ms = timer(lambda: flash_attention_bwd_reference(
                qx, kx, vx, out, lse, dox, scale, causal), iters=5)
            del got, want
            qg, kg, vg = (x.detach().requires_grad_() for x in (qx, kx, vx))
            o_lib = F.scaled_dot_product_attention(qg, kg, vg,
                                                   is_causal=causal)
            lib_ms = timer(lambda: torch.autograd.grad(
                o_lib, (qg, kg, vg), dox, retain_graph=True))
            del o_lib, qg, kg, vg
            # one product over the scores the mask leaves live; the bf16
            # forms as run, with P and dS split into hi + lo: K2 4, K3 6
            tile = 2 * b * h * d * (s * (s + 1) // 2 if causal else s * s)
            io = (2 if suffix else 4) * b * h * s * d
            record("flash_bwd_dq" + suffix, shape + what, errs[0][0],
                   errs[0][1],
                   timer(lambda: flash_bwd_dq(qx, kx, vx, dox, lse, delta,
                                              scale, causal)),
                   plain_ms, lib_ms, 5 * io + 8 * b * h * s, 3 * tile,
                   4 * tile if suffix else None)
            record("flash_bwd_dkv" + suffix, shape + what,
                   max(errs[1][0], errs[2][0]), errs[1][1] and errs[2][1],
                   timer(lambda: flash_bwd_dkv(qx, kx, vx, dox, lse, delta,
                                               scale, causal)),
                   plain_ms, lib_ms, 6 * io + 8 * b * h * s, 4 * tile,
                   6 * tile if suffix else None)
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


def check_slice18_rows(torch, timer, record):
    """K7 and K8 at the call shapes of the suffix prefill and the
    speculative verify: K7 with 256 rows of one sequence of 900
    positions (row i attends over 645 + i of them: a suffix of 256
    after a cached prefix of 644), and with the verify's 144 rows, 16
    sequences of 1,000-1,059 positions with k + 1 = 9 rows each (row j
    over c + j + 1); the tables are each row's sequence's, 128 slots
    wide, in one pool of 16 x 128 + 1 pages.  K8 at M = 64 and 256 for
    the flagship layer's four (K, N).  Its own seeds, so the other
    kernels' inputs stay as they were."""
    import numpy as np

    from paddle_tpu_torch.kernels.flash_attention import (
        paged_attention, paged_attention_reference)
    from paddle_tpu_torch.kernels.matmul_fused import (
        dequantize_weight, matmul_int8_dequant, matmul_int8_reference,
        quantize_weight, tile_form)

    rng = np.random.RandomState(SEED + 18)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 18)
    h, d, bs, nb = 8, 128, 16, 128
    scale = d ** -0.5
    n_pages = 16 * nb + 1
    kp = torch.randn(n_pages, bs, h, d, device="cuda", generator=gen)
    vp = torch.randn(n_pages, bs, h, d, device="cuda", generator=gen)
    ids = rng.permutation(np.arange(1, n_pages)).reshape(16, nb)
    suffix = np.full(256, 0)
    verify = rng.randint(1000, 1060, 16)
    for what, seq_of_row, lens_np in (
            ("suffix prefill S=256 of one sequence, 645-900 positions",
             suffix, 645 + np.arange(256)),
            ("verify B=16 k+1=9, 144 rows, 1,001-1,068 positions",
             np.repeat(np.arange(16), 9),
             np.repeat(verify, 9) + np.tile(np.arange(1, 10), 16))):
        ctx = np.zeros(16, np.int64)
        np.maximum.at(ctx, seq_of_row, lens_np)
        live = np.arange(nb)[None] < -(-ctx[:, None] // bs)
        tables_np = np.where(live, ids, 0).astype(np.int32)[seq_of_row]
        tables = torch.from_numpy(tables_np).cuda()
        lens = torch.from_numpy(lens_np.astype(np.int32)).cuda()
        q = torch.randn(len(lens_np), h, d, device="cuda", generator=gen)
        err, ok = compare(torch, paged_attention(q, kp, vp, tables, lens),
                          paged_attention_reference(q, kp, vp, tables, lens,
                                                    scale))
        record("paged_attention", what, err, ok,
               timer(lambda: paged_attention(q, kp, vp, tables, lens)),
               timer(lambda: paged_attention_reference(q, kp, vp, tables,
                                                       lens, scale)),
               timer(lambda: paged_library(torch, q, kp, vp, tables, lens,
                                           scale)),
               paged_bytes(tables_np, lens_np, h, d),
               4 * int(lens_np.sum()) * h * d)
        del q, tables, lens
        torch.cuda.empty_cache()
    del kp, vp
    for kk, n in ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024)):
        w = (rng.randn(kk, n) * 0.1).astype(np.float32)
        qn, sn, chunk = quantize_weight(w)
        wq = torch.from_numpy(qn).cuda()
        sc = torch.from_numpy(sn).cuda()
        wd = dequantize_weight(wq, sc, chunk)
        for m in (64, 256):
            x = torch.randn(m, kk, device="cuda", generator=gen)
            err, ok = compare(torch, matmul_int8_dequant(x, wq, sc, chunk),
                              matmul_int8_reference(x, wq, sc, chunk))
            record("matmul_int8", "M=%d K=%d N=%d" % (m, kk, n), err, ok,
                   timer(lambda: matmul_int8_dequant(x, wq, sc, chunk)),
                   timer(lambda: matmul_int8_reference(x, wq, sc, chunk)),
                   timer(lambda: torch.matmul(x, wd)),
                   4 * m * kk + kk * n + 4 * (kk // chunk) * n + 4 * m * n,
                   2 * m * kk * n)["form"] = tile_form("matmul_int8", m, n)
        del x, wq, sc, wd
    torch.cuda.empty_cache()


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
    RTOL; a bf16 output to one bf16 ulp, compare_bf16); with stats, the
    per-channel sums by conv_fused.stats_error.
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


# engine attributes whose change over a serve run serve() reports
ENGINE_COUNTERS = ("prefills", "decode_steps", "decode_rows", "steps",
                   "replays", "capture_seconds", "spec_rounds",
                   "spec_proposed", "spec_accepted", "spec_draft_s",
                   "spec_verify_s")
POOL_COUNTERS = ("prefix_hits", "prefix_tokens", "prefix_tokens_cached",
                 "cow_copies", "preemptions")


def engine_counters(eng):
    out = {k: getattr(eng, k) for k in ENGINE_COUNTERS}
    out.update({k: getattr(eng.pool, k) for k in POOL_COUNTERS})
    if eng.draft is not None:
        out.update({"draft_steps": eng.draft.steps,
                    "draft_replays": eng.draft.replays,
                    "draft_capture_seconds": eng.draft.capture_seconds})
    return out


def serve(torch, srv, name, prompts):
    """Generate for every prompt, the second half arriving while the
    first half decodes; returns (results, seconds, launches, calls,
    counters), ``counters`` the change of ``engine_counters`` over the
    run.
    ``calls`` lists the K7 call of every decode step (one a layer) as
    [B, NB, context lengths of the real rows], (B, NB) the bucket the
    step ran at (a covering bucket while its own is captured); a
    padding row attends over one position.  ``launches`` also holds
    the prefills, the decode steps and the graph replays: every step of
    the tenant's engine (and of its draft's) must be a replay."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    eng = srv.engine(name)
    half = len(prompts) // 2
    # one short request first: CUDA/cuBLAS first-call set-up is load
    # time, not any measured request's TTFT; so is the capture its
    # decode bucket's miss starts in the background
    srv.generate(name, prompts[0][:16], 2).result(600)
    eng.drain()
    torch.cuda.synchronize()
    reset_launches()
    steps0 = eng.decode_steps
    counters0 = engine_counters(eng)
    calls, step = [], eng.decode_step

    def logged(blocks_list, lens_list, *args, **kw):
        out = step(blocks_list, lens_list, *args, **kw)
        calls.append(list(eng.last_decode_key)
                     + [int(n) + 1 for n in lens_list])
        return out

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
    counters = {k: v - counters0[k]
                for k, v in engine_counters(eng).items()}
    launches.update({k: counters[k]
                     for k in ("prefills", "decode_steps", "replays")})
    if counters["replays"] != counters["steps"] or \
            counters.get("draft_replays") != counters.get("draft_steps"):
        raise AssertionError("a step ran outside a graph replay: %r"
                             % counters)
    if any(len(r["tokens"]) != MAX_NEW for r in res):
        raise AssertionError("a request did not get %d tokens" % MAX_NEW)
    if eng.pool.used_blocks != 0:
        raise AssertionError("pool not drained: %d blocks used"
                             % eng.pool.used_blocks)
    return res, secs, launches, calls, counters


def load_tenant(torch, srv, name, cfg, params, quant="", **kw):
    """``srv.load_generative`` with its default warm (every warm bucket
    captured; ``kw``: prefix_cache, spec_k, draft); returns (engine,
    what the load cost: seconds, seconds spent capturing (the draft's
    included), memory reserved before (the allocator's cache emptied
    first: an unloaded tenant's graph pools may be released meanwhile)
    and after, the warm keys)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    eng = srv.load_generative(name, cfg, params, quant=quant,
                              kv_blocks=512, **kw)
    torch.cuda.synchronize()
    load = {"load_s": time.perf_counter() - t0,
            "capture_s": eng.capture_seconds,
            "memory_reserved_before_bytes": before,
            "memory_reserved_bytes": torch.cuda.memory_reserved(),
            "warm_decode_keys": eng.warm_decode_buckets,
            "warm_prefill_keys": eng._prefill.warm_keys}
    if eng.prefix_cache is not None:
        load["warm_prefill_cached_keys"] = eng._prefill_cached.warm_keys
    if eng.draft is not None:
        load["capture_s"] += eng.draft.capture_seconds
        load["warm_verify_keys"] = eng._verify.warm_keys
        load["warm_draft_keys"] = {
            "decode": eng.draft._decode.warm_keys,
            "propose": eng.draft._propose.warm_keys,
            "prefill": eng.draft._prefill.warm_keys}
    return eng, load


# a prefill at the (256,) bucket and a decode of 7 rows of 65 blocks
# each, the (8, nb_top) bucket: the bucket steps checked on their own
BUCKET_PROMPT, BUCKET_ROWS, BUCKET_ROW_BLOCKS = 200, 7, 65


def bucket_checks(torch, eng, seed):
    """One prefill and one decode of warm buckets on the idle tenant:
    the launches a replay makes, read from a ``torch.profiler`` trace by
    kernel symbol (profile_serve.SERVE_SYMBOLS), against the launches
    the wrappers recorded at the capture and the path's own (6 K1 a
    prefill, 6 K7 calls a decode step, 24 K8 each under int8); then
    each replay against its step function run eagerly on the card from
    the same pages: tokens and every page but the scratch block bit
    for bit."""
    import numpy as np

    from paddle_tpu_torch.serving.engine import pow2_bucket

    cfg = eng.config
    layers, int8 = cfg.n_layers, 4 * cfg.n_layers if eng.quant else 0
    rng = np.random.RandomState(seed)
    eng.drain()               # no capture of the serve run in flight
    blocks = [eng.pool.alloc(BUCKET_ROW_BLOCKS) for _ in range(BUCKET_ROWS)]
    out = {}
    try:
        prompt = rng.randint(0, cfg.vocab, BUCKET_PROMPT).tolist()
        lens = [BUCKET_ROW_BLOCKS * cfg.block_size - 1 - i
                for i in range(BUCKET_ROWS)]
        toks = rng.randint(0, cfg.vocab, BUCKET_ROWS).tolist()
        runs = (("prefill", lambda: eng.prefill_tokens(prompt, blocks[0]),
                 {"flash_fwd": layers, "matmul_int8": int8}),
                ("decode", lambda: eng.decode_step(blocks, lens, toks),
                 {"paged_attention": layers, "matmul_int8": int8}))
        for kind, run, want in runs:
            if kind == "prefill":
                key = (pow2_bucket(BUCKET_PROMPT, cfg.max_seq),)
                cache = eng._prefill
            else:
                key, cache = None, eng._decode
            out[kind] = replay_check(torch, eng, cache, key, run, want)
    finally:
        for b in blocks:
            eng.pool.free(b)
    out["ok"] = all(v["ok"] for v in out.values())
    return out


def replay_check(torch, eng, cache, key, run, want):
    """``run()`` (one replay of ``cache``'s step at ``key``, else at
    ``eng.last_decode_key``) under ``torch.profiler``: the launches it
    makes, read by kernel symbol, against those the wrappers recorded at
    the capture and ``want``, the path's; then the replay against the
    step function run eagerly on the card from the same pages and the
    inputs the replay was given: outputs and every page but the scratch
    block 0 bit for bit.  ``eng`` owns the pages the step writes."""
    from paddle_tpu_torch.tools.profile_serve import (SERVE_SYMBOLS,
                                                      traced_launches)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        run()
        torch.cuda.synchronize()
    key = key if key is not None else eng.last_decode_key
    step = cache.get(key)
    traced = traced_launches(prof, 1)
    recorded = {k: step.launches.get(k, 0) for k in SERVE_SYMBOLS}
    want = {k: want.get(k, 0) for k in SERVE_SYMBOLS}
    pages = [t.clone() for t in (eng._kp, eng._vp)]
    with eng._lock, torch.no_grad():
        for t, p in zip((eng._kp, eng._vp), pages):
            t.copy_(p)
        step.graph.replay()
        got = [t.clone() for t in step.outputs]
        got_pages = [t[:, 1:].clone() for t in (eng._kp, eng._vp)]
        for t, p in zip((eng._kp, eng._vp), pages):
            t.copy_(p)
        eager = step.fn()
        # past block 0, the scratch block a prefill's padding positions
        # all write at once, in no defined order
        same = (all(torch.equal(a, b) for a, b in zip(got, eager))
                and all(torch.equal(a, b[:, 1:]) for a, b in
                        zip(got_pages, (eng._kp, eng._vp))))
    del pages, got_pages
    return {"key": list(key), "recorded": recorded,
            "traced": traced if traced is not None else "not measured",
            "wanted": want, "replay_equals_eager_bit_for_bit": same,
            "ok": traced == recorded == want and same}


def serve_summary(res, secs):
    ttft = [r["ttft_ms"] for r in res]
    itl = [x for r in res for x in r["itl_ms"]]
    n_tok = sum(len(r["tokens"]) for r in res)
    return {"requests": len(res), "tokens": n_tok,
            "tokens_per_s": n_tok / secs, "seconds": secs,
            "ttft_ms_p50": _pct(ttft, 0.5), "ttft_ms_p90": _pct(ttft, 0.9),
            "itl_ms_p50": _pct(itl, 0.5), "itl_ms_p90": _pct(itl, 0.9),
            "preempted": sum(r["preempted"] for r in res),
            "tokens_sha1": hashlib.sha1(json.dumps(
                [r["tokens"] for r in res]).encode()).hexdigest()}


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
# serve_prefix and serve_spec: prefix caching and speculative decoding
# ---------------------------------------------------------------------------

SYSTEM_PREFIX = 768     # the shared "system" prompt: 48 blocks
TIMED = 5               # prefills timed a prompt (median)


def prefix_prompts(cfg, seed):
    """serve_prefix's 12 prompts (the second six arrive mid-decode):
    eight share a 768-token system prefix, with suffixes of 16-512
    tokens; two share one of those prompts up to a point inside a block
    (a COW); two are unrelated."""
    import numpy as np

    rng = np.random.RandomState(seed)

    def tok(n):
        return rng.randint(0, cfg.vocab, n).tolist()

    system = tok(SYSTEM_PREFIX)
    hits = [system + tok(n) for n in (100, 300, 16, 512, 48, 200, 33, 400)]
    cold = [tok(600), tok(64)]
    cow = [hits[0][:SYSTEM_PREFIX + 24] + tok(40),
           hits[1][:SYSTEM_PREFIX + 40] + tok(90)]
    return [hits[0], cold[0], hits[1], hits[2], hits[3], cold[1],
            hits[4], cow[0], hits[5], cow[1], hits[6], hits[7]]


def token_certificate(prompts, want, got, plain_logits, tenant_logits):
    """A tenant's greedy tokens (``got``) against the plain path's
    (``want``), request by request.  Where they first differ, at step
    t, the plain path's top-2 margin there against the largest |delta
    logit| between the two paths' logits at that step
    (``plain_logits`` / ``tenant_logits``(prompt, the t tokens before);
    a tenant_logits of None: the tenant ran the plain path's own step
    there, delta 0).  A difference with the margin above the delta is a
    fault; one under it a near-tie, after which the two contexts differ
    and the request is compared no further."""
    import numpy as np

    diffs, faults = [], 0
    for i, (p, a, b) in enumerate(zip(prompts, want, got)):
        t = next((j for j, (x, y) in enumerate(zip(a, b)) if x != y), None)
        if t is None:
            continue
        lp = plain_logits(p, a[:t])
        lt = tenant_logits(p, a[:t])
        top = np.sort(lp)[::-1]
        margin = float(top[0] - top[1])
        delta = float(np.abs(lp - lt).max()) if lt is not None else 0.0
        diffs.append({"request": i, "step": t, "plain": a[t],
                      "tenant": b[t], "top2_margin": margin,
                      "max_abs_logit_delta": delta,
                      "near_tie": margin <= delta})
        faults += margin > delta
    return {"identical_requests": sum(a == b for a, b in zip(want, got)),
            "of": len(want), "differences": diffs, "ok": faults == 0}


def plain_step_logits(eng, prompt, prev):
    """The plain path's f32 logits for the token after prompt + prev:
    a decode step with logits after a prefill of all but the last of
    those tokens; for the first token, dense_forward's last row (the
    prefill step returns no logits)."""
    from paddle_tpu_torch.serving import dense_forward

    if not prev:
        return dense_forward(eng.config, eng._params, prompt,
                             device=eng.device)[-1].cpu().numpy()
    ctx = prompt + prev[:-1]
    blocks = eng.pool.alloc(eng.pool.blocks_for(len(ctx) + 1))
    try:
        eng.prefill_tokens(ctx, blocks)
        _, logits = eng.decode_step([blocks], [len(ctx)], [prev[-1]],
                                    with_logits=True)
    finally:
        eng.pool.free(blocks)
    return logits[0]


def prefix_step_logits(eng, prompt, prev):
    """The prefix tenant's f32 logits for the token after prompt + prev:
    the prompt admitted through its prefix cache (a hit runs the suffix
    prefill, which gives the first token's logits), then decode steps
    with logits over prev.  None for the first token of a miss."""
    from paddle_tpu_torch.serving import GenRequest

    req = GenRequest(prompt, MAX_NEW, None, None)
    if not eng.prefix_cache.acquire(req):
        raise AssertionError("the prefix tenant's pool is full")
    logits = None
    try:
        more = eng.pool.blocks_for(len(prompt) + len(prev) + 1) - \
            len(req.blocks)
        if more > 0:
            req.blocks += eng.pool.alloc(more)
        if 0 < req.cached_len < len(prompt):
            _, logits = eng._prefill_suffix(prompt, req.blocks,
                                            req.cached_len,
                                            with_logits=True)
        else:
            eng.prefill_tokens(prompt, req.blocks)
        for i, tok in enumerate(prev):
            _, lg = eng.decode_step([req.blocks], [len(prompt) + i], [tok],
                                    with_logits=True)
            logits = lg[0]
    finally:
        eng.free_sequence(req)
    return logits


def verify_step_logits(eng, prompt, prev):
    """The spec tenant's f32 logits for the token after prompt + prev: a
    prefill of all but the last of those tokens, then a verify step with
    logits, whose row 0 feeds the last.  None for the first token (a
    spec tenant's comes from the plain prefill)."""
    import numpy as np

    from paddle_tpu_torch.serving import GenRequest

    if not prev:
        return None
    ctx = prompt + prev[:-1]
    req = GenRequest(prompt, MAX_NEW, None, None)
    req.blocks = eng.pool.alloc(eng.pool.blocks_for(len(ctx) + eng.spec_k
                                                    + 1))
    try:
        eng.prefill_tokens(ctx, req.blocks)
        req.context_len, req.out = len(ctx), list(prev)
        _, logits = eng.verify_step(
            [req], np.zeros((1, eng.spec_k), np.int64), with_logits=True)
    finally:
        eng.free_sequence(req)
    return logits[0, 0]


def host_ms(torch, fn):
    """Median host ms of TIMED calls of ``fn``, a synchronize at each
    end."""
    ms = []
    for _ in range(TIMED):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    return sorted(ms)[TIMED // 2]


def reserved_added(load, base):
    """Reserved memory a tenant's load added beyond ``base``'s (a
    tenant of the same LM without the feature): its extra ladders."""
    return ((load["memory_reserved_bytes"]
             - load["memory_reserved_before_bytes"])
            - (base["memory_reserved_bytes"]
               - base["memory_reserved_before_bytes"]))


def serve_prefix_phase(torch, srv, cfg, params, prompts, cold_tenants):
    """The prefix tenants (f32 and int8): each loaded with
    prefix_cache=True, served ``prompts``, and the same traffic served
    by the cold tenant of its quant (``cold_tenants``: (quant, name,
    load)).  Returns (the phase's line, launches summed over the prefix
    tenants' runs)."""
    import numpy as np

    from paddle_tpu_torch.serving import GenRequest
    from paddle_tpu_torch.serving.engine import pow2_bucket

    out, failures, launches_sum = {"phase": "serve_prefix"}, [], {}
    # the timed prompts: the system prefix with a fresh suffix of 48
    # and of 512 tokens (the served prompts have indexed themselves)
    rng = np.random.RandomState(SEED + 6)
    timed = [prompts[0][:SYSTEM_PREFIX]
             + rng.randint(0, cfg.vocab, n).tolist() for n in (48, 512)]
    for quant, cold_name, cold_load in cold_tenants:
        tag = quant or "f32"
        name = tag + "_prefix"
        cold = srv.engine(cold_name)
        eng, load = load_tenant(torch, srv, name, cfg, params, quant=quant,
                                prefix_cache=True)
        suffix, n_suffix = eng._prefill_suffix, [0]

        def counted(*args, **kw):
            n_suffix[0] += 1
            return suffix(*args, **kw)

        eng._prefill_suffix = counted
        try:
            res, secs, launches, _, counters = serve(torch, srv, name,
                                                     prompts)
        finally:
            del eng._prefill_suffix
        res_c, secs_c, _, _, _ = serve(torch, srv, cold_name, prompts)
        for k, v in launches.items():
            launches_sum[k] = launches_sum.get(k, 0) + v
        cert = token_certificate(
            prompts, [r["tokens"] for r in res_c],
            [r["tokens"] for r in res],
            lambda p, prev: plain_step_logits(cold, p, prev),
            lambda p, prev: prefix_step_logits(eng, p, prev))
        hit = prompts[6]
        oracle = oracle_check(torch, eng, eng._params, hit,
                              res[6]["tokens"])
        # one suffix prefill (a 48-token and a 512-token suffix of the
        # system prefix) beside the cold prefill of its prompt, and the
        # first one's replay traced and held to its eager step
        timing, replay = [], None
        for prompt in timed:
            req = GenRequest(prompt, 1, None, None)
            if not eng.prefix_cache.acquire(req):
                raise AssertionError("the prefix tenant's pool is full")
            try:
                start = req.cached_len
                key = (pow2_bucket(max(len(prompt) - start, cfg.block_size),
                                   cfg.max_seq),)
                ms = host_ms(torch, lambda: eng._prefill_suffix(
                    prompt, req.blocks, start))
                if replay is None:
                    replay = replay_check(
                        torch, eng, eng._prefill_cached, key,
                        lambda: eng._prefill_suffix(prompt, req.blocks,
                                                    start),
                        {"paged_attention": cfg.n_layers,
                         "matmul_int8": 4 * cfg.n_layers if quant else 0})
            finally:
                eng.free_sequence(req)
            blocks = cold.pool.alloc(cold.pool.blocks_for(len(prompt)))
            try:
                cold_ms = host_ms(torch, lambda: cold.prefill_tokens(
                    prompt, blocks))
            finally:
                cold.pool.free(blocks)
            timing.append({"prompt_tokens": len(prompt), "cached": start,
                           "suffix_bucket": key[0], "suffix_prefill_ms": ms,
                           "cold_prefill_ms": cold_ms})
        load["ladders_added_reserved_bytes"] = reserved_added(load,
                                                              cold_load)
        out[tag] = {"launches": launches, "counters": counters,
                    "suffix_prefills": n_suffix[0],
                    "index_nodes": eng.prefix_cache.nodes,
                    "tenant": serve_summary(res, secs),
                    "cold_tenant": serve_summary(res_c, secs_c),
                    "certificate": cert, "oracle": oracle,
                    "prefill_ms": timing, "replay": replay, "load": load}
        if not n_suffix[0] or not counters["prefix_hits"]:
            failures.append("%s: no prefix hit ran a suffix prefill" % tag)
        for what, ok in (("certificate", cert["ok"]),
                         ("oracle", oracle["ok"]), ("replay", replay["ok"])):
            if not ok:
                failures.append("%s: %s" % (tag, what))
        srv.unload(name)
    out["failures"] = failures
    out["ok"] = not failures
    return out, launches_sum


def serve_spec_phase(torch, srv, timer, cfg, params, prompts):
    """The speculative tenants (f32 and int8 targets, an f32 draft of
    layer 0, k = SPEC_K; profile_serve.spec_lm, the reference's
    construction), each beside a plain tenant of the same target, all
    serving ``prompts``.  Returns (the phase's line, launches summed
    over the spec tenants' runs)."""
    import numpy as np

    from paddle_tpu_torch.serving import GenRequest
    from paddle_tpu_torch.tools.profile_serve import (SPEC_DAMP, SPEC_K,
                                                      spec_lm)

    target, dcfg, dparams = spec_lm(params)
    out, failures, launches_sum = {"phase": "serve_spec", "k": SPEC_K,
                                   "damp": SPEC_DAMP}, [], {}
    k = SPEC_K
    for quant in ("", "int8"):
        tag = quant or "f32"
        plain, load_p = load_tenant(torch, srv, "spec_plain_" + tag, cfg,
                                    target, quant=quant)
        res_p, secs_p, _, _, _ = serve(torch, srv, "spec_plain_" + tag,
                                       prompts)
        eng, load = load_tenant(torch, srv, "spec_" + tag, cfg, target,
                                quant=quant, spec_k=k, draft=(dcfg, dparams))
        spec_decode, tally = eng.spec_decode, {}

        def tallied(seqs):
            before = [len(s.out) for s in seqs]
            emitted = spec_decode(seqs)
            for s, n, toks in zip(seqs, before, emitted):
                key = tuple(s.prompt)
                # a round right after the prefill starts the request's
                # tally (again, after a preemption)
                tally[key] = (0 if n == 1 else tally[key]) + len(toks)
            return emitted

        eng.spec_decode = tallied
        try:
            res, secs, launches, _, counters = serve(torch, srv,
                                                     "spec_" + tag, prompts)
        finally:
            del eng.spec_decode
        for key, v in launches.items():
            launches_sum[key] = launches_sum.get(key, 0) + v
        # delivered <= 1 + sum(m_i + 1) <= delivered + k, request by
        # request (the last round's tokens past max_new are dropped)
        accounting = [(len(r["tokens"]), 1 + tally.get(tuple(p), 0))
                      for p, r in zip(prompts, res)]
        accounting_ok = all(d <= e <= d + k for d, e in accounting)
        cert = token_certificate(
            prompts, [r["tokens"] for r in res_p],
            [r["tokens"] for r in res],
            lambda p, prev: plain_step_logits(plain, p, prev),
            lambda p, prev: verify_step_logits(eng, p, prev))
        # one propose and one verify replay at (8, 128, k) / (8, 128,
        # k + 1): 7 rows of 65 blocks, traced, timed and held to their
        # eager steps
        rng = np.random.RandomState(SEED + 5)
        blocks = [eng.pool.alloc(BUCKET_ROW_BLOCKS)
                  for _ in range(BUCKET_ROWS)]
        lens = [BUCKET_ROW_BLOCKS * cfg.block_size - k - 1 - i
                for i in range(BUCKET_ROWS)]
        toks = rng.randint(0, cfg.vocab, BUCKET_ROWS).tolist()
        seqs = []
        for bl, n, t in zip(blocks, lens, toks):
            seq = GenRequest([t], 1, None, None)
            seq.blocks, seq.context_len, seq.out = bl, n, [t]
            seqs.append(seq)
        props = rng.randint(0, cfg.vocab, (BUCKET_ROWS, k))
        d = eng.draft
        try:
            replays = {
                "propose": replay_check(
                    torch, d, d._propose, (8, d.nb_top, k),
                    lambda: d.propose_step(blocks, lens, toks, k),
                    {"paged_attention": k * dcfg.n_layers}),
                "verify": replay_check(
                    torch, eng, eng._verify, (8, eng.nb_top, k + 1),
                    lambda: eng.verify_step(seqs, props),
                    {"paged_attention": cfg.n_layers,
                     "matmul_int8": 4 * cfg.n_layers if quant else 0})}
            steps = {"propose": d._propose.get((8, d.nb_top, k)),
                     "verify": eng._verify.get((8, eng.nb_top, k + 1))}
            replay_ms = {kind: timer(lambda: step.graph.replay())
                         for kind, step in steps.items()}
        finally:
            for bl in blocks:
                eng.pool.free(bl)
        load["ladders_added_reserved_bytes"] = reserved_added(load, load_p)
        rounds = counters["spec_rounds"]
        out[tag] = {
            "launches": launches, "counters": counters,
            "accept_rate": counters["spec_accepted"]
            / max(1, counters["spec_proposed"]),
            "tenant": serve_summary(res, secs),
            "plain_tenant": serve_summary(res_p, secs_p),
            "certificate": cert,
            "accounting": {"delivered_emitted": accounting,
                           "ok": accounting_ok},
            "replay": replays,
            "replay_ms_at_8x128": replay_ms, "load": load,
            "plain_load": load_p}
        if not rounds:
            failures.append("%s: no speculative round ran" % tag)
        for what, ok in (("certificate", cert["ok"]),
                         ("accounting", accounting_ok),
                         ("propose replay", replays["propose"]["ok"]),
                         ("verify replay", replays["verify"]["ok"])):
            if not ok:
                failures.append("%s: %s" % (tag, what))
        srv.unload("spec_" + tag)
        srv.unload("spec_plain_" + tag)
    out["failures"] = failures
    out["ok"] = not failures
    return out, launches_sum


# ---------------------------------------------------------------------------
# serve_fleet: the disaggregated fleet, one prefill and two decode workers
# ---------------------------------------------------------------------------

FLEET = (("p0", "prefill"), ("d0", "decode"), ("d1", "decode"))
FLEET_LEASE_S = 0.5          # the kill drill's router lease
FLEET_HOLD_S = 1.5           # the drill's prefill delay, past the lease
FLEET_STEPS = 8              # decode steps of the import check
FLEET_COPY_BLOCKS = (1, 16, 64)  # block counts of the copies timed alone
FLEET_COPY_REPS = 3


def _fleet_call(tr, name, head):
    from paddle_tpu_torch.serving.fleet import M_CALL, decode_call, \
        encode_call

    return decode_call(tr.call("local:" + name, M_CALL, encode_call(head)))


def _fleet_load(torch, name, role, cfg, params, tr):
    """One warm FleetWorker (its role's ladders captured) and its load:
    seconds, capture seconds, memory reserved before and after (the
    allocator's cache emptied first), the warm keys."""
    from paddle_tpu_torch.serving import FleetWorker

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_reserved()
    t0 = time.perf_counter()
    w = FleetWorker(name, role, cfg, params, kv_blocks=512, warm=True,
                    transport=tr)
    torch.cuda.synchronize()
    tr.register(w)
    return w, {"load_s": time.perf_counter() - t0,
               "capture_s": w.engine.capture_seconds,
               "memory_reserved_before_bytes": before,
               "memory_reserved_bytes": torch.cuda.memory_reserved(),
               "warm_decode_keys": len(w.engine._decode.warm_keys),
               "warm_prefill_keys": len(w.engine._prefill.warm_keys)}


def _timed(rec, fn, size=len):
    """``fn`` wrapped to append (``size`` of its first argument, host ms
    of the call) to ``rec``: prefill returns the first token (a host
    read), export_blocks and import_blocks synchronise the engine's
    stream before they return."""
    def wrapped(arg, *args):
        t0 = time.perf_counter()
        out = fn(arg, *args)
        rec.append((size(arg), (time.perf_counter() - t0) * 1e3))
        return out
    return wrapped


class _WireLog:
    """A LocalTransport's ``call`` wrapped to log each MigrateKV frame:
    (bytes, ms from send to ack)."""

    def __init__(self, tr):
        from paddle_tpu_torch.serving.fleet import M_MIGRATE

        self.frames, call = [], tr.call

        def logged(addr, method, payload, timeout=None):
            t0 = time.perf_counter()
            out = call(addr, method, payload, timeout=timeout)
            if method == M_MIGRATE:
                self.frames.append((sum(len(p) for p in payload),
                                    (time.perf_counter() - t0) * 1e3))
            return out

        tr.call = logged


def fleet_import_check(torch, p0, d0, prompt):
    """Trouble spot of an in-place import, on the card: d0's decode
    bucket graphs were captured at its load; p0 prefills ``prompt`` and
    exports its pages, d0 imports them into fresh blocks, and
    FLEET_STEPS decode steps (graph replays) run over those blocks.
    Their tokens must equal those of the same prompt prefilled locally
    on d0 and decoded the same way, and the page tensors must keep their
    storage."""
    eng, cfg = d0.engine, d0.engine.config
    n = len(prompt)
    nb = eng.pool.blocks_for(n + FLEET_STEPS)
    src = p0.engine.pool.alloc(p0.engine.pool.blocks_for(n))
    try:
        first = p0.engine.prefill_tokens(prompt, src)
        k, v, _ = p0.engine.export_blocks(src)
    finally:
        p0.engine.pool.free(src)
    ptrs = [t.untyped_storage().data_ptr() for t in (eng._kp, eng._vp)]
    replays0 = eng.replays
    out = {}
    for how in ("imported", "local"):
        blocks = eng.pool.alloc(nb)
        try:
            if how == "imported":
                eng.import_blocks(blocks[:k.shape[1]], k, v)
                tok = first
            else:
                tok = eng.prefill_tokens(prompt, blocks)
            toks = [tok]
            for i in range(FLEET_STEPS):
                nxt = eng.decode_step([blocks], [n + i], [toks[-1]])
                toks.append(int(nxt[0]))
            out[how] = toks
            if how == "imported":
                pages = [t[:, blocks[:k.shape[1]]].clone()
                         for t in (eng._kp, eng._vp)]
            else:
                diff = max(float((t[:, blocks[:k.shape[1]]] - p).abs().max())
                           for t, p in zip((eng._kp, eng._vp), pages))
        finally:
            eng.pool.free(blocks)
    same_storage = ptrs == [t.untyped_storage().data_ptr()
                            for t in (eng._kp, eng._vp)]
    replayed = eng.replays - replays0
    return {"prompt_tokens": n, "steps": FLEET_STEPS,
            "tokens_imported": out["imported"], "tokens_local": out["local"],
            "identical": out["imported"] == out["local"],
            "page_max_abs_diff_imported_vs_local": diff,
            "page_storage_unchanged": same_storage,
            "replays": replayed,
            "ok": (out["imported"] == out["local"] and same_storage
                   and replayed == 2 * FLEET_STEPS + 1)}


def _migrate_ms(prefills, exports, imports, frames, acks):
    """The logged host ms of a run's migrations, in completion order:
    p0's prefill (prompt tokens, ms) and export (blocks, ms), the
    frame's send to ack (bytes, ms), the decode worker's import (blocks,
    ms); medians and maxima of each, and p0's own send-to-ack list."""
    out = {}
    for name, log in (("prefill_ms", prefills), ("export_ms", exports),
                      ("send_to_ack_ms", frames), ("import_ms", imports)):
        ms = [x for _, x in log]
        out[name] = [[a, x] for a, x in log]
        out[name + "_p50"] = _pct(ms, 0.5)
        out[name + "_max"] = max(ms)
    out["p0_migrate_ms"] = list(acks)
    return out


def fleet_summary(res, secs, prompts):
    ttft = [r["router_ttft_ms"] for r in res]
    itl = [x for r in res for x in r["itl_ms"]]
    n_tok = sum(len(r["tokens"]) for r in res)
    return {"requests": len(res), "tokens": n_tok,
            "tokens_per_s": n_tok / secs, "seconds": secs,
            "router_ttft_ms_p50": _pct(ttft, 0.5),
            "router_ttft_ms_p90": _pct(ttft, 0.9),
            "itl_ms_p50": _pct(itl, 0.5), "itl_ms_p90": _pct(itl, 0.9),
            "router_ttft_ms_by_prompt": [[len(p), r["router_ttft_ms"],
                                          r["worker"]]
                                         for p, r in zip(prompts, res)],
            "tokens_sha1": hashlib.sha1(json.dumps(
                [r["tokens"] for r in res]).encode()).hexdigest()}


def fleet_serve(torch, router, workers, prompts, tag):
    """Every prompt through the router (the second half arriving while
    the first decodes), MAX_NEW tokens each; returns (results, seconds,
    the engines' counter deltas)."""
    from paddle_tpu_torch.kernels import reset_launches

    half = len(prompts) // 2
    steps0 = sum(w.engine.decode_steps for w in workers.values())
    torch.cuda.synchronize()
    reset_launches()
    counters0 = {n: engine_counters(w.engine) for n, w in workers.items()}
    t0 = time.perf_counter()
    futs = [router.generate(p, MAX_NEW, req_id="%s%02d" % (tag, i))
            for i, p in enumerate(prompts[:half])]
    while sum(w.engine.decode_steps for w in workers.values()) == steps0 \
            and not futs[0].done():
        time.sleep(0.001)
    futs += [router.generate(p, MAX_NEW, req_id="%s%02d" % (tag, i + half))
             for i, p in enumerate(prompts[half:])]
    res = [f.result(600) for f in futs]
    secs = time.perf_counter() - t0
    torch.cuda.synchronize()
    counters = {n: {k: v - counters0[n][k]
                    for k, v in engine_counters(w.engine).items()}
                for n, w in workers.items()}
    return res, secs, counters


def fleet_kill_drill(torch, tr, workers, prompts, want):
    """The kill drill: a router with a FLEET_LEASE_S lease serves the
    prompts; once the first half is prefilled and migrated (some on d1),
    a FLEET_HOLD_S delay at the ``fleet_prefill`` injection point holds
    the next prompt passes (as many as p0 has slots), the second half
    arrives, and d1 is killed while those prompts are held.  d1 misses
    its lease and is evicted while requests it owns are still in their
    prompt pass, so they are re-prefilled on d0.  Every request must
    complete with ``want``'s tokens (zero lost), with one eviction."""
    from paddle_tpu_torch.core.flags import FLAGS
    from paddle_tpu_torch.distributed.resilience import (get_injector,
                                                         install_faults)
    from paddle_tpu_torch.serving import FleetRouter

    p0, d1 = workers["p0"], workers["d1"]
    half = len(prompts) // 2
    slots = int(FLAGS.fleet_prefill_slots)
    router = FleetRouter(tr, [(n, "local:" + n, r) for n, r in FLEET],
                         lease_s=FLEET_LEASE_S, lease_interval_s=0.05,
                         deadline_s=600)
    try:
        t0 = time.perf_counter()
        base, d1_base = len(p0.migrate_ms), d1.migrations
        futs = [router.generate(p, MAX_NEW, req_id="k%02d" % i)
                for i, p in enumerate(prompts[:half])]
        while len(p0.migrate_ms) < base + half:
            time.sleep(0.001)
        admitted_d1 = d1.migrations - d1_base
        install_faults("fleet_prefill:delay:%g:%d" % (FLEET_HOLD_S, slots))
        futs += [router.generate(p, MAX_NEW, req_id="k%02d" % (i + half))
                 for i, p in enumerate(prompts[half:])]
        while get_injector().stats.get("fleet_prefill", 0) < slots:
            time.sleep(0.001)
        owned = [r.rid for r in router._recs.values()
                 if r.owner == "d1" and not r.done_evt.is_set()]
        t_kill = time.perf_counter() - t0
        tr.kill("d1")
        res, lost = [], []
        for f in futs:
            try:
                res.append(f.result(600))
            except Exception as e:
                lost.append("%s: %s" % (type(e).__name__, e))
        secs = time.perf_counter() - t0
    finally:
        install_faults("")
        router.close()
    identical = sum(r["tokens"] == w for r, w in zip(res, want))
    out = {"requests": len(futs), "lost": len(lost), "errors": lost,
           "identical": identical, "admitted_on_d1_before_kill":
           admitted_d1, "owned_by_d1_at_kill": owned,
           "killed_at_s": t_kill, "seconds": secs,
           "evictions": router.evictions,
           "reprefills": router.reprefills,
           "workers": [r["worker"] for r in res],
           "migration_failures": router.migration_failures,
           "availability": router.availability}
    out["ok"] = (not lost and identical == len(futs) and admitted_d1 > 0
                 and [e["reason"] for e in router.evictions]
                 == ["fleet:eviction:d1"] and router.reprefills >= 1)
    return out


def fleet_torn_drill(router, decoders, prompt, want):
    """One request with ``fleet_migrate_tear:drop:1:1`` installed: p0
    sends a frame cut mid-payload; the decode worker rolls its blocks
    back and answers BufferLifetimeError naming kv_migration:<id>; the
    router falls back to that worker's local generate, which must give
    ``want``.  Every decode worker's free-block count is the same after
    the request as before, and one sanitizer trip is counted."""
    from paddle_tpu_torch.core import sanitizer
    from paddle_tpu_torch.distributed.resilience import install_faults

    def free():
        return {w.name: w.engine.pool.free_blocks for w in decoders}

    free0, trips0 = free(), sanitizer.trips
    install_faults("fleet_migrate_tear:drop:1:1")
    try:
        res = router.generate(prompt, MAX_NEW, req_id="tear").result(600)
    finally:
        install_faults("")
    errors = [e for e in router._recs["tear"].migrate_errors if e]
    named = [e for e in errors
             if e.get("kind") == "BufferLifetimeError"
             and "kv_migration:tear" in e.get("error", "")
             and "rolled back" in e.get("error", "")]
    out = {"worker": res["worker"], "migrate_errors": errors,
           "identical": res["tokens"] == want,
           "free_blocks_before": free0, "free_blocks_after": free(),
           "sanitizer_trips": sanitizer.trips - trips0}
    out["ok"] = (len(named) == 1 and res["tokens"] == want
                 and free() == free0 and out["sanitizer_trips"] == 1)
    return out


def fleet_socket_round(p0, d0, prompt, want):
    """p0 and d0 behind FleetEndpoints on 127.0.0.1, one request through
    a router over SocketTransport (p0 migrates over a socket too): its
    tokens must equal ``want``."""
    from paddle_tpu_torch.serving import (FleetEndpoint, FleetRouter,
                                          SocketTransport)

    sock = SocketTransport(timeout=120.0)
    eps = [FleetEndpoint(p0), FleetEndpoint(d0)]
    local, p0.transport = p0.transport, sock
    router = FleetRouter(sock, [("p0", eps[0].addr, "prefill"),
                                ("d0", eps[1].addr, "decode")],
                         deadline_s=600)
    try:
        migrations0 = d0.migrations
        res = router.generate(prompt, MAX_NEW, req_id="sock").result(600)
        migrated = d0.migrations - migrations0
    finally:
        router.close()
        p0.transport = local
        for ep in eps:
            ep.stop()
        sock.close()
    return {"addrs": [ep.addr for ep in eps], "migrated": migrated,
            "router_ttft_ms": res["router_ttft_ms"],
            "identical": res["tokens"] == want,
            "ok": res["tokens"] == want and migrated == 1}


def fleet_copies_alone(torch, p0, d0):
    """A migration's host copies timed on idle engines, FLEET_COPY_REPS
    times at each of FLEET_COPY_BLOCKS: p0's export (gather, copy to
    page-locked memory, synchronised), the ``b"".join`` a LocalTransport
    makes of the frame's parts, d0's import (page-locked staging, copy to
    the card, ``index_copy_``, synchronised), and apart from it the copy
    of the K pages alone into page-locked staging; host ms each."""
    from paddle_tpu_torch.serving.fleet import _byte_view, encode_migrate

    def ms(t0):
        return (time.perf_counter() - t0) * 1e3

    rows = []
    for nb in FLEET_COPY_BLOCKS:
        for _ in range(FLEET_COPY_REPS):
            src = p0.engine.pool.alloc(nb)
            dst = d0.engine.pool.alloc(nb)
            if src is None or dst is None:
                raise RuntimeError("copies alone: no %d free blocks" % nb)
            try:
                t0 = time.perf_counter()
                k, v, _ = p0.engine.export_blocks(src)
                row = {"blocks": nb, "bytes": k.nbytes + v.nbytes,
                       "export_ms": ms(t0)}
                t0 = time.perf_counter()
                frame = b"".join(encode_migrate(
                    {"blocks": src}, _byte_view(k), _byte_view(v)))
                row["join_ms"] = ms(t0)
                t0 = time.perf_counter()
                d0.engine.import_blocks(dst, k, v)
                row["import_ms"] = ms(t0)
                staged = torch.empty(k.shape, dtype=torch.float32,
                                     pin_memory=True)
                t0 = time.perf_counter()
                staged.numpy()[...] = k
                row["copy_k_to_page_locked_ms"] = ms(t0)
                del frame, staged
            finally:
                p0.engine.pool.free(src)
                d0.engine.pool.free(dst)
            rows.append(row)
    return rows


def serve_fleet_phase(torch, cfg, params, prompts, f32_res, f32_secs):
    """The flagship LM on a fleet of one prefill worker and two decode
    workers (f32, 512 blocks each, every role's ladder captured at load)
    sharing the card, over a LocalTransport behind a FleetRouter: the
    serve_f32 prompts, the launches and replays of the path, the import
    under captured graphs, a socket round, the torn migration and the
    kill drill.  Returns (the phase's line, launches of the serve run)."""
    import numpy as np

    from paddle_tpu_torch.kernels import KERNELS
    from paddle_tpu_torch.serving import FleetRouter, LocalTransport
    from paddle_tpu_torch.serving.engine import pow2_bucket

    out, failures = {"phase": "serve_fleet"}, []
    want = [r["tokens"] for r in f32_res]
    tr = LocalTransport()
    workers, loads = {}, {}
    try:
        for name, role in FLEET:
            workers[name], loads[name] = _fleet_load(torch, name, role, cfg,
                                                     params, tr)
        p0, d0, d1 = (workers[n] for n, _ in FLEET)
        wire = _WireLog(tr)
        prefills, exports, imports = [], [], []
        p0.engine.prefill = _timed(prefills, p0.engine.prefill,
                                   lambda seq: len(seq.prompt))
        p0.engine.export_blocks = _timed(exports, p0.engine.export_blocks)
        for d in (d0, d1):
            d.engine.import_blocks = _timed(imports, d.engine.import_blocks)
        router = FleetRouter(tr, [(n, "local:" + n, r) for n, r in FLEET],
                             deadline_s=600)
        try:
            # CUDA and cuBLAS first-call set-up is load time: one short
            # request on each decode worker, one through p0
            for d in ("d0", "d1"):
                _fleet_call(tr, d, {"op": "generate", "req": {
                    "id": "warm-" + d, "prompt": prompts[0][:16],
                    "max_new": 2, "eos": None}})
                _fleet_call(tr, d, {"op": "wait", "id": "warm-" + d,
                                    "timeout": 600})
            router.generate(prompts[0][:16], 2, req_id="warm").result(600)
            # a first run of the prompts fills the page-locked host pools
            # (the first copy at each size allocates) and the host
            # memory the frames land in; the second is the one measured
            res1, secs1, _ = fleet_serve(torch, router, workers, prompts,
                                         "f")
            logs = (prefills, exports, imports, wire.frames, p0.migrate_ms)
            first = {"fleet": fleet_summary(res1, secs1, prompts),
                     "migrate_ms": _migrate_ms(*logs)}
            for log in logs:
                del log[:]
            res, secs, counters = fleet_serve(torch, router, workers,
                                              prompts, "s")
            launches = {k: fn.launches for k, fn in KERNELS.items()}
            launches.update({k: sum(c[k] for c in counters.values())
                             for k in ("prefills", "decode_steps",
                                       "replays")})
            identical = sum(r["tokens"] == w for r, w in zip(res, want))
            identical1 = sum(r["tokens"] == w for r, w in zip(res1, want))
            steps_ok = all(c["replays"] == c["steps"]
                           for c in counters.values())
            frames = [b for b, _ in wire.frames]
            migration = {
                "migrations": {n: workers[n].migrations
                               for n in ("d0", "d1")},
                "dups": {n: workers[n].migration_dups
                         for n in ("d0", "d1")},
                "failures": router.migration_failures,
                "bytes_per_migration": [min(frames), max(frames)],
                "bytes_total": sum(frames),
                **_migrate_ms(*logs)}
            f32 = serve_summary(f32_res, f32_secs)
            out.update({
                "fleet": fleet_summary(res, secs, prompts),
                "serve_f32": {k: f32[k] for k in (
                    "tokens_per_s", "ttft_ms_p50", "ttft_ms_p90",
                    "itl_ms_p50", "itl_ms_p90", "tokens_sha1")},
                "identical_to_serve_f32": [identical, len(res)],
                "first_run": dict(first, identical_to_serve_f32=[
                    identical1, len(res1)]),
                "launches": launches, "counters": counters,
                "every_step_a_replay": steps_ok,
                "migration": migration, "load": loads})
            if identical != len(res) or identical1 != len(res1):
                failures.append("tokens differ from serve_f32's on %d + %d "
                                "of %d requests" % (
                                    len(res) - identical,
                                    len(res1) - identical1, len(res)))
            if not steps_ok:
                failures.append("a step ran outside a graph replay")
            if router.migration_failures or sum(
                    migration["migrations"].values()) != 2 * len(prompts) + 1:
                failures.append("a request of the run did not migrate")
            for k in ("flash_fwd", "paged_attention"):
                if launches[k] <= 0:
                    failures.append("%s never launched" % k)
            # a decode replay on d0 (bucket_checks: a prefill at (256,)
            # and a decode at (8, 128)) and a prefill replay on p0, their
            # traced launches against the recorded ones and the path's
            buckets = bucket_checks(torch, d0.engine, SEED + 3)
            rng = np.random.RandomState(SEED + 7)
            prompt = rng.randint(0, cfg.vocab, BUCKET_PROMPT).tolist()
            blocks = p0.engine.pool.alloc(p0.engine.pool.blocks_for(
                BUCKET_PROMPT))
            try:
                p0_prefill = replay_check(
                    torch, p0.engine, p0.engine._prefill,
                    (pow2_bucket(BUCKET_PROMPT, cfg.max_seq),),
                    lambda: p0.engine.prefill_tokens(prompt, blocks),
                    {"flash_fwd": cfg.n_layers})
            finally:
                p0.engine.pool.free(blocks)
            imported = fleet_import_check(torch, p0, d0, prompts[2])
            socket_round = fleet_socket_round(p0, d0, prompts[1], want[1])
            torn = fleet_torn_drill(router, (d0, d1), prompts[3], want[3])
            copies = fleet_copies_alone(torch, p0, d0)
        finally:
            router.close()
        out.update({"copies_alone": copies,
                    "buckets_d0": buckets, "prefill_p0": p0_prefill,
                    "import_under_captured_graphs": imported,
                    "socket_round": socket_round, "torn_migration": torn})
        kill = fleet_kill_drill(torch, tr, workers, prompts, want)
        out["kill_drill"] = kill
        for what, ok in (("d0's bucket replays", buckets["ok"]),
                         ("p0's prefill replay", p0_prefill["ok"]),
                         ("import under captured graphs", imported["ok"]),
                         ("socket round", socket_round["ok"]),
                         ("torn migration", torn["ok"]),
                         ("kill drill", kill["ok"])):
            if not ok:
                failures.append(what)
    finally:
        # a killed worker's engine is alive until its shutdown
        for w in workers.values():
            w.shutdown()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    out["failures"] = failures
    out["ok"] = not failures
    return out, launches


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
# under bf16 AMP: each kernel's bf16 form instead
BF16_FORM = {k: k + "_bf16" for k in TRAIN_KERNELS + FUSED_KERNELS}
# the fused program's projections (name, K, N, bias, act), each one K4
# launch per layer, lm_head once a step
# the sequence-parallel path: 4 ring shards on the one card; per layer
# and step 10 live chunk folds (K9) forward and 10 chunk backward steps
# (K2 + K3) at causal, p(p+1)/2 of p*p
SP = 4
SP_KERNELS = {"flash_chunk": SP * (SP + 1) // 2,
              "flash_bwd_dq": SP * (SP + 1) // 2,
              "flash_bwd_dkv": SP * (SP + 1) // 2}
# under bf16 AMP: each one's bf16 form, and no f32 form
SP_AMP_KERNELS = {k + "_bf16": n for k, n in SP_KERNELS.items()}
FUSED_MATMULS = (("qkv", 1024, 3072, False, ""),
                 ("out_proj", 1024, 1024, True, ""),
                 ("fc1", 1024, 4096, True, "relu"),
                 ("fc2", 4096, 1024, True, ""),
                 ("lm_head", 1024, 8192, True, ""))


def train_launches_per_step(fuse, amp=False, n=None):
    """{kernel: launches a training step of ``n`` layers (TRAIN_LM's by
    default) must make} (under AMP the bf16 forms, and no f32 form)."""
    n = n or TRAIN_LM["n_layers"]
    want = {k: n for k in TRAIN_KERNELS}
    if fuse:
        want.update(matmul_epilogue=4 * n + 1, add_ln=2 * n)
    return {BF16_FORM[k]: v for k, v in want.items()} if amp else want


def train_phase(fuse, amp):
    return ("train_fused" if fuse else "train_f32" if not amp
            else "train") + ("_amp" if amp else "")


def build_lm(fluid, amp=False, **overrides):
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(**{**TRAIN_LM, **overrides})
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


def lm_batch(batch, seed):
    """One batch of next-token pairs from a seeded RandomState."""
    import numpy as np

    rng = np.random.RandomState(seed)
    toks = rng.randint(0, TRAIN_LM["vocab_size"],
                       (batch, TRAIN_LM["seq_len"] + 1)).astype(np.int64)
    return {"src": toks[:, :-1], "label": toks[:, 1:, None]}


def train(torch, fuse, amp=False):
    """Startup, then 1 warm-up and TRAIN_STEPS timed steps of the
    flagship LM (the fused-block program with ``fuse``; under bf16 AMP
    with ``amp``) on one fixed batch, through Executor(CUDAPlace(0))."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_lm(fluid, amp=amp, fuse_transformer=fuse)
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
    want = train_launches_per_step(fuse, amp)
    per_step = {k: launches[k] / TRAIN_STEPS for k in KERNELS}
    dtypes = param_dtypes(main, scope)
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(per_step[k] == want.get(k, 0) for k in KERNELS)
          and dtypes == ["float32"])
    return {"phase": train_phase(fuse, amp), "amp": amp,
            "batch": TRAIN_BATCH, **TRAIN_LM,
            "startup_s": startup_s, "losses": losses, "step_ms": step_ms,
            "step_ms_p50": p50, "tokens_per_s": tokens / p50 * 1e3,
            "max_memory_allocated_bytes": peak,
            "launches_per_step": per_step,
            "launches_per_step_wanted": want, "launches": launches,
            "param_dtypes": dtypes, "ok": ok}


def train_amp_oracle(torch, fuse):
    """One step of the LM under bf16 AMP (the fused-block program with
    ``fuse``) at full width, depth 1, batch 1 on the card and, from the
    same parameters, on Executor(CPUPlace()), then twice more on the CPU
    with every weight matrix moved by one bf16 ulp up and down (the
    step's own bf16 spread, paddle_tpu_torch/tools/amp_spread.py
    --model transformer): the loss, the block's output and every
    parameter gradient are each held to AMP_ORACLE_SPREAD times their
    own spread, never below ORACLE_GRAD_RTOL, in relative Frobenius
    norm, and the median gradient to that multiple of the median
    spread; a loss spread above AMP_ORACLE_LOSS_SPREAD_MAX fails."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.tools.amp_spread import (lm_block_output,
                                                   nudge_weights)

    main, startup, loss = build_lm(fluid, amp=True, n_layers=1,
                                   fuse_transformer=fuse)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    arrays = get_scope_arrays(card, persist)
    params = [p.name for p in main.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    block_out = lm_block_output(main)
    fetch = [loss.name, block_out] + grads
    feed = lm_batch(1, SEED + 4)
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=card, return_numpy=False)
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    grad_dtypes = sorted({str(t.dtype) for t in got[2:]})
    out_dtype = str(got[1].dtype)
    got = [t.float().cpu().numpy() for t in got]
    cpu = []
    for step in (0, 1, -1):
        host = fluid.Scope()
        set_scope_arrays(host, nudge_weights(arrays, step, params), "cpu")
        cpu.append(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=host))
    want, up, down = cpu
    return {"phase": train_phase(fuse, True) + "_oracle", "n_layers": 1,
            "batch": 1, "amp": True, "launches": launches,
            "loss_card": float(got[0].ravel()[0]),
            "loss_cpu": float(want[0].ravel()[0]),
            "block_output": block_out, "block_output_dtype": out_dtype,
            "grad_dtypes": grad_dtypes,
            **amp_agreement(got, want, up, down, fetch, grads, {
                "launches": launches == train_launches_per_step(
                    fuse, True, 1),
                "grad_dtypes": grad_dtypes == ["torch.float32"],
                "block_output_dtype": out_dtype == "torch.bfloat16"})}


def amp_agreement(got, want, up, down, fetch, grads, checks):
    """Each fetched tensor of a card step (``got``) against the CPU's
    (``want``) in relative Frobenius norm, held to AMP_ORACLE_SPREAD
    times the larger of its CPU spreads (``up``, ``down``: the CPU step
    with every weight one bf16 ulp up / down), never below
    ORACLE_GRAD_RTOL; the median gradient to that multiple of the median
    spread; the loss spread at most AMP_ORACLE_LOSS_SPREAD_MAX; and
    ``checks`` ({name: bool}) all true."""
    import numpy as np

    def fro_rel(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    held = {}
    for i, name in enumerate(fetch):
        spread = max(fro_rel(up[i], want[i]), fro_rel(down[i], want[i]))
        held[name] = {"fro_rel": fro_rel(got[i], want[i]),
                      "cpu_ulp_fro_rel": spread,
                      "tolerance": max(ORACLE_GRAD_RTOL,
                                       AMP_ORACLE_SPREAD * spread)}
    g = [held[n] for n in grads]
    median = _pct([x["fro_rel"] for x in g], 0.5)
    median_spread = _pct([x["cpu_ulp_fro_rel"] for x in g], 0.5)
    median_tol = max(ORACLE_GRAD_RTOL, AMP_ORACLE_SPREAD * median_spread)
    worst = max(held, key=lambda n: held[n]["fro_rel"] /
                held[n]["tolerance"])
    loss_spread = held[fetch[0]]["cpu_ulp_fro_rel"]
    ok = (all(math.isfinite(x["fro_rel"]) and x["fro_rel"] <= x["tolerance"]
              for x in held.values())
          and median <= median_tol
          and loss_spread <= AMP_ORACLE_LOSS_SPREAD_MAX
          and all(checks.values()))
    return {"loss": held[fetch[0]], "loss_spread_max":
            AMP_ORACLE_LOSS_SPREAD_MAX,
            "worst_vs_tolerance": [worst, held[worst]],
            "median_grad_fro_rel": median,
            "cpu_ulp_median_grad_fro_rel": median_spread,
            "median_grad_tolerance": median_tol, "checks": checks,
            "held": held, "ok": ok}


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


def train_sp(torch, amp=False):
    """Startup, then 1 warm-up and TRAIN_STEPS timed steps of the sp LM
    (under bf16 AMP with ``amp``) on one fixed batch through
    ExecutorCore(CUDAPlace(0)) on the 4-shard one-card mesh; the dense
    program's loss from the startup parameters and the same batch beside
    the warm-up's, for information."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.executor_impl import ExecutorCore
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_lm(fluid, amp=amp, sp=True)
    mesh = sp_mesh(torch, "cuda:0")
    core = ExecutorCore(fluid.CUDAPlace(0), mesh=mesh)
    scope = fluid.Scope()
    t0 = time.perf_counter()
    core.run(startup.desc, scope)
    torch.cuda.synchronize()
    startup_s = time.perf_counter() - t0
    feed = lm_batch(TRAIN_BATCH, SEED + 3)
    dmain, _, dloss = build_lm(fluid, amp=amp)
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
    want = {k: TRAIN_LM["n_layers"] * n for k, n in
            (SP_AMP_KERNELS if amp else SP_KERNELS).items()}
    per_step = {k: launches[k] / TRAIN_STEPS for k in KERNELS}
    dtypes = param_dtypes(main, scope)
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(per_step[k] == want.get(k, 0) for k in KERNELS)
          and dtypes == ["float32"])
    return {"phase": "train_sp_amp" if amp else "train_sp", "amp": amp,
            "batch": TRAIN_BATCH, **TRAIN_LM,
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
            "param_dtypes": dtypes, "ok": ok}


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


def train_sp_amp_oracle(torch):
    """One sp step under bf16 AMP at full width, depth 1, batch 1 on the
    card's 4-shard mesh, and from the same parameters the same step on a
    4-shard CPU mesh and the dense AMP program's step on the card; the
    CPU sp step twice more with every weight matrix one bf16 ulp up and
    down (its own spread, as train_amp_oracle's).  Each fetched tensor
    (the loss, the block's output, every parameter gradient) of the card
    sp step is held to AMP_ORACLE_SPREAD times that spread against the
    CPU sp step and against the dense card step (amp_agreement)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.executor_impl import ExecutorCore
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.tools.amp_spread import (lm_block_output,
                                                   nudge_weights)

    main, startup, loss = build_lm(fluid, amp=True, n_layers=1, sp=True)
    dmain, _, _ = build_lm(fluid, amp=True, n_layers=1)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    arrays = get_scope_arrays(card, persist)
    dense = fluid.Scope()
    set_scope_arrays(dense, arrays, "cuda")
    params = [p.name for p in main.all_parameters()]
    grads = [p + "@GRAD" for p in params]
    block_out = lm_block_output(main)
    fetch = [loss.name, block_out] + grads
    feed = lm_batch(1, SEED + 4)
    reset_launches()
    got = ExecutorCore(fluid.CUDAPlace(0), mesh=sp_mesh(torch, "cuda:0")
                       ).run(main.desc, card, 0, feed, fetch,
                             return_numpy=False)
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    grad_dtypes = sorted({str(t.dtype) for t in got[2:]})
    out_dtype = str(got[1].dtype)
    got = [t.float().cpu().numpy() for t in got]
    cpu = []
    for step in (0, 1, -1):
        host = fluid.Scope()
        set_scope_arrays(host, nudge_weights(arrays, step, params), "cpu")
        cpu.append(ExecutorCore(fluid.CPUPlace(), mesh=sp_mesh(torch, "cpu")
                                ).run(main.desc, host, 0, feed, fetch))
    want, up, down = cpu
    dense_card = fluid.Executor(fluid.CUDAPlace(0)).run(
        dmain, feed=feed, fetch_list=fetch, scope=dense)
    vs_cpu = amp_agreement(got, want, up, down, fetch, grads, {
        "launches": launches == SP_AMP_KERNELS,
        "grad_dtypes": grad_dtypes == ["torch.float32"],
        "block_output_dtype": out_dtype == "torch.bfloat16"})
    vs_dense = amp_agreement(got, dense_card, up, down, fetch, grads, {})
    return {"phase": "train_sp_amp_oracle", "n_layers": 1, "batch": 1,
            "sp": SP, "amp": True, "launches": launches,
            "loss_card": float(got[0].ravel()[0]),
            "loss_cpu_sp": float(want[0].ravel()[0]),
            "loss_card_dense": float(dense_card[0].ravel()[0]),
            "block_output": block_out, "block_output_dtype": out_dtype,
            "grad_dtypes": grad_dtypes, "vs_cpu_sp": vs_cpu,
            "vs_card_dense": vs_dense,
            "ok": vs_cpu["ok"] and vs_dense["ok"]}


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
BENCH_ITERS = 10
CONV_FWD = "ResNet-50 forward, batch 256, stats: 53 launches, 20 shapes"
CONV_FWD_BF16 = ("ResNet-50 forward, batch 256, bf16, stats: 53 launches, "
                 "20 shapes")


def build_resnet(fluid, fused, is_test=False, amp=False):
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = resnet.get_model(
            **RESNET, is_test=is_test,
            data_format="NHWC" if fused else "NCHW", fused_stages=fused)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


class bn_bf16:
    """FLAGS.bn_bf16 set for the block (bench.py's AMP default), then
    restored."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        from paddle_tpu_torch.core.flags import FLAGS

        self.prev, FLAGS.bn_bf16 = FLAGS.bn_bf16, self.on

    def __exit__(self, *exc):
        from paddle_tpu_torch.core.flags import FLAGS

        FLAGS.bn_bf16 = self.prev


def param_dtypes(main, scope):
    return sorted({str(scope.find_var(p.name).dtype).replace("torch.", "")
                   for p in main.all_parameters()})


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


def infer_params(torch, exe, feed):
    """The NCHW startup's parameters with each BN's running statistics
    set to ``feed``'s own (fetched from one step of the NCHW training
    program), so an is_test program normalizes as training does."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays

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
    return params


def infer_resnet(torch):
    """The is_test fused forward at batch 256 against the NCHW is_test
    forward on the card, from the NCHW startup's parameters with each
    BN's running statistics set to this batch's own (infer_params), so
    both normalize as training does.  1 warm-up and RESNET_STEPS timed
    forwards of the fused program."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = resnet_batch(RESNET_BATCH, SEED + 6)
    params = infer_params(torch, exe, feed)

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


def infer_resnet_amp(torch):
    """The is_test fused forward under bf16 AMP at batch 256 against the
    f32 is_test fused forward on the card, both from infer_params' set;
    1 warm-up and RESNET_STEPS timed AMP forwards."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    exe = fluid.Executor(fluid.CUDAPlace(0))
    feed = resnet_batch(RESNET_BATCH, SEED + 6)
    params = infer_params(torch, exe, feed)
    probs = {}
    for amp in (False, True):
        with bn_bf16(amp):
            main, _, _ = build_resnet(fluid, True, is_test=True, amp=amp)
            softmax = [op.output("Out")[0] for op in main.desc.blocks[0].ops
                       if op.type == "softmax"]
            scope = fluid.Scope()
            set_scope_arrays(scope, _hwio_for(params, main), "cuda")
            reset_launches()
            probs[amp] = exe.run(main, feed=feed, fetch_list=softmax,
                                 scope=scope)[0]
            if amp:
                first = KERNELS["conv_stage_bf16"].launches
                fwd_ms = []
                for _ in range(RESNET_STEPS):
                    t0 = time.perf_counter()
                    exe.run(main, feed=feed, fetch_list=softmax, scope=scope)
                    fwd_ms.append((time.perf_counter() - t0) * 1e3)
                launches = {k: fn.launches for k, fn in KERNELS.items()}
                dtypes = param_dtypes(main, scope)
        del scope
        torch.cuda.empty_cache()
    err = float(np.abs(probs[True] - probs[False]).max())
    top1 = int((probs[True].argmax(1) == probs[False].argmax(1)).sum())
    p50 = _pct(fwd_ms, 0.5)
    ok = (np.isfinite(probs[True]).all() and err <= INFER_AMP_TOL
          and first == RESNET_CONVS and dtypes == ["float32"]
          and launches["conv_stage_bf16"] == RESNET_CONVS * (1 + RESNET_STEPS)
          and all(launches[k] == 0 for k in KERNELS
                  if k != "conv_stage_bf16"))
    return {"phase": "infer_resnet_fused_amp", "batch": RESNET_BATCH,
            **RESNET, "amp": True, "bn_bf16": True,
            "forward_ms": fwd_ms, "forward_ms_p50": p50,
            "images_per_s": RESNET_BATCH / p50 * 1e3,
            "conv_stage_bf16_launches_per_forward": first,
            "softmax_max_abs_err_vs_f32": err, "tolerance": INFER_AMP_TOL,
            "top1_agree_vs_f32": [top1, RESNET_BATCH],
            "param_dtypes": dtypes, "launches": launches, "ok": bool(ok)}


def train_resnet(torch, fused, amp=False):
    """Startup, then 1 warm-up and RESNET_STEPS timed steps of ResNet-50
    (the NHWC fused-stage program with ``fused``; under bf16 AMP and
    FLAGS_bn_bf16 with ``amp``) on one fixed uint8 batch, through
    Executor(CUDAPlace(0))."""
    with bn_bf16(amp):
        return _train_resnet(torch, fused, amp)


def _train_resnet(torch, fused, amp):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_resnet(fluid, fused, amp=amp)
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
    want = {("conv_stage_bf16" if amp else "conv_stage"): RESNET_CONVS} \
        if fused else {}
    per_step = {k: launches[k] / RESNET_STEPS for k in KERNELS}
    dtypes = param_dtypes(main, scope)
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(per_step[k] == want.get(k, 0) for k in KERNELS)
          and dtypes == ["float32"])
    return {"phase": ("train_resnet_fused" if fused else "train_resnet")
            + ("_amp" if amp else ""),
            "batch": RESNET_BATCH, **RESNET, "amp": amp, "bn_bf16": amp,
            "startup_s": startup_s,
            "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
            "images_per_s": RESNET_BATCH / p50 * 1e3,
            "max_memory_allocated_bytes": peak,
            "launches_per_step": per_step,
            "launches_per_step_wanted": want, "launches": launches,
            "param_dtypes": dtypes, "ok": ok}


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


def resnet_oracle_amp(torch, seed=SEED):
    """One step of the fused ResNet-50 under bf16 AMP (FLAGS_bn_bf16) at
    depth 50, batch 2, on the card and, from the same parameters, on
    Executor(CPUPlace()), then twice more on the CPU with every filter
    moved by one bf16 ulp up and down (the step's own bf16 spread):
    every fetched tensor (the loss, each fused stage's output Y, each
    parameter gradient) is held to AMP_ORACLE_SPREAD times its own
    spread, never below ORACLE_GRAD_RTOL, in relative Frobenius norm,
    and the median gradient to that multiple of the median spread."""
    with bn_bf16(True):
        return _resnet_oracle_amp(torch, seed)


def _resnet_oracle_amp(torch, seed):
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

    main, startup, loss = build_resnet(fluid, True, amp=True)
    startup.random_seed = seed
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    arrays = get_scope_arrays(card, persist)
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    ys = [op.output("Y")[0] for op in main.desc.blocks[0].ops
          if op.type == "fused_conv2d_bn_act"]
    grads = [p + "@GRAD" for p in params]
    fetch = [loss.name] + ys + grads
    feed = resnet_batch(RESNET_ORACLE_BATCH, seed + 7)
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=card, return_numpy=False)
    k6 = {k: KERNELS[k].launches for k in ("conv_stage_bf16", "conv_stage")}
    y_dtypes = sorted({str(t.dtype) for t in got[1:1 + len(ys)]})
    grad_dtypes = sorted({str(t.dtype) for t in got[1 + len(ys):]})
    got = [t.float().cpu().numpy() for t in got]

    def nudged(v, step):
        t = torch.from_numpy(v).to(torch.bfloat16).float()
        return (t + step * bf16_ulp(t)).numpy()

    cpu = []
    for step in (0, 1, -1):
        host = fluid.Scope()
        set_scope_arrays(host, {k: nudged(v, step) if step and v.ndim == 4
                                else v for k, v in arrays.items()}, "cpu")
        cpu.append(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=host))
    want, up, down = cpu

    def fro_rel(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        return float(np.linalg.norm(a - b) / np.linalg.norm(b))

    held = {}
    for i, name in enumerate(fetch):
        spread = max(fro_rel(up[i], want[i]), fro_rel(down[i], want[i]))
        held[name] = {"fro_rel": fro_rel(got[i], want[i]),
                      "cpu_ulp_fro_rel": spread,
                      "tolerance": max(ORACLE_GRAD_RTOL,
                                       AMP_ORACLE_SPREAD * spread)}
    g = [held[n] for n in grads]
    median = _pct([x["fro_rel"] for x in g], 0.5)
    median_spread = _pct([x["cpu_ulp_fro_rel"] for x in g], 0.5)
    median_tol = max(ORACLE_GRAD_RTOL, AMP_ORACLE_SPREAD * median_spread)
    worst = max(held, key=lambda n: held[n]["fro_rel"] /
                held[n]["tolerance"])
    loss_spread = held[loss.name]["cpu_ulp_fro_rel"]
    ok = (all(math.isfinite(x["fro_rel"]) and x["fro_rel"] <= x["tolerance"]
              for x in held.values())
          and median <= median_tol
          and loss_spread <= AMP_ORACLE_LOSS_SPREAD_MAX
          and k6 == {"conv_stage_bf16": RESNET_CONVS, "conv_stage": 0}
          and grad_dtypes == ["torch.float32"]
          and y_dtypes == ["torch.bfloat16"])
    return {"phase": "train_resnet_fused_amp_oracle", "depth": 50,
            "batch": RESNET_ORACLE_BATCH, "seed": seed, "amp": True,
            "bn_bf16": True, "conv_stage_launches": k6,
            "loss_card": float(got[0][0]), "loss_cpu": float(want[0][0]),
            "loss": held[loss.name], "loss_spread_max":
            AMP_ORACLE_LOSS_SPREAD_MAX,
            "stage_y_first": held[ys[0]], "stage_y_last": held[ys[-1]],
            "stage_y_worst_fro_rel": max(held[n]["fro_rel"] for n in ys),
            "worst_vs_tolerance": [worst, held[worst]],
            "median_grad_fro_rel": median,
            "cpu_ulp_median_grad_fro_rel": median_spread,
            "median_grad_tolerance": median_tol,
            "y_dtypes": y_dtypes, "grad_dtypes": grad_dtypes,
            "held": held, "ok": ok}


# ---------------------------------------------------------------------------
# phases 25-28: the prepared step, captured as one CUDA graph
# ---------------------------------------------------------------------------

# (run() phase, model, fused): the four bf16 programs, the bench
# headline (NCHW ResNet-50 under AMP) first
PREPARED_PATHS = (("train_resnet_amp", "resnet", False),
                  ("train_resnet_fused_amp", "resnet", True),
                  ("train_fused_amp", "lm", True),
                  ("train_amp", "lm", False))
# prepared steps held against as many run() steps from one scope
AGREE_STEPS = 3
TRACED_REPLAYS = 2     # replays traced for the launches they make


def train_prepared(torch, path, kind, fused, run_result):
    """Phase ``path``_prepared: ``path``'s program, batch and steps
    through Executor.prepare / run_prepared (one CUDA graph replay a
    step): startup, prepare with the batch, 1 warm-up step (it captures)
    and the timed steps; ``path``'s checks, its launches a step, and
    AGREE_STEPS prepared steps against as many run() steps from one
    copied scope (``prepared_agreement``).  ``run_result`` is
    ``path``'s own result, from this process."""
    with bn_bf16(kind == "resnet"):
        return _train_prepared(torch, path, kind, fused, run_result)


def _train_prepared(torch, path, kind, fused, run_result):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    if kind == "resnet":
        main, startup, loss = build_resnet(fluid, fused, amp=True)
        feed, steps = resnet_batch(RESNET_BATCH, SEED + 5), RESNET_STEPS
        want = {"conv_stage_bf16": RESNET_CONVS} if fused else {}
        batch = RESNET_BATCH
    else:
        main, startup, loss = build_lm(fluid, amp=True,
                                       fuse_transformer=fused)
        feed, steps = lm_batch(TRAIN_BATCH, SEED + 3), TRAIN_STEPS
        want = train_launches_per_step(fused, True)
        batch = TRAIN_BATCH
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    agreement = prepared_agreement(torch, fluid, main, loss, feed, persist,
                                   get_scope_arrays(scope, persist))
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    prep = exe.prepare(main, feed_specs=feed, fetch_list=[loss], scope=scope)
    losses = [float(prep.run_prepared(feed, return_numpy=True)[0][0])]
    capture_s = time.perf_counter() - t0    # warm-ups, capture, replay
    reset_launches()
    step_ms = []
    for _ in range(steps):
        t0 = time.perf_counter()
        out = prep.run_prepared(feed, return_numpy=True)
        step_ms.append((time.perf_counter() - t0) * 1e3)   # the fetch syncs
        losses.append(float(out[0][0]))
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    # the peak from prepare() on: the warm-up steps, the capture and
    # the replays; between replays the graph's private pool keeps the
    # step's activations reserved, not allocated
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    # the counts above are the wrappers' calls recorded at capture, added
    # per replay; the launches a replay makes are read from a trace
    traced = traced_launches(torch, lambda: prep.run_prepared(feed),
                             TRACED_REPLAYS)
    prep.sync_scope()
    p50 = _pct(step_ms, 0.5)
    per_step = {k: launches[k] / steps for k in KERNELS}
    dtypes = param_dtypes(main, scope)
    ok = (all(math.isfinite(x) for x in losses) and losses[-1] < losses[0]
          and all(per_step[k] == want.get(k, 0) for k in KERNELS)
          and per_step == run_result["launches_per_step"]
          and traced is not None
          and all(n == per_step[k] for k, n in traced.items())
          and dtypes == ["float32"] and agreement["ok"])
    unit = "images_per_s" if kind == "resnet" else "tokens_per_s"
    per = batch if kind == "resnet" else batch * TRAIN_LM["seq_len"]
    return {"phase": path + "_prepared", "batch": batch, "amp": True,
            "captured": True, "losses": losses, "step_ms": step_ms,
            "step_ms_p50": p50, "run_step_ms_p50": run_result["step_ms_p50"],
            "ratio_to_run": p50 / run_result["step_ms_p50"],
            unit: per / p50 * 1e3,
            "first_step_s": capture_s,
            "max_memory_allocated_bytes": peak,
            "memory_reserved_bytes": reserved,
            "run_max_memory_allocated_bytes":
                run_result["max_memory_allocated_bytes"],
            "device_idle_share": "not measured here (profile_train "
                                 "--prepared)",
            "launches_per_step": per_step,
            "launches_per_step_wanted": want, "launches": launches,
            "replay_launches_traced_per_step":
                traced if traced is not None else "not measured",
            "param_dtypes": dtypes, "agreement": agreement, "ok": ok}


def traced_launches(torch, step, n):
    """{kernel: launches a step} of the bf16 kernels a captured step
    runs, read from a ``torch.profiler`` trace of ``n`` calls of
    ``step`` (each one replay) by the kernels' symbols
    (``profile_train.KERNEL_GROUPS``; K6 bf16's stem form counts with
    its wgmma form, as its wrapper counts them); None when the trace
    holds no device event."""
    from paddle_tpu_torch.tools.profile_train import (device_kernels,
                                                      port_kernel_groups)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = device_kernels(prof, n)
    if not kernels:
        return None
    out = {k: g["calls_per_step"]
           for k, g in port_kernel_groups(kernels).items()}
    out["conv_stage_bf16"] += out.pop("conv_stage_bf16_stem")
    return out


def prepared_agreement(torch, fluid, main, loss, feed, persist, init):
    """AGREE_STEPS prepared steps against AGREE_STEPS run() steps, each
    from a copy of ``init`` on the card: the losses and every
    persistable after sync_scope.  run() goes twice first: where its two
    runs are bit-identical, the prepared step must be too; where they
    are not (cuDNN's grad convs sum with atomics), each tensor is held
    as the oracles hold the card against the CPU, to AMP_ORACLE_SPREAD
    times its own spread (here: run() against run(), relative Frobenius
    norm), never below ORACLE_GRAD_RTOL."""
    import numpy as np

    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    def steps(prepared):
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        exe = fluid.Executor(fluid.CUDAPlace(0))
        if prepared:
            with exe.prepare(main, feed_specs=feed, fetch_list=[loss],
                             scope=scope) as prep:
                losses = [prep.run_prepared(feed, return_numpy=True)[0]
                          for _ in range(AGREE_STEPS)]
        else:
            losses = [exe.run(main, feed=feed, fetch_list=[loss],
                              scope=scope)[0] for _ in range(AGREE_STEPS)]
        out = {"loss": np.concatenate([np.ravel(x) for x in losses])}
        out.update(get_scope_arrays(scope, persist))
        return out

    run_a, run_b = steps(False), steps(False)
    torch.cuda.empty_cache()
    got = steps(True)

    def fro_rel(a, b):
        a, b = a.astype(np.float64), b.astype(np.float64)
        d = float(np.linalg.norm(a - b))
        return d / max(float(np.linalg.norm(b)), 1e-30) if d else 0.0

    deterministic = all(np.array_equal(run_a[n], run_b[n]) for n in run_a)
    identical = all(np.array_equal(got[n], run_a[n]) for n in run_a)
    held = {}
    for n in run_a:
        spread = fro_rel(run_b[n], run_a[n])
        held[n] = {"fro_rel": fro_rel(got[n], run_a[n]),
                   "run_spread_fro_rel": spread,
                   "tolerance": max(ORACLE_GRAD_RTOL,
                                    AMP_ORACLE_SPREAD * spread),
                   "max_abs_diff": float(np.abs(
                       got[n].astype(np.float64) - run_a[n]).max())
                   if got[n].size else 0.0}
    worst = max(held, key=lambda n: held[n]["fro_rel"] /
                held[n]["tolerance"])
    ok = identical if deterministic else all(
        math.isfinite(h["fro_rel"]) and h["fro_rel"] <= h["tolerance"]
        for h in held.values())
    return {"steps": AGREE_STEPS, "tensors": len(held),
            "run_bit_identical_run_to_run": deterministic,
            "bit_identical_to_run": identical,
            "losses_prepared": got["loss"].tolist(),
            "losses_run": run_a["loss"].tolist(),
            "max_abs_diff": max(h["max_abs_diff"] for h in held.values()),
            "loss": held["loss"], "worst_vs_tolerance": [worst, held[worst]],
            "ok": bool(ok)}


def bench_runs(torch, fused_step_ms):
    """The port's bench entry in a subprocess: the default headline with
    its secondary (the flagship LM, which must be the bf16 LM),
    BENCH_LAYOUT=NHWC, (information, beside ``fused_step_ms``, phase
    13's p50) BENCH_AMP=0 BENCH_LAYOUT=NHWC, and BENCH_MODEL=transformer
    at its card default (bf16), unfused and fused-block, each
    BENCH_ITERS, no secondary but the headline's.  Returns (the runs'
    JSON lines, the phase's summary)."""
    root = os.path.dirname(os.path.abspath(__file__))
    runs = (("headline", {"BENCH_SECONDARY": "1"}),
            ("headline_run", {"BENCH_PREPARED": "0"}),
            ("nhwc", {"BENCH_LAYOUT": "NHWC"}),
            ("nhwc_f32", {"BENCH_LAYOUT": "NHWC", "BENCH_AMP": "0"}),
            ("lm", {"BENCH_MODEL": "transformer"}),
            ("lm_fused", {"BENCH_MODEL": "transformer",
                          "BENCH_FUSED_TRANSFORMER": "1"}))
    lines, summary, bad = {}, {}, []
    for name, extra in runs:
        env = {k: v for k, v in os.environ.items()
               if not k.startswith("BENCH_")}
        env.update(BENCH_ITERS=str(BENCH_ITERS), BENCH_SECONDARY="0")
        env.update(extra)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        proc = subprocess.run(
            [sys.executable, "-m", "paddle_tpu_torch.tools.bench"],
            cwd=root, env=env, capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        out = None
        if proc.returncode == 0 and proc.stdout.strip():
            out = json.loads(proc.stdout.strip().splitlines()[-1])
        if out is None:
            sys.stderr.write(proc.stderr[-4000:])
            bad.append("%s: rc %d" % (name, proc.returncode))
            continue
        lines[name] = out
        amp = extra.get("BENCH_AMP", "1") == "1"
        checks = bench_checks(out, amp, extra.get("BENCH_PREPARED") != "0")
        if "BENCH_MODEL" in extra:
            fused = "BENCH_FUSED_TRANSFORMER" in extra
            checks.update(
                metric=out["metric"] ==
                "transformer_lm_d1024_L6_train_bs16_seq2048_bf16",
                fused_stages=out["fused_stages"] ==
                (6 * TRAIN_LM["n_layers"] + 1 if fused else 0))
        else:
            checks["data_format"] = out["data_format"] == extra.get(
                "BENCH_LAYOUT", "NCHW")
            sec = out["secondary"]
            if name == "headline":
                checks["secondary_bf16_lm"] = (
                    sec is not None and sec["amp"] is True
                    and sec["metric"] ==
                    "transformer_lm_d1024_L6_train_bs16_seq2048_bf16"
                    and all(bench_checks(sec, True, True).values()))
        ok = all(checks.values())
        if not ok:
            bad.append("%s failed its checks: %s" % (
                name, sorted(k for k, v in checks.items() if not v)))
        summary[name] = {k: out.get(k) for k in (
            "metric", "value", "step_ms_p50", "step_ms_p90", "step_ms_p99",
            "tflops", "mfu", "amp", "data_format", "fused_stages",
            "prepared", "prepared_steps", "device")}
        if out.get("secondary"):
            summary[name]["secondary"] = {k: out["secondary"].get(k) for k in (
                "metric", "value", "step_ms_p50", "tflops", "mfu", "amp",
                "prepared", "prepared_steps")}
        summary[name].update(seconds=secs, ok=ok)
    if "nhwc_f32" in lines:
        summary["nhwc_f32"]["train_resnet_fused_step_ms_p50"] = fused_step_ms
        summary["nhwc_f32"]["ratio_to_train_resnet_fused"] = \
            lines["nhwc_f32"]["step_ms_p50"] / fused_step_ms
    return lines, {"phase": "bench", "iters": BENCH_ITERS, "runs": summary,
                   "failures": bad, "ok": not bad}


def bench_checks(out, amp, prepared):
    """The checks every bench entry run must pass: finite losses, the
    last below the first, float32 parameters, ``amp`` as asked and an
    mfu exactly under AMP, and with ``prepared`` every timed step
    through the prepared step (without, none)."""
    losses = out["losses"]
    return {"losses": out["losses_finite"] and losses[-1] < losses[0],
            "param_dtypes": out["param_dtypes"] == ["float32"],
            "amp": out["amp"] is amp,
            "mfu": (out["mfu"] is not None) is amp,
            "prepared": out["prepared"] is prepared
            and out["prepared_steps"] == (len(out["step_ms"]) if prepared
                                          else 0)}


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
        spills = {sym: line for lib in report.values()
                  for sym, line in lib["ptxas"].items()
                  if any(k in sym for k in WGMMA_KERNELS)
                  and re.search(r"[1-9]\d* bytes spill", line)}
        if spills:
            raise AssertionError("a wgmma kernel spills: %s" % spills)

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
            eng, load = load_tenant(torch, srv, "f32", cfg, params)
            res, secs, launches, calls, _ = serve(torch, srv, "f32",
                                                  prompts)
            for k in ("flash_fwd", "paged_attention"):
                if launches[k] <= 0:
                    raise AssertionError("%s never launched" % k)
            check = oracle_check(torch, eng, params, prompts[6],
                                 res[6]["tokens"])
            buckets = bucket_checks(torch, eng, SEED + 3)
            emit({"phase": "serve_f32", "launches": launches,
                  **serve_summary(res, secs), "oracle": check,
                  "load": load, "buckets": buckets,
                  "paged_calls": calls})
            if not check["ok"]:
                raise AssertionError("f32 tenant disagrees with "
                                     "dense_forward")
            if not buckets["ok"]:
                raise AssertionError("f32 tenant's bucket steps: %r"
                                     % buckets)

            phase = "serve_int8"
            eng8, load8 = load_tenant(torch, srv, "int8", cfg, params,
                                      quant="int8")
            res8, secs8, launches8, calls8, _ = serve(torch, srv, "int8",
                                                      prompts)
            if min(launches8[k] for k in SERVE_KERNELS) <= 0:
                raise AssertionError("a kernel never launched on the int8 "
                                     "tenant: %r" % launches8)
            agree = sum(a == b for r, r8 in zip(res, res8)
                        for a, b in zip(r["tokens"], r8["tokens"]))
            check8 = oracle_check(torch, eng8, eng8._params, prompts[6],
                                  res8[6]["tokens"])
            buckets8 = bucket_checks(torch, eng8, SEED + 3)
            emit({"phase": "serve_int8", "launches": launches8,
                  **serve_summary(res8, secs8),
                  "token_agreement_with_f32": [agree,
                                               len(prompts) * MAX_NEW],
                  "oracle": check8, "load": load8, "buckets": buckets8,
                  "paged_calls": calls8})
            if not check8["ok"]:
                raise AssertionError("int8 tenant disagrees with "
                                     "dense_forward over its own "
                                     "dequantized weights")
            if not buckets8["ok"]:
                raise AssertionError("int8 tenant's bucket steps: %r"
                                     % buckets8)

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

            phase = "serve_prefix"
            result, launches_prefix = serve_prefix_phase(
                torch, srv, cfg, params, prefix_prompts(cfg, SEED + 4),
                (("", "f32", load), ("int8", "int8", load8)))
            emit(result)
            if not result["ok"]:
                raise AssertionError("serve_prefix: %s"
                                     % "; ".join(result["failures"]))

            phase = "serve_spec"
            srv.unload("f32")
            srv.unload("int8")
            result, launches_spec = serve_spec_phase(torch, srv, timer, cfg,
                                                     params, prompts)
            emit(result)
            if not result["ok"]:
                raise AssertionError("serve_spec: %s"
                                     % "; ".join(result["failures"]))
        finally:
            srv.close()

        phase = "serve_fleet"
        torch.cuda.empty_cache()
        result, launches_fleet = serve_fleet_phase(torch, cfg, params,
                                                   prompts, res, secs)
        emit(result)
        if not result["ok"]:
            raise AssertionError("serve_fleet: %s"
                                 % "; ".join(result["failures"]))

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
            fused_step_ms = result["step_ms_p50"]

        phase = "train_resnet_fused_oracle"
        torch.cuda.empty_cache()
        oracle = resnet_oracle(torch)
        emit(oracle)
        if not oracle["ok"]:
            raise AssertionError("%s: the card's training step disagrees "
                                 "with the CPU one" % phase)

        phase = "infer_resnet_fused_amp"
        torch.cuda.empty_cache()
        result = infer_resnet_amp(torch)
        emit(result)
        if not result["ok"]:
            raise AssertionError("%s failed its checks" % phase)
        launches_train[phase] = result["launches"]
        run_results = {}
        for fused in (False, True):
            phase = ("train_resnet_fused" if fused else "train_resnet") + \
                "_amp"
            torch.cuda.empty_cache()
            result = train_resnet(torch, fused, amp=True)
            emit(result)
            if not result["ok"]:
                raise AssertionError("%s failed its checks" % phase)
            launches_train[phase] = result["launches"]
            run_results[phase] = result

        phase = "train_resnet_fused_amp_oracle"
        torch.cuda.empty_cache()
        oracle = resnet_oracle_amp(torch)
        emit(oracle)
        if not oracle["ok"]:
            raise AssertionError("%s: the card's AMP step disagrees with "
                                 "the CPU one past its spread" % phase)

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

        for fuse in (False, True):
            phase = train_phase(fuse, True)
            torch.cuda.empty_cache()
            result = train(torch, fuse, amp=True)
            emit(result)
            if not result["ok"]:
                raise AssertionError("%s failed its checks" % phase)
            launches_train[phase] = result["launches"]
            run_results[phase] = result

            phase += "_oracle"
            torch.cuda.empty_cache()
            oracle = train_amp_oracle(torch, fuse)
            emit(oracle)
            if not oracle["ok"]:
                raise AssertionError("%s: the card's AMP step disagrees "
                                     "with the CPU one past its spread"
                                     % phase)

        phase = "train_sp_amp"
        torch.cuda.empty_cache()
        result = train_sp(torch, amp=True)
        emit(result)
        if not result["ok"]:
            raise AssertionError("%s failed its checks" % phase)
        launches_train[phase] = result["launches"]

        phase = "train_sp_amp_oracle"
        torch.cuda.empty_cache()
        oracle = train_sp_amp_oracle(torch)
        emit(oracle)
        if not oracle["ok"]:
            raise AssertionError("%s: the card's sp AMP step disagrees with "
                                 "the CPU sp step or the dense card step "
                                 "past the CPU's spread" % phase)

        for path, kind, fused in PREPARED_PATHS:
            phase = path + "_prepared"
            torch.cuda.empty_cache()
            result = train_prepared(torch, path, kind, fused,
                                    run_results[path])
            emit(result)
            if not result["ok"]:
                raise AssertionError("%s failed its checks" % phase)
            launches_train[phase] = result["launches"]

        phase = "bench"
        torch.cuda.empty_cache()
        lines, result = bench_runs(torch, fused_step_ms)
        for line in lines.values():
            emit(line)
        emit(result)
        if not result["ok"]:
            raise AssertionError("bench: %s" % "; ".join(result["failures"]))
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
    # fused step's five projections, K5 at the fused step's seam (each
    # bf16 form of K1-K5 as its f32 form), K6 and
    # its bf16 form as the sum of the ResNet-50 forward's 53 launches, K9
    # at the slower of the ring's diagonal and off-diagonal folds, K10 at
    # the LM's logits
    m = TRAIN_BATCH * TRAIN_LM["seq_len"]
    shard = "[%d,%d,%d,%d]" % (TRAIN_BATCH, TRAIN_LM["n_head"],
                               TRAIN_LM["seq_len"] // SP,
                               TRAIN_LM["d_model"] // TRAIN_LM["n_head"])
    pick = {"flash_fwd": ["[16,8,2048,128] causal"],
            "flash_bwd_dq": ["[16,8,2048,128] causal"],
            "flash_bwd_dkv": ["[16,8,2048,128] causal"],
            "flash_fwd_bf16": ["[16,8,2048,128] causal"],
            "flash_bwd_dq_bf16": ["[16,8,2048,128] causal"],
            "flash_bwd_dkv_bf16": ["[16,8,2048,128] causal"],
            "paged_attention": ["B=16 NB=128 bs=16 H=8 D=128"],
            "matmul_int8": ["M=16 K=1024 N=4096", "M=16 K=4096 N=1024"],
            "matmul_epilogue": ["%s M=%d K=%d N=%d" % (what, m, kk, n)
                                for what, kk, n, _, _ in FUSED_MATMULS],
            "add_ln": ["[%d,%d] affine" % (m, TRAIN_LM["d_model"])],
            "matmul_epilogue_bf16": ["%s M=%d K=%d N=%d" % (what, m, kk, n)
                                     for what, kk, n, _, _ in FUSED_MATMULS],
            "add_ln_bf16": ["[%d,%d] affine" % (m, TRAIN_LM["d_model"])],
            "conv_stage": [CONV_FWD],
            "conv_stage_bf16": [CONV_FWD_BF16],
            "flash_chunk": [shard + " diagonal causal",
                            shard + " non-causal, seeded carry"],
            "flash_chunk_bf16": [shard + " diagonal causal",
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
            "flash_fwd_bf16": (csrc + "flash_bf16.cuh",
                               tpu + "flash_attention.py:68"),
            "flash_bwd_dq_bf16": (csrc + "flash_bwd.cu",
                                  tpu + "flash_attention.py:284"),
            "flash_bwd_dkv_bf16": (csrc + "flash_bwd.cu",
                                   tpu + "flash_attention.py:307"),
            "paged_attention": (csrc + "paged_attention.cu",
                                tpu + "flash_attention.py:496"),
            "matmul_int8": (csrc + "matmul_int8.cu",
                            tpu + "matmul_fused.py:275"),
            "matmul_epilogue": (csrc + "matmul_fused.cu",
                                tpu + "matmul_fused.py:105"),
            "add_ln": (csrc + "matmul_fused.cu",
                       tpu + "matmul_fused.py:394"),
            "matmul_epilogue_bf16": (csrc + "wgmma_gemm.cuh",
                                     tpu + "matmul_fused.py:105"),
            "add_ln_bf16": (csrc + "matmul_fused.cu",
                            tpu + "matmul_fused.py:394"),
            "conv_stage": (csrc + "conv_fused.cu",
                           tpu + "conv_fused.py:73"),
            "conv_stage_bf16": (csrc + "conv_fused.cu",
                                tpu + "conv_fused.py:73"),
            "flash_chunk": (csrc + "flash_chunk.cu",
                            tpu + "flash_attention.py:795"),
            "flash_chunk_bf16": (csrc + "flash_bf16.cuh",
                                 tpu + "flash_attention.py:795"),
            "fused_ce": (csrc + "fused_ce.cu", tpu + "fused.py:29")}
    # launches: each kernel's count on its main path (train_f32 for the
    # flash training kernels, train_fused for K4/K5, train_amp and
    # train_fused_amp for their bf16 forms, train_resnet_fused for K6,
    # train_resnet_fused_amp for K6's bf16 form, train_sp for K9,
    # train_sp_amp for K9's bf16 form, the
    # int8 tenant's serve run, which runs all three serving kernels, for
    # the rest; K10 is on no path, so 0); every path's count stands
    # beside it (the *_prepared phases': the wrappers' calls recorded at
    # capture, held against a trace of the replays)
    bf16_path = {BF16_FORM[k]: "train_amp" for k in TRAIN_KERNELS}
    bf16_path.update({BF16_FORM[k]: "train_fused_amp"
                      for k in FUSED_KERNELS})
    summary = []
    for name in KERNELS:
        r = max((x for x in by_name[name] if x["shape"] in pick[name]),
                key=lambda x: x["ms"])
        path = ("train_resnet_fused" if name == "conv_stage" else
                "train_resnet_fused_amp" if name == "conv_stage_bf16" else
                bf16_path[name] if name in bf16_path else
                "train_sp" if name == "flash_chunk" else
                "train_sp_amp" if name == "flash_chunk_bf16" else
                None if name == "fused_ce" else
                "train_fused" if name in FUSED_KERNELS else
                "train_f32" if name in TRAIN_KERNELS else "serve_int8")
        by_path = {"serve_f32": launches.get(name, 0),
                   "serve_int8": launches8.get(name, 0),
                   "serve_prefix": launches_prefix.get(name, 0),
                   "serve_spec": launches_spec.get(name, 0),
                   "serve_fleet": launches_fleet.get(name, 0),
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
            **({"bound_split_ms": r["bound_split_ms"]}
               if "bound_split_ms" in r else {}),
            "library_ms": r["library_ms"], "shape": r["shape"]})
    emit({"kernels": summary})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
