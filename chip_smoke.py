#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (paddle_tpu_torch) on one NVIDIA GPU.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases, each printed as one JSON line:

1. device  — nvidia-smi name and power limit, torch and CUDA versions;
2. build   — nvcc build of every kernel under paddle_tpu_torch/kernels/csrc;
3. kernels — each kernel against its plain PyTorch version on the card,
             at the serving and training paths' shapes, with times (CUDA
             events, median of 11, L2 flushed before each launch) beside
             the plain version, a PyTorch library yardstick and the
             card's bound (the f32 matrix-product kernels K1-K4, K6 and
             K9 against split-TF32 tensor-core products, K8 against the
             two-MMA split its exact int8 weights allow, the rest
             against f32 FMAs; ``ops_rate`` says which); K4 also at
             every epilogue variant on ragged shapes; each K4, K6 and
             K8 row's ``form`` names the form it ran;
3a. train_fused_dropout, train_fused_dropout_amp — the FFN half of a
             block at the flagship widths (16384 rows, 1024 -> 4096
             gelu -> dropout 0.1 -> 1024 -> dropout 0.1 -> + x),
             fused: two fused_matmul_bias_act a step with their dropout
             branch (K4, then the mask and the residual in torch), one
             CUDA graph replay a step (the batch staged on the card):
             K4 (its bf16 form under AMP) twice a step, recorded and
             traced; every replay draws new masks keeping 1 - p within
             5 sigma; 20 run() and 20 prepared steps bit-identical;
             with an explicit seed the fused and unfused programs draw
             the same masks, each fused op's Out and MulOut against the
             plain version of its composition (K4's bars), the fused and
             unfused gradients within 1e-4 (bf16 2**-7); step ms, device
             ms and idle share;
3b. train_vgg, train_vgg_amp — VGG16-BN (flowers, 224 x 224, 102
             classes, Adam 1e-3, NCHW; no TPU kernel on its path), f32
             through run() and the prepared step at batch 256 or, where
             it does not fit, the largest halving that does, and bf16
             AMP (FLAGS_bn_bf16) prepared at 256: step ms, images/s,
             peak memory, the device's idle share, 3 prepared steps
             against 3 run() steps from one scope;
3c. train_vgg_oracle — one f32 VGG step at batch 4 on the card against
             Executor(CPUPlace()) on a desc copy with every dropout_prob
             0, at twice the CPU's one-ulp spread, as phase 14 holds
             ResNet-50;
3d. sparse_update — an is_sparse 8192 x 1024 table (its gradient a
             SelectedRows, duplicate ids every batch) under sgd,
             momentum and lazy adam: 3 captured steps against 3 CPU
             run() steps, losses and persistables within 1e-6;
3e. checkpoint_prepared_amp, trainer_resume, host_ops — checkpoints and
             the host-op runtime (in a child process, ``--slice22``):
             the fused-block LM under bf16 AMP at full width through
             the prepared step, saved in the middle of the loop and
             resumed in a fresh executor and scope, bit for bit; the
             f32 fused LM through fluid.Trainer (no place: the card),
             killed and resumed bit for bit, then the Inferencer and an
             inference model's feed / fetch ops, the logits bit for
             bit; Print as a postlude and between device ops; the
             checkpoint's bytes and the save's and load's GB/s;
3f. train_lstm, train_lstm_amp, train_lstm_ragged, train_lstm_oracle,
             train_sentiment_conv — ragged (LoD) feeds and the sequence
             ops (in a child process, ``--slice23``; no TPU kernel on
             the path): the stacked dynamic LSTM at bench.py's card
             width (64 sequences of 80 tokens, hidden 512, 3 stacks, a
             5000-word vocabulary, Adam 2e-3), f32 and bf16 AMP, through
             run() and the prepared step (step ms p50, examples/s, peak
             memory, capture s, the device's idle share), 3 prepared
             steps bit for bit against 3 run() steps; the same model on
             seeded batches of 64 sequences of 8-80 tokens whose
             longest fall in 3 padded buckets (one captured graph a
             bucket, all in one memory pool, the pool and the reserved
             bytes after each new bucket; losses finite and falling on
             the repeated batch; bit for bit against run()); one f32
             step at 4 sequences of 5-23 tokens against
             Executor(CPUPlace()) at twice the CPU's one-ulp spread
             (every parameter moved), never below 1e-4, the median at
             twice the median spread, and a TF32 control past the bar;
             understand_sentiment's conv net (is_sparse embedding,
             Adagrad) on ragged batches, 3 captured steps against 3 CPU
             run() steps, losses and persistables within 1e-6;
3g. control_flow, train_sentiment_dyn_rnn, train_sentiment_dyn_rnn_amp,
             train_rnn_seq2seq, rnn_oracle — sub-blocks and control
             flow (in a child process, ``--slice24``; no TPU kernel on
             the path): tests/test_control_flow.py's While, array,
             conditional_block, Switch and IfElse programs on the card
             against the CPU (integer, condition and selected results
             exact); prepare() raises Uncapturable for while and
             conditional_block, also inside a DynamicRNN body, and a
             fluid.Trainer over such a program falls back to run();
             the book's DynamicRNN sentiment LSTM (emb 32, hidden 128,
             IMDB's 5147 words, batch 128, Adagrad 0.002; f32 and bf16
             AMP) and the seq2seq model (dict 30000, dims 32, Adam,
             batch 64) on three ragged buckets, each captured once and
             replayed once in one memory pool, bit for bit against
             run(): ms a step of both paths, a traced step's device
             kernels, the idle share; one f32 step of each model
             against Executor(CPUPlace()) at twice the CPU's one-ulp
             spread (no floor) with a TF32 control past it;
3h. train_lm_sched, train_lm_sched_fused_amp, train_lm_sched_oracle,
             optimizers, train_alexnet, train_alexnet_oracle,
             train_googlenet, train_googlenet_oracle — the training
             front end (in a child process, ``--slice25``): the flagship
             LM (batch 16, unfused f32) built from the reference's
             public API under noam_decay(1024, 4000), a global-norm
             clip of 1.0 and L2Decay(1e-4) with Adam, through the
             prepared step (the counter's increment, the schedule, the
             clip and the decay inside one CUDA graph replay a step) and
             run(), 6 steps bit for bit (losses, learning rates, every
             persistable, the step counter), each learning rate within
             one f32 ulp of its float64 formula, K1-K3 n_layers times a
             step, step ms and tokens/s beside the plain train_f32
             program's on both paths and a traced replay of each; the
             fused-block LM under bf16 AMP with piecewise_decay([2, 4],
             ...) crossing both boundaries inside the replays, bit for
             bit, K1-K5 bf16 as train_fused_amp; one f32 step of the
             scheduled LM at depth 1 against the CPU (ulp_oracle); each
             new optimizer, ModelAverage's apply and restore, the
             value and norm clips and L1Decay on a small fc program, 3
             captured steps against the CPU within 1e-6 or twice its
             one-ulp spread; AlexNet and GoogLeNet through the bench
             entry (flowers 224 x 224, batch 256, bf16; images/s,
             vs_baseline), each with an f32 oracle at batch 4 (the same
             seeded dropout masks on both places through
             ops/random.keep_mask; no TPU kernel on their path);
3i. train_mt, train_mt_oracle, train_recommender,
             train_recommender_oracle, train_srl, train_srl_oracle, ctc,
             beam_decode — crf_ctc, beam_search and the last three book
             models (in a child process, ``--slice26``; no TPU kernel on
             the path): machine_translation at its defaults (dicts
             10000, emb and hidden 256; batch 64 of wmt14's synthetic
             corpus in buckets T 8 and 16), the recommender (batch 64 of
             movielens, its sparse tables) and label_semantic_roles
             (hidden 512, depth 8, the word table trained, batch 16 of
             conll05 in buckets T 8, 16 and 24, its Viterbi path
             fetched), each through the prepared step (one graph a
             bucket, one pool) and run(), bit for bit, step ms p50 and
             peak memory, and one f32 step of each at batch 4 against
             the CPU (``ulp_oracle``, floor LSTM_ORACLE_GRAD_FLOOR, a
             TF32 control past the bar, the Viterbi path equal); warpctc's
             loss and gradient against the CPU and ctc_greedy_decoder's
             ids equal to the CPU's; the While-loop beam decode of
             tests/test_beam_search.py and one of 8 sentences x 4 beams
             over 1,000 words through run(), ids bit for bit and scores
             within BEAM_SCORE_TOL of the CPU's, prepare() refused;
3j. train_ssd, train_ssd_oracle, detect_ssd, conv_family — the conv
             family, the detection / misc / metric ops and MobileNet-SSD
             (in a child process, ``--slice27``; no TPU kernel on the
             path): mobilenet_ssd.py's MobileNet-SSD (300 x 300, 21
             classes, its six maps into multi_box_head, ssd_loss, Adam;
             ``build_mobilenet_ssd``) at batch 32 on synthetic images
             whose ragged gt (1-8 and 1-16 boxes an image) pad to two
             buckets, through the prepared step (one graph a bucket, one
             pool, each prior_box a device constant) and run(), bit for
             bit, the loss falling, step ms p50 of both, capture s, peak
             memory, a traced replay's device ms, idle share and kernel
             families; one f32 step at batch 4 against the CPU
             (``ulp_oracle``, floor 1e-4, the spread cap
             SSD_ORACLE_SPREAD_MAX, a TF32 control past the bar); the
             detection program at batch 8 through run() (prepare()
             refuses its host ops), its NMS rows, counts and mAP equal to
             the port's host ops on the CPU over the card's decoded boxes
             and scores, the NMS's host ms; conv2d_transpose, conv3d,
             depthwise_conv2d, row_conv, spp, roi_pool,
             max_pool2d_with_index, unpool and conv_shift once each at a
             realistic shape (CONV_FAMILY), forward and gradients against
             the CPU, ms a call;
3k. bench_real, train_reader_k6, loader_oracle — the data pipeline (in
             a child process, ``--slice28``; K6 bf16 on the path): the
             bench entry at its card defaults for ResNet-50, whose
             BENCH_FAKE default is now 0 (the flowers adapter's synthetic
             images in an uncompressed recordio file under _smoke_io/,
             staged once in a DeviceDatasetCache, shuffled on the card
             each epoch; the stream probe: idle h2d MB/s, images/s
             through the double-buffered DeviceLoader, the overlap
             ratio), beside BENCH_FAKE=1 in the same child, images/s,
             peak memory, the file's and the cache's bytes; the full
             ResNet-50 at batch 256, NHWC fused stages, bf16 AMP, fed
             through run() by open_files -> shuffle -> batch ->
             double_buffer -> read_file over a recordio file of 1024
             seeded images (the native codec must have built): the
             read op's batches equal the host-decoded ones, and fed
             through run() from the same start they give every loss and
             persistable bit for bit (cuDNN's deterministic algorithms);
             K6 bf16 53 launches a step by the wrappers' counts and in a
             trace of TRACED_REPLAYS steps (device ms, idle share);
             fluid.core.EOFException after the epoch, reset(), a step
             more; DeviceLoader's batches byte-identical to the host's,
             the cache's epoch covering each sample once and reshuffled,
             a mid-epoch double-buffer reset leaving no copy in flight;
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
29. bench — the port's bench entry (paddle_tpu_torch.tools.bench's
             main(), every run in one child process, ``--bench-child``),
             prepared by default, on one synthetic batch (BENCH_FAKE=1;
             phase 3k's bench_real runs the real-data default), at its
             default headline (ResNet-50, bf16 AMP, NCHW, batch 256,
             with its secondary, the flagship LM, which must be the bf16
             LM), then (information) with BENCH_PREPARED=0 (run()), and
             with BENCH_LAYOUT=NHWC (no secondary), each with
             BENCH_ITERS=5, then (information) at BENCH_AMP=0
             BENCH_LAYOUT=NHWC beside phase 13's step, then
             BENCH_MODEL=transformer at its card default (bf16),
             unfused and BENCH_FUSED_TRANSFORMER=1, then
             BENCH_MODEL=vgg (bf16, batch 256) and BENCH_MODEL=resnet32
             (BENCH_DATASET=cifar10); each must exit 0
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

    def __call__(self, fn, iters=11, warmup=3):
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
TRAIN_STEPS = 3
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
RESNET_STEPS = 3
RESNET_CONVS = 53      # conv stages: K6 launches a fused step or forward
RESNET_ORACLE_BATCH = 2
RESNET_PATHS = ("infer_resnet_fused", "train_resnet", "train_resnet_fused")
BENCH_ITERS = 5
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


def fro_rel(a, b, scale=None):
    """||a - b|| / ||b|| in float64 (Frobenius norm); 0 where a == b."""
    import numpy as np

    a, b = a.astype(np.float64), b.astype(np.float64)
    d = float(np.linalg.norm(a - b))
    return d / float(np.linalg.norm(b)) if d else 0.0


def ulp_oracle(fluid, main, arrays, feed, fetch, n, perturb, rel, floor,
               median_floor=None, spread_max=RESNET_ORACLE_SPREAD_MAX):
    """One f32 step of ``main`` on ``feed`` from the persistables
    ``arrays``, on the card and on Executor(CPUPlace()), then on the CPU
    again with one ulp added to every array that ``perturb(name,
    array)`` selects (the step's own f32 spread).  ``fetch`` is the
    loss, then the ``n`` gradients held, then whatever the caller reads
    besides.  Each gradient's error ``rel(card, cpu, scale)`` (``scale``:
    the largest |value| of the CPU's gradients) is held to
    RESNET_ORACLE_SPREAD times the worst CPU spread ``rel(moved, cpu,
    scale)``, never below ``floor``, and the median error to that
    multiple of the median spread, never below ``median_floor`` (else
    ``floor``); the loss to RESNET_ORACLE_LOSS_RTOL
    relative; a worst spread above ``spread_max``
    (RESNET_ORACLE_SPREAD_MAX) fails, so that no unstable step raises
    its own bar without limit.  Returns
    the card's, the CPU's and the moved CPU's fetches (a SelectedRows
    made dense, ``dense_rows``), and the summary (its "ok")."""
    import numpy as np

    from paddle_tpu_torch.fluid.io import set_scope_arrays

    card = fluid.Scope()
    set_scope_arrays(card, arrays, "cuda")
    got = fluid.Executor(fluid.CUDAPlace(0)).run(main, feed=feed,
                                                 fetch_list=fetch,
                                                 scope=card)
    del card
    cpu = []
    for ulp in (False, True):
        host = fluid.Scope()
        set_scope_arrays(host, {
            k: np.nextafter(v, np.float32(np.inf)) if ulp and perturb(k, v)
            else v for k, v in arrays.items()}, "cpu")
        cpu.append(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=host))
    got, want, moved = ([dense_rows(v) for v in x]
                        for x in (got, cpu[0], cpu[1]))
    loss = [float(x[0].ravel()[0]) for x in (got, want, moved)]
    loss_err = abs(loss[0] - loss[1]) / abs(loss[1])
    scale = max(float(np.abs(b).max()) for b in want[1:1 + n])
    grads = {name: {"fro_rel": rel(a, b, scale),
                    "cpu_ulp_fro_rel": rel(c, b, scale)}
             for name, a, b, c in zip(fetch[1:1 + n], got[1:1 + n],
                                      want[1:1 + n], moved[1:1 + n])}
    spread = max(g["cpu_ulp_fro_rel"] for g in grads.values())
    tol = max(floor, RESNET_ORACLE_SPREAD * spread)
    median = _pct([g["fro_rel"] for g in grads.values()], 0.5)
    median_spread = _pct([g["cpu_ulp_fro_rel"] for g in grads.values()], 0.5)
    median_tol = max(floor if median_floor is None else median_floor,
                     RESNET_ORACLE_SPREAD * median_spread)
    worst = max(grads, key=lambda g: grads[g]["fro_rel"])
    ok = (math.isfinite(loss_err) and loss_err <= RESNET_ORACLE_LOSS_RTOL
          and spread <= spread_max and median <= median_tol
          and all(math.isfinite(g["fro_rel"]) and g["fro_rel"] <= tol
                  for g in grads.values()))
    return got, want, moved, {
        "loss_card": loss[0], "loss_cpu": loss[1], "loss_cpu_ulp": loss[2],
        "loss_rel_err": loss_err,
        "worst_grad": worst, "worst_fro_rel": grads[worst]["fro_rel"],
        "median_fro_rel": median, "cpu_ulp_worst_fro_rel": spread,
        "cpu_ulp_median_fro_rel": median_spread,
        "cpu_ulp_tolerance": spread_max, "grads": grads,
        "loss_tolerance": RESNET_ORACLE_LOSS_RTOL, "grad_floor": floor,
        "grad_tolerance": tol, "median_grad_tolerance": median_tol,
        "ok": ok}


def dense_rows(v):
    """A fetched SelectedRows (a sparse embedding's gradient, numpy rows
    and values) as its dense array, duplicate rows summed; any other
    fetch as it is."""
    import numpy as np

    if not hasattr(v, "height"):
        return v
    out = np.zeros((v.height,) + v.values.shape[1:], v.values.dtype)
    np.add.at(out, v.rows, v.values)
    return out


def start_arrays(fluid, main, startup, place):
    """The persistables of ``main`` (sorted names) and their values after
    ``startup`` on ``place``, as numpy arrays."""
    from paddle_tpu_torch.fluid.io import get_scope_arrays

    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    start = fluid.Scope()
    fluid.Executor(place).run(startup, scope=start)
    return persist, get_scope_arrays(start, persist)


def resnet_oracle(torch, seed=SEED):
    """One step of the fused ResNet-50 at full width and depth, batch
    RESNET_ORACLE_BATCH, held by ``ulp_oracle`` with one ulp added to
    every filter, never below ORACLE_GRAD_RTOL (relu flips); the flips
    counted on the zero pattern of each relu stage's Y.  ``seed`` draws
    the parameters and the batch."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = build_resnet(fluid, True)
    startup.random_seed = seed
    _, arrays = start_arrays(fluid, main, startup, fluid.CUDAPlace(0))
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    relu_y = [op.output("Y")[0] for op in main.desc.blocks[0].ops
              if op.type == "fused_conv2d_bn_act" and op.attr("act") == "relu"]
    fetch = [loss.name] + [p + "@GRAD" for p in params] + relu_y
    feed = resnet_batch(RESNET_ORACLE_BATCH, seed + 7)
    n = len(params)
    reset_launches()
    got, want, moved, held = ulp_oracle(
        fluid, main, arrays, feed, fetch, n, lambda k, v: v.ndim == 4,
        fro_rel, ORACLE_GRAD_RTOL)
    k6 = KERNELS["conv_stage"].launches

    def flips(xs, ys):
        return sum(int(((a > 0) != (b > 0)).sum()) for a, b in zip(xs, ys))

    return {"phase": "train_resnet_fused_oracle", "depth": 50,
            "batch": RESNET_ORACLE_BATCH, "seed": seed,
            "conv_stage_launches": k6,
            "relu_flips": flips(got[1 + n:], want[1 + n:]),
            "relu_flips_cpu_ulp": flips(moved[1 + n:], want[1 + n:]),
            "relu_outputs": int(sum(a.size for a in want[1 + n:])),
            **held, "ok": held["ok"] and k6 == RESNET_CONVS}


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
TRACE_ATTEMPTS = 3     # profiler sessions, while a reading falls short


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
    # per replay; the launches a replay makes are read from a trace.  A
    # process that has run many profiler sessions may lose events from
    # a replay's trace (PERF.md §7): a reading short of the recorded
    # counts is traced again, up to TRACE_ATTEMPTS sessions, and every
    # reading is reported
    per_step = {k: launches[k] / steps for k in KERNELS}
    readings = []
    for _ in range(TRACE_ATTEMPTS):
        traced = traced_launches(torch, lambda: prep.run_prepared(feed),
                                 TRACED_REPLAYS)
        readings.append(traced)
        if traced is not None and all(n == per_step[k]
                                      for k, n in traced.items()):
            break
    prep.sync_scope()
    p50 = _pct(step_ms, 0.5)
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
            "trace_readings": readings,
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


# ---------------------------------------------------------------------------
# slice 21: dropout and its random stream in a captured step (K4's
# dropout branch), VGG16-BN, the sparse updates
# ---------------------------------------------------------------------------

DROPOUT_P = 0.1
DROPOUT_ROWS = (8, 2048)        # 16384 rows of the flagship LM's width
DROPOUT_STEPS = 20              # run() against run_prepared, bit for bit
DROPOUT_SEED = 11               # the explicit seed of the fused/unfused pair
DROPOUT_TIMED = 10              # more replays timed, after the checked 3
# K4 launches a step: fc1 (gelu, dropout) and fc2 (dropout, residual)
DROPOUT_K4 = 2
# a replay's K4 kernels by symbol: the f32 form's split-TF32 tile, the
# bf16 form's wgmma tile
K4_SYMBOLS = {"matmul_epilogue": "gemm::gemm_kernel",
              "matmul_epilogue_bf16": "gemm_bf16_kernel"}


def dropout_chain(fluid, fuse, amp, seed=None):
    """The FFN half of a transformer block at the flagship LM's widths:
    x [8, 2048, 1024] -> fc 4096 + gelu -> dropout(0.1) -> fc 1024 ->
    dropout(0.1) -> + x, a squared error against y, Adam; under
    FLAGS_transformer_fuse (``fuse``) each fc chain is one
    fused_matmul_bias_act (K4, the mask and the residual in torch);
    under bf16 AMP with ``amp``.  Returns (main, startup, loss, the
    two dropout Masks, the fused ops' Outs or None)."""
    d, dff = TRAIN_LM["d_model"], TRAIN_LM["d_ff"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[DROPOUT_ROWS[1], d],
                              dtype="float32")
        y = fluid.layers.data(name="y", shape=[DROPOUT_ROWS[1], d],
                              dtype="float32")
        h = fluid.layers.fc(x, size=dff, num_flatten_dims=2, act="gelu")
        h = fluid.layers.dropout(h, dropout_prob=DROPOUT_P, seed=seed)
        h = fluid.layers.fc(h, size=d, num_flatten_dims=2)
        h = fluid.layers.dropout(h, dropout_prob=DROPOUT_P, seed=seed)
        out = fluid.layers.elementwise_add(x, h)
        loss = fluid.layers.mean(fluid.layers.square_error_cost(out, y))
        if fuse:
            counts = fluid.transpiler.TransformerFuseTranspiler().transpile(
                main)
            if counts.get("matmul_bias_act") != DROPOUT_K4:
                raise AssertionError("the fuse pass: %r" % counts)
        fluid.optimizer.Adam(learning_rate=1e-4).minimize(loss)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    ops = main.desc.blocks[0].ops
    kind = "fused_matmul_bias_act" if fuse else "dropout"
    masks = [op.output("Mask")[0] for op in ops
             if op.type == kind and op.output("Mask", [])]
    fused = [op for op in ops if op.type == "fused_matmul_bias_act"]
    return main, startup, loss, masks, fused


def dropout_batch(seed):
    import numpy as np

    rng = np.random.RandomState(seed)
    shape = DROPOUT_ROWS + (TRAIN_LM["d_model"],)
    return {"x": rng.randn(*shape).astype(np.float32),
            "y": rng.randn(*shape).astype(np.float32)}


def traced_k4(torch, step, n):
    """{K4 form: launches a step} of ``n`` calls of ``step`` (one replay
    each), read from a ``torch.profiler`` trace by kernel symbol; None
    when the trace holds no device event."""
    from paddle_tpu_torch.tools.profile_train import device_kernels

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(n):
            step()
        torch.cuda.synchronize()
    kernels = device_kernels(prof, n)
    if not kernels:
        return None
    return {name: sum(v["calls_per_step"] for k, v in kernels.items()
                      if sym in k) for name, sym in K4_SYMBOLS.items()}


def _fro_rel(np, a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    d = float(np.linalg.norm(a - b))
    return d / max(float(np.linalg.norm(b)), 1e-30) if d else 0.0


def train_fused_dropout(torch, amp):
    """Phase train_fused_dropout[_amp]: ``dropout_chain`` fused, as a
    prepared step (one CUDA graph replay a step).  Gates:

    - K4 launches DROPOUT_K4 times a step (its bf16 form under AMP, no
      other form), recorded at capture and read from a trace of two
      replays;
    - run-seeded masks differ between replays, each keeping 1 - p of
      the elements within 5 sigma;
    - DROPOUT_STEPS steps of run() and of run_prepared from one start
      are bit-identical: losses and every persistable;
    - with an explicit seed, the fused and the unfused programs draw the
      same masks; each fused op's Out and MulOut are held to K4's bar
      against the plain version of its composition on its own inputs
      (f32 atol = rtol = 1e-4; bf16 one ulp plus 1e-6 of max |Y|), and
      the parameter gradients of the fused and unfused programs agree
      (f32: relative Frobenius 1e-4; bf16: 2**-7, one bf16 ulp)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.kernels import matmul_fused as mf

    k4 = "matmul_epilogue_bf16" if amp else "matmul_epilogue"
    feed = dropout_batch(SEED + 21)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    main, startup, loss, masks, _ = dropout_chain(fluid, True, amp)
    start = fluid.Scope()
    exe.run(startup, scope=start)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    init = get_scope_arrays(start, persist)
    failures = []

    # the captured step: launches, fresh masks, the keep rate; the
    # batch staged on the card once, so that a step copies it device to
    # device (from the host, its 128 MB would cross PCIe every step)
    scope = fluid.Scope()
    set_scope_arrays(scope, init, "cuda")
    dfeed = {k: torch.from_numpy(v).cuda() for k, v in feed.items()}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prep = exe.prepare(main, feed_specs=dfeed, fetch_list=[loss] + masks,
                       scope=scope)
    t0 = time.perf_counter()
    prep.run_prepared(dfeed)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    reset_launches()
    step_ms, outs = [], []
    for _ in range(3):
        t0 = time.perf_counter()
        o = prep.run_prepared(dfeed)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        outs.append(o)
    counted = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    launches = {k: n / 3 for k, n in counted.items()}
    for _ in range(DROPOUT_TIMED):
        t0 = time.perf_counter()
        prep.run_prepared(dfeed)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    want = {k: DROPOUT_K4 if k == k4 else 0 for k in K4_SYMBOLS}
    traced = traced_k4(torch, lambda: prep.run_prepared(dfeed), 1)
    device_ms, idle = idle_share(torch, lambda: prep.run_prepared(dfeed), 1)
    prep.sync_scope()
    peak = torch.cuda.max_memory_allocated()
    if launches != {k4: DROPOUT_K4}:
        failures.append("launches a step %r" % launches)
    if traced != want:
        failures.append("traced launches a replay %r" % traced)
    keep = [float((o[1] != 0).float().mean()) for o in outs]
    n = outs[0][1].numel()
    sigma = math.sqrt(DROPOUT_P * (1 - DROPOUT_P) / n)
    fresh = all(not torch.equal(outs[i][j], outs[i + 1][j])
                for i in range(2) for j in (1, 2))
    if not fresh:
        failures.append("a replay drew its predecessor's mask")
    if any(abs(k - (1 - DROPOUT_P)) > 5 * sigma for k in keep):
        failures.append("keep rate %r" % keep)
    del outs, prep

    # run() against run_prepared, DROPOUT_STEPS steps from one start
    runs = {}
    for prepared in (False, True):
        s = fluid.Scope()
        set_scope_arrays(s, init, "cuda")
        if prepared:
            with exe.prepare(main, feed_specs=feed, fetch_list=[loss],
                             scope=s) as p:
                ls = [p.run_prepared(feed, return_numpy=True)[0]
                      for _ in range(DROPOUT_STEPS)]
        else:
            ls = [exe.run(main, feed=feed, fetch_list=[loss], scope=s)[0]
                  for _ in range(DROPOUT_STEPS)]
        runs[prepared] = (np.concatenate([np.ravel(x) for x in ls]),
                          get_scope_arrays(s, persist))
        del s
        torch.cuda.empty_cache()
    identical = bool(np.array_equal(runs[False][0], runs[True][0]) and all(
        np.array_equal(runs[False][1][k], runs[True][1][k])
        for k in persist))
    if not identical:
        differ = [k for k in persist
                  if not np.array_equal(runs[False][1][k], runs[True][1][k])]
        failures.append("run() and run_prepared differ: losses %s, %d "
                        "persistables" % (
                            not np.array_equal(runs[False][0],
                                               runs[True][0]), len(differ)))
    losses = runs[True][0].tolist()
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        failures.append("losses %r" % losses[:3])
    del runs

    # an explicit seed: the fused and the unfused programs
    pair = {}
    for fuse in (False, True):
        m, st, ls, mk, fused = dropout_chain(fluid, fuse, amp,
                                             seed=DROPOUT_SEED)
        params = sorted(p.name for p in m.all_parameters())
        fetch = mk + [p + "@GRAD" for p in params]
        ins = []
        for op in fused:
            ins.append([op.attr("act"), op.input("X")[0], op.input("W")[0],
                        op.input("Bias")[0], op.output("Out")[0],
                        op.output("MulOut", [None])[0],
                        op.output("Mask")[0]]
                       + op.input("Residual", []))
        flat = sorted({n for names in ins for n in names[1:]
                       if n is not None and n not in persist})
        s = fluid.Scope()
        set_scope_arrays(s, init, "cuda")
        with exe.prepare(m, feed_specs=feed, fetch_list=fetch + flat,
                         scope=s) as p:
            got = p.run_prepared(feed)
        vals = dict(zip(fetch + flat, got))
        kernel = []
        for act, x, w, b, out, pre, mask, *res in ins:
            xt, wt, bt = vals[x], s.find_var(w), s.find_var(b)
            # the step updated W and b: the forward read their starting
            # values
            wt = torch.from_numpy(init[w]).cuda().to(wt.dtype)
            bt = torch.from_numpy(init[b]).cuda().to(bt.dtype)
            if amp:
                wt, bt = wt.to(torch.bfloat16), bt.to(torch.bfloat16)
                xt = xt.to(torch.bfloat16)
            x2 = xt.reshape(-1, wt.shape[0])
            ref = mf.matmul_epilogue_f32acc_reference if amp else \
                mf.matmul_epilogue_reference
            h, pre_want = ref(x2, wt, bt, None, act)
            want = h * vals[mask].reshape(h.shape).to(h.dtype)
            if res:
                want = want + vals[res[0]].reshape(h.shape).to(h.dtype)
            e1, ok1 = (None, True) if pre is None else compare(
                torch, vals[pre].reshape(h.shape), pre_want)
            got_out = vals[out].reshape(h.shape)
            if amp and res:
                # one ulp of h (K4's own bar) carried through the bf16
                # residual add, plus that add's rounding
                from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

                w32 = want.float()
                err = (got_out.float() - w32).abs()
                bound = bf16_ulp(h.float()) + bf16_ulp(w32) + \
                    1e-6 * w32.abs().max()
                e2, ok2 = float(err.max()), bool((err <= bound).all())
            else:
                e2, ok2 = compare(torch, got_out, want)
            kernel.append({"shape": "M=%d K=%d N=%d" % (
                x2.shape[0], x2.shape[1], wt.shape[1]), "act": act,
                "residual": bool(res), "mulout_max_abs_err": e1,
                "out_max_abs_err": e2, "ok": ok1 and ok2})
        pair[fuse] = {"masks": [vals[k].float().cpu().numpy() for k in mk],
                      "grads": {k: vals[k + "@GRAD"].float().cpu().numpy()
                                for k in params}, "kernel": kernel}
        del s, vals, got
        torch.cuda.empty_cache()
    same_masks = all(np.array_equal(a, b) for a, b in
                     zip(pair[False]["masks"], pair[True]["masks"]))
    if not same_masks:
        failures.append("the fused and unfused programs drew other masks "
                        "with seed %d" % DROPOUT_SEED)
    if not all(k["ok"] for k in pair[True]["kernel"]):
        failures.append("K4's dropout branch against its plain version: "
                        "%r" % pair[True]["kernel"])
    grad_tol = 2.0 ** -7 if amp else 1e-4
    grads = {k: _fro_rel(np, pair[True]["grads"][k], pair[False]["grads"][k])
             for k in pair[False]["grads"]}
    if not all(v <= grad_tol for v in grads.values()):
        failures.append("fused vs unfused gradients %r" % grads)
    p50 = _pct(step_ms, 0.5)
    return {"phase": "train_fused_dropout" + ("_amp" if amp else ""),
            "amp": amp, "rows": DROPOUT_ROWS[0] * DROPOUT_ROWS[1],
            "d_model": TRAIN_LM["d_model"], "d_ff": TRAIN_LM["d_ff"],
            "dropout_prob": DROPOUT_P, "captured": True,
            "first_step_s": capture_s, "step_ms": step_ms,
            "step_ms_p50": p50,
            "tokens_per_s": DROPOUT_ROWS[0] * DROPOUT_ROWS[1] / p50 * 1e3,
            "max_memory_allocated_bytes": peak,
            "device_ms_per_step": device_ms, "device_idle_share": idle,
            "feeds": "staged on the card once (a device-to-device copy "
                     "a step)",
            "launches_per_step": launches,
            "launches_per_step_wanted": {k4: DROPOUT_K4},
            "launches": counted,
            "replay_launches_traced_per_step":
                traced if traced is not None else "not measured",
            "keep_rate": keep, "keep_sigma": sigma,
            "masks_fresh_each_replay": fresh,
            "run_vs_prepared_steps": DROPOUT_STEPS,
            "run_vs_prepared_bit_identical": identical,
            "losses_prepared": losses,
            "explicit_seed_masks_identical": same_masks,
            "k4_vs_plain": pair[True]["kernel"],
            "fused_vs_unfused_grad_fro_rel": grads,
            "grad_tolerance": grad_tol, "failures": failures,
            "ok": not failures}


VGG = dict(data_set="flowers", learning_rate=1e-3)
VGG_BATCH = 256
VGG_STEPS = 3
VGG_ORACLE_BATCH = 4
VGG_PROFILED = 1        # steps traced for the device's idle share
TRAIN_FLOPS_PER_IMG_VGG16 = 46.5e9      # bench.py:55


def build_vgg(fluid, amp=False):
    from paddle_tpu_torch.models import vgg

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = vgg.get_model(**VGG)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


def vgg_batch(batch, seed):
    """bench.py's fake VGG batch: float32 images in [0, 1), 102 labels."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return {"data": rng.rand(batch, 3, 224, 224).astype(np.float32),
            "label": rng.randint(0, 102, (batch, 1)).astype(np.int64)}


def idle_share(torch, step, n):
    """(device ms a step, the device's idle share) over ``n`` calls of
    ``step`` under ``torch.profiler``: the kernels', memcpys' and
    memsets' summed time against the wall time; ("not measured", ...)
    when the trace holds no device event."""
    from paddle_tpu_torch.tools.profile_train import device_kernels

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = device_kernels(prof, n)
    if not kernels:
        return "not measured", "not measured"
    busy = sum(k["ms_per_step"] for k in kernels.values())
    return busy, max(0.0, 1.0 - busy / wall)


def train_vgg(torch, amp):
    """Phases train_vgg (f32: run() and the prepared step) and
    train_vgg_amp (bf16 AMP with FLAGS_bn_bf16, the bench entry's
    default: the prepared step): VGG16-BN at bench.py's card default
    (flowers, 224 x 224, batch 256, 102 classes, Adam 1e-3), NCHW, its
    ten dropout layers drawing from the step's stream.  f32 at batch 256
    may not fit the card: the batch halves until it does, and the
    result says so.  Each path: 1 warm-up step (the prepared one
    captures), VGG_STEPS timed steps on one batch, step ms p50,
    images/s, peak memory, the device's idle share over VGG_PROFILED
    profiled steps; no kernel of the port runs (the path reaches no TPU
    kernel); the prepared steps against run() (``prepared_agreement``;
    where run() is not bit-identical run to run, the losses alone)."""
    with bn_bf16(amp):
        return _train_vgg(torch, amp)


def _train_vgg(torch, amp):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays

    main, startup, loss = build_vgg(fluid, amp)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    start = fluid.Scope()
    exe.run(startup, scope=start)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    init = get_scope_arrays(start, persist)
    del start
    paths = ("prepared",) if amp else ("run", "prepared")
    batch, failures = VGG_BATCH, []
    while True:
        try:
            out = {path: _vgg_path(torch, fluid, exe, main, loss, init,
                                   persist, path, batch) for path in paths}
            break
        except RuntimeError as e:
            # an allocation that failed, raised as it is or by the
            # capture that wraps it
            if not _out_of_memory(torch, e) or amp or batch <= 8:
                raise
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            batch //= 2
    for path, res in out.items():
        if not res["ok"]:
            failures.append("%s: %s" % (path, res["failures"]))
    feed = vgg_batch(batch, SEED + 9)
    torch.cuda.empty_cache()
    agreement = prepared_agreement(torch, fluid, main, loss, feed, persist,
                                   init)
    # where run() is not bit-identical run to run (cuDNN's f32 grad
    # convs sum with atomics), Adam turns the order noise of near-zero
    # gradients (the BN biases') into steps of about lr, and one run()
    # pair under-reads that spread: the losses are held, the
    # persistables reported
    held = agreement["ok"] or (
        not agreement["run_bit_identical_run_to_run"]
        and agreement["loss"]["fro_rel"] <= agreement["loss"]["tolerance"])
    if not held:
        failures.append("prepared against run(): %r"
                        % agreement["worst_vs_tolerance"])
    p = out["prepared"]
    result = {"phase": "train_vgg" + ("_amp" if amp else ""),
              "amp": amp, "bn_bf16": amp, **VGG, "batch": batch,
              "batch_wanted": VGG_BATCH,
              "batch_note": None if batch == VGG_BATCH else
              "f32 at batch %d does not fit the card: the largest batch "
              "that did, halving" % VGG_BATCH,
              "step_ms_p50": p["step_ms_p50"],
              "images_per_s": p["images_per_s"],
              "paths": out, "agreement": agreement,
              "launches": p["launches"], "failures": failures,
              "ok": not failures}
    return result


def _out_of_memory(torch, e):
    while e is not None:
        if isinstance(e, torch.cuda.OutOfMemoryError):
            return True
        e = e.__cause__ or e.__context__
    return False


def _vgg_path(torch, fluid, exe, main, loss, init, persist, path, batch):
    from paddle_tpu_torch.fluid.io import set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    feed = vgg_batch(batch, SEED + 9)
    scope = fluid.Scope()
    set_scope_arrays(scope, init, "cuda")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prep = None
    try:
        if path == "prepared":
            prep = exe.prepare(main, feed_specs=feed, fetch_list=[loss],
                               scope=scope)

            def step():
                return prep.run_prepared(feed, return_numpy=True)
        else:
            def step():
                return exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)
        t0 = time.perf_counter()
        losses = [float(step()[0][0])]
        first_s = time.perf_counter() - t0
        reset_launches()
        step_ms = []
        for _ in range(VGG_STEPS):
            t0 = time.perf_counter()
            o = step()
            step_ms.append((time.perf_counter() - t0) * 1e3)  # fetch syncs
            losses.append(float(o[0][0]))
        launches = {k: fn.launches for k, fn in KERNELS.items()
                    if fn.launches}
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        device_ms, idle = idle_share(torch, step, VGG_PROFILED)
        if prep is not None:
            prep.sync_scope()
        dtypes = param_dtypes(main, scope)
    finally:
        del prep, scope
    failures = []
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        failures.append("losses %r" % losses)
    if launches:
        failures.append("a port kernel ran on the VGG path: %r" % launches)
    if dtypes != ["float32"]:
        failures.append("parameter dtypes %r" % dtypes)
    p50 = _pct(step_ms, 0.5)
    return {"path": path, "batch": batch, "first_step_s": first_s,
            "losses": losses, "step_ms": step_ms, "step_ms_p50": p50,
            "images_per_s": batch / p50 * 1e3,
            "train_tflops": batch / p50 * 1e3 * TRAIN_FLOPS_PER_IMG_VGG16
            / 1e12,
            "max_memory_allocated_bytes": peak,
            "memory_reserved_bytes": reserved,
            "device_ms_per_step": device_ms, "device_idle_share": idle,
            "launches": launches, "param_dtypes": dtypes,
            "failures": failures, "ok": not failures}



def vgg_oracle(torch, seed=SEED):
    """One step of VGG16-BN (f32, flowers 224 x 224) at batch
    VGG_ORACLE_BATCH, on a copy of the desc with every dropout_prob 0
    (so that the card and the CPU draw the same, empty, masks), held by
    ``ulp_oracle`` as the ResNet oracle is: one ulp added to every
    filter, never below ORACLE_GRAD_RTOL."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    main, startup, loss = build_vgg(fluid)
    main = main.clone()
    for op in main.desc.blocks[0].ops:
        if op.type in ("dropout", "dropout_grad"):
            op.set_attr("dropout_prob", 0.0)
    startup.random_seed = seed
    _, arrays = start_arrays(fluid, main, startup, fluid.CUDAPlace(0))
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    feed = vgg_batch(VGG_ORACLE_BATCH, seed + 7)

    def rel(a, b, scale):
        # a bias under batch norm has an exact gradient of 0: its noise
        # is held to the largest gradient's scale instead
        a, b = a.astype(np.float64), b.astype(np.float64)
        den = max(float(np.linalg.norm(b)), 1e-3 * scale * math.sqrt(b.size))
        return float(np.linalg.norm(a - b)) / den

    _, _, _, held = ulp_oracle(fluid, main, arrays, feed, fetch,
                               len(params), lambda k, v: v.ndim == 4, rel,
                               ORACLE_GRAD_RTOL)
    return {"phase": "train_vgg_oracle", "batch": VGG_ORACLE_BATCH,
            "seed": seed, "dropout_prob": 0.0, **held}


SPARSE_STEPS = 3
SPARSE_BATCH = (16, 128)        # ids a step: 2048, duplicates forced
SPARSE_TOL = 1e-6


def sparse_update(torch):
    """Phase sparse_update: an ``is_sparse`` embedding at the flagship
    LM's vocabulary and width (8192 x 1024) -> fc 1 -> mean, its
    gradient a SelectedRows, under sgd, momentum (densified) and lazy
    adam, duplicate ids in every batch: SPARSE_STEPS captured steps on
    the card against as many run() steps of the port on the CPU from
    the same start, losses and every persistable within SPARSE_TOL
    (atol and rtol); the rows no id touched unchanged under sgd and
    adam."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    vocab, dim = TRAIN_LM["vocab_size"], TRAIN_LM["d_model"]
    rng = np.random.RandomState(SEED + 13)
    feeds = []
    for _ in range(SPARSE_STEPS):
        ids = rng.randint(0, vocab, SPARSE_BATCH + (1,)).astype(np.int64)
        ids[:, :16] = ids[0, 0]
        feeds.append({"ids": ids})
    touched = np.unique(np.concatenate([f["ids"].ravel() for f in feeds]))
    out, failures = {}, []
    for optimizer in ("sgd", "momentum", "adam"):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids = fluid.layers.data(name="ids", shape=[SPARSE_BATCH[1], 1],
                                    dtype="int64")
            e = fluid.layers.embedding(ids, size=[vocab, dim],
                                       is_sparse=True,
                                       param_attr=fluid.ParamAttr(
                                           name="table"))
            loss = fluid.layers.mean(fluid.layers.fc(e, size=1,
                                                     num_flatten_dims=2))
            {"sgd": lambda: fluid.optimizer.SGD(learning_rate=0.5),
             "momentum": lambda: fluid.optimizer.Momentum(0.5, 0.9),
             # Adam's step is about lr whatever the gradient, so the
             # two devices' rounding of a small gradient reaches the
             # parameters at lr times its relative size: the default
             # rate, as VGG and the LM train at
             "adam": lambda: fluid.optimizer.Adam(learning_rate=1e-3)
             }[optimizer]().minimize(loss)
        persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                         if v.persistable)
        cpu = fluid.Scope()
        fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
        init = get_scope_arrays(cpu, persist)
        want = [float(fluid.Executor(fluid.CPUPlace()).run(
            main, feed=f, fetch_list=[loss], scope=cpu)[0].ravel()[0])
            for f in feeds]
        card = fluid.Scope()
        set_scope_arrays(card, init, "cuda")
        t0 = time.perf_counter()
        with fluid.Executor(fluid.CUDAPlace(0)).prepare(
                main, feed_specs=feeds[0], fetch_list=[loss],
                scope=card) as prep:
            got = [float(prep.run_prepared(f, return_numpy=True)[0]
                         .ravel()[0]) for f in feeds]
        secs = time.perf_counter() - t0
        a, b = get_scope_arrays(card, persist), get_scope_arrays(cpu, persist)
        err = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max())
               for k in persist}
        ok = (np.allclose(got, want, rtol=SPARSE_TOL, atol=SPARSE_TOL)
              and all(np.allclose(a[k], b[k], rtol=SPARSE_TOL,
                                  atol=SPARSE_TOL) for k in persist))
        untouched = np.setdiff1d(np.arange(vocab), touched)
        lazy = optimizer == "momentum" or bool(np.array_equal(
            a["table"][untouched], init["table"][untouched]))
        if not (ok and lazy):
            failures.append(optimizer)
        out[optimizer] = {"losses_card": got, "losses_cpu": want,
                          "max_abs_err": err, "untouched_rows_unchanged":
                          lazy, "seconds": secs, "ok": ok and lazy}
    return {"phase": "sparse_update", "table": [vocab, dim],
            "ids_per_step": SPARSE_BATCH[0] * SPARSE_BATCH[1],
            "rows_touched": int(touched.size), "steps": SPARSE_STEPS,
            "captured": True, "tolerance": SPARSE_TOL, "runs": out,
            "failures": failures, "ok": not failures}


SLICE21_TIMEOUT_S = 600


def slice21_phases(torch):
    """Slice 21's phases in order, as (name, zero-argument callable)."""
    return [("train_fused_dropout",
             lambda: train_fused_dropout(torch, False)),
            ("train_fused_dropout_amp",
             lambda: train_fused_dropout(torch, True)),
            ("train_vgg", lambda: train_vgg(torch, False)),
            ("train_vgg_amp", lambda: train_vgg(torch, True)),
            ("train_vgg_oracle", lambda: vgg_oracle(torch)),
            ("sparse_update", lambda: sparse_update(torch))]


# ---------------------------------------------------------------------------
# slice 22: checkpoints and the host-op runtime (a save in the middle of a
# prepared loop and a resume, the Trainer's kill and resume, the
# Inferencer and an inference model, host ops on the card)
# ---------------------------------------------------------------------------

CKPT_STEPS = 6          # the uninterrupted run; the save after CKPT_SAVE_AT
CKPT_SAVE_AT = 3
TRAINER_EPOCHS = 2
TRAINER_STEPS = 4       # batches an epoch
TRAINER_KILL_AT = (1, 1)      # a crash after this step (epoch, step)
TRAINER_LR = 1e-3
INFER_SEQS = 2          # sequences the Inferencer and the model run
PREPARED_TIMED = 3      # bare prepared steps timed beside the Trainer's
HOST_OPS_ROWS = 256
SLICE22_TIMEOUT_S = 600


def smoke_dir(name):
    """A fresh directory ``name`` under the checkout's ignored
    ``_smoke_io/`` (the checkpoints and models the phases write)."""
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "_smoke_io")
    path = os.path.join(root, name)
    shutil.rmtree(path, ignore_errors=True)
    os.makedirs(path)
    return path


def dir_bytes(path):
    return sum(os.path.getsize(os.path.join(d, f))
               for d, _, files in os.walk(path) for f in files)


def lm_batches(n, seed):
    return [lm_batch(TRAIN_BATCH, seed + i) for i in range(n)]


def _bits_equal(torch, a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.cpu(), b.cpu())


def _free(torch):
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def checkpoint_prepared_amp(torch):
    """Phase checkpoint_prepared_amp: the fused-block LM under bf16 AMP
    at TRAIN_LM, batch 16 x 2048, through Executor.prepare (one CUDA
    graph replay a step), from one set of startup values: (A)
    CKPT_STEPS steps uninterrupted; (B) CKPT_SAVE_AT steps,
    fluid.io.save_checkpoint (no sync_scope by hand: the save flushes
    the prepared state), the rest of the steps as replays, then a
    load_checkpoint into B's scope while its prepared program lives and
    one more replay; (C) a fresh Executor(CUDAPlace(0)) and Scope:
    startup, load_checkpoint, prepare, the steps after the save.  Gates:
    B's and C's losses after the save A's, bit for bit; every saved
    tensor A's state after CKPT_SAVE_AT steps, bit for bit in its dtype;
    the replay after the load A's loss of the step after the save; K1-K5's
    bf16 forms launched per replay as train_launches_per_step(True,
    True).  Records the checkpoint's bytes, the save's and the load's
    seconds and GB/s (warm: the files are in the page cache), and the
    state's device-to-host and host-to-device copies alone."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.utils import serialization

    t_phase = time.perf_counter()
    main, startup, loss = build_lm(fluid, amp=True, fuse_transformer=True)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    feeds = lm_batches(CKPT_STEPS, SEED + 20)
    ckpt = smoke_dir("checkpoint_prepared_amp")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    start = fluid.Scope()
    exe.run(startup, scope=start)
    init = {n: start.find_var(n).clone() for n in persist}
    del start

    def scope_from(state):
        s = fluid.Scope()
        for n, v in state.items():
            s.set(n, v.clone())
        return s

    def losses(ts):
        return [float(t.float().cpu().reshape(-1)[0]) for t in ts]

    # (A) uninterrupted; the state after CKPT_SAVE_AT steps kept aside
    scope = scope_from(init)
    prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                       scope=scope)
    a_out = []
    for i, f in enumerate(feeds):
        a_out.append(prep.run_prepared(f)[0])
        if i + 1 == CKPT_SAVE_AT:
            prep.sync_scope()
            after = {n: scope.find_var(n).clone() for n in persist}
    del prep, scope
    _free(torch)

    # (B) the save in the middle of the loop, then a load into the
    # live prepared program's scope
    scope = scope_from(init)
    prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                       scope=scope)
    b_out = [prep.run_prepared(feeds[0])[0]]
    reset_launches()
    replays = 0
    for i, f in enumerate(feeds[1:], 1):
        if i == CKPT_SAVE_AT:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with fluid.scope_guard(scope):
                serial = fluid.io.save_checkpoint(
                    exe, ckpt, trainer_args={"step_id": CKPT_SAVE_AT},
                    main_program=main)
            save_s = time.perf_counter() - t0
        b_out.append(prep.run_prepared(f)[0])
        replays += 1
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    nbytes = dir_bytes(ckpt)
    model_dir = os.path.join(ckpt, "checkpoint_%d" % serial, "__model__")
    saved_ok, mismatched = True, []
    for n in persist:
        got = serialization.load_tensor(os.path.join(model_dir, n),
                                        as_torch=True)
        want = after[n].cpu()
        if want.dim() == 0:
            want = want.reshape(1)
        if not _bits_equal(torch, got, want):
            saved_ok = False
            mismatched.append(n)
    # the save's and the load's device copies alone (pageable, as the
    # ops make them): the rest is the host's serialization and the files
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host = [after[n].cpu() for n in persist]
    d2h_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    back = [h.to(exe.device) for h in host]
    torch.cuda.synchronize()
    h2d_s = time.perf_counter() - t0
    del host, back
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.load_checkpoint(exe, ckpt, serial, main_program=main)
    torch.cuda.synchronize()
    load_live_s = time.perf_counter() - t0
    on_card = all(scope.find_var(n).device.type == "cuda" for n in persist)
    again = prep.run_prepared(feeds[CKPT_SAVE_AT])[0]
    del prep, scope, after
    _free(torch)

    # (C) a fresh executor and scope resume from the checkpoint
    exe_c = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe_c.run(startup, scope=scope)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with fluid.scope_guard(scope):
        fluid.io.load_checkpoint(exe_c, ckpt, main_program=main)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    prep = exe_c.prepare(main, feed_specs=feeds[CKPT_SAVE_AT],
                         fetch_list=[loss], scope=scope)
    c_out = [prep.run_prepared(f)[0] for f in feeds[CKPT_SAVE_AT:]]
    del prep, scope
    _free(torch)

    la, lb, lc = losses(a_out), losses(b_out), losses(c_out)
    tail = slice(CKPT_SAVE_AT, None)
    b_same = all(_bits_equal(torch, x, y)
                 for x, y in zip(b_out[tail], a_out[tail]))
    c_same = all(_bits_equal(torch, x, y)
                 for x, y in zip(c_out, a_out[tail]))
    live_same = _bits_equal(torch, again, a_out[CKPT_SAVE_AT])
    per_replay = {k: launches[k] / replays for k in KERNELS}
    want = train_launches_per_step(True, True)
    launches_ok = all(per_replay[k] == want.get(k, 0) for k in KERNELS)
    failures = [name for name, ok in (
        ("B's losses after the save", b_same),
        ("C's losses", c_same), ("the saved tensors", saved_ok),
        ("the replay after a load into the live scope", live_same),
        ("the loaded tensors on the card", on_card),
        ("launches per replay", launches_ok)) if not ok]
    return {"phase": "checkpoint_prepared_amp", "amp": True, "fused": True,
            "batch": TRAIN_BATCH, **TRAIN_LM, "captured": True,
            "steps": CKPT_STEPS, "save_after_step": CKPT_SAVE_AT,
            "losses_a": la, "losses_b": lb, "losses_c": lc,
            "loss_after_live_load": losses([again])[0],
            "checkpoint_bytes": nbytes, "tensors": len(persist),
            "save_s": save_s, "save_gb_per_s": nbytes / save_s / 1e9,
            "load_s": load_s, "load_gb_per_s": nbytes / load_s / 1e9,
            "load_into_live_scope_s": load_live_s,
            "d2h_s": d2h_s, "h2d_s": h2d_s,
            "saved_tensors_mismatched": mismatched,
            "launches": launches, "replays_counted": replays,
            "launches_per_replay": per_replay,
            "launches_per_replay_wanted": want,
            "seconds": time.perf_counter() - t_phase,
            "failures": failures, "ok": not failures}


def lm_train_func(fluid, logits_out):
    """The layers transformer.get_model builds, fused, without its
    minimize (the Trainer minimizes); the logits Variable goes into
    ``logits_out``."""
    from paddle_tpu_torch.fluid.transpiler import TransformerFuseTranspiler
    from paddle_tpu_torch.models.transformer import transformer_lm

    lm = TRAIN_LM

    def train_func():
        src = fluid.layers.data(name="src", shape=[lm["seq_len"]],
                                dtype="int64")
        label = fluid.layers.data(name="label", shape=[lm["seq_len"], 1],
                                  dtype="int64")
        logits = transformer_lm(src, lm["vocab_size"], lm["seq_len"],
                                lm["d_model"], lm["n_head"], lm["n_layers"],
                                lm["d_ff"])
        avg = fluid.layers.mean(
            fluid.layers.softmax_with_cross_entropy(logits, label))
        TransformerFuseTranspiler().transpile(fluid.default_main_program())
        logits_out[:] = [logits]
        return [avg]

    return train_func


def lm_infer_func(fluid):
    from paddle_tpu_torch.fluid.transpiler import TransformerFuseTranspiler
    from paddle_tpu_torch.models.transformer import transformer_lm

    lm = TRAIN_LM

    def infer_func():
        src = fluid.layers.data(name="src", shape=[lm["seq_len"]],
                                dtype="int64")
        logits = transformer_lm(src, lm["vocab_size"], lm["seq_len"],
                                lm["d_model"], lm["n_head"], lm["n_layers"],
                                lm["d_ff"])
        TransformerFuseTranspiler().transpile(fluid.default_main_program())
        return logits

    return infer_func


def lm_reader(seed):
    """Samples (src [2048], label [2048, 1]) from a seeded RandomState,
    TRAIN_STEPS batches of TRAIN_BATCH an epoch."""
    import numpy as np

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(TRAINER_STEPS * TRAIN_BATCH):
            toks = rng.randint(0, TRAIN_LM["vocab_size"],
                               TRAIN_LM["seq_len"] + 1).astype(np.int64)
            yield toks[:-1], toks[1:, None]

    return reader


class Killed(Exception):
    """Raised by the kill run's event handler: a crash in the middle of
    an epoch (the checkpoints stay)."""


def trainer_run(fluid, pt, ckpt, kill_at=None, logits=None):
    """One fluid.Trainer (no place: the card) over the flagship LM's
    fused f32 program: TRAINER_EPOCHS epochs of lm_reader, Adam at
    TRAINER_LR, CheckpointConfig(step_interval=2, epoch_interval=1) in
    ``ckpt``; killed after step ``kill_at``.  Returns (trainer, [(epoch,
    step, loss, ms)])."""
    seen, t0 = [], [0.0]

    def handler(ev):
        if isinstance(ev, fluid.BeginStepEvent):
            t0[0] = time.perf_counter()
        elif isinstance(ev, fluid.EndStepEvent):
            seen.append((ev.epoch, ev.step,
                         float(ev.metrics[0].reshape(-1)[0]),
                         (time.perf_counter() - t0[0]) * 1e3))
            if (ev.epoch, ev.step) == kill_at:
                raise Killed()

    cfg = fluid.CheckpointConfig(checkpoint_dir=ckpt, step_interval=2,
                                 epoch_interval=1)
    t = fluid.Trainer(
        train_func=lm_train_func(fluid, logits if logits is not None
                                 else []),
        optimizer_func=lambda: fluid.optimizer.Adam(
            learning_rate=TRAINER_LR),
        checkpoint_config=cfg)
    try:
        t.train(num_epochs=TRAINER_EPOCHS, event_handler=handler,
                reader=pt.batch(lm_reader(SEED + 30), TRAIN_BATCH),
                feed_order=["src", "label"])
    except Killed:
        pass
    return t, seen


def trainer_resume(torch):
    """Phase trainer_resume: fluid.Trainer with no place (so
    CUDAPlace(0)) trains the flagship LM's fused-block program at full
    width in f32 (TRAINER_EPOCHS x TRAINER_STEPS steps of 16 x 2048
    tokens, checkpoints every 2 steps and every epoch), uninterrupted,
    then killed after TRAINER_KILL_AT and resumed in a new Trainer: the
    killed run's and the resumed run's losses the uninterrupted run's,
    bit for bit.  Then, from
    the uninterrupted Trainer: save_params -> Inferencer (no place),
    whose logits for INFER_SEQS sequences equal the Trainer's test
    program's bit for bit; save_inference_model -> load_inference_model
    in a fresh scope (the feed and fetch host ops on the card), the same
    logits.  Records each step's ms (a step that saved a checkpoint
    includes the save) beside PREPARED_TIMED bare run_prepared steps of
    the same program from the same scope, and the save_params seconds."""
    import numpy as np

    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    t_phase = time.perf_counter()
    logits = []
    reset_launches()
    base, seen = trainer_run(fluid, pt, smoke_dir("trainer_base"),
                             logits=logits)
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    failures = []
    if base.place != fluid.CUDAPlace(0) or \
            base.scope.find_var("pos_emb").device.type != "cuda":
        failures.append("the Trainer's place")
    want_launches = {k: n * (len(seen) + 2)   # + the capture's warm-ups
                     for k, n in train_launches_per_step(True).items()}
    if any(launches[k] != want_launches.get(k, 0) for k in KERNELS):
        failures.append("launches")
    # the Inferencer and the inference model against the test program
    rng = np.random.RandomState(SEED + 31)
    toks = rng.randint(0, TRAIN_LM["vocab_size"],
                       (INFER_SEQS, TRAIN_LM["seq_len"] + 1)).astype(
                           np.int64)
    src = toks[:, :-1]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    want, = exe.run(base.test_program,
                    feed={"src": src, "label": toks[:, 1:, None]},
                    fetch_list=[logits[0]], scope=base.scope)
    params = smoke_dir("trainer_params")
    t0 = time.perf_counter()
    base.save_params(params)
    save_params_s = time.perf_counter() - t0
    inf = fluid.Inferencer(infer_func=lm_infer_func(fluid),
                           param_path=params)
    got_inf, = inf.infer({"src": src})
    inf_place = inf.place
    del inf
    model = smoke_dir("trainer_model")
    with fluid.scope_guard(base.scope):
        fluid.io.save_inference_model(model, ["src"], [logits[0]], exe,
                                      main_program=base.train_program)
    with fluid.scope_guard(fluid.Scope()):
        prog, feed_names, fetch_vars = fluid.io.load_inference_model(model,
                                                                     exe)
        got_model, = exe.run(prog, feed={"src": src}, fetch_list=fetch_vars)
    host_ops = sorted({op.type for op in prog.desc.blocks[0].ops
                       if op.type in ("feed", "fetch")})
    del prog, fetch_vars
    if inf_place != fluid.CUDAPlace(0) or \
            not np.array_equal(got_inf, want):
        failures.append("the Inferencer's logits")
    if feed_names != ["src"] or host_ops != ["feed", "fetch"] or \
            not np.array_equal(got_model, want):
        failures.append("the inference model's logits")
    # bare prepared steps of the same program, beside the Trainer's
    feed = fluid.DataFeeder(["src", "label"],
                            program=base.train_program).feed(
        list(lm_reader(SEED + 32)())[:TRAIN_BATCH])
    prep = exe.prepare(base.train_program, feed_specs=feed,
                       fetch_list=[base.train_func_outputs[0]],
                       scope=base.scope)
    prep.run_prepared(feed, return_numpy=True)
    prepared_ms = []
    for _ in range(PREPARED_TIMED):
        t0 = time.perf_counter()
        prep.run_prepared(feed, return_numpy=True)
        prepared_ms.append((time.perf_counter() - t0) * 1e3)
    del prep, base
    _free(torch)

    ckpt = smoke_dir("trainer_resume")
    killed, first = trainer_run(fluid, pt, ckpt, kill_at=TRAINER_KILL_AT)
    del killed
    _free(torch)
    resumed_t, second = trainer_run(fluid, pt, ckpt)
    del resumed_t
    _free(torch)
    baseline = {(e, s): v for e, s, v, _ in seen}
    resumed = {(e, s): v for e, s, v, _ in second}
    # the last checkpoint before the kill holds the last even step: the
    # resume starts after it
    kill_e, kill_s = TRAINER_KILL_AT
    want_keys = [(e, s) for e, s, *_ in seen
                 if (e, s) >= (kill_e, kill_s - kill_s % 2 + 1)]
    if first[-1][:2] != TRAINER_KILL_AT or any(
            v != baseline[(e, s)] for e, s, v, _ in first):
        failures.append("the killed run's losses")
    if sorted(resumed) != want_keys or any(
            resumed[k] != baseline[k] for k in want_keys):
        failures.append("the resumed losses")
    saving = {(e, s) for e, s, *_ in seen if s % 2 == 0}
    plain_ms = [ms for e, s, _, ms in seen[1:] if (e, s) not in saving]
    # the second epoch's loss on each batch below the first epoch's
    losses = [v for *_, v, _ in seen]
    if not (all(math.isfinite(x) for x in losses) and all(
            baseline[(1, s)] < baseline[(0, s)]
            for s in range(TRAINER_STEPS))):
        failures.append("the losses")
    return {"phase": "trainer_resume", "amp": False, "fused": True,
            "batch": TRAIN_BATCH, **TRAIN_LM, "learning_rate": TRAINER_LR,
            "place": repr(fluid.CUDAPlace(0)),
            "epochs": TRAINER_EPOCHS, "steps_per_epoch": TRAINER_STEPS,
            "kill_at": list(TRAINER_KILL_AT),
            "losses": [[e, s, v] for e, s, v, _ in seen],
            "losses_killed": [[e, s, v] for e, s, v, _ in first],
            "losses_resumed": [[e, s, v] for e, s, v, _ in second],
            "step_ms": [[e, s, ms] for e, s, _, ms in seen],
            "step_ms_p50_no_save": _pct(plain_ms, 0.5),
            "prepared_step_ms": prepared_ms,
            "prepared_step_ms_p50": _pct(prepared_ms, 0.5),
            "save_params_s": save_params_s,
            "checkpoint_bytes": dir_bytes(params),
            "inference_logits_shape": list(want.shape),
            "launches": launches, "launches_wanted": want_launches,
            "seconds": time.perf_counter() - t_phase,
            "failures": failures, "ok": not failures}


def host_ops_phase(torch):
    """Phase host_ops: x [HOST_OPS_ROWS, 1024] -> fc 4096 relu -> fc 1024
    -> mean on the card, with Print after the last device op (the
    postlude, reading a temporary), with Print between the two fcs (the
    block runs op by op), and with both: each Print runs once a run, and
    the fetches are those of the program without Print, bit for bit;
    prepare() refuses the blocks with ValueError."""
    import contextlib
    import io as _io

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    d, dff = TRAIN_LM["d_model"], TRAIN_LM["d_ff"]

    def build(between, tail):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[d], dtype="float32")
            h = fluid.layers.fc(x, size=dff, act="relu")
            if between:
                fluid.layers.Print(h, message="host_ops h", summarize=0)
            y = fluid.layers.fc(h, size=d)
            out = fluid.layers.mean(y)
            if tail:
                fluid.layers.Print(y, message="host_ops y")
        return main, startup, [h, y, out]

    exe = fluid.Executor(fluid.CUDAPlace(0))
    x = np.random.RandomState(SEED + 40).randn(HOST_OPS_ROWS, d).astype(
        np.float32)
    main, startup, fetch = build(False, False)
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    init = get_scope_arrays(scope, persist)
    want = exe.run(main, feed={"x": x}, fetch_list=fetch, scope=scope)
    runs, failures = {}, []
    for name, between, tail in (("postlude", False, True),
                                ("between", True, False),
                                ("both", True, True)):
        main, startup, fetch = build(between, tail)
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        buf = _io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            got = exe.run(main, feed={"x": x}, fetch_list=fetch,
                          scope=scope)
        secs = time.perf_counter() - t0
        printed = [ln.split("\t")[0] for ln in buf.getvalue().splitlines()
                   if ln.startswith("host_ops ")]
        try:
            exe.prepare(main, feed_specs={"x": x}, fetch_list=fetch,
                        scope=scope)
            refused = False
        except ValueError:
            refused = True
        same = all(np.array_equal(g, w) for g, w in zip(got, want))
        expect = ["host_ops h"] * between + ["host_ops y"] * tail
        ok = same and refused and printed == expect
        if not ok:
            failures.append(name)
        runs[name] = {"fetches_bit_identical": same, "printed": printed,
                      "prepare_refused": refused, "seconds": secs,
                      "ok": ok}
    return {"phase": "host_ops", "rows": HOST_OPS_ROWS, "runs": runs,
            "failures": failures, "ok": not failures}


def slice22_phases(torch):
    """Slice 22's phases in order, as (name, zero-argument callable)."""
    return [("checkpoint_prepared_amp",
             lambda: checkpoint_prepared_amp(torch)),
            ("trainer_resume", lambda: trainer_resume(torch)),
            ("host_ops", lambda: host_ops_phase(torch))]


# ---------------------------------------------------------------------------
# slice 23: ragged (LoD) feeds and the sequence ops (the stacked dynamic
# LSTM, ragged buckets, the sentiment conv net)
# ---------------------------------------------------------------------------

LSTM = dict(dict_dim=5000, hidden_dim=512, stacked_num=3,
            learning_rate=2e-3)     # bench.py:360-415
LSTM_BATCH = 64
LSTM_SEQ = 80
LSTM_STEPS = 3
# steps traced for the device's idle share: a traced run() step records
# every one of its thousands of host-side torch ops, so that path
# traces one
LSTM_PROFILED = {"run": 1, "prepared": 1}
RAGGED_MAX = (80, 56, 33)           # padded T 80, 56 and 40
RAGGED_ORDER = (0, 1, 2, 0, 1, 2, 0)
# the buckets' graphs share one memory pool and one warm-up stream:
# after the first (and largest) bucket's capture, the pool and the
# card's reserved bytes may grow by at most this share; a private pool
# a bucket would add about (56 + 40) / 80 = 1.2 times the pool, and a
# new warm-up stream a bucket 10 % of the reserved bytes each (on an
# H100: 713, 784, 857 MB)
RAGGED_GROWTH_MAX = 0.1
LSTM_ORACLE_LENS = (5, 11, 17, 23)
# train_lstm_oracle's floor under each gradient's bar.  The last fc's
# bias gradient is a sum over the batch of p - y, terms near +-0.5
# whose sum nearly cancels: its error is an ulp of the terms, not of
# itself, and one ulp on the parameters leaves it unmoved.  On an H100
# the card reads 9.73e-6 there (the other gradients 1.2e-6 at most,
# within twice the spread), and the CPU step from TF32-rounded weights
# 4.97e-4: the floor sits between.  The median stays at twice the
# median spread, with no floor
LSTM_ORACLE_GRAD_FLOOR = 1e-4
# the sentiment book model on IMDB's word dictionary (5147 words)
SENTIMENT = dict(dict_dim=5147, emb_dim=32, hid_dim=32,
                 learning_rate=0.002)
SENTIMENT_BATCH = 128
SENTIMENT_MAX = (80, 60, 40)
SENTIMENT_TOL = 1e-6
SLICE23_TIMEOUT_S = 600


def build_lstm(fluid, amp=False):
    from paddle_tpu_torch.models import stacked_dynamic_lstm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, (words, label), _ = stacked_dynamic_lstm.get_model(**LSTM)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss, [words, label]


def ragged_batch(fluid, main, slots, lens, seed, vocab):
    """A DataFeeder batch of seeded sequences of ``lens`` tokens, each
    with a 0/1 label: the words slot a LoDTensor."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return fluid.DataFeeder(slots, program=main).feed(
        [(rng.randint(0, vocab, int(n)).tolist(), [int(rng.randint(2))])
         for n in lens])


def ragged_lens(mx, n, seed):
    """``n`` lengths in 8 .. ``mx``, the first ``mx``."""
    import numpy as np

    lens = np.random.RandomState(seed).randint(8, mx + 1, n)
    lens[0] = mx
    return lens


def train_lstm(torch, amp):
    """Phases train_lstm (f32) and train_lstm_amp (bf16 AMP, the bench
    entry's card default): the stacked dynamic LSTM at bench.py's card
    width on one batch of LSTM_BATCH sequences of LSTM_SEQ tokens, through
    run() and the prepared step (its first step captures: ``capture_s``),
    each 1 first step and LSTM_STEPS timed ones: step ms p50,
    examples/s, peak memory, the device's idle share over LSTM_PROFILED
    traced steps (under the profiler); no kernel of the port runs (no
    TPU kernel on the path); then AGREE_STEPS prepared steps bit for bit
    against as many run() steps from the same start
    (``prepared_agreement``)."""
    import paddle_tpu_torch.fluid as fluid

    main, startup, loss, slots = build_lstm(fluid, amp)
    persist, init = start_arrays(fluid, main, startup, fluid.CUDAPlace(0))
    feed = ragged_batch(fluid, main, slots, [LSTM_SEQ] * LSTM_BATCH,
                        SEED + 23, LSTM["dict_dim"])
    exe = fluid.Executor(fluid.CUDAPlace(0))
    out = {path: _lstm_path(torch, fluid, exe, main, loss, init, path, feed)
           for path in ("run", "prepared")}
    failures = ["%s: %s" % (p, r["failures"]) for p, r in out.items()
                if not r["ok"]]
    torch.cuda.empty_cache()
    agreement = prepared_agreement(torch, fluid, main, loss, feed, persist,
                                   init)
    if not agreement["bit_identical_to_run"]:
        failures.append("prepared against run(): %r"
                        % agreement["worst_vs_tolerance"])
    r, p = out["run"], out["prepared"]
    return {"phase": "train_lstm" + ("_amp" if amp else ""), "amp": amp,
            **LSTM, "batch": LSTM_BATCH, "seq": LSTM_SEQ,
            "step_ms_p50_run": r["step_ms_p50"],
            "step_ms_p50_prepared": p["step_ms_p50"],
            "run_over_prepared": r["step_ms_p50"] / p["step_ms_p50"],
            "examples_per_s": p["examples_per_s"],
            "capture_s": p["first_step_s"], "paths": out,
            "agreement": agreement, "launches": p["launches"],
            "failures": failures, "ok": not failures}


def _lstm_path(torch, fluid, exe, main, loss, init, path, feed):
    from paddle_tpu_torch.fluid.io import set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    scope = fluid.Scope()
    set_scope_arrays(scope, init, "cuda")
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    prep = None
    try:
        t0 = time.perf_counter()
        if path == "prepared":
            prep = exe.prepare(main, feed_specs=feed, fetch_list=[loss],
                               scope=scope)

            def step():
                return prep.run_prepared(feed, return_numpy=True)
        else:
            def step():
                return exe.run(main, feed=feed, fetch_list=[loss],
                               scope=scope)
        losses = [float(step()[0][0])]
        first_s = time.perf_counter() - t0
        reset_launches()
        step_ms = []
        for _ in range(LSTM_STEPS):
            t0 = time.perf_counter()
            o = step()
            step_ms.append((time.perf_counter() - t0) * 1e3)  # fetch syncs
            losses.append(float(o[0][0]))
        launches = {k: fn.launches for k, fn in KERNELS.items()
                    if fn.launches}
        peak = torch.cuda.max_memory_allocated()
        reserved = torch.cuda.memory_reserved()
        device_ms, idle = idle_share(torch, step, LSTM_PROFILED[path])
        buckets = None
        if prep is not None:
            buckets = prep._prep._step.buckets
            prep.sync_scope()
        dtypes = param_dtypes(main, scope)
    finally:
        del prep, scope
    failures = []
    if not (all(math.isfinite(x) for x in losses)
            and losses[-1] < losses[0]):
        failures.append("losses %r" % losses)
    if launches:
        failures.append("a port kernel ran on the LSTM path: %r" % launches)
    if dtypes != ["float32"]:
        failures.append("parameter dtypes %r" % dtypes)
    p50 = _pct(step_ms, 0.5)
    return {"path": path, "first_step_s": first_s, "losses": losses,
            "step_ms": step_ms, "step_ms_p50": p50,
            "examples_per_s": LSTM_BATCH / p50 * 1e3,
            "max_memory_allocated_bytes": peak,
            "memory_reserved_bytes": reserved,
            "device_ms_per_step": device_ms, "device_idle_share": idle,
            "buckets": buckets, "launches": launches,
            "param_dtypes": dtypes, "failures": failures,
            "ok": not failures}


def train_lstm_ragged(torch):
    """Phase train_lstm_ragged: the f32 stacked LSTM on three seeded
    batches of LSTM_BATCH sequences of 8 .. RAGGED_MAX[i] tokens (padded
    T 80, 56 and 40), stepped in RAGGED_ORDER through the prepared step:
    each bucket's first batch captures a graph of its own, every later
    one replays it (``buckets``: captures and replays a bucket), all in
    one memory pool, which, with the card's reserved bytes, grows by at
    most RAGGED_GROWTH_MAX after the first capture
    (``memory_by_bucket``: both after each new bucket); the losses
    finite and falling on the repeated batch 0; the same steps through
    run() from the same start, losses and every persistable bit for
    bit."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss, slots = build_lstm(fluid)
    persist, init = start_arrays(fluid, main, startup, fluid.CUDAPlace(0))
    batches = [ragged_batch(fluid, main, slots,
                            ragged_lens(mx, LSTM_BATCH, SEED + 30 + i),
                            SEED + 40 + i, LSTM["dict_dim"])
               for i, mx in enumerate(RAGGED_MAX)]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    runs = {}
    for path in ("prepared", "run"):
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        torch.cuda.empty_cache()
        reset_launches()
        losses, step_ms, buckets, memory, pools = [], [], None, [], None
        if path == "prepared":
            with exe.prepare(main, feed_specs=batches[0], fetch_list=[loss],
                             scope=scope) as prep:
                caps = prep._prep._step._captures
                for i in RAGGED_ORDER:
                    n = len(caps)
                    t0 = time.perf_counter()
                    o = prep.run_prepared(batches[i], return_numpy=True)
                    step_ms.append((time.perf_counter() - t0) * 1e3)
                    losses.append(float(o[0][0]))
                    if len(caps) > n:
                        memory.append(pool_memory(torch, caps))
                buckets = prep._prep._step.buckets
                pools = len({c.graph.pool() for c in caps.values()})
        else:
            for i in RAGGED_ORDER:
                t0 = time.perf_counter()
                o = exe.run(main, feed=batches[i], fetch_list=[loss],
                            scope=scope)
                step_ms.append((time.perf_counter() - t0) * 1e3)
                losses.append(float(o[0][0]))
        launches = {k: fn.launches for k, fn in KERNELS.items()
                    if fn.launches}
        runs[path] = {"losses": losses, "step_ms": step_ms,
                      "buckets": buckets, "memory_by_bucket": memory,
                      "pools": pools, "launches": launches,
                      "state": get_scope_arrays(scope, persist)}
        del scope
    p, r = runs["prepared"], runs["run"]
    identical = p["losses"] == r["losses"] and all(
        np.array_equal(p["state"][n], r["state"][n]) for n in persist)
    want = {}
    for i in RAGGED_ORDER:
        t = -(-max(RAGGED_MAX[i], 1) // 8) * 8
        want[t] = want.get(t, 0) + 1
    got = {int(re.search(r"words\[\d+, (\d+)", k).group(1)): v
           for k, v in p["buckets"].items()}
    failures = []
    if sorted(got) != sorted(want) or any(
            got[t] != {"captures": 1, "replays": want[t]} for t in want):
        failures.append("buckets %r, want replays %r" % (p["buckets"], want))
    first = [p["losses"][j] for j, i in enumerate(RAGGED_ORDER) if i == 0]
    if not (all(math.isfinite(x) for x in p["losses"])
            and all(a > b for a, b in zip(first, first[1:]))):
        failures.append("losses %r" % p["losses"])
    if not identical:
        failures.append("prepared against run(): not bit for bit")
    mem = p["memory_by_bucket"]
    if p["pools"] != 1:
        failures.append("the buckets' graphs in %r pools" % p["pools"])
    for key in ("pool_bytes", "reserved_bytes"):
        if mem[-1][key] > (1 + RAGGED_GROWTH_MAX) * mem[0][key]:
            failures.append("%s grew past %g: %r"
                            % (key, RAGGED_GROWTH_MAX, mem))
    if p["launches"] or r["launches"]:
        failures.append("a port kernel ran: %r" % [p["launches"],
                                                   r["launches"]])
    return {"phase": "train_lstm_ragged", **LSTM, "batch": LSTM_BATCH,
            "max_lens": list(RAGGED_MAX), "order": list(RAGGED_ORDER),
            "buckets": p["buckets"], "buckets_wanted_replays": want,
            "memory_by_bucket": mem, "pools": p["pools"],
            "losses_prepared": p["losses"], "losses_run": r["losses"],
            "step_ms_prepared": p["step_ms"], "step_ms_run": r["step_ms"],
            "bit_identical_to_run": identical, "launches": p["launches"],
            "failures": failures, "ok": not failures}


def tf32(v):
    """``v`` (float32) rounded to TF32's 10-bit mantissa, to nearest, as
    a TF32 product rounds its operands."""
    import numpy as np

    bits = v.view(np.uint32)
    return ((bits + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(
        np.float32)


def pool_memory(torch, caps):
    """The bytes reserved on the card in all, and in the memory pool the
    captured graphs ``caps`` ({signature: _Capture}) share."""
    pool = tuple(next(iter(caps.values())).graph.pool())
    size = sum(sg["total_size"]
               for sg in torch.cuda.memory._snapshot()["segments"]
               if tuple(sg["segment_pool_id"]) == pool)
    return {"captures": len(caps), "pool_bytes": size,
            "reserved_bytes": torch.cuda.memory_reserved()}


def lstm_oracle(torch):
    """Phase train_lstm_oracle: one f32 step of the stacked LSTM at
    bench.py's width on 4 sequences of LSTM_ORACLE_LENS tokens, held by
    ``ulp_oracle`` with one ulp added to every parameter (the biases
    too): each gradient at twice the CPU's worst spread, never below
    LSTM_ORACLE_GRAD_FLOOR, the median at twice the median spread.  A
    control shows that the bar sees a lower precision: the CPU step
    from the parameters rounded to TF32 (only the weights' rounding, a
    part of what TF32 products do) must read past the bar
    (``tf32_worst_fro_rel``)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import set_scope_arrays

    main, startup, loss, slots = build_lstm(fluid)
    _, arrays = start_arrays(fluid, main, startup, fluid.CUDAPlace(0))
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    feed = ragged_batch(fluid, main, slots, LSTM_ORACLE_LENS, SEED + 50,
                        LSTM["dict_dim"])
    _, want, _, held = ulp_oracle(fluid, main, arrays, feed, fetch,
                                  len(params), lambda k, v: k in params,
                                  fro_rel, LSTM_ORACLE_GRAD_FLOOR, 0.0)
    host = fluid.Scope()
    set_scope_arrays(host, {k: tf32(v) if k in params else v
                            for k, v in arrays.items()}, "cpu")
    rounded = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    tf32_worst = max(fro_rel(a, b) for a, b in zip(rounded[1:], want[1:]))
    return {"phase": "train_lstm_oracle", "lens": list(LSTM_ORACLE_LENS),
            **held, "tf32_worst_fro_rel": tf32_worst,
            "ok": held["ok"] and tf32_worst > held["grad_tolerance"]}


def sentiment_conv(torch):
    """Phase train_sentiment_conv: understand_sentiment's conv net (an
    is_sparse SENTIMENT["dict_dim"] x 32 embedding, sequence_conv_pool
    with filters 3 and 4 and sqrt pooling, Adagrad) on three ragged
    batches of SENTIMENT_BATCH sequences of 8 .. SENTIMENT_MAX[i]
    tokens: 3 captured steps on the card (one graph a bucket) against 3
    CPU run() steps from the same start, losses and every persistable
    within SENTIMENT_TOL (atol and rtol), as sparse_update holds them;
    the embedding rows no id touched unchanged (the lazy update)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import understand_sentiment

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, _ = understand_sentiment.get_model(net="conv",
                                                        **SENTIMENT)
    persist, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
    batches = [ragged_batch(fluid, main, slots,
                            ragged_lens(mx, SENTIMENT_BATCH, SEED + 60 + i),
                            SEED + 70 + i, SENTIMENT["dict_dim"])
               for i, mx in enumerate(SENTIMENT_MAX)]
    cpu = fluid.Scope()
    set_scope_arrays(cpu, init, "cpu")
    want = [float(fluid.Executor(fluid.CPUPlace()).run(
        main, feed=b, fetch_list=[loss], scope=cpu)[0].ravel()[0])
        for b in batches]
    card = fluid.Scope()
    set_scope_arrays(card, init, "cuda")
    reset_launches()
    t0 = time.perf_counter()
    with fluid.Executor(fluid.CUDAPlace(0)).prepare(
            main, feed_specs=batches[0], fetch_list=[loss],
            scope=card) as prep:
        got = [float(prep.run_prepared(b, return_numpy=True)[0].ravel()[0])
               for b in batches]
        buckets = prep._prep._step.buckets
    secs = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    a, b = get_scope_arrays(card, persist), get_scope_arrays(cpu, persist)
    err = {k: float(np.abs(a[k].astype(np.float64) - b[k]).max())
           for k in persist}
    ok = (np.allclose(got, want, rtol=SENTIMENT_TOL, atol=SENTIMENT_TOL)
          and all(np.allclose(a[k], b[k], rtol=SENTIMENT_TOL,
                              atol=SENTIMENT_TOL) for k in persist))
    table = next(p.name for p in main.all_parameters()
                 if p.shape[0] == SENTIMENT["dict_dim"])
    ids = np.concatenate([np.asarray(bt["words"].data).ravel()
                          for bt in batches])
    untouched = np.setdiff1d(np.arange(SENTIMENT["dict_dim"]), ids)
    lazy = bool(np.array_equal(a[table][untouched],
                               init[table][untouched]))
    failures = []
    if not ok:
        failures.append("card against CPU past %g: %r" % (
            SENTIMENT_TOL, {k: v for k, v in err.items()
                            if v > SENTIMENT_TOL}))
    if not lazy:
        failures.append("untouched embedding rows moved")
    if len(buckets) != len(SENTIMENT_MAX):
        failures.append("buckets %r" % buckets)
    if launches:
        failures.append("a port kernel ran: %r" % launches)
    return {"phase": "train_sentiment_conv", **SENTIMENT,
            "batch": SENTIMENT_BATCH, "max_lens": list(SENTIMENT_MAX),
            "losses_card": got, "losses_cpu": want, "max_abs_err": err,
            "buckets": buckets, "seconds": secs, "captured": True,
            "untouched_rows_unchanged": lazy, "tolerance": SENTIMENT_TOL,
            "launches": launches, "failures": failures, "ok": not failures}


def slice23_phases(torch):
    """Slice 23's phases in order, as (name, zero-argument callable)."""
    return [("train_lstm", lambda: train_lstm(torch, False)),
            ("train_lstm_amp", lambda: train_lstm(torch, True)),
            ("train_lstm_ragged", lambda: train_lstm_ragged(torch)),
            ("train_lstm_oracle", lambda: lstm_oracle(torch)),
            ("train_sentiment_conv", lambda: sentiment_conv(torch))]


# ---------------------------------------------------------------------------
# slice 24: sub-blocks and control flow (While, conditional_block, the
# tensor arrays, StaticRNN / DynamicRNN), the sentiment DynamicRNN LSTM
# and the seq2seq book model
# ---------------------------------------------------------------------------

# understand_sentiment's DynamicRNN LSTM at the book's widths, on the
# IMDB word dictionary (5147 words), batches as slice 23's
SENTIMENT_DYN = dict(dict_dim=5147, emb_dim=32, hid_dim=128,
                     learning_rate=0.002)
# the seq2seq book model's widths (test_rnn_encoder_decoder.py: dict 30000,
# word and hidden dim 32, Adam); the batch is raised from the book's 2 to
# 64 so that the card does real work (a batch is no width)
SEQ2SEQ = dict(src_dict_dim=30000, trg_dict_dim=30000, emb_dim=32,
               hidden_dim=32)
SEQ2SEQ_BATCH = 64
SEQ2SEQ_MAX = (50, 33, 17)          # padded T 56, 40 and 24
# each bucket once, then again: the first round captures, the second
# replays (its steps timed)
RNN_ORDER = (0, 1, 2, 0, 1, 2)
RNN_ORACLE_LENS = (5, 11, 17, 23)
SLICE24_TIMEOUT_S = 600


def cf_programs(fluid):
    """tests/test_control_flow.py's While sum, While with an array,
    conditional_block, Switch and IfElse programs, built on the port:
    {name: (main, startup, [fetch var], [feed dict a step], [exact
    fetch])}; IfElse trains 3 steps (its selection mask exact, its
    prediction and loss to f32 products' 1e-5)."""
    import numpy as np

    L = fluid.layers
    progs = {}

    def build(name, body, feeds, exact):
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            fetch = body()
        progs[name] = (main, startup, fetch, feeds, exact)

    def while_sum():
        i = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        n = L.fill_constant(shape=[1], dtype="float32", value=10.0)
        s = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        cond = L.less_than(x=i, y=n)
        with L.While(cond=cond).block():
            L.assign(L.elementwise_add(x=s, y=i), s)
            L.increment(x=i, value=1.0, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
        return [s, i, cond]

    def while_array():
        i = L.fill_constant(shape=[1], dtype="int64", value=0)
        n = L.fill_constant(shape=[1], dtype="int64", value=5)
        x = L.fill_constant(shape=[3], dtype="float32", value=1.0)
        arr = L.create_array("float32", element_shape=[3], capacity=8)
        cond = L.less_than(x=i, y=n)
        with L.While(cond=cond).block():
            L.array_write(L.scale(x=x, scale=2.0), i, array=arr)
            L.increment(x=i, value=1.0, in_place=True)
            L.less_than(x=i, y=n, cond=cond)
        j = L.fill_constant(shape=[1], dtype="int64", value=3)
        return [L.array_read(arr, j), L.array_length(arr)]

    def conditional():
        flag = L.data(name="flag", shape=[1], dtype="float32",
                      append_batch_size=False)
        out = L.fill_constant(shape=[1], dtype="float32", value=-1.0)
        cond = L.greater_than(flag, L.fill_constant([1], "float32", 0.0))
        with L.ConditionalBlock([cond]).block():
            L.assign(L.scale(x=flag, scale=10.0), out)
        return [out]

    def switch():
        step = L.data(name="step", shape=[1], dtype="float32",
                      append_batch_size=False)
        lr = L.fill_constant(shape=[1], dtype="float32", value=0.0)
        sw = L.Switch()
        for bound, v in ((5.0, 1.0), (10.0, 0.5)):
            with sw.case(L.less_than(step, L.fill_constant(
                    [1], "float32", bound))):
                L.assign(L.fill_constant([1], "float32", v), lr)
        with sw.default():
            L.assign(L.fill_constant([1], "float32", 0.1), lr)
        return [lr]

    def ifelse():
        x = L.data(name="x", shape=[4], dtype="float32")
        y = L.data(name="y", shape=[1], dtype="float32")
        cond = L.greater_than(L.reduce_sum(x, dim=1, keep_dim=True),
                              L.fill_constant([1], "float32", 0.0))
        ie = L.IfElse(cond)
        with ie.true_block():
            ie.output(L.fc(input=ie.input(x), size=1,
                           param_attr=fluid.ParamAttr(name="w_shared")))
        with ie.false_block():
            ie.output(L.scale(L.fc(
                input=ie.input(x), size=1,
                param_attr=fluid.ParamAttr(name="w_shared")), scale=-1.0))
        pred = ie()
        loss = L.mean(L.square_error_cost(pred, y))
        fluid.optimizer.SGD(learning_rate=0.05).minimize(loss)
        return [cond, loss, pred]

    rng = np.random.RandomState(SEED)
    xv = rng.randn(32, 4).astype(np.float32)
    yv = np.abs(xv.sum(1, keepdims=True)).astype(np.float32)
    build("while_sum", while_sum, [{}], 3)
    build("while_array", while_array, [{}], 2)
    build("conditional_block", conditional,
          [{"flag": np.array([v], np.float32)} for v in (3.0, -3.0)], 1)
    build("switch", switch, [{"step": np.array([v], np.float32)}
                             for v in (2.0, 7.0, 20.0)], 1)
    build("ifelse", ifelse, [{"x": xv, "y": yv}] * 3, 1)
    return progs


def nested_host_read(fluid, kind):
    """A DynamicRNN over [N, T, 3] whose body holds a ``kind``
    (while / conditional_block) op, then fc and softmax cross-entropy:
    (train_func, its main program, startup, loss)."""
    L = fluid.layers

    def train_func():
        x = L.data(name="x", shape=[3], dtype="float32", lod_level=1)
        y = L.data(name="y", shape=[1], dtype="int64")
        rnn = L.DynamicRNN()
        with rnn.block():
            x_t = rnn.step_input(x)
            h = rnn.memory(shape=[8], value=0.0)
            h_new = L.fc(input=[x_t, h], size=8, act="tanh")
            if kind == "while":
                i = L.fill_constant([1], "float32", 0.0)
                n = L.fill_constant([1], "float32", 2.0)
                cond = L.less_than(i, n)
                with L.While(cond=cond).block():
                    L.assign(L.scale(h_new, scale=0.5), h_new)
                    L.increment(i, value=1.0)
                    L.less_than(i, n, cond=cond)
            else:
                cond = L.greater_than(L.reduce_sum(x_t),
                                      L.fill_constant([1], "float32", 0.0))
                with L.ConditionalBlock([cond]).block():
                    L.assign(L.scale(h_new, scale=0.5), h_new)
            rnn.update_memory(h, h_new)
            rnn.output(h_new)
        pred = L.fc(input=L.sequence_last_step(rnn()), size=2,
                    act="softmax")
        return L.mean(L.cross_entropy(input=pred, label=y))

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss = train_func()
        fluid.optimizer.SGD(learning_rate=0.1).minimize(loss)
    return train_func, main, startup, loss


def nested_reader(seed, n=4):
    import numpy as np

    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            yield [(rng.randn(int(rng.randint(2, 9)), 3).astype(
                np.float32).tolist(), [int(rng.randint(2))])
                for _ in range(4)]
    return reader


def control_flow_phase(torch):
    """Phase control_flow: tests/test_control_flow.py's While sum, While
    with an array, conditional_block, Switch and IfElse programs on the
    card against Executor(CPUPlace()) from the same start, the integer,
    condition and selected results exact (the IfElse prediction and
    loss at 1e-5: f32 products); prepare() on the card raises
    Uncapturable for the while and conditional_block programs and for
    a DynamicRNN whose body holds either; a fluid.Trainer over each
    nested program falls back to run() (its prepare() refused, no graph
    captured) and trains as a run() loop does, bit for bit."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.executor_impl import Uncapturable
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    failures, results = [], {}
    for name, (main, startup, fetch, feeds, exact) in \
            cf_programs(fluid).items():
        persist, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
        outs = {}
        for dev, place in (("cuda", fluid.CUDAPlace(0)),
                           ("cpu", fluid.CPUPlace())):
            scope = fluid.Scope()
            set_scope_arrays(scope, init, dev)
            exe = fluid.Executor(place)
            outs[dev] = [exe.run(main, feed=f, fetch_list=fetch, scope=scope)
                         for f in feeds]
        worst = 0.0
        for k, (a, b) in enumerate(zip(outs["cuda"], outs["cpu"])):
            for j, (x, y) in enumerate(zip(a, b)):
                if j < exact and not np.array_equal(x, y):
                    failures.append("%s step %d fetch %d: %r != %r"
                                    % (name, k, j, x.ravel()[:4],
                                       y.ravel()[:4]))
                elif j >= exact:
                    worst = max(worst, float(np.abs(
                        x.astype(np.float64) - y).max()))
                    if not np.allclose(x, y, rtol=1e-5, atol=1e-5):
                        failures.append("%s step %d fetch %d past 1e-5"
                                        % (name, k, j))
        refused = None
        if name in ("while_sum", "while_array", "conditional_block"):
            scope = fluid.Scope()
            set_scope_arrays(scope, init, "cuda")
            try:
                fluid.Executor(fluid.CUDAPlace(0)).prepare(
                    main, feed_specs=feeds[0], fetch_list=fetch,
                    scope=scope)
                failures.append("%s: prepare() captured it" % name)
            except Uncapturable as e:
                refused = str(e)
        results[name] = {
            "steps": len(feeds), "exact_fetches": exact,
            "first_step_card": [np.asarray(x).ravel()[:3].tolist()
                                for x in outs["cuda"][0]],
            "max_abs_err_inexact": worst, "uncapturable": refused}

    nested = {}
    real_prepare = fluid.Executor.prepare
    for kind in ("while", "conditional_block"):
        train_func, main, startup, loss = nested_host_read(fluid, kind)
        persist, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        exe = fluid.Executor(fluid.CUDAPlace(0))
        feeds = [fluid.DataFeeder([main.global_block().var("x"),
                                   main.global_block().var("y")],
                                  program=main).feed(b)
                 for b in nested_reader(SEED + 100)()]
        try:
            exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                        scope=scope)
            failures.append("nested %s: prepare() captured it" % kind)
            refused = None
        except Uncapturable as e:
            refused = str(e)
        refusals = []

        def prepare(self, *a, **kw):
            try:
                return real_prepare(self, *a, **kw)
            except Uncapturable as e:
                refusals.append(str(e))
                raise

        fluid.Executor.prepare = prepare
        try:
            t = fluid.Trainer(train_func=train_func,
                              optimizer_func=lambda: fluid.optimizer.SGD(
                                  learning_rate=0.1))
            tpersist = sorted(n for n, v in
                              t.train_program.desc.blocks[0].vars.items()
                              if v.persistable)
            start = get_scope_arrays(t.scope, tpersist)
            seen = []
            t.train(num_epochs=1, reader=nested_reader(SEED + 100),
                    feed_order=["x", "y"],
                    event_handler=lambda ev: seen.append(
                        float(ev.metrics[0].reshape(-1)[0]))
                    if isinstance(ev, fluid.EndStepEvent) else None)
        finally:
            fluid.Executor.prepare = real_prepare
        # the same steps through run() from the Trainer's start
        scope = fluid.Scope()
        set_scope_arrays(scope, start, "cuda")
        want = [float(exe.run(t.train_program, feed=f,
                              fetch_list=[t.train_func_outputs[0]],
                              scope=scope)[0].ravel()[0]) for f in feeds]
        nested[kind] = {"uncapturable": refused,
                        "trainer_prepare_refusals": len(refusals),
                        "trainer_losses": seen, "run_losses": want}
        if len(refusals) != 1 or seen != want or \
                not all(math.isfinite(v) for v in seen):
            failures.append("Trainer over nested %s: %r" % (kind,
                                                            nested[kind]))
    return {"phase": "control_flow", "programs": results,
            "nested_in_dynamic_rnn": nested, "failures": failures,
            "ok": not failures}


def build_rnn_model(fluid, model, amp=False):
    """(main, startup, loss, slots) of the sentiment DynamicRNN LSTM or
    the seq2seq book model at their published widths."""
    from paddle_tpu_torch.models import (rnn_encoder_decoder,
                                         understand_sentiment)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == "sentiment":
            loss, slots, _ = understand_sentiment.get_model(
                net="dyn_rnn", **SENTIMENT_DYN)
        else:
            loss, slots, _ = rnn_encoder_decoder.get_model(**SEQ2SEQ)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss, slots


def seq2seq_batch(fluid, main, slots, lens, seed):
    """A DataFeeder batch of seeded (source, target, label) rows: the
    targets of ``lens`` words, the sources of as many as the shortest
    to the longest of them, the label the target shifted by one."""
    import numpy as np

    rng = np.random.RandomState(seed)
    rows = []
    for ln in lens:
        src = rng.randint(2, SEQ2SEQ["src_dict_dim"], int(rng.randint(
            min(lens), max(lens) + 1))).tolist()
        trg = rng.randint(2, SEQ2SEQ["trg_dict_dim"], int(ln)).tolist()
        rows.append((src, trg, trg[1:] + [1]))
    return fluid.DataFeeder(slots, program=main).feed(rows)


def rnn_batches(fluid, main, slots, model):
    if model == "sentiment":
        return [ragged_batch(fluid, main, slots,
                             ragged_lens(mx, SENTIMENT_BATCH, SEED + 80 + i),
                             SEED + 90 + i, SENTIMENT_DYN["dict_dim"])
                for i, mx in enumerate(SENTIMENT_MAX)]
    return [seq2seq_batch(fluid, main, slots,
                          ragged_lens(mx, SEQ2SEQ_BATCH, SEED + 100 + i),
                          SEED + 110 + i) for i, mx in enumerate(SEQ2SEQ_MAX)]


def step_kernels(torch, step, n, families=False):
    """(device ms a step, the device's idle share, device kernels
    launched a step (kernels, memcpys, memsets), the five costliest by
    name, or with ``families`` every kernel summed by KERNEL_FAMILIES)
    over ``n`` calls of ``step`` under ``torch.profiler``."""
    from paddle_tpu_torch.tools.profile_train import device_kernels

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = device_kernels(prof, n)
    if not kernels:
        return "not measured", "not measured", "not measured", {}
    busy = sum(k["ms_per_step"] for k in kernels.values())
    top = kernel_families(kernels) if families else dict(
        sorted(kernels.items(), key=lambda kv: -kv[1]["ms_per_step"])[:5])
    return (busy, max(0.0, 1.0 - busy / wall),
            sum(k["calls_per_step"] for k in kernels.values()), top)


def train_rnn(torch, model, amp=False):
    """Phases train_sentiment_dyn_rnn (f32), train_sentiment_dyn_rnn_amp
    (bf16 AMP) and train_rnn_seq2seq: the model at its published widths
    on three seeded ragged buckets, stepped in RNN_ORDER through the
    prepared step (the first round captures one graph a bucket, all in
    one memory pool, which with the card's reserved bytes grows by at
    most RAGGED_GROWTH_MAX after the first capture; the second replays)
    and through run() from the same start: the losses and every
    persistable bit for bit, finite losses; ms a step of the second
    round on each path; then one traced step of each (bucket 0): device
    ms, idle share, device kernels launched and the costliest; no
    kernel of the port runs (no TPU kernel on the path)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss, slots = build_rnn_model(fluid, model, amp)
    persist, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
    batches = rnn_batches(fluid, main, slots, model)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    runs = {}
    for path in ("prepared", "run"):
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        torch.cuda.empty_cache()
        reset_launches()
        losses, step_ms, memory, buckets, pools = [], [], [], None, None
        t0 = time.perf_counter()
        if path == "prepared":
            with exe.prepare(main, feed_specs=batches[0], fetch_list=[loss],
                             scope=scope) as prep:
                caps = prep._prep._step._captures

                def step(i):
                    return prep.run_prepared(batches[i], return_numpy=True)
                for i in RNN_ORDER:
                    n = len(caps)
                    t1 = time.perf_counter()
                    losses.append(float(step(i)[0].ravel()[0]))
                    step_ms.append((time.perf_counter() - t1) * 1e3)
                    if len(caps) > n:
                        memory.append(pool_memory(torch, caps))
                launches = {k: fn.launches for k, fn in KERNELS.items()
                            if fn.launches}
                buckets = prep._prep._step.buckets
                pools = len({c.graph.pool() for c in caps.values()})
                state = None
                prep.sync_scope()
                state = get_scope_arrays(scope, persist)
                traced = step_kernels(torch, lambda: step(0), 1)
        else:
            def step(i):
                return exe.run(main, feed=batches[i], fetch_list=[loss],
                               scope=scope)
            for i in RNN_ORDER:
                t1 = time.perf_counter()
                losses.append(float(step(i)[0].ravel()[0]))
                step_ms.append((time.perf_counter() - t1) * 1e3)
            launches = {k: fn.launches for k, fn in KERNELS.items()
                        if fn.launches}
            state = get_scope_arrays(scope, persist)
            traced = step_kernels(torch, lambda: step(0), 1)
        secs = time.perf_counter() - t0
        half = len(RNN_ORDER) // 2
        runs[path] = {"losses": losses, "step_ms": step_ms,
                      "ms_per_step": sum(step_ms[half:]) / half,
                      "seconds": secs, "buckets": buckets,
                      "memory_by_bucket": memory, "pools": pools,
                      "launches": launches, "state": state,
                      "device_ms_per_step": traced[0],
                      "device_idle_share": traced[1],
                      "device_launches_per_step": traced[2],
                      "costliest_kernels": traced[3]}
        del scope
    p, r = runs["prepared"], runs["run"]
    identical = p["losses"] == r["losses"] and all(
        np.array_equal(p["state"][n], r["state"][n]) for n in persist)
    failures = []
    if not identical:
        worst = max(persist, key=lambda n: float(np.abs(
            p["state"][n].astype(np.float64) - r["state"][n]).max()))
        failures.append("prepared against run(): not bit for bit (losses "
                        "%r against %r, worst %s)" % (p["losses"],
                                                      r["losses"], worst))
    if not all(math.isfinite(x) for x in p["losses"]):
        failures.append("losses %r" % p["losses"])
    if len(p["buckets"]) != 3 or any(
            v != {"captures": 1, "replays": 2} for v in p["buckets"].values()):
        failures.append("buckets %r" % p["buckets"])
    if p["pools"] != 1:
        failures.append("the buckets' graphs in %r pools" % p["pools"])
    mem = p["memory_by_bucket"]
    for key in ("pool_bytes", "reserved_bytes"):
        if not mem or mem[-1][key] > (1 + RAGGED_GROWTH_MAX) * mem[0][key]:
            failures.append("%s grew past %g: %r"
                            % (key, RAGGED_GROWTH_MAX, mem))
    if p["launches"] or r["launches"]:
        failures.append("a port kernel ran: %r" % [p["launches"],
                                                   r["launches"]])
    for v in runs.values():
        del v["state"]
    name = ("train_sentiment_dyn_rnn" + ("_amp" if amp else "")
            if model == "sentiment" else "train_rnn_seq2seq")
    widths = dict(SENTIMENT_DYN, batch=SENTIMENT_BATCH,
                  max_lens=list(SENTIMENT_MAX)) if model == "sentiment" \
        else dict(SEQ2SEQ, batch=SEQ2SEQ_BATCH, max_lens=list(SEQ2SEQ_MAX),
                  batch_note="the book trains at batch 2; 64 here so that "
                             "the card does real work (a batch is no width)")
    return {"phase": name, "amp": amp, **widths, "order": list(RNN_ORDER),
            "ms_per_step_prepared": p["ms_per_step"],
            "ms_per_step_run": r["ms_per_step"],
            "run_over_prepared": r["ms_per_step"] / p["ms_per_step"],
            "bit_identical_to_run": identical, "paths": runs,
            "launches": p["launches"], "failures": failures,
            "ok": not failures}


def rnn_oracle(torch):
    """Phase rnn_oracle: one f32 step of each model at its published
    widths on 4 sequences of RNN_ORACLE_LENS words, held by
    ``ulp_oracle``: one ulp added to every parameter, each gradient at
    twice the CPU's worst spread and the median at twice the median
    spread, with no floor (on an H100 the worst gradients read 3.8e-7
    and 5.4e-7 against spreads of 5.6e-7 and 3.9e-7: no cancelling sum
    stands out, as the LSTM's bias does for train_lstm_oracle); and a
    control past the bar, the CPU step from the parameters rounded to
    TF32 (``tf32_worst_fro_rel``)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import set_scope_arrays

    out, ok = {}, True
    for model in ("sentiment", "seq2seq"):
        main, startup, loss, slots = build_rnn_model(fluid, model)
        _, arrays = start_arrays(fluid, main, startup, fluid.CPUPlace())
        params = sorted(p.name for p in main.all_parameters()
                        if p.trainable)
        fetch = [loss.name] + [p + "@GRAD" for p in params]
        if model == "sentiment":
            feed = ragged_batch(fluid, main, slots, RNN_ORACLE_LENS,
                                SEED + 120, SENTIMENT_DYN["dict_dim"])
        else:
            feed = seq2seq_batch(fluid, main, slots, RNN_ORACLE_LENS,
                                 SEED + 121)
        _, want, _, held = ulp_oracle(fluid, main, arrays, feed, fetch,
                                      len(params), lambda k, v: k in params,
                                      fro_rel, 0.0)
        host = fluid.Scope()
        set_scope_arrays(host, {k: tf32(v) if k in params else v
                                for k, v in arrays.items()}, "cpu")
        rounded = fluid.Executor(fluid.CPUPlace()).run(
            main, feed=feed, fetch_list=fetch, scope=host)
        tf32_worst = max(fro_rel(dense_rows(a), b)
                         for a, b in zip(rounded[1:], want[1:]))
        held["tf32_worst_fro_rel"] = tf32_worst
        held["ok"] = held["ok"] and tf32_worst > held["grad_tolerance"]
        ok = ok and held["ok"]
        out[model] = held
    return {"phase": "rnn_oracle", "lens": list(RNN_ORACLE_LENS),
            **out, "ok": ok}


def slice24_phases(torch):
    """Slice 24's phases in order, as (name, zero-argument callable)."""
    return [("control_flow", lambda: control_flow_phase(torch)),
            ("train_sentiment_dyn_rnn",
             lambda: train_rnn(torch, "sentiment")),
            ("train_sentiment_dyn_rnn_amp",
             lambda: train_rnn(torch, "sentiment", amp=True)),
            ("train_rnn_seq2seq", lambda: train_rnn(torch, "seq2seq")),
            ("rnn_oracle", lambda: rnn_oracle(torch))]


# ---------------------------------------------------------------------------
# slice 25: the training front end (LR schedules, regularizers, gradient
# clips, the other optimizers) and the dense op library; AlexNet and
# GoogLeNet through the bench entry
# ---------------------------------------------------------------------------

SCHED_STEPS = 5         # timed steps, after the first (run()'s warm-up,
                        # the prepared step's capture): 6 compared
SCHED_NOAM_WARMUP = 4000
SCHED_PIECEWISE = ([2, 4], [1e-3, 5e-4, 2.5e-4])
SCHED_L2 = 1e-4
SCHED_CLIP = 1.0
SCHED_PROFILED = 1      # replays traced for the step's kernels
OPT_FEATURES, OPT_HIDDEN, OPT_BATCH = 256, 512, 64
OPT_STEPS = 3
OPT_TOL = 1e-6          # or twice the CPU's one-ulp spread, the larger
LEGACY_ORACLE_BATCH = 4
LEGACY_BASELINES = {"alexnet": 626.53, "googlenet": 269.50}  # bench.py:775
SLICE25_TIMEOUT_S = 600


def build_sched_lm(fluid, schedule="noam", fuse=False, amp=False,
                   **overrides):
    """The flagship LM's training program under a schedule, built with
    the reference's public API alone: ``transformer_lm``,
    ``softmax_with_cross_entropy`` and ``mean``;
    ``set_gradient_clip(GradientClipByGlobalNorm(1.0))``; Adam with
    ``L2Decay(1e-4)`` over ``noam_decay(d_model, 4000)`` or
    ``piecewise_decay([2, 4], [1e-3, 5e-4, 2.5e-4])``.  With ``fuse`` the
    fused-block program (the fuse pass before minimize), with ``amp``
    under bf16 AMP.  Returns (main, startup, loss, learning rate)."""
    from paddle_tpu_torch.models import transformer

    cfg = {**TRAIN_LM, **overrides}
    seq = cfg["seq_len"]
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        L = fluid.layers
        src = L.data(name="src", shape=[seq], dtype="int64")
        label = L.data(name="label", shape=[seq, 1], dtype="int64")
        logits = transformer.transformer_lm(
            src, cfg["vocab_size"], seq, cfg["d_model"], cfg["n_head"],
            cfg["n_layers"], cfg["d_ff"])
        loss = L.mean(L.softmax_with_cross_entropy(logits, label))
        if fuse:
            fluid.transpiler.TransformerFuseTranspiler().transpile(main)
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByGlobalNorm(clip_norm=SCHED_CLIP))
        lr = (L.noam_decay(cfg["d_model"], SCHED_NOAM_WARMUP)
              if schedule == "noam" else L.piecewise_decay(*SCHED_PIECEWISE))
        fluid.optimizer.Adam(
            learning_rate=lr,
            regularization=fluid.regularizer.L2Decay(SCHED_L2)
        ).minimize(loss)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss, lr


def noam_lr(step):
    """noam_decay(1024, 4000)'s value at ``step`` in float64."""
    d = TRAIN_LM["d_model"]
    return d ** -0.5 * min(step ** -0.5, SCHED_NOAM_WARMUP ** -1.5 * step)


def piecewise_lr(step):
    bounds, values = SCHED_PIECEWISE
    return values[sum(step >= b for b in bounds)]


def lm_step_paths(torch, fluid, main, startup, loss, lr, feed, profile=True):
    """One set of startup values, then SCHED_STEPS + 1 steps through
    run() and through the prepared step (its first step captures): each
    step's loss and learning rate, the state after, ms a step of the
    last SCHED_STEPS, the kernels' launches over them, peak memory; with
    ``profile``, a traced step of each (device ms, idle share, device
    kernels a step, the costliest)."""
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    persist, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
    exe = fluid.Executor(fluid.CUDAPlace(0))
    out = {}
    for path in ("run", "prepared"):
        _free(torch)
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        torch.cuda.reset_peak_memory_stats()
        prep = None
        if path == "prepared":
            prep = exe.prepare(main, feed_specs=feed, fetch_list=[loss, lr],
                               scope=scope)

            def step():
                return prep.run_prepared(feed, return_numpy=True)
        else:
            def step():
                return exe.run(main, feed=feed, fetch_list=[loss, lr],
                               scope=scope)
        t0 = time.perf_counter()
        fetched = [step()]
        first_s = time.perf_counter() - t0
        reset_launches()
        step_ms = []
        for _ in range(SCHED_STEPS):
            t0 = time.perf_counter()
            fetched.append(step())
            step_ms.append((time.perf_counter() - t0) * 1e3)
        launches = {k: fn.launches for k, fn in KERNELS.items()
                    if fn.launches}
        peak = torch.cuda.max_memory_allocated()
        if prep is not None:
            prep.sync_scope()
        state = get_scope_arrays(scope, persist)
        dtypes = param_dtypes(main, scope)
        traced = (step_kernels(torch, step, SCHED_PROFILED) if profile
                  else ("not measured",) * 3 + ({},))
        del prep, scope
        p50 = _pct(step_ms, 0.5)
        out[path] = {
            "first_step_s": first_s,
            "losses": [float(f[0].ravel()[0]) for f in fetched],
            "lrs": [float(f[1].ravel()[0]) for f in fetched],
            "step_ms": step_ms, "step_ms_p50": p50,
            "tokens_per_s": feed["src"].size / p50 * 1e3,
            "max_memory_allocated_bytes": peak,
            "launches": launches,
            "launches_per_step": {k: v / SCHED_STEPS
                                  for k, v in launches.items()},
            "param_dtypes": dtypes, "state": state,
            "device_ms_per_step": traced[0], "device_idle_share": traced[1],
            "device_launches_per_step": traced[2],
            "costliest_kernels": traced[3]}
    return persist, out


def sched_checks(np, persist, out, want_lr, want_launches):
    """The checks a scheduled LM's paths must pass: the prepared step
    bit for bit with run() (every loss, learning rate and persistable,
    the step counter among them), the counter at the steps taken, the
    learning rates ``want_lr(step)`` within one f32 ulp, the kernels'
    launches a step ``want_launches`` on both paths, finite falling
    losses, float32 parameters."""
    r, p = out["run"], out["prepared"]
    failures = []
    if r["losses"] != p["losses"] or r["lrs"] != p["lrs"]:
        failures.append("prepared fetches %r against run()'s %r"
                        % ([p["losses"], p["lrs"]], [r["losses"], r["lrs"]]))
    differ = [n for n in persist
              if not np.array_equal(r["state"][n], p["state"][n])]
    if differ:
        failures.append("prepared persistables differ from run()'s: %r"
                        % differ[:5])
    steps = SCHED_STEPS + 1
    counter = float(p["state"]["@LR_DECAY_COUNTER@"][0])
    if counter != steps:
        failures.append("@LR_DECAY_COUNTER@ %r after %d steps"
                        % (counter, steps))
    lr_ulps = []
    for s, got in enumerate(p["lrs"], 1):
        want = want_lr(s)
        lr_ulps.append(abs(got - want) / float(np.spacing(np.float32(want))))
    if max(lr_ulps) > 1.0:
        failures.append("learning rates %r, %r ulps off" % (p["lrs"],
                                                             lr_ulps))
    for path in ("run", "prepared"):
        per = out[path]["launches_per_step"]
        if per != {k: float(v) for k, v in want_launches.items()}:
            failures.append("%s launches a step %r, want %r"
                            % (path, per, want_launches))
        losses = out[path]["losses"]
        if not (all(math.isfinite(x) for x in losses)
                and losses[-1] < losses[0]):
            failures.append("%s losses %r" % (path, losses))
        if out[path]["param_dtypes"] != ["float32"]:
            failures.append("%s parameter dtypes %r"
                            % (path, out[path]["param_dtypes"]))
    return lr_ulps, failures


def train_lm_sched(torch):
    """Phase train_lm_sched, the slice's main path: the flagship LM at
    TRAIN_LM, batch 16, unfused f32, under noam_decay(1024, 4000), a
    global-norm clip of 1.0 and L2Decay(1e-4) with Adam
    (``build_sched_lm``), through Executor.prepare / run_prepared (one
    CUDA graph a step: the counter's increment, the schedule, the clip
    and the decay inside the replay) and through run(), 6 steps each
    from one start, bit for bit (``sched_checks``); K1, K2 and K3
    n_layers times a step on both paths.  Beside it the plain
    ``train_f32`` program (constant learning rate, no clip, no decay)
    through the same two paths: step ms, tokens/s and a traced replay
    each, so that what the clip and the decay add shows."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    feed = lm_batch(TRAIN_BATCH, SEED + 3)
    main, startup, loss, lr = build_sched_lm(fluid)
    ops = [op.type for op in main.desc.blocks[0].ops]
    persist, out = lm_step_paths(torch, fluid, main, startup, loss, lr, feed)
    lr_ulps, failures = sched_checks(np, persist, out, noam_lr,
                                     train_launches_per_step(False))
    # the plain program of train_f32, through the same paths
    pmain, pstart, ploss = build_lm(fluid)
    plr = [n for n in pmain.desc.blocks[0].vars if n.startswith(
        "learning_rate")][0]
    _, plain = lm_step_paths(torch, fluid, pmain, pstart, ploss,
                             pmain.global_block().var(plr), feed)
    for res in list(out.values()) + list(plain.values()):
        del res["state"]
    p, q = out["prepared"], plain["prepared"]
    return {"phase": "train_lm_sched", "batch": TRAIN_BATCH, **TRAIN_LM,
            "schedule": "noam_decay(%d, %d)" % (TRAIN_LM["d_model"],
                                                SCHED_NOAM_WARMUP),
            "clip": "GradientClipByGlobalNorm(%g)" % SCHED_CLIP,
            "regularizer": "L2Decay(%g)" % SCHED_L2,
            "ops_added": {t: ops.count(t) for t in (
                "increment", "square", "reduce_sum", "sqrt", "sum",
                "elementwise_max", "elementwise_div", "elementwise_mul",
                "scale", "elementwise_pow", "elementwise_min")},
            "step_ms_p50": p["step_ms_p50"],
            "tokens_per_s": p["tokens_per_s"],
            "run_step_ms_p50": out["run"]["step_ms_p50"],
            "train_f32_step_ms_p50": q["step_ms_p50"],
            "train_f32_tokens_per_s": q["tokens_per_s"],
            "train_f32_run_step_ms_p50": plain["run"]["step_ms_p50"],
            "sched_over_train_f32": p["step_ms_p50"] / q["step_ms_p50"],
            "lr_ulps_off": lr_ulps, "paths": out, "train_f32_paths": plain,
            "launches": p["launches"], "failures": failures,
            "ok": not failures}


def train_lm_sched_fused_amp(torch):
    """Phase train_lm_sched_fused_amp: the same LM as the fused-block
    program under bf16 AMP (K1-K5 in bf16), under piecewise_decay([2,
    4], [1e-3, 5e-4, 2.5e-4]) (its table an assign_value: a device
    constant of the captured step), the global-norm clip and L2Decay; 6
    steps of run() and of the prepared step bit for bit, crossing both
    boundaries inside the replays; the parameters stay float32, as
    ``train_fused_amp``'s do."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid

    feed = lm_batch(TRAIN_BATCH, SEED + 3)
    main, startup, loss, lr = build_sched_lm(fluid, "piecewise", fuse=True,
                                             amp=True)
    n_assign = sum(op.type == "assign_value"
                   for op in main.desc.blocks[0].ops)
    persist, out = lm_step_paths(torch, fluid, main, startup, loss, lr, feed)
    lr_ulps, failures = sched_checks(np, persist, out, piecewise_lr,
                                     train_launches_per_step(True, True))
    if n_assign != 1:
        failures.append("%d assign_value ops" % n_assign)
    for res in out.values():
        del res["state"]
    p = out["prepared"]
    return {"phase": "train_lm_sched_fused_amp", "amp": True,
            "batch": TRAIN_BATCH, **TRAIN_LM,
            "schedule": "piecewise_decay(%r, %r)" % SCHED_PIECEWISE,
            "clip": "GradientClipByGlobalNorm(%g)" % SCHED_CLIP,
            "regularizer": "L2Decay(%g)" % SCHED_L2,
            "step_ms_p50": p["step_ms_p50"],
            "tokens_per_s": p["tokens_per_s"],
            "run_step_ms_p50": out["run"]["step_ms_p50"],
            "lrs": p["lrs"], "lr_ulps_off": lr_ulps, "paths": out,
            "launches": p["launches"], "failures": failures,
            "ok": not failures}


def lm_sched_oracle(torch):
    """Phase train_lm_sched_oracle: one f32 step of the scheduled LM
    (noam, clip, L2) at full width, depth 1, batch 1, on the card and on
    Executor(CPUPlace()), held by ``ulp_oracle``: one ulp added to every
    parameter, each gradient at twice the CPU's worst spread, never
    below ORACLE_GRAD_RTOL (the f32 LM oracle's bar)."""
    import paddle_tpu_torch.fluid as fluid

    main, startup, loss, _ = build_sched_lm(fluid, n_layers=1)
    _, arrays = start_arrays(fluid, main, startup, fluid.CPUPlace())
    params = sorted(p.name for p in main.all_parameters())
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    _, _, _, held = ulp_oracle(
        fluid, main, arrays, lm_batch(1, SEED + 4), fetch, len(params),
        lambda k, v: k in params, lambda a, b, scale: fro_rel(a, b),
        ORACLE_GRAD_RTOL)
    return {"phase": "train_lm_sched_oracle", "n_layers": 1, "batch": 1,
            **held}


def _opt_case(fluid, case):
    """The fc program of the optimizers phase: x [256] -> fc 512 relu ->
    fc 1, squared error, under ``case``'s optimizer, clip or decay;
    returns (loss, ModelAverage or None)."""
    L, O = fluid.layers, fluid.optimizer
    x = L.data(name="x", shape=[OPT_FEATURES], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(
        L.fc(L.fc(x, OPT_HIDDEN, act="relu"), 1), y))
    avg = None
    if case.startswith("clip_"):
        fluid.clip.set_gradient_clip(
            fluid.clip.GradientClipByValue(1e-3) if case == "clip_by_value"
            else fluid.clip.GradientClipByNorm(1e-2))
    opt = {"adamax": lambda: O.Adamax(1e-3),
           "decayed_adagrad": lambda: O.DecayedAdagrad(1e-3),
           "adadelta": lambda: O.Adadelta(1.0),
           "rmsprop": lambda: O.RMSProp(1e-3, momentum=0.5),
           "ftrl": lambda: O.Ftrl(1e-2, l1=1e-3, l2=1e-3),
           "l1_decay": lambda: O.Momentum(
               1e-2, 0.9, regularization=fluid.regularizer.L1Decay(1e-3))
           }.get(case, lambda: O.Adam(1e-3))()
    opt.minimize(loss)
    if case == "model_average":
        avg = O.ModelAverage(0.5, min_average_window=2, max_average_window=3)
    return loss, avg


OPT_CASES = ("adamax", "decayed_adagrad", "adadelta", "rmsprop", "ftrl",
             "model_average", "clip_by_value", "clip_by_norm", "l1_decay")


def optimizers_phase(torch):
    """Phase optimizers: each new optimizer class (Adamax,
    DecayedAdagrad, Adadelta, RMSProp, Ftrl; ModelAverage over Adam),
    GradientClipByValue / ByNorm (Adam) and L1Decay (Momentum) on a
    small dense fc program: OPT_STEPS captured steps on the card against
    OPT_STEPS run() steps of Executor(CPUPlace()) from one start, the
    losses and every persistable within OPT_TOL or twice the CPU's own
    one-ulp spread; ModelAverage's apply (the averaged parameters) and
    restore (the trained ones, bit for bit) on the card against the
    CPU's."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    rng = np.random.RandomState(SEED + 25)
    feeds = [{"x": rng.randn(OPT_BATCH, OPT_FEATURES).astype(np.float32),
              "y": rng.randn(OPT_BATCH, 1).astype(np.float32)}
             for _ in range(OPT_STEPS)]
    cases, failures = {}, []
    for case in OPT_CASES:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss, avg = _opt_case(fluid, case)
        persist, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
        params = sorted(p.name for p in main.all_parameters())
        res = {}
        for where in ("cuda", "cpu", "cpu_ulp"):
            scope = fluid.Scope()
            set_scope_arrays(scope, {
                k: np.nextafter(v, np.float32(np.inf))
                if where == "cpu_ulp" and k in params else v
                for k, v in init.items()}, "cuda" if where == "cuda"
                else "cpu")
            exe = fluid.Executor(fluid.CUDAPlace(0) if where == "cuda"
                                 else fluid.CPUPlace())
            if where == "cuda":
                with exe.prepare(main, feed_specs=feeds[0],
                                 fetch_list=[loss], scope=scope) as prep:
                    losses = [prep.run_prepared(f, return_numpy=True)[0]
                              for f in feeds]
            else:
                losses = [exe.run(main, feed=f, fetch_list=[loss],
                                  scope=scope)[0] for f in feeds]
            state = get_scope_arrays(scope, persist)
            state["loss"] = np.concatenate([np.ravel(x) for x in losses])
            if avg is not None:
                with fluid.scope_guard(scope):
                    with avg.apply(exe):
                        applied = get_scope_arrays(scope, params)
                restored = get_scope_arrays(scope, params)
                state.update({"applied:" + k: v for k, v in applied.items()})
                if any(not np.array_equal(restored[k], state[k])
                       for k in params):
                    failures.append("%s: restore on %s did not give the "
                                    "trained parameters back" % (case,
                                                                 where))
            res[where] = state
        worst, held = None, True
        for name, want in res["cpu"].items():
            if want.dtype.kind != "f":
                if not np.array_equal(res["cuda"][name], want):
                    held = False
                    worst = (name, "integers differ")
                continue
            spread = float(np.abs(res["cpu_ulp"][name].astype(np.float64)
                                  - want).max(initial=0.0))
            bar = max(OPT_TOL, 2 * spread)
            err = float(np.abs(res["cuda"][name].astype(np.float64)
                               - want).max(initial=0.0))
            scale = max(1.0, float(np.abs(want).max(initial=0.0)))
            if not err <= bar * scale:
                held = False
            if worst is None or err / (bar * scale) > worst[1]:
                worst = (name, err / (bar * scale), err, bar)
        cases[case] = {"losses_card": res["cuda"]["loss"].tolist(),
                       "losses_cpu": res["cpu"]["loss"].tolist(),
                       "worst_vs_bar": worst, "ok": held}
        if not held:
            failures.append("%s: the card's steps miss the CPU's: %r"
                            % (case, worst))
    return {"phase": "optimizers", "steps": OPT_STEPS,
            "widths": [OPT_FEATURES, OPT_HIDDEN, 1], "batch": OPT_BATCH,
            "tolerance": "max(%g, twice the CPU's one-ulp spread), times "
                         "max(1, |value|)" % OPT_TOL,
            "cases": cases, "failures": failures, "ok": not failures}


def bench_model(torch, model):
    """Phases train_alexnet and train_googlenet: the port's bench entry
    with BENCH_MODEL=``model`` at bench.py's card defaults (flowers 224 x
    224, batch 256, bf16 AMP, the prepared step), BENCH_ITERS iterations:
    images/s and vs_baseline (bench.py:775-778's MKL-DNN CPU number),
    its checks (finite falling losses, float32 parameters, every timed
    step prepared); bench.py counts no FLOPs for these models, so no
    mfu."""
    root = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items() if not k.startswith("BENCH_")}
    env.update(BENCH_MODEL=model, BENCH_ITERS=str(BENCH_ITERS),
               BENCH_SECONDARY="0")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m",
                           "paddle_tpu_torch.tools.bench"], cwd=root,
                          env=env, capture_output=True, text=True,
                          timeout=600)
    secs = time.perf_counter() - t0
    if proc.returncode != 0 or not proc.stdout.strip():
        sys.stderr.write(proc.stderr[-4000:])
        return {"phase": "train_" + model, "ok": False,
                "error": "the bench entry exited %d" % proc.returncode}
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    checks = bench_checks(out, True, True)
    checks.update(
        metric=out["metric"] == "%s_flowers_train_bs256_bf16" % model
        and out["unit"] == "images/sec",
        mfu=out["mfu"] is None and out["tflops"] is None,
        vs_baseline=out["vs_baseline"] == out["value"]
        / LEGACY_BASELINES[model],
        data_format=out["data_format"] == "NCHW",
        secondary=out["secondary"] is None)
    failed = sorted(k for k, v in checks.items() if not v)
    return {"phase": "train_" + model, "seconds": secs,
            "images_per_s": out["value"], "vs_baseline": out["vs_baseline"],
            "bench": {k: out.get(k) for k in (
                "metric", "value", "unit", "vs_baseline", "step_ms_p50",
                "step_ms_p90", "step_ms_p99", "amp", "prepared",
                "prepared_steps", "losses", "param_dtypes", "device")},
            "failures": failed, "ok": not failed}


def legacy_oracle(torch, model, seed=SEED):
    """Phases train_alexnet_oracle and train_googlenet_oracle: one f32
    step of the model (flowers 224 x 224) at batch LEGACY_ORACLE_BATCH
    on the card and on Executor(CPUPlace()), its dropout masks one
    seeded draw put in through ``ops/random.keep_mask`` on both (so the
    two places drop the same units), held by ``ulp_oracle`` as VGG16-BN
    is: one ulp added to every filter, twice the CPU's spread, never
    below ORACLE_GRAD_RTOL."""
    import zlib

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import alexnet, googlenet
    from paddle_tpu_torch.ops import random as prandom

    mod = alexnet if model == "alexnet" else googlenet
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = mod.get_model()
    startup.random_seed = seed
    _, arrays = start_arrays(fluid, main, startup, fluid.CPUPlace())
    params = sorted(p.name for p in main.all_parameters())
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    rng = np.random.RandomState(seed + 11)
    feed = {"data": rng.rand(LEGACY_ORACLE_BATCH, 3, 224, 224).astype(
                np.float32),
            "label": rng.randint(0, 102, (LEGACY_ORACLE_BATCH, 1)).astype(
                np.int64)}

    def seeded_keep(ctx, shape, keep_prob, seed=0):
        name = ctx.op.output("Mask")[0]
        mask = np.random.RandomState(zlib.crc32(name.encode())).rand(
            *shape) < keep_prob
        return torch.from_numpy(mask).to(ctx.device)

    real = prandom.keep_mask
    prandom.keep_mask = seeded_keep
    try:
        _, _, _, held = ulp_oracle(
            fluid, main, arrays, feed, fetch, len(params),
            lambda k, v: v.ndim == 4, lambda a, b, scale: fro_rel(a, b),
            ORACLE_GRAD_RTOL)
    finally:
        prandom.keep_mask = real
    return {"phase": "train_%s_oracle" % model,
            "batch": LEGACY_ORACLE_BATCH, "seed": seed,
            "masks": "one seeded draw a dropout op, the same on both "
                     "places (ops/random.keep_mask)", **held}


def slice25_phases(torch):
    """Slice 25's phases in order, as (name, zero-argument callable)."""
    return [("train_lm_sched", lambda: train_lm_sched(torch)),
            ("train_lm_sched_fused_amp",
             lambda: train_lm_sched_fused_amp(torch)),
            ("train_lm_sched_oracle", lambda: lm_sched_oracle(torch)),
            ("optimizers", lambda: optimizers_phase(torch)),
            ("train_alexnet", lambda: bench_model(torch, "alexnet")),
            ("train_alexnet_oracle",
             lambda: legacy_oracle(torch, "alexnet")),
            ("train_googlenet", lambda: bench_model(torch, "googlenet")),
            ("train_googlenet_oracle",
             lambda: legacy_oracle(torch, "googlenet"))]


# ---------------------------------------------------------------------------
# slice 26: crf_ctc, beam_search and the last three book models
# (machine_translation, recommender, label_semantic_roles) on their
# dataset adapters' synthetic corpora; no TPU kernel on the path
# ---------------------------------------------------------------------------

BOOK_BATCH = {"machine_translation": 64, "recommender": 64,
              "label_semantic_roles": 16}
BOOK_ORDER = {"machine_translation": (0, 1, 0, 1),
              "recommender": (0, 1, 2, 0, 1, 2),
              "label_semantic_roles": (0, 1, 2, 0, 1, 2)}
# the ragged buckets of each model's batches ({feed name: padded T})
BOOK_BUCKETS = {"machine_translation": 2, "recommender": 1,
                "label_semantic_roles": 3}
BOOK_ORACLE_BATCH = 4
CTC = dict(n=16, features=128, vocab=32, t=(60, 100), labels=(10, 30))
BEAM = dict(sentences=8, beam=4, vocab=1000, steps=12)
BEAM_SCORE_TOL = 1e-6
SLICE26_TIMEOUT_S = 600


def build_book(fluid, model):
    """(main, startup, loss, slots, fetch besides the loss) of a book
    model at its published widths: machine_translation.get_model's
    defaults (dicts 10000, emb and hidden 256), the recommender's fixed
    widths over movielens' dictionaries, label_semantic_roles at its
    defaults (hidden 512, depth 8) with the word table trained
    (``train_word_emb=True``) and its crf_decoding fetched."""
    from paddle_tpu_torch import dataset
    from paddle_tpu_torch.models import (label_semantic_roles,
                                         machine_translation, recommender)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == "machine_translation":
            loss, slots, extra = machine_translation.get_model()
        elif model == "recommender":
            loss, slots, extra = recommender.get_model()
            extra = []
        else:
            word, verb, label = dataset.conll05.get_dict()
            loss, slots, extra = label_semantic_roles.get_model(
                len(word), len(label), len(verb), train_word_emb=True)
    return main, startup, loss, slots, list(extra)


def book_rows(model):
    """The dataset adapter's synthetic samples of ``model``, grouped so
    that its batches fall in BOOK_BUCKETS[model] padded buckets: wmt14
    (dict 10000) by sentence length (<= 6 words: T 8, else 16), conll05
    by sentence length (<= 8, <= 16, 17: T 8, 16, 24), movielens in
    reader order (every batch at T 8)."""
    from paddle_tpu_torch import dataset

    n = BOOK_BATCH[model]
    if model == "machine_translation":
        rows = list(dataset.wmt14.train(10000)())
        short = [r for r in rows if len(r[0]) <= 8]
        long_ = [r for r in rows if len(r[0]) > 8]
        return [short[:n], long_[:n]]
    if model == "recommender":
        rows = list(dataset.movielens.train()())
        return [rows[i * n:(i + 1) * n] for i in range(3)]
    rows = list(dataset.conll05.test()())
    by = [[r for r in rows if lo < len(r[0]) <= hi]
          for lo, hi in ((0, 8), (8, 16), (16, 24))]
    return [b[:n] for b in by]


def train_book(torch, model):
    """Phases train_mt, train_recommender and train_srl: the model at
    its published widths (``build_book``) on its adapter's batches
    (``book_rows``), stepped in BOOK_ORDER[model] through the prepared
    step (the first round captures one graph a padded bucket, all in one
    memory pool; the rest replay) and through run() from the same start:
    the fetches (the SRL's Viterbi path too) and every persistable bit
    for bit, finite losses; ms a step of the second round on each path,
    the peak memory, a traced step's device ms, idle share and
    kernels; no kernel of the port runs (no TPU kernel on the path)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss, slots, extra = build_book(fluid, model)
    fetch = [loss] + extra
    persist, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
    feeder = fluid.DataFeeder(slots, program=main)
    batches = [feeder.feed(rows) for rows in book_rows(model)]
    order = BOOK_ORDER[model]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    runs = {}
    for path in ("prepared", "run"):
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        outs, step_ms, buckets, pools = [], [], None, None
        t0 = time.perf_counter()
        if path == "prepared":
            with exe.prepare(main, feed_specs=batches[0], fetch_list=fetch,
                             scope=scope) as prep:
                caps = prep._prep._step._captures

                def step(i):
                    return prep.run_prepared(batches[i], return_numpy=True)
                for i in order:
                    t1 = time.perf_counter()
                    outs.append(step(i))
                    step_ms.append((time.perf_counter() - t1) * 1e3)
                launches = {k: fn.launches for k, fn in KERNELS.items()
                            if fn.launches}
                buckets = prep._prep._step.buckets
                pools = len({c.graph.pool() for c in caps.values()})
                prep.sync_scope()
                state = get_scope_arrays(scope, persist)
                peak = torch.cuda.max_memory_allocated()
                traced = step_kernels(torch, lambda: step(0), 1)
        else:
            def step(i):
                return exe.run(main, feed=batches[i], fetch_list=fetch,
                               scope=scope)
            for i in order:
                t1 = time.perf_counter()
                outs.append(step(i))
                step_ms.append((time.perf_counter() - t1) * 1e3)
            launches = {k: fn.launches for k, fn in KERNELS.items()
                        if fn.launches}
            state = get_scope_arrays(scope, persist)
            peak = torch.cuda.max_memory_allocated()
            traced = step_kernels(torch, lambda: step(0), 1)
        half = len(order) // 2
        runs[path] = {"losses": [float(o[0].ravel()[0]) for o in outs],
                      "outs": outs, "step_ms": step_ms,
                      "step_ms_p50": _pct(step_ms[half:], 0.5),
                      "seconds": time.perf_counter() - t0,
                      "buckets": buckets, "pools": pools,
                      "max_memory_allocated_bytes": peak,
                      "launches": launches, "state": state,
                      "device_ms_per_step": traced[0],
                      "device_idle_share": traced[1],
                      "device_launches_per_step": traced[2],
                      "costliest_kernels": traced[3]}
        del scope
    p, r = runs["prepared"], runs["run"]
    identical = all(np.array_equal(a, b) for x, y in zip(p["outs"], r["outs"])
                    for a, b in zip(x, y)) and all(
        np.array_equal(p["state"][n], r["state"][n]) for n in persist)
    failures = []
    if not identical:
        failures.append("prepared against run(): not bit for bit (losses "
                        "%r against %r)" % (p["losses"], r["losses"]))
    if not all(math.isfinite(x) for x in p["losses"]):
        failures.append("losses %r" % p["losses"])
    n_buckets = BOOK_BUCKETS[model]
    replays = len(order) // n_buckets      # the capture's step replays too
    if len(p["buckets"]) != n_buckets or any(
            v != {"captures": 1, "replays": replays}
            for v in p["buckets"].values()):
        failures.append("buckets %r" % p["buckets"])
    if p["pools"] != 1:
        failures.append("the buckets' graphs in %r pools" % p["pools"])
    if p["launches"] or r["launches"]:
        failures.append("a port kernel ran: %r" % [p["launches"],
                                                   r["launches"]])
    decode = None
    if extra:
        tags = np.concatenate([o[1].ravel() for o in p["outs"]])
        decode = {"tags": int(tags.size), "min": int(tags.min()),
                  "max": int(tags.max())}
        if tags.min() < 0 or tags.max() >= main.global_block().var(
                "crfw").shape[1]:
            failures.append("Viterbi tags out of range: %r" % decode)
    for v in runs.values():
        del v["state"], v["outs"]
    name = {"machine_translation": "train_mt",
            "recommender": "train_recommender",
            "label_semantic_roles": "train_srl"}[model]
    return {"phase": name, "model": model, "batch": BOOK_BATCH[model],
            "order": list(order), "buckets": n_buckets,
            "step_ms_p50": p["step_ms_p50"],
            "run_step_ms_p50": r["step_ms_p50"],
            "run_over_prepared": r["step_ms_p50"] / p["step_ms_p50"],
            "max_memory_allocated_bytes": p["max_memory_allocated_bytes"],
            "crf_decode": decode, "bit_identical_to_run": identical,
            "paths": runs, "launches": p["launches"],
            "failures": failures, "ok": not failures}


def book_oracle(torch, model):
    """Phases train_mt_oracle, train_recommender_oracle and
    train_srl_oracle: one f32 step of the model at its published widths
    on BOOK_ORACLE_BATCH of its adapter's rows, held by ``ulp_oracle``
    with one ulp added to every trainable parameter: each gradient (a
    sparse table's made dense) at twice the CPU's worst spread, never
    below LSTM_ORACLE_GRAD_FLOOR, the median at twice the median spread,
    the loss within RESNET_ORACLE_LOSS_RTOL; the SRL's Viterbi path
    equal to the CPU's; and a control past the bar, the CPU step from
    the parameters rounded to TF32 (``tf32_worst_fro_rel``)."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import set_scope_arrays

    main, startup, loss, slots, extra = build_book(fluid, model)
    _, arrays = start_arrays(fluid, main, startup, fluid.CPUPlace())
    torch.cuda.reset_peak_memory_stats()
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    fetch = [loss.name] + [p + "@GRAD" for p in params] + \
        [v.name for v in extra]
    rows = book_rows(model)[-1][:BOOK_ORACLE_BATCH]
    feed = fluid.DataFeeder(slots, program=main).feed(rows)
    got, want, _, held = ulp_oracle(fluid, main, arrays, feed, fetch,
                                    len(params), lambda k, v: k in params,
                                    fro_rel, LSTM_ORACLE_GRAD_FLOOR)
    host = fluid.Scope()
    set_scope_arrays(host, {k: tf32(v) if k in params else v
                            for k, v in arrays.items()}, "cpu")
    rounded = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    tf32_worst = max(fro_rel(dense_rows(a), b) for a, b in zip(
        rounded[1:1 + len(params)], want[1:1 + len(params)]))
    ok = held["ok"] and tf32_worst > held["grad_tolerance"]
    if extra:
        held["viterbi_equal"] = bool(np.array_equal(got[-1], want[-1]))
        ok = ok and held["viterbi_equal"]
    name = {"machine_translation": "train_mt_oracle",
            "recommender": "train_recommender_oracle",
            "label_semantic_roles": "train_srl_oracle"}[model]
    return {"phase": name, "batch": BOOK_ORACLE_BATCH, **held,
            "tf32_worst_fro_rel": tf32_worst,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "ok": ok}


def ctc_program(fluid):
    """x (ragged, CTC["features"]) -> fc to CTC["vocab"] -> warpctc
    against a ragged label (blank 0) -> mean, SGD; beside it
    ctc_greedy_decoder over dense logits p [T, vocab]."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name="x", shape=[CTC["features"]], lod_level=1,
                   dtype="float32")
        lab = L.data(name="lab", shape=[1], lod_level=1, dtype="int64")
        h = L.fc(x, size=CTC["vocab"])
        loss = L.mean(L.warpctc(h, lab, blank=0))
        fluid.optimizer.SGD(learning_rate=1e-3).minimize(loss)
        p = L.data(name="p", shape=[CTC["t"][1], CTC["vocab"]],
                   dtype="float32")
        dec = L.ctc_greedy_decoder(p, blank=0)
    return main, startup, loss, dec


def ctc_phase(torch):
    """Phase ctc: the warpctc loss and its gradient on the card against
    the CPU, one f32 step through ``ulp_oracle`` (16 sequences of 60-100
    frames of 128 features, fc to 32 symbols, labels of 10-30 symbols:
    each fc gradient at twice the CPU's one-ulp spread, never below
    LSTM_ORACLE_GRAD_FLOOR), and ctc_greedy_decoder over logits with
    tied maxima (integer-valued), its ids equal to the CPU's; its ms
    on the card through run()."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.fluid.io import set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss, dec = ctc_program(fluid)
    _, arrays = start_arrays(fluid, main, startup, fluid.CPUPlace())
    params = sorted(p.name for p in main.all_parameters())
    rng = np.random.RandomState(SEED + 140)
    t_lens = rng.randint(CTC["t"][0], CTC["t"][1] + 1, CTC["n"])
    l_lens = rng.randint(CTC["labels"][0], CTC["labels"][1] + 1, CTC["n"])
    xs = [rng.randn(t, CTC["features"]).astype(np.float32) for t in t_lens]
    labs = [rng.randint(1, CTC["vocab"], (n, 1)).astype(np.int64)
            for n in l_lens]
    logits = rng.randint(0, 4, (CTC["n"], CTC["t"][1], CTC["vocab"])
                         ).astype(np.float32)
    feed = {"x": LoDTensor.from_sequences(xs),
            "lab": LoDTensor.from_sequences(labs), "p": logits}
    fetch = [loss.name] + [p + "@GRAD" for p in params] + [dec.name]
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    got, want, _, held = ulp_oracle(fluid, main, arrays, feed, fetch,
                                    len(params), lambda k, v: k in params,
                                    fro_rel, LSTM_ORACLE_GRAD_FLOOR)
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    ids_equal = bool(np.array_equal(got[-1], want[-1]))
    scope = fluid.Scope()
    set_scope_arrays(scope, arrays, "cuda")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    ms = []
    for _ in range(4):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        exe.run(main, feed=feed, fetch_list=[loss.name], scope=scope)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    failures = []
    if not held["ok"]:
        failures.append("the card's warpctc step against the CPU's")
    if not ids_equal:
        failures.append("ctc_greedy_decoder's ids differ from the CPU's")
    if launches:
        failures.append("a port kernel ran: %r" % launches)
    return {"phase": "ctc", **CTC, "decoder_ids_equal": ids_equal,
            "run_step_ms_p50": _pct(ms[1:], 0.5),
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            **held,
            "failures": failures, "ok": not failures}


def build_decode(fluid, beam_size, n=1, max_len=4, vocab=5, end=0):
    """tests/test_beam_search.py's While-loop decode over a log-prob
    table (the machine_translation decode program's shape) for ``n``
    sentences: only beam 0 of each is live at t = 0."""
    import numpy as np

    L = fluid.layers
    nb = n * beam_size
    counter = L.fill_constant(shape=[1], dtype="int64", value=0)
    limit = L.fill_constant(shape=[1], dtype="int64", value=max_len)
    init_ids = L.fill_constant(shape=[nb, 1], dtype="int64", value=1)
    init_scores = L.assign(np.asarray(
        ([[0.0]] + [[-1e9]] * (beam_size - 1)) * n, np.float32))
    ids_arr = L.array_write(init_ids, i=counter, capacity=max_len + 1)
    sc_arr = L.array_write(init_scores, i=counter, capacity=max_len + 1)
    par_arr = L.array_write(L.assign(np.zeros((nb,), np.int32)),
                            i=counter, capacity=max_len + 1)
    cond = L.less_than(x=counter, y=limit)
    w = L.While(cond=cond)
    with w.block():
        pre_ids = L.array_read(ids_arr, i=counter)
        pre_scores = L.array_read(sc_arr, i=counter)
        logp = L.embedding(pre_ids, size=[vocab, vocab],
                           param_attr=fluid.ParamAttr(name="table"))
        logp = L.reshape(logp, [nb, vocab])
        accu = L.elementwise_add(x=logp, y=pre_scores)
        cand_scores, cand_ids = L.topk(accu, k=vocab - 1)
        sel_ids, sel_scores, parent = L.beam_search(
            pre_ids, pre_scores, cand_ids, cand_scores,
            beam_size=beam_size, end_id=end)
        L.increment(x=counter, value=1, in_place=True)
        L.array_write(sel_ids, i=counter, array=ids_arr)
        L.array_write(sel_scores, i=counter, array=sc_arr)
        L.array_write(parent, i=counter, array=par_arr)
        L.less_than(x=counter, y=limit, cond=cond)
    return L.beam_search_decode(ids_arr, sc_arr, par_arr, beam_size, end)


def garden_table():
    """tests/test_beam_search.py's table: greedy takes 1 -> 2 and then a
    weak continuation; 1 -> 3 -> end has the higher total."""
    import numpy as np

    t = np.full((5, 5), -1e9, np.float32)
    t[1, 2], t[1, 3] = np.log(0.6), np.log(0.4)
    t[2, 4], t[2, 0] = np.log(0.55), np.log(0.45)
    t[4, 0] = t[3, 0] = t[0, 0] = 0.0
    return t


def beam_decode_phase(torch):
    """Phase beam_decode: the While-loop decode through run() on the
    card against the CPU, ids bit for bit and scores within
    BEAM_SCORE_TOL: tests/test_beam_search.py's garden-path table at
    beam 1 and 2 (beam 2 finds 1 -> 3 -> end, greedy 1 -> 2 -> 4 ->
    end), and a random log-prob table of BEAM["vocab"] words at
    BEAM["sentences"] sentences of BEAM["beam"] beams over
    BEAM["steps"] steps, where the -1e9 scores of the beams not yet live
    tie and the selection's tie rule decides; its ms on the card;
    prepare() refuses the program (a while reads its condition on the
    host) as Uncapturable."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.executor_impl import Uncapturable
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    rng = np.random.RandomState(SEED + 150)
    p = rng.uniform(0.05, 1.0, (BEAM["vocab"], BEAM["vocab"]))
    cases = {"greedy_garden": (1, 1, 4, 5, garden_table()),
             "beam2_garden": (2, 1, 4, 5, garden_table()),
             "random": (BEAM["beam"], BEAM["sentences"], BEAM["steps"],
                        BEAM["vocab"], np.log(p / p.sum(1, keepdims=True))
                        .astype(np.float32))}
    results, failures = {}, []
    reset_launches()
    torch.cuda.reset_peak_memory_stats()
    for name, (beam, n, steps, vocab, table) in cases.items():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            ids, scores = build_decode(fluid, beam, n, steps, vocab)
        out, ms = {}, []
        for dev, place in (("cuda", fluid.CUDAPlace(0)),
                           ("cpu", fluid.CPUPlace())):
            scope = fluid.Scope()
            exe = fluid.Executor(place)
            exe.run(startup, scope=scope)
            scope.set("table", torch.from_numpy(table).to(
                "cuda" if dev == "cuda" else "cpu"))
            reps = 3 if dev == "cuda" else 1
            for _ in range(reps):
                if dev == "cuda":
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                out[dev] = exe.run(main, fetch_list=[ids, scores],
                                   scope=scope)
                if dev == "cuda":
                    torch.cuda.synchronize()
                    ms.append((time.perf_counter() - t0) * 1e3)
            if dev == "cuda":
                try:
                    exe.prepare(main, feed_specs={}, fetch_list=[ids],
                                scope=scope)
                    refused = False
                except Uncapturable:
                    refused = True
        ids_equal = bool(np.array_equal(out["cuda"][0], out["cpu"][0]))
        score_err = float(np.abs(out["cuda"][1].astype(np.float64)
                                 - out["cpu"][1]).max())
        results[name] = {"beam": beam, "sentences": n, "steps": steps,
                         "vocab": vocab, "ids_equal": ids_equal,
                         "max_abs_score_err": score_err,
                         "run_ms_p50": _pct(ms[1:], 0.5),
                         "prepare_refused": refused,
                         "best": out["cuda"][0][0, 0].tolist()[:6]}
        if not (ids_equal and score_err <= BEAM_SCORE_TOL and refused):
            failures.append("%s: %r" % (name, results[name]))
    garden = (results["greedy_garden"]["best"][:4] == [1, 2, 4, 0]
              and results["beam2_garden"]["best"][:3] == [1, 3, 0])
    if not garden:
        failures.append("the garden path's beams")
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    if launches:
        failures.append("a port kernel ran: %r" % launches)
    return {"phase": "beam_decode", "score_tol": BEAM_SCORE_TOL,
            "cases": results,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "failures": failures, "ok": not failures}


def slice26_phases(torch):
    """Slice 26's phases in order, as (name, zero-argument callable)."""
    return [("train_mt", lambda: train_book(torch, "machine_translation")),
            ("train_mt_oracle",
             lambda: book_oracle(torch, "machine_translation")),
            ("train_recommender", lambda: train_book(torch, "recommender")),
            ("train_recommender_oracle",
             lambda: book_oracle(torch, "recommender")),
            ("train_srl",
             lambda: train_book(torch, "label_semantic_roles")),
            ("train_srl_oracle",
             lambda: book_oracle(torch, "label_semantic_roles")),
            ("ctc", lambda: ctc_phase(torch)),
            ("beam_decode", lambda: beam_decode_phase(torch))]


# ---------------------------------------------------------------------------
# slice 27: the conv family, the detection / misc / metric ops and
# MobileNet-SSD (no TPU kernel on the path)
# ---------------------------------------------------------------------------

# PaddlePaddle/models fluid/object_detection/mobilenet_ssd.py (Fluid era):
# MobileNet-v1's published widths, SSD heads on PASCAL VOC's 21 classes
SSD_IMAGE = 300
SSD_CLASSES = 21
SSD_MAX_GT = 8          # gt boxes an image: 1-8, a ragged feed
SSD_LR = 0.001


def _ssd_conv_bn(fluid, x, filter_size, num_filters, stride, padding,
                 num_groups=1, act="relu"):
    """mobilenet_ssd.py's conv_bn: conv (no bias; MSRA, learning rate
    0.1) and batch norm."""
    attr = fluid.ParamAttr(learning_rate=0.1,
                           initializer=fluid.initializer.MSRA())
    conv = fluid.layers.conv2d(
        input=x, num_filters=num_filters, filter_size=filter_size,
        stride=stride, padding=padding, groups=num_groups, act=None,
        param_attr=attr, bias_attr=False)
    return fluid.layers.batch_norm(input=conv, act=act)


def _ssd_separable(fluid, x, nf1, nf2, groups, stride, scale):
    """A depthwise 3x3 (conv2d with groups = C, as the published model
    writes it) and a pointwise 1x1, each conv-BN-relu."""
    dw = _ssd_conv_bn(fluid, x, 3, int(nf1 * scale), stride, 1,
                      int(groups * scale))
    return _ssd_conv_bn(fluid, dw, 1, int(nf2 * scale), 1, 0)


def _ssd_extra(fluid, x, nf1, nf2, groups, stride, scale):
    pw = _ssd_conv_bn(fluid, x, 1, int(nf1 * scale), 1, 0,
                      int(groups * scale))
    return _ssd_conv_bn(fluid, pw, 3, int(nf2 * scale), stride, 1,
                        int(groups * scale))


def build_mobilenet_ssd(fluid, image=SSD_IMAGE, scale=1.0,
                        num_classes=SSD_CLASSES, detect=False):
    """MobileNet-SSD (mobilenet_ssd.py's mobile_net and its train /
    infer programs) from the layers both packages have.  Feeds: "image"
    [N, 3, image, image], "gt_box" [N, G, 4] and "gt_label" [N, G, 1]
    ragged (lod_level 1).  Returns (loss, feed names, extra fetches):
    the mean ssd_loss under Adam; with ``detect`` no optimizer and the
    extra fetches the decoded boxes, the softmax scores transposed to
    [N, C, M], detection_output's rows and detection_map's mAP."""
    layers = fluid.layers
    img = layers.data(name="image", shape=[3, image, image],
                      dtype="float32")
    gt_box = layers.data(name="gt_box", shape=[4], dtype="float32",
                         lod_level=1)
    gt_label = layers.data(name="gt_label", shape=[1], dtype="int64",
                           lod_level=1)
    # 300 -> 150 -> 75 -> 38 -> 19
    t = _ssd_conv_bn(fluid, img, 3, int(32 * scale), 2, 1)
    t = _ssd_separable(fluid, t, 32, 64, 32, 1, scale)
    t = _ssd_separable(fluid, t, 64, 128, 64, 2, scale)
    t = _ssd_separable(fluid, t, 128, 128, 128, 1, scale)
    t = _ssd_separable(fluid, t, 128, 256, 128, 2, scale)
    t = _ssd_separable(fluid, t, 256, 256, 256, 1, scale)
    t = _ssd_separable(fluid, t, 256, 512, 256, 2, scale)
    for _ in range(5):
        t = _ssd_separable(fluid, t, 512, 512, 512, 1, scale)
    module11 = t                                         # 19 x 19 x 512
    t = _ssd_separable(fluid, t, 512, 1024, 512, 2, scale)
    module13 = _ssd_separable(fluid, t, 1024, 1024, 1024, 1, scale)
    module14 = _ssd_extra(fluid, module13, 256, 512, 1, 2, scale)   # 5
    module15 = _ssd_extra(fluid, module14, 128, 256, 1, 2, scale)   # 3
    module16 = _ssd_extra(fluid, module15, 128, 256, 1, 2, scale)   # 2
    module17 = _ssd_extra(fluid, module16, 64, 128, 1, 2, scale)    # 1
    locs, confs, box, box_var = layers.detection.multi_box_head(
        inputs=[module11, module13, module14, module15, module16,
                module17],
        image=img, num_classes=num_classes, min_ratio=20, max_ratio=90,
        aspect_ratios=[[2.0], [2.0, 3.0], [2.0, 3.0], [2.0, 3.0],
                       [2.0, 3.0], [2.0, 3.0]],
        base_size=image, offset=0.5, flip=True)
    feeds = ["image", "gt_box", "gt_label"]
    if detect:
        scores = layers.softmax(confs)
        decoded = layers.detection.box_coder(box, box_var, locs,
                                             "decode_center_size")
        scores_t = layers.transpose(scores, perm=[0, 2, 1])
        nmsed = layers.detection.multiclass_nms(decoded, scores_t)
        label = layers.concat(
            [layers.cast(gt_label, "float32"), gt_box], axis=2)
        m = layers.detection.detection_map(nmsed, label, num_classes)
        return None, feeds, [decoded, scores_t, nmsed, m]
    loss = layers.mean(layers.detection.ssd_loss(locs, confs, gt_box,
                                                 gt_label, box, box_var))
    fluid.optimizer.Adam(learning_rate=SSD_LR).minimize(loss)
    return loss, feeds, []


def ssd_batch(n, image=SSD_IMAGE, num_classes=SSD_CLASSES,
              max_gt=SSD_MAX_GT, seed=SEED):
    """A synthetic VOC-like batch from ``seed``: images uniform in
    [0, 1), 1-``max_gt`` boxes an image (corners sorted in [0, 1], at
    least 0.05 wide and high), labels 1 .. num_classes - 1.  Returns
    (image [n, 3, image, image], [boxes [g, 4]] and [labels [g, 1]]
    per image)."""
    import numpy as np

    rng = np.random.RandomState(seed)
    imgs = rng.uniform(0, 1, (n, 3, image, image)).astype(np.float32)
    boxes, labels = [], []
    for _ in range(n):
        g = int(rng.randint(1, max_gt + 1))
        lo = rng.uniform(0, 0.7, (g, 2))
        wh = rng.uniform(0.05, 0.3, (g, 2))
        boxes.append(np.concatenate([lo, np.minimum(lo + wh, 1.0)],
                                    1).astype(np.float32))
        labels.append(rng.randint(1, num_classes, (g, 1)).astype(np.int64))
    return imgs, boxes, labels


def ssd_feed(lod_tensor_cls, imgs, boxes, labels):
    """The feed dict of ``ssd_batch``'s arrays for a package's
    LoDTensor class."""
    return {"image": imgs,
            "gt_box": lod_tensor_cls.from_sequences(boxes),
            "gt_label": lod_tensor_cls.from_sequences(labels)}


SSD_BATCH = 32
SSD_ORDER = (0, 1, 0, 1, 0, 1)
SSD_BOXES = (8, 16)     # gt boxes an image at most: padded buckets 8, 16
SSD_ORACLE_BATCH = 4
# the CPU's own one-ulp spread of MobileNet-SSD's gradients reaches 0.10 -
# 0.14 at batch 4 - 16 (the first batch norm's scale: a sum over 32 x
# 150 x 150 products that nearly cancels), past RESNET_ORACLE_SPREAD_MAX
SSD_ORACLE_SPREAD_MAX = 0.25
SSD_DETECT_BATCH = 8
SLICE27_TIMEOUT_S = 600
# kernel families of a traced SSD replay, by a substring of the symbol
KERNEL_FAMILIES = (("conv", ("conv", "cudnn", "xmma", "implicit", "dgrad",
                             "wgrad", "winograd", "fft")),
                   ("gemm", ("gemm", "cutlass")),
                   ("sort", ("sort", "radix")),
                   ("reduce", ("reduce", "Reduce")),
                   ("index", ("index", "gather", "scatter", "Index")),
                   ("memcpy / memset", ("Memcpy", "Memset", "memcpy",
                                        "memset")),
                   ("elementwise", ("elementwise", "vectorized",
                                    "unrolled", "Elementwise")))


def kernel_families(kernels):
    """``profile_train.device_kernels`` summed by KERNEL_FAMILIES (the
    first family whose substring a symbol holds; "other" else)."""
    out = {}
    for name, k in kernels.items():
        fam = next((f for f, keys in KERNEL_FAMILIES
                    if any(key in name for key in keys)), "other")
        d = out.setdefault(fam, {"ms_per_step": 0.0, "calls_per_step": 0.0})
        d["ms_per_step"] += k["ms_per_step"]
        d["calls_per_step"] += k["calls_per_step"]
    return out


_SSD_PROGRAMS = {}


def ssd_program(fluid, detect=False):
    """(main, startup, loss, extra fetches) of MobileNet-SSD at its
    published widths, built once a process; ``detect``: the test clone
    of the detection program (batch norm on its running statistics)."""
    if detect not in _SSD_PROGRAMS:
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            loss, _, extra = build_mobilenet_ssd(fluid, detect=detect)
        if detect:
            main = main.clone(for_test=True)
        _SSD_PROGRAMS[detect] = (main, startup, loss, extra)
    return _SSD_PROGRAMS[detect]


def train_ssd(torch):
    """Phase train_ssd: MobileNet-SSD (300 x 300, 21 classes, Adam) at
    batch SSD_BATCH on two synthetic batches whose ragged gt (1-8 and
    1-16 boxes an image) pad to two buckets, stepped SSD_ORDER through
    the prepared step (one graph a bucket, one pool) and through run()
    from the same start, both on cuDNN's deterministic algorithms
    (FLAGS_cudnn_deterministic: its default weight gradients add with
    atomics): every loss and persistable bit for bit, each bucket
    captured once, the loss falling on the repeated batch; step ms p50
    of both paths, each bucket's first (capture) step s, peak memory
    allocated and reserved, one traced replay's device ms, idle share,
    kernels and their families; beside them the prepared step's ms on
    cuDNN's default algorithms (``default_cudnn_step_ms_p50``); no
    kernel of the port runs (no TPU kernel on the path)."""
    from paddle_tpu_torch.core.flags import FLAGS

    prev = FLAGS.cudnn_deterministic
    try:
        FLAGS.cudnn_deterministic = False
        default_ms = _ssd_default_ms(torch)
        FLAGS.cudnn_deterministic = True
        out = _train_ssd(torch)
    finally:
        FLAGS.cudnn_deterministic = prev
    out["default_cudnn_step_ms_p50"] = default_ms
    return out


def _ssd_default_ms(torch):
    """ms p50 of 3 replays of the prepared SSD step on batch 0 (after its
    capture) on cuDNN's default algorithms."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.fluid.io import set_scope_arrays

    main, startup, loss, _ = ssd_program(fluid)
    _, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
    feed = ssd_feed(LoDTensor, *ssd_batch(SSD_BATCH, max_gt=SSD_BOXES[0],
                                          seed=SEED))
    scope = fluid.Scope()
    set_scope_arrays(scope, init, "cuda")
    ms = []
    with fluid.Executor(fluid.CUDAPlace(0)).prepare(
            main, feed_specs=feed, fetch_list=[loss], scope=scope) as prep:
        for _ in range(4):
            t0 = time.perf_counter()
            prep.run_prepared(feed, return_numpy=True)
            ms.append((time.perf_counter() - t0) * 1e3)
    del scope
    torch.cuda.empty_cache()
    return _pct(ms[1:], 0.5)


def _train_ssd(torch):
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss, _ = ssd_program(fluid)
    persist, init = start_arrays(fluid, main, startup, fluid.CPUPlace())
    batches = [ssd_feed(LoDTensor, *ssd_batch(SSD_BATCH, max_gt=g,
                                              seed=SEED + k))
               for k, g in enumerate(SSD_BOXES)]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    runs = {}
    for path in ("prepared", "run"):
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        outs, step_ms = [], []
        t0 = time.perf_counter()
        if path == "prepared":
            with exe.prepare(main, feed_specs=batches[0], fetch_list=[loss],
                             scope=scope) as prep:
                caps = prep._prep._step._captures

                def step(i):
                    return prep.run_prepared(batches[i], return_numpy=True)
                for i in SSD_ORDER:
                    t1 = time.perf_counter()
                    outs.append(step(i))
                    step_ms.append((time.perf_counter() - t1) * 1e3)
                launches = {k: fn.launches for k, fn in KERNELS.items()
                            if fn.launches}
                buckets = prep._prep._step.buckets
                pools = len({c.graph.pool() for c in caps.values()})
                prep.sync_scope()
                state = get_scope_arrays(scope, persist)
                peak = torch.cuda.max_memory_allocated()
                reserved = torch.cuda.max_memory_reserved()
                traced = step_kernels(torch, lambda: step(0), 1,
                                      families=True)
        else:
            def step(i):
                return exe.run(main, feed=batches[i], fetch_list=[loss],
                               scope=scope)
            for i in SSD_ORDER:
                t1 = time.perf_counter()
                outs.append(step(i))
                step_ms.append((time.perf_counter() - t1) * 1e3)
            launches = {k: fn.launches for k, fn in KERNELS.items()
                        if fn.launches}
            buckets = pools = None
            state = get_scope_arrays(scope, persist)
            peak = torch.cuda.max_memory_allocated()
            reserved = torch.cuda.max_memory_reserved()
            traced = step_kernels(torch, lambda: step(0), 1,
                                  families=True)
        half = len(SSD_ORDER) // 2
        runs[path] = {"losses": [float(o[0].ravel()[0]) for o in outs],
                      "outs": outs, "step_ms": step_ms,
                      "step_ms_p50": _pct(step_ms[half:], 0.5),
                      "first_step_s": [step_ms[0] / 1e3, step_ms[1] / 1e3],
                      "seconds": time.perf_counter() - t0,
                      "buckets": buckets, "pools": pools,
                      "max_memory_allocated_bytes": peak,
                      "max_memory_reserved_bytes": reserved,
                      "launches": launches, "state": state,
                      "device_ms_per_step": traced[0],
                      "device_idle_share": traced[1],
                      "device_launches_per_step": traced[2],
                      "kernel_families": traced[3]}
        del scope
    p, r = runs["prepared"], runs["run"]
    identical = all(np.array_equal(a, b) for x, y in zip(p["outs"], r["outs"])
                    for a, b in zip(x, y)) and all(
        np.array_equal(p["state"][n], r["state"][n]) for n in persist)
    failures = []
    if not identical:
        failures.append("prepared against run(): not bit for bit (losses "
                        "%r against %r)" % (p["losses"], r["losses"]))
    losses = p["losses"]
    if not all(math.isfinite(x) for x in losses):
        failures.append("losses %r" % losses)
    elif not losses[-2] < losses[0]:
        failures.append("the loss of batch 0 did not fall: %r" % losses)
    replays = len(SSD_ORDER) // 2
    if len(p["buckets"]) != 2 or any(
            v != {"captures": 1, "replays": replays}
            for v in p["buckets"].values()):
        failures.append("buckets %r" % p["buckets"])
    if p["pools"] != 1:
        failures.append("the buckets' graphs in %r pools" % p["pools"])
    if p["launches"] or r["launches"]:
        failures.append("a port kernel ran: %r" % [p["launches"],
                                                   r["launches"]])
    for v in runs.values():
        del v["state"], v["outs"]
    n_priors = int(main.global_block().var(
        [op for op in main.global_block().ops
         if op.type == "iou_similarity"][0].input("Y")[0]).shape[0])
    return {"phase": "train_ssd", "batch": SSD_BATCH, "image": SSD_IMAGE,
            "classes": SSD_CLASSES, "priors": n_priors,
            "gt_buckets": list(SSD_BOXES), "order": list(SSD_ORDER),
            "cudnn_deterministic": True, "step_ms_p50": p["step_ms_p50"],
            "run_step_ms_p50": r["step_ms_p50"],
            "images_per_s": SSD_BATCH * 1e3 / p["step_ms_p50"],
            "run_over_prepared": r["step_ms_p50"] / p["step_ms_p50"],
            "capture_s": p["first_step_s"],
            "max_memory_allocated_bytes": p["max_memory_allocated_bytes"],
            "max_memory_reserved_bytes": p["max_memory_reserved_bytes"],
            "bit_identical_to_run": identical, "paths": runs,
            "launches": p["launches"], "failures": failures,
            "ok": not failures}


def ssd_oracle(torch):
    """Phase train_ssd_oracle: one f32 step of MobileNet-SSD at its
    published widths on SSD_ORACLE_BATCH synthetic images (1-8 gt
    boxes), held by ``ulp_oracle`` with one ulp added to every trainable
    parameter: each gradient at twice the CPU's worst spread, never
    below LSTM_ORACLE_GRAD_FLOOR, the median at twice the median spread,
    the loss within RESNET_ORACLE_LOSS_RTOL, the CPU's worst spread at
    most SSD_ORACLE_SPREAD_MAX; and a control past the bar, the CPU step
    from the parameters rounded to TF32 (``tf32_worst_fro_rel``)."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.fluid.io import set_scope_arrays

    main, startup, loss, _ = ssd_program(fluid)
    _, arrays = start_arrays(fluid, main, startup, fluid.CPUPlace())
    torch.cuda.reset_peak_memory_stats()
    params = sorted(p.name for p in main.all_parameters() if p.trainable)
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    feed = ssd_feed(LoDTensor, *ssd_batch(SSD_ORACLE_BATCH,
                                          seed=SEED + 7))
    t0 = time.perf_counter()
    _, want, _, held = ulp_oracle(fluid, main, arrays, feed, fetch,
                                  len(params), lambda k, v: k in params,
                                  fro_rel, LSTM_ORACLE_GRAD_FLOOR,
                                  spread_max=SSD_ORACLE_SPREAD_MAX)
    oracle_s = time.perf_counter() - t0
    host = fluid.Scope()
    set_scope_arrays(host, {k: tf32(v) if k in params else v
                            for k, v in arrays.items()}, "cpu")
    rounded = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    tf32_worst = max(fro_rel(a, b) for a, b in zip(
        rounded[1:1 + len(params)], want[1:1 + len(params)]))
    return {"phase": "train_ssd_oracle", "batch": SSD_ORACLE_BATCH, **held,
            "oracle_s": oracle_s, "tf32_worst_fro_rel": tf32_worst,
            "max_memory_allocated_bytes": torch.cuda.max_memory_allocated(),
            "ok": held["ok"] and tf32_worst > held["grad_tolerance"]}


def ssd_host_tail(fluid, place, decoded, scores, boxes, labels):
    """The port's host ops alone on ``place``: multiclass_nms (the
    detection_output defaults) over ``decoded`` [N, M, 4] and ``scores``
    [N, C, M], then detection_map against the ragged gt.  Returns the
    rows, their per-image counts and the mAP."""
    import numpy as np

    from paddle_tpu_torch.core.lod import LoDTensor

    main, startup = fluid.Program(), fluid.Program()
    n, m, _ = decoded.shape
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        bb = fluid.layers.data(name="bb", shape=[m, 4], dtype="float32")
        sc = fluid.layers.data(name="sc", shape=[SSD_CLASSES, m],
                               dtype="float32")
        lab = fluid.layers.data(name="lab", shape=[5], dtype="float32",
                                lod_level=1)
        rows = fluid.layers.detection.multiclass_nms(bb, sc)
        m_ap = fluid.layers.detection.detection_map(rows, lab, SSD_CLASSES)
    label = LoDTensor.from_sequences([
        np.concatenate([lb.astype(np.float32), bx], 1)
        for bx, lb in zip(boxes, labels)])
    return fluid.Executor(place).run(
        main, feed={"bb": decoded, "sc": scores, "lab": label},
        fetch_list=[rows, rows.name + "@ROWS", m_ap], scope=fluid.Scope())


def detect_ssd(torch):
    """Phase detect_ssd: MobileNet-SSD's detection program (the test
    clone: softmax, box_coder decode, multiclass_nms, detection_map) at
    SSD_DETECT_BATCH through run() on the card (prepare() refuses the
    host tail), from the startup parameters: the NMS rows, their
    per-image counts and the mAP equal bit for bit what the port's host
    ops give on the CPU for the decoded boxes and scores the card
    fetched, on the synthetic gt (mAP 0 for a random head) and on a gt
    of each image's first 3 detections (mAP above 0); the NMS's host ms
    on those arrays."""
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.fluid.io import set_scope_arrays
    from paddle_tpu_torch.ops.detection import multiclass_nms_rows

    main, startup, _, extra = ssd_program(fluid, detect=True)
    _, arrays = start_arrays(fluid, main, startup, fluid.CPUPlace())
    imgs, boxes, labels = ssd_batch(SSD_DETECT_BATCH, seed=SEED + 9)
    feed = ssd_feed(LoDTensor, imgs, boxes, labels)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    set_scope_arrays(scope, arrays, "cuda")
    decoded, scores, rows, m_ap = extra
    fetch = [decoded, scores, rows, rows.name + "@ROWS", m_ap]
    failures = []
    try:
        exe.prepare(main, feed_specs=feed, fetch_list=fetch, scope=scope)
        failures.append("prepare() took the host tail")
    except ValueError:
        pass
    t0 = time.perf_counter()
    got = exe.run(main, feed=feed, fetch_list=fetch, scope=scope)
    run_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    multiclass_nms_rows(got[0], got[1], {})
    nms_ms = (time.perf_counter() - t0) * 1e3
    # a second batch whose gt are each image's first 3 detections, so
    # that its mAP is not 0 as the random gt's is
    offs = np.concatenate([[0], np.cumsum(got[3])])
    top = [got[2][offs[i]:offs[i] + 3] for i in range(SSD_DETECT_BATCH)]
    gt2 = ([r[:, 2:].copy() for r in top],
           [r[:, :1].astype(np.int64) for r in top])
    got2 = exe.run(main, feed=ssd_feed(LoDTensor, imgs, *gt2),
                   fetch_list=fetch, scope=scope)
    equal = []
    for out, (bx, lb) in ((got, (boxes, labels)), (got2, gt2)):
        want = ssd_host_tail(fluid, fluid.CPUPlace(), out[0], out[1], bx,
                             lb)
        equal += [bool(np.array_equal(a, b)) for a, b in zip(out[2:], want)]
        counts = out[3].tolist()
        if sum(counts) != out[2].shape[0] or \
                not 0.0 <= float(out[4][0]) <= 1.0:
            failures.append("counts %r, mAP %r" % (counts, out[4]))
    if not all(equal):
        failures.append("rows / counts / mAP against the CPU's host ops: "
                        "%r" % equal)
    if not float(got2[4][0]) > 0.0:
        failures.append("the mAP against the card's own detections is "
                        "%r" % got2[4])
    return {"phase": "detect_ssd", "batch": SSD_DETECT_BATCH,
            "run_ms": run_ms, "nms_host_ms": nms_ms,
            "detections": int(got[2].shape[0]),
            "per_image": got[3].tolist(), "map": float(got[4][0]),
            "map_own_detections": float(got2[4][0]),
            "equal_to_cpu_host_ops": equal,
            "failures": failures, "ok": not failures}


# the conv family and the device ops of ops/misc.py once at a realistic
# shape each: (name, op, inputs {slot: (shape, "f32" | index maker)},
# attrs, the float slots differentiated)
def _roi_boxes(np, rng, n, r, h, w, scale):
    """``r`` Fast R-CNN proposals over ``n`` images of an h x w map at
    ``scale``: [batch_idx, x1, y1, x2, y2] in image coordinates."""
    x1 = rng.uniform(0, w / scale * 0.7, r)
    y1 = rng.uniform(0, h / scale * 0.7, r)
    bw = rng.uniform(16, w / scale * 0.3, r)
    bh = rng.uniform(16, h / scale * 0.3, r)
    return np.stack([rng.randint(0, n, r), x1, y1, x1 + bw, y1 + bh],
                    1).astype(np.float32)


CONV_FAMILY = (
    # FCN-8s / DCGAN: a 4 x 4 stride-2 upsample, 256 -> 128 channels
    ("conv2d_transpose", {"Input": (32, 256, 28, 28),
                          "Filter": (256, 128, 4, 4)},
     {"strides": [2, 2], "paddings": [1, 1], "dilations": [1, 1]}),
    # C3D conv2a: 3 x 3 x 3, 64 -> 128 channels over 16 frames of 56 x 56
    ("conv3d", {"Input": (8, 64, 16, 56, 56), "Filter": (128, 64, 3, 3, 3)},
     {"strides": [1, 1, 1], "paddings": [1, 1, 1], "dilations": [1, 1, 1],
      "groups": 1}),
    # MobileNet-v1's 3 x 3 depthwise at 19 x 19 x 512 (MobileNet-SSD's
    # module11 stages)
    ("depthwise_conv2d", {"Input": (32, 512, 19, 19),
                          "Filter": (512, 1, 3, 3)},
     {"strides": [1, 1], "paddings": [1, 1], "dilations": [1, 1],
      "groups": 512}),
    # DeepSpeech2's lookahead row convolution: 20 future steps over 300
    # frames of a 1024-wide layer
    ("row_conv", {"X": (32, 300, 1024), "Filter": (21, 1024)}, {}),
    # SPP-net over AlexNet's conv5 (13 x 13 x 256), a 3-level pyramid
    ("spp", {"X": (32, 256, 13, 13)},
     {"pyramid_height": 3, "pooling_type": "max"}),
    # Fast R-CNN: 7 x 7 bins over VGG16's conv5 of two ~600 x 800 images
    # (38 x 50 x 512, spatial scale 1/16), 128 proposals
    ("roi_pool", {"X": (2, 512, 38, 50), "ROIs": "rois"},
     {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 0.0625}),
    # SegNet's encoder pool1 (2 x 2, stride 2) over VGG16's conv1 at
    # 224 x 224
    ("max_pool2d_with_index", {"X": (8, 64, 224, 224)},
     {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}),
    # SegNet's decoder unpool of that pooling, its indices
    ("unpool", {"X": (8, 64, 112, 112), "Indices": "mask"},
     {"ksize": [2, 2], "strides": [2, 2], "paddings": [0, 0]}),
    # a Neural Turing Machine's shift: 3-tap weights over 128 memory rows,
    # 64 heads x batch
    ("conv_shift", {"X": (64, 128), "Y": (64, 3)}, {}),
)


def family_arrays(np, op, slots, attrs, seed):
    """The inputs of one CONV_FAMILY case from ``seed``."""
    rng = np.random.RandomState(seed)
    out = {}
    for slot, spec in slots.items():
        if spec == "rois":
            n, _, h, w = slots["X"]
            out[slot] = _roi_boxes(np, rng, n, 128, h, w,
                                   attrs["spatial_scale"])
        elif spec == "mask":
            # the pool1 indices of a map of 2x the unpool's input
            n, c, oh, ow = slots["X"]
            dy, dx = rng.randint(0, 2, (2, n, c, oh, ow))
            rows = np.arange(oh)[:, None] * 2 + dy
            cols = np.arange(ow)[None, :] * 2 + dx
            out[slot] = (rows * (2 * ow) + cols).astype(np.int32)
        else:
            out[slot] = rng.randn(*spec).astype(np.float32)
    return out


def family_call(torch, op, arrays, attrs, device):
    """One CONV_FAMILY op forward and backward on ``device``: a call
    returning [the float output, its integer companion (Mask, Argmax)
    where the op has one, the gradients of the float inputs].  The
    convs' gradients through their explicit grad lowering
    (``<op>_grad``); the rest through autograd over the forward."""
    import numpy as np

    import paddle_tpu_torch.ops  # noqa: F401  (registers the ops)
    from paddle_tpu_torch.core.desc import OpDesc, ProgramDesc
    from paddle_tpu_torch.core.lowering import Ins, LoweringContext
    from paddle_tpu_torch.core.registry import get_op_info

    ctx = LoweringContext(ProgramDesc(), 0, {}, torch.device(device))
    ins = {k: torch.as_tensor(v, device=device) for k, v in arrays.items()}
    floats = [k for k, v in ins.items() if v.is_floating_point()
              and not (op == "roi_pool" and k == "ROIs")]
    fwd = get_op_info(op).lower
    explicit = get_op_info(op).grad_lower is not None
    cots = []       # the output's cotangent: one seeded array, any device

    def call():
        leaves = {k: v.detach().requires_grad_(k in floats)
                  for k, v in ins.items()}
        with torch.enable_grad():
            outs = fwd(ctx, Ins({k: [v] for k, v in leaves.items()}),
                       dict(attrs), None)
            out = outs.get("Out", outs.get("Output"))
            if not cots:
                cots.append(torch.from_numpy(np.random.RandomState(3).randn(
                    *out.shape).astype(np.float32)).to(device))
            cot = cots[0]
            if explicit:
                gop = OpDesc(op + "_grad", inputs={
                    "Input": ["x"], "Filter": ["w"], "Output@GRAD": ["dy"]},
                    outputs={"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"]},
                    attrs=dict(attrs))
                g = get_op_info(op + "_grad").lower(ctx, Ins({
                    "Input": [ins["Input"]], "Filter": [ins["Filter"]],
                    "Output@GRAD": [cot]}), dict(attrs), gop)
                grads = [g["Input@GRAD"], g["Filter@GRAD"]]
            else:
                grads = list(torch.autograd.grad(
                    out, [leaves[k] for k in floats], cot))
        ints = [v for k, v in outs.items() if k in ("Mask", "Argmax")]
        return [out.detach()] + ints + [g.detach() for g in grads]

    return call


def conv_family(torch):
    """Phase conv_family: each CONV_FAMILY op at its realistic shape,
    forward and gradients on the card against the CPU (each tensor
    scaled by its largest |CPU value|, within ATOL + RTOL of it; Mask and
    Argmax outputs exact), with the card's ms a call (forward and
    backward, CUDA events, median of 3 after a warm-up)."""
    import numpy as np

    rows, failures = {}, []
    for op, slots, attrs in CONV_FAMILY:
        arrays = family_arrays(np, op, slots, attrs, seed=SEED + 27)
        card = family_call(torch, op, arrays, attrs, "cuda")
        got = [t.cpu() for t in card()]
        torch.cuda.synchronize()
        times = []
        for _ in range(4):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            card()
            end.record()
            torch.cuda.synchronize()
            times.append(start.elapsed_time(end))
        want = family_call(torch, op, arrays, attrs, "cpu")()
        errs, ok = [], True
        for a, b in zip(got, want):
            if not b.is_floating_point():
                good = bool(torch.equal(a, b))
                errs.append(0 if good else int((a != b).sum()))
                ok = ok and good
                continue
            s = max(float(b.abs().max()), 1e-30)
            err, good = compare(torch, a / s, b / s)
            errs.append(err)
            ok = ok and good
        rows[op] = {"shapes": {k: list(v.shape) for k, v in arrays.items()},
                    "ms": _pct(times[1:], 0.5), "scaled_max_err": errs,
                    "ok": ok}
        if not ok:
            failures.append("%s: %r" % (op, errs))
        del card, got, want
        torch.cuda.empty_cache()
    return {"phase": "conv_family", "atol": ATOL, "rtol": RTOL,
            "ops": rows, "failures": failures, "ok": not failures}


def slice27_phases(torch):
    """Slice 27's phases in order, as (name, zero-argument callable)."""
    return [("train_ssd", lambda: train_ssd(torch)),
            ("train_ssd_oracle", lambda: ssd_oracle(torch)),
            ("detect_ssd", lambda: detect_ssd(torch)),
            ("conv_family", lambda: conv_family(torch))]


# slice 28: the data pipeline (recordio, the reader ops, DeviceLoader /
# DeviceDatasetCache) with ResNet-50 trained from a recordio file
SLICE28_TIMEOUT_S = 600
READER_BATCH = 256
READER_IMAGES = 1536        # 6 batches an epoch at READER_BATCH: a
#                             warm-up, 3 timed, TRACED_REPLAYS traced
READER_SHUFFLE = 512        # the shuffle reader's buffer
READER_EPOCH_STEPS = READER_IMAGES // READER_BATCH
READER_AFTER_RESET = 1      # steps after the EOF and the reset
BENCH_REAL_ITERS = 10
BENCH_REAL_IMAGES = 1024    # flowers' synthetic train set, all written
IMAGE = (3, 224, 224)


class cudnn_deterministic:
    """FLAGS.cudnn_deterministic set for the block, then restored."""

    def __init__(self, on):
        self.on = on

    def __enter__(self):
        from paddle_tpu_torch.core.flags import FLAGS

        self.prev, FLAGS.cudnn_deterministic = \
            FLAGS.cudnn_deterministic, self.on

    def __exit__(self, *exc):
        from paddle_tpu_torch.core.flags import FLAGS

        FLAGS.cudnn_deterministic = self.prev


def reader_samples(n, seed, shape=IMAGE, classes=102):
    """``n`` (uint8 image, int64 [1] label) samples from a seeded
    RandomState: the records of the reader phases' recordio file."""
    import numpy as np

    rng = np.random.RandomState(seed)
    return [(rng.randint(0, 256, shape).astype(np.uint8),
             np.asarray([rng.randint(0, classes)], np.int64))
            for _ in range(n)]


def write_reader_file(fluid, path, samples):
    """The samples as a recordio file of pickled feed tuples, as
    ``fluid.recordio_writer`` writes them (uncompressed); returns the
    record count."""
    from paddle_tpu_torch import recordio

    return fluid.recordio_writer.convert_reader_to_recordio_file(
        path, lambda: iter(samples), compressor=recordio.NO_COMPRESS)


def build_reader_resnet(fluid, rio=None, data_set="flowers", depth=50,
                        batch=READER_BATCH, shuffle=READER_SHUFFLE,
                        amp=True, learning_rate=0.01):
    """``resnet.get_model``'s training program (uint8 input cast and
    scaled on the device, NHWC with fused stages, Momentum) fed by the
    reader chain ``open_files([rio]) -> shuffle -> batch -> double_buffer
    -> read_file``, or with ``rio`` None by the data layers ``data`` and
    ``label``; under bf16 AMP with ``amp``.  The two programs name every
    parameter alike.  Returns (main, startup, loss, the reader or None,
    image var, label var)."""
    from paddle_tpu_torch.fluid.transpiler import LayoutTranspiler
    from paddle_tpu_torch.models import resnet

    cifar = data_set == "cifar10"
    shape = [3, 32, 32] if cifar else list(IMAGE)
    main, startup = fluid.Program(), fluid.Program()
    reader = None
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if rio is not None:
            reader = fluid.layers.io.open_files(
                [rio], shapes=[[-1] + shape, [-1, 1]], lod_levels=[0, 0],
                dtypes=["uint8", "int64"])
            reader = fluid.layers.io.shuffle(reader, buffer_size=shuffle)
            reader = fluid.layers.io.batch(reader, batch_size=batch)
            reader = fluid.layers.io.double_buffer(reader)
            image, label = fluid.layers.io.read_file(reader)
        else:
            image = fluid.layers.data(name="data", shape=shape,
                                      dtype="uint8")
            label = fluid.layers.data(name="label", shape=[1], dtype="int64")
        x = fluid.layers.scale(fluid.layers.cast(image, "float32"),
                               scale=1.0 / 255.0)
        if cifar:
            predict = resnet.resnet_cifar10(x, 10, depth=depth)
        else:
            predict = resnet.resnet_imagenet(x, 102, depth=depth)
        loss = fluid.layers.mean(fluid.layers.cross_entropy(input=predict,
                                                            label=label))
        LayoutTranspiler().transpile(main, startup_program=startup,
                                     data_format="NHWC", fuse_stages=True)
        fluid.optimizer.Momentum(learning_rate=learning_rate,
                                 momentum=0.9).minimize(loss)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss, reader, image, label


def host_reader_batches(rio, batch, shuffle, steps, reset_at=None):
    """The batches the program's chain pops, decoded on the host by the
    same reader classes (no double buffer): ``steps`` batches, the chain
    reset before batch ``reset_at`` (after its EOF)."""
    from paddle_tpu_torch.ops import reader_ops as ro

    chain = ro._BatchReader(ro._ShuffleReader(ro._MultiFileReader([rio]),
                                              shuffle), batch)
    out = []
    for i in range(steps):
        if i == reset_at:
            try:
                chain.next()
                raise AssertionError("the host chain has no EOF at %d" % i)
            except ro.EOFException:
                chain.reset()
        out.append(chain.next())
    return out


def persistable_tensors(torch, main, scope):
    """{name: tensor} of ``main``'s persistable tensors in ``scope`` (the
    reader handles left out)."""
    out = {}
    for name, vd in main.desc.blocks[0].vars.items():
        if vd.persistable and scope.has_var(name):
            v = scope.find_var(name)
            if isinstance(v, torch.Tensor):
                out[name] = v
    return out


def traced_step(torch, step, n):
    """({kernel: launches a step} of the port's kernels by symbol, device
    ms a step, the device's idle share) of ``n`` calls of ``step`` in one
    ``torch.profiler`` session; the kernel counts None when the trace
    holds no device event."""
    from paddle_tpu_torch.tools.profile_train import (device_kernels,
                                                      port_kernel_groups)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            step()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n
    kernels = device_kernels(prof, n)
    if not kernels:
        return None, "not measured", "not measured"
    groups = {k: g["calls_per_step"]
              for k, g in port_kernel_groups(kernels).items()}
    groups["conv_stage_bf16"] += groups.pop("conv_stage_bf16_stem")
    busy = sum(k["ms_per_step"] for k in kernels.values())
    return groups, busy, max(0.0, 1.0 - busy / wall)


def train_reader_k6(torch):
    """Phase train_reader_k6: the full ResNet-50 (flowers 224 x 224, 102
    classes, Momentum 0.01) at batch READER_BATCH, NHWC with fused
    stages under bf16 AMP (FLAGS_bn_bf16; cuDNN's deterministic
    algorithms for the convs K6 does not take), fed through run() by the
    reader chain ``open_files([rio]) -> shuffle(READER_SHUFFLE) ->
    batch -> double_buffer -> read_file`` over a recordio file of
    READER_IMAGES seeded uint8 images: an epoch of READER_EPOCH_STEPS
    steps (the last TRACED_REPLAYS in one profiler session: K6 bf16's
    launches a step by symbol, device ms, idle share), then
    ``fluid.core.EOFException``, ``reset()`` and READER_AFTER_RESET more
    steps.  The same batches, decoded on the host by the chain's reader
    classes, must equal the ones the read op popped, and fed through
    run() from the same scope start they must give every loss and
    persistable bit for bit.  K6 bf16 launches 53 times a step (the
    wrappers' counts over the reader run, and the trace).  ``step_ms_p50``
    is over the epoch's untraced steps after its first (the first, and
    the step after the reset, whose double buffer refills the shuffle
    buffer from the file before its first batch, are reported apart)."""
    with bn_bf16(True), cudnn_deterministic(True):
        return _train_reader_k6(torch)


def _train_reader_k6(torch):
    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import recordio
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    if not recordio.native_available():
        raise AssertionError("the native recordio codec did not build: %s"
                             % recordio.native_error())
    rio = os.path.join(smoke_dir("reader_k6"), "train.recordio")
    t0 = time.perf_counter()
    n = write_reader_file(fluid, rio, reader_samples(READER_IMAGES, SEED + 28))
    write_s = time.perf_counter() - t0
    main, startup, loss, reader, image, label = build_reader_resnet(
        fluid, rio)
    fmain, fstartup, floss, _, fimage, flabel = build_reader_resnet(fluid)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)
    init = {k: v.clone() for k, v in
            persistable_tensors(torch, main, scope).items()}
    steps = READER_EPOCH_STEPS + READER_AFTER_RESET
    t0 = time.perf_counter()
    host = host_reader_batches(rio, READER_BATCH, READER_SHUFFLE, steps,
                               reset_at=READER_EPOCH_STEPS)
    host_decode_s = time.perf_counter() - t0

    def step():
        return exe.run(main, fetch_list=[loss], scope=scope)[0]

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_ms, popped, traced = [], [], [], None
    untraced = READER_EPOCH_STEPS - TRACED_REPLAYS
    for i in range(untraced):
        t0 = time.perf_counter()
        losses.append(float(step()[0]))     # the fetch waits for the card
        step_ms.append((time.perf_counter() - t0) * 1e3)
        popped.append([scope.find_var(v.name).cpu().numpy()
                       for v in (image, label)])
    # the epoch's last TRACED_REPLAYS steps, traced in one session
    trace_losses = []

    def traced_one():
        trace_losses.append(step())
        popped.append([scope.find_var(v.name) for v in (image, label)])

    traced, device_ms, idle = traced_step(torch, traced_one, TRACED_REPLAYS)
    losses += [float(x[0]) for x in trace_losses]
    popped[untraced:] = [[t.cpu().numpy() for t in p]
                         for p in popped[untraced:]]
    eof = False
    try:
        step()
    except fluid.core.EOFException:
        eof = True
    reader.reset(scope=scope)
    after_reset_ms = []
    for _ in range(READER_AFTER_RESET):
        t0 = time.perf_counter()
        losses.append(float(step()[0]))
        after_reset_ms.append((time.perf_counter() - t0) * 1e3)
        popped.append([scope.find_var(v.name).cpu().numpy()
                       for v in (image, label)])
    launches = {k: fn.launches for k, fn in KERNELS.items()}
    peak = torch.cuda.max_memory_allocated()
    final = {k: v.clone() for k, v in
             persistable_tensors(torch, main, scope).items()}
    db_device = str(scope.find_var(image.name).device)
    del scope, exe
    _free(torch)

    # the same batches, decoded on the host, fed from the same start
    same_batches = len(popped) == len(host) and all(
        p[0].dtype == h[0].dtype and np.array_equal(p[0], h[0])
        and np.array_equal(p[1], h[1]) for p, h in zip(popped, host))
    fscope = fluid.Scope()
    fexe = fluid.Executor(fluid.CUDAPlace(0))
    fexe.run(fstartup, scope=fscope)
    for k, v in init.items():
        fscope.set(k, v.clone())
    fed = [float(fexe.run(fmain, feed={fimage.name: h[0],
                                       flabel.name: h[1]},
                          fetch_list=[floss], scope=fscope)[0][0])
           for h in host]
    fed_final = persistable_tensors(torch, fmain, fscope)
    differ = sorted(k for k in final if k not in fed_final
                    or not _bits_equal(torch, final[k], fed_final[k]))
    del fscope, fexe, init, final, fed_final
    _free(torch)

    per_step = launches["conv_stage_bf16"] / steps
    checks = {
        "records": n == READER_IMAGES,
        "eof_after_epoch": eof,
        "double_buffer_on_card": db_device.startswith("cuda"),
        "same_batches_as_host": same_batches,
        "losses_bit_for_bit": losses == fed,
        "persistables_bit_for_bit": not differ,
        "losses_finite": all(math.isfinite(x) for x in losses),
        "k6_bf16_53_a_step": per_step == RESNET_CONVS
        and launches["conv_stage"] == 0,
        "k6_bf16_traced_53_a_step": traced is not None
        and traced["conv_stage_bf16"] == RESNET_CONVS,
    }
    return {"phase": "train_reader_k6", "batch": READER_BATCH,
            "images": READER_IMAGES, "shuffle": READER_SHUFFLE,
            "file_bytes": os.path.getsize(rio), "write_s": write_s,
            "host_decode_s": host_decode_s, "steps": steps, "losses": losses,
            "fed_losses": fed, "differing_persistables": differ[:10],
            "first_step_ms": step_ms[0], "step_ms": step_ms[1:],
            "step_ms_p50": _pct(step_ms[1:], 0.5),
            "images_per_s": READER_BATCH / _pct(step_ms[1:], 0.5) * 1e3,
            "after_reset_step_ms": after_reset_ms,
            "traced_steps": TRACED_REPLAYS, "traced_launches_per_step":
            traced, "device_ms_per_step": device_ms, "idle_share": idle,
            "max_memory_allocated_bytes": peak,
            "launches": launches, "launches_per_step": {
                k: v / steps for k, v in launches.items() if v},
            "checks": checks, "ok": all(checks.values())}


def loader_oracle(torch):
    """Phase loader_oracle: on the card, ``DeviceLoader`` and
    ``DeviceDatasetCache`` against the host.  DeviceLoader's batches of
    READER_BATCH images from a recordio file (pinned copies on its copy
    stream), copied back, byte-identical to ``batch(reader)``'s; one
    epoch of the cache (READER_IMAGES indexed images) covers every
    sample exactly once with each batch's images those of its indices,
    and the next epoch's order differs; a mid-epoch ``reset()`` of the
    reader chain's double buffer, its queue full, leaves no copy in
    flight (its copy stream idle, its queue empty, its thread gone) and
    after ``torch.cuda.synchronize()`` no staged batch allocated beyond
    the one the scope holds; the epoch after it gives the file's batches
    in order."""
    import gc
    import pickle

    import numpy as np

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch import reader as rd

    samples = reader_samples(READER_IMAGES, SEED + 29)
    rio = os.path.join(smoke_dir("loader_oracle"), "loader.recordio")
    write_reader_file(fluid, rio, samples)
    place = fluid.CUDAPlace(0)
    checks, info = {}, {}

    # DeviceLoader: batches copied back equal the host reader's
    base = rd.creator.recordio(rio, pickle.loads)
    batched = rd.batch(base, READER_BATCH)
    t0 = time.perf_counter()
    got = [{k: (str(v.device), v.cpu().numpy()) for k, v in d.items()}
           for d in rd.DeviceLoader(batched, ["image", "label"], place,
                                    capacity=3)]
    info["device_loader_s"] = time.perf_counter() - t0
    want = list(batched())
    checks["loader_batches"] = len(got) == len(want) == READER_EPOCH_STEPS
    checks["loader_on_card"] = all(v[0].startswith("cuda")
                                   for d in got for v in d.values())
    checks["loader_bytes_equal"] = all(
        g["image"][1].tobytes() == np.stack([s[0] for s in w]).tobytes()
        and g["label"][1].tobytes() == np.stack([s[1] for s in w]).tobytes()
        for g, w in zip(got, want))
    del got, want

    # DeviceDatasetCache: an epoch covers each sample once, reshuffled
    imgs = np.stack([s[0] for s in samples])

    def indexed():
        for i, s in enumerate(samples):
            yield s[0], np.asarray([i], np.int64)

    cache = rd.DeviceDatasetCache(indexed, ["image", "index"], place,
                                  READER_BATCH, seed=SEED)
    epochs = []
    images_match = True
    for _ in range(2):
        ids = []
        for d in cache:
            idx = d["index"][:, 0].cpu().numpy()
            ids.append(idx)
            images_match &= d["image"].device.type == "cuda" and \
                np.array_equal(d["image"].cpu().numpy(), imgs[idx])
        epochs.append(np.concatenate(ids))
    checks["cache_covers_each_sample_once"] = all(
        np.array_equal(np.sort(e), np.arange(READER_IMAGES)) for e in epochs)
    checks["cache_reshuffles"] = not np.array_equal(epochs[0], epochs[1])
    checks["cache_images_match_indices"] = bool(images_match)
    info["cache_bytes"] = cache.nbytes
    del cache, epochs
    _free(torch)

    # the double buffer's mid-epoch reset
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        r = fluid.layers.io.open_files(
            [rio], shapes=[[-1] + list(IMAGE), [-1, 1]], lod_levels=[0, 0],
            dtypes=["uint8", "int64"])
        r = fluid.layers.io.batch(r, batch_size=READER_BATCH)
        r = fluid.layers.io.double_buffer(r)
        image, label = fluid.layers.io.read_file(r)
        total = fluid.layers.reduce_sum(fluid.layers.cast(image, "float32"))
    scope = fluid.Scope()
    exe = fluid.Executor(place)
    exe.run(startup, scope=scope)
    torch.cuda.synchronize()
    m0 = torch.cuda.memory_allocated()
    exe.run(main, fetch_list=[total], scope=scope)
    db = scope.find_var(r.name)
    deadline = time.time() + 30
    while not db._q.full() and time.time() < deadline:
        time.sleep(0.01)
    batch_bytes = READER_BATCH * (int(np.prod(IMAGE)) + 8)
    torch.cuda.synchronize()
    m1 = torch.cuda.memory_allocated()
    r.reset(scope=scope)
    gc.collect()
    torch.cuda.synchronize()
    m2 = torch.cuda.memory_allocated()
    checks["queue_was_full"] = m1 - m0 >= 2 * batch_bytes
    checks["no_copy_in_flight"] = (db._thread is None and db._q.empty()
                                   and db._copier.stream.query())
    # what stays: the batch the scope holds and the run's small outputs
    checks["staged_batches_freed"] = m2 - m0 <= batch_bytes + (1 << 20)
    after = []
    for _ in range(READER_EPOCH_STEPS):
        exe.run(main, fetch_list=[total], scope=scope)
        after.append(scope.find_var(image.name).cpu().numpy())
    try:
        exe.run(main, fetch_list=[total], scope=scope)
        eof = False
    except fluid.core.EOFException:
        eof = True
    checks["epoch_after_reset_in_order"] = eof and all(
        np.array_equal(a, imgs[k * READER_BATCH:(k + 1) * READER_BATCH])
        for k, a in enumerate(after))
    info.update(allocated_before=m0, allocated_queue_full=m1,
                allocated_after_reset=m2, batch_bytes=batch_bytes)
    del scope, exe
    _free(torch)
    return {"phase": "loader_oracle", "batch": READER_BATCH,
            "images": READER_IMAGES, **info, "checks": checks,
            "ok": all(checks.values())}


def bench_once(torch, extra):
    """The bench entry's ``main()`` once in this process under the
    BENCH_* settings ``extra`` (the others cleared, the flags it sets put
    back after): (its JSON last line, seconds, peak memory allocated)."""
    import contextlib
    import io

    from paddle_tpu_torch.core.flags import FLAGS
    from paddle_tpu_torch.tools import bench

    flags = {k: d["value"] for k, d in FLAGS._defs.items()}
    saved = {k: v for k, v in os.environ.items() if k.startswith("BENCH_")}
    for k in saved:
        del os.environ[k]
    os.environ.update(extra)
    _free(torch)
    torch.cuda.reset_peak_memory_stats()
    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = bench.main()
        if rc != 0:
            raise AssertionError("the bench entry returned %r" % rc)
        out = json.loads(buf.getvalue().strip().splitlines()[-1])
    finally:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        os.environ.update(saved)
        for k, v in flags.items():
            setattr(FLAGS, k, v)
    secs = time.perf_counter() - t0
    return out, secs, torch.cuda.max_memory_allocated()


def bench_real(torch):
    """Phase bench_real: the bench entry at its card defaults for
    ``resnet50`` (flowers 224 x 224, batch 256, bf16 AMP, uint8 input,
    NCHW, prepared; BENCH_FAKE's card default 0: the recordio file of
    the flowers adapter's synthetic images, ``DeviceDatasetCache``,
    the stream probe), BENCH_REAL_ITERS timed steps, no secondary;
    beside it BENCH_FAKE=1 (one synthetic host batch) in this process:
    images/s of both, the stream probe's three numbers, peak memory, the
    file's and the cache's bytes."""
    data_dir = smoke_dir("bench_data")
    base = {"BENCH_ITERS": str(BENCH_REAL_ITERS), "BENCH_SECONDARY": "0",
            "BENCH_DATA_DIR": data_dir}
    real, real_s, real_peak = bench_once(torch, base)
    fake, fake_s, fake_peak = bench_once(torch, dict(base, BENCH_FAKE="1"))
    data = real.get("data") or {}
    image_bytes = int(math.prod(IMAGE))
    checks = {
        "real_data": real["fake_data"] is False,
        "cached": data.get("loader") == "DeviceDatasetCache",
        "native_codec": data.get("codec") == "native",
        "records": data.get("records") == BENCH_REAL_IMAGES,
        "cache_bytes": data.get("cache_bytes") ==
        BENCH_REAL_IMAGES * (image_bytes + 8),
        "stream_probe": all(isinstance(real.get(k), float) and real[k] > 0
                            for k in ("h2d_mb_per_sec_idle",
                                      "streaming_imgs_per_sec",
                                      "stream_overlap_ratio")),
        "fake_run": fake["fake_data"] is True and "data" not in fake,
        "metric": real["metric"] == fake["metric"] ==
        "resnet50_flowers_train_bs256_bf16",
        **{"%s_%s" % (name, k): v for name, out in (("real", real),
                                                    ("fake", fake))
           for k, v in bench_checks(out, True, True).items()},
    }
    keys = ("metric", "value", "step_ms_p50", "step_ms_p90", "tflops", "mfu",
            "prepared_steps")
    return {"phase": "bench_real", "iters": BENCH_REAL_ITERS,
            "real": {**{k: real.get(k) for k in keys}, "data": data,
                     "h2d_mb_per_sec_idle": real.get("h2d_mb_per_sec_idle"),
                     "streaming_imgs_per_sec":
                     real.get("streaming_imgs_per_sec"),
                     "stream_overlap_ratio": real.get("stream_overlap_ratio"),
                     "stream_steps": real.get("stream_steps"),
                     "seconds": real_s,
                     "max_memory_allocated_bytes": real_peak},
            "fake": {**{k: fake.get(k) for k in keys}, "seconds": fake_s,
                     "max_memory_allocated_bytes": fake_peak},
            "cached_over_fake": real["value"] / fake["value"],
            "device": real.get("device"), "checks": checks,
            "ok": all(checks.values())}


def slice28_phases(torch):
    """Slice 28's phases in order, as (name, zero-argument callable)."""
    return [("bench_real", lambda: bench_real(torch)),
            ("train_reader_k6", lambda: train_reader_k6(torch)),
            ("loader_oracle", lambda: loader_oracle(torch))]


SLICES = {"--slice21": slice21_phases, "--slice22": slice22_phases,
          "--slice23": slice23_phases, "--slice24": slice24_phases,
          "--slice25": slice25_phases, "--slice26": slice26_phases,
          "--slice27": slice27_phases, "--slice28": slice28_phases}


def slice_main(flag):
    """``chip_smoke.py --slice21`` .. ``--slice28``: that slice's phases
    alone, each printed as one JSON line; stops at the
    first that fails (exit 1).  Slice 22's files go under
    ``_smoke_io/``, removed after."""
    import shutil

    import torch

    from paddle_tpu_torch import resolve_device

    resolve_device("cuda")
    try:
        for name, run in SLICES[flag](torch):
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            try:
                result = run()
                result.setdefault("phase_seconds", time.perf_counter() - t0)
            except Exception as e:
                traceback.print_exc()
                result = {"phase": name, "ok": False,
                          "error": "%s: %s" % (type(e).__name__, e)}
            emit(result)
            if not result["ok"]:
                return 1
        return 0
    finally:
        shutil.rmtree(os.path.join(os.path.dirname(
            os.path.abspath(__file__)), "_smoke_io"), ignore_errors=True)


def slice_subprocess(flag, timeout, counted):
    """Run ``slice_main(flag)`` in a child process (``main``'s profiler
    sessions stay out of its traces).  Returns (its phases' JSON lines,
    {phase: launches} of the phases ``counted`` names, which drive a
    kernel's path, and (phase, reason) of the first that failed, or
    None)."""
    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           flag], cwd=root, capture_output=True,
                          text=True, timeout=timeout)
    lines = []
    for ln in proc.stdout.splitlines():
        if ln.startswith("{"):
            lines.append(json.loads(ln))
    launches = {r["phase"]: r["launches"] for r in lines
                if r["phase"] in counted and "launches" in r}
    failure = None
    bad = [r for r in lines if not r.get("ok")]
    if bad:
        r = bad[0]
        failure = (r["phase"], r.get("error") or "; ".join(
            r.get("failures") or ["its checks"]))
    elif proc.returncode != 0 or len(lines) != len(SLICES[flag](None)):
        failure = (flag[2:], "the child exited %d after %d phases: %s" % (
            proc.returncode, len(lines), proc.stderr[-2000:]))
    if failure:
        sys.stderr.write(proc.stderr[-4000:])
    return lines, launches, failure


# the bench entry's runs: (name, BENCH_* settings besides BENCH_ITERS)
BENCH_RUNS = (("headline", {"BENCH_SECONDARY": "1"}),
              ("headline_run", {"BENCH_PREPARED": "0"}),
              ("nhwc", {"BENCH_LAYOUT": "NHWC"}),
              ("nhwc_f32", {"BENCH_LAYOUT": "NHWC", "BENCH_AMP": "0"}),
              ("lm", {"BENCH_MODEL": "transformer"}),
              ("lm_fused", {"BENCH_MODEL": "transformer",
                            "BENCH_FUSED_TRANSFORMER": "1"}),
              # slice 21: VGG16-BN at bench.py's card default (flowers,
              # batch 256, bf16) and the cifar ResNet (depth 32, which
              # takes cifar10, as in bench.py)
              ("vgg", {"BENCH_MODEL": "vgg"}),
              ("resnet32", {"BENCH_MODEL": "resnet32",
                            "BENCH_DATASET": "cifar10"}),
              # slice 23: the stacked dynamic LSTM at bench.py's card
              # default (64 x 80 tokens, hidden 512, bf16), ms/batch
              ("lstm", {"BENCH_MODEL": "lstm"}))


def bench_child():
    """``chip_smoke.py --bench-child``: every BENCH_RUNS configuration
    through the bench entry's ``main()`` in this one process (one import
    of torch and the port, where a process a run paid ~8 s each), the
    BENCH_* environment and the flags the entry sets put back before
    each run; one JSON line a run: {"bench_run", "seconds", "rc",
    "out"} (``out`` the entry's last line)."""
    import contextlib
    import gc
    import io

    import torch

    from paddle_tpu_torch.core.flags import FLAGS
    from paddle_tpu_torch.tools import bench

    flags = {k: d["value"] for k, d in FLAGS._defs.items()}
    for name, extra in BENCH_RUNS:
        for k in [k for k in os.environ if k.startswith("BENCH_")]:
            del os.environ[k]
        # one synthetic batch (slice 28's bench_real runs the card's
        # real-data default, BENCH_FAKE=0)
        os.environ.update(BENCH_ITERS=str(BENCH_ITERS), BENCH_SECONDARY="0",
                          BENCH_FAKE="1")
        os.environ.update(extra)
        for k, v in flags.items():
            setattr(FLAGS, k, v)
        gc.collect()
        torch.cuda.empty_cache()
        buf = io.StringIO()
        t0 = time.perf_counter()
        try:
            with contextlib.redirect_stdout(buf):
                rc = bench.main()
            out = json.loads(buf.getvalue().strip().splitlines()[-1])
        except Exception:
            traceback.print_exc()
            rc, out = 1, None
        print(json.dumps({"bench_run": name,
                          "seconds": time.perf_counter() - t0,
                          "rc": rc, "out": out}), flush=True)
    return 0


def bench_runs(torch, fused_step_ms):
    """The port's bench entry in one child process (``bench_child``):
    the default headline with its secondary (the flagship LM, which
    must be the bf16 LM), BENCH_LAYOUT=NHWC, (information, beside
    ``fused_step_ms``, phase 13's p50) BENCH_AMP=0 BENCH_LAYOUT=NHWC,
    and BENCH_MODEL=transformer at its card default (bf16), unfused and
    fused-block, BENCH_MODEL=vgg at its card default,
    BENCH_MODEL=resnet32 on cifar10 and BENCH_MODEL=lstm at its card
    default (bf16, ms/batch), each BENCH_ITERS, no secondary but the
    headline's.  Returns (the runs' JSON lines, the phase's summary)."""
    root = os.path.dirname(os.path.abspath(__file__))
    torch.cuda.empty_cache()
    proc = subprocess.run([sys.executable, os.path.abspath(__file__),
                           "--bench-child"], cwd=root, capture_output=True,
                          text=True, timeout=1500)
    done = {}
    for ln in proc.stdout.splitlines():
        if ln.startswith('{"bench_run"'):
            r = json.loads(ln)
            done[r["bench_run"]] = r
    lines, summary, bad = {}, {}, []
    for name, extra in BENCH_RUNS:
        r = done.get(name)
        out = r["out"] if r and r["rc"] == 0 else None
        secs = r["seconds"] if r else None
        if out is None:
            sys.stderr.write(proc.stderr[-4000:])
            bad.append("%s: rc %s" % (name, r["rc"] if r else
                                      "none (the child exited %d)"
                                      % proc.returncode))
            continue
        lines[name] = out
        amp = extra.get("BENCH_AMP", "1") == "1"
        checks = bench_checks(out, amp, extra.get("BENCH_PREPARED") != "0")
        if extra.get("BENCH_MODEL") == "lstm":
            # bench.py reports no FLOPs for the LSTM: no mfu
            checks.update(
                metric=out["metric"] == "stacked_lstm_train_bs64_h512_seq80"
                "_bf16" and out["unit"] == "ms/batch",
                mfu=out["mfu"] is None,
                vs_baseline=out["vs_baseline"] == 184.0 / out["value"],
                secondary=out["secondary"] is None)
        elif extra.get("BENCH_MODEL") in ("vgg", "resnet32"):
            model = extra["BENCH_MODEL"]
            checks.update(
                metric=out["metric"] == (
                    "vgg_flowers_train_bs256_bf16" if model == "vgg"
                    else "resnet32_cifar10_train_bs256_bf16"),
                data_format=out["data_format"] == "NCHW",
                secondary=out["secondary"] is None)
            # bench.py's MFU counts 224 x 224 images only
            checks["mfu"] = (out["mfu"] is not None) is (model == "vgg")
        elif "BENCH_MODEL" in extra:
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
            "prepared", "prepared_steps", "device", "examples_per_sec",
            "vs_baseline")}
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


def cache_bytecode():
    """Let the child processes (the slices, the bench runs) share one
    bytecode cache under the checkout's ignored ``_pycache/``: where the
    environment sets PYTHONDONTWRITEBYTECODE, each child would compile
    torch's Python sources again (on an H100 host, importing torch and
    the port took 9.7-11.0 s without the cache, 7.6-8.0 s with it)."""
    os.environ["PYTHONPYCACHEPREFIX"] = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "_pycache")
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)


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

    cache_bytecode()
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

        # slice 21's phases run in a process of their own: profiler
        # sessions pile up in one process, and past some number of them
        # a trace of a CUDA graph replay shows only part of its kernels
        # or none (a late trace of the dropout chain's replay read one of
        # its two K4 launches; with these phases first, serve_fleet's
        # decode trace read none), where a fresh process reads them all
        phase = "slice21"
        torch.cuda.empty_cache()
        lines, launches_train, failure = slice_subprocess(
            "--slice21", SLICE21_TIMEOUT_S,
            ("train_fused_dropout", "train_fused_dropout_amp"))
        for line in lines:
            emit(line)
        if failure:
            phase = failure[0]
            raise AssertionError("%s: %s" % failure)

        # slice 22's phases, in a child process of their own too
        phase = "slice22"
        torch.cuda.empty_cache()
        lines, launches22, failure = slice_subprocess(
            "--slice22", SLICE22_TIMEOUT_S,
            ("checkpoint_prepared_amp", "trainer_resume"))
        for line in lines:
            emit(line)
        if failure:
            phase = failure[0]
            raise AssertionError("%s: %s" % failure)
        launches_train.update(launches22)

        # slice 23's phases (ragged feeds, the sequence ops), in a child
        # process of their own too
        phase = "slice23"
        torch.cuda.empty_cache()
        lines, launches23, failure = slice_subprocess(
            "--slice23", SLICE23_TIMEOUT_S,
            ("train_lstm", "train_lstm_amp", "train_lstm_ragged",
             "train_sentiment_conv"))
        for line in lines:
            emit(line)
        if failure:
            phase = failure[0]
            raise AssertionError("%s: %s" % failure)
        launches_train.update(launches23)

        # slice 24's phases (sub-blocks and control flow), in a child
        # process of their own too
        phase = "slice24"
        torch.cuda.empty_cache()
        lines, launches24, failure = slice_subprocess(
            "--slice24", SLICE24_TIMEOUT_S,
            ("train_sentiment_dyn_rnn", "train_sentiment_dyn_rnn_amp",
             "train_rnn_seq2seq"))
        for line in lines:
            emit(line)
        if failure:
            phase = failure[0]
            raise AssertionError("%s: %s" % failure)
        launches_train.update(launches24)

        # slice 25's phases (the training front end, AlexNet and
        # GoogLeNet), in a child process of their own too
        phase = "slice25"
        torch.cuda.empty_cache()
        lines, launches25, failure = slice_subprocess(
            "--slice25", SLICE25_TIMEOUT_S,
            ("train_lm_sched", "train_lm_sched_fused_amp"))
        for line in lines:
            emit(line)
        if failure:
            phase = failure[0]
            raise AssertionError("%s: %s" % failure)
        launches_train.update(launches25)

        # slice 26's phases (crf_ctc, beam_search, the last three book
        # models), in a child process of their own too
        phase = "slice26"
        torch.cuda.empty_cache()
        lines, launches26, failure = slice_subprocess(
            "--slice26", SLICE26_TIMEOUT_S,
            ("train_mt", "train_recommender", "train_srl"))
        for line in lines:
            emit(line)
        if failure:
            phase = failure[0]
            raise AssertionError("%s: %s" % failure)
        launches_train.update(launches26)

        # slice 27's phases (the conv family, the detection / misc / metric
        # ops, MobileNet-SSD), in a child process of their own too
        phase = "slice27"
        torch.cuda.empty_cache()
        lines, launches27, failure = slice_subprocess(
            "--slice27", SLICE27_TIMEOUT_S, ("train_ssd",))
        for line in lines:
            emit(line)
        if failure:
            phase = failure[0]
            raise AssertionError("%s: %s" % failure)
        launches_train.update(launches27)

        # slice 28's phases (the data pipeline, ResNet-50 from a recordio
        # file through the reader ops), in a child process of their own too
        phase = "slice28"
        torch.cuda.empty_cache()
        lines, launches28, failure = slice_subprocess(
            "--slice28", SLICE28_TIMEOUT_S, ("train_reader_k6",))
        for line in lines:
            emit(line)
        if failure:
            phase = failure[0]
            raise AssertionError("%s: %s" % failure)
        launches_train.update(launches28)

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
    if sys.argv[1:2] == ["--bench-child"]:
        sys.exit(bench_child())
    sys.exit(slice_main(sys.argv[1]) if sys.argv[1:2] and
             sys.argv[1] in SLICES else main())
