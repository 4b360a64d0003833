"""Where a training step's time goes on the card.

Builds one of two models as a fluid Program:

- ``--model lm`` (the default): the flagship LM (``models/transformer``
  get_model: vocab 8192, d_model 1024, 8 heads, 6 layers, d_ff 4096,
  sequence 2048, Adam; ``--batch`` sequences, default 16; ``--fuse``
  for the fused-block program, ``FLAGS_transformer_fuse``; ``--sp P``
  for the sequence-parallel program on a P-shard mesh laid on the one
  card, run by ``ExecutorCore`` with that mesh; ``--amp`` for bf16
  mixed precision, ``Float16Transpiler``, as ``bench.py`` trains it on
  an accelerator, with ``--sp`` too);
- ``--model resnet50``: ResNet-50 (``models/resnet`` get_model:
  flowers, 224 x 224, 102 classes, uint8 images, Momentum 0.9 at lr
  0.01; ``--batch`` images, default 256; ``--fuse`` for the NHWC
  fused-stage program, ``FLAGS_conv_layout=NHWC``; ``--amp`` for bf16
  mixed precision, ``Float16Transpiler`` with ``FLAGS_bn_bf16``, as
  ``bench.py`` trains it on an accelerator);

runs its startup program and 2 untimed steps on one fixed batch drawn
from ``--seed`` (with ``--prepared`` through ``Executor.prepare`` /
``run_prepared``: the first captures the step as one CUDA graph, and
every later step is one replay), then:

- ``--steps`` steps (default 3) under ``torch.profiler``: host wall
  time of a step, ended by the loss fetch (median), device time per
  step (the sum of kernel, memcpy and memset times), the device's idle
  share of the step, device time by kernel name, and by kernel of the
  port's (``KERNEL_GROUPS``: each one's launches under its symbol,
  whatever their template form), and of device-to-device copies;
- with ``--prepared``, the captured step's copy-back of its state into
  its static inputs, captured and timed alone (``state_copy_back``: ms
  and bytes);
- as many steps with CUDA events recorded on the current stream around
  every op of the program (``executor_impl.OP_HOOK``): device time per
  step by op type.  The events bracket everything the op enqueued,
  including what autograd's device thread launched for a ``*_grad`` op
  (a profiler range on the calling thread would miss that), and any
  gap in between, which the idle share above bounds.  These steps run
  through ``run()`` also with ``--prepared`` (a replay runs no Python
  between the ops), and ``by_op_type_path`` says so.

Where the profiler records no device time these read "not measured".
Run on a CUDA machine from the repository root:

    python -m paddle_tpu_torch.tools.profile_train [--model resnet50]
        [--batch N] [--fuse] [--amp] [--sp P] [--prepared]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from .. import fluid
from ..core import executor_impl
from ..core.flags import FLAGS
from ..models import resnet, transformer
from ..parallel import make_mesh

LM = dict(vocab_size=8192, seq_len=2048, d_model=1024, n_head=8,
          n_layers=6, d_ff=4096, learning_rate=1e-3)
RESNET50 = dict(data_set="flowers", depth=50, learning_rate=0.01,
                input_dtype="uint8")
# {name: the substring of its kernel symbols}: the wgmma kernels' device
# ms a step, summed over their forms and call sites, and K6's bf16 stem
# on mma.sync's bf16_kernel (the one kernel of that tile a step runs)
KERNEL_GROUPS = {"matmul_epilogue_bf16": "gemm_bf16_kernel",
                 "add_ln_bf16": "add_ln_bf16_kernel",
                 "conv_stage_bf16": "conv_wgmma_kernel",
                 "conv_stage_bf16_stem": "gemm::bf16_kernel",
                 "flash_fwd_bf16": "flash_fwd_bf16_kernel",
                 "flash_chunk_bf16": "flash_chunk_bf16_kernel",
                 "flash_bwd_dq_bf16": "flash_bwd_dq_bf16_kernel",
                 "flash_bwd_dkv_bf16": "flash_bwd_dkv_bf16_kernel"}


def device_kernels(prof, steps):
    """{device event name: {"ms_per_step", "calls_per_step"}} of a
    ``torch.profiler`` trace of ``steps`` steps: kernels, memcpys and
    memsets (a CPU op's self device time would repeat its kernels')."""
    kernels = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            kernels[evt.key] = {"ms_per_step": us / 1e3 / steps,
                                "calls_per_step": evt.count / steps}
    return kernels


def port_kernel_groups(kernels):
    """``device_kernels`` summed by ``KERNEL_GROUPS``."""
    return {name: {
        "ms_per_step": sum(v["ms_per_step"] for k, v in kernels.items()
                           if sym in k),
        "calls_per_step": sum(v["calls_per_step"]
                              for k, v in kernels.items() if sym in k)}
        for name, sym in KERNEL_GROUPS.items()}


def copy_back_ms(graph, reps=5):
    """(ms, bytes) of the captured step's copy-back as a replay runs it:
    every read-and-written persistable copied into its static input
    (``StepGraph.write_back``), captured alone in a CUDA graph whose
    ``reps`` replays are timed with CUDA events (launched eagerly, one
    copy a tensor, the host's launches would be timed instead); bytes
    is the state's size (each byte read once and written once)."""
    dst = [graph.state[n] for n in graph.write_back]
    src = [t.clone() for t in dst]
    copies = torch.cuda.CUDAGraph()
    with torch.cuda.graph(copies):
        for d, s in zip(dst, src):
            d.copy_(s)
    copies.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        copies.replay()
    end.record()
    torch.cuda.synchronize()
    return (start.elapsed_time(end) / reps,
            sum(t.numel() * t.element_size() for t in dst))


class OpTimer:
    """``executor_impl.OP_HOOK``: CUDA events around each op."""

    def __init__(self):
        self.marks = []

    @contextlib.contextmanager
    def __call__(self, op):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        self.marks.append((op.type, start, end))

    def by_type(self, steps):
        torch.cuda.synchronize()
        out = {}
        for kind, start, end in self.marks:
            ms, calls = out.get(kind, (0.0, 0))
            out[kind] = (ms + start.elapsed_time(end), calls + 1)
        return {k: {"ms_per_step": ms / steps, "calls_per_step": n / steps}
                for k, (ms, n) in sorted(out.items(),
                                         key=lambda kv: -kv[1][0])}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--model", choices=("lm", "resnet50"), default="lm")
    ap.add_argument("--batch", type=int, default=None,
                    help="sequences (lm, default 16) or images (resnet50, "
                    "default 256)")
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--fuse", action="store_true",
                    help="profile the fused-block (lm) or the NHWC "
                    "fused-stage (resnet50) program")
    ap.add_argument("--sp", type=int, default=0,
                    help="lm: the sequence-parallel program on a mesh of "
                    "this many ring shards laid on the one card")
    ap.add_argument("--amp", action="store_true",
                    help="bf16 mixed precision (resnet50: bn_bf16 on)")
    ap.add_argument("--prepared", action="store_true",
                    help="profile the prepared step (one CUDA graph "
                    "replay a step); the by-op times stay on run()")
    args = ap.parse_args(argv)
    if args.sp and args.model != "lm":
        ap.error("--sp applies to --model lm")
    FLAGS.bn_bf16 = args.amp and args.model == "resnet50"

    rng = np.random.RandomState(args.seed)
    main_prog, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main_prog, startup), fluid.unique_name.guard():
        if args.model == "lm":
            batch = args.batch or 16
            config = dict(LM, fuse_transformer=args.fuse,
                          sp=args.sp > 1)
            loss, _, _ = transformer.get_model(**config)
            toks = rng.randint(0, LM["vocab_size"],
                               (batch, LM["seq_len"] + 1)).astype(np.int64)
            feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
            per_step, unit = batch * LM["seq_len"], "tokens_per_s"
        else:
            batch = args.batch or 256
            config = dict(RESNET50, data_format="NHWC" if args.fuse
                          else "NCHW", fused_stages=args.fuse)
            loss, _, _ = resnet.get_model(**config)
            feed = {"data": rng.randint(0, 256, (batch, 3, 224, 224))
                    .astype(np.uint8),
                    "label": rng.randint(0, 102, (batch, 1))
                    .astype(np.int64)}
            per_step, unit = batch, "images_per_s"
    if args.amp:
        fluid.transpiler.Float16Transpiler().transpile(main_prog)
    scope = fluid.Scope()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    exe.run(startup, scope=scope)

    if args.sp > 1 and args.model == "lm":
        core = executor_impl.ExecutorCore(
            fluid.CUDAPlace(0),
            mesh=make_mesh({"sp": args.sp}, ["cuda:0"] * args.sp))

        def run_step():
            return core.run(main_prog.desc, scope, 0, feed, [loss.name])

        prepare = (lambda: core.prepare(main_prog.desc, feed, [loss.name],
                                        scope=scope))
    else:
        def run_step():
            return exe.run(main_prog, feed=feed, fetch_list=[loss],
                           scope=scope)

        prepare = (lambda: exe.prepare(main_prog, feed_specs=feed,
                                       fetch_list=[loss], scope=scope))
    step = run_step
    if args.prepared:
        prep = prepare()

        def step():
            return executor_impl.fetches_to_host(
                prep.run_prepared(feed))

    torch.cuda.reset_peak_memory_stats()
    for _ in range(2):
        step()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    step_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(args.steps):
            t0 = time.perf_counter()
            step()                  # the loss fetch synchronizes
            step_ms.append((time.perf_counter() - t0) * 1e3)
    peak = torch.cuda.max_memory_allocated()
    reserved = torch.cuda.memory_reserved()
    kernels = device_kernels(prof, args.steps)
    busy = sum(k["ms_per_step"] for k in kernels.values())
    groups = port_kernel_groups(kernels)
    dtod = sum(v["ms_per_step"] for k, v in kernels.items()
               if k.startswith("Memcpy DtoD"))
    med = float(np.median(step_ms))
    top = dict(sorted(kernels.items(),
                      key=lambda kv: -kv[1]["ms_per_step"])[:15])

    copy_back = None
    if args.prepared:
        core_prep = getattr(prep, "_prep", prep)    # the fluid view's core
        ms, nbytes = copy_back_ms(core_prep._step)
        copy_back = {"ms": ms, "state_bytes": nbytes}
        # the first run() after the capture fills the caching
        # allocator's pool anew: keep it out of the by-op times
        run_step()
    timer = OpTimer()
    executor_impl.OP_HOOK = timer
    try:
        for _ in range(args.steps):
            run_step()
    finally:
        executor_impl.OP_HOOK = None
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": args.model,
        "batch": batch, **config, "amp": args.amp, "steps": args.steps,
        "prepared": args.prepared, "max_memory_allocated_bytes": peak,
        "memory_reserved_bytes": reserved,
        "by_op_type_path": "run()",
        "step_ms_median": med, unit: per_step / med * 1e3,
        "device_ms_per_step": busy if kernels else "not measured",
        "device_idle_share": 1.0 - busy / med if kernels
        else "not measured",
        "by_op_type": timer.by_type(args.steps),
        "by_port_kernel": groups if kernels else "not measured",
        "memcpy_dtod_ms_per_step": dtod if kernels else "not measured",
        "state_copy_back": copy_back,
        "kernels": top or "not measured"}))


if __name__ == "__main__":
    main()
