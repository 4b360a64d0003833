"""Where a training step's time goes on the card.

Builds one of two models as a fluid Program:

- ``--model lm`` (the default): the flagship LM (``models/transformer``
  get_model: vocab 8192, d_model 1024, 8 heads, 6 layers, d_ff 4096,
  sequence 2048, Adam; ``--batch`` sequences, default 16; ``--fuse``
  for the fused-block program, ``FLAGS_transformer_fuse``; ``--sp P``
  for the sequence-parallel program on a P-shard mesh laid on the one
  card, run by ``ExecutorCore`` with that mesh; ``--amp`` for bf16
  mixed precision, ``Float16Transpiler``, as ``bench.py`` trains it on
  an accelerator, not with ``--sp``);
- ``--model resnet50``: ResNet-50 (``models/resnet`` get_model:
  flowers, 224 x 224, 102 classes, uint8 images, Momentum 0.9 at lr
  0.01; ``--batch`` images, default 256; ``--fuse`` for the NHWC
  fused-stage program, ``FLAGS_conv_layout=NHWC``; ``--amp`` for bf16
  mixed precision, ``Float16Transpiler`` with ``FLAGS_bn_bf16``, as
  ``bench.py`` trains it on an accelerator);

runs its startup program and 2 untimed steps on one fixed batch drawn
from ``--seed``, then:

- ``--steps`` steps (default 3) under ``torch.profiler``: host wall
  time of a step, ended by the loss fetch (median), device time per
  step (the sum of kernel, memcpy and memset times), the device's idle
  share of the step, device time by kernel name, and by kernel of the
  port's (``KERNEL_GROUPS``: each one's launches under its symbol,
  whatever their template form);
- as many steps with CUDA events recorded on the current stream around
  every op of the program (``executor_impl.OP_HOOK``): device time per
  step by op type.  The events bracket everything the op enqueued,
  including what autograd's device thread launched for a ``*_grad`` op
  (a profiler range on the calling thread would miss that), and any
  gap in between, which the idle share above bounds.

Where the profiler records no device time these read "not measured".
Run on a CUDA machine from the repository root:

    python -m paddle_tpu_torch.tools.profile_train [--model resnet50]
        [--batch N] [--fuse] [--amp] [--sp P]

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
                 "conv_stage_bf16": "conv_wgmma_kernel",
                 "conv_stage_bf16_stem": "gemm::bf16_kernel",
                 "flash_fwd_bf16": "flash_fwd_bf16_kernel",
                 "flash_bwd_dq_bf16": "flash_bwd_dq_bf16_kernel",
                 "flash_bwd_dkv_bf16": "flash_bwd_dkv_bf16_kernel"}


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
    args = ap.parse_args(argv)
    if args.sp and args.model != "lm":
        ap.error("--sp applies to --model lm")
    if args.amp and args.sp > 1:
        ap.error("--amp with --sp: the ring has no bf16 form yet (ROADMAP "
                 "queue 1 item 3g)")
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

        def step():
            return core.run(main_prog.desc, scope, 0, feed, [loss.name])
    else:
        def step():
            return exe.run(main_prog, feed=feed, fetch_list=[loss],
                           scope=scope)

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
    kernels = {}
    for evt in prof.key_averages():
        # device-side events only (kernels, memcpy/memset): a CPU op's
        # self device time repeats its kernels' time
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        us = getattr(evt, "self_device_time_total", None)
        if us is None:
            us = getattr(evt, "self_cuda_time_total", 0)
        if us > 0:
            kernels[evt.key] = {"ms_per_step": us / 1e3 / args.steps,
                                "calls_per_step": evt.count / args.steps}
    busy = sum(k["ms_per_step"] for k in kernels.values())
    groups = {name: {"ms_per_step": sum(
        v["ms_per_step"] for k, v in kernels.items() if sym in k),
        "calls_per_step": sum(
        v["calls_per_step"] for k, v in kernels.items() if sym in k)}
        for name, sym in KERNEL_GROUPS.items()}
    med = float(np.median(step_ms))
    top = dict(sorted(kernels.items(),
                      key=lambda kv: -kv[1]["ms_per_step"])[:15])

    timer = OpTimer()
    executor_impl.OP_HOOK = timer
    try:
        for _ in range(args.steps):
            step()
    finally:
        executor_impl.OP_HOOK = None
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "model": args.model,
        "batch": batch, **config, "amp": args.amp, "steps": args.steps,
        "step_ms_median": med, unit: per_step / med * 1e3,
        "device_ms_per_step": busy if kernels else "not measured",
        "device_idle_share": 1.0 - busy / med if kernels
        else "not measured",
        "by_op_type": timer.by_type(args.steps),
        "by_port_kernel": groups if kernels else "not measured",
        "kernels": top or "not measured"}))


if __name__ == "__main__":
    main()
