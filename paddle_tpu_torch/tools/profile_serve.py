"""Where a serving step's time goes on the card.

Builds the flagship LM tenant (vocab 8192, d_model 1024, 8 heads,
6 layers, d_ff 4096, block 16, max_seq 2048; random weights from
``--seed``), prefills BATCH = 16 sequences of CTX = 1024 tokens, then
times STEPS = 8 decode steps over all of them (after 2 untimed ones).
Reports:

- ``prefill_ms``: host wall time of one CTX-token prefill, ended by a
  synchronize (median over the batch);
- ``step_ms``: host wall time of one decode step, ended by a
  synchronize (median);
- from ``torch.profiler`` over the timed steps: device time per step
  and the device's idle share of the step, from the union of the
  device events' intervals (K7's combine is a programmatic dependent
  launch: it is scheduled while the span kernel runs and waits for it,
  so its own span includes that wait and the two overlap), device time
  by kernel name (each kernel's own span, waits included), and K7's
  device time per step (``paged_attention_ms_per_step``: the union of
  its kernels' intervals);
- from ``torch.profiler`` over one more CTX-token prefill: its device
  time by kernel name (``prefill_kernels``).
  Where the profiler records no device time these read "not measured".

Run on a CUDA machine from the repository root:

    python -m paddle_tpu_torch.tools.profile_serve [--quant int8]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ..serving import FLAGSHIP_LM, GenerativeEngine, GenRequest, tiny_lm
BATCH, CTX, STEPS = 16, 1024, 8


def _by_kernel(prof, n):
    """{kernel name: {"ms_per_step", "calls_per_step"}} over n steps of
    a profile: device-side events only (kernels, memcpy/memset), since
    a CPU op's self device time repeats its kernels' time."""
    kernels = {}
    for evt in prof.key_averages():
        if getattr(evt, "device_type", None) != DeviceType.CUDA:
            continue
        dev_us = getattr(evt, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(evt, "self_cuda_time_total", 0)
        if dev_us > 0:
            kernels[evt.key] = {"ms_per_step": dev_us / 1e3 / n,
                                "calls_per_step": evt.count / n}
    return kernels


def _device_intervals(prof):
    """[(name, start us, end us)] of the profile's device events."""
    return [(e.name, e.time_range.start, e.time_range.end)
            for e in prof.events()
            if getattr(e, "device_type", None) == DeviceType.CUDA]


def _union_ms(intervals):
    """Milliseconds covered by the union of (start us, end us)
    intervals: time in which at least one of them ran."""
    total, reach = 0.0, None
    for start, end in sorted(intervals):
        if reach is None or start > reach:
            total += end - start
            reach = end
        elif end > reach:
            total += end - reach
            reach = end
    return total / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quant", default="")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    cfg, params = tiny_lm(args.seed, **FLAGSHIP_LM)
    per_seq = -(-(CTX + STEPS + 4) // cfg.block_size)
    eng = GenerativeEngine(cfg, params, quant=args.quant,
                           kv_blocks=(BATCH + 1) * per_seq + 1,
                           device="cuda")
    rng = np.random.RandomState(args.seed + 1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def request():
        req = GenRequest(rng.randint(0, cfg.vocab, CTX).tolist(),
                         STEPS + 4, None, None)
        req.blocks = eng.pool.alloc(per_seq)
        return req

    seqs, prefill_ms = [], []
    for _ in range(BATCH):
        req = request()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        req.out.append(eng.prefill(req))
        torch.cuda.synchronize()
        prefill_ms.append((time.perf_counter() - t0) * 1e3)
        seqs.append(req)
    extra = request()
    with torch.profiler.profile(activities=acts) as prof:
        extra.out.append(eng.prefill(extra))
        torch.cuda.synchronize()
    prefill_kernels = _by_kernel(prof, 1)
    eng.free_sequence(extra)

    def step():
        for s, t in zip(seqs, eng.decode(seqs)):
            s.out.append(int(t))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    step_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step()            # ends in a device-to-host copy of tokens
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
    kernels = _by_kernel(prof, STEPS)
    spans = _device_intervals(prof)
    busy = _union_ms([(s, e) for _, s, e in spans]) / STEPS
    paged = _union_ms([(s, e) for name, s, e in spans
                       if "paged" in name]) / STEPS
    med = float(np.median(step_ms))
    top = dict(sorted(kernels.items(),
                      key=lambda kv: -kv[1]["ms_per_step"])[:12])
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "quant": args.quant,
        "batch": BATCH, "ctx": CTX, "steps": STEPS,
        "prefill_ms_median": float(np.median(prefill_ms)),
        "step_ms_median": med,
        "device_ms_per_step": busy if kernels else "not measured",
        "device_idle_share": 1.0 - busy / med if kernels
        else "not measured",
        "paged_attention_ms_per_step": paged if kernels
        else "not measured",
        "kernels": top or "not measured",
        "prefill_kernels": prefill_kernels or "not measured"}))
    for s in seqs:
        eng.free_sequence(s)
    eng.close()


if __name__ == "__main__":
    main()
