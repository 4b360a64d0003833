"""Where a serving step's time goes on the card.

Builds the flagship LM tenant (vocab 8192, d_model 1024, 8 heads,
6 layers, d_ff 4096, block 16, max_seq 2048; random weights from
``--seed``) with its default warm (on a card: one CUDA graph captured
per warm prefill and decode bucket), prefills BATCH = 16 sequences of
CTX = 1024 tokens, then runs decode steps over all of them: 2 untimed,
STEPS = 8 timed, STEPS profiled.  Reports:

- ``load_s``: the engine's construction (weights staged, kernels built,
  buckets captured), ended by a synchronize; ``capture_s``, the part
  spent warming up and capturing; ``memory_reserved_bytes`` after it;
- ``prefill_ms``: host wall time of one CTX-token prefill, ended by a
  synchronize (median over the batch), unprofiled;
- ``step_ms``: host wall time of one decode step, which ends in the
  device-to-host copy of its tokens (median), unprofiled;
- from ``torch.profiler`` over STEPS more steps: device time per step
  and the device's idle share of the unprofiled step
  (``device_idle_share``) and of the profiled one, from the union of
  the device events' intervals (K7's combine is a programmatic
  dependent launch: it is scheduled while the span kernel runs and
  waits for it, so its own span includes that wait and the two
  overlap), device time by kernel name (each kernel's own span, waits
  included), K7's and K8's device time per step (the union of each
  one's kernels' intervals: ``paged_attention_ms_per_step``,
  ``matmul_int8_ms_per_step``) and the launches of each port kernel a
  step, read by kernel symbol (``traced_launches``);
- ``tokens_sha1``: a digest of every sequence's greedy tokens, to hold
  two builds' tokens equal;
- from ``torch.profiler`` over one more CTX-token prefill: its device
  time, by kernel name (``prefill_kernels``), and its launches.
  Where the profiler records no device time these read "not measured".

``--prefix`` measures one suffix prefill instead: the tenant built with
``prefix_cache=True``, a SYSTEM = 768-token prompt prefix indexed (48
blocks), then the prompt of that prefix and SUFFIX = 256 fresh tokens
admitted through the cache, whose suffix prefill (256 K7 rows over
769..1024 positions a layer) runs STEPS times unprofiled (host ms, a
synchronize at each end, median) and STEPS times profiled: device ms,
idle share, K7 / K8 ms and traced launches a step; beside it the cold
prefill of the same prompt, measured the same way.

``--spec`` measures one speculative round instead: the target is the
flagship LM with layers 1-5's ``wo`` and ``w2`` scaled by SPEC_DAMP,
the draft its layer 0 (``spec_lm``), k = SPEC_K; BATCH sequences of CTX
tokens prefilled, 2 rounds untimed (the first re-prefills the draft),
then STEPS rounds unprofiled and STEPS profiled (``spec_decode``: the
draft's catch-up steps, its fused k-step proposal, the target's verify
of B x (k + 1) rows): host ms a round, device ms, idle share, K7 / K8 ms
and traced launches a round, the accept rate and tokens a round; then
one proposal and one verify profiled alone.

Run on a CUDA machine from the repository root:

    python -m paddle_tpu_torch.tools.profile_serve [--quant int8] \
        [--prefix | --spec]

Prints one JSON line.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import re
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from ..serving import (FLAGSHIP_LM, GenerativeEngine, GenRequest, LMConfig,
                       tiny_lm)

BATCH, CTX, STEPS = 16, 1024, 8
SYSTEM, SUFFIX = 768, 256
# the speculative construction of the reference's serving bench
# (tools/serve_bench.py), at the flagship's width: a draft of the
# target's layer 0 predicts its greedy tokens most of the time
SPEC_K, SPEC_DAMP = 8, 0.002
# the serving kernels' symbols in a trace: K1's f32 form, K7's span
# kernel (one a call; its combine follows when a row has more than one
# span), K8's decode and prefill forms (the prefill form is the
# split-TF32 GEMM tile K4 shares, which no serving step runs for K4)
SERVE_SYMBOLS = {"flash_fwd": ("flash_fwd_kernel",),
                 "paged_attention": ("span_kernel",),
                 "matmul_int8": ("mm_int8_skinny", "gemm::gemm_kernel")}


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


def traced_launches(prof, n):
    """{serving kernel: launches a step} over ``n`` steps of a profile,
    by kernel symbol (``SERVE_SYMBOLS``); None when the trace holds no
    device event."""
    events = [e for e in prof.events()
              if getattr(e, "device_type", None) == DeviceType.CUDA]
    if not events:
        return None
    return {name: sum(any(sym in e.name for sym in syms)
                      for e in events) / n
            for name, syms in SERVE_SYMBOLS.items()}


def _kernel_ms(spans, syms):
    return _union_ms([(s, e) for name, s, e in spans
                      if any(sym in name for sym in syms)])


def spec_lm(params, damp=SPEC_DAMP):
    """(target params, draft config, draft params) over the flagship's
    ``params``: the target's layers 1.. have ``wo`` and ``w2`` scaled
    by ``damp``; the draft is layer 0 with the shared embeddings, final
    LayerNorm and head."""
    target = dict(params)
    for l in range(1, FLAGSHIP_LM["n_layers"]):
        for w in ("wo", "w2"):
            target["l%d.%s" % (l, w)] = target["l%d.%s" % (l, w)] * damp
    draft = {k: v for k, v in target.items()
             if not re.match(r"l[0-9]+\.", k) or k.startswith("l0.")}
    return target, LMConfig(**dict(FLAGSHIP_LM, n_layers=1)), draft


def _acts():
    return [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]


def _profiled(fn, n):
    """Device numbers of ``n`` calls of ``fn`` under torch.profiler:
    ({device ms, K7 ms, K8 ms a call, traced launches a call}, the top
    kernels), "not measured" where the trace holds no device time."""
    with torch.profiler.profile(activities=_acts()) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    kernels = _by_kernel(prof, n)
    spans = _device_intervals(prof)
    if not kernels:
        return {"device_ms": "not measured"}, "not measured"
    top = dict(sorted(kernels.items(),
                      key=lambda kv: -kv[1]["ms_per_step"])[:12])
    return {"device_ms": _union_ms([(s, e) for _, s, e in spans]) / n,
            "paged_attention_ms": _kernel_ms(
                spans, SERVE_SYMBOLS["paged_attention"]) / n,
            "matmul_int8_ms": _kernel_ms(
                spans, SERVE_SYMBOLS["matmul_int8"]) / n,
            "traced_launches": traced_launches(prof, n)}, top


def _measured(fn, n):
    """``fn`` n times unprofiled (host ms, a synchronize at each end,
    median), then n times profiled (``_profiled``); the idle share is
    of the unprofiled call."""
    ms = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    med = float(np.median(ms))
    dev, top = _profiled(fn, n)
    if dev["device_ms"] != "not measured":
        dev["device_idle_share"] = 1.0 - dev["device_ms"] / med
    return dict(host_ms_median=med, **dev), top


def prefix_main(args, cfg, params):
    """The --prefix measurement: one suffix prefill beside the cold
    prefill of its prompt."""
    rng = np.random.RandomState(args.seed + 1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = GenerativeEngine(cfg, params, quant=args.quant, kv_blocks=512,
                           device="cuda", prefix_cache=True)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    system = rng.randint(0, cfg.vocab, SYSTEM).tolist()
    seed = GenRequest(system + rng.randint(0, cfg.vocab, 16).tolist(), 1,
                      None, None)
    assert eng.prefix_cache.acquire(seed)
    eng.prefill(seed)
    eng.prefix_cache.insert(seed)
    eng.free_sequence(seed)
    prompt = system + rng.randint(0, cfg.vocab, SUFFIX).tolist()
    req = GenRequest(prompt, 1, None, None)
    assert eng.prefix_cache.acquire(req)
    start = req.cached_len
    suffix, suffix_top = _measured(
        lambda: eng._prefill_suffix(prompt, req.blocks, start), STEPS)
    blocks = eng.pool.alloc(eng.pool.blocks_for(len(prompt)))
    cold, cold_top = _measured(
        lambda: eng.prefill_tokens(prompt, blocks), STEPS)
    out = {"device": torch.cuda.get_device_name(0), "quant": args.quant,
           "mode": "prefix", "prompt_tokens": len(prompt), "cached": start,
           "suffix_rows": len(prompt) - start, "load_s": load_s,
           "capture_s": eng.capture_seconds,
           "memory_reserved_bytes": torch.cuda.memory_reserved(),
           "suffix_prefill": suffix, "cold_prefill": cold,
           "suffix_kernels": suffix_top, "cold_kernels": cold_top,
           "same_first_token": eng._prefill_suffix(prompt, req.blocks,
                                                   start)
           == eng.prefill_tokens(prompt, blocks)}
    eng.free_sequence(req)
    eng.pool.free(blocks)
    eng.close()
    return out


def spec_main(args, cfg, params):
    """The --spec measurement: speculative rounds over BATCH sequences,
    then one proposal and one verify alone."""
    target, dcfg, dparams = spec_lm(params)
    k = SPEC_K
    rounds = 2 + 2 * STEPS
    per_seq = -(-(CTX + (rounds + 2) * (k + 1)) // cfg.block_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = GenerativeEngine(cfg, target, quant=args.quant,
                           kv_blocks=BATCH * per_seq + 1, device="cuda",
                           spec_k=k, draft=(dcfg, dparams))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    rng = np.random.RandomState(args.seed + 1)
    seqs = []
    for _ in range(BATCH):
        req = GenRequest(rng.randint(0, cfg.vocab, CTX).tolist(), 1 << 10,
                         None, None)
        req.blocks = eng.pool.alloc(per_seq)
        req.out.append(eng.prefill(req))
        seqs.append(req)
    emitted = []

    def spec_round():
        out = eng.spec_decode(seqs)
        for s, toks in zip(seqs, out):
            s.out.extend(toks)
        emitted.append(sum(len(t) for t in out))

    for _ in range(2):
        spec_round()
    acc0, prop0 = eng.spec_accepted, eng.spec_proposed
    del emitted[:]
    round_, round_top = _measured(spec_round, STEPS)
    d = eng.draft
    props = d.propose_step([s.blocks for s in seqs],
                           [s.draft_len for s in seqs],
                           [s.out[-1] for s in seqs], k)
    propose, _ = _profiled(lambda: d.propose_step(
        [s.blocks for s in seqs], [s.draft_len for s in seqs],
        [s.out[-1] for s in seqs], k), 1)
    verify, _ = _profiled(lambda: eng.verify_step(seqs, props), 1)
    out = {"device": torch.cuda.get_device_name(0), "quant": args.quant,
           "mode": "spec", "k": k, "damp": SPEC_DAMP, "batch": BATCH,
           "ctx": CTX, "load_s": load_s,
           "capture_s": eng.capture_seconds + d.capture_seconds,
           "memory_reserved_bytes": torch.cuda.memory_reserved(),
           "round": round_, "round_kernels": round_top,
           "accept_rate": (eng.spec_accepted - acc0)
           / (eng.spec_proposed - prop0),
           "tokens_per_round": float(np.mean(emitted)),
           "propose": propose, "verify": verify,
           "tokens_sha1": hashlib.sha1(json.dumps(
               [s.out for s in seqs]).encode()).hexdigest()}
    for s in seqs:
        eng.free_sequence(s)
    eng.close()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--quant", default="")
    ap.add_argument("--seed", type=int, default=0)
    mode = ap.add_mutually_exclusive_group()
    mode.add_argument("--prefix", action="store_true",
                      help="one suffix prefill beside the cold prefill")
    mode.add_argument("--spec", action="store_true",
                      help="one speculative round (propose + verify)")
    args = ap.parse_args(argv)
    if args.prefix or args.spec:
        cfg, params = tiny_lm(args.seed, **FLAGSHIP_LM)
        run = prefix_main if args.prefix else spec_main
        print(json.dumps(run(args, cfg, params)))
        return

    cfg, params = tiny_lm(args.seed, **FLAGSHIP_LM)
    per_seq = -(-(CTX + 2 * STEPS + 4) // cfg.block_size)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng = GenerativeEngine(cfg, params, quant=args.quant,
                           kv_blocks=(BATCH + 1) * per_seq + 1,
                           device="cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    reserved = torch.cuda.memory_reserved()
    rng = np.random.RandomState(args.seed + 1)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]

    def request():
        req = GenRequest(rng.randint(0, cfg.vocab, CTX).tolist(),
                         2 * STEPS + 4, None, None)
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
    prefill_spans = _device_intervals(prof)
    prefill_launches = traced_launches(prof, 1)
    eng.free_sequence(extra)

    def step():
        for s, t in zip(seqs, eng.decode(seqs)):
            s.out.append(int(t))

    for _ in range(2):
        step()
    torch.cuda.synchronize()
    step_ms = []
    for _ in range(STEPS):
        t0 = time.perf_counter()
        step()            # ends in a device-to-host copy of tokens
        step_ms.append((time.perf_counter() - t0) * 1e3)
    prof_ms = []
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(STEPS):
            t0 = time.perf_counter()
            step()
            prof_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
    kernels = _by_kernel(prof, STEPS)
    spans = _device_intervals(prof)
    busy = _union_ms([(s, e) for _, s, e in spans]) / STEPS
    med, prof_med = float(np.median(step_ms)), float(np.median(prof_ms))
    top = dict(sorted(kernels.items(),
                      key=lambda kv: -kv[1]["ms_per_step"])[:12])
    launches = traced_launches(prof, STEPS)
    measured = bool(kernels)

    def dev(value):
        return value if measured else "not measured"

    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "quant": args.quant,
        "batch": BATCH, "ctx": CTX, "steps": STEPS,
        "load_s": load_s,
        "capture_s": getattr(eng, "capture_seconds", "not captured"),
        "memory_reserved_bytes": reserved,
        "replays": getattr(eng, "replays", "not captured"),
        "prefill_ms_median": float(np.median(prefill_ms)),
        "step_ms_median": med,
        "profiled_step_ms_median": prof_med,
        "device_ms_per_step": dev(busy),
        "device_idle_share": dev(1.0 - busy / med),
        "device_idle_share_profiled": dev(1.0 - busy / prof_med),
        "paged_attention_ms_per_step": dev(
            _kernel_ms(spans, SERVE_SYMBOLS["paged_attention"]) / STEPS),
        "matmul_int8_ms_per_step": dev(
            _kernel_ms(spans, SERVE_SYMBOLS["matmul_int8"]) / STEPS),
        "traced_launches_per_step": launches or "not measured",
        "kernels": top or "not measured",
        "prefill_device_ms": dev(_union_ms(
            [(s, e) for _, s, e in prefill_spans])),
        "prefill_matmul_int8_ms": dev(
            _kernel_ms(prefill_spans, SERVE_SYMBOLS["matmul_int8"])),
        "prefill_traced_launches": prefill_launches or "not measured",
        "prefill_kernels": prefill_kernels or "not measured",
        "tokens_sha1": hashlib.sha1(json.dumps(
            [s.out for s in seqs]).encode()).hexdigest()}))
    for s in seqs:
        eng.free_sequence(s)
    eng.close()


if __name__ == "__main__":
    main()
