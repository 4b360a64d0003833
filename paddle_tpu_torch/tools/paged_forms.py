"""Time forms of the paged-decode kernel K7 at the same shapes on the
card.

``paged_attention.cu`` splits each row's live pages into spans of P
pages, streams a span's pages through a ring of cp.async stages and
folds the spans in a second launch; the product runs one form
(``paged::Product``).  This tool compiles, beside the product library,
one translation unit that includes the kernel's source and exports a
launcher for every form of ``FORMS`` (P in {4, 8, 16, 32} pages a span,
3, 4 or 6 ring stages, 4 or 8 warps), each in three shapes of the
combine: the product's second launch, programmatic (scheduled while
the span kernel runs); the same second launch issued plainly after it;
and one launch in which the last span of a (sequence, head) to finish
folds the row, found by a self-resetting ticket.  It times every form
on the same inputs (CUDA events, median of single calls, L2 flushed
before each) and holds each against the plain version at atol = rtol =
1e-4, at B in {1, 2, 4, 8, 16} times contexts uniform 128, 1024 and
2048 tokens and mixed 16-2048 (seeded), H = 8, D = 128, bs = 16, NB
the power-of-2 bucket of the longest row, every live page a distinct
page of a pool of B x NB + 1, so the bytes bound counts bytes that come
from device memory.

Run on a CUDA machine from the repository root:

    python -m paddle_tpu_torch.tools.paged_forms

Prints ptxas's summary per kernel, one JSON line per shape (each
form's ms and agreement in each combine, the product wrapper's ms cold
and with the inputs left in L2, the bytes bound, and the timer's floor:
one small elementwise kernel on the lengths, timed the same way), then
the card's name and power limit.

    python -m paddle_tpu_torch.tools.paged_forms --calls SMOKE_LOG

times the forms instead at the K7 calls that the serve phases of a
``chip_smoke.py`` run logged (``paged_calls`` in its output, saved to
SMOKE_LOG: one call a decode step, its batch and block-count buckets
and its rows' lengths), in the product's combine on distinct pages,
each held to the plain version; it prints one JSON line per (B, NB)
bucket and one of the totals, each form's ms summed over the logged
steps, fastest first.

    python -m paddle_tpu_torch.tools.paged_forms --replay

times the product wrapper alone (no forms are built) at the grid's
shapes as the serving engine runs it: REPLAY_CALLS calls captured as
one CUDA graph and replayed (``replayed_ms``: a call's share of a
replay, no host launch between the calls), beside single calls with
the inputs left in L2 (``product_warm_ms``), and the timer's floor
(the elementwise kernel on the lengths) timed both ways.
"""
from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys

import numpy as np
import torch

from .. import resolve_device
from ..kernels import _build
from ..kernels.flash_attention import (paged_attention,
                                       paged_attention_reference)
from .gemm_forms import Timer

TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
H, D, BS = 8, 128, 16
# (P pages a span, ring stages, warps a block)
FORMS = tuple((p, st, nw) for p in (4, 8, 16, 32) for st in (3, 4, 6)
              for nw in (4, 8))
BATCHES = (1, 2, 4, 8, 16)
# the combine's shapes, by the exporter's mode number
COMBINES = ("two_launch", "one_launch", "two_plain_launches")
CONTEXTS = ("uniform 128", "uniform 1024", "uniform 2048", "mixed 16-2048")


def _source():
    cases = "\n".join(
        "    case %d: return run<Form<%d, %d, %d>>(mode, a, t, s);"
        % ((i,) + f) for i, f in enumerate(FORMS))
    return r'''
#include "%s/paged_attention.cu"
using namespace paged;

// the one-launch combine: the last live span of a (b, h) to finish
// folds the row, and resets its ticket for the next call
template <class F>
__global__ void __launch_bounds__(F::THREADS)
span_ticket_kernel(const Args a, int* tickets) {
  extern __shared__ float4 smem4[];
  __shared__ int last;
  const int h = blockIdx.y, b = blockIdx.z;
  const int n = (live_pages(a.lens[b], a.NB) + F::P - 1) / F::P;
  if ((int)blockIdx.x >= n) return;
  span_pass<F>(a, reinterpret_cast<float*>(smem4));
  if (n == 1) return;
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0) {
    int* t = tickets + b * a.H + h;
    last = atomicAdd(t, 1) == n - 1;
    if (last) *t = 0;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  for (int d = threadIdx.x; d < D; d += F::THREADS)
    combine_pass(a, b, h, n, d);
}

template <class F>
cudaError_t launch_ticket(const Args& a, int* tickets, cudaStream_t s) {
  if (a.S != (a.NB + F::P - 1) / F::P) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      span_ticket_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      F::SMEM);
  if (err != cudaSuccess) return err;
  span_ticket_kernel<F><<<dim3(a.S, a.H, a.B), F::THREADS, F::SMEM, s>>>(
      a, tickets);
  return cudaGetLastError();
}

// the second launch issued plainly, not programmatically
template <class F>
cudaError_t launch_plain(const Args& a, cudaStream_t s) {
  if (a.S != (a.NB + F::P - 1) / F::P) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      span_kernel<F>, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (err != cudaSuccess) return err;
  span_kernel<F><<<dim3(a.S, a.H, a.B), F::THREADS, F::SMEM, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.S == 1) return err;
  combine_kernel<F::P><<<dim3(a.H, a.B), D, 0, s>>>(a);
  return cudaGetLastError();
}

// mode 0: the product's launch; 1: one launch; 2: two plain launches
template <class F>
cudaError_t run(int mode, const Args& a, int* tickets, cudaStream_t s) {
  return mode == 0 ? launch<F>(a, s)
         : mode == 1 ? launch_ticket<F>(a, tickets, s)
                     : launch_plain<F>(a, s);
}

extern "C" int paged_form_f32(int form, int mode, const float* q,
                              const float* kp, const float* vp,
                              const int* tables, const int* lens, float* out,
                              float* part, int* t, int B, int H, int NB,
                              int spans, float scale, void* stream) {
  const Args a{q, kp, vp, tables, lens, out, part, B, H, NB, spans, scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
%s
  }
  return (int)cudaErrorInvalidValue;
}
''' % (_build.CSRC, cases)


def build():
    """Compile the form exporter into ``_build/forms/``; returns its
    ctypes entry and ptxas's summary per kernel."""
    out = os.path.join(_build.BUILD_DIR, "forms")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "paged_forms.cu")
    with open(src, "w") as f:
        f.write(_source())
    lib = os.path.join(out, "paged_forms.so")
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n%s" % proc.stdout[-4000:])
    fn = ctypes.CDLL(lib).paged_form_f32
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                   + [ctypes.c_int] * 4 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn, _build._ptxas_summary(proc.stdout)


def lengths(b, context, rng):
    if context == "mixed 16-2048":
        return rng.randint(16, 2049, size=b)
    return np.full(b, int(context.split()[1]))


def case(b, lens, gen, nb=None):
    """q, pages, tables (every live page distinct, the rest page 0) and
    lens at NB (by default the power-of-2 bucket of the longest row)."""
    pages = -(-lens // BS)
    nb = nb or 1 << int(pages.max() - 1).bit_length()
    n = b * nb + 1
    q = torch.randn(b, H, D, device="cuda", generator=gen)
    kp = torch.randn(n, BS, H, D, device="cuda", generator=gen)
    vp = torch.randn(n, BS, H, D, device="cuda", generator=gen)
    ids = torch.randperm(n - 1, device="cuda", generator=gen).reshape(b, nb)
    live = torch.arange(nb, device="cuda")[None] < torch.from_numpy(
        pages).cuda()[:, None]
    tables = torch.where(live, ids + 1, 0).to(torch.int32)
    return q, kp, vp, tables, torch.from_numpy(lens.astype(np.int32)).cuda()


def bound_ms(lens, b, nb):
    """Bytes once over the HBM rate: the live K/V positions (every page
    distinct), q, out and the tables (chip_smoke.py's K7 count)."""
    live = int(lens.sum())
    nbytes = 4 * (2 * live * H * D + 2 * b * H * D) + 4 * b * (nb + 1)
    return nbytes / HBM_BYTES_PER_S * 1e3


def warm(fn, iters=15):
    """Median CUDA-event time of single calls whose inputs the previous
    call left in L2, the card kept busy while the host enqueues."""
    fn()
    times = []
    for _ in range(iters):
        torch.cuda._sleep(2_000_000)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[iters // 2]


REPLAY_CALLS = 20


def replayed(fn, calls=REPLAY_CALLS, iters=15):
    """Median CUDA-event time of one call of ``fn`` when ``calls`` calls
    run back to back as one captured CUDA graph: the inputs left in L2
    by the call before, and no host launch in between."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    times = []
    for _ in range(iters):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return sorted(times)[iters // 2]


def time_replay(gen):
    """The product wrapper at B x contexts, replayed and single; one
    JSON line a shape."""
    rng = np.random.RandomState(0)
    for context in CONTEXTS:
        for b in BATCHES:
            lens = lengths(b, context, rng)
            q, kp, vp, tables, lens_t = case(b, lens, gen)
            nb = tables.shape[1]

            def call():
                return paged_attention(q, kp, vp, tables, lens_t)

            def floor():
                return lens_t + 1

            print(json.dumps({
                "kernel": "paged_attention", "B": b, "context": context,
                "NB": nb, "bound_ms": bound_ms(lens, b, nb),
                "replay_calls": REPLAY_CALLS,
                "replayed_ms": replayed(call),
                "product_warm_ms": warm(call),
                "floor_replayed_ms": replayed(floor),
                "floor_warm_ms": warm(floor)}), flush=True)
            del q, kp, vp, tables, lens_t
            torch.cuda.empty_cache()


def serve_calls(path):
    """{(B, NB, lengths of all B rows): decode steps} from the
    ``paged_calls`` that chip_smoke.py's serve phases print; a padding
    row attends over one position."""
    calls = {}
    with open(path) as f:
        for line in f:
            if not line.startswith("{"):
                continue
            for c in json.loads(line).get("paged_calls", ()):
                b, nb, lens = c[0], c[1], list(c[2:])
                key = (b, nb) + tuple(lens + [1] * (b - len(lens)))
                calls[key] = calls.get(key, 0) + 1
    return calls


def time_calls(fn, timer, calls, gen):
    """Every form, in the product's combine, at every logged call; one
    JSON line per (B, NB) bucket and one of the totals (ms summed over
    the decode steps, one K7 call each)."""
    p = _build.ptr
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    scale = D ** -0.5
    groups, ok = {}, True
    for key, steps in sorted(calls.items()):
        b, nb, lens = key[0], key[1], np.array(key[2:])
        q, kp, vp, tables, lens_t = case(b, lens, gen, nb)
        want = paged_attention_reference(q, kp, vp, tables, lens_t, scale)
        out = torch.empty_like(q)
        g = groups.setdefault((b, nb), {"B": b, "NB": nb, "steps": 0,
                                        "forms": {}})
        g["steps"] += steps
        for f, (pp, stages, nw) in enumerate(FORMS):
            part = torch.empty(b, H, -(-nb // pp), D + 2, device="cuda")

            def call(f=f, pp=pp, part=part):
                _build.check(fn(
                    f, 0, p(q), p(kp), p(vp), p(tables), p(lens_t),
                    p(out), p(part), None, b, H, nb, -(-nb // pp), scale,
                    st()), "paged_form_f32")
            out.fill_(float("nan"))
            call()
            ok = ok and bool(torch.allclose(out, want, atol=TOL, rtol=TOL))
            name = "P%d s%d w%d" % (pp, stages, nw)
            g["forms"][name] = g["forms"].get(name, 0.0) + \
                steps * timer(call)
        del q, kp, vp, tables, lens_t, want, out
        torch.cuda.empty_cache()
    total = {}
    for g in groups.values():
        for name, ms in g["forms"].items():
            total[name] = total.get(name, 0.0) + ms
        print(json.dumps(g), flush=True)
    print(json.dumps({"kernel": "paged_attention", "serve_calls": True,
                      "steps": sum(calls.values()),
                      "distinct_calls": len(calls), "all_ok": ok,
                      "total_ms": dict(sorted(total.items(),
                                              key=lambda kv: kv[1]))}),
          flush=True)


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if not torch.cuda.is_available():
        raise SystemExit("paged_forms needs a CUDA card")
    resolve_device("cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    if argv[:1] == ["--replay"]:
        time_replay(gen)
    else:
        fn, ptxas = build()
        for sym, line in sorted(ptxas.items()):
            print(json.dumps({"kernel": sym, "ptxas": line}), flush=True)
        if argv[:1] == ["--calls"]:
            time_calls(fn, Timer(), serve_calls(argv[1]), gen)
        else:
            time_grid(fn, Timer(), gen)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)


def time_grid(fn, timer, gen):
    """Every form in every combine at B x contexts; one JSON line a
    shape."""
    rng = np.random.RandomState(0)
    p = _build.ptr
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    scale = D ** -0.5
    for context in CONTEXTS:
        for b in BATCHES:
            lens = lengths(b, context, rng)
            q, kp, vp, tables, lens_t = case(b, lens, gen)
            nb = tables.shape[1]
            want = paged_attention_reference(q, kp, vp, tables, lens_t,
                                             scale)
            product = paged_attention(q, kp, vp, tables, lens_t)
            row = {"kernel": "paged_attention", "B": b, "context": context,
                   "NB": nb, "live_positions": int(lens.sum()),
                   "bound_ms": bound_ms(lens, b, nb),
                   "product_ok": bool(torch.allclose(product, want,
                                                     atol=TOL, rtol=TOL)),
                   "product_ms": timer(lambda: paged_attention(
                       q, kp, vp, tables, lens_t)),
                   "product_warm_ms": warm(lambda: paged_attention(
                       q, kp, vp, tables, lens_t)),
                   "floor_ms": timer(lambda: lens_t + 1), "forms": {}}
            out = torch.empty_like(q)
            tickets = torch.zeros(b * H, dtype=torch.int32, device="cuda")
            for f, (pp, stages, nw) in enumerate(FORMS):
                spans = -(-nb // pp)
                part = torch.empty(b, H, spans, D + 2, device="cuda")
                res = {}
                for mode, key in enumerate(COMBINES):
                    def call(mode=mode, spans=spans, part=part, f=f):
                        _build.check(fn(
                            f, mode, p(q), p(kp), p(vp), p(tables),
                            p(lens_t), p(out), p(part), p(tickets), b, H,
                            nb, spans, scale, st()), "paged_form_f32")
                    out.fill_(float("nan"))
                    call()
                    res[key + "_ok"] = bool(torch.allclose(
                        out, want, atol=TOL, rtol=TOL))
                    res[key + "_same_bits_as_product"] = bool(
                        torch.equal(out, product))
                    res[key + "_ms"] = timer(call)
                row["forms"]["P%d s%d w%d" % (pp, stages, nw)] = res
            best = min(row["forms"].items(),
                       key=lambda kv: kv[1]["two_launch_ms"])
            row["fastest_two_launch"] = best[0]
            print(json.dumps(row), flush=True)
            del q, kp, vp, tables, lens_t, want, product, out
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
