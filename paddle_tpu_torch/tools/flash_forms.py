"""Time the tile forms of K1 (f32 and bf16), K9, and K2 and K3 (bf16) at
the same shapes on the card.

``flash_fwd.cu`` and ``flash_chunk.cu`` each pick one of two tile
forms from the grid, inside their C launcher: Small (64 x 16 tiles,
4 warps, two blocks an SM) or Large (128 x 32, 8 warps, one block an
SM), Large when its blocks give every SM one (``use_large`` in
``flash_tile.cuh``).  The product has no way to force a form.  This tool compiles, beside the product libraries, one more
translation unit per kernel that includes the kernel's source and
exports its launcher for either form, then times both forms on the same
inputs (CUDA events, median of single calls, L2 flushed before each)
and holds each against the plain version at atol = rtol = 1e-4:

- K1 causal at the serving prefill shapes [1, 8, 256, 128] and
  [1, 8, 2048, 128], at the training shape [16, 8, 2048, 128], and on a
  sweep of head counts at T = 2048 around the switch (bh x 16 Large
  blocks against the SM count: 8 heads take Small, 12 Large);
- K9 at the ring's shard [16, 8, 512, 128], diagonal (causal,
  k_offset 0) and non-causal;
- K1's bf16 form (``--bf16``, the wgmma kernel of ``flash_bf16.cuh``'s
  ``f16``, built in ``flash_fwd.cu``: Wide, 128 query rows a block, when its blocks give every SM
  one, else Narrow, 64) in both forms at [1, 8, 256, 128], [1, 8, 2048, 128]
  and [16, 8, 2048, 128] causal, each held within one bf16 ulp plus
  2**-12 of max |plain| on O and at atol = rtol = 1e-4 on the LSE,
  beside SDPA in bf16 and the time of the ``mma.sync`` form it replaced
  (``REPLACED_BF16_MS``, PERF.md);
- K2's and K3's bf16 forms (``--bwd``, the wgmma kernels of
  ``flash_bwd.cu``'s ``b16``: Wide, 128 resident rows a block, when its
  blocks give every SM one, else Narrow, 64) in both forms at
  [1, 8, 256, 128] and [16, 8, 2048, 128] causal, each gradient held
  within one bf16 ulp plus 2**-12 of max |plain|, beside SDPA's bf16
  backward (the whole backward, dQ, dK and dV) and the times of the
  ``mma.sync`` forms they replaced (``REPLACED_BWD_MS``, PERF.md).

Run on a CUDA machine from the repository root:

    python -m paddle_tpu_torch.tools.flash_forms [--bf16 | --bwd]

Prints one JSON line per shape, then the card's name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import math
import os
import subprocess

import torch

from ..kernels import _build
from ..kernels.flash_attention import (NEG_INF, attention_reference,
                                       chunk_update_reference)

FORMS = ("small", "large")
TOL = 1e-4
# Large<128>::BQ, the rows a Large block owns
LARGE_BQ = 128
# the rows a Wide block owns: f16::Wide::BQ (K1's bf16 form) and
# b16::Wide::BR (K2's and K3's)
WIDE_ROWS = 128
# the bf16 bar's floor, of max |plain| (chip_smoke.py's FLASH_BF16_FLOOR)
BF16_FLOOR = 2.0 ** -12

_K1 = r'''
#include "%s/flash_fwd.cu"
extern "C" int flash_fwd_form(const float* q, const float* k,
                              const float* v, float* out, float* lse,
                              int bh, int t, int tk, float scale, int causal,
                              int large, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(large ? launch<Large<128>>(q, k, v, out, lse, bh, t, tk,
                                          scale, causal, s)
                     : launch<Small<128>>(q, k, v, out, lse, bh, t, tk,
                                          scale, causal, s));
}
'''
# K1's bf16 forms (name, f16 form): Wide (128 query rows a block, two
# warpgroups taking turns) and Narrow (64)
BF16_FORMS = (("wide", "Wide"), ("narrow", "Narrow"))
# K1's bf16 form on mma.sync, which the wgmma kernel replaced (PERF.md
# section 6, chip_smoke.py's phase 3; NVIDIA H100 80GB HBM3, 700 W)
REPLACED_BF16_MS = {(1, 8, 256): 0.0158, (16, 8, 2048): 0.8332}

_K1_BF16 = r'''
#include "%%s/flash_fwd.cu"
extern "C" int flash_fwd_bf16_form(int form, const tc::bf16* q,
                                   const tc::bf16* k, const tc::bf16* v,
                                   tc::bf16* out, float* lse, int bh, int t,
                                   int tk, float scale, int causal,
                                   void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
%s
  }
  return (int)cudaErrorInvalidValue;
}
''' % "\n".join(
    "    case %d: return (int)f16::launch<f16::%s, false>(q, k, v, out, "
    "lse, f16::Carry{}, bh, t, tk, scale, causal, 0, s);" % (i, f)
    for i, (_, f) in enumerate(BF16_FORMS))
# K2's and K3's bf16 forms on mma.sync, which the wgmma kernels
# replaced (PERF.md section 6, chip_smoke.py's phase 3; NVIDIA H100 80GB
# HBM3, 700 W): {(b, h, t): (dq ms, dkv ms)}
REPLACED_BWD_MS = {(1, 8, 256): (0.0165, 0.0231),
                   (16, 8, 2048): (0.9376, 1.4432)}

_BWD_BF16 = r'''
#include "%%s/flash_bwd.cu"
extern "C" int flash_bwd_dq_bf16_form(int form, const tc::bf16* q,
                                      const tc::bf16* k, const tc::bf16* v,
                                      const tc::bf16* dout, const float* lse,
                                      const float* delta, tc::bf16* dq,
                                      int bh, int t, int tk, float scale,
                                      int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
%s
  }
  return (int)cudaErrorInvalidValue;
}
extern "C" int flash_bwd_dkv_bf16_form(int form, const tc::bf16* q,
                                       const tc::bf16* k,
                                       const tc::bf16* v,
                                       const tc::bf16* dout,
                                       const float* lse, const float* delta,
                                       tc::bf16* dk, tc::bf16* dv, int bh,
                                       int t, int tk, float scale,
                                       int causal, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
%s
  }
  return (int)cudaErrorInvalidValue;
}
''' % ("\n".join(
    "    case %d: return (int)b16::launch_dq<b16::%s>(q, k, v, dout, lse, "
    "delta, dq, bh, t, tk, scale, causal, 0, s);" % (i, f)
    for i, (_, f) in enumerate(BF16_FORMS)), "\n".join(
    "    case %d: return (int)b16::launch_dkv<b16::%s>(q, k, v, dout, lse, "
    "delta, dk, dv, bh, t, tk, scale, causal, 0, s);" % (i, f)
    for i, (_, f) in enumerate(BF16_FORMS)))
_K9 = r'''
#include "%s/flash_chunk.cu"
extern "C" int flash_chunk_form(const float* q, const float* k,
                                const float* v, const float* m_in,
                                const float* l_in, const float* acc_in,
                                float* m_out, float* l_out, float* acc_out,
                                int bh, int t, int tk, float scale,
                                int causal, int k_offset, int large,
                                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(large ? launch<Large<128>>(q, k, v, m_in, l_in, acc_in,
                                          m_out, l_out, acc_out, bh, t, tk,
                                          scale, causal, k_offset, s)
                     : launch<Small<128>>(q, k, v, m_in, l_in, acc_in,
                                          m_out, l_out, acc_out, bh, t, tk,
                                          scale, causal, k_offset, s));
}
'''


def build():
    """Compile the form exporters (one nvcc each, started together) into
    ``_build/forms/``; returns their ctypes entries (K1, K9, K1 bf16)
    and ptxas's summary per kernel."""
    out = os.path.join(_build.BUILD_DIR, "forms")
    os.makedirs(out, exist_ok=True)
    nvcc = _build.nvcc_path()
    procs = {}
    for name, text in (("k1", _K1), ("k9", _K9), ("k1_bf16", _K1_BF16),
                       ("bwd_bf16", _BWD_BF16)):
        src = os.path.join(out, name + "_forms.cu")
        with open(src, "w") as f:
            f.write(text % _build.CSRC)
        lib = os.path.join(out, name + "_forms.so")
        procs[name] = (subprocess.Popen(
            [nvcc, *_build.NVCC_FLAGS, "-o", lib, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    fns, ptxas = {}, {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError("nvcc failed for %s:\n%s" % (name, log[-4000:]))
        fns[name] = ctypes.CDLL(lib)
        ptxas.update(_build._ptxas_summary(log))
    k1, k9 = fns["k1"].flash_fwd_form, fns["k9"].flash_chunk_form
    k1b = fns["k1_bf16"].flash_fwd_bf16_form
    k1b.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5
                    + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                            ctypes.c_void_p])
    k1b.restype = ctypes.c_int
    k1.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 2 + [ctypes.c_void_p])
    k9.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 3
                   + [ctypes.c_float] + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    k1.restype = k9.restype = ctypes.c_int
    lib = fns["bwd_bf16"]
    k23b = lib.flash_bwd_dq_bf16_form, lib.flash_bwd_dkv_bf16_form
    for n_out, fn in zip((1, 2), k23b):
        fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * (6 + n_out)
                       + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_int,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return k1, k9, k1b, k23b, ptxas


class Timer:
    """Median CUDA-event time of single calls, the L2 flushed (a 64 MiB
    read) before each and the card kept busy while the host enqueues."""

    def __init__(self):
        self.flush = torch.ones(16 << 20, device="cuda")

    def __call__(self, fn, iters=25, warmup=3):
        for _ in range(warmup):
            fn()
        times = []
        for _ in range(iters):
            self.flush.sum()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        return times[len(times) // 2]


def _close(got, want):
    return bool(torch.allclose(got, want, atol=TOL, rtol=TOL))


def bf16_forms(k1b, timer, sms):
    """K1's bf16 form in each of BF16_FORMS at the LM's shapes."""
    import torch.nn.functional as F

    from ..kernels.conv_fused import within_bf16_ulp
    from ..kernels.flash_attention import flash_fwd_bf16

    gen = torch.Generator(device="cuda").manual_seed(0)
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = _build.ptr
    d = 128
    scale = 1.0 / math.sqrt(d)
    for b, h, t in ((1, 8, 256), (1, 8, 2048), (16, 8, 2048)):
        bh = b * h
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   .bfloat16() for _ in range(3))
        out = torch.empty_like(q)
        lse = torch.empty(b, h, t, device="cuda")
        ro, rl = attention_reference(q, k, v, scale, True)
        row = {"kernel": "flash_fwd_bf16", "shape": [b, h, t, d],
               "causal": True,
               "launcher_picks": ("wide" if bh * -(-t // WIDE_ROWS) >= sms
                                  else "narrow"),
               "replaced_ms": REPLACED_BF16_MS.get((b, h, t)),
               "product_ms": timer(lambda: flash_fwd_bf16(q, k, v,
                                                          causal=True)),
               "library_ms": timer(lambda: F.scaled_dot_product_attention(
                   q, k, v, is_causal=True))}
        for f, (name, _) in enumerate(BF16_FORMS):
            call = lambda: _build.check(k1b(
                f, p(q), p(k), p(v), p(out), p(lse), bh, t, t, scale, 1,
                st()), "flash_fwd_bf16_form")
            call()
            row[name + "_ok"] = within_bf16_ulp(out, ro, BF16_FLOOR)[1] \
                and _close(lse, rl)
            row[name + "_ms"] = timer(call)
        print(json.dumps(row), flush=True)
        del q, k, v, out, lse, ro, rl


def bwd_forms(k23b, timer, sms):
    """K2's and K3's bf16 forms in each of BF16_FORMS at the LM's
    shapes."""
    import torch.nn.functional as F

    from ..kernels.conv_fused import within_bf16_ulp
    from ..kernels.flash_attention import (flash_attention_bwd_reference,
                                           flash_bwd_dkv_bf16,
                                           flash_bwd_dq_bf16, flash_delta)

    gen = torch.Generator(device="cuda").manual_seed(0)
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = _build.ptr
    d = 128
    scale = 1.0 / math.sqrt(d)

    def within(got, want):
        return within_bf16_ulp(got, want, BF16_FLOOR)[1]

    for b, h, t in ((1, 8, 256), (16, 8, 2048)):
        bh = b * h
        q, k, v, do = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                       .bfloat16() for _ in range(4))
        out, lse = attention_reference(q, k, v, scale, True)
        delta = flash_delta(do, out)
        want = flash_attention_bwd_reference(q, k, v, out, lse, do, scale,
                                             True)
        qg, kg, vg = (x.detach().requires_grad_() for x in (q, k, v))
        o_lib = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True)
        lib_ms = timer(lambda: torch.autograd.grad(
            o_lib, (qg, kg, vg), do, retain_graph=True))
        del o_lib, qg, kg, vg
        picks = ("wide" if bh * -(-t // WIDE_ROWS) >= sms else "narrow")
        replaced = REPLACED_BWD_MS.get((b, h, t), (None, None))
        dq = torch.empty_like(q)
        dk, dv = torch.empty_like(k), torch.empty_like(v)
        rows = (
            ("flash_bwd_dq_bf16", replaced[0],
             lambda: flash_bwd_dq_bf16(q, k, v, do, lse, delta, scale, True),
             lambda f: k23b[0](f, p(q), p(k), p(v), p(do), p(lse), p(delta),
                               p(dq), bh, t, t, scale, 1, st()),
             lambda: within(dq, want[0])),
            ("flash_bwd_dkv_bf16", replaced[1],
             lambda: flash_bwd_dkv_bf16(q, k, v, do, lse, delta, scale,
                                        True),
             lambda f: k23b[1](f, p(q), p(k), p(v), p(do), p(lse), p(delta),
                               p(dk), p(dv), bh, t, t, scale, 1, st()),
             lambda: within(dk, want[1]) and within(dv, want[2])))
        for name, replaced_ms, product, form_call, ok in rows:
            row = {"kernel": name, "shape": [b, h, t, d], "causal": True,
                   "launcher_picks": picks, "replaced_ms": replaced_ms,
                   "product_ms": timer(product),
                   "sdpa_backward_ms": lib_ms}
            for f, (form, _) in enumerate(BF16_FORMS):
                call = lambda: _build.check(form_call(f), name + "_form")
                call()
                row[form + "_ok"] = ok()
                row[form + "_ms"] = timer(call)
            print(json.dumps(row), flush=True)
        del q, k, v, do, out, lse, delta, want, dq, dk, dv


def f32_forms(k1, k9, timer, sms):
    """K1's and K9's float32 forms at their path's shapes."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = _build.ptr
    d = 128
    scale = 1.0 / math.sqrt(d)

    k1_shapes = [(1, 8, 256), (1, 8, 2048), (16, 8, 2048)]
    k1_shapes += [(1, bh, 2048) for bh in (8, 9, 10, 12, 16, 24, 32, 64)]
    for b, h, t in k1_shapes:
        bh = b * h
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   for _ in range(3))
        out = torch.empty_like(q)
        lse = torch.empty(b, h, t, device="cuda")
        ro, rl = attention_reference(q, k, v, scale, True)
        row = {"kernel": "flash_fwd", "shape": [b, h, t, d], "causal": True,
               "large_blocks": bh * -(-t // LARGE_BQ),
               "launcher_picks": ("large" if bh * -(-t // LARGE_BQ)
                                  >= sms else "small")}
        for large, form in enumerate(FORMS):
            call = lambda: _build.check(k1(
                p(q), p(k), p(v), p(out), p(lse), bh, t, t, scale, 1, large,
                st()), "flash_fwd_form")
            call()
            ok = _close(out, ro) and _close(lse, rl)
            row[form + "_ms"] = timer(call)
            row[form + "_ok"] = ok
        print(json.dumps(row), flush=True)
        del q, k, v, out, lse, ro, rl

    b, h, t = 16, 8, 512
    bh = b * h
    q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
               for _ in range(3))
    m = torch.full((b, h, t), NEG_INF, device="cuda")
    l = torch.zeros(b, h, t, device="cuda")
    acc = torch.zeros(b, h, t, d, device="cuda")
    m2, l2, acc2 = torch.empty_like(m), torch.empty_like(l), \
        torch.empty_like(acc)
    for causal in (True, False):
        want = chunk_update_reference(q, k, v, m, l, acc, scale, causal, 0)
        row = {"kernel": "flash_chunk", "shape": [b, h, t, d],
               "causal": causal, "k_offset": 0,
               "large_blocks": bh * -(-t // LARGE_BQ),
               "launcher_picks": ("large" if bh * -(-t // LARGE_BQ)
                                  >= sms else "small")}
        for large, form in enumerate(FORMS):
            call = lambda: _build.check(k9(
                p(q), p(k), p(v), p(m), p(l), p(acc), p(m2), p(l2), p(acc2),
                bh, t, t, scale, int(causal), 0, large, st()),
                "flash_chunk_form")
            call()
            ok = all(_close(a, w) for a, w in zip((m2, l2, acc2), want))
            row[form + "_ms"] = timer(call)
            row[form + "_ok"] = ok
        print(json.dumps(row), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--bf16", action="store_true",
                    help="time K1's bf16 (wgmma) forms only")
    ap.add_argument("--bwd", action="store_true",
                    help="time K2's and K3's bf16 (wgmma) forms only")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("flash_forms needs a CUDA card")
    k1, k9, k1b, k23b, ptxas = build()
    for sym, line in sorted(ptxas.items()):
        print(json.dumps({"kernel": sym, "ptxas": line}), flush=True)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    timer = Timer()
    if args.bwd:
        bwd_forms(k23b, timer, sms)
    elif args.bf16:
        bf16_forms(k1b, timer, sms)
    else:
        f32_forms(k1, k9, timer, sms)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: not available", flush=True)


if __name__ == "__main__":
    main()
