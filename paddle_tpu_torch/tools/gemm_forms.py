"""Time tile forms of the split-TF32 GEMM tile (K4, K8's prefill form,
K6), and of the wgmma tile (K4's bf16 form), at the same shapes on the
card.

``matmul_fused.cu`` (K4) and ``matmul_int8.cu`` (K8, M > 16) run
``gemm_tile.cuh``'s tile in one of two forms, picked inside the C
launcher from the grid (``gemm::use_large``): Large (128 x 64, 4 warps,
3 stages) when its blocks give every SM one, else Small (64 x 64, 4
warps, 4 stages).  The product has no way to force a form.  This tool compiles,
beside the product libraries, one translation unit that includes the
tile and exports a launcher for each form of ``FORMS`` (the two the
product uses and candidates of other shapes and K depths), then
times every form on the same inputs (CUDA events, median of single
calls, L2 flushed before each) and holds each against the plain
version at atol = rtol = 1e-4:

- K4 at the fused LM step's five projections, M = 16 x 2048, with
  their epilogues (``chip_smoke.FUSED_MATMULS``);
- K8 at the int8 tenant's four projections at prefill buckets M = 64,
  256, 1024 (the largest the serve phase pads to) and 2048;
- K6 (``--k6``: ``conv_fused.cu``'s gather and epilogue on the tile,
  which the exporter includes) at the 20 conv shapes of the ResNet-50
  forward at batch 256, in the statistics form, in the forms of
  ``K6_FORMS`` (the product runs Large at every shape); the stem also with x and w zero-padded to Ci = 4 on
  the card (the pad's time included), so that it takes the 16-byte
  gather.  Statistics are held to ``conv_fused.STATS_RTOL``;
- K6's bf16 form (``--k6 --bf16``) at the same 20 shapes in the
  statistics form, in the forms of ``K6_BF16_FORMS``: the product's
  (``conv2d_nhwc``: the wgmma tile with x by TMA's im2col mode for Ci %
  8 == 0, 128 x 128 for Co >= 128 and 128 x 64 below; the stem on the
  mma.sync tile), each wgmma width and a shorter fragment chain, and the
  mma.sync form the wgmma tile replaced (``ConvA<16, bf16>`` on
  ``gemm_tile.cuh``'s bf16_kernel, which only this tool instantiates),
  each held within one bf16 ulp plus 1e-6 of max |Y| and to
  ``STATS_RTOL``; beside them the replaced form's time before it was
  replaced (``REPLACED_K6_BF16_MS``), cuDNN bf16 alone (F.conv2d on
  channels_last bf16) and cuDNN plus the sums in torch (chip_smoke.py's
  yardstick);
- K4's bf16 form (``--bf16``: ``wgmma_gemm.cuh``, which the exporter
  includes too) at the five projections in the forms of ``BF16_FORMS``
  (the product runs ``GemmBf16``), each held within one bf16 ulp plus
  1e-6 of max |Y| of ``matmul_epilogue_f32acc_reference``, beside the
  library call (``torch.addmm`` / ``matmul`` in bf16, then the
  activation) and the time of the ``mma.sync`` form it replaced
  (``REPLACED_BF16_MS``, PERF.md).

Run on a CUDA machine from the repository root:

    python -m paddle_tpu_torch.tools.gemm_forms [--k8-only | --k6 | --bf16 |
                                                 --k6 --bf16]

Prints one JSON line per shape (each form's ms and agreement, the form
the launcher picks, the library call's ms), then the card's name and
power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess

import numpy as np
import torch

from .. import resolve_device
from ..kernels import _build
from ..kernels import conv_fused
from ..kernels.matmul_fused import (dequantize_weight, matmul_epilogue,
                                    matmul_epilogue_reference,
                                    matmul_int8_reference, quantize_weight,
                                    tile_form)

TOL = 1e-4
# (name, gemm::Tile<BM, BN, WM, WN, STAGES, MIN_BLOCKS>); the first two
# are the product's Large and Small
FORMS = (("large", "Large"),
         ("small", "Small"),
         ("128x128", "Tile<128, 128, 2, 4, 3, 1>"),
         ("128x128k64", "Tile<128, 128, 2, 4, 3, 1, 64>"),
         ("64x128", "Tile<64, 128, 2, 2, 4, 2>"),
         ("64x64k64", "Tile<64, 64, 2, 2, 3, 2, 64>"))
_ACTS = {"": 0, "relu": 1, "gelu": 2}
# (name, wg::GemmTile<STAGES, K tiles a fragment>) of K4's bf16 form;
# the first is the product's
BF16_FORMS = (("s5pi4", "GemmBf16"), ("s4pi2", "GemmTile<4, 2>"),
              ("s4pi1", "GemmTile<4, 1>"))
# the fused LM step's five projections at M = 16 x 2048: (what, K, N,
# bias, act), as chip_smoke.FUSED_MATMULS
PROJECTIONS = (("qkv", 1024, 3072, False, ""),
               ("out_proj", 1024, 1024, True, ""),
               ("fc1", 1024, 4096, True, "relu"),
               ("fc2", 4096, 1024, True, ""),
               ("lm_head", 1024, 8192, True, ""))
# the time of K4's bf16 form on gemm_tile.cuh's mma.sync bf16_kernel,
# which the wgmma tile replaced, at each projection (PERF.md section 6,
# chip_smoke.py's phase 3; NVIDIA H100 80GB HBM3, 700 W)
REPLACED_BF16_MS = {"qkv": 1.0735, "out_proj": 0.3748, "fc1": 1.4468,
                    "fc2": 1.3080, "lm_head": 2.9464}
# the forms K6 is timed in, with their BM (the rows of a statistics
# partial): the tile's two and the 8-warp 128 x 128
K6_FORMS = {"large": 128, "small": 64, "128x128": 128}
# (name, launch in conv_fused.cu's terms, rows of a statistics partial)
# of K6's bf16 form; "product" is the launcher's own pick, "mma_sync" the
# form the wgmma tile replaced (needs Ci % 8 == 0)
K6_BF16_FORMS = (
    ("product", "launch_stage_bf16(c, s, 0)", None),
    ("wgmma_128x128", "launch_wgmma<ConvWide>(c, s, 0)", 64),
    ("wgmma_128x64", "launch_wgmma<ConvNarrow>(c, s, 0)", 64),
    ("wgmma_128x128_pi2", "launch_wgmma<wg::GemmTile<5, 2, 128>>(c, s, 0)",
     64),
    ("mma_sync", "gemm::launch_bf16<gemm::Large, ConvA<16, bf16>, ConvEpi>"
     "(c.a, s, c.s, c.p)", 128))
# the time of K6's bf16 form on gemm_tile.cuh's mma.sync bf16_kernel,
# which the wgmma form replaced, at each conv shape (H, Ci, Co, k,
# stride, pad) of the forward at batch 256, statistics form
# (chip_smoke.py's phase 3 before the replacement, PERF.md section 6;
# NVIDIA H100 80GB HBM3, 700 W)
REPLACED_K6_BF16_MS = {
    (14, 256, 256, 3, 1, 1): 0.3482, (28, 128, 128, 3, 1, 1): 0.3662,
    (7, 512, 512, 3, 1, 1): 0.3257, (55, 64, 64, 3, 1, 1): 0.4027,
    (14, 256, 1024, 1, 1, 0): 0.2404, (14, 1024, 256, 1, 1, 0): 0.1828,
    (28, 128, 512, 1, 1, 0): 0.3180, (55, 64, 256, 1, 1, 0): 0.5218,
    (28, 512, 128, 1, 1, 0): 0.2090, (7, 512, 2048, 1, 1, 0): 0.1914,
    (224, 3, 64, 7, 2, 3): 1.1815, (55, 256, 512, 1, 2, 0): 0.4480,
    (28, 512, 1024, 1, 2, 0): 0.3719, (14, 1024, 2048, 1, 2, 0): 0.3297,
    (7, 2048, 512, 1, 1, 0): 0.1619, (55, 256, 64, 1, 1, 0): 0.2706,
    (55, 256, 128, 1, 2, 0): 0.1382, (28, 512, 256, 1, 2, 0): 0.1157,
    (14, 1024, 512, 1, 2, 0): 0.0942, (55, 64, 64, 1, 1, 0): 0.1528}


def _source():
    cases = "\n".join(
        "    case %d: return vec ? launch<%s, W, true>(a, s)\n"
        "                       : launch<%s, W, false>(a, s);"
        % (i, t, t) for i, (_, t) in enumerate(FORMS))
    bf16_cases = "\n".join(
        "    case %d: return (int)wg::gemm_bf16<wg::%s>(a, s);" % (i, t)
        for i, (_, t) in enumerate(BF16_FORMS))
    conv_cases = "\n".join(
        "    case %d: return launch_form<gemm::%s>(c, s);" % (i, t)
        for i, (name, t) in enumerate(FORMS) if name in K6_FORMS)
    conv_bf16_cases = "\n".join(
        "    case %d: return (int)%s;" % (i, t)
        for i, (_, t, _) in enumerate(K6_BF16_FORMS))
    return r'''
#include "%s/conv_fused.cu"
#include "%s/wgmma_gemm.cuh"
using namespace gemm;
template <class W>
static cudaError_t run_form(int form, const Args& a, bool vec,
                            cudaStream_t s) {
  switch (form) {
%s
  }
  return cudaErrorInvalidValue;
}
extern "C" int gemm_form_f32(int form, const float* x, const float* w,
                             const float* bias, const float* res,
                             float* out, float* pre, int M, int N, int K,
                             int act, void* stream) {
  const Args a{x, w, nullptr, bias, res, out, pre, M, N, K, 0, act};
  return (int)run_form<F32W>(form, a, N %% 4 == 0,
                             static_cast<cudaStream_t>(stream));
}
extern "C" int gemm_form_int8(int form, const float* x, const int8_t* w,
                              const float* scales, const float* bias,
                              const float* res, float* out, int M, int N,
                              int K, int chunk, int act, void* stream) {
  const Args a{x, w, scales, bias, res, out, nullptr, M, N, K, chunk, act};
  return (int)run_form<Int8W>(form, a, N %% 16 == 0,
                              static_cast<cudaStream_t>(stream));
}
extern "C" int conv_form_f32(int form, const float* x, const float* w,
                             float* out, float* partials, int N, int H,
                             int W, int Ci, int Co, int KH, int KW, int sh,
                             int sw, int ph, int pw, void* stream) {
  Call<float> c;
  const cudaError_t err =
      make_call<float>(c, x, w, nullptr, nullptr, nullptr, out, partials,
                       N, H, W, Ci, Co, KH, KW, sh, sw, ph, pw, 0);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
%s
  }
  return (int)cudaErrorInvalidValue;
}
extern "C" int conv_form_bf16(int form, const bf16* x, const bf16* w,
                              bf16* out, float* partials, int N, int H,
                              int W, int Ci, int Co, int KH, int KW, int sh,
                              int sw, int ph, int pw, void* stream) {
  Call<bf16> c;
  const cudaError_t err =
      make_call<bf16>(c, x, w, nullptr, nullptr, nullptr, out, partials,
                      N, H, W, Ci, Co, KH, KW, sh, sw, ph, pw, 0);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
%s
  }
  return (int)cudaErrorInvalidValue;
}
extern "C" int gemm_form_bf16(int form, const bf16* x, const bf16* w,
                              const bf16* bias, const bf16* res, bf16* out,
                              bf16* pre, int M, int N, int K, int act,
                              void* stream) {
  const ArgsT<bf16> a{x, w, nullptr, bias, res, out, pre, M, N, K, 0, act};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (form) {
%s
  }
  return (int)cudaErrorInvalidValue;
}
''' % (_build.CSRC, _build.CSRC, cases, conv_cases, conv_bf16_cases,
       bf16_cases)


def build():
    """Compile the form exporter into ``_build/forms/``; returns its
    ctypes entries (f32, int8, conv, bf16, conv_bf16) and ptxas's
    summary per kernel."""
    out = os.path.join(_build.BUILD_DIR, "forms")
    os.makedirs(out, exist_ok=True)
    src = os.path.join(out, "gemm_forms.cu")
    with open(src, "w") as f:
        f.write(_source())
    lib = os.path.join(out, "gemm_forms.so")
    proc = subprocess.run(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", lib, src],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed:\n%s" % proc.stdout[-4000:])
    dll = ctypes.CDLL(lib)
    f32, i8, conv = dll.gemm_form_f32, dll.gemm_form_int8, dll.conv_form_f32
    bf16 = dll.gemm_form_bf16
    f32.argtypes = bf16.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                                    + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    i8.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6
                   + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    conv_bf16 = dll.conv_form_bf16
    conv.argtypes = conv_bf16.argtypes = (
        [ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11
        + [ctypes.c_void_p])
    for fn in (f32, i8, conv, bf16, conv_bf16):
        fn.restype = ctypes.c_int
    return (f32, i8, conv, bf16, conv_bf16,
            _build._ptxas_summary(proc.stdout))


class Timer:
    """Median CUDA-event time of single calls, the L2 flushed (a 64 MiB
    read) before each and the card kept busy while the host enqueues."""

    def __init__(self):
        self.flush = torch.ones(16 << 20, device="cuda")

    def __call__(self, fn, iters=15, warmup=2):
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


def resnet50_conv_shapes():
    """{(H, Ci, Co, k, stride, pad): launches a forward} of the fused
    ResNet-50 program (flowers, 224 x 224), read off its desc."""
    from .. import fluid
    from ..models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        resnet.get_model(data_set="flowers", depth=50, is_test=True,
                         data_format="NHWC", fused_stages=True)
    block = main.desc.blocks[0]
    shapes = {}
    for op in block.ops:
        if op.type == "fused_conv2d_bn_act":
            _, h, _, ci = block.vars[op.input("Input")[0]].shape
            k, _, _, co = block.vars[op.input("Filter")[0]].shape
            key = (h, ci, co, k, op.attr("strides")[0],
                   op.attr("paddings")[0])
            shapes[key] = shapes.get(key, 0) + 1
    return shapes


def conv_forms(conv, timer, batch=256):
    """K6 in each of K6_FORMS at the ResNet-50 forward's conv shapes."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = _build.ptr
    shapes = resnet50_conv_shapes()
    for shp, count in sorted(shapes.items()):
        h, ci, co, k, s, pad = shp
        ho = (h + 2 * pad - k) // s + 1
        m = batch * ho * ho
        x = torch.randn(batch, h, h, ci, device="cuda", generator=gen)
        w = torch.randn(k, k, ci, co, device="cuda", generator=gen) * \
            (k * k * ci) ** -0.5
        want = conv_fused.conv2d_nhwc_reference(x, w, s, pad)
        out = torch.empty(batch, ho, ho, co, device="cuda")
        row = {"kernel": "conv_stage", "shape": list(shp), "launches": count,
               "launcher_picks": conv_fused.conv_stage_form(ci, co),
               "product_ms": timer(lambda: conv_fused.conv2d_nhwc(
                   x, w, s, pad, stats=True)),
               "library_ms": timer(lambda: F.conv2d(
                   x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, s,
                   pad))}
        variants = [(name, x, w) for name in K6_FORMS]
        if ci % 4:
            variants += [(name + "_pad4", None, None) for name in K6_FORMS]
        for name, xv, wv in variants:
            base = name.replace("_pad4", "")
            form = [f for f, _ in FORMS].index(base)
            parts = torch.empty(-(-m // K6_FORMS[base]), 2, co,
                                device="cuda")

            def call(xv=xv, wv=wv, form=form, parts=parts):
                if xv is None:   # the pad is part of the call
                    xv = F.pad(x, (0, 4 - ci % 4))
                    wv = F.pad(w, (0, 0, 0, 4 - ci % 4))
                _build.check(conv(
                    form, p(xv), p(wv), p(out), p(parts), batch, h, h,
                    xv.shape[3], co, k, k, s, s, pad, pad, st()),
                    "conv_form_f32")
            call()
            row[name + "_ok"] = _close(out, want)
            acc = out.reshape(-1, co).double()
            rel = 0.0
            for got, terms in ((parts[:, 0].sum(0), acc),
                               (parts[:, 1].sum(0), acc.square())):
                e = (got.double() - terms.sum(0)).abs()
                rel = max(rel, float((e / terms.abs().sum(0)).max()))
            row[name + "_stats_ok"] = rel <= conv_fused.STATS_RTOL
            row[name + "_ms"] = timer(call)
        print(json.dumps(row), flush=True)
        del x, w, want, out
        torch.cuda.empty_cache()


def conv_bf16_forms(conv_bf16, timer, batch=256):
    """K6's bf16 form in each of K6_BF16_FORMS at the ResNet-50
    forward's conv shapes, statistics form, beside cuDNN."""
    import torch.nn.functional as F

    gen = torch.Generator(device="cuda").manual_seed(0)
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = _build.ptr
    bf = torch.bfloat16
    for shp, count in sorted(resnet50_conv_shapes().items()):
        h, ci, co, k, s, pad = shp
        ho = (h + 2 * pad - k) // s + 1
        m = batch * ho * ho
        x = torch.randn(batch, h, h, ci, device="cuda", generator=gen).to(bf)
        w = (torch.randn(k, k, ci, co, device="cuda", generator=gen)
             * (k * k * ci) ** -0.5).to(bf)
        xcl = x.permute(0, 3, 1, 2)
        wcl = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        want = conv_fused.conv2d_nhwc_reference(x, w, s, pad).float()
        bar = conv_fused.bf16_ulp(want) + 1e-6 * want.abs().max()
        # float64 sums of the raw conv of the same operands
        acc = F.conv2d(xcl.double(), wcl.double(), None, s, pad)
        acc = acc.permute(0, 2, 3, 1).reshape(-1, co)
        exact = (acc.sum(0), acc.square().sum(0))
        mags = (acc.abs().sum(0), acc.square().sum(0))
        del acc

        def lib_sums():
            y = F.conv2d(xcl, wcl, None, s, pad)
            return y, y.sum((0, 2, 3), dtype=torch.float32), \
                torch.square(y.float()).sum((0, 2, 3))

        cil = ci + (-ci) % 4
        row = {"kernel": "conv_stage_bf16", "shape": list(shp),
               "launches": count,
               "launcher_picks": conv_fused.conv_stage_form(cil, co, bf),
               "replaced_ms": REPLACED_K6_BF16_MS.get(shp),
               "product_ms": timer(lambda: conv_fused.conv2d_nhwc(
                   x, w, s, pad, stats=True)),
               "library_ms": timer(lambda: F.conv2d(xcl, wcl, None, s,
                                                    pad)),
               "library_sums_ms": timer(lib_sums)}
        out = torch.empty(batch, ho, ho, co, device="cuda", dtype=bf)
        for f, (name, _, rows) in enumerate(K6_BF16_FORMS):
            if name != "product" and ci % 8:
                continue   # TMA and ConvA<16> need 8-channel pixel rows
            if rows is None:
                rows = conv_fused.conv_stage_tile(cil, co, bf)[0]
            parts = torch.empty(-(-m // rows), 2, co, device="cuda")
            xv, wv = x, w
            if ci % 4:   # as the wrapper launches the stem
                xv = F.pad(x, (0, cil - ci))
                wv = F.pad(w, (0, 0, 0, cil - ci))

            def call(f=f, xv=xv, wv=wv, parts=parts):
                _build.check(conv_bf16(
                    f, p(xv), p(wv), p(out), p(parts), batch, h, h, cil,
                    co, k, k, s, s, pad, pad, st()), "conv_form_bf16")
            call()
            sums = parts.sum(0).double()
            rel = max(float(((sums[i] - exact[i]).abs() / mags[i]).max())
                      for i in range(2))
            row[name + "_ok"] = bool(
                ((out.float() - want).abs() <= bar).all()) and \
                rel <= conv_fused.STATS_RTOL
            row[name + "_ms"] = timer(call)
        print(json.dumps(row), flush=True)
        del x, w, xcl, wcl, want, bar, out, exact, mags
        torch.cuda.empty_cache()


def bf16_forms(bf16, timer):
    """K4's bf16 form in each of BF16_FORMS at the five projections."""
    from ..kernels.matmul_fused import (apply_act, matmul_epilogue_bf16,
                                        matmul_epilogue_f32acc_reference)

    gen = torch.Generator(device="cuda").manual_seed(0)
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = _build.ptr
    null = ctypes.c_void_p(None)
    bf = torch.bfloat16
    m = 16 * 2048
    for what, kk, n, with_bias, act in PROJECTIONS:
        x = torch.randn(m, kk, device="cuda", generator=gen).to(bf)
        w = (torch.randn(kk, n, device="cuda", generator=gen)
             * kk ** -0.5).to(bf)
        bias = (torch.randn(n, device="cuda", generator=gen).to(bf)
                if with_bias else None)
        out = torch.empty(m, n, device="cuda", dtype=bf)
        want = matmul_epilogue_f32acc_reference(x, w, bias, None, act)[0]
        bar = conv_fused.bf16_ulp(want.float()) + 1e-6 * \
            want.float().abs().max()

        def lib():
            y = torch.addmm(bias, x, w) if with_bias else torch.matmul(x, w)
            return apply_act(y, act)

        row = {"kernel": "matmul_epilogue_bf16", "shape": [m, kk, n],
               "what": what, "replaced_ms": REPLACED_BF16_MS[what],
               "product_ms": timer(lambda: matmul_epilogue_bf16(
                   x, w, bias, None, act)),
               "library_ms": timer(lib)}
        for f, (name, _) in enumerate(BF16_FORMS):
            call = lambda: _build.check(bf16(
                f, p(x), p(w), p(bias) if bias is not None else null,
                null, p(out), null, m, n, kk, _ACTS[act], st()),
                "gemm_form_bf16")
            call()
            row[name + "_ok"] = bool(
                ((out.float() - want.float()).abs() <= bar).all())
            row[name + "_ms"] = timer(call)
        print(json.dumps(row), flush=True)
        del x, w, bias, out, want, bar
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--k8-only", action="store_true")
    ap.add_argument("--k6", action="store_true",
                    help="time K6's forms only (with --bf16: its bf16 "
                         "forms)")
    ap.add_argument("--bf16", action="store_true",
                    help="time K4's bf16 (wgmma) forms only (with --k6: "
                         "K6's)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("gemm_forms needs a CUDA card")
    resolve_device("cuda")
    f32, i8, conv, bf16, conv_bf16, ptxas = build()
    for sym, line in sorted(ptxas.items()):
        print(json.dumps({"kernel": sym, "ptxas": line}), flush=True)
    timer = Timer()
    if args.k6 and args.bf16:
        conv_bf16_forms(conv_bf16, timer)
    elif args.k6:
        conv_forms(conv, timer)
    elif args.bf16:
        bf16_forms(bf16, timer)
    gen = torch.Generator(device="cuda").manual_seed(0)
    st = lambda: ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
    p = _build.ptr
    null = ctypes.c_void_p(None)
    rng = np.random.RandomState(0)

    for kk, n in (() if args.k6 or args.bf16 else
                  ((1024, 3072), (1024, 1024), (1024, 4096), (4096, 1024))):
        w = (rng.randn(kk, n) * 0.1).astype(np.float32)
        qn, sn, chunk = quantize_weight(w)
        wq, sc = torch.from_numpy(qn).cuda(), torch.from_numpy(sn).cuda()
        wd = dequantize_weight(wq, sc, chunk)
        for m in (64, 256, 1024, 2048):
            x = torch.randn(m, kk, device="cuda", generator=gen)
            out = torch.empty(m, n, device="cuda")
            want = matmul_int8_reference(x, wq, sc, chunk)
            row = {"kernel": "matmul_int8", "shape": [m, kk, n],
                   "launcher_picks": tile_form("matmul_int8", m, n),
                   "library_ms": timer(lambda: torch.matmul(x, wd))}
            for f, (name, _) in enumerate(FORMS):
                call = lambda: _build.check(i8(
                    f, p(x), p(wq), p(sc), null, null, p(out), m, n, kk,
                    chunk, 0, st()), "gemm_form_int8")
                call()
                row[name + "_ok"] = _close(out, want)
                row[name + "_ms"] = timer(call)
            print(json.dumps(row), flush=True)
    if not (args.k8_only or args.k6 or args.bf16):
        m = 16 * 2048
        for what, kk, n, with_bias, act in PROJECTIONS:
            x = torch.randn(m, kk, device="cuda", generator=gen)
            w = torch.randn(kk, n, device="cuda", generator=gen) * kk ** -0.5
            bias = (torch.randn(n, device="cuda", generator=gen)
                    if with_bias else None)
            out = torch.empty(m, n, device="cuda")
            want = matmul_epilogue_reference(x, w, bias, None, act)[0]
            row = {"kernel": "matmul_epilogue", "shape": [m, kk, n],
                   "what": what,
                   "launcher_picks": tile_form("matmul_epilogue", m, n),
                   "product_ms": timer(lambda: matmul_epilogue(
                       x, w, bias, None, act), iters=7),
                   "library_ms": timer(
                       lambda: torch.addmm(bias, x, w) if with_bias
                       else torch.matmul(x, w), iters=7)}
            for f, (name, _) in enumerate(FORMS):
                call = lambda: _build.check(f32(
                    f, p(x), p(w), p(bias) if bias is not None else null,
                    null, p(out), null, m, n, kk, _ACTS[act], st()),
                    "gemm_form_f32")
                call()
                row[name + "_ok"] = _close(out, want)
                row[name + "_ms"] = timer(call, iters=7)
            print(json.dumps(row), flush=True)
            del x, w, bias, out, want
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip(), flush=True)


if __name__ == "__main__":
    main()
