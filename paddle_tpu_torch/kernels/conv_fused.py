"""The fused conv-stage kernel of the ResNet program (NHWC activations,
HWIO weights).

Counterpart of ``paddle_tpu/kernels/conv_fused.py``:

- ``conv2d_nhwc`` (K6, ``csrc/conv_fused.cu``): x [N, H, W, Ci] conv
  w [KH, KW, Ci, Co] into an f32 accumulator, with the optional
  epilogue stats (per-channel sum and sum of squares, the training
  form), affine (y * a + b, the test-mode BatchNorm fold), + residual,
  relu; float32 operands run the split-TF32 form, bfloat16 operands
  (the ResNet program under AMP) the bf16 form (on ``wgmma`` with x
  loaded by TMA's im2col mode when Ci % 8 == 0, else on ``mma.sync``),
  whose output is bf16 and whose statistics are still f32 sums of the
  f32 accumulator;
- ``conv2d_nhwc_reference``: its plain version, the reference's
  fallback branch (``F.conv2d`` on permuted views in f32, bf16 operands
  widened exactly, stats from the f32 conv output, then the epilogue
  and one rounding to x's dtype);
- ``fused_conv_bn_act_reference``: the test-mode conv + BN (+ residual)
  (+ relu) stage from running statistics;
- ``stats_error``: the rule K6's statistics are held to;
- ``conv_stage_tile``, ``conv_stage_form``: the form K6 runs for a
  shape's channels and dtype (its rows of statistics partials, its
  name).

A CPU tensor runs the plain version; a CUDA tensor launches K6 or
raises (there is no fallback).  ``conv2d_nhwc.launches`` counts launches
of the f32 form, ``conv2d_nhwc_bf16.launches`` those of the bf16 form.
The reference's ``force_xla`` / ``interpret`` knobs and its autotune
cache have no counterpart here.
"""
from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import _build
from ._build import ptr, require, route, stream

__all__ = ["nchw_views", "conv_nhwc", "conv2d_nhwc_reference",
           "conv2d_nhwc", "conv2d_nhwc_bf16", "fused_conv_bn_act_reference",
           "stats_error", "bf16_ulp", "within_bf16_ulp", "conv_stage_tile",
           "conv_stage_form", "STATS_RTOL"]

# K6's per-channel sums over N*Ho*Wo pixels are sums of values near 0, so
# each is held to STATS_RTOL of the sum of its terms' magnitudes, against
# a float64 sum of K6's own raw conv output (which the output check holds
# to the plain conv).  What that leaves is the f32 reduction: a thread's
# rows, 8 row groups, the warps along M, then the partials (of 128
# pixels, or 64 on the bf16 wgmma tile), worst ~3e-7 of the magnitudes;
# one lost 128-pixel partial of the stem (25,088 of them at batch 256)
# moves a sum by ~4e-5 of them
STATS_RTOL = 1e-6
_ACTS = {"": 0, "relu": 1}
# the forms: operand dtype -> (C entry, the Co multiple it takes)
_FORMS = {torch.float32: ("conv_stage_f32", 4),
          torch.bfloat16: ("conv_stage_bf16", 8)}


def _pair(v):
    if isinstance(v, (list, tuple)):
        return tuple(int(x) for x in v)
    return (int(v), int(v))


def nchw_views(x, w, nhwc=True, hwio=True):
    """NCHW / OIHW views of NHWC data and HWIO filters for torch's conv
    (channels-last memory on the card; nothing is copied)."""
    return (x.permute(0, 3, 1, 2) if nhwc else x,
            w.permute(3, 2, 0, 1) if hwio else w)


def conv_nhwc(x, w, strides, paddings):
    """NHWC x HWIO conv in f32 through ``F.conv2d`` on NCHW / OIHW views
    (cuDNN on the card, TF32 off), NHWC out."""
    xv, wv = nchw_views(x.float(), w.float())
    return F.conv2d(xv, wv, None, _pair(strides),
                    _pair(paddings)).permute(0, 2, 3, 1)


def _epilogue(acc, affine, residual, act):
    y = acc
    if affine is not None:
        a, b = affine
        y = y * a.float() + b.float()
    if residual is not None:
        y = y + residual.float()
    if act == "relu":
        y = torch.relu(y)
    return y


def conv2d_nhwc_reference(x, w, strides=(1, 1), paddings=(0, 0), *,
                          stats=False, affine=None, residual=None, act=""):
    """Plain version of ``conv2d_nhwc``: returns y, or (y, sum, sum_sq)
    with ``stats``."""
    acc = conv_nhwc(x, w, strides, paddings)
    y = _epilogue(acc, affine, residual, act).to(x.dtype)
    if not stats:
        return y
    co = w.shape[3]
    flat = acc.reshape(-1, co)
    return y, flat.sum(dim=0), torch.square(flat).sum(dim=0)


def conv2d_nhwc(x, w, strides=(1, 1), paddings=(0, 0), *, stats=False,
                affine=None, residual=None, act=""):
    """NHWC x [N, H, W, Ci] * HWIO w [KH, KW, Ci, Co] -> [N, Ho, Wo, Co].

    ``stats``: also return per-channel (sum, sum_sq) f32 of the raw conv
    output (the fused-BN training form).  ``affine=(a, b)``: fuse
    ``y * a + b`` per channel.  ``residual``: fuse a same-shape add;
    ``act``: '' | 'relu'.  The output has x's dtype.  On the card x, w
    and residual are all float32 (the split-TF32 form, Co a multiple of
    4) or all bfloat16 (the bf16 form, Co a multiple of 8; x and w are
    padded to a multiple of 4 channels when Ci is not one), contiguous
    and 16-byte aligned; any N, H, W, Ci, kernel size, stride and
    padding, except that the bf16 form's wgmma tile (Ci % 8 == 0) takes
    strides up to 8 and paddings and kernels within TMA's im2col box
    corners (-p and p - (k - 1) in [-128, 127])."""
    extra = [t for t in (residual,) + tuple(affine or ()) if t is not None]
    where = route(x, w, *extra)
    require(x.dim() == 4 and w.dim() == 4,
            "want x [N, H, W, Ci] and w [KH, KW, Ci, Co]")
    n, h, wd, ci = x.shape
    kh, kw, wci, co = w.shape
    sh, sw = _pair(strides)
    ph, pw = _pair(paddings)
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (wd + 2 * pw - kw) // sw + 1
    require(wci == ci, "x has %d channels, w takes %d" % (ci, wci))
    require(ho >= 1 and wo >= 1, "empty conv output")
    require(residual is None or tuple(residual.shape) == (n, ho, wo, co),
            "residual must be [N, Ho, Wo, Co] = %r" % ((n, ho, wo, co),))
    require(affine is None or (len(affine) == 2 and all(
        tuple(t.shape) == (co,) for t in affine)), "affine must be (a, b), "
            "each [Co]")
    require(act in _ACTS, "unsupported fused activation %r" % (act,))
    if where == "cpu":
        return conv2d_nhwc_reference(x, w, (sh, sw), (ph, pw), stats=stats,
                                     affine=affine, residual=residual,
                                     act=act)
    streams = [x, w] + ([residual] if residual is not None else [])
    require(x.dtype in _FORMS and all(t.dtype == x.dtype for t in streams),
            "conv stage kernel takes x, w and residual all float32 or all "
            "bfloat16, got %s" % [str(t.dtype) for t in streams])
    co_mult = _FORMS[x.dtype][1]
    if x.dtype == torch.bfloat16 and ci % 4:
        # no cp.async takes a bf16 pixel row whose Ci is not a multiple
        # of 4 (the stem's 6 bytes are 2-byte aligned): zero channels up
        # to one add only zero products
        x = F.pad(x, (0, 4 - ci % 4))
        w = F.pad(w, (0, 0, 0, 4 - ci % 4))
    if x.dtype == torch.bfloat16 and x.shape[3] % 8 == 0:
        corners = (-ph, -pw, ph - (kh - 1), pw - (kw - 1))
        require(max(sh, sw) <= 8 and all(-128 <= c <= 127 for c in corners),
                "conv stage kernel (bf16, Ci %% 8 == 0) takes strides up to "
                "8 and box corners -p, p - (k - 1) in [-128, 127], got "
                "strides %r, corners %r" % ((sh, sw), corners))
    if affine is not None:
        affine = tuple(t.float().contiguous() for t in affine)
    ops = streams + list(affine or ())
    require(all(t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ops),
            "conv stage kernel needs contiguous, 16-byte aligned operands")
    require(co % co_mult == 0, "conv stage kernel (%s) needs Co a multiple "
            "of %d, got %d" % (x.dtype, co_mult, co))
    out = torch.empty((n, ho, wo, co), dtype=x.dtype, device=x.device)
    partials = None
    if stats:
        rows, _ = conv_stage_tile(x.shape[3], co, x.dtype)
        partials = torch.empty((-(-n * ho * wo // rows), 2, co),
                               dtype=torch.float32, device=x.device)
    _launch(x, w, (sh, sw), (ph, pw), affine, residual, act, out, partials)
    if x.dtype == torch.bfloat16:
        _build.count(conv2d_nhwc_bf16)
    else:
        _build.count(conv2d_nhwc)
    if not stats:
        return out
    sums = partials.sum(dim=0)
    return out, sums[0], sums[1]


conv2d_nhwc.launches = 0


def conv2d_nhwc_bf16(*args, **kw):
    """``conv2d_nhwc`` on bfloat16 operands (the form a ResNet AMP step
    launches); its ``launches`` counts the bf16 form's launches, which
    ``conv2d_nhwc`` makes for any bf16 call."""
    require(args[0].dtype == torch.bfloat16 and
            args[1].dtype == torch.bfloat16, "want bfloat16 x and w")
    return conv2d_nhwc(*args, **kw)


conv2d_nhwc_bf16.launches = 0


def _launch(x, w, strides, paddings, affine, residual, act, out, partials,
            blocks=0):
    """One launch of K6 (the form of x's dtype) on checked operands;
    ``partials`` (or None) has ceil(M / rows) rows, rows from
    conv_stage_tile.  ``blocks`` > 0 caps the bf16 wgmma form's
    persistent grid (a test's: the grid changes no sum)."""
    entry = _FORMS[x.dtype][0]
    args = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 12
    extra = ()
    if blocks:
        require(x.dtype == torch.bfloat16, "a grid cap is the bf16 form's")
        entry, args, extra = (entry + "_capped", args + [ctypes.c_int],
                              (blocks,))
    fn = _build.function("conv_fused", entry, args + [ctypes.c_void_p])
    null = ctypes.c_void_p(None)
    n, h, wd, ci = x.shape
    kh, kw, _, co = w.shape
    rc = fn(ptr(x), ptr(w),
            ptr(affine[0]) if affine is not None else null,
            ptr(affine[1]) if affine is not None else null,
            ptr(residual) if residual is not None else null,
            ptr(out), ptr(partials) if partials is not None else null,
            n, h, wd, ci, co, kh, kw, *strides, *paddings, _ACTS[act],
            *extra, stream())
    _build.check(rc, "conv2d_nhwc")


def _form(ci, co, dtype):
    """(BM, BN, rows of a partial, wgmma?) of the form K6's launcher
    runs for ``ci`` (after the bf16 pad) and ``co`` channels."""
    fn = _build.function(
        "conv_fused", "conv_stage_tile",
        [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int)] * 4)
    out = [ctypes.c_int() for _ in range(4)]
    _build.check(fn(ci, co, int(dtype == torch.bfloat16),
                    *map(ctypes.byref, out)), "conv_stage_tile")
    return tuple(v.value for v in out[:3]) + (bool(out[3].value),)


def conv_stage_tile(ci, co, dtype=torch.float32):
    """(rows, BN) of the form K6 runs for ``ci`` input channels (as
    launched: bf16 x is padded to a multiple of 4) and ``co`` output
    channels in ``dtype``, as its launcher decides: each ``rows`` output
    pixels give one row of statistics partials, BN is the output tile's
    width."""
    _, bn, rows, _ = _form(int(ci), int(co), dtype)
    return rows, bn


def conv_stage_form(ci, co, dtype=torch.float32):
    """The name of that form: 'wgmma 128x128' or 'wgmma 128x64' (bf16,
    Ci % 8 == 0), else 'mma.sync 128x64' (float32's split-TF32 tile and
    the bf16 stem's)."""
    bm, bn, _, wgmma = _form(int(ci), int(co), dtype)
    return "%s %dx%d" % ("wgmma" if wgmma else "mma.sync", bm, bn)


def fused_conv_bn_act_reference(x, w, scale, bias, mean, var, *, strides,
                                paddings, eps, act="", residual=None):
    """The fused stage in TEST mode (running statistics), plain."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * a
    return conv2d_nhwc_reference(x, w, strides, paddings, affine=(a, b),
                                 residual=residual, act=act)


def bf16_ulp(y):
    """The spacing of bfloat16 numbers at each element of ``y`` (float):
    2**(e - 7) for |y| in [2**e, 2**(e + 1)), the smallest normal's
    below it."""
    _, e = torch.frexp(y.float().abs().clamp_min(2.0 ** -126))
    return torch.ldexp(torch.ones_like(y, dtype=torch.float32), e - 8)


def within_bf16_ulp(got, want, floor):
    """(max |got - want|, whether every element of ``got`` is within one
    bf16 ulp of ``want`` plus ``floor`` of max |want|): the bar of a
    bf16 output that is one rounding of f32 sums taken in another order
    than the plain version's."""
    want = want.float()
    err = (got.float() - want).abs()
    ok = bool((err <= bf16_ulp(want) + floor * want.abs().max()).all())
    return float(err.max()), ok


def stats_error(x, w, strides, paddings, s, ss):
    """How far per-channel (sum, sum_sq) from ``conv2d_nhwc(...,
    stats=True)`` are from float64 sums of the raw conv output: (max
    |err|, max |err| / sum |terms|).  Pass when the second is at most
    STATS_RTOL.  For float32 operands the raw output is recomputed by
    ``conv2d_nhwc`` without epilogue (on the card, K6's same
    accumulation, bit for bit); the bf16 form never writes its f32
    accumulator, so for bf16 operands it is a float64 conv of the same
    operands, widened exactly, which differs from the accumulator only
    by the accumulator's own f32 rounding."""
    if x.dtype == torch.bfloat16:
        xv, wv = nchw_views(x.double(), w.double())
        acc = F.conv2d(xv, wv, None, _pair(strides),
                       _pair(paddings)).permute(0, 2, 3, 1)
    else:
        acc = conv2d_nhwc(x, w, strides, paddings)
    acc = acc.reshape(-1, acc.shape[-1]).double()
    err = rel = 0.0
    for got, terms in ((s, acc), (ss, acc.square())):
        e = (got.double() - terms.sum(0)).abs()
        err = max(err, float(e.max()))
        rel = max(rel, float((e / terms.abs().sum(0)).max()))
    return err, rel
