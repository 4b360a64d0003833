"""The arithmetic of the conv-stage kernel K6 (``csrc/conv_fused.cu``:
an implicit GEMM on the split-TF32 tile of ``csrc/gemm_tile.cuh``),
emulated in torch on the CPU and held against the JAX package's
``conv2d_nhwc`` (its XLA path on the CPU) on the same numpy inputs.

The emulation follows the kernel: A is x gathered in (kh, kw, ci) order,
HWIO's row order (im2col here; the kernel gathers it into shared memory
with zero fill at the padding and past K); the product is
``test_torch_split_tf32``'s split-TF32 one (three MMAs a product, each
32-deep K tile in a fresh fragment added in f32); then the epilogue
x * a + b (one FMA), + residual, relu.  The statistics are the kernel's
per-M-tile partials in its fixed order: a thread's rows g + 8 r in
order, the 8 row groups g pairwise (``__shfl_xor`` over lane bits 2..4),
the 2 warps along M, then the wrapper's sum of the tiles' partials.

Tolerance atol = rtol = 1e-4 on outputs, the card tests' and
``chip_smoke.py``'s; the statistics are held to ``STATS_RTOL`` of the
sum of their terms' magnitudes, as ``conv_fused.stats_error`` holds the
card's.  The negative case shows the bar separates the schemes:
single-pass TF32 misses it at K = 4608.  The kernel itself runs only on
the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.kernels import conv_fused as jcf
from paddle_tpu_torch.kernels import conv_fused as pcf
from test_torch_split_tf32 import BK, TOL, emulate_f32

BM, WM = 128, 2   # K6's tile: 128 rows, 2 warps along M


def _im2col(x, kh, kw, s, p):
    """A [N * Ho * Wo, KH * KW * Ci] in (kh, kw, ci) order, zero-padded
    to a whole number of K tiles (the kernel's zero fill past K)."""
    n, h, w, ci = x.shape
    ho, wo = (h + 2 * p - kh) // s + 1, (w + 2 * p - kw) // s + 1
    xp = F.pad(x, (0, 0, p, p, p, p))
    taps = [xp[:, i:i + s * (ho - 1) + 1:s, j:j + s * (wo - 1) + 1:s, :]
            for i in range(kh) for j in range(kw)]
    a = torch.stack(taps, dim=3).reshape(n * ho * wo, kh * kw * ci)
    return F.pad(a, (0, -a.shape[1] % BK))


def _stats(acc):
    """(sum, sum of squares) per channel as K6 sums them: per-M-tile
    partials [T, 2, Co] in the kernel's order, then their sum."""
    m, co = acc.shape
    t = -(-m // BM)
    rows = F.pad(acc, (0, 0, 0, t * BM - m))   # rows past M add nothing
    rows = rows.reshape(t, WM, BM // WM // 8, 8, co)   # tile, warp, r, g
    s = torch.zeros(t, WM, 8, co)
    q = torch.zeros(t, WM, 8, co)
    for r in range(rows.shape[2]):
        v = rows[:, :, r]
        s = s + v
        q = (q.double() + v.double() * v.double()).float()   # fmaf
    parts = []
    for part in (s, q):
        while part.shape[2] > 1:   # g ^ 1, g ^ 2, g ^ 4
            part = part[:, :, 0::2] + part[:, :, 1::2]
        tot = torch.zeros(t, co)
        for w in range(WM):
            tot = tot + part[:, w, 0]
        parts.append(tot)
    sums = torch.stack(parts, dim=1).sum(dim=0)
    return sums[0], sums[1]


def emulate_conv(x, w, s, p, affine=None, residual=None, act="",
                 single_pass=False):
    """K6's output, its raw accumulator and its statistics."""
    kh, kw, ci, co = w.shape
    n = x.shape[0]
    a = _im2col(x, kh, kw, s, p)
    wm = F.pad(w.reshape(kh * kw * ci, co), (0, 0, 0, a.shape[1] - kh * kw
                                             * ci))
    acc = emulate_f32(a, wm, single_pass=single_pass)
    y = acc
    if affine is not None:
        y = (acc.double() * affine[0].double()
             + affine[1].double()).float()   # one FMA
    if residual is not None:
        y = y + residual.reshape(-1, co)
    if act == "relu":
        y = torch.relu(y)
    ho = (x.shape[1] + 2 * p - kh) // s + 1
    wo = (x.shape[2] + 2 * p - kw) // s + 1
    return y.reshape(n, ho, wo, co), acc, _stats(acc)


def _rel(got, terms):
    """max |got - sum terms| / sum |terms| per channel (stats_error's
    measure), terms [M, Co] in float64."""
    e = (got.double() - terms.sum(0)).abs()
    return float((e / terms.abs().sum(0)).max())


# (N, H, Ci, Co, k, stride, pad): a 3x3 stage at K = 4608 (M = 98, less
# than a tile), the stem (Ci = 3, K = 147, ragged K), a
# Ci = 40 3x3 stage (4-channel groups whose K tiles span taps) and a
# strided 1x1
SHAPES = [(2, 7, 512, 512, 3, 1, 1), (2, 23, 3, 64, 7, 2, 3),
          (2, 9, 40, 256, 3, 1, 1), (2, 7, 256, 68, 1, 2, 0)]


def _operands(seed, shape):
    n, h, ci, co, k, s, p = shape
    ho = (h + 2 * p - k) // s + 1
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) * (k * k * ci) ** -0.5).astype(np.float32)
    a = (rng.rand(co) + 0.5).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    r = rng.randn(n, ho, ho, co).astype(np.float32)
    return x, w, a, b, r


@pytest.mark.parametrize("mode", ["stats", "affine+residual+relu"])
@pytest.mark.parametrize("shape", SHAPES)
def test_split_tf32_conv_matches_jax_conv2d_nhwc(shape, mode):
    x, w, a, b, r = _operands(0, shape)
    _, _, _, _, k, s, p = shape
    t = torch.from_numpy
    if mode == "stats":
        want, want_s, want_ss = (torch.from_numpy(np.array(v)) for v in
                                 jcf.conv2d_nhwc(x, w, s, p, stats=True))
        got, acc, (got_s, got_ss) = emulate_conv(t(x), t(w), s, p)
        acc = acc[:want.reshape(-1, w.shape[3]).shape[0]].double()
        # the kernel's sums against float64 sums of its own accumulator,
        # and against the reference's sums of its own conv
        assert _rel(got_s, acc) <= pcf.STATS_RTOL
        assert _rel(got_ss, acc.square()) <= pcf.STATS_RTOL
        ref = want.reshape(-1, w.shape[3]).double()
        assert _rel(got_s, ref) <= pcf.STATS_RTOL
        assert _rel(got_ss, ref.square()) <= pcf.STATS_RTOL
        torch.testing.assert_close(want_s, got_s, **TOL)
        torch.testing.assert_close(want_ss, got_ss, **TOL)
    else:
        want = torch.from_numpy(np.array(jcf.conv2d_nhwc(
            x, w, s, p, affine=(a, b), residual=r, act="relu")))
        got = emulate_conv(t(x), t(w), s, p, affine=(t(a), t(b)),
                           residual=t(r), act="relu")[0]
    torch.testing.assert_close(got, want, **TOL)


def test_single_pass_tf32_misses_the_bar_at_k4608():
    """At K = 4608 single-pass TF32 misses atol = rtol = 1e-4 where
    split-TF32 meets it."""
    x, w, _, _, _ = _operands(1, SHAPES[0])
    want = torch.from_numpy(np.array(jcf.conv2d_nhwc(x, w, 1, 1)))
    t = torch.from_numpy
    split = emulate_conv(t(x), t(w), 1, 1)[0]
    single = emulate_conv(t(x), t(w), 1, 1, single_pass=True)[0]
    torch.testing.assert_close(split, want, **TOL)
    assert not torch.allclose(single, want, **TOL)


def test_stats_order_is_the_kernels():
    """The emulated partials take the kernel's rows in the kernel's
    order: at a 128-row tile whose values span 2^24 (so the order shows
    in the rounding), they equal, bit for bit, a scalar float32 loop
    over the fragment layout (warp wm, row group g, rows wm * 64 + 16 i
    + g + 8 h for i, h in order; then g pairwise; then the warps)."""
    rng = np.random.RandomState(2)
    acc = (rng.randn(128, 3) * 2.0 ** rng.randint(0, 24, (128, 3))) \
        .astype(np.float32)
    s, _ = _stats(torch.from_numpy(acc))
    f = np.float32
    for col in range(3):
        tot = f(0)
        for wm in range(WM):
            per_g = []
            for g in range(8):
                v = f(0)
                for i in range(4):
                    for h in range(2):
                        v = f(v + acc[wm * 64 + 16 * i + g + 8 * h, col])
                per_g.append(v)
            while len(per_g) > 1:
                per_g = [f(per_g[j] + per_g[j + 1])
                         for j in range(0, len(per_g), 2)]
            tot = f(tot + per_g[0])
        assert s[col].item() == tot
