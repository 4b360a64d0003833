"""K6's bf16 wgmma form on the CPU: the addressing of its producer, and
the plain version it is held to at its new card shapes.

The wgmma form (``csrc/conv_fused.cu``, ``Im2colLoad``) loads A by TMA's
im2col mode and W by a rank-3 tensor map.  A CUDA kernel cannot run
here, so this file restates in torch what the producer computes and
what the hardware does with it, and assembles the product from those
boxes alone:

- the producer: K tile kt is tap = kt // ceil(Ci / 64) and channels c0
  = 64 (kt mod ceil(Ci / 64)), (kh, kw) = divmod(tap, KW); a tile's box
  starts at its first output pixel m0 = (n, ho, wo) as input pixel
  (w, h) = (wo sw - pw, ho sh - ph) of image n, with im2col offsets
  (kw, kh);
- TMA's im2col box: 128 pixels x 64 channels, walked from that pixel by
  the element strides (sw, sh) through the bounding box of top-left
  taps, whose corners are {-pw, -ph} and (W - 1, H - 1) + {pw - (KW -
  1), ph - (KH - 1)}: past the box's right edge to its left edge one
  row down, past its bottom to the next image; each pixel read at (w +
  kw, h + kh), zeros past the image, past the last image and past Ci;
- W's box: 64 ci x 64 co of one tap of w as [KH KW, Ci, Co], zeros past
  Ci (never the next tap's rows) and past Co.

On integer data the sums are exact in float64, so A @ W assembled from
the boxes must equal ``F.conv2d`` bit for bit, at the ResNet-50 path's
20 conv shapes at batch 2 (the stem, which runs on ``mma.sync``,
padded to Ci = 8 as a check that its corners fit a rank-4 map) and at
the card tests' ragged shapes; the rows of the last tile past M must be
zeros (they add nothing to the statistics).  Then the bf16 plain
version against the JAX package's ``conv2d_nhwc`` (its XLA branch) at
the shapes the card tests add for this form, within one bf16 ulp plus
1e-6 of max |Y| and ``STATS_RTOL``, as ``test_torch_conv_bf16.py``
holds the others.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from paddle_tpu.kernels import conv_fused as jconv
from paddle_tpu_torch.kernels import conv_fused as tconv
from paddle_tpu_torch.kernels.conv_fused import STATS_RTOL, bf16_ulp

BM, BK = 128, 64   # the wgmma tile's rows and K tile depth
# a rank-4 im2col map's box corners are 8-bit
CORNER_MIN, CORNER_MAX = -128, 127

# the conv stages (H, Ci, Co, k, stride, pad) of the fused ResNet-50
# forward (flowers, 224 x 224), as chip_smoke.py and gemm_forms.py read
# them off the program
PATH_SHAPES = [(14, 256, 256, 3, 1, 1), (28, 128, 128, 3, 1, 1),
               (7, 512, 512, 3, 1, 1), (55, 64, 64, 3, 1, 1),
               (14, 256, 1024, 1, 1, 0), (14, 1024, 256, 1, 1, 0),
               (28, 128, 512, 1, 1, 0), (55, 64, 256, 1, 1, 0),
               (28, 512, 128, 1, 1, 0), (7, 512, 2048, 1, 1, 0),
               (224, 3, 64, 7, 2, 3), (55, 256, 512, 1, 2, 0),
               (28, 512, 1024, 1, 2, 0), (14, 1024, 2048, 1, 2, 0),
               (7, 2048, 512, 1, 1, 0), (55, 256, 64, 1, 1, 0),
               (55, 256, 128, 1, 2, 0), (28, 512, 256, 1, 2, 0),
               (14, 1024, 512, 1, 2, 0), (55, 64, 64, 1, 1, 0)]
# (N, H, Ci, Co, k, stride, pad) of the card tests' wgmma shapes
# (tests/test_torch_cuda.py CONV_BF16_SHAPES with Ci % 8 == 0 as
# launched): Ci = 5 padded to 8, a K tail (Ci = 40), Co = 64 at 56 x 56,
# Co = 2048, a strided 1x1 at ragged M, a 7 x 7 3x3 at K = 4608, a
# Co = 64 1x1 at ragged M
RAGGED_SHAPES = [(2, 9, 8, 64, 3, 1, 1), (1, 5, 40, 256, 3, 1, 1),
                 (2, 56, 64, 64, 3, 1, 1), (4, 7, 512, 2048, 1, 1, 0),
                 (3, 9, 256, 512, 1, 2, 0), (2, 7, 512, 512, 3, 1, 1),
                 (3, 11, 256, 64, 1, 1, 0)]
NEW_CARD_SHAPES = RAGGED_SHAPES[4:]


def _out_hw(h, k, s, p):
    return (h + 2 * p - k) // s + 1


def _pairs(*vals):
    return [v if isinstance(v, tuple) else (v, v) for v in vals]


def tile_start(m0, ho_, wo_, s, p):
    """Im2colLoad::start: the tile's first output pixel (n, ho, wo) as
    image n and its top-left tap (h, w) in x; s and p are (h, w)."""
    hw = ho_ * wo_
    n = m0 // hw
    q = m0 - n * hw
    ho = q // wo_
    return n, ho * s[0] - p[0], (q - ho * wo_) * s[1] - p[1]


def k_tile(kt, ci, kw_):
    """Im2colLoad::load's K tile kt: (tap, c0, kh, kw)."""
    cit = -(-ci // BK)
    tap = kt // cit
    kh, kw = divmod(tap, kw_)
    return tap, (kt - tap * cit) * BK, kh, kw


def im2col_walk(n, h, w, dims, k, s, p):
    """TMA's walk of a box's BM pixels from (n, h, w) (tensors [T], one a
    tile) through the bounding box of top-left taps: [T, BM] each.
    dims (N, H, W); k, s, p the filter, strides and paddings, each an
    int or (h, w)."""
    _, hh, ww = dims
    k, s, p = _pairs(k, s, p)
    # the map's corners, {W, H} as the launcher passes them
    lower = (-p[1], -p[0])
    upper = (p[1] - (k[1] - 1), p[0] - (k[0] - 1))
    for v in lower + upper:
        assert CORNER_MIN <= v <= CORNER_MAX, "corner past a rank-4 map"
    w_last, h_last = ww - 1 + upper[0], hh - 1 + upper[1]
    assert w_last >= lower[0] and h_last >= lower[1], "an empty box"
    ns, hs, ws = [], [], []
    for _ in range(BM):
        ns.append(n)
        hs.append(h)
        ws.append(w)
        w = w + s[1]
        wrap = w > w_last
        w = torch.where(wrap, torch.full_like(w, lower[0]), w)
        h = torch.where(wrap, h + s[0], h)
        wrap = h > h_last
        h = torch.where(wrap, torch.full_like(h, lower[1]), h)
        n = torch.where(wrap, n + 1, n)
    return torch.stack(ns, 1), torch.stack(hs, 1), torch.stack(ws, 1)


def im2col_box(x, walk, c0, kh, kw):
    """The A box [T, BM, BK] of channels c0 .. c0 + 63 at tap (kh, kw):
    each walked pixel read at (h + kh, w + kw), zeros past x's edges
    (past its images, rows, columns and channels)."""
    nn_, hh, ww, ci = x.shape
    n, h, w = walk
    h, w = h + kh, w + kw
    ok = (n < nn_) & (h >= 0) & (h < hh) & (w >= 0) & (w < ww)
    idx = torch.where(ok, (n * hh + h) * ww + w, torch.zeros_like(n))
    cols = x.reshape(-1, ci)[:, c0:c0 + BK]
    box = torch.zeros(*idx.shape, BK, dtype=x.dtype)
    box[..., :cols.shape[1]] = cols[idx]
    return box * ok[..., None]


def w_box(w3, tap, c0, n0):
    """W's box [BK, 64] of w3 [taps, Ci, Co] at (n0 co, c0 ci, tap),
    zeros past Ci and Co."""
    _, ci, co = w3.shape
    box = torch.zeros(BK, 64, dtype=w3.dtype)
    rows, cols = min(BK, ci - c0), min(64, co - n0)
    box[:rows, :cols] = w3[tap, c0:c0 + rows, n0:n0 + cols]
    return box


def emulate(x, w, s, p, bn):
    """The wgmma form's product out [tiles x BM, Co rounded up to BN]
    assembled from its boxes alone, tile by tile and K tile by K tile;
    s and p each an int or (h, w)."""
    nn_, h, wd, ci = x.shape
    kh_, kw_, _, co = w.shape
    s, p = _pairs(s, p)
    ho, wo = _out_hw(h, kh_, s[0], p[0]), _out_hw(wd, kw_, s[1], p[1])
    m = nn_ * ho * wo
    tiles = -(-m // BM)
    starts = [tile_start(t * BM, ho, wo, s, p) for t in range(tiles)]
    n, hs, ws = (torch.tensor(v) for v in zip(*starts))
    walk = im2col_walk(n, hs, ws, (nn_, h, wd), (kh_, kw_), s, p)
    w3 = w.reshape(kh_ * kw_, ci, co)
    cols = -(-co // bn) * bn
    out = torch.zeros(tiles * BM, cols, dtype=x.dtype)
    nk = kh_ * kw_ * -(-ci // BK)
    for kt in range(nk):
        tap, c0, kh, kw = k_tile(kt, ci, kw_)
        a = im2col_box(x, walk, c0, kh, kw).reshape(-1, BK)
        for n0 in range(0, cols, 64):
            out[:, n0:n0 + 64] += a @ w_box(w3, tap, c0, n0)
    return out, m


def _int_operands(n, hw, ci, co, k, seed):
    rng = np.random.RandomState(seed)
    (h, wd), (kh, kw) = _pairs(hw, k)
    x = torch.from_numpy(rng.randint(-2, 3, (n, h, wd, ci)).astype(np.float64))
    w = torch.from_numpy(rng.randint(-2, 3, (kh, kw, ci, co)).astype(
        np.float64))
    return x, w


def _check_assembly(n, hw, ci, co, k, s, p, seed=0):
    """hw, k, s, p each an int or (h, w)."""
    x, w = _int_operands(n, hw, ci, co, k, seed)
    want = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), None, s,
                    p).permute(0, 2, 3, 1).reshape(-1, co)
    bn = 128 if co >= 128 else 64
    got, m = emulate(x, w, s, p, bn)
    assert torch.equal(got[:m, :co], want)
    assert not got[m:].any()      # TMA's zeros past the last image
    assert not got[:, co:].any()  # W's zeros past Co


@pytest.mark.parametrize("shape", PATH_SHAPES,
                         ids=["x".join(map(str, s)) for s in PATH_SHAPES])
def test_im2col_boxes_assemble_the_conv_at_the_path_shapes(shape):
    h, ci, co, k, s, p = shape
    _check_assembly(2, h, ci + (-ci) % 8, co, k, s, p)


@pytest.mark.parametrize("shape", RAGGED_SHAPES,
                         ids=["x".join(map(str, s)) for s in RAGGED_SHAPES])
def test_im2col_boxes_assemble_the_conv_at_the_ragged_shapes(shape):
    _check_assembly(*shape, seed=1)


# (N, (H, W), Ci, Co, (KH, KW), (sh, sw), (ph, pw)): windows that are not
# square, where a swap of the corners' or offsets' {W, H} order shows
RECT_SHAPES = [(2, (9, 11), 16, 64, (1, 3), (2, 1), (0, 1)),
               (3, (7, 5), 24, 128, (3, 1), (1, 2), (1, 0)),
               (2, (12, 10), 8, 64, (5, 3), (2, 3), (2, 1))]


@pytest.mark.parametrize("shape", RECT_SHAPES,
                         ids=["rect%d" % i for i in range(len(RECT_SHAPES))])
def test_im2col_boxes_assemble_the_conv_on_rectangular_windows(shape):
    _check_assembly(*shape, seed=2)


def test_the_path_shapes_are_the_programs():
    """PATH_SHAPES are the fused ResNet-50 program's conv stages."""
    from paddle_tpu_torch.tools.gemm_forms import resnet50_conv_shapes

    assert sorted(resnet50_conv_shapes()) == sorted(PATH_SHAPES)


def test_the_walk_wraps_rows_and_images_by_the_strides():
    """A 1x1 stride-2 conv on 5 x 5 images: the box's pixels are the
    even input pixels, row by row, then the next image's."""
    n, h, w = im2col_walk(torch.tensor([0]), torch.tensor([0]),
                          torch.tensor([0]), (3, 5, 5), 1, 2, 0)
    first = [(int(a), int(b), int(c))
             for a, b, c in zip(n[0, :10], h[0, :10], w[0, :10])]
    assert first == [(0, 0, 0), (0, 0, 2), (0, 0, 4), (0, 2, 0), (0, 2, 2),
                     (0, 2, 4), (0, 4, 0), (0, 4, 2), (0, 4, 4), (1, 0, 0)]


def test_the_walk_starts_in_the_padding_and_spans_the_output():
    """A 3x3 pad-1 conv: a box starts at top-left tap (-1, -1) and
    steps through Wo = W positions a row, the last at W - 2."""
    n, h, w = im2col_walk(torch.tensor([0]), torch.tensor([-1]),
                          torch.tensor([-1]), (1, 4, 4), 3, 1, 1)
    assert [int(v) for v in w[0, :5]] == [-1, 0, 1, 2, -1]
    assert [int(v) for v in h[0, :5]] == [-1, -1, -1, -1, 0]
    assert int(n[0, 16]) == 1    # the 17th pixel is past the one image


def test_k_tiles_cover_each_tap_and_its_channels_once():
    ci, k = 40, 3
    seen = [k_tile(kt, ci, k) for kt in range(k * k * -(-ci // BK))]
    assert [(kh, kw) for _, _, kh, kw in seen] == [
        divmod(t, k) for t in range(k * k)]
    seen = [k_tile(kt, 512, 3)[:2] for kt in range(9 * 8)]
    assert seen == [(t, 64 * c) for t in range(9) for c in range(8)]


def test_the_stems_corners_fit_a_rank4_map():
    """The stem (7x7, pad 3) and the path's 3x3 stages need corners
    -3 and -1: inside [-128, 127]; a pad of 129 is not."""
    _check_assembly(1, 30, 8, 64, 7, 2, 3)
    with pytest.raises(AssertionError, match="corner"):
        im2col_walk(torch.tensor([0]), torch.tensor([0]), torch.tensor([0]),
                    (1, 300, 300), 3, 1, 129)


# -- the plain version at the new card shapes --------------------------------

def _inputs(shape, seed=0):
    n, h, ci, co, k, s, p = shape
    ho = _out_hw(h, k, s, p)
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(np.float32)
    a = (rng.rand(co) + 0.5).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    r = rng.randn(n, ho, ho, co).astype(np.float32)
    return x, w, a, b, r, (s, s), (p, p)


def _bf16(v):
    return torch.from_numpy(v).to(torch.bfloat16)


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


@pytest.mark.parametrize("shape", NEW_CARD_SHAPES,
                         ids=["x".join(map(str, s)) for s in NEW_CARD_SHAPES])
@pytest.mark.parametrize("mode", ["stats", "affine+residual+relu"])
def test_plain_bf16_conv_stage_matches_the_reference(shape, mode):
    x, w, a, b, r, strides, paddings = _inputs(shape)
    tx, tw, tr = _bf16(x), _bf16(w), _bf16(r)
    jx, jw, jr = (jnp.asarray(v).astype(jnp.bfloat16) for v in (x, w, r))
    if mode == "stats":
        got = tconv.conv2d_nhwc(tx, tw, strides, paddings, stats=True)
        want = jconv.conv2d_nhwc(jx, jw, strides, paddings, stats=True)
    else:
        got = (tconv.conv2d_nhwc(
            tx, tw, strides, paddings, affine=(torch.from_numpy(a),
                                               torch.from_numpy(b)),
            residual=tr, act="relu"),)
        want = (jconv.conv2d_nhwc(jx, jw, strides, paddings,
                                  affine=(jnp.asarray(a), jnp.asarray(b)),
                                  residual=jr, act="relu"),)
    y, jy = got[0], want[0]
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert tuple(y.shape) == tuple(jy.shape)
    jyf = _f32(jy).astype(np.float64)
    bound = bf16_ulp(torch.from_numpy(jyf)).numpy() + \
        1e-6 * np.abs(jyf).max()
    err = np.abs(_f32(y).astype(np.float64) - jyf)
    assert np.all(err <= bound), float((err / bound).max())
    if mode != "stats":
        return
    xv, wv = tconv.nchw_views(tx.double(), tw.double())
    terms = F.conv2d(xv, wv, None, strides, paddings).permute(0, 2, 3, 1)
    terms = terms.reshape(-1, terms.shape[-1])
    for got_s, want_s, t in ((got[1], want[1], terms),
                             (got[2], want[2], terms.square())):
        assert got_s.dtype == torch.float32
        mag, exact = t.abs().sum(0).numpy(), t.sum(0).numpy()
        for v in (got_s.double().numpy(), np.asarray(want_s, np.float64)):
            assert np.all(np.abs(v - exact) <= STATS_RTOL * mag)
