"""Specialty operators closing the reference op census.

Counterpart of ``paddle_tpu/ops/misc.py`` (reference
operators/{conv_shift,fake_dequantize,polygon_box_transform,
pool_with_index,unpool,roi_pool,positive_negative_pair}_op.cc and the
scale_sub_region layer).  Plain torch on the op's device; no TPU kernel
is behind any of them.  ``positive_negative_pair`` is a host op, its
numpy body a copy of the JAX package's.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.detection import _read_host, write_host
from paddle_tpu_torch.ops.io_ops import _host


@register_op("conv_shift")
def _conv_shift(ctx, ins, attrs, op=None):
    """Circular correlation (reference conv_shift_op.cc): X [B, M],
    Y [B, N] with N odd, N <= M; Out[b, i] = sum_j X[b, (i + j - N/2)
    % M] * Y[b, j]."""
    x, y = ins["X"], ins["Y"]
    m, n = x.shape[1], y.shape[1]
    dev = x.device
    offs = (torch.arange(m, device=dev)[:, None] +
            torch.arange(n, device=dev)[None, :] - n // 2) % m
    gathered = x[:, offs]                                  # [B, M, N]
    return {"Out": torch.einsum("bmn,bn->bm", gathered, y)}


@register_op("fake_dequantize_max_abs", grad_maker=None)
def _fake_dequantize_max_abs(ctx, ins, attrs, op=None):
    """Out = Scale * X / max_range (reference fake_dequantize_op.cc), the
    int8 simulation's dequantize step, in f32."""
    x = ins["X"].float()
    scale = ins["Scale"].reshape(()).float()
    return {"Out": x * scale / float(attrs.get("max_range", 127.0))}


@register_op("polygon_box_transform", grad_maker=None)
def _polygon_box_transform(ctx, ins, attrs, op=None):
    """EAST-style geometry decode (reference
    polygon_box_transform_op.cc): Input [N, K * 2, H, W] per-pixel
    offsets; Output = 4 * the pixel's column (even channels) or row (odd
    channels) minus the offset."""
    x = ins["Input"]
    n, c, h, w = x.shape
    xs = torch.arange(w, dtype=x.dtype, device=x.device)[
        None, None, None, :] * 4
    ys = torch.arange(h, dtype=x.dtype, device=x.device)[
        None, None, :, None] * 4
    is_x = (torch.arange(c, device=x.device) % 2 == 0)[None, :, None, None]
    return {"Output": torch.where(is_x, xs, ys) - x}


def _pool_index_common(x, ksize, strides, paddings):
    """Max pool returning the values and the flat argmax h * W + w within
    each input map (reference pool_with_index_op.h), over explicit
    windows as the JAX package builds them: the value's gradient splits
    a tie evenly (``amax``, jax's max reduction), the index is the first
    maximum."""
    n, c, h, w = x.shape
    kh, kw = ksize
    sh, sw = strides
    ph, pw = paddings
    oh = (h + 2 * ph - kh) // sh + 1
    ow = (w + 2 * pw - kw) // sw + 1
    dev = x.device
    xp = F.pad(x, (pw, pw, ph, ph), value=torch.finfo(x.dtype).min)
    # index map of the ORIGINAL coordinates, padded with -1
    flat_idx = (torch.arange(h, device=dev)[:, None] * w +
                torch.arange(w, device=dev)[None, :]).to(torch.int32)
    idxp = F.pad(flat_idx, (pw, pw, ph, ph), value=-1)
    hh = torch.arange(oh, device=dev)[:, None] * sh + \
        torch.arange(kh, device=dev)[None, :]               # [OH, KH]
    ww = torch.arange(ow, device=dev)[:, None] * sw + \
        torch.arange(kw, device=dev)[None, :]               # [OW, KW]
    win = xp[:, :, hh[:, :, None, None], ww[None, None, :, :]]
    # [N, C, OH, KH, OW, KW] -> [N, C, OH, OW, KH * KW]
    win = win.movedim(3, 4).reshape(n, c, oh, ow, kh * kw)
    out = win.amax(dim=-1)
    arg = torch.argmax(win.detach(), dim=-1)
    iwin = idxp[hh[:, :, None, None], ww[None, None, :, :]]
    iwin = iwin.movedim(1, 2).reshape(oh, ow, kh * kw)
    mask = torch.gather(iwin.expand(n, c, oh, ow, kh * kw), -1,
                        arg[..., None])[..., 0]
    return out, mask.to(torch.int32)


@register_op("max_pool2d_with_index", no_vjp_outputs=("Mask",))
def _max_pool2d_with_index(ctx, ins, attrs, op=None):
    ksize = [int(k) for k in attrs["ksize"]]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    paddings = [int(p) for p in attrs.get("paddings", [0, 0])]
    out, mask = _pool_index_common(ins["X"], ksize, strides, paddings)
    return {"Out": out, "Mask": mask}


@register_op("unpool")
def _unpool(ctx, ins, attrs, op=None):
    """Max unpooling (reference unpool_op.cc): X put back at the
    positions Indices recorded, zeros elsewhere.

    It ASSIGNS: overlapping pooling windows record one source position
    several times, and it gets one value, not their sum.  Of the
    duplicates, the last in flat order writes, as jax's scatter-set does
    on the host, and only it receives the gradient (jax's scatter jvp
    masks every other duplicate): the winner is picked by a max over the
    updates' ids, which no arrival order moves, and the losers write to
    a spare column that is dropped, as an index of -1 (a pad-region
    argmax) is."""
    x = ins["X"]                                  # [N, C, OH, OW]
    idx = ins["Indices"].long()
    ksize = [int(k) for k in attrs["ksize"]]
    strides = [int(s) for s in attrs.get("strides", [1, 1])]
    paddings = [int(p) for p in attrs.get("paddings", [0, 0])]
    n, c, oh, ow = x.shape
    h = (oh - 1) * strides[0] - 2 * paddings[0] + ksize[0]
    w = (ow - 1) * strides[1] - 2 * paddings[1] + ksize[1]
    k = oh * ow
    sc = idx.reshape(n, c, k)
    sc = torch.where(sc < 0, h * w, sc)
    ids = torch.arange(k, device=x.device).expand(n, c, k)
    last = torch.full((n, c, h * w + 1), -1, dtype=torch.int64,
                      device=x.device).scatter_reduce(
        2, sc, ids, reduce="amax")
    wins = torch.gather(last, 2, sc) == ids
    tgt = torch.where(wins & (sc < h * w), sc, h * w)
    flat = torch.zeros((n, c, h * w + 1), dtype=x.dtype,
                       device=x.device).scatter(2, tgt, x.reshape(n, c, k))
    return {"Out": flat[:, :, :h * w].reshape(n, c, h, w)}


class _RoiPool(torch.autograd.Function):
    """ROI max pooling as the JAX package defines it: each cell the
    maximum of a masked full-map reduction over its [hstart, hend) x
    [wstart, wend) rectangle (the reference's floor / ceil bounds make
    adjacent cells overlap, so a pixel may win two cells), Argmax the
    first maximum in h * W + w order, an empty cell 0.

    A rectangle's maximum is taken in two passes: each column band j's
    row maxima over [wstart, wend) (one pass over the map a band), then
    over each row band's rows (small).  The first maximum in row-major
    order is the first row reaching it, at that row's first column.  The
    backward splits a cell's cotangent evenly over the rectangle's
    positions holding its maximum, as jax's max reduction does, again
    one pass over the map a column band: such a position's row maximum
    over the band equals the cell's."""

    @staticmethod
    def _bands(rois, scale, ph, pw, h, w):
        """Each ROI's image and its cells' row and column masks [R, PH, H]
        and [R, PW, W]."""
        dev = rois.device
        b = rois[:, 0].to(torch.int64)
        x1, y1, x2, y2 = [torch.round(rois[:, i] * scale).to(torch.int32)
                          for i in (1, 2, 3, 4)]
        rh = (y2 - y1 + 1).clamp_min(1).float()
        rw = (x2 - x1 + 1).clamp_min(1).float()

        def band(start, size, n, extent):
            k = torch.arange(n, device=dev)[None, :]
            # a true division by a device tensor: CUDA divides by a host
            # scalar as a product with its reciprocal, whose rounding
            # moves floor / ceil at exact multiples
            nt = torch.full((), float(n), device=dev)
            lo = start[:, None] + torch.floor(k * size[:, None] / nt).to(
                torch.int32)
            hi = start[:, None] + torch.ceil((k + 1) * size[:, None] / nt).to(
                torch.int32)
            pos = torch.arange(extent, device=dev)[None, None, :]
            return (pos >= lo[:, :, None]) & (pos < hi[:, :, None])

        return b, band(y1, rh, ph, h), band(x1, rw, pw, w)

    @staticmethod
    def _rows(img, mw_j, neg):
        """Band j's row maxima [R, C, H] over its columns, and the map
        with the other columns masked."""
        v = img.masked_fill(~mw_j[:, None, None, :], neg)
        return v.amax(dim=-1), v

    @staticmethod
    def forward(ctx, x, rois, scale, ph, pw):
        n, c, h, w = x.shape
        r = rois.shape[0]
        b, mh, mw = _RoiPool._bands(rois, scale, ph, pw, h, w)
        img = x[b]                                        # [R, C, H, W]
        neg = torch.finfo(x.dtype).min
        out = x.new_zeros((r, c, ph, pw))
        arg = torch.zeros((r, c, ph, pw), dtype=torch.int32,
                          device=x.device)
        for j in range(pw):
            rowmax, v = _RoiPool._rows(img, mw[:, j], neg)
            rowarg = torch.argmax(v, dim=-1)              # first column
            del v
            for i in range(ph):
                rm = rowmax.masked_fill(~mh[:, i, None, :], neg)
                best = rm.amax(dim=-1)
                h_arg = torch.argmax(rm, dim=-1)          # first row
                w_arg = rowarg.gather(-1, h_arg[..., None])[..., 0]
                any_m = (mh[:, i].any(dim=1) & mw[:, j].any(dim=1))[:, None]
                out[:, :, i, j] = torch.where(any_m, best, 0.0)
                arg[:, :, i, j] = torch.where(
                    any_m, (h_arg * w + w_arg).to(torch.int32), 0)
        ctx.save_for_backward(x, rois, out)
        ctx.args = (scale, ph, pw)
        return out, arg

    @staticmethod
    def backward(ctx, g_out, g_arg):
        x, rois, out = ctx.saved_tensors
        scale, ph, pw = ctx.args
        n, c, h, w = x.shape
        r = rois.shape[0]
        b, mh, mw = _RoiPool._bands(rois, scale, ph, pw, h, w)
        img = x[b]
        neg = torch.finfo(x.dtype).min
        g_img = torch.zeros_like(img)
        for j in range(pw):
            rowmax, v = _RoiPool._rows(img, mw[:, j], neg)
            at_max = v == rowmax[..., None]               # within band j
            del v
            rowcnt = at_max.sum(dim=-1)                   # [R, C, H]
            share = torch.zeros_like(rowmax)              # [R, C, H]
            for i in range(ph):
                any_m = (mh[:, i].any(dim=1) & mw[:, j].any(dim=1))[:, None]
                rows = mh[:, i, None, :] & (rowmax == out[:, :, i, j, None])
                cnt = (rows * rowcnt).sum(dim=-1).clamp_min(1)
                g = torch.where(any_m, g_out[:, :, i, j] / cnt, 0.0)
                share += rows * g[..., None]
            g_img += at_max * share[..., None]
        # each image's ROIs summed in ROI order: a one-hot product, no
        # atomics
        onehot = (b[None, :] == torch.arange(n, device=x.device)[:, None])
        g_x = (onehot.to(g_img.dtype) @ g_img.reshape(r, -1)).reshape(
            n, c, h, w)
        return g_x, None, None, None, None


@register_op("roi_pool", no_vjp_outputs=("Argmax",))
def _roi_pool(ctx, ins, attrs, op=None):
    """ROI max pooling (reference roi_pool_op.cc): X [N, C, H, W]; ROIs
    [R, 5] rows [batch_idx, x1, y1, x2, y2] in image coordinates, scaled
    by spatial_scale.  Out [R, C, PH, PW], Argmax the flat h * W + w of
    each cell's first maximum (0 in an empty cell)."""
    x = ins["X"]
    rois = ins["ROIs"].float()
    scale = float(attrs.get("spatial_scale", 1.0))
    ph, pw = int(attrs["pooled_height"]), int(attrs["pooled_width"])
    if x.device.type == "meta":
        shape = (rois.shape[0], x.shape[1], ph, pw)
        return {"Out": x.new_empty(shape),
                "Argmax": torch.empty(shape, dtype=torch.int32,
                                      device=x.device)}
    out, arg = _RoiPool.apply(x, rois, scale, ph, pw)
    return {"Out": out, "Argmax": arg}


@_host("positive_negative_pair")
def _positive_negative_pair(executor, op, scope, feed, env=None):
    """Ranking-pair metric (reference positive_negative_pair_op.cc):
    within each query id, count prediction-score pairs ordered
    consistently (positive) / inconsistently (negative) with the label
    order; a score tie increments NeutralPair by 1."""
    def read(name):
        return _read_host(scope, feed, env, name)

    score = read(op.input("Score")[0]).reshape(-1)
    label = read(op.input("Label")[0]).reshape(-1)
    qid = read(op.input("QueryID")[0]).reshape(-1)
    pos = neg = neu = 0.0
    for q in np.unique(qid):
        idx = np.where(qid == q)[0]
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                i, j = idx[a], idx[b]
                if label[i] == label[j]:
                    continue
                ds = score[i] - score[j]
                dl = label[i] - label[j]
                if ds == 0:
                    neu += 1
                elif (ds > 0) == (dl > 0):
                    pos += 1
                else:
                    neg += 1
    outs = {"PositivePair": pos, "NegativePair": neg,
            "NeutralPair": neu}
    for slot, val in outs.items():
        names = op.outputs.get(slot) or []
        if names and names[0]:
            write_host(executor, scope, env, names[0],
                       np.asarray([val], np.float32))


@register_op("scale_sub_region")
def _scale_sub_region(ctx, ins, attrs, op=None):
    """Scale a per-sample [C, H, W] sub-box by ``value`` (reference
    ScaleSubRegionLayer).  Indices [N, 6] rows are 1-based inclusive
    (c0, c1, h0, h1, w0, w1); a mask of per-sample bounds against
    iotas."""
    x = ins["X"]
    idx = ins["Indices"].to(torch.int32)
    value = float(attrs.get("value", 1.0))
    n, c, h, w = x.shape

    def bounds(lo, hi, size, axis_pos):
        pos = torch.arange(size, device=x.device).reshape(
            (1,) + (1,) * axis_pos + (size,) + (1,) * (2 - axis_pos))
        lo = (lo - 1).reshape(n, 1, 1, 1)
        hi = (hi - 1).reshape(n, 1, 1, 1)
        return (pos >= lo) & (pos <= hi)

    mask = (bounds(idx[:, 0], idx[:, 1], c, 0) &
            bounds(idx[:, 2], idx[:, 3], h, 1) &
            bounds(idx[:, 4], idx[:, 5], w, 2))
    return {"Out": torch.where(mask, x * value, x)}
