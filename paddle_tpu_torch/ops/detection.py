"""Detection (SSD) operators.

Counterpart of ``paddle_tpu/ops/detection.py`` (reference
paddle/fluid/operators/detection/ — prior_box_op.cc, iou_similarity_op.h,
box_coder_op.h, bipartite_match_op.cc, target_assign_op.h,
mine_hard_examples_op.cc, multiclass_nms_op.cc, detection_map_op.cc).

The dense geometry (priors, IoU matrices, box encode / decode, matching,
mining, target assignment) is torch on the op's device; no TPU kernel is
behind any of it.  On a card nothing here reads a value back to the host,
so the SSD training step captures as one CUDA graph:

- ``prior_box`` depends only on its attrs and its inputs' shapes: a
  prepared step makes its priors once, on the device
  (``ops/tensor.CONSTANT_OPS``); ``run()`` makes them each step, in f32
  on the host in the JAX package's order of operations, and copies them.
- ``bipartite_match``'s greedy loop runs G device argmaxes (G the padded
  gt count), each taking the first maximum as ``jnp.argmax`` does, and
  updates its state with masks, never a branch on a value.
- ``mine_hard_examples`` ranks by a stable sort, as ``jnp.argsort`` is:
  tied negative losses (common at initialisation) keep prior order on
  the card too.

``multiclass_nms`` and ``detection_map`` stay host ops, as in the JAX
package and the reference (CPU-only kernels there): their numpy bodies
are copies of the JAX package's, with its ``'<name>@ROWS'`` per-image
detection counts.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.executor_impl import fetches_to_host
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.io_ops import _host, _install
from paddle_tpu_torch.ops.tensor import CONSTANT_OPS

_MISSING = object()


def _read_host(scope, feed, env, name, default=_MISSING):
    """env -> feed -> scope lookup shared by the host detection ops, as
    host numpy."""
    for src_ in (env, feed):
        if src_ is not None and name in src_:
            return fetches_to_host([src_[name]])[0]
    try:
        return fetches_to_host([scope.find_var(name)])[0]
    except KeyError:
        if default is not _MISSING:
            return default
        raise


def write_host(executor, scope, env, name, value):
    """A host op's numpy result on the executor's device, in the env
    (when the run has one) and in the scope that owns the name."""
    _install(executor, scope, env, name,
             torch.from_numpy(np.ascontiguousarray(value)))


# ---------------------------------------------------------------------------
# prior_box
# ---------------------------------------------------------------------------

def prior_box_arrays(attrs, h, w, img_h, img_w):
    """SSD prior boxes and variances [H, W, P, 4] of an H x W feature map
    over an img_h x img_w image, in f32 as the JAX package computes them
    (the box sizes in float64, rounded once to f32; every coordinate op
    in f32)."""
    min_sizes = [float(s) for s in attrs["min_sizes"]]
    max_sizes = [float(s) for s in attrs.get("max_sizes", [])]
    ars = [1.0]
    for ar in attrs.get("aspect_ratios", [1.0]):
        ar = float(ar)
        if not any(abs(ar - a) < 1e-6 for a in ars):
            ars.append(ar)
            if attrs.get("flip", False):
                ars.append(1.0 / ar)
    variances = [float(v) for v in
                 attrs.get("variances", [0.1, 0.1, 0.2, 0.2])]
    step_w = float(attrs.get("step_w", 0.0)) or img_w / w
    step_h = float(attrs.get("step_h", 0.0)) or img_h / h
    offset = float(attrs.get("offset", 0.5))

    # reference order per min_size: the square, each aspect ratio's box,
    # the max_size geometric-mean square
    ws, hs = [], []
    for k, ms in enumerate(min_sizes):
        ws.append(ms)
        hs.append(ms)
        for ar in ars:
            if abs(ar - 1.0) < 1e-6:
                continue
            ws.append(ms * np.sqrt(ar))
            hs.append(ms / np.sqrt(ar))
        if max_sizes:
            sq = np.sqrt(ms * max_sizes[k])
            ws.append(sq)
            hs.append(sq)
    f32 = torch.float32
    ws = torch.tensor(ws, dtype=f32)[None, None, :]
    hs = torch.tensor(hs, dtype=f32)[None, None, :]
    p = ws.shape[-1]
    cx = ((torch.arange(w, dtype=f32) + offset) * step_w)[None, :, None]
    cy = ((torch.arange(h, dtype=f32) + offset) * step_h)[:, None, None]
    xmin = (cx - ws / 2) / img_w
    xmax = (cx + ws / 2) / img_w
    ymin = (cy - hs / 2) / img_h
    ymax = (cy + hs / 2) / img_h
    boxes = torch.stack(torch.broadcast_tensors(xmin, ymin, xmax, ymax),
                        dim=-1)                              # [H, W, P, 4]
    if attrs.get("clip", False):
        boxes = boxes.clamp(0.0, 1.0)
    var = torch.tensor(variances, dtype=f32).expand(h, w, p, 4)
    return boxes.contiguous(), var.contiguous()


def prior_box_constant(attrs, device, shape_of):
    """``prior_box``'s outputs for a prepared step (CONSTANT_OPS), from
    the desc shapes of its Input and Image; None where one of those
    spatial dims is only known at run time."""
    h, w = shape_of("Input")[2:4]
    img_h, img_w = shape_of("Image")[2:4]
    if min(h, w, img_h, img_w) <= 0:
        return None
    boxes, var = prior_box_arrays(attrs, h, w, img_h, img_w)
    return {"Boxes": boxes.to(device), "Variances": var.to(device)}


CONSTANT_OPS["prior_box"] = prior_box_constant


@register_op("prior_box", grad_maker=None)
def _prior_box(ctx, ins, attrs, op=None):
    """SSD prior (anchor) boxes for one feature map (reference
    prior_box_op.cc).  Input [N, C, H, W] fixes the grid; Image
    [N, C, Hi, Wi] the normalization.  Boxes / Variances [H, W, P, 4]:
    the prepared step's device constant, else made on the host and
    copied."""
    const = ctx.constants.get(id(op)) if op is not None else None
    if const is not None:
        return dict(const)
    feat, image = ins["Input"], ins["Image"]
    h, w = feat.shape[2], feat.shape[3]
    if feat.device.type == "meta":
        probe = prior_box_arrays(attrs, 1, 1, 1, 1)[0]
        shape = (h, w, probe.shape[2], 4)
        return {"Boxes": torch.empty(shape, device=feat.device),
                "Variances": torch.empty(shape, device=feat.device)}
    boxes, var = prior_box_arrays(attrs, h, w, image.shape[2],
                                  image.shape[3])
    return {"Boxes": boxes.to(ctx.device), "Variances": var.to(ctx.device)}


# ---------------------------------------------------------------------------
# iou_similarity / box_coder
# ---------------------------------------------------------------------------

def _iou(a, b):
    """[..., Na, 4] x [Nb, 4] -> [..., Na, Nb] IoU (xmin, ymin, xmax,
    ymax)."""
    ax0, ay0, ax1, ay1 = [a[..., i] for i in range(4)]
    bx0, by0, bx1, by1 = [b[..., i] for i in range(4)]
    ix0 = torch.maximum(ax0[..., :, None], bx0[..., None, :])
    iy0 = torch.maximum(ay0[..., :, None], by0[..., None, :])
    ix1 = torch.minimum(ax1[..., :, None], bx1[..., None, :])
    iy1 = torch.minimum(ay1[..., :, None], by1[..., None, :])
    iw = (ix1 - ix0).clamp_min(0.0)
    ih = (iy1 - iy0).clamp_min(0.0)
    inter = iw * ih
    area_a = (ax1 - ax0).clamp_min(0.0) * (ay1 - ay0).clamp_min(0.0)
    area_b = (bx1 - bx0).clamp_min(0.0) * (by1 - by0).clamp_min(0.0)
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


@register_op("iou_similarity", grad_maker=None, seq_aware=True)
def _iou_similarity(ctx, ins, attrs, op=None):
    """X [N, 4] or [B, N, 4] vs Y [M, 4] -> IoU matrix (reference
    iou_similarity_op.h); Out's rows keep X's ragged lengths."""
    out = _iou(ins["X"].float(), ins["Y"].float())
    if op is not None:
        src = (op.inputs.get("X") or [None])[0]
        for nm in (op.outputs.get("Out") or []):
            if nm and src:
                lens = ctx.seq_len_of(src)
                if lens is not None:
                    ctx.set_seq_len(nm, lens)
    return {"Out": out}


def _center_size(boxes):
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    cx = boxes[..., 0] + w / 2
    cy = boxes[..., 1] + h / 2
    return cx, cy, w, h


@register_op("box_coder", grad_maker=None)
def _box_coder(ctx, ins, attrs, op=None):
    """Encode / decode boxes against priors in center-size form
    (reference box_coder_op.h).  PriorBox [M, 4], PriorBoxVar [M, 4]
    (ones when absent), TargetBox [N, M, 4] offsets (decode) or [..., G,
    4] gt boxes (encode: [..., G, M, 4])."""
    prior = ins["PriorBox"].float()
    pvar = ins.get("PriorBoxVar")
    tb = ins["TargetBox"].float()
    code_type = attrs.get("code_type", "encode_center_size")
    pcx, pcy, pw, ph = _center_size(prior)
    if pvar is None:
        pvar = torch.ones_like(prior)
    v0, v1, v2, v3 = [pvar[..., i] for i in range(4)]
    if "decode" in code_type:
        tcx = tb[..., 0] * v0 * pw + pcx
        tcy = tb[..., 1] * v1 * ph + pcy
        tw = torch.exp(tb[..., 2] * v2) * pw
        th = torch.exp(tb[..., 3] * v3) * ph
        out = torch.stack([tcx - tw / 2, tcy - th / 2,
                           tcx + tw / 2, tcy + th / 2], dim=-1)
    else:
        gcx, gcy, gw, gh = _center_size(tb)
        tx = (gcx[..., :, None] - pcx[None, :]) / pw[None, :] / v0
        ty = (gcy[..., :, None] - pcy[None, :]) / ph[None, :] / v1
        tw = torch.log((gw[..., :, None] / pw[None, :]).clamp_min(
            1e-10)) / v2
        th = torch.log((gh[..., :, None] / ph[None, :]).clamp_min(
            1e-10)) / v3
        out = torch.stack([tx, ty, tw, th], dim=-1)
    return {"OutputBox": out}


# ---------------------------------------------------------------------------
# bipartite_match / target_assign / mine_hard_examples
# ---------------------------------------------------------------------------

def _rows_lens(ctx, op, slot, b, g, device):
    names = (op.inputs.get(slot) or []) if op is not None else []
    lens = ctx.seq_len_of(names[0]) if names and names[0] else None
    if lens is None:
        return torch.full((b,), g, dtype=torch.int32, device=device)
    return lens.to(torch.int32)


@register_op("bipartite_match", grad_maker=None, seq_aware=True)
def _bipartite_match(ctx, ins, attrs, op=None):
    """Greedy bipartite matching (reference bipartite_match_op.cc):
    G times take the global maximum of DistMat [B, G, M] (gt x priors)
    over the rows and columns still free, binding that gt row and prior
    column where it is > 0; then (match_type 'per_prediction') match each
    prior still free to its best gt where that overlap exceeds
    dist_threshold.  ColToRowMatchIndices [B, M] (gt row or -1) and
    ColToRowMatchDist.  Ties take the first maximum (``jnp.argmax``'s);
    the loop never reads a value back to the host."""
    dist = ins["DistMat"].float()
    if dist.dim() == 2:
        dist = dist[None]
    b, g, m = dist.shape
    dev = dist.device
    per_pred = attrs.get("match_type", "bipartite") == "per_prediction"
    thresh = float(attrs.get("dist_threshold", 0.5))
    glens = _rows_lens(ctx, op, "DistMat", b, g, dev)

    row_ok = torch.arange(g, device=dev)[None, :] < glens[:, None]  # [B, G]
    row_valid0 = row_ok
    col_ok = torch.ones((b, m), dtype=torch.bool, device=dev)
    match = torch.full((b, m), -1, dtype=torch.int32, device=dev)
    matched_dist = torch.zeros((b, m), dtype=torch.float32, device=dev)
    bi = torch.arange(b, device=dev)
    for _ in range(g):
        masked = dist.masked_fill(
            ~(row_ok[:, :, None] & col_ok[:, None, :]), -1.0)
        flat = masked.reshape(b, g * m)
        best = torch.argmax(flat, dim=1)
        val = flat.gather(1, best[:, None])[:, 0]
        r, c = best // m, best % m
        ok = val > 0
        match = match.index_put(
            (bi, c), torch.where(ok, r.to(torch.int32), match[bi, c]))
        matched_dist = matched_dist.index_put(
            (bi, c), torch.where(ok, val, matched_dist[bi, c]))
        row_ok = row_ok.index_put((bi, r), row_ok[bi, r] & ~ok)
        col_ok = col_ok.index_put((bi, c), col_ok[bi, c] & ~ok)

    if per_pred:
        masked = dist.masked_fill(~row_valid0[:, :, None], -1.0)
        best_v, _ = torch.max(masked, dim=1)
        best_g = torch.argmax(masked, dim=1).to(torch.int32)    # [B, M]
        extra = col_ok & (best_v > thresh)
        match = torch.where(extra, best_g, match)
        matched_dist = torch.where(extra, best_v, matched_dist)
    return {"ColToRowMatchIndices": match,
            "ColToRowMatchDist": matched_dist}


@register_op("target_assign", grad_maker=None, seq_aware=True)
def _target_assign(ctx, ins, attrs, op=None):
    """Gather per-prior targets by match indices (reference
    target_assign_op.h): X [B, G, K] per-gt values, MatchIndices [B, M]
    (-1 = background).  Out [B, M, K] (mismatch_value where unmatched);
    OutWeight [B, M, 1] = 1 where matched or where NegIndices marks a
    mined negative."""
    x = ins["X"]
    match = ins["MatchIndices"].long()
    b, m = match.shape
    idx = match.clamp(0, x.shape[1] - 1)
    out = torch.gather(x, 1, idx[:, :, None].expand(b, m, x.shape[2]))
    matched = (match >= 0)[:, :, None]
    out = out.masked_fill(~matched, attrs.get("mismatch_value", 0))
    wt = matched.float()
    neg = ins.get("NegIndices")
    if neg is not None:
        wt = torch.maximum(wt, neg.float()[:, :, None])
    return {"Out": out, "OutWeight": wt}


@register_op("mine_hard_examples", grad_maker=None)
def _mine_hard_examples(ctx, ins, attrs, op=None):
    """Online hard negative mining (reference mine_hard_examples_op.cc,
    max_negative mode): rank the unmatched priors by ClsLoss and keep the
    top neg_pos_ratio * #positives of each image.  NegIndices: a [B, M]
    0/1 int32 mask (the reference's NegIndices LoD list, densified).  The
    ranking is a stable sort, so tied losses rank in prior order on
    every device, as ``jnp.argsort``'s."""
    mining = attrs.get("mining_type", "max_negative")
    if mining != "max_negative":
        raise NotImplementedError(
            "mine_hard_examples: mining_type %r is not implemented "
            "(only 'max_negative'); reference hard_example mode caps by "
            "sample_size, which max_negative honors too" % mining)
    cls_loss = ins["ClsLoss"].float()
    match = ins["MatchIndices"].to(torch.int32)
    if cls_loss.dim() == 3:
        cls_loss = cls_loss[..., 0]
    ratio = float(attrs.get("neg_pos_ratio", 3.0))
    sample_size = int(attrs.get("sample_size", -1))
    b, m = match.shape
    positive = match >= 0
    n_pos = positive.sum(dim=1, dtype=torch.int32)
    n_neg = torch.minimum((n_pos.float() * ratio).to(torch.int32),
                          m - n_pos)
    if sample_size > 0:
        n_neg = n_neg.clamp_max(sample_size)
    neg_loss = cls_loss.masked_fill(positive, -float("inf"))
    order = torch.argsort(-neg_loss, dim=1, stable=True)
    rank = torch.empty_like(order).scatter_(
        1, order, torch.arange(m, device=order.device).expand(b, m))
    neg_mask = (rank < n_neg[:, None]) & ~positive & \
        torch.isfinite(neg_loss)
    return {"NegIndices": neg_mask.to(torch.int32),
            "UpdatedMatchIndices": match}


@register_op("gather_encoded_target", grad_maker=None)
def _gather_encoded_target(ctx, ins, attrs, op=None):
    """Per-prior localization target: Out[b, m] = Encoded[b, match[b, m],
    m] (zeros where unmatched), OutWeight the matched mask [B, M, 1]."""
    enc = ins["Encoded"]                           # [B, G, M, 4]
    match = ins["MatchIndices"].long()             # [B, M]
    b, g, m, _ = enc.shape
    idx = match.clamp(0, g - 1)
    rows = torch.arange(b, device=enc.device)[:, None]
    cols = torch.arange(m, device=enc.device)[None, :]
    out = enc[rows, idx, cols]                     # [B, M, 4]
    matched = (match >= 0)[:, :, None]
    return {"Out": out.masked_fill(~matched, 0.0),
            "OutWeight": matched.float()}


# ---------------------------------------------------------------------------
# multiclass_nms / detection_map (host, as the reference's CPU kernels);
# the numpy bodies are copies of the JAX package's
# ---------------------------------------------------------------------------

def _nms_one_class(boxes, scores, score_threshold, nms_threshold, top_k,
                   eta):
    idx = np.argsort(-scores)
    idx = idx[scores[idx] > score_threshold]
    if top_k > -1:
        idx = idx[:top_k]
    keep = []
    adaptive = nms_threshold
    while idx.size:
        i = idx[0]
        keep.append(i)
        if idx.size == 1:
            break
        rest = idx[1:]
        xx0 = np.maximum(boxes[i, 0], boxes[rest, 0])
        yy0 = np.maximum(boxes[i, 1], boxes[rest, 1])
        xx1 = np.minimum(boxes[i, 2], boxes[rest, 2])
        yy1 = np.minimum(boxes[i, 3], boxes[rest, 3])
        inter = np.maximum(xx1 - xx0, 0) * np.maximum(yy1 - yy0, 0)
        area_i = max((boxes[i, 2] - boxes[i, 0]) *
                     (boxes[i, 3] - boxes[i, 1]), 0)
        area_r = np.maximum(boxes[rest, 2] - boxes[rest, 0], 0) * \
            np.maximum(boxes[rest, 3] - boxes[rest, 1], 0)
        union = area_i + area_r - inter
        iou = np.where(union > 0, inter / union, 0)
        idx = rest[iou <= adaptive]
        if eta < 1 and adaptive > 0.5:
            adaptive *= eta
    return keep


def multiclass_nms_rows(bboxes, scores, attrs):
    """Per-class NMS and the cross-class keep_top_k over host arrays:
    BBoxes [B, M, 4], Scores [B, C, M] -> (rows [No, 6] f32 [label,
    score, xmin, ymin, xmax, ymax], per-image counts int64)."""
    bg = int(attrs.get("background_label", 0))
    score_th = float(attrs.get("score_threshold", 0.01))
    nms_th = float(attrs.get("nms_threshold", 0.3))
    nms_top_k = int(attrs.get("nms_top_k", 400))
    keep_top_k = int(attrs.get("keep_top_k", 200))
    eta = float(attrs.get("nms_eta", 1.0))

    all_rows = []
    counts = []
    for b in range(bboxes.shape[0]):
        dets = []
        for c in range(scores.shape[1]):
            if c == bg:
                continue
            keep = _nms_one_class(bboxes[b], scores[b, c], score_th,
                                  nms_th, nms_top_k, eta)
            for i in keep:
                dets.append((float(scores[b, c, i]), c, i))
        dets.sort(reverse=True)
        if keep_top_k > -1:
            dets = dets[:keep_top_k]
        counts.append(len(dets))
        for s, c, i in dets:
            all_rows.append([float(c), s] + [float(v)
                                            for v in bboxes[b, i]])
    out = (np.asarray(all_rows, np.float32) if all_rows
           else np.zeros((0, 6), np.float32))
    return out, np.asarray(counts, np.int64)


@_host("multiclass_nms")
def _multiclass_nms(executor, op, scope, feed, env=None):
    """Per-class NMS + cross-class keep_top_k (reference
    multiclass_nms_op.cc, a CPU-only kernel there too).  BBoxes [B, M, 4]
    decoded boxes, Scores [B, C, M].  Out: [No, 6] rows [label, score,
    xmin, ymin, xmax, ymax]; the '@ROWS' var holds the per-image
    detection counts (the LoD analog)."""
    def read(name):
        return _read_host(scope, feed, env, name)

    attrs = {k: a.value for k, a in op.attrs.items()}
    out, counts = multiclass_nms_rows(read(op.input("BBoxes")[0]),
                                      read(op.input("Scores")[0]), attrs)
    out_name = op.output("Out")[0]
    write_host(executor, scope, env, out_name, out)
    write_host(executor, scope, env, out_name + "@ROWS", counts)


def detection_map_value(det, label, rows, glens, attrs):
    """mAP of detections ``det`` [No, 6] (``rows`` of them an image)
    against padded labels [B, G, 5] (``glens`` real rows an image)."""
    class_num = int(attrs["class_num"])
    background = int(attrs.get("background_label", 0))
    thresh = float(attrs.get("overlap_threshold", 0.5))
    ap_version = attrs.get("ap_version", "integral")

    # split detections per image
    offs = np.concatenate([[0], np.cumsum(rows)])
    n_imgs = len(rows)
    # collect (score, is_tp) per class + gt count per class
    scored = {c: [] for c in range(class_num)}
    n_gt = np.zeros(class_num, np.int64)
    for b in range(n_imgs):
        dets_b = det[offs[b]:offs[b + 1]]
        gts_b = label[b, :int(glens[b])]
        for g in gts_b:
            if int(g[0]) != background:
                n_gt[int(g[0])] += 1
        used = np.zeros(len(gts_b), bool)
        # match detections best-first within their class
        for row in dets_b[np.argsort(-dets_b[:, 1])]:
            c = int(row[0])
            if c == background:
                continue
            best, best_iou = -1, thresh
            for gi, g in enumerate(gts_b):
                if used[gi] or int(g[0]) != c:
                    continue
                ix0 = max(row[2], g[1]); iy0 = max(row[3], g[2])  # noqa: E702
                ix1 = min(row[4], g[3]); iy1 = min(row[5], g[4])  # noqa: E702
                inter = max(ix1 - ix0, 0) * max(iy1 - iy0, 0)
                ua = ((row[4] - row[2]) * (row[5] - row[3]) +
                      (g[3] - g[1]) * (g[4] - g[2]) - inter)
                iou = inter / ua if ua > 0 else 0.0
                if iou >= best_iou:
                    best, best_iou = gi, iou
            if best >= 0:
                used[best] = True
                scored[c].append((row[1], 1))
            else:
                scored[c].append((row[1], 0))

    aps = []
    for c in range(class_num):
        if c == background or n_gt[c] == 0:
            continue
        hits = sorted(scored[c], reverse=True)
        tp = np.cumsum([h[1] for h in hits]) if hits else np.zeros(0)
        fp = np.cumsum([1 - h[1] for h in hits]) if hits else \
            np.zeros(0)
        recall = tp / n_gt[c] if len(tp) else np.zeros(0)
        precision = tp / np.maximum(tp + fp, 1e-9) if len(tp) else \
            np.zeros(0)
        if ap_version == "11point":
            ap = 0.0
            for t in np.linspace(0, 1, 11):
                p = precision[recall >= t].max() if \
                    (recall >= t).any() else 0.0
                ap += p / 11.0
        else:  # integral
            ap = 0.0
            prev_r = 0.0
            for r, p in zip(recall, precision):
                ap += (r - prev_r) * p
                prev_r = r
        aps.append(ap)
    return float(np.mean(aps)) if aps else 0.0


@_host("detection_map")
def _detection_map(executor, op, scope, feed, env=None):
    """mAP metric (reference detection_map_op.cc, CPU-only there too).
    DetectRes: [No, 6] rows [label, score, x0, y0, x1, y1] with
    '<name>@ROWS' per-image counts (multiclass_nms's output layout).
    Label: padded [B, G, 5] rows [label, x0, y0, x1, y1] with '@LEN'.
    Outputs MAP [1] (11point or integral ap_version)."""
    def read(name, **kw):
        return _read_host(scope, feed, env, name, **kw)

    det_name = op.input("DetectRes")[0]
    det = read(det_name)
    label = read(op.input("Label")[0])
    rows = read(det_name + "@ROWS", default=None)
    if rows is None:
        if label.shape[0] != 1:
            raise ValueError(
                "detection_map: %r has no '@ROWS' sidecar but the "
                "label batch has %d images — per-image detection "
                "counts are required (multiclass_nms emits them)" %
                (det_name, label.shape[0]))
        rows = np.asarray([det.shape[0]])
    glens = read(op.input("Label")[0] + "@LEN",
                 default=np.full((label.shape[0],), label.shape[1]))
    attrs = {k: a.value for k, a in op.attrs.items()}
    m = detection_map_value(det, label, rows, glens, attrs)
    write_host(executor, scope, env, op.output("MAP")[0],
               np.asarray([m], np.float32))
