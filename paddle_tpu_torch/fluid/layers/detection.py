"""Detection layers (SSD family).

Counterpart of paddle_tpu/fluid/layers/detection.py, function for
function (reference python/paddle/fluid/layers/detection.py —
detection_output:46, bipartite_match:208, target_assign:278,
ssd_loss:350, prior_box:568, multi_box_head:677): the same calls build
the same ops and descs over ``ops/detection.py``.  Batch layout: gt
boxes / labels are padded [B, G, ...] with '@LEN' instead of the
reference's LoD packing.
"""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["prior_box", "multi_box_head", "bipartite_match",
           "target_assign", "box_coder", "iou_similarity", "ssd_loss",
           "detection_output", "multiclass_nms", "detection_map"]


def iou_similarity(x, y, name=None):
    helper = LayerHelper("iou_similarity", **locals())
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", name=None):
    helper = LayerHelper("box_coder", **locals())
    out = helper.create_tmp_variable(dtype="float32")
    inputs = {"PriorBox": [prior_box], "TargetBox": [target_box]}
    if prior_box_var is not None:  # op defaults variances to 1
        inputs["PriorBoxVar"] = [prior_box_var]
    helper.append_op(
        type="box_coder", inputs=inputs,
        outputs={"OutputBox": [out]},
        attrs={"code_type": code_type})
    return out


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper("bipartite_match", **locals())
    match_indices = helper.create_tmp_variable(dtype="int32")
    match_dist = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="bipartite_match", inputs={"DistMat": [dist_matrix]},
        outputs={"ColToRowMatchIndices": [match_indices],
                 "ColToRowMatchDist": [match_dist]},
        attrs={"match_type": ("bipartite" if match_type is None
                              else match_type),
               "dist_threshold": (0.5 if dist_threshold is None
                                  else dist_threshold)})
    return match_indices, match_dist


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=0, name=None):
    helper = LayerHelper("target_assign", **locals())
    out = helper.create_tmp_variable(dtype=input.dtype)
    out_weight = helper.create_tmp_variable(dtype="float32")
    inputs = {"X": [input], "MatchIndices": [matched_indices]}
    if negative_indices is not None:
        inputs["NegIndices"] = [negative_indices]
    helper.append_op(type="target_assign", inputs=inputs,
                     outputs={"Out": [out], "OutWeight": [out_weight]},
                     attrs={"mismatch_value": mismatch_value})
    return out, out_weight


def prior_box(input, image, min_sizes, max_sizes=None,
              aspect_ratios=(1.0,), variance=(0.1, 0.1, 0.2, 0.2),
              flip=False, clip=False, steps=(0.0, 0.0), offset=0.5,
              name=None):
    helper = LayerHelper("prior_box", **locals())
    boxes = helper.create_tmp_variable(dtype="float32")
    variances = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="prior_box", inputs={"Input": [input], "Image": [image]},
        outputs={"Boxes": [boxes], "Variances": [variances]},
        attrs={"min_sizes": [float(s) for s in min_sizes],
               "max_sizes": [float(s) for s in (max_sizes or [])],
               "aspect_ratios": [float(a) for a in aspect_ratios],
               "variances": [float(v) for v in variance],
               "flip": flip, "clip": clip,
               "step_w": float(steps[0]), "step_h": float(steps[1]),
               "offset": float(offset)})
    return boxes, variances


def _num_priors(mins, maxs, ars, flip):
    uniq = [1.0]
    for a in ars:
        if not any(abs(a - u) < 1e-6 for u in uniq):
            uniq.append(a)
            if flip:
                uniq.append(1.0 / a)
    return len(mins) * (len(uniq) + (len(maxs) if maxs else 0))


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=(0.1, 0.1, 0.2, 0.2), flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1,
                   name=None):
    """SSD heads over multiple feature maps (reference detection.py:677):
    per map, conv heads for locations and confidences plus its prior
    boxes; everything concatenated over maps.  Returns
    (mbox_locs [N,M,4], mbox_confs [N,M,C], boxes [M,4], vars [M,4])."""
    from . import nn
    from . import tensor as tensor_layers

    n_maps = len(inputs)
    if min_sizes is None:
        # reference ratio schedule (detection.py:790)
        min_sizes, max_sizes = [], []
        step = int((max_ratio - min_ratio) / (n_maps - 2))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.0)
            max_sizes.append(base_size * (ratio + step) / 100.0)
        min_sizes = [base_size * 0.1] + min_sizes
        max_sizes = [base_size * 0.2] + max_sizes

    locs, confs, boxes_l, vars_l = [], [], [], []
    for i, feat in enumerate(inputs):
        mins = min_sizes[i]
        mins = list(mins) if isinstance(mins, (list, tuple)) else [mins]
        maxs = max_sizes[i] if max_sizes else None
        maxs = (list(maxs) if isinstance(maxs, (list, tuple))
                else ([maxs] if maxs else []))
        ars = aspect_ratios[i]
        ars = list(ars) if isinstance(ars, (list, tuple)) else [ars]
        st = (list(steps[i]) if steps else
              [(step_w[i] if step_w else 0.0),
               (step_h[i] if step_h else 0.0)])
        box, var = prior_box(feat, image, mins, maxs, ars, variance,
                             flip, clip, st, offset)
        boxes_l.append(nn.reshape(box, [-1, 4]))
        vars_l.append(nn.reshape(var, [-1, 4]))
        p = _num_priors(mins, maxs, ars, flip)
        h_f, w_f = feat.shape[2], feat.shape[3]
        loc = nn.conv2d(feat, num_filters=p * 4,
                        filter_size=kernel_size, padding=pad,
                        stride=stride)
        loc = nn.transpose(loc, [0, 2, 3, 1])
        locs.append(nn.reshape(loc, [-1, h_f * w_f * p, 4]))
        conf = nn.conv2d(feat, num_filters=p * num_classes,
                         filter_size=kernel_size, padding=pad,
                         stride=stride)
        conf = nn.transpose(conf, [0, 2, 3, 1])
        confs.append(nn.reshape(conf, [-1, h_f * w_f * p, num_classes]))

    mbox_locs = tensor_layers.concat(locs, axis=1)
    mbox_confs = tensor_layers.concat(confs, axis=1)
    boxes = tensor_layers.concat(boxes_l, axis=0)
    variances = tensor_layers.concat(vars_l, axis=0)
    return mbox_locs, mbox_confs, boxes, variances


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0,
             overlap_threshold=0.5, neg_pos_ratio=3.0,
             loc_loss_weight=1.0, conf_loss_weight=1.0,
             match_type="per_prediction", mining_type="max_negative",
             normalize=True, sample_size=None):
    """SSD multibox loss (reference detection.py:350): bipartite-match
    priors to gt, mine hard negatives, smooth-l1 on matched locations +
    cross-entropy on positives and mined negatives.  location [B,M,4],
    confidence [B,M,C], gt_box [B,G,4], gt_label [B,G,1].  Returns the
    per-image loss [B, 1]."""
    from . import nn
    from . import tensor as tensor_layers

    helper = LayerHelper("ssd_loss", **locals())
    iou = iou_similarity(gt_box, prior_box)          # [B,G,M]
    match_indices, _ = bipartite_match(iou, match_type,
                                       overlap_threshold)
    # confidence target: matched gt label, else background.  pos_w is
    # the positives-only mask (normalization denominator below)
    lab = tensor_layers.cast(gt_label, "float32")
    conf_target, pos_w = target_assign(lab, match_indices,
                                       mismatch_value=background_label)
    conf_target = tensor_layers.cast(conf_target, "int64")
    conf_target.stop_gradient = True
    cls_loss = nn.softmax_with_cross_entropy(confidence, conf_target)
    # hard negative mining over per-prior cls loss
    neg_indices = helper.create_tmp_variable(dtype="int32")
    updated = helper.create_tmp_variable(dtype="int32")
    helper.append_op(
        type="mine_hard_examples",
        inputs={"ClsLoss": [cls_loss],
                "MatchIndices": [match_indices]},
        outputs={"NegIndices": [neg_indices],
                 "UpdatedMatchIndices": [updated]},
        attrs={"neg_pos_ratio": float(neg_pos_ratio),
               "mining_type": mining_type,
               "sample_size": int(sample_size) if sample_size else -1})
    neg_indices.stop_gradient = True
    _, conf_w = target_assign(lab, match_indices,
                              negative_indices=neg_indices,
                              mismatch_value=background_label)
    conf_w.stop_gradient = True
    conf_loss = nn.reduce_sum(nn.elementwise_mul(cls_loss, conf_w),
                              dim=[1, 2])            # [B]
    # localization: encoded gt offsets gathered at matched priors
    encoded = box_coder(prior_box, prior_box_var, gt_box,
                        "encode_center_size")        # [B,G,M,4]
    loc_target = helper.create_tmp_variable(dtype="float32")
    loc_w = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="gather_encoded_target",
        inputs={"Encoded": [encoded],
                "MatchIndices": [match_indices]},
        outputs={"Out": [loc_target], "OutWeight": [loc_w]})
    loc_target.stop_gradient = True
    loc_w.stop_gradient = True
    loc_out = nn.smooth_l1(location, loc_target,
                           outside_weight=loc_w)     # [B,1]
    loc_loss = nn.reduce_sum(loc_out, dim=1)         # [B]
    loss = nn.elementwise_add(
        nn.scale(conf_loss, scale=float(conf_loss_weight)),
        nn.scale(loc_loss, scale=float(loc_loss_weight)))
    if normalize:
        # reference normalizes by the POSITIVE match count only, not
        # positives + mined negatives
        npos = nn.reduce_sum(pos_w, dim=[1, 2])
        one = tensor_layers.fill_constant(shape=[1], dtype="float32",
                                          value=1.0)
        loss = nn.elementwise_div(loss, nn.elementwise_max(npos, one))
    return nn.reshape(loss, [-1, 1])


def multiclass_nms(bboxes, scores, background_label=0,
                   score_threshold=0.01, nms_top_k=400,
                   nms_threshold=0.3, keep_top_k=200, nms_eta=1.0,
                   name=None):
    helper = LayerHelper("multiclass_nms", **locals())
    out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="multiclass_nms",
        inputs={"BBoxes": [bboxes], "Scores": [scores]},
        outputs={"Out": [out]},
        attrs={"background_label": background_label,
               "score_threshold": score_threshold,
               "nms_top_k": nms_top_k, "nms_threshold": nms_threshold,
               "keep_top_k": keep_top_k, "nms_eta": nms_eta})
    out.stop_gradient = True
    return out


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3,
                     nms_top_k=400, keep_top_k=200, score_threshold=0.01,
                     nms_eta=1.0):
    """Decode + NMS (reference detection.py:46): loc [N,M,4] offsets,
    scores [N,M,C] post-softmax.  Returns [No,6] rows
    [label, score, xmin, ymin, xmax, ymax] ('<out>@ROWS' holds the
    per-image counts, the LoD analog)."""
    from . import nn

    decoded = box_coder(prior_box, prior_box_var, loc,
                        "decode_center_size")
    scores_t = nn.transpose(scores, perm=[0, 2, 1])   # [N,C,M]
    return multiclass_nms(decoded, scores_t, background_label,
                          score_threshold, nms_top_k, nms_threshold,
                          keep_top_k, nms_eta)


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.5, ap_version="integral",
                  name=None):
    """mAP over a batch (reference detection.py:157 /
    detection_map_op.cc)."""
    helper = LayerHelper("detection_map", **locals())
    map_out = helper.create_tmp_variable(dtype="float32")
    helper.append_op(
        type="detection_map",
        inputs={"DetectRes": [detect_res], "Label": [label]},
        outputs={"MAP": [map_out]},
        attrs={"class_num": int(class_num),
               "background_label": int(background_label),
               "overlap_threshold": float(overlap_threshold),
               "ap_version": ap_version})
    return map_out
