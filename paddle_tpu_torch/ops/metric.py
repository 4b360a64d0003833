"""Metric ops.

Counterpart of ``paddle_tpu/ops/metric.py``: ``accuracy``, ``auc`` and
``precision_recall`` (``chunk_eval`` is a host op of ``ops/crf_ctc.py``).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.core.selected_rows import add_rows


@register_op("accuracy", grad_maker=None)
def _accuracy(ctx, ins, attrs, op):
    """Top-k accuracy: Indices [N, k] from top_k, Label [N, 1]; Correct
    and Total int32, as in the JAX package."""
    indices = ins["Indices"]
    label = ins["Label"].reshape(-1, 1)
    correct = torch.any(indices == label, dim=1)
    num_correct = torch.sum(correct, dtype=torch.int32)
    total = indices.shape[0]
    acc = num_correct.float() / float(total)
    return {"Accuracy": acc.reshape((1,)),
            "Correct": num_correct.reshape((1,)),
            "Total": torch.full((1,), total, dtype=torch.int32,
                                device=indices.device)}


@register_op("auc", grad_maker=None)
def _auc(ctx, ins, attrs, op):
    """Streaming AUC over histogram thresholds (reference auc_op.cc).
    Predict [N, 2] (class 1's probability in the last column), Label
    [N, 1], the int64 statistics TP / FP / TN / FN [num_thresholds]
    (their outputs are the same persistables: the counts carry from step
    to step).  The AUC is the trapezoid sum over decreasing FPR, in f32
    as the JAX package takes it."""
    predict = ins["Predict"]
    label = ins["Label"].reshape(-1)
    num_t = attrs.get("num_thresholds", 200)
    pos_prob = predict[:, -1]
    # divided by a device tensor, as the CPU and jax divide (CUDA takes a
    # host scalar divisor as a product with its reciprocal)
    thresholds = (torch.arange(num_t, dtype=torch.float32,
                               device=predict.device) + 1.0) / torch.full(
        (), num_t + 1.0, device=predict.device)
    pred_pos = pos_prob[None, :] > thresholds[:, None]     # [T, N]
    is_pos = (label > 0)[None, :]
    tp = ins["TP"] + (pred_pos & is_pos).sum(dim=1)
    fp = ins["FP"] + (pred_pos & ~is_pos).sum(dim=1)
    tn = ins["TN"] + (~pred_pos & ~is_pos).sum(dim=1)
    fn = ins["FN"] + (~pred_pos & is_pos).sum(dim=1)
    tpr = tp.float() / (tp + fn).float().clamp_min(1e-6)
    fpr = fp.float() / (fp + tn).float().clamp_min(1e-6)
    auc = torch.sum((fpr[:-1] - fpr[1:]) * (tpr[:-1] + tpr[1:]) / 2.0)
    return {"AUC": auc.reshape((1,)), "TPOut": tp, "FPOut": fp,
            "TNOut": tn, "FNOut": fn}


@register_op("precision_recall", grad_maker=None)
def _precision_recall(ctx, ins, attrs, op):
    """Multi-class precision / recall (reference precision_recall_op.cc):
    per class the weighted true-positive, predicted and true counts,
    summed in a fixed order on every device (``selected_rows.add_rows``:
    ``index_add_``'s CUDA atomics would add duplicates in arrival order),
    then the macro and micro precision, recall and F1."""
    max_probs = ins["MaxProbs"].reshape(-1)
    indices = ins["Indices"].reshape(-1).long()
    labels = ins["Labels"].reshape(-1).long()
    cls = attrs.get("class_number")
    weights = (ins["Weights"].reshape(-1).float() if ins.has("Weights")
               else torch.ones_like(max_probs, dtype=torch.float32))
    zeros = torch.zeros((cls,), dtype=torch.float32, device=weights.device)
    tp = add_rows(zeros.clone(), labels,
                  torch.where(indices == labels, weights, 0.0))
    pred_cnt = add_rows(zeros.clone(), indices, weights)
    true_cnt = add_rows(zeros.clone(), labels, weights)
    states = torch.stack([tp, pred_cnt - tp, true_cnt - tp,
                          torch.zeros_like(tp)], dim=1)
    if ins.has("StatesInfo"):
        states = states + ins["StatesInfo"]
    tp_a, fp_a, fn_a = states[:, 0], states[:, 1], states[:, 2]
    prec = tp_a / (tp_a + fp_a).clamp_min(1e-6)
    rec = tp_a / (tp_a + fn_a).clamp_min(1e-6)
    f1 = 2 * prec * rec / (prec + rec).clamp_min(1e-6)
    macro = torch.stack([torch.mean(prec), torch.mean(rec),
                         torch.mean(f1)])
    tp_s, fp_s, fn_s = tp_a.sum(), fp_a.sum(), fn_a.sum()
    mprec = tp_s / (tp_s + fp_s).clamp_min(1e-6)
    mrec = tp_s / (tp_s + fn_s).clamp_min(1e-6)
    micro = torch.stack([mprec, mrec,
                         2 * mprec * mrec / (mprec + mrec).clamp_min(1e-6)])
    metrics = torch.cat([macro, micro]).reshape(1, 6)
    return {"BatchMetrics": metrics, "AccumMetrics": metrics.clone(),
            "AccumStatesInfo": states}
