"""Loss ops.

Counterpart of ``paddle_tpu/ops/loss.py``, op for op.  The per-token
losses of a ragged input are 0 at its padded positions,
as the JAX package's are (``_mask_padded``).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.math import absolute, scalar

_TOL = 1e-20  # reference math/cross_entropy.h TolerableValue


@register_op("cross_entropy")
def _cross_entropy(ctx, ins, attrs, op):
    """-log(max(p, 1e-20)) of the label's probability (or the soft-label
    sum).  X holds probabilities, [N, D]."""
    x = ins["X"]
    label = ins["Label"]
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * torch.log(torch.clamp_min(x, _TOL)),
                          dim=-1, keepdim=True)
    else:
        picked = torch.gather(x, -1, _hard_label_idx(label, x.dim()))
        loss = -torch.log(torch.clamp_min(picked, _TOL))
    return {"Y": _mask_padded(ctx, op, "X", loss)}


@register_op("softmax_with_cross_entropy")
def _softmax_with_ce(ctx, ins, attrs, op):
    logits = ins["Logits"]
    label = ins["Label"]
    lse = torch.logsumexp(logits, dim=-1, keepdim=True)
    log_softmax = logits - lse
    softmax = torch.exp(log_softmax)
    if attrs.get("soft_label", False):
        loss = -torch.sum(label * log_softmax, dim=-1, keepdim=True)
    else:
        idx = _hard_label_idx(label, logits.dim())
        loss = -torch.gather(log_softmax, -1, idx)
    return {"Softmax": softmax,
            "Loss": _mask_padded(ctx, op, "Logits", loss)}


def _mask_padded(ctx, op, slot, loss):
    """Zero the per-token loss at the padded positions of a ragged input
    (the packed reference never sees padding, cross_entropy_op.cc)."""
    if op is None:
        return loss
    names = op.inputs.get(slot) or []
    lens = ctx.seq_len_of(names[0]) if names and names[0] else None
    if lens is None or loss.dim() < 2:
        return loss
    mask = (torch.arange(loss.shape[1], device=loss.device)[None, :]
            < lens[:, None]).to(loss.dtype)
    return loss * mask.reshape(mask.shape + (1,) * (loss.dim() - 2))


def _hard_label_idx(label, logits_ndim):
    """Label [..., 1] (or [...]) -> int64 index tensor with logits' rank,
    so N-d logits (e.g. [B, S, V] LM heads) work."""
    idx = label.long()
    if idx.dim() < logits_ndim:
        idx = idx[..., None]
    return idx


def _relu0(x):
    """jnp.maximum(x, 0): a tie at 0 splits the gradient, as jax's."""
    return torch.maximum(x, scalar(x, 0.0))


def _log1p_exp_neg_abs(x):
    return torch.log1p(torch.exp(-absolute(x)))


@register_op("sigmoid_cross_entropy_with_logits")
def _sigmoid_ce(ctx, ins, attrs, op):
    x, label = ins["X"], ins["Label"]
    # log(1 + exp(x)) - x * label, stable
    return {"Out": _relu0(x) - x * label + _log1p_exp_neg_abs(x)}


@register_op("hinge_loss")
def _hinge_loss(ctx, ins, attrs, op):
    logits, labels = ins["Logits"], ins["Labels"]
    signs = 2.0 * labels - 1.0
    return {"Loss": _relu0(1.0 - signs * logits)}


@register_op("huber_loss")
def _huber_loss(ctx, ins, attrs, op):
    x, y = ins["X"], ins["Y"]
    delta = attrs.get("delta", 1.0)
    r = y - x
    ar = torch.abs(r)
    loss = torch.where(ar <= delta, 0.5 * r * r, delta * (ar - 0.5 * delta))
    return {"Out": loss, "Residual": r}


@register_op("log_loss")
def _log_loss(ctx, ins, attrs, op):
    p, label = ins["Predicted"], ins["Labels"]
    eps = attrs.get("epsilon", 1e-4)
    return {"Loss": -label * torch.log(p + eps)
            - (1 - label) * torch.log(1 - p + eps)}


@register_op("rank_loss")
def _rank_loss(ctx, ins, attrs, op):
    label, left, right = ins["Label"], ins["Left"], ins["Right"]
    d = left - right
    return {"Out": _relu0(d) - d * label + _log1p_exp_neg_abs(d)}


@register_op("margin_rank_loss")
def _margin_rank_loss(ctx, ins, attrs, op):
    label, x1, x2 = ins["Label"], ins["X1"], ins["X2"]
    out = _relu0(-label * (x1 - x2) + attrs.get("margin", 0.0))
    return {"Out": out, "Activated": (out > 0).to(x1.dtype)}


@register_op("smooth_l1_loss")
def _smooth_l1(ctx, ins, attrs, op):
    x, y = ins["X"], ins["Y"]
    sigma = attrs.get("sigma", 1.0)
    s2 = sigma * sigma
    diff = x - y
    if ins.has("InsideWeight"):
        diff = diff * ins["InsideWeight"]
    ad = torch.abs(diff)
    elem = torch.where(ad < 1.0 / s2, 0.5 * s2 * diff * diff, ad - 0.5 / s2)
    if ins.has("OutsideWeight"):
        elem = elem * ins["OutsideWeight"]
    return {"Diff": diff, "Out": torch.sum(
        elem.reshape(elem.shape[0], -1), dim=1, keepdim=True)}


@register_op("modified_huber_loss")
def _modified_huber(ctx, ins, attrs, op):
    x, y = ins["X"], ins["Y"]
    z = x * (2.0 * y - 1.0)
    loss = torch.where(z >= 1.0, torch.zeros_like(z),
                       torch.where(z >= -1.0, torch.square(1.0 - z),
                                   -4.0 * z))
    return {"IntermediateVal": z, "Out": loss}


@register_op("bilinear_tensor_product")
def _bilinear_tp(ctx, ins, attrs, op):
    x, y, w = ins["X"], ins["Y"], ins["Weight"]  # [N,M], [N,P], [S,M,P]
    out = torch.einsum("nm,smp,np->ns", x, w, y)
    if ins.has("Bias"):
        out = out + ins["Bias"]
    return {"Out": out}


def nce_negatives(ctx, n, num_neg, total, seed=0):
    """[n, num_neg] int64 negative classes, uniform over [0, total),
    drawn from the step's stream: the one draw ``nce`` makes, so that a
    test can put the JAX package's samples in at one place."""
    return torch.randint(0, total, (n, num_neg), generator=ctx.generator(seed),
                         device=ctx.device)


@register_op("nce", stateful=True)
def _nce(ctx, ins, attrs, op):
    """Noise-contrastive estimation (reference nce_op.cc), the uniform
    sampler: sigmoid CE of each true and sampled class's logit, less
    log(num_neg / total)."""
    x, label, w = ins["Input"], ins["Label"], ins["Weight"]
    num_neg = attrs.get("num_neg_samples", 10)
    total = attrs.get("num_total_classes")
    n = x.shape[0]
    t = label.shape[1] if label.dim() > 1 else 1
    label2 = label.reshape(n, t).long()
    if ctx.device.type == "meta":
        neg = torch.empty((n, num_neg), dtype=torch.int64, device=x.device)
    else:
        neg = nce_negatives(ctx, n, num_neg, total)
    samples = torch.cat([label2, neg], dim=1)              # [N, T + S]
    logits = torch.einsum("nd,nkd->nk", x, w[samples])
    if ins.has("Bias"):
        logits = logits + ins["Bias"][samples]
    lbl = torch.cat([torch.ones((n, t), device=x.device),
                     torch.zeros((n, num_neg), device=x.device)], dim=1)
    # log(num_neg * p_noise) in float32, as jnp.log takes it
    adj = logits - float(np.log(np.float32(num_neg * (1.0 / total))))
    per = _relu0(adj) - adj * lbl + _log1p_exp_neg_abs(adj)
    return {"Cost": torch.sum(per, dim=1, keepdim=True),
            "SampleLogits": logits, "SampleLabels": samples}


@register_op("lambda_rank", seq_aware=True, no_vjp_outputs=("NDCG",))
def _lambda_rank(ctx, ins, attrs, op=None):
    """LambdaRank cost (the JAX package's ``lambda_rank``: the legacy
    LambdaCost, one ragged sequence a query).  ``Out`` is the surrogate
    sum |dcgDif| / maxDCG * log(1 + e^{-(s_i - s_j)}) over the pairs the
    gold order ranks apart, whose gradient is the lambda; ``NDCG`` is
    the gold gains at the top NDCG_num positions of the output order
    over maxDCG.  Natural logs, positions from the gold sort."""
    from paddle_tpu_torch.ops.sequence import _lens_of, _mask

    score, label = ins["Score"], ins["Label"]
    k = int(attrs.get("NDCG_num", 5))
    if score.dim() == 3:
        score = score[..., 0]
    if label.dim() == 3:
        label = label[..., 0]
    label = label.to(torch.float32)
    sf = score.to(torch.float32)
    n, t = sf.shape
    lens = _lens_of(ctx, op, "Score")
    if lens is None:
        lens = _lens_of(ctx, op, "Label")
    valid = _mask(lens, n, t, torch.bool, device=sf.device)
    neg_inf = scalar(sf, -1e30)
    zero = scalar(sf, 0.0)
    ar = torch.arange(t, device=sf.device)
    # 0-based position of each item in the descending gold order
    gold_key = torch.where(valid, label, neg_inf)
    order = torch.argsort(-gold_key, dim=1, stable=True)
    pos = torch.argsort(order, dim=1, stable=True).to(torch.float32)
    disc = 1.0 / torch.log(pos + 2.0)
    gain = torch.exp2(torch.where(valid, label, zero))
    sg = -torch.sort(-torch.where(valid, gain - 1.0, zero), dim=1).values
    top_disc = torch.where(ar < k, 1.0 / torch.log(ar.to(torch.float32)
                                                   + 2.0), zero)
    maxdcg = torch.clamp_min((sg * top_disc[None, :]).sum(dim=1), 1e-6)
    d_gain = gain[:, :, None] - gain[:, None, :]
    d_disc = disc[:, :, None] - disc[:, None, :]
    weight = torch.abs(d_gain * d_disc) / maxdcg[:, None, None]
    pair = (valid[:, :, None] & valid[:, None, :]
            & (label[:, :, None] > label[:, None, :]))
    d_s = sf[:, :, None] - sf[:, None, :]
    logistic = _log1p_exp_neg_abs(d_s) + _relu0(-d_s)
    cost = torch.where(pair, weight * logistic, zero).sum(dim=(1, 2))
    out_key = torch.where(valid, sf, neg_inf)
    by_out = torch.gather(torch.where(valid, gain - 1.0, zero), 1,
                          torch.argsort(-out_key, dim=1, stable=True))
    dcg = (by_out * top_disc[None, :]).sum(dim=1)
    return {"Out": cost[:, None], "NDCG": (dcg / maxdcg)[:, None]}
