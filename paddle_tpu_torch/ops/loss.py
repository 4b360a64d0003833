"""Loss ops.

Counterpart of ``paddle_tpu/ops/loss.py`` for the ops ported so far.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op

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
    return {"Y": loss}


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
    return {"Softmax": softmax, "Loss": loss}


def _hard_label_idx(label, logits_ndim):
    """Label [..., 1] (or [...]) -> int64 index tensor with logits' rank,
    so N-d logits (e.g. [B, S, V] LM heads) work."""
    idx = label.long()
    if idx.dim() < logits_ndim:
        idx = idx[..., None]
    return idx
