"""Loss ops.

Counterpart of ``paddle_tpu/ops/loss.py`` for the ops ported so far.
The per-token losses of a ragged input are 0 at its padded positions,
as the JAX package's are (``_mask_padded``).
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
