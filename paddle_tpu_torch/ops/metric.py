"""Metric ops.

Counterpart of ``paddle_tpu/ops/metric.py`` for the ops ported so far
(``accuracy``).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


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
