"""Neural-network ops.

Counterpart of ``paddle_tpu/ops/nn.py`` for the ops ported so far.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs, op):
    x = ins["X"]
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    # statistics in f32, the normalized output in x.dtype (as the JAX
    # package does for bf16 inputs)
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axes, keepdim=True)
    mean = mean.to(x.dtype)
    var = var.to(x.dtype)
    y = (x - mean) * torch.rsqrt(var + eps)
    fshape = (1,) * begin + tuple(x.shape[begin:])
    scale = ins.get("Scale")
    bias = ins.get("Bias")
    if scale is not None:
        y = y * scale.to(x.dtype).reshape(fshape)
    if bias is not None:
        y = y + bias.to(x.dtype).reshape(fshape)
    lead = tuple(x.shape[:begin])
    return {"Y": y, "Mean": mean.reshape(lead),
            "Variance": var.reshape(lead)}
