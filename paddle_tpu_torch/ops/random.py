"""Random ops, drawn from a ``torch.Generator`` (``ctx.generator``).

Counterpart of ``paddle_tpu/ops/random.py`` for the ops ported so far
(``uniform_random``, ``gaussian_random``).
The numbers differ from the JAX package's (a different generator from
the same seed): tests carry parameters across instead of re-drawing
them.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.core.types import DataType, proto_to_torch_dtype


@register_op("uniform_random", stateful=True, grad_maker=None)
def _uniform_random(ctx, ins, attrs, op):
    dtype = proto_to_torch_dtype(attrs.get("dtype", DataType.FP32))
    shape = tuple(attrs.get("shape"))
    if ctx.device.type == "meta":
        return {"Out": torch.empty(shape, dtype=dtype, device=ctx.device)}
    lo, hi = attrs.get("min", -1.0), attrs.get("max", 1.0)
    out = torch.rand(shape, generator=ctx.generator(attrs.get("seed", 0)),
                     device=ctx.device, dtype=torch.float32)
    return {"Out": (out * (hi - lo) + lo).to(dtype)}


@register_op("gaussian_random", stateful=True, grad_maker=None)
def _gaussian_random(ctx, ins, attrs, op):
    """N(mean, std) draws (the conv filters' NormalInitializer)."""
    dtype = proto_to_torch_dtype(attrs.get("dtype", DataType.FP32))
    shape = tuple(attrs.get("shape"))
    if ctx.device.type == "meta":
        return {"Out": torch.empty(shape, dtype=dtype, device=ctx.device)}
    out = torch.randn(shape, generator=ctx.generator(attrs.get("seed", 0)),
                      device=ctx.device, dtype=torch.float32)
    out = out * attrs.get("std", 1.0) + attrs.get("mean", 0.0)
    return {"Out": out.to(dtype)}
