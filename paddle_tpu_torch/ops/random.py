"""Random ops, drawn from a ``torch.Generator`` (``ctx.generator``,
the step's ``lowering.RandomStream``).

Counterpart of ``paddle_tpu/ops/random.py`` for the ops ported so far
(``uniform_random``, ``gaussian_random``), and ``keep_mask``: the one
draw every dropout form makes (the ``dropout`` op and the dropout
branch of ``fused_matmul_bias_act``), so that a test can put another
mask in at one place.
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


def keep_mask(ctx, shape, keep_prob, seed=0):
    """[shape] bool, each element True with probability ``keep_prob``
    (``jax.random.bernoulli``'s uniform < p), drawn from the op's own
    ``seed`` when set, else from the step's stream.  The draw is at the
    op-output shape, so the fused and unfused dropout forms with one
    explicit seed draw the same mask."""
    u = torch.rand(tuple(shape), generator=ctx.generator(seed),
                   device=ctx.device, dtype=torch.float32)
    return u < keep_prob
