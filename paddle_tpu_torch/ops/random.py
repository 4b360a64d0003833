"""Random ops, drawn from a ``torch.Generator`` (``ctx.generator``,
the step's ``lowering.RandomStream``).

Counterpart of ``paddle_tpu/ops/random.py``, op for op, and
``keep_mask``: the one
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


def _batch_shape(ins, attrs):
    """``shape`` with dim ``output_dim_idx`` taken from the input's dim
    ``input_dim_idx`` (its batch)."""
    shape = list(attrs.get("shape"))
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"].shape[attrs.get("input_dim_idx", 0)]
    return tuple(shape)


@register_op("uniform_random_batch_size_like", stateful=True, grad_maker=None)
def _uniform_random_bsl(ctx, ins, attrs, op):
    return _uniform_random(ctx, ins, dict(attrs, shape=_batch_shape(
        ins, attrs)), op)


@register_op("gaussian_random_batch_size_like", stateful=True,
             grad_maker=None)
def _gaussian_random_bsl(ctx, ins, attrs, op):
    return _gaussian_random(ctx, ins, dict(attrs, shape=_batch_shape(
        ins, attrs)), op)


@register_op("sampling_id", stateful=True, grad_maker=None)
def _sampling_id(ctx, ins, attrs, op):
    """A class a row of X [N, D] (probabilities), drawn as
    ``jax.random.categorical`` draws: the argmax of log p plus Gumbel
    noise, from one uniform draw (no host sync, so a captured step
    replays it)."""
    x = ins["X"]
    if ctx.device.type == "meta":
        return {"Out": torch.empty(x.shape[:-1], dtype=torch.int64,
                                   device=x.device)}
    u = torch.rand(tuple(x.shape), generator=ctx.generator(
        attrs.get("seed", 0)), device=ctx.device, dtype=torch.float32)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(torch.clamp_min(u, tiny)))
    logp = torch.log(torch.clamp_min(x.to(torch.float32), 1e-20))
    return {"Out": torch.argmax(logp + gumbel, dim=-1)}


def keep_mask(ctx, shape, keep_prob, seed=0):
    """[shape] bool, each element True with probability ``keep_prob``
    (``jax.random.bernoulli``'s uniform < p), drawn from the op's own
    ``seed`` when set, else from the step's stream.  The draw is at the
    op-output shape, so the fused and unfused dropout forms with one
    explicit seed draw the same mask."""
    u = torch.rand(tuple(shape), generator=ctx.generator(seed),
                   device=ctx.device, dtype=torch.float32)
    return u < keep_prob
