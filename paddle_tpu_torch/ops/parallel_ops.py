"""Attention op of the transformer LM.

Counterpart of the dense (single-device) branch of
``paddle_tpu/ops/parallel_ops.py``: ``ring_attention`` runs the flash
forward (K1) and ``ring_attention_grad`` the flash backward kernels
(K2, K3) from the saved LSE.  The sequence-parallel ring (an ``sp_axis``
over a mesh) is not ported yet.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core import lowering as core_lowering
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_fwd_lse, flash_attention_train)


def _dense_only(attrs):
    if attrs.get("sp_axis"):
        raise NotImplementedError(
            "ring_attention with sp_axis=%r: the sequence-parallel ring is "
            "not ported to paddle_tpu_torch yet" % attrs["sp_axis"])


def _scale(attrs):
    # ABSENT means 1/sqrt(D); a present value (0.0 included) is used as is
    return attrs["scale"] if "scale" in attrs else None


def _ring_attention_infer(ins, attrs, op=None):
    q = ins["Q"]
    b, h, t, _ = q.shape
    return {"Out": torch.empty_like(q),
            "LSE": torch.empty((b, h, t), dtype=torch.float32,
                               device=q.device)}


@register_op("ring_attention", no_vjp_outputs=("LSE",),
             infer_shape=_ring_attention_infer)
def _ring_attention_lower(ctx, ins, attrs, op=None):
    """Causal (or not) scaled-dot-product attention, Q/K/V [B, H, S, D].
    The ``transpose`` lowerings hand over views: the kernels take
    contiguous operands.  Under autograd (the generic grad lowering's
    forward re-run) the forward goes through ``flash_attention_train``,
    so the backward is K2/K3 and not an autograd of a kernel call."""
    _dense_only(attrs)
    q, k, v = (ins[s].contiguous() for s in ("Q", "K", "V"))
    causal = bool(attrs.get("causal", True))
    train = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    fwd = flash_attention_train if train else flash_attention_fwd_lse
    out, lse = fwd(q, k, v, _scale(attrs), causal)
    if op is not None and op.outputs.get("LSE"):
        return {"Out": out, "LSE": lse}
    return {"Out": out}


@register_op("ring_attention_grad", grad_maker=None)
def _ring_attention_grad_lower(ctx, ins, attrs, op=None):
    """Flash backward from the forward's saved LSE (no forward re-run);
    without the LSE residual (an op built without that output) the
    generic grad lowering re-runs the forward under autograd."""
    _dense_only(attrs)
    lse = ins.get("LSE")
    if lse is None:
        return core_lowering.generic_grad_lower(ctx, ins, attrs, op)
    dq, dk, dv = flash_attention_bwd(
        *(ins[s].contiguous() for s in ("Q", "K", "V", "Out")),
        lse.contiguous(), ins["Out@GRAD"].contiguous(),
        scale=_scale(attrs), causal=bool(attrs.get("causal", True)))
    return {"Q@GRAD": dq, "K@GRAD": dk, "V@GRAD": dv}
