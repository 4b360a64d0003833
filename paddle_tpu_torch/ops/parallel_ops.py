"""SPMD annotation ops and the attention op of the transformer LM.

Counterpart of ``paddle_tpu/ops/parallel_ops.py``.  ``ring_attention``
runs the sequence-parallel ring (``parallel/ring.py``, K9 forward, K2/K3
backward per ring step) when the executor's mesh has the op's ``sp``
axis with size > 1, and the dense flash path (K1 forward, K2/K3
backward) otherwise: no mesh, no such axis, or size 1.  The op cuts
Q/K/V along S into the ring's shards and joins ``Out`` and ``LSE`` back,
as ``shard_map``'s in/out specs do in the JAX package.  Batch (``dp``)
and head (``tp``) axes of size > 1 are not ported and raise.  Under bf16
AMP both paths carry bf16 Q/K/V through the kernels' bf16 forms (Out in
bf16, LSE in f32): the dense one K1/K2/K3's, the ring K9's and
K2/K3's.
``moe_ffn`` is the top-1 mixture-of-experts FFN in its dense-dispatch
form, under AMP in the dtype the reference's jnp promotion gives its
operands; an ``ep`` axis of size > 1 (expert parallelism) raises.
"""
from __future__ import annotations

import math

import torch

from paddle_tpu_torch.core import lowering as core_lowering
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels import custom_ops
from paddle_tpu_torch.kernels.flash_attention import (
    flash_attention_bwd, flash_attention_train)


@register_op("sharding_constraint")
def _sharding_constraint_lower(ctx, ins, attrs, op=None):
    """Identity: the executor runs every op on its own device, and only
    the ring attention op shards over the mesh."""
    return {"Out": ins["X"]}


def _axis_or_none(mesh, name):
    return name if (name and mesh is not None
                    and name in mesh.axis_names
                    and mesh.shape[name] > 1) else None


def _ring_axes(ctx, attrs):
    """The op's sp axis on ``ctx.mesh`` (or None: the dense path);
    raises for a batch or head axis of size > 1."""
    mesh = ctx.mesh
    for key, default in (("batch_axis", "dp"), ("head_axis", "tp")):
        axis = _axis_or_none(mesh, attrs.get(key, default))
        if axis is not None:
            raise NotImplementedError(
                "ring_attention over %s=%r (size %d): only the sp axis is "
                "ported to paddle_tpu_torch yet"
                % (key, axis, mesh.shape[axis]))
    return _axis_or_none(mesh, attrs.get("sp_axis", "sp"))


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
    forward re-run) the forward goes through an autograd Function
    (``flash_attention_train``, or the ring's), so the backward is the
    flash or ring backward and not an autograd of a kernel call."""
    sp_axis = _ring_axes(ctx, attrs)
    q, k, v = (ins[s].contiguous() for s in ("Q", "K", "V"))
    causal = bool(attrs.get("causal", True))
    with_lse = op is not None and bool(op.outputs.get("LSE"))
    if sp_axis is not None:
        from paddle_tpu_torch.parallel.ring import (ring_attention,
                                                    ring_attention_fwd_lse)
        if with_lse:
            out, lse = ring_attention_fwd_lse(q, k, v, ctx.mesh, sp_axis,
                                              causal, _scale(attrs))
            return {"Out": out, "LSE": lse}
        return {"Out": ring_attention(q, k, v, ctx.mesh, sp_axis, causal,
                                      _scale(attrs))}
    train = torch.is_grad_enabled() and any(
        x.requires_grad for x in (q, k, v))
    scale = _scale(attrs)
    if train:
        out, lse = flash_attention_train(q, k, v, scale, causal)
    else:
        # K1 through its custom op (kernels/custom_ops.py), which
        # torch.export traces
        if scale is None:
            scale = 1.0 / math.sqrt(q.shape[-1])
        out, lse = custom_ops.flash_fwd(q, k, v, float(scale), causal)
    if with_lse:
        return {"Out": out, "LSE": lse}
    return {"Out": out}


@register_op("ring_attention_grad", grad_maker=None)
def _ring_attention_grad_lower(ctx, ins, attrs, op=None):
    """Backward from the forward's saved LSE (no forward re-run): the
    reverse ring under sp, the flash backward kernels dense.  Without
    the LSE residual (an op built without that output) the generic grad
    lowering re-runs the forward under autograd."""
    sp_axis = _ring_axes(ctx, attrs)
    lse = ins.get("LSE")
    if lse is None:
        return core_lowering.generic_grad_lower(ctx, ins, attrs, op)
    out, do = ins["Out"], ins["Out@GRAD"]
    causal = bool(attrs.get("causal", True))
    if sp_axis is None:
        # the flash backward takes the cotangent in Out's dtype, as the
        # reference's kernel branch casts it (an f32 cotangent of a bf16
        # Out under AMP); the ring takes it as it arrives, as the
        # reference's ring does (delta from it; each chunk backward casts
        # it to q's dtype on the card only)
        do = do.to(out.dtype)
    args = [ins[s].contiguous() for s in ("Q", "K", "V")] + [
        out.contiguous(), lse.contiguous(), do.contiguous()]
    if sp_axis is not None:
        from paddle_tpu_torch.parallel.ring import ring_attention_bwd
        dq, dk, dv = ring_attention_bwd(*args, ctx.mesh, sp_axis, causal,
                                        _scale(attrs))
    else:
        dq, dk, dv = flash_attention_bwd(*args, scale=_scale(attrs),
                                         causal=causal)
    return {"Q@GRAD": dq, "K@GRAD": dk, "V@GRAD": dv}


@register_op("moe_ffn")
def _moe_ffn_lower(ctx, ins, attrs, op=None):
    """Top-1 mixture-of-experts FFN, dense dispatch (every token through
    every expert, the chosen one's row kept and scaled by its gate).  X:
    [T, D] or [B, S, D] (flattened internally).  The reference's
    expert-parallel all-to-all over the ep axis (ROADMAP item 10) is not
    ported: an ep axis of size > 1 raises.  Its ``emit_router_stats``
    metrics side effect waits for the telemetry port (ROADMAP item 11);
    dense dispatch drops no token, so ``capacity_factor`` has no use."""
    mesh = ctx.mesh
    axis = _axis_or_none(mesh, attrs.get("ep_axis", "ep"))
    if axis is not None:
        raise NotImplementedError(
            "moe_ffn over ep_axis=%r (size %d): expert parallelism is "
            "ROADMAP item 10, not ported to paddle_tpu_torch yet"
            % (axis, mesh.shape[axis]))
    x, wg, w1, w2 = (ins[s] for s in ("X", "RouterW", "W1", "W2"))
    shape = x.shape
    x2 = x.reshape(-1, shape[-1])
    gates = torch.softmax(torch.matmul(*_promoted(x2, wg)), dim=-1)
    expert = torch.argmax(gates, dim=-1)
    gate = torch.gather(gates, 1, expert[:, None])[:, 0]
    h = torch.relu(torch.einsum("td,edf->tef", *_promoted(x2, w1)))
    y = torch.einsum("tef,efd->ted", *_promoted(h, w2))
    out = y[torch.arange(x2.shape[0], device=x2.device), expert] * \
        gate[:, None]
    return {"Out": out.reshape(shape)}


def _promoted(a, b):
    """``a`` and ``b`` in their promoted dtype, as the reference's jnp
    promotes the operands of a product (under AMP a bf16 activation
    times an f32 weight runs in f32); torch's products refuse a mix."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt), b.to(dt)
