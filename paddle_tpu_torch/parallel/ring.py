"""Ring attention: sequence parallelism over a mesh axis.

Counterpart of ``paddle_tpu/parallel/ring.py``.  Q/K/V [B, H, S, D] are
cut along S into p contiguous shards over the ``sp`` axis, shard ``i``
on the axis's device ``i``.  Each shard folds one K/V block a step into
an online-softmax carry (``flash_attention_chunk``, K9 on the card), so
no [S_local, S_local] score block is ever stored:

- **Forward.**  Step ``j`` of shard ``my`` folds the K/V block of shard
  (my - j) mod p, with the causal mask only on the diagonal step
  (j == 0); under ``causal`` a block wholly in the shard's future
  (j > my) is skipped, so the ring runs p(p+1)/2 folds, not p^2.
- **Backward.**  From the saved per-row lse, no forward re-run: step
  ``j`` at K/V home ``my`` takes the Q package (q, dO, lse, delta) of
  shard (my + j) mod p, live when j == 0 or j < p - my.  dK and dV
  stay home; each dQ travels with its package, so shard s's dQ takes
  home s first, then s - 1, and so on, as the JAX ring adds them.

On bf16 Q/K/V (the sp LM under AMP) the carry, the lse and delta stay
float32: each fold runs K9's bf16 form, ``out`` is rounded to q's dtype
once by ``chunk_finalize``, and each backward step's bf16 gradients
(K2/K3's bf16 forms, dO cast to q's dtype on the card) are summed in
float32 and rounded once, as the JAX ring's are.  delta is taken from
the cotangent as it arrives, as the JAX ring takes it.

The JAX package runs the shards at once under ``shard_map`` and moves
blocks with ``ppermute``.  Here one process runs them in turn, and the
collective is an index into the list of shards plus a ``.to(device)``
where two shards' devices differ (none does on a one-card mesh).  Each
per-shard step is the exact chunk call of a p-card ring.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.kernels.flash_attention import (
    NEG_INF, chunk_finalize, flash_attention_chunk,
    flash_attention_chunk_bwd)

__all__ = ["ring_attention", "ring_attention_fwd_lse",
           "ring_attention_bwd", "causal_step_counts"]


def _step_live(j, my, p, causal, direction):
    """Whether ring step ``j`` runs on ring position ``my``.

    forward: after j steps the local K/V block is shard (my - j) mod p's,
    wholly in the past iff j <= my.  backward: after j reverse steps the
    visiting Q package is shard (my + j) mod p's, at or after the local
    K/V block iff j < p - my.  The diagonal step and every non-causal
    step always run."""
    if j == 0 or not causal:
        return True
    if direction == "fwd":
        return j <= my
    return j < p - my


def _ring_devices(mesh, axis_name, batch_axis, head_axis):
    for name, axis in (("batch_axis", batch_axis), ("head_axis", head_axis)):
        if axis is not None:
            raise NotImplementedError(
                "ring attention with %s=%r: only the sp axis is ported "
                "to paddle_tpu_torch yet" % (name, axis))
    return mesh.axis_devices(axis_name)


def _split(x, devices):
    """``x`` ([B, H, S, ...]) cut along S into len(devices) contiguous
    shards, shard i on devices[i]."""
    p = len(devices)
    if x.shape[2] % p:
        raise ValueError("sequence length %d does not split over %d ring "
                         "shards" % (x.shape[2], p))
    return [s.to(d).contiguous() for s, d in zip(x.chunk(p, dim=2),
                                                 devices)]


def _join(shards, device):
    return torch.cat([s.to(device) for s in shards], dim=2)


def _ring_fwd_shard(my, qs, ks, vs, devices, causal, scale):
    """Forward of ring position ``my`` over the shard lists: returns its
    (out [B, H, S_local, D], lse [B, H, S_local] f32)."""
    p, dev = len(devices), devices[my]
    q = qs[my]
    m = torch.full(q.shape[:3], NEG_INF, dtype=torch.float32, device=dev)
    l = torch.zeros(q.shape[:3], dtype=torch.float32, device=dev)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=dev)
    for j in range(p):
        if not _step_live(j, my, p, causal, "fwd"):
            continue
        src = (my - j) % p
        m, l, acc = flash_attention_chunk(
            q, ks[src].to(dev), vs[src].to(dev), m, l, acc, scale=scale,
            causal=causal and j == 0)
    return chunk_finalize(m, l, acc, q.dtype)


def _ring_bwd_shards(qs, ks, vs, dos, lses, deltas, devices, causal,
                     scale):
    """Backward over every ring position: returns the per-shard (dq,
    dk, dv) lists.  Steps run in ring order (j outer), so each sum is
    taken in the JAX ring's order."""
    p = len(devices)
    dq = [torch.zeros(q.shape, dtype=torch.float32, device=q.device)
          for q in qs]
    dk = [torch.zeros(k.shape, dtype=torch.float32, device=k.device)
          for k in ks]
    dv = [torch.zeros(v.shape, dtype=torch.float32, device=v.device)
          for v in vs]
    for j in range(p):
        for my in range(p):
            src = (my + j) % p     # the visiting Q package's shard
            if not _step_live(j, my, p, causal, "bwd"):
                continue
            dev = devices[my]
            dqj, dkj, dvj = flash_attention_chunk_bwd(
                qs[src].to(dev), ks[my], vs[my], dos[src].to(dev),
                lses[src].to(dev), deltas[src].to(dev), scale=scale,
                causal=causal and j == 0)
            dq[src] = dq[src].to(dev) + dqj.float()
            dk[my] = dk[my] + dkj.float()
            dv[my] = dv[my] + dvj.float()
    dq = [g.to(q.device).to(q.dtype) for g, q in zip(dq, qs)]
    dk = [g.to(k.dtype) for g, k in zip(dk, ks)]
    dv = [g.to(v.dtype) for g, v in zip(dv, vs)]
    return dq, dk, dv


def ring_attention_fwd_lse(q, k, v, mesh, axis_name="sp", causal=True,
                           scale=None, batch_axis=None, head_axis=None):
    """Forward returning ``(out, lse)``, the op-level residual form:
    ``lse`` [B, H, S] f32 is the real per-row log-sum-exp, which the
    grad op's ``ring_attention_bwd`` replays P from.  Both come back on
    ``q``'s device."""
    devices = _ring_devices(mesh, axis_name, batch_axis, head_axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs, ks, vs = (_split(x, devices) for x in (q, k, v))
    outs = [_ring_fwd_shard(my, qs, ks, vs, devices, causal, scale)
            for my in range(len(devices))]
    return (_join([o for o, _ in outs], q.device),
            _join([lse for _, lse in outs], q.device))


def ring_attention_bwd(q, k, v, out, lse, do, mesh, axis_name="sp",
                       causal=True, scale=None, batch_axis=None,
                       head_axis=None):
    """Backward from the op-level residuals: ``(dq, dk, dv)`` through the
    reverse ring over the saved lse, no forward re-run."""
    devices = _ring_devices(mesh, axis_name, batch_axis, head_axis)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qs, ks, vs, outs, dos, lses = (_split(x, devices)
                                   for x in (q, k, v, out, do, lse))
    deltas = [(g.float() * o.float()).sum(-1) for g, o in zip(dos, outs)]
    dq, dk, dv = _ring_bwd_shards(qs, ks, vs, dos, lses, deltas, devices,
                                  causal, scale)
    return (_join(dq, q.device), _join(dk, k.device), _join(dv, v.device))


class _RingAttention(torch.autograd.Function):
    """The ring forward saving (q, k, v, out, lse); backward is the
    reverse ring — the counterpart of the JAX package's custom_vjp."""

    @staticmethod
    def forward(ctx, q, k, v, mesh, axis_name, causal, scale):
        out, lse = ring_attention_fwd_lse(q, k, v, mesh, axis_name, causal,
                                          scale)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.ring = (mesh, axis_name, causal, scale)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        mesh, axis_name, causal, scale = ctx.ring
        dq, dk, dv = ring_attention_bwd(q, k, v, out, lse, dout, mesh,
                                        axis_name, causal, scale)
        return dq, dk, dv, None, None, None, None


def ring_attention(q, k, v, mesh, axis_name="sp", causal=True, scale=None,
                   batch_axis=None, head_axis=None):
    """q, k, v: [B, H, S, D], S split over ``axis_name``; returns
    [B, H, S, D].  Differentiable: autograd runs the saved-lse reverse
    ring (no forward re-run, no [S, S] block)."""
    _ring_devices(mesh, axis_name, batch_axis, head_axis)
    return _RingAttention.apply(q, k, v, mesh, axis_name, causal, scale)


def causal_step_counts(mesh, axis_name="sp", causal=True, direction="fwd"):
    """Chunk folds each ring position runs (a list of p ints), from the
    same liveness rule the ring loops follow.  Causal at p shards they
    sum to p(p+1)/2 against p*p dense."""
    p = mesh.shape[axis_name]
    return [sum(_step_live(j, my, p, causal, direction) for j in range(p))
            for my in range(p)]
