"""Flash attention (forward and backward) and paged attention (decode)
for the port.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``.  Same
interfaces and layouts: ``[B, H, T, D]`` for the flash forward and
backward, ``q [B, H, D]`` with pages ``[N, bs, H, D]`` for paged decode.

Each entry is a wrapper around a hand-written CUDA kernel
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``,
``csrc/paged_attention.cu``) with its plain PyTorch version beside it.
The wrapper checks device, dtype, shape and contiguity; for a tensor on
the CPU it runs the plain version, for a CUDA tensor it launches the
kernel or raises.  ``<wrapper>.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._build import ptr, require, route, stream

__all__ = ["flash_attention", "flash_attention_fwd_lse",
           "flash_attention_bwd", "flash_attention_train",
           "flash_bwd_dq", "flash_bwd_dkv", "paged_attention",
           "attention_reference", "flash_attention_bwd_reference",
           "paged_attention_reference", "NEG_INF"]

NEG_INF = -1e30
# the shapes the kernels are built for: the flagship LM's head_dim and
# the serving block size (flags.serve_kv_block_size)
_HEAD_DIM = 128
_BLOCK_SIZE = 16


# ---------------------------------------------------------------------------
# K1: flash forward with LSE
# ---------------------------------------------------------------------------

def attention_reference(q, k, v, scale, causal):
    """Plain attention returning ``(out, lse)`` — the math of the JAX
    package's ``flash_attention_fwd_lse`` fallback branch: f32 scores,
    top-left-aligned causal mask filled with NEG_INF, per-row
    log-sum-exp."""
    t, tk = q.shape[2], k.shape[2]
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if causal:
        mask = torch.ones(t, tk, dtype=torch.bool,
                          device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)
    p = torch.exp(s - lse[..., None])
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float()).to(q.dtype)
    return out, lse


def flash_attention_fwd_lse(q, k, v, scale=None, causal=False):
    """softmax(Q K^T scale [causal]) V and its per-row log-sum-exp:
    ``q`` [B, H, T, D], ``k``/``v`` [B, H, Tk, D], float32; returns
    ``(out [B, H, T, D], lse f32 [B, H, T])``."""
    where = route(q, k, v)
    require(q.dim() == 4 and k.dim() == 4 and v.dim() == 4,
            "q/k/v must be [B, H, T, D]")
    b, h, t, d = q.shape
    require(k.shape[:2] == (b, h) and k.shape[3] == d
            and v.shape == k.shape,
            "shape mismatch q %s k %s v %s"
            % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    require(all(x.dtype == torch.float32 for x in (q, k, v)),
            "flash attention takes float32")
    require(t > 0 and k.shape[2] > 0, "empty sequence")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if where == "cpu":
        return attention_reference(q, k, v, scale, causal)
    require(all(x.is_contiguous() for x in (q, k, v)),
            "flash attention kernel needs contiguous q/k/v")
    require(d == _HEAD_DIM, "flash kernel is built for head_dim %d, not %d"
            % (_HEAD_DIM, d))
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device)
    fn = _build.function(
        "flash_fwd", "flash_fwd_f32",
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    rc = fn(ptr(q), ptr(k), ptr(v), ptr(out), ptr(lse), b * h, t,
            k.shape[2], d, float(scale), int(bool(causal)), stream())
    _build.check(rc, "flash_fwd")
    flash_attention_fwd_lse.launches += 1
    return out, lse


flash_attention_fwd_lse.launches = 0


def flash_attention(q, k, v, scale=None, causal=False):
    """softmax(Q K^T scale [causal]) V, ``[B, H, T, D]`` in and out (the
    forward of ``flash_attention_fwd_lse`` without the LSE)."""
    return flash_attention_fwd_lse(q, k, v, scale, causal)[0]


# ---------------------------------------------------------------------------
# K2 / K3: flash backward from the saved LSE
# ---------------------------------------------------------------------------

def flash_attention_bwd_reference(q, k, v, out, lse, do, scale, causal):
    """Plain attention backward returning ``(dq, dk, dv)`` — the math of
    the JAX package's ``flash_attention_bwd`` fallback branch: P rebuilt
    from the saved lse under the same top-left causal mask, then
    dV = P^T dO, dS = P (dO V^T - rowsum(dO O)) scale, dQ = dS K,
    dK = dS^T Q."""
    t, tk = q.shape[2], k.shape[2]
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    s = torch.einsum("bhtd,bhsd->bhts", qf, kf) * scale
    if causal:
        mask = torch.ones(t, tk, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, NEG_INF)
    p = torch.exp(s - lse[..., None])
    dv = torch.einsum("bhts,bhtd->bhsd", p, dof)
    dp = torch.einsum("bhtd,bhsd->bhts", dof, vf)
    delta = (dof * out.float()).sum(-1)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhts,bhsd->bhtd", ds, kf)
    dk = torch.einsum("bhts,bhtd->bhsd", ds, qf)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _bwd_args(q, k, v, out, lse, do):
    """Check the backward's operands; returns the device route."""
    where = route(q, k, v, out, lse, do)
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            "q/k/v must be [B, H, T, D]")
    b, h, t, d = q.shape
    require(k.shape[:2] == (b, h) and k.shape[3] == d
            and out.shape == q.shape and do.shape == q.shape
            and tuple(lse.shape) == (b, h, t),
            "shape mismatch q %s k %s out %s lse %s do %s"
            % (tuple(q.shape), tuple(k.shape), tuple(out.shape),
               tuple(lse.shape), tuple(do.shape)))
    require(all(x.dtype == torch.float32 for x in (q, k, v, out, lse, do)),
            "flash attention backward takes float32")
    if where == "cuda":
        require(all(x.is_contiguous() for x in (q, k, v, out, lse, do)),
                "flash backward kernels need contiguous inputs")
        require(d == _HEAD_DIM, "flash backward kernels are built for "
                "head_dim %d, not %d" % (_HEAD_DIM, d))
    return where


_BWD_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 4 + [
    ctypes.c_float, ctypes.c_int, ctypes.c_void_p]


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal):
    """K2 on the card: dQ ``[B, H, T, D]`` from contiguous float32 CUDA
    operands and ``delta = rowsum(dO * O)`` [B, H, T]."""
    b, h, t, d = q.shape
    dq = torch.empty_like(q)
    fn = _build.function("flash_bwd", "flash_bwd_dq_f32", _BWD_ARGTYPES)
    rc = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
            b * h, t, k.shape[2], d, float(scale), int(bool(causal)),
            stream())
    _build.check(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal):
    """K3 on the card: ``(dK, dV)`` ``[B, H, Tk, D]``, operands as for
    ``flash_bwd_dq``."""
    b, h, t, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.function("flash_bwd", "flash_bwd_dkv_f32",
                         [ctypes.c_void_p] + _BWD_ARGTYPES)
    rc = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk),
            ptr(dv), b * h, t, k.shape[2], d, float(scale),
            int(bool(causal)), stream())
    _build.check(rc, "flash_bwd_dkv")
    flash_bwd_dkv.launches += 1
    return dk, dv


flash_bwd_dkv.launches = 0


def flash_attention_bwd(q, k, v, out, lse, do, scale=None, causal=False):
    """Backward of ``flash_attention_fwd_lse`` from its residuals: P is
    rebuilt tile by tile from the saved ``lse`` (no forward re-run, no
    [T, T] matrix).  All operands float32, ``lse`` [B, H, T]; returns
    ``(dq, dk, dv)``.  On the card: ``delta = rowsum(dO * O)`` in
    PyTorch (the JAX package also computes it outside its kernels), then
    K2 (dQ) and K3 (dK, dV)."""
    where = _bwd_args(q, k, v, out, lse, do)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    if where == "cpu":
        return flash_attention_bwd_reference(q, k, v, out, lse, do, scale,
                                             causal)
    delta = (do * out).sum(-1)
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal)
    return dq, dk, dv


class _FlashAttention(torch.autograd.Function):
    """K1 forward, K2/K3 backward from the saved (q, k, v, out, lse);
    the LSE output takes no gradient (the JAX op's no_vjp output)."""

    @staticmethod
    def forward(ctx, q, k, v, scale, causal):
        out, lse = flash_attention_fwd_lse(q, k, v, scale, causal)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.scale, ctx.causal = scale, causal
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, dout, _dlse):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse,
                                         dout.contiguous(), ctx.scale,
                                         ctx.causal)
        return dq, dk, dv, None, None


def flash_attention_train(q, k, v, scale=None, causal=False):
    """``flash_attention_fwd_lse`` that autograd differentiates through
    the flash backward (kernels on the card, plain versions on the
    CPU) instead of through its ops."""
    return _FlashAttention.apply(q, k, v, scale, causal)


# ---------------------------------------------------------------------------
# K7: paged decode attention
# ---------------------------------------------------------------------------

def paged_attention_reference(q, k_pages, v_pages, block_tables,
                              context_lens, scale):
    """Plain paged attention — the math of the JAX package's
    ``_paged_attention_xla``: gather each sequence's pages through its
    block table, mask positions >= its context length with NEG_INF,
    softmax, weighted sum of V."""
    tables = block_tables.long()
    b, nb = tables.shape
    _, bs, h, d = k_pages.shape
    k_ctx = k_pages[tables].reshape(b, nb * bs, h, d)
    v_ctx = v_pages[tables].reshape(b, nb * bs, h, d)
    s = torch.einsum("bhd,bshd->bhs", q.float(), k_ctx.float()) * scale
    pos = torch.arange(nb * bs, device=q.device)
    live = pos[None, None, :] < context_lens.long()[:, None, None]
    s = s.masked_fill(~live, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v_ctx.float()).to(q.dtype)


def paged_attention(q, k_pages, v_pages, block_tables, context_lens,
                    scale=None):
    """Decode-mode attention through a paged KV cache.

    ``q`` [B, H, D] — one query token per sequence; ``k_pages``/
    ``v_pages`` [N, bs, H, D] — the block pool; ``block_tables`` [B, NB]
    int32 — each sequence's page ids (slots past its context are
    masked); ``context_lens`` [B] int32 — real context per sequence
    (>= 1; a padding row uses 1)."""
    where = route(q, k_pages, v_pages, block_tables, context_lens)
    require(q.dim() == 3 and k_pages.dim() == 4
            and v_pages.shape == k_pages.shape,
            "want q [B, H, D] and pages [N, bs, H, D]")
    b, h, d = q.shape
    n, bs, hp, dp = k_pages.shape
    require((hp, dp) == (h, d), "q %s does not match pages %s"
            % (tuple(q.shape), tuple(k_pages.shape)))
    require(block_tables.dim() == 2 and block_tables.shape[0] == b
            and tuple(context_lens.shape) == (b,),
            "want block_tables [B, NB] and context_lens [B]")
    require(block_tables.dtype == torch.int32
            and context_lens.dtype == torch.int32,
            "block_tables and context_lens must be int32")
    require(all(x.dtype == torch.float32 for x in (q, k_pages, v_pages)),
            "paged attention takes float32")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if where == "cpu":
        return paged_attention_reference(q, k_pages, v_pages, block_tables,
                                         context_lens, scale)
    require(all(x.is_contiguous() for x in
                (q, k_pages, v_pages, block_tables, context_lens)),
            "paged attention kernel needs contiguous inputs")
    require(d == _HEAD_DIM and bs == _BLOCK_SIZE,
            "paged kernel is built for head_dim %d and block_size %d, not "
            "%d and %d" % (_HEAD_DIM, _BLOCK_SIZE, d, bs))
    out = torch.empty_like(q)
    fn = _build.function(
        "paged_attention", "paged_attention_f32",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptr(q), ptr(k_pages), ptr(v_pages), ptr(block_tables),
            ptr(context_lens), ptr(out), b, h, d, bs,
            block_tables.shape[1], float(scale), stream())
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0
