"""Flash attention (forward and backward) and paged attention (decode)
for the port.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``.  Same
interfaces and layouts: ``[B, H, T, D]`` for the flash forward and
backward, ``q [B, H, D]`` with pages ``[N, bs, H, D]`` for paged decode.

Each entry is a wrapper around a hand-written CUDA kernel
(``csrc/flash_fwd.cu``, ``csrc/flash_bwd.cu``, ``csrc/flash_chunk.cu``,
``csrc/paged_attention.cu``) with its plain PyTorch version beside it.
The ring-step chunk form (``flash_attention_chunk`` and its backward)
threads an explicit online-softmax carry for ``parallel/ring.py``.
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
           "flash_bwd_dq", "flash_bwd_dkv", "flash_attention_chunk",
           "chunk_finalize", "flash_attention_chunk_bwd", "paged_attention",
           "attention_reference", "flash_attention_bwd_reference",
           "chunk_update_reference", "chunk_bwd_reference",
           "paged_attention_reference", "paged_span_pages", "NEG_INF"]

NEG_INF = -1e30
# the shapes the kernels are built for: the flagship LM's head_dim and
# the serving block size (flags.serve_kv_block_size)
_HEAD_DIM = 128
_BLOCK_SIZE = 16


# ---------------------------------------------------------------------------
# K1: flash forward with LSE
# ---------------------------------------------------------------------------

def _aligned16(*tensors):
    """Whether every tensor's data starts on a 16-byte boundary, as the
    flash kernels' 16-byte cp.async copies and float4 accesses need (a
    contiguous view at an offset that is not a multiple of 4 floats
    does not)."""
    return all(x.data_ptr() % 16 == 0 for x in tensors)


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
    require(_aligned16(q, k, v), "flash attention kernel needs q/k/v "
            "on 16-byte boundaries (copy an offset view with .clone())")
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
    ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]


def _require_aligned(*tensors):
    require(_aligned16(*tensors), "flash backward kernels need q/k/v/do "
            "on 16-byte boundaries (copy an offset view with .clone())")


def flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, k_offset=0):
    """K2 on the card: dQ ``[B, H, T, D]`` from contiguous float32 CUDA
    operands and ``delta = rowsum(dO * O)`` [B, H, T]; ``causal`` masks
    q_pos < k_offset + k_pos."""
    _require_aligned(q, k, v, do)
    b, h, t, d = q.shape
    dq = torch.empty_like(q)
    fn = _build.function("flash_bwd", "flash_bwd_dq_f32", _BWD_ARGTYPES)
    rc = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dq),
            b * h, t, k.shape[2], d, float(scale), int(bool(causal)),
            int(k_offset), stream())
    _build.check(rc, "flash_bwd_dq")
    flash_bwd_dq.launches += 1
    return dq


flash_bwd_dq.launches = 0


def flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, k_offset=0):
    """K3 on the card: ``(dK, dV)`` ``[B, H, Tk, D]``, operands as for
    ``flash_bwd_dq``."""
    _require_aligned(q, k, v, do)
    b, h, t, d = q.shape
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    fn = _build.function("flash_bwd", "flash_bwd_dkv_f32",
                         [ctypes.c_void_p] + _BWD_ARGTYPES)
    rc = fn(ptr(q), ptr(k), ptr(v), ptr(do), ptr(lse), ptr(delta), ptr(dk),
            ptr(dv), b * h, t, k.shape[2], d, float(scale),
            int(bool(causal)), int(k_offset), stream())
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
# K9: the ring-step chunk update, and its backward through K2/K3
# ---------------------------------------------------------------------------

def _chunk_block_k(tk):
    """K/V rows per step of the plain chunk versions: the JAX package's
    default tile (1024) fitted to ``tk`` as its ``resolve_chunk_blocks``
    fits it, the largest power of two <= 1024 dividing ``tk`` (down to
    8), else all of ``tk``."""
    block = min(1024, tk)
    while block > 8 and tk % block:
        block //= 2
    return block if tk % block == 0 else tk


def _chunk_mask(s, k0, k_offset):
    """Scores ``s`` [B, H, Sq, bk] of a K tile whose first row is ``k0``
    of the block, NEG_INF where q_pos < k_offset + k_pos."""
    t, bk = s.shape[2], s.shape[3]
    q_pos = torch.arange(t, device=s.device)[:, None]
    k_pos = k_offset + k0 + torch.arange(bk, device=s.device)[None, :]
    return s.masked_fill(q_pos < k_pos, NEG_INF)


def chunk_update_reference(q, k, v, m, l, acc, scale, causal, k_offset=0):
    """Plain chunk update — the math of the JAX package's
    ``_chunk_update_xla``: K/V streamed ``_chunk_block_k`` rows at a
    time, masked scores forced to zero mass (the fully-masked guard),
    the carry rescaled by exp(m - m').  Returns new ``(m, l, acc)``."""
    tk = k.shape[2]
    bk = _chunk_block_k(tk)
    qs = q.float() * scale
    for k0 in range(0, tk, bk):
        s = torch.einsum("bhtd,bhkd->bhtk", qs, k[:, :, k0:k0 + bk].float())
        if causal:
            s = _chunk_mask(s, k0, k_offset)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.where(s <= 0.5 * NEG_INF, torch.zeros_like(s),
                        torch.exp(s - m_new[..., None]))
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhtk,bhkd->bhtd", p, v[:, :, k0:k0 + bk].float())
        m = m_new
    return m, l, acc


def flash_attention_chunk(q, k, v, m, l, acc, scale=None, causal=False,
                          k_offset=0):
    """One ring-step update: fold the K/V block into the online-softmax
    carry.

    ``q`` [B, H, Sq, D]; ``k``/``v`` [B, H, Sk, D], one ring block;
    carry ``m``/``l`` [B, H, Sq] f32 (start NEG_INF / 0) and ``acc``
    [B, H, Sq, D] f32 (start 0; the UNNORMALIZED numerator).  Returns
    the new ``(m, l, acc)``.  ``causal`` masks q_pos < k_offset + k_pos:
    ``k_offset`` 0 is the ring's diagonal block, ``k_offset >= Sq`` a
    block wholly in the future, which leaves the carry bit-identical.
    On the card, K9; on the CPU, ``chunk_update_reference``."""
    where = route(q, k, v, m, l, acc)
    require(q.dim() == 4 and k.dim() == 4 and v.shape == k.shape,
            "q/k/v must be [B, H, S, D]")
    b, h, t, d = q.shape
    require(k.shape[:2] == (b, h) and k.shape[3] == d
            and tuple(m.shape) == (b, h, t) and l.shape == m.shape
            and acc.shape == q.shape,
            "shape mismatch q %s k %s m %s l %s acc %s"
            % (tuple(q.shape), tuple(k.shape), tuple(m.shape),
               tuple(l.shape), tuple(acc.shape)))
    require(all(x.dtype == torch.float32 for x in (q, k, v, m, l, acc)),
            "flash attention chunk takes float32")
    require(t > 0 and k.shape[2] > 0, "empty sequence")
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    k_offset = int(k_offset)
    if where == "cpu":
        return chunk_update_reference(q, k, v, m, l, acc, scale, causal,
                                      k_offset)
    require(all(x.is_contiguous() for x in (q, k, v, m, l, acc)),
            "flash chunk kernel needs contiguous inputs")
    require(_aligned16(q, k, v, acc), "flash chunk kernel needs q/k/v "
            "and acc on 16-byte boundaries (copy an offset view with "
            ".clone())")
    require(d == _HEAD_DIM, "flash chunk kernel is built for head_dim %d, "
            "not %d" % (_HEAD_DIM, d))
    m2, l2, acc2 = torch.empty_like(m), torch.empty_like(l), \
        torch.empty_like(acc)
    fn = _build.function(
        "flash_chunk", "flash_chunk_f32",
        [ctypes.c_void_p] * 9 + [ctypes.c_int] * 4
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    rc = fn(ptr(q), ptr(k), ptr(v), ptr(m), ptr(l), ptr(acc), ptr(m2),
            ptr(l2), ptr(acc2), b * h, t, k.shape[2], d, float(scale),
            int(bool(causal)), k_offset, stream())
    _build.check(rc, "flash_chunk")
    flash_attention_chunk.launches += 1
    return m2, l2, acc2


flash_attention_chunk.launches = 0


def chunk_finalize(m, l, acc, dtype):
    """``(out, lse)`` from a finished chunk carry: the numerator over l,
    and lse = m + log l.  Rows that never saw a live key give output 0
    and an lse of NEG_INF, not NaN."""
    l_safe = torch.clamp(l, min=1e-30)
    out = (acc / l_safe[..., None]).to(dtype)
    lse = torch.where(l > 0, m + torch.log(l_safe),
                      torch.full_like(m, NEG_INF))
    return out, lse


def chunk_bwd_reference(q, k, v, do, lse, delta, scale, causal,
                        k_offset=0):
    """Plain chunk backward — the math of the JAX package's
    ``_chunk_bwd_xla``: P rebuilt tile by tile from the saved lse (zero
    for masked scores and for rows whose lse is NEG_INF), K/V streamed
    ``_chunk_block_k`` rows at a time.  Returns ``(dq, dk, dv)``."""
    tk = k.shape[2]
    bk = _chunk_block_k(tk)
    qf, dof = q.float(), do.float()
    dead = lse <= 0.5 * NEG_INF
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    dks, dvs = [], []
    for k0 in range(0, tk, bk):
        kj, vj = k[:, :, k0:k0 + bk].float(), v[:, :, k0:k0 + bk].float()
        s = torch.einsum("bhtd,bhkd->bhtk", qf, kj) * scale
        if causal:
            s = _chunk_mask(s, k0, k_offset)
        p = torch.where((s <= 0.5 * NEG_INF) | dead[..., None],
                        torch.zeros_like(s), torch.exp(s - lse[..., None]))
        dvs.append(torch.einsum("bhtk,bhtd->bhkd", p, dof))
        dp = torch.einsum("bhtd,bhkd->bhtk", dof, vj)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + torch.einsum("bhtk,bhkd->bhtd", ds, kj)
        dks.append(torch.einsum("bhtk,bhtd->bhkd", ds, qf))
    return (dq.to(q.dtype), torch.cat(dks, 2).to(k.dtype),
            torch.cat(dvs, 2).to(v.dtype))


def flash_attention_chunk_bwd(q, k, v, do, lse, delta, scale=None,
                              causal=False, k_offset=0):
    """Backward of one ring step: ``(dq, dk, dv)`` of one Q shard against
    one K/V block, from the forward's per-row ``lse`` [B, H, Sq] and
    ``delta`` = rowsum(dO * O) [B, H, Sq]; no forward re-run.  Same
    ``causal``/``k_offset`` contract as ``flash_attention_chunk``.  On
    the card it runs K2 (dQ) and K3 (dK, dV), whose mask takes the
    offset, as the JAX package's TPU branch runs its two flash backward
    kernels (its causal off-diagonal offsets go to ``_chunk_bwd_xla``,
    the same math); a CPU tensor takes ``chunk_bwd_reference``."""
    where = _bwd_args(q, k, v, do, lse, do)    # no O: dO stands in
    require(tuple(delta.shape) == tuple(lse.shape)
            and delta.device == q.device,
            "delta must be [B, H, Sq] beside q")
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[3])
    delta = delta.float()
    if where == "cpu":
        return chunk_bwd_reference(q, k, v, do, lse, delta, scale, causal,
                                   int(k_offset))
    require(delta.is_contiguous(), "flash backward kernels need a "
            "contiguous delta")
    dq = flash_bwd_dq(q, k, v, do, lse, delta, scale, causal, k_offset)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, scale, causal, k_offset)
    return dq, dk, dv


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
    (>= 1; a padding row uses 1).

    On the card it runs K7 (``csrc/paged_attention.cu``): each row's
    live pages split into spans of ``paged_span_pages()``, one block a
    (span, head, sequence), the spans folded in order by a second
    launch; table slots past a row's context are never read.
    ``launches`` counts calls, not the kernels of a call."""
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
    require(_aligned16(q, k_pages, v_pages), "paged attention kernel "
            "needs q and the pages on 16-byte boundaries")
    nb = block_tables.shape[1]
    spans = -(-nb // paged_span_pages())
    out = torch.empty_like(q)
    # each span's (acc, m, l) where a row has more than one live span
    part = q.new_empty((b, h, spans, d + 2)) if spans > 1 else None
    fn = _build.function(
        "paged_attention", "paged_attention_f32",
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6
        + [ctypes.c_float, ctypes.c_void_p])
    rc = fn(ptr(q), ptr(k_pages), ptr(v_pages), ptr(block_tables),
            ptr(context_lens), ptr(out),
            ptr(part) if part is not None else ctypes.c_void_p(None),
            b, h, d, bs, nb, spans, float(scale), stream())
    _build.check(rc, "paged_attention")
    paged_attention.launches += 1
    return out


paged_attention.launches = 0


def paged_span_pages():
    """K7's span length P in pages, as its launcher has it: a constant
    of the library, never a function of the batch, the table width or
    the lengths, so a row's result is batch-invariant."""
    return _build.function("paged_attention", "paged_span_pages", [])()
