"""Flash attention (prefill) and paged attention (decode) for the port.

Counterpart of ``paddle_tpu/kernels/flash_attention.py``.  Same
interfaces and layouts: ``[B, H, T, D]`` for the flash forward,
``q [B, H, D]`` with pages ``[N, bs, H, D]`` for paged decode.

Each entry is a wrapper around a hand-written CUDA kernel
(``csrc/flash_fwd.cu``, ``csrc/paged_attention.cu``) with its plain
PyTorch version beside it.  The wrapper checks device, dtype, shape and
contiguity; for a tensor on the CPU it runs the plain version, for a
CUDA tensor it launches the kernel or raises.  ``<wrapper>.launches``
counts kernel launches.
"""
from __future__ import annotations

import ctypes
import math

import torch

from . import _build
from ._build import ptr, require, route, stream

__all__ = ["flash_attention", "flash_attention_fwd_lse",
           "paged_attention", "attention_reference",
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
