"""Power-of-2 shape buckets — the part of ``paddle_tpu/serving/engine.py``
the generative tier uses.

The JAX package compiles one executable per bucket (``StepCache``); the
port runs eagerly, so it keeps only the bucket arithmetic, which fixes
the shapes both packages compute on.  A per-bucket CUDA graph is the
later counterpart of ``StepCache``.
"""
from __future__ import annotations

__all__ = ["bucket_ladder", "pow2_bucket"]


def bucket_ladder(max_batch):
    """Power-of-2 ladder up to and including max_batch: 1,2,4,...; a
    non-power-of-2 cap contributes itself as the top bucket."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return out


def pow2_bucket(n, cap):
    """Smallest power of two >= n, clamped to cap (which joins the
    ladder even when it is not itself a power of two)."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, int(cap))
