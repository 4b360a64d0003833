"""Fused softmax cross-entropy (K10).

Counterpart of ``paddle_tpu/kernels/fused.py``: per-row
-log softmax(logits)[label] in one pass over the logits, the class axis
streamed with an online logsumexp, so the [N, C] probabilities never
exist in memory.  As in the JAX package, no op calls it: it is a
module export (``kernels.fused_softmax_cross_entropy``).

The wrapper launches ``csrc/fused_ce.cu`` for a CUDA tensor, or raises;
for a CPU tensor it runs the plain version beside it.
``fused_softmax_cross_entropy.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build
from ._build import ptr, require, route, stream

__all__ = ["fused_softmax_cross_entropy", "softmax_ce_reference"]


def softmax_ce_reference(logits, labels):
    """Plain version — the JAX package's ``_xla_path``: logsumexp of the
    f32 row minus its label logit, cast back to the logits' dtype."""
    x = logits.float()
    lse = torch.logsumexp(x, dim=-1)
    picked = torch.gather(x, 1, labels.long()[:, None])[:, 0]
    return (lse - picked).to(logits.dtype)


def fused_softmax_cross_entropy(logits, labels):
    """Per-row -log softmax(logits)[label]: ``logits`` [N, C] float32,
    ``labels`` [N] (or [N, 1]) integer class ids in [0, C); returns the
    loss [N] float32."""
    labels = labels.reshape(-1)
    where = route(logits, labels)
    require(logits.dim() == 2, "logits must be [N, C]")
    n, c = logits.shape
    require(labels.shape[0] == n, "labels %s do not match logits %s"
            % (tuple(labels.shape), tuple(logits.shape)))
    require(logits.dtype == torch.float32, "fused cross-entropy takes "
            "float32 logits")
    require(not labels.is_floating_point() and not labels.is_complex(),
            "labels must be integer class ids")
    require(n > 0 and c > 0, "empty logits")
    if where == "cpu":
        return softmax_ce_reference(logits, labels)
    require(logits.is_contiguous(), "fused cross-entropy kernel needs "
            "contiguous logits")
    lab = labels.to(torch.int32).contiguous()
    out = torch.empty(n, dtype=torch.float32, device=logits.device)
    fn = _build.function("fused_ce", "fused_ce_f32",
                         [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
                         + [ctypes.c_void_p])
    rc = fn(ptr(logits), ptr(lab), ptr(out), n, c, stream())
    _build.check(rc, "fused_ce")
    _build.count(fused_softmax_cross_entropy)
    return out


fused_softmax_cross_entropy.launches = 0
