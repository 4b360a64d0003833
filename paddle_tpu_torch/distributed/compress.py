"""The port's copy of the int8 quantizer of
``paddle_tpu/distributed/compress.py`` (``CHUNK``,
``quantize_symmetric``).  Host numpy; it must round exactly as the
original does, so a weight quantized by either package is the same
bytes."""
from __future__ import annotations

import numpy as np

__all__ = ["CHUNK", "quantize_symmetric"]

# int8 quantization granularity: one f32 scale per CHUNK elements
CHUNK = 2048


def quantize_symmetric(chunks):
    """Per-chunk symmetric int8 quantization of ``chunks`` [n, chunk]:
    scale = absmax/127 per row (1.0 for all-zero rows so dequant stays
    exact zeros).  Returns (q int8 [n, chunk], scales f32 [n])."""
    chunks = np.ascontiguousarray(chunks, np.float32)
    absmax = np.abs(chunks).max(axis=1) if chunks.shape[0] else \
        np.zeros(0, np.float32)
    scales = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
    q = np.clip(np.rint(chunks / scales[:, None]), -127, 127) \
        .astype(np.int8)
    return q, scales
