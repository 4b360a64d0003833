"""Data-input layers (counterpart of paddle_tpu/fluid/layers/io.py;
``data`` only: the reader-op chain is not ported yet)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["data"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        # a ragged (LoD) feed would be padded [N, T, ...]: a time dim is
        # inserted after batch, as in the JAX package
        shape = [-1] * (1 + (1 if lod_level > 0 else 0)) + shape
    return helper.create_global_variable(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient)
