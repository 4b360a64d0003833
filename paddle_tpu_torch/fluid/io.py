"""Moving a scope's values across devices and frameworks.

The JAX package's fluid/io.py saves and loads parameters to files; the
port has only what carries weights across so far: numpy arrays in and
out of a scope, which is how the tests load the JAX package's startup
results (the two draw different random numbers from one seed) and how a
card run is replayed on the CPU.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.device import resolve_device

__all__ = ["set_scope_arrays", "get_scope_arrays"]


def set_scope_arrays(scope, arrays, device=None):
    """Write ``{name: np.ndarray}`` into ``scope`` as tensors on
    ``device`` (None -> cuda, as for every entry point of the port)."""
    dev = resolve_device(device)
    for name, arr in arrays.items():
        arr = np.asarray(arr)
        if not arr.flags.writeable:     # torch.from_numpy wants writable
            arr = arr.copy()
        scope.set(name, torch.from_numpy(np.ascontiguousarray(arr)).to(dev))


def get_scope_arrays(scope, names):
    """``{name: np.ndarray}`` of ``names`` read from ``scope``."""
    out = {}
    for name in names:
        val = scope.find_var(name)
        out[name] = (val.detach().cpu().numpy()
                     if isinstance(val, torch.Tensor) else np.asarray(val))
    return out
