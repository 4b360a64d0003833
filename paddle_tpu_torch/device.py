"""Device resolution for the port's entry points.

The JAX package picks its device through ``core/place.py`` places and
``jax.devices()``; here every entry point takes ``device=None``, which
means ``"cuda"``.  Without a card that default raises instead of
quietly running on the host: the caller asks for the CPU explicitly
(``device="cpu"``), as the CPU tests do.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None):
    """``torch.device`` for ``device`` (None -> cuda).  Raises
    RuntimeError for a CUDA device when CUDA is unavailable.

    On CUDA this also pins float32 matmuls to full float32: the
    reference engine computes in f32 and the parity checks assume it,
    so TF32 (three decimal digits) is switched off explicitly for
    cuBLAS matmuls and cuDNN rather than left to PyTorch's defaults.
    And bf16 cuBLAS matmuls sum in float32 throughout, as the
    reference's bf16 dots do: PyTorch's default lets cuBLAS reduce a
    bf16 product's split-K partials in bf16."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run the "
                "port on the host")
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction \
            = False
    elif dev.type != "cpu":
        raise ValueError("unsupported device %r (want cuda or cpu)"
                         % (device,))
    return dev
