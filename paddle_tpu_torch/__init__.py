"""PyTorch/CUDA port of paddle_tpu.

A second package beside ``paddle_tpu``: same module names, PyTorch
tensors instead of jax arrays, and hand-written CUDA C++ kernels for
Hopper (``kernels/csrc``) where the JAX package wrote Pallas kernels for
the TPU.  It imports nothing of jax or paddle_tpu.

Ported so far: token-level generative serving
(``serving.InferenceServer().load_generative(...)`` then ``generate``)
and training of the transformer LM through the fluid front-end
(``fluid``, ``models.transformer.get_model``, ``fluid.Executor``), with
checkpoints (``fluid.io``), ``fluid.Trainer`` / ``fluid.Inferencer``
and readers (``reader``, ``batch``).
"""
from __future__ import annotations

from .device import resolve_device
from .reader import batch

__all__ = ["resolve_device", "batch"]
