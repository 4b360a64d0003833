"""PyTorch/CUDA port of paddle_tpu.

A second package beside ``paddle_tpu``: same module names, PyTorch
tensors instead of jax arrays, and hand-written CUDA C++ kernels for
Hopper (``kernels/csrc``) where the JAX package wrote Pallas kernels for
the TPU.  It imports nothing of jax or paddle_tpu.

Ported so far: token-level generative serving
(``serving.InferenceServer().load_generative(...)`` then ``generate``),
the predict tier (``InferenceServer().load(name, model_dir)`` then
``submit`` / ``predict`` / ``swap``, the socket endpoint) and the
predictor API (``inference.create_paddle_predictor``, AOT programs from
``fluid.io.save_inference_model(aot_feed_specs=...)``), and training of the transformer LM through the fluid front-end
(``fluid``, ``models.transformer.get_model``, ``fluid.Executor``), with
checkpoints (``fluid.io``), ``fluid.Trainer`` / ``fluid.Inferencer``,
readers (``reader``, ``batch``, ``DeviceLoader``, ``DeviceDatasetCache``),
the recordio container (``recordio``) and dataset adapters (``dataset``).
"""
from __future__ import annotations

from .device import resolve_device
from . import reader  # noqa: F401
from . import dataset  # noqa: F401
from . import recordio  # noqa: F401
from .reader import batch

__all__ = ["resolve_device", "batch"]
