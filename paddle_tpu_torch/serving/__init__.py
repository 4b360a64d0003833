"""Generative serving on PyTorch/CUDA — the token-level tier of
``paddle_tpu/serving``: ``InferenceServer().load_generative(...)`` then
``generate(...)``."""
from __future__ import annotations

from .engine import bucket_ladder, pow2_bucket
from .generative import (FLAGSHIP_LM, DecodeLoop, GenerativeEngine,
                         GenRequest, LMConfig, PrefixCache, dense_forward,
                         tiny_lm)
from .kv_cache import BlockPool
from .server import InferenceServer

__all__ = ["FLAGSHIP_LM", "BlockPool", "DecodeLoop", "GenRequest",
           "GenerativeEngine", "InferenceServer", "LMConfig", "PrefixCache",
           "bucket_ladder", "dense_forward", "pow2_bucket", "tiny_lm"]
