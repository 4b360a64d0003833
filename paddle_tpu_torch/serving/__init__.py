"""Generative serving on PyTorch/CUDA — the token-level tier of
``paddle_tpu/serving``: ``InferenceServer().load_generative(...)`` then
``generate(...)``; and the disaggregated fleet (``FleetWorker``,
``FleetRouter``) of prefill and decode workers joined by the MigrateKV
handoff."""
from __future__ import annotations

from .engine import bucket_ladder, pow2_bucket
from .fleet import (FleetEndpoint, FleetRemoteError, FleetWorker,
                    LocalTransport, SocketTransport)
from .generative import (FLAGSHIP_LM, DecodeLoop, GenerativeEngine,
                         GenRequest, LMConfig, PrefixCache, dense_forward,
                         tiny_lm)
from .kv_cache import BlockPool
from .router import FleetRouter, default_fleet_slos
from .server import InferenceServer

__all__ = ["FLAGSHIP_LM", "BlockPool", "DecodeLoop", "FleetEndpoint",
           "FleetRemoteError", "FleetRouter", "FleetWorker", "GenRequest",
           "GenerativeEngine", "InferenceServer", "LMConfig",
           "LocalTransport", "PrefixCache", "SocketTransport",
           "bucket_ladder", "default_fleet_slos", "dense_forward",
           "pow2_bucket", "tiny_lm"]
