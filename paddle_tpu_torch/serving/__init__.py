"""Serving on PyTorch/CUDA — counterpart of ``paddle_tpu/serving``: the
predict tier (``InferenceServer().load(name, model_dir)`` then
``submit`` / ``predict``, ``swap``, the socket endpoint with
``PredictClient``; ``ModelEngine``'s bucket ladder, on a card one CUDA
graph a bucket), the token-level tier
(``InferenceServer().load_generative(...)`` then ``generate(...)``), and
the disaggregated fleet (``FleetWorker``, ``FleetRouter``) of prefill and
decode workers joined by the MigrateKV handoff."""
from __future__ import annotations

from .engine import ModelEngine, bucket_ladder, pow2_bucket
from .fleet import (FleetEndpoint, FleetRemoteError, FleetWorker,
                    LocalTransport, SocketTransport)
from .generative import (FLAGSHIP_LM, DecodeLoop, GenerativeEngine,
                         GenRequest, LMConfig, PrefixCache, dense_forward,
                         tiny_lm)
from .kv_cache import BlockPool
from .router import FleetRouter, default_fleet_slos
from .server import InferenceServer
from .wire import PredictClient, PredictEndpoint, RemoteError

__all__ = ["FLAGSHIP_LM", "BlockPool", "DecodeLoop", "FleetEndpoint",
           "FleetRemoteError", "FleetRouter", "FleetWorker", "GenRequest",
           "GenerativeEngine", "InferenceServer", "LMConfig",
           "LocalTransport", "ModelEngine", "PredictClient",
           "PredictEndpoint", "PrefixCache", "RemoteError",
           "SocketTransport",
           "bucket_ladder", "default_fleet_slos", "dense_forward",
           "pow2_bucket", "tiny_lm"]
