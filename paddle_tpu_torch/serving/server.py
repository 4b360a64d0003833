"""Multi-tenant inference server: the predict tier and the generative
tenants of ``paddle_tpu/serving/server.py``.

One InferenceServer multiplexes any number of loaded models (tenants)
in one process.

- A predict tenant (``load``) owns a ModelEngine (its parameter scope on
  the device, its bucket executables — on a card one CUDA graph each), a
  request queue and a continuous-batching dispatcher thread
  (``batcher.Dispatcher``).  Requests come in through ``submit(model,
  feed) -> Future`` / ``predict`` (the blocking convenience), and over a
  socket through ``start_endpoint(port)``, which serves the
  fastwire-framed Predict method (``wire.py``) for out-of-process
  clients.  ``swap(model, new_dir)`` builds the new engine IN SHADOW
  (fresh scope, params loaded, warm buckets built) and then atomically
  flips the tenant's route pointer: a batch snapshots the route once, so
  every request is served whole by exactly one engine version, and none
  is dropped.
- A generative tenant (``load_generative``) owns a GenerativeEngine, a
  request queue and a DecodeLoop thread; ``generate`` returns a Future of
  ``{"tokens", "ttft_ms", "itl_ms", "preempted"}``.  On a card its warm
  buckets are captured as CUDA graphs when it loads; it may keep a
  prefix cache and speculate with a draft LM (``prefix_cache``,
  ``spec_k`` and ``draft``).

``unload`` and ``close`` stop a tenant's thread, then let its engine go
(a generative engine joins its background captures and drops the
graphs before the pages; a predict engine joins its background bucket
builds).  ``device=None`` means the card; pass ``device='cpu'`` to serve
on the host.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np

from .batcher import Dispatcher, Request, RequestQueue
from .engine import ModelEngine
from .generative import DecodeLoop, GenerativeEngine, GenRequest

__all__ = ["InferenceServer"]


class _Tenant:
    __slots__ = ("name", "engine", "queue", "dispatcher")

    def __init__(self, name, engine, max_wait_us):
        self.name = name
        self.engine = engine     # the atomically-swappable route
        self.queue = RequestQueue()
        self.dispatcher = Dispatcher(self.queue, lambda: self.engine,
                                     max_wait_us=max_wait_us, label=name)


class _GenTenant:
    __slots__ = ("name", "engine", "queue", "dispatcher")

    def __init__(self, name, engine):
        self.name = name
        self.engine = engine
        self.queue = RequestQueue()
        self.dispatcher = DecodeLoop(engine, self.queue, label=name)


class InferenceServer:
    """``load`` predict tenants, ``submit`` / ``predict`` requests,
    ``swap`` checkpoints, ``start_endpoint`` for socket clients;
    ``load_generative`` tenants and ``generate`` against them.
    ``device=None`` means CUDA; pass ``device='cpu'`` to serve on the
    host.  ``max_batch`` / ``max_wait_us`` default to
    FLAGS_serve_max_batch / FLAGS_serve_max_wait_us."""

    def __init__(self, device=None, max_batch=None, max_wait_us=None):
        self.device = device
        self.max_batch = max_batch
        self.max_wait_us = max_wait_us
        self._tenants = {}
        self._lock = threading.Lock()
        self._endpoint = None
        self._closed = False

    def _check_loadable(self, name):
        if self._closed:
            raise RuntimeError("server closed")
        if name in self._tenants:
            raise ValueError("tenant %r already loaded (use swap)" % name)

    # -- predict tenants -----------------------------------------------
    def load(self, name, model_dir, warm=None):
        """Load ``model_dir`` as predict tenant ``name`` (its bucket
        ladder is built per ``warm`` / FLAGS_serve_warm_buckets before
        the first request is accepted)."""
        with self._lock:
            self._check_loadable(name)   # reject BEFORE the warm builds
        engine = ModelEngine(model_dir, device=self.device,
                             max_batch=self.max_batch, warm=warm, name=name)
        try:
            with self._lock:
                self._check_loadable(name)
                self._tenants[name] = _Tenant(name, engine,
                                              self.max_wait_us)
        except Exception:
            engine.drain()
            raise
        return engine

    def swap(self, name, model_dir, warm=None):
        """Hot-swap predict tenant ``name`` to the model in ``model_dir``
        (a fresh training checkpoint export).  The new engine is built
        and warmed in shadow; the route flip is one reference assignment
        — zero dropped, zero torn requests."""
        with self._lock:
            if self._closed:
                raise RuntimeError("server closed")
        tenant = self._tenant(name)
        if isinstance(tenant, _GenTenant):
            raise TypeError("tenant %r is generative — hot swap serves "
                            "the predict tier; reload the generative "
                            "tenant instead" % (name,))
        shadow = ModelEngine(model_dir, device=self.device,
                             max_batch=self.max_batch, warm=warm, name=name)
        old = tenant.engine
        tenant.engine = shadow    # the atomic flip
        old.drain()
        return shadow

    def submit(self, name, feed):
        """Enqueue one request; returns a Future resolving to
        {fetch_name: ndarray} with the request's own batch dim."""
        tenant = self._tenant(name)
        if isinstance(tenant, _GenTenant):
            raise TypeError("tenant %r is generative — use generate(), "
                            "not submit/predict" % (name,))
        feed = {k: np.asarray(v) for k, v in feed.items()}
        rows = tenant.engine.validate(feed)
        fut = Future()
        tenant.queue.put(Request(feed, rows, fut))
        return fut

    def predict(self, name, feed, timeout=None):
        return self.submit(name, feed).result(timeout)

    def start_endpoint(self, port=0, host="127.0.0.1"):
        """Serve the fastwire-framed Predict method; returns the bound
        port (``port=0`` picks a free one)."""
        from .wire import PredictEndpoint

        if self._endpoint is not None:
            raise RuntimeError("endpoint already running on port %d"
                               % self._endpoint.port)
        self._endpoint = PredictEndpoint(self, host=host, port=port)
        return self._endpoint.port

    # -- generative tenants --------------------------------------------

    def load_generative(self, name, config, params, quant="",
                        kv_blocks=None, warm=True, prefix_cache=None,
                        spec_k=None, draft=None):
        """Load a generative (greedy decode) tenant built from
        ``(config, params)`` — e.g. ``tiny_lm`` output — with int8
        weight quantization gated per tenant via ``quant='int8'``.
        ``warm`` builds the warm buckets now (on a card: the kernels,
        then one CUDA graph a bucket), so no request pays for them.
        ``prefix_cache=True`` turns on copy-on-write prefix KV reuse
        for this tenant; ``spec_k > 0`` turns on speculative decoding,
        which needs ``draft=(config, params)``: a small LM with the
        same vocab and paging geometry (both default to
        FLAGS_serve_prefix_cache / FLAGS_serve_spec_k)."""
        with self._lock:
            self._check_loadable(name)
        engine = GenerativeEngine(config, params, quant=quant,
                                  kv_blocks=kv_blocks, name=name,
                                  device=self.device, warm=warm,
                                  prefix_cache=prefix_cache,
                                  spec_k=spec_k, draft=draft)
        try:
            with self._lock:
                self._check_loadable(name)
                self._tenants[name] = _GenTenant(name, engine)
        except Exception:
            engine.close()
            raise
        return engine

    def unload(self, name):
        with self._lock:
            tenant = self._tenants.pop(name, None)
        if tenant is not None:
            _stop(tenant)

    def _tenant(self, name):
        with self._lock:
            tenant = self._tenants.get(name)
        if tenant is None:
            raise KeyError("unknown model %r (loaded: %r)"
                           % (name, sorted(self._tenants)))
        return tenant

    def models(self):
        with self._lock:
            return sorted(self._tenants)

    def engine(self, name):
        return self._tenant(name).engine

    def generate(self, name, prompt, max_new_tokens, eos_id=None):
        """Enqueue one greedy generate request; returns a Future
        resolving to ``{"tokens": [...], "ttft_ms": float, "itl_ms":
        [...], "preempted": int}``.  Requests that could never be
        admitted are rejected here, not in the decode loop."""
        tenant = self._tenant(name)
        if not isinstance(tenant, _GenTenant):
            raise TypeError("tenant %r is a predict model — generate() "
                            "needs a load_generative tenant" % (name,))
        prompt = [int(t) for t in np.asarray(prompt).reshape(-1)]
        if not prompt:
            raise ValueError("empty prompt")
        cfg = tenant.engine.config
        if max(prompt) >= cfg.vocab or min(prompt) < 0:
            raise ValueError("prompt token out of range [0, %d)"
                             % cfg.vocab)
        if int(max_new_tokens) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(prompt) > cfg.max_seq:
            raise ValueError(
                "prompt length %d exceeds max_seq %d (block_size x "
                "max_blocks)" % (len(prompt), cfg.max_seq))
        pool = tenant.engine.pool
        if pool.blocks_for(len(prompt)) > pool.capacity:
            raise ValueError(
                "prompt needs %d KV blocks but the tenant's pool holds "
                "%d — raise FLAGS_serve_kv_blocks"
                % (pool.blocks_for(len(prompt)), pool.capacity))
        fut = Future()
        tenant.queue.put(GenRequest(prompt, max_new_tokens, eos_id, fut))
        return fut

    def close(self):
        with self._lock:
            self._closed = True
            tenants = list(self._tenants.values())
            self._tenants.clear()
        if self._endpoint is not None:
            self._endpoint.stop()
            self._endpoint = None
        for t in tenants:
            _stop(t)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def _stop(tenant):
    """Stop a tenant's thread, then let its engine go."""
    tenant.dispatcher.stop()
    if isinstance(tenant, _GenTenant):
        tenant.engine.close()
    else:
        tenant.engine.drain()
