"""Inference server: the generative tenants of
``paddle_tpu/serving/server.py``.

One InferenceServer hosts any number of generative tenants in one
process; each owns a GenerativeEngine, a request queue and a
DecodeLoop thread.  ``generate`` returns a Future of
``{"tokens", "ttft_ms", "itl_ms", "preempted"}``.  On a card a tenant's
warm buckets are captured as CUDA graphs when it loads
(``load_generative(warm=True)``, the default); ``unload`` and ``close``
stop its loop, then close the engine, which joins its background
captures and drops the graphs before the pages.  A tenant may keep a
prefix cache and speculate with a draft LM (``load_generative``'s
``prefix_cache``, ``spec_k`` and ``draft``).  The predict tier
(``load``/``submit``/``swap``, the socket endpoint) is not part of this
slice.
"""
from __future__ import annotations

import threading
from concurrent.futures import Future

import numpy as np

from .batcher import RequestQueue
from .generative import DecodeLoop, GenerativeEngine, GenRequest

__all__ = ["InferenceServer"]


class _GenTenant:
    __slots__ = ("name", "engine", "queue", "dispatcher")

    def __init__(self, name, engine):
        self.name = name
        self.engine = engine
        self.queue = RequestQueue()
        self.dispatcher = DecodeLoop(engine, self.queue, label=name)


class InferenceServer:
    """``load_generative`` tenants and ``generate`` against them.
    ``device=None`` means CUDA; pass ``device='cpu'`` to serve on the
    host."""

    def __init__(self, device=None):
        self.device = device
        self._tenants = {}
        self._lock = threading.Lock()
        self._closed = False

    def _check_loadable(self, name):
        if self._closed:
            raise RuntimeError("server closed")
        if name in self._tenants:
            raise ValueError("tenant %r already loaded" % name)

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
            tenant.dispatcher.stop()
            tenant.engine.close()

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
        for t in tenants:
            t.dispatcher.stop()
            t.engine.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
