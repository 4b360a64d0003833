"""Power-of-2 shape buckets and the bucket-keyed step cache — the part of
``paddle_tpu/serving/engine.py`` the generative tier uses.

The JAX package AOT-compiles one executable per bucket and keeps them
in ``StepCache``; the port keeps the same cache, whose entries are the
engine's bucket steps: on a card one CUDA graph each, captured once
(``serving/generative.py``), on the CPU the same step run eagerly.
The reference's metrics counters are plain integer attributes here
(``compiles``, ``misses``, ``compile_failures``).
"""
from __future__ import annotations

import threading
import warnings

__all__ = ["bucket_ladder", "pow2_bucket", "StepCache"]


def bucket_ladder(max_batch):
    """Power-of-2 ladder up to and including max_batch: 1,2,4,...; a
    non-power-of-2 cap contributes itself as the top bucket."""
    out, b = [], 1
    while b < max_batch:
        out.append(b)
        b *= 2
    out.append(int(max_batch))
    return out


def pow2_bucket(n, cap):
    """Smallest power of two >= n, clamped to cap (which joins the
    ladder even when it is not itself a power of two)."""
    b = 1
    while b < n and b < cap:
        b *= 2
    return min(b, int(cap))


class StepCache:
    """Bucket-keyed step cache.

    Keys are tuples of bucket dims (``(batch, block_count)`` for a
    decode step, ``(seq_len,)`` for a prefill).  ``build_fn(key)``
    builds the step for that key.  ``pick(key)`` returns an exact hit,
    or the smallest warm key COVERING the request (every dim >=; the
    caller pads up to whatever key comes back) while ONE background
    thread builds the miss.  With nothing covering, the caller builds
    it synchronously (a cold engine must still answer).  A background
    build that raises warns and leaves traffic on the covering key."""

    def __init__(self, build_fn, name=""):
        self.name = name
        self._build_fn = build_fn
        self._steps = {}
        self._lock = threading.Lock()
        self._building = set()
        self._threads = []
        self.compiles = 0
        self.misses = 0
        self.compile_failures = 0

    def drain(self, timeout=120):
        """Join any in-flight background builds: a tenant must not free
        what a capture in flight is using."""
        with self._lock:
            threads = [t for t in self._threads if t.is_alive()]
            self._threads = []
        for t in threads:
            t.join(timeout)

    def clear(self):
        """Drop every step (the engine's ``close``, after ``drain``)."""
        with self._lock:
            self._steps = {}

    def _add(self, key, step):
        with self._lock:
            self._steps[key] = step
            self.compiles += 1

    def warm(self, keys):
        for key in keys:
            key = tuple(key)
            if self.get(key) is None:
                self._add(key, self._build_fn(key))

    def get(self, key):
        with self._lock:
            return self._steps.get(tuple(key))

    @property
    def warm_keys(self):
        with self._lock:
            return sorted(self._steps)

    def pick(self, key):
        """(key, step) serving the request NOW.  On a miss the smallest
        covering warm key answers and the ideal key builds in the
        background; with no covering key the build happens inline."""
        key = tuple(key)
        with self._lock:
            step = self._steps.get(key)
            if step is not None:
                return key, step
            covering = sorted(
                k for k in self._steps
                if len(k) == len(key)
                and all(a >= b for a, b in zip(k, key)))
            self.misses += 1
            if covering:
                cover = covering[0], self._steps[covering[0]]
        if covering:
            self.ensure_async(key)
            return cover
        step = self._build_fn(key)
        self._add(key, step)
        return key, step

    def ensure_async(self, key):
        key = tuple(key)
        with self._lock:
            if key in self._steps or key in self._building:
                return
            self._building.add(key)

        def _bg():
            try:
                self._add(key, self._build_fn(key))
            except Exception as e:
                with self._lock:
                    self.compile_failures += 1
                warnings.warn(
                    "step bucket %r build failed for %r (%s: %s); "
                    "traffic stays on covering buckets"
                    % (key, self.name, type(e).__name__, e))
            finally:
                with self._lock:
                    self._building.discard(key)

        t = threading.Thread(target=_bg, daemon=True,
                             name="serve-stepbuild-%s" % (self.name,))
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()
