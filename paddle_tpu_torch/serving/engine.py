"""Per-model serving engine and the bucket-keyed step cache.

Counterpart of ``paddle_tpu/serving/engine.py``.

``ModelEngine`` (the predict tier) owns one loaded inference model — its
parameter Scope, its program, and a ladder of bucket executables
(``inference/aot.py`` ``AotExecutable``), one per padded batch size.
Buckets are powers of two capped by ``FLAGS_serve_max_batch``; the
continuous batcher (``batcher.py``) picks the smallest warm bucket that
fits the rows it assembled and pads the feed up to it.  On a card each
bucket is one CUDA graph: a bucket built here is the executor's
prepared step (``build_aot``), captured at build, and the model dir's
exported program (``save_inference_model(aot_feed_specs=...)``) is
adopted as a free warm bucket when its spec sits on the ladder
(``load_aot``: no op lowered, captured at load).  The warm set —
``FLAGS_serve_warm_buckets`` or the whole ladder — is built at model
load, so steady-state traffic never waits for a build.  A cold bucket
hit at runtime is served by the nearest warm bucket while ONE background
thread builds the missed one (on a card capturing in ``thread_local``
mode on its own stream, since the dispatcher replays meanwhile); the
moment it lands, traffic moves over.  Engines are immutable once built
— hot swap (``server.py``) builds a whole new engine in shadow and flips
the tenant's route pointer.

``StepCache`` is the generative tier's analog of that ladder: its
entries are the engine's bucket steps, on a card one CUDA graph each,
captured once (``serving/generative.py``), on the CPU the same step run
eagerly.

The JAX package's metrics counters are plain integer attributes here
(``compiles``, ``misses``, ``compile_failures``).
"""
from __future__ import annotations

import threading
import warnings

import numpy as np

from ..core.flags import FLAGS

__all__ = ["bucket_ladder", "pow2_bucket", "StepCache", "ModelEngine"]


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


class ModelEngine:
    """One loaded model: scope + program + bucket executables.

    ``device=None`` means the card (RuntimeError without one); pass
    ``device='cpu'`` to serve on the host."""

    def __init__(self, model_dir, device=None, max_batch=None, warm=None,
                 name=""):
        import paddle_tpu_torch.fluid as fluid
        from paddle_tpu_torch.device import resolve_device

        from ..inference.aot import load_aot

        self.name = name or model_dir
        self.model_dir = model_dir
        self.device = resolve_device(device)
        self.place = (fluid.CUDAPlace(self.device.index or 0)
                      if self.device.type == "cuda" else fluid.CPUPlace())
        self.scope = fluid.Scope()
        self.max_batch = int(max_batch or FLAGS.serve_max_batch)
        if self.max_batch < 1:
            raise ValueError("serve_max_batch must be >= 1")
        exe = fluid.Executor(self.place)
        with fluid.scope_guard(self.scope):
            prog, feeds, fetches = fluid.io.load_inference_model(
                model_dir, exe)
        self.program = prog
        self.feed_names = list(feeds)
        self.fetch_names = [v.name for v in fetches]
        # per-sample specs from the program's feed var descs: data vars
        # declare (-1, *sample_shape) — the batch dim is ours to pick
        self.sample_specs = {}
        blk = prog.global_block()
        for n in self.feed_names:
            var = blk.vars[n]
            shape = tuple(var.shape)
            if not shape or shape[0] != -1:
                raise ValueError(
                    "feed %r declares shape %r — serving needs a "
                    "leading batch dimension (-1)" % (n, shape))
            if any(d < 0 for d in shape[1:]):
                raise ValueError(
                    "feed %r has a dynamic non-batch dim %r — bucket "
                    "padding only covers the batch dimension" %
                    (n, shape))
            self.sample_specs[n] = (tuple(int(d) for d in shape[1:]),
                                    np.dtype(var.dtype))
        # the fetch side of the bucket-padding contract: each request's
        # rows are sliced back out of the coalesced fetches, so every
        # fetch must carry the batch dim as its leading axis — reject at
        # load, not silently mis-slice later
        for n in self.fetch_names:
            var = blk.vars.get(n)
            if var is None:
                continue        # unmaterialized intermediate: no desc
            shape = tuple(var.shape)
            if not shape or shape[0] != -1:
                raise ValueError(
                    "fetch %r declares shape %r — serving needs the "
                    "batch dim leading (-1) on every fetch so "
                    "coalesced batches slice back per request; "
                    "cross-row outputs can't ride the batcher"
                    % (n, shape))
        self.ladder = bucket_ladder(self.max_batch)
        self._exes = {}          # bucket -> AotExecutable
        self._lock = threading.Lock()
        self._compiling = set()
        self._compile_errors = {}   # bucket -> repr(exc) of last failure
        self._threads = []
        self.compiles = 0
        self.misses = 0
        self.compile_failures = 0
        # the exported artifact (save_inference_model aot_feed_specs)
        # is a free warm bucket when its spec sits on our ladder
        self.artifact_bucket = None
        disk = load_aot(model_dir, self.scope, self.place)
        if disk is not None:
            b = self._artifact_bucket(disk)
            if b is not None:
                self._exes[b] = disk
                self.artifact_bucket = b
        for b in self._warm_set(warm):
            if b not in self._exes:
                self._exes[b] = self._compile_bucket(b)

    # -- build ---------------------------------------------------------
    def _warm_set(self, warm):
        if warm is None:
            raw = str(FLAGS.serve_warm_buckets).strip()
            warm = [int(t) for t in raw.split(",") if t.strip()] \
                if raw else list(self.ladder)
        warm = sorted({int(b) for b in warm})
        bad = [b for b in warm if b not in self.ladder]
        if bad:
            raise ValueError("warm buckets %r not on the ladder %r"
                             % (bad, self.ladder))
        if not warm:
            warm = [self.ladder[0]]
        return warm

    def _artifact_bucket(self, exe):
        """The on-disk executable's batch size, when its specs are
        exactly this model's sample specs at one ladder bucket."""
        if set(exe.specs) != set(self.sample_specs):
            return None
        b = None
        for n, (shape, dtype) in exe.specs.items():
            sshape, sdtype = self.sample_specs[n]
            if not shape or shape[1:] != sshape or dtype != sdtype:
                return None
            if b is None:
                b = shape[0]
            elif shape[0] != b:
                return None
        return b if b in self.ladder else None

    def bucket_specs(self, b):
        return {n: ((b,) + shape, dtype)
                for n, (shape, dtype) in self.sample_specs.items()}

    def _compile_bucket(self, b):
        from ..inference.aot import build_aot

        exe = build_aot(self.program, self.bucket_specs(b),
                        self.fetch_names, self.scope, self.place)
        with self._lock:
            self.compiles += 1
        return exe

    # -- runtime -------------------------------------------------------
    @property
    def warm_buckets(self):
        with self._lock:
            return sorted(self._exes)

    def executable(self, b):
        with self._lock:
            return self._exes.get(b)

    def pick_bucket(self, rows):
        """(bucket, missed): the smallest warm bucket >= rows, or —
        when every warm bucket is smaller — the largest warm one (the
        batcher then dispatches a prefix of its batch and requeues the
        rest).  ``missed`` is the cold ladder bucket to build in the
        background, or None when the ideal bucket was already warm."""
        # rows wider than the ladder (a request validated against a
        # pre-swap engine with a larger max_batch) degrade to the top
        # bucket, not kill the dispatcher with StopIteration
        ideal = next((b for b in self.ladder if b >= rows),
                     self.ladder[-1])
        with self._lock:
            warm = sorted(self._exes)
            if ideal in self._exes:
                return ideal, None
            up = [b for b in warm if b >= rows]
            pick = up[0] if up else warm[-1]
            self.misses += 1
        return pick, ideal

    def ensure_bucket_async(self, b):
        """Kick off ONE background build of bucket ``b`` (idempotent
        while one is in flight); traffic keeps falling to warm buckets
        until it lands."""
        with self._lock:
            if b in self._exes or b in self._compiling:
                return
            self._compiling.add(b)

        def _bg():
            try:
                exe = self._compile_bucket(b)
                with self._lock:
                    self._exes[b] = exe
                    self._compile_errors.pop(b, None)
            except Exception as e:
                # counted, never silent: traffic keeps paying the miss
                # and the batcher's wait fails fast on the reason
                with self._lock:
                    self.compile_failures += 1
                    self._compile_errors[b] = "%s: %s" % (
                        type(e).__name__, e)
                warnings.warn(
                    "serving bucket %d build failed for model %r "
                    "(%s: %s); traffic stays on warm buckets %r"
                    % (b, self.name, type(e).__name__, e,
                       self.warm_buckets))
            finally:
                with self._lock:
                    self._compiling.discard(b)

        t = threading.Thread(target=_bg, daemon=True,
                             name="serve-compile-%s-b%d" % (self.name, b))
        with self._lock:
            self._threads = [x for x in self._threads if x.is_alive()]
            self._threads.append(t)
        t.start()

    def drain(self, timeout=120):
        """Join any in-flight background builds (a capture in flight
        must not outlive its engine's tenant)."""
        with self._lock:
            threads = [t for t in self._threads if t.is_alive()]
            self._threads = []
        for t in threads:
            t.join(timeout)

    def compile_error(self, b):
        """repr of bucket ``b``'s last failed background build, or None
        (cleared on a later success)."""
        with self._lock:
            return self._compile_errors.get(b)

    def validate(self, feed):
        """Shape/dtype-check one request's feed; returns its row count.
        All feeds must agree on the batch dim, every non-batch dim must
        match the model's sample spec exactly (the bucket-padding
        contract)."""
        missing = [n for n in self.feed_names if n not in feed]
        if missing:
            raise ValueError("missing feeds %r (model expects %r)"
                             % (missing, self.feed_names))
        rows = None
        for n in self.feed_names:
            v = np.asarray(feed[n])
            sshape, sdtype = self.sample_specs[n]
            if v.ndim != len(sshape) + 1 or tuple(v.shape[1:]) != sshape:
                raise ValueError(
                    "feed %r shape %r does not match per-sample spec "
                    "%r (+ leading batch dim)" % (n, v.shape, sshape))
            if v.dtype != sdtype:
                raise ValueError("feed %r dtype %s != %s"
                                 % (n, v.dtype, sdtype))
            if rows is None:
                rows = int(v.shape[0])
            elif int(v.shape[0]) != rows:
                raise ValueError(
                    "feeds disagree on the batch dim (%d vs %d)"
                    % (rows, int(v.shape[0])))
        if rows < 1:
            raise ValueError("empty request (batch dim 0)")
        if rows > self.max_batch:
            raise ValueError(
                "request batch %d exceeds serve_max_batch %d — split "
                "it client-side" % (rows, self.max_batch))
        return rows
