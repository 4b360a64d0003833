"""Request queue, the continuous batcher of the predict tier, and the
token-granular scheduling of generative decode.

Counterpart of ``paddle_tpu/serving/batcher.py``.

The predict tier (``Request``, ``Dispatcher``): Orca-style continuous
batching under a Clipper-style latency deadline (Yu et al. OSDI '22;
Crankshaw et al. NSDI '17).  Requests land in a queue with their arrival
stamp; one dispatcher thread per tenant assembles batches and launches
them on the tenant's bucket executables.  The invariants:

- the device never idles while requests wait: the dispatcher drains
  whatever queued up while the previous dispatch ran and launches
  immediately (those requests' deadlines — anchored at ARRIVAL —
  already expired);
- a batch is never held for fullness: with the device free, assembly
  waits at most ``FLAGS_serve_max_wait_us`` past the first request's
  arrival, then launches the partial batch;
- a batch never mixes engines: the dispatcher snapshots the tenant's
  engine route once per batch, which is what makes hot swap
  (``server.swap``) atomic — queued requests dispatch on whichever
  engine is routed when their batch launches, none dropped, none torn.

Assembly concatenates the batch's rows and pads them up to the chosen
bucket with zero rows on the host; the bucket's executable copies the
batch into its static inputs (on a card, the CUDA graph's) and runs.
The padded rows are computed and discarded; each request's rows are
sliced back out of the fetches.  The JAX package's metrics (its
``set_metrics_enabled`` / ``metrics_probe`` telemetry gate) are plain
integer counters on the dispatcher here (``batches``, ``rows``,
``padding_rows``, ``failed_batches``), as in the generative tier.

Generative decode (``TokenScheduler``): every decode iteration
re-decides the batch, admitting queued prefills the moment the block
pool can hold them (Orca iteration-level scheduling), and a request
migrated in with its pages resident (``serving/fleet.py``) the moment
the batch has room.
"""
from __future__ import annotations

import threading
import time
from collections import deque

import numpy as np

__all__ = ["Request", "RequestQueue", "Dispatcher", "TokenScheduler"]


class Request:
    __slots__ = ("feed", "rows", "future", "t_arrival")

    def __init__(self, feed, rows, future):
        self.feed = feed
        self.rows = rows
        self.future = future
        self.t_arrival = time.perf_counter()


class RequestQueue:
    """Deque + condition: FIFO puts, timed gets, and put_front so a
    request that could not be admitted keeps its place."""

    def __init__(self):
        self._q = deque()
        self._cv = threading.Condition()
        self._closed = False

    def put(self, item):
        with self._cv:
            if self._closed:
                raise RuntimeError("queue closed")
            self._q.append(item)
            self._cv.notify()

    def put_front(self, items):
        with self._cv:
            for item in reversed(items):
                self._q.appendleft(item)
            self._cv.notify()

    def get(self, timeout=None):
        """Next request, or None on timeout / close-with-empty-queue."""
        with self._cv:
            if not self._q:
                self._cv.wait_for(lambda: self._q or self._closed,
                                  timeout)
            if self._q:
                return self._q.popleft()
            return None

    def close(self):
        with self._cv:
            self._closed = True
            self._cv.notify_all()

    @property
    def closed(self):
        with self._cv:
            return self._closed and not self._q

    def __len__(self):
        with self._cv:
            return len(self._q)


class Dispatcher:
    """One per predict tenant.  ``engine_ref()`` returns the CURRENT
    engine (the tenant's atomically-swappable route); ``max_wait_us`` is
    read per batch (None: ``FLAGS_serve_max_wait_us``), so a runtime flag
    flip takes effect immediately."""

    def __init__(self, queue, engine_ref, max_wait_us=None, label=""):
        self.queue = queue
        self.engine_ref = engine_ref
        self.max_wait_us = max_wait_us
        self.label = label
        self.batches = 0          # batches launched
        self.rows = 0             # real rows in them
        self.padding_rows = 0     # padding rows computed and discarded
        self.failed_batches = 0   # batches whose futures got an exception
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._loop, daemon=True,
            name="serve-dispatch-%s" % (label or id(self)))
        self._thread.start()

    def stop(self, join=True):
        self._stop.set()
        self.queue.close()
        if join:
            self._thread.join(timeout=30)

    def _wait_us(self):
        if self.max_wait_us is not None:
            return float(self.max_wait_us)
        from paddle_tpu_torch.core.flags import FLAGS
        return float(FLAGS.serve_max_wait_us)

    # -- the continuous-batching loop ---------------------------------
    def _loop(self):
        while True:
            req = self.queue.get(timeout=0.25)
            if req is None:
                if self._stop.is_set() and self.queue.closed:
                    return
                continue
            engine = self.engine_ref()
            batch, rows = [req], req.rows
            deadline = req.t_arrival + self._wait_us() / 1e6
            while rows < engine.max_batch:
                remaining = deadline - time.perf_counter()
                nxt = self.queue.get(timeout=max(0.0, remaining)) \
                    if remaining > 0 else self.queue.get(timeout=0)
                if nxt is None:
                    break
                if rows + nxt.rows > engine.max_batch:
                    self.queue.put_front([nxt])
                    break
                batch.append(nxt)
                rows += nxt.rows
            # the dispatcher thread must survive ANYTHING — a dead
            # dispatcher wedges the tenant forever with unresolved
            # futures and no error anywhere
            try:
                self._launch(engine, batch, rows)
            except Exception as e:
                self._fail(batch, e)

    def _fail(self, batch, err):
        self.failed_batches += 1
        for r in batch:
            if not r.future.done():
                r.future.set_exception(err)

    def _launch(self, engine, batch, rows):
        if len(batch) == 1 and batch[0].rows > engine.max_batch:
            # validated against a pre-swap engine whose ladder was
            # taller: no bucket of THIS engine will ever fit it
            self._fail(batch, ValueError(
                "request batch %d exceeds the routed engine's "
                "serve_max_batch %d (shrunk by a hot swap) — split it "
                "client-side" % (batch[0].rows, engine.max_batch)))
            return
        bucket, missed = engine.pick_bucket(rows)
        if missed is not None:
            engine.ensure_bucket_async(missed)
        if bucket < rows:
            # every warm bucket is smaller than the batch: dispatch the
            # prefix that fits, requeue the tail AT THE FRONT (it keeps
            # its arrival stamps — its deadline has long expired, so it
            # ships on the very next loop turn)
            head, acc = [], 0
            while batch and acc + batch[0].rows <= bucket:
                acc += batch[0].rows
                head.append(batch.pop(0))
            if not head:
                # single request wider than any warm bucket: wait for
                # the ideal bucket to land rather than failing it
                self._await_bucket(engine, batch)
                return
            self.queue.put_front(batch)
            batch, rows = head, acc
        try:
            feed = self._assemble(engine, batch, bucket, rows)
            outs = engine.executable(bucket).run(feed)
            self._complete(engine, batch, outs)
        except Exception as e:
            self._fail(batch, e)
            return
        self.batches += 1
        self.rows += rows
        self.padding_rows += bucket - rows

    def _await_bucket(self, engine, batch):
        """Block (bounded) until the background build for a bucket
        fitting ``batch`` lands, then launch.  Rare path: only reached
        when the warm buckets were restricted below a request's own
        width."""
        rows = sum(r.rows for r in batch)
        t0 = time.perf_counter()
        while time.perf_counter() - t0 < 120.0:
            bucket, missed = engine.pick_bucket(rows)
            if missed is not None:
                engine.ensure_bucket_async(missed)
            if bucket >= rows:
                self._launch(engine, batch, rows)
                return
            if missed is not None:
                fail = engine.compile_error(missed)
                if fail is not None:
                    self._fail(batch, RuntimeError(
                        "bucket %d build failed (%s) and no warm "
                        "bucket fits %d rows" % (missed, fail, rows)))
                    return
            time.sleep(0.005)
        self._fail(batch, TimeoutError("no bucket >= %d rows became warm"
                                       % rows))

    @staticmethod
    def _assemble(engine, batch, bucket, rows):
        """The batch's rows, concatenated and zero-padded to ``bucket``
        rows, one host array a feed."""
        feed = {}
        for n, (sshape, sdtype) in engine.sample_specs.items():
            parts = [np.asarray(r.feed[n]) for r in batch]
            if bucket > rows:
                parts.append(np.zeros((bucket - rows,) + sshape, sdtype))
            feed[n] = parts[0] if len(parts) == 1 \
                else np.concatenate(parts, axis=0)
        return feed

    def _complete(self, engine, batch, outs):
        off = 0
        for r in batch:
            res = {name: np.array(o[off:off + r.rows])
                   for name, o in zip(engine.fetch_names, outs)}
            off += r.rows
            r.future.set_result(res)


class TokenScheduler:
    """Admission + preemption policy over a kv_cache.BlockPool.

    Pure policy: sequences are duck-typed — the scheduler reads
    ``seq.prompt`` and owns ``seq.blocks``.  Admission is FIFO and stops
    at the first request the pool cannot hold whole (it stays at the
    queue front).  A running sequence that cannot grow preempts the
    YOUNGEST running sequence, never an older one; a lone sequence that
    cannot grow out of an empty pool is reported to the caller.

    With a prefix index attached (generative.PrefixCache), admission
    takes the PARTIALLY-CACHED branch: the index shares the prompt's
    already-resident prefix blocks by refcount and allocates only the
    rest, so a mostly-cached prompt admits under pressure that would
    requeue a cold one (``seq.cached_len`` carries the boundary to the
    engine's suffix prefill).  A request that arrives with ``blocks``
    (migrated in by the fleet, its pages resident) is admitted as it
    is, before either branch."""

    def __init__(self, pool, max_batch, prefix_cache=None):
        self.pool = pool
        self.max_batch = int(max_batch)
        self.prefix_cache = prefix_cache

    def try_admit(self, queue, n_running):
        """Pop and return the requests admissible RIGHT NOW (their
        prompt blocks are allocated on return, as ``req.blocks``)."""
        admitted = []
        while n_running + len(admitted) < self.max_batch:
            req = queue.get(timeout=0)
            if req is None:
                break
            if req.blocks:
                # migrated in (serving/fleet.py MigrateKV): the pages are
                # already in blocks the receive path allocated, so
                # admission is batch membership alone; another alloc
                # here would leak the originals
                admitted.append(req)
                continue
            if self.prefix_cache is not None:
                if not self.prefix_cache.acquire(req):
                    queue.put_front([req])  # keeps its arrival stamp
                    break
                admitted.append(req)
                continue
            blocks = self.pool.alloc(self.pool.blocks_for(
                len(req.prompt)))
            if blocks is None:
                queue.put_front([req])      # keeps its arrival stamp
                break
            req.blocks = blocks
            admitted.append(req)
        return admitted

    def grow(self, seq):
        """One more block for ``seq`` (decode crossed a block
        boundary); True on success."""
        got = self.pool.alloc(1)
        if got is None:
            return False
        seq.blocks.extend(got)
        return True

    def pick_victim(self, running, needing):
        """The youngest running sequence other than ``needing`` — or
        ``needing`` itself when it IS the youngest.  None when there is
        nothing to evict."""
        candidates = [s for s in running if s is not needing]
        if not candidates:
            return None
        victim = candidates[-1]
        if running.index(victim) < running.index(needing):
            return needing
        return victim
