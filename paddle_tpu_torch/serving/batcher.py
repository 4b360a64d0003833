"""Request queue and token-granular scheduling for generative decode.

Counterpart of the ``RequestQueue`` and ``TokenScheduler`` of
``paddle_tpu/serving/batcher.py``: every decode iteration re-decides
the batch, admitting queued prefills the moment the block pool can hold
them (Orca iteration-level scheduling), and a request migrated in with
its pages resident (``serving/fleet.py``) the moment the batch has
room.  The predict-tier dispatcher is not part of the port.
"""
from __future__ import annotations

import threading
from collections import deque

__all__ = ["RequestQueue", "TokenScheduler"]


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
