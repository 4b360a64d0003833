"""Paged KV cache accounting: the refcounted block pool behind
generative decode.

Counterpart of ``paddle_tpu/serving/kv_cache.py``.  The engine owns the
``[L, N, bs, H, D]`` page tensors on the device; this is the host-side
ledger over them: per-block REFCOUNTS, a free list and an LRU of
refcount-zero cached blocks.

Ownership protocol: ``alloc`` hands out blocks at refcount 1; ``share``
takes one more reference (reviving a parked refcount-zero block from
the cached LRU); ``free`` DROPS one reference — the block returns to
circulation only at refcount zero, parking in the cached LRU when the
prefix index marked it cacheable, else going straight to the free
list.  ``cow`` is the mid-block-write escape: a private replacement
block is allocated, the device pages copied, and only then the shared
reference dropped.

Block 0 is RESERVED as the padding scratch block: bucket-padding rows
of a decode batch point every block-table slot at it and write their
(discarded) K/V there, so a padded step never touches a live
sequence's blocks.

The reference's process gauges and counters are plain integer
attributes of the pool here: ``alloc_failures``, ``preemptions``,
``cow_copies``, ``prefix_hits``, ``prefix_tokens``,
``prefix_tokens_cached`` and the ``shared_blocks`` property.  A decref
without a reference (a double free) trips the buffer sanitizer under
``FLAGS_sanitizer=buffers`` and is ignored otherwise, as in the
reference.
"""
from __future__ import annotations

import threading
from collections import OrderedDict

from ..core import sanitizer as _san

__all__ = ["BlockPool"]


class BlockPool:
    """Refcounted free-list allocator over ``num_blocks`` fixed-size KV
    blocks.  Thread-safe."""

    def __init__(self, num_blocks, block_size):
        if num_blocks < 2:
            raise ValueError("kv pool needs >= 2 blocks (one is the "
                             "reserved padding block)")
        self.num_blocks = int(num_blocks)
        self.block_size = int(block_size)
        self._free = list(range(self.num_blocks - 1, 0, -1))
        self._ref = {}                 # block id -> refcount (> 0)
        self._cached = OrderedDict()   # refcount-zero LRU (oldest first)
        self._cacheable = set()        # park in _cached at refcount 0
        self._evict_cb = None          # prefix index invalidation hook
        self._lock = threading.Lock()
        self.alloc_failures = 0
        self.preemptions = 0
        self.cow_copies = 0
        self.prefix_hits = 0           # lookups that shared >= 1 block
        self.prefix_tokens = 0         # prompt tokens looked up
        self.prefix_tokens_cached = 0  # of those, served from the cache

    @property
    def capacity(self):
        return self.num_blocks - 1

    @property
    def free_blocks(self):
        """Blocks allocatable right now: the free list PLUS the
        refcount-zero cached LRU (reclaimed under pressure)."""
        with self._lock:
            return len(self._free) + len(self._cached)

    @property
    def used_blocks(self):
        """Blocks referenced by at least one live owner: a block shared
        N ways counts once, a parked (cached) block not at all."""
        with self._lock:
            return len(self._ref)

    @property
    def shared_blocks(self):
        """Blocks referenced by more than one owner."""
        with self._lock:
            return sum(1 for r in self._ref.values() if r >= 2)

    @property
    def cached_blocks(self):
        with self._lock:
            return len(self._cached)

    def ref(self, block):
        """Current refcount of ``block`` (0 when parked or free)."""
        with self._lock:
            return self._ref.get(int(block), 0)

    def blocks_for(self, tokens):
        """Blocks needed to hold ``tokens`` positions."""
        return max(1, -(-int(tokens) // self.block_size))

    def set_evict_callback(self, cb):
        """``cb(block_id) -> iterable of descendant block ids`` called
        when a parked cached block is reclaimed by allocation pressure:
        the prefix index drops the block's node and returns the cached
        blocks that became unreachable with it (they go to the free
        list too).  Called UNDER the pool lock: the callback must not
        call back into the pool."""
        with self._lock:
            self._evict_cb = cb

    def set_cacheable(self, blocks, on=True):
        """Mark ``blocks`` to park in the cached LRU (instead of the
        free list) when their refcount reaches zero — the prefix
        index's retention bit."""
        blocks = [int(b) for b in blocks]
        with self._lock:
            if on:
                self._cacheable.update(blocks)
                return
            for b in blocks:
                self._cacheable.discard(b)
                # an un-indexed parked block is plain free space
                if b in self._cached:
                    del self._cached[b]
                    self._free.append(b)

    def _evict_locked(self, n):
        """Reclaim up to ``n`` parked blocks, LRU first, into _free.
        Returns the number reclaimed."""
        got = 0
        while got < n and self._cached:
            b, _ = self._cached.popitem(last=False)
            self._cacheable.discard(b)
            self._free.append(b)
            got += 1
            if self._evict_cb is not None:
                for d in (self._evict_cb(b) or ()):
                    d = int(d)
                    if d in self._cached:
                        del self._cached[d]
                        self._cacheable.discard(d)
                        self._free.append(d)
                        got += 1
        return got

    def alloc(self, n):
        """``n`` block ids at refcount 1, or None (counted) when the
        pool cannot satisfy the request even after reclaiming parked
        cached blocks — the caller decides between waiting, requeueing
        and preempting (batcher.TokenScheduler)."""
        n = int(n)
        with self._lock:
            if n > len(self._free) + len(self._cached):
                self.alloc_failures += 1
                return None
            if n > len(self._free):
                self._evict_locked(n - len(self._free))
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
        return out

    def share(self, blocks):
        """Take one more reference on each of ``blocks`` (the prefix
        hit path); a parked refcount-zero block is revived to refcount
        1.  True on success; False — with every reference this call
        took rolled back — when a block is neither live nor parked (it
        was reclaimed between the index lookup and the share: the
        caller treats the lookup as a miss)."""
        blocks = [int(b) for b in blocks]
        if any(b == 0 for b in blocks):
            raise ValueError("block 0 is the reserved padding block; "
                             "it is never shared")
        taken = []
        with self._lock:
            for b in blocks:
                if b in self._ref:
                    self._ref[b] += 1
                elif b in self._cached:
                    del self._cached[b]
                    self._ref[b] = 1
                else:
                    break
                taken.append(b)
            else:
                return True
            for b in taken:
                self._ref[b] -= 1
                if self._ref[b] == 0:
                    del self._ref[b]
                    self._cached[b] = None
        return False

    def cow(self, block, copy=None):
        """Copy-on-write for a shared ``block`` about to be written
        mid-block: allocate a private replacement (counted in
        ``cow_copies``), run ``copy(src, dst)`` — the device-page copy,
        GenerativeEngine.copy_block — and only THEN drop the caller's
        reference on the original, so the source pages cannot be
        reclaimed under the copy.  Returns the replacement id, or None
        when the pool cannot supply one (the caller's reference on the
        original is NOT dropped)."""
        got = self.alloc(1)
        if got is None:
            return None
        if copy is not None:
            try:
                copy(int(block), got[0])
            except Exception:
                self.free(got)
                raise
        with self._lock:
            self.cow_copies += 1
        self.free([block])
        return got[0]

    def free(self, blocks):
        """Drop one reference per listed block.  A block returns to
        circulation only at refcount zero — to the cached LRU when the
        prefix index marked it cacheable, else to the free list.
        Dropping a reference that does not exist (the refcount form of a
        double free) trips the sanitizer under FLAGS_sanitizer=buffers
        and is ignored otherwise."""
        blocks = [int(b) for b in blocks]
        if not blocks:
            return
        # validate BEFORE mutating: a trip half-way through the decrefs
        # would leave the ledger half-updated
        if any(b == 0 for b in blocks):
            raise ValueError("block 0 is the reserved padding block; "
                             "it is never allocated")
        with self._lock:
            if _san.buffers_on():
                # two owners each think they returned the pages: the
                # next alloc would hand one sequence's live pages to
                # another.  Checked and applied under one lock hold, so
                # two racing frees of the last reference cannot both pass
                avail = dict(self._ref)
                for b in blocks:
                    if avail.get(b, 0) <= 0:
                        _san.trip("kv_block:%d" % b, op="free",
                                  site="BlockPool(block_size=%d): "
                                       "decref without a reference"
                                       % self.block_size)
                    avail[b] = avail.get(b, 0) - 1
            for b in blocks:
                r = self._ref.get(b, 0)
                if r <= 0:
                    continue          # unmatched decref (tripped above)
                if r > 1:
                    self._ref[b] = r - 1      # decref-to-nonzero: no free
                    continue
                del self._ref[b]
                if b in self._cacheable:
                    self._cached[b] = None    # park, most-recent end
                else:
                    self._free.append(b)

    def note_prefix_lookup(self, tokens, tokens_cached):
        """Prefix-index accounting: one lookup over ``tokens`` prompt
        tokens of which ``tokens_cached`` came from shared blocks."""
        with self._lock:
            self.prefix_tokens += int(tokens)
            if tokens_cached > 0:
                self.prefix_tokens_cached += int(tokens_cached)
                self.prefix_hits += 1

    def note_preemption(self):
        with self._lock:
            self.preemptions += 1

    def close(self):
        with self._lock:
            self._free = []
            self._ref = {}
            self._cached = OrderedDict()
            self._cacheable = set()
            self.num_blocks = 1

    def __repr__(self):
        return "BlockPool(%d/%d free, %d cached, block_size=%d)" % (
            self.free_blocks, self.capacity, self.cached_blocks,
            self.block_size)
