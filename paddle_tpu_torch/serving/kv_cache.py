"""Paged KV cache accounting: the refcounted block pool behind
generative decode.

Counterpart of ``paddle_tpu/serving/kv_cache.py``.  The engine owns the
``[L, N, bs, H, D]`` page tensors on the device; this is the host-side
ledger over them: per-block refcounts and a free list.  ``alloc`` hands
out blocks at refcount 1 and ``free`` drops one reference, returning a
block to the free list at refcount zero.

Block 0 is RESERVED as the padding scratch block: bucket-padding rows
of a decode batch point every block-table slot at it and write their
(discarded) K/V there, so a padded step never touches a live
sequence's blocks.

Not in this slice: the process metric gauges and the prefix cache's
sharing, copy-on-write and cached-block LRU.  Allocation failures and
preemptions are plain counters on the pool.
"""
from __future__ import annotations

import threading

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
        self._lock = threading.Lock()
        self.alloc_failures = 0
        self.preemptions = 0

    @property
    def capacity(self):
        return self.num_blocks - 1

    @property
    def free_blocks(self):
        with self._lock:
            return len(self._free)

    @property
    def used_blocks(self):
        with self._lock:
            return len(self._ref)

    def blocks_for(self, tokens):
        """Blocks needed to hold ``tokens`` positions."""
        return max(1, -(-int(tokens) // self.block_size))

    def alloc(self, n):
        """``n`` block ids at refcount 1, or None (counted) when the
        pool cannot satisfy the request — the caller decides between
        waiting, requeueing and preempting (batcher.TokenScheduler)."""
        n = int(n)
        with self._lock:
            if n > len(self._free):
                self.alloc_failures += 1
                return None
            out = [self._free.pop() for _ in range(n)]
            for b in out:
                self._ref[b] = 1
        return out

    def free(self, blocks):
        """Drop one reference per listed block; a block returns to the
        free list at refcount zero.  An unmatched decref is ignored."""
        blocks = [int(b) for b in blocks]
        if any(b == 0 for b in blocks):
            raise ValueError("block 0 is the reserved padding block; "
                             "it is never allocated")
        with self._lock:
            for b in blocks:
                r = self._ref.get(b, 0)
                if r > 1:
                    self._ref[b] = r - 1
                elif r == 1:
                    del self._ref[b]
                    self._free.append(b)

    def note_preemption(self):
        with self._lock:
            self.preemptions += 1

    def close(self):
        with self._lock:
            self._free = []
            self._ref = {}
            self.num_blocks = 1

    def __repr__(self):
        return "BlockPool(%d/%d free, block_size=%d)" % (
            self.free_blocks, self.capacity, self.block_size)
