"""Device-side data loading: batching + double-buffered host->device
staging, plus a device dataset cache for datasets that fit on the card.

Counterpart of ``paddle_tpu/reader/device_loader.py``.  Role parity:
reference operators/reader/ (BatchReader, create_double_buffer_reader_op.cc,
blocking_queue.h), the C++ decorated-reader chain that overlaps input
copy with compute.  Where the JAX package's background thread calls
``jax.device_put`` on upcoming batches, the port's stacks each batch
into pinned host tensors and copies them with ``non_blocking=True`` on a
dedicated copy stream (``StagedCopy``); it records an event there, and
the consumer's stream waits on that event before the batch is used, so
the copy of batch k+1 runs while the step of batch k does.  The bounded
queue is the blocking-queue analog.

``DeviceDatasetCache`` is the small-dataset fast path: the whole dataset
is staged on the device once, and every epoch is served as device-side
``index_select`` gathers under one ``torch.randperm`` on a device
``torch.Generator`` seeded from (seed, epoch): zero per-step host->device
traffic (the tf.data ``cache()``-on-accelerator idiom).  Its order is
not jax's permutation; the same seed gives the same order on a place.

On ``CPUPlace`` the batches are CPU tensors (no copy stream, no pinned
memory).  A ``CUDAPlace`` without a card raises (``Place.torch_device``):
nothing here carries on on the host when handed the card.
"""
from __future__ import annotations

import queue
import threading

import numpy as np
import torch

__all__ = ["batch", "DeviceLoader", "DeviceDatasetCache",
           "DatasetExceedsBudget", "StagedCopy"]


class DatasetExceedsBudget(ValueError):
    """Dataset won't fit the DeviceDatasetCache byte budget — stream it
    through DeviceLoader instead."""


def batch(reader, batch_size, drop_last=True):
    """Group samples into lists of ``batch_size`` (reference
    python/paddle/batch.py; ``drop_last=True`` by default, as the JAX
    package's, so a ragged last batch never changes the step's shape).
    Samples may be tuples (fields stay parallel)."""

    def batched():
        b = []
        for s in reader():
            b.append(s)
            if len(b) >= batch_size:
                yield b
                b = []
        if b and not drop_last:
            yield b

    return batched


class StagedCopy:
    """Host -> device staging on a dedicated copy stream.

    ``stage(arrays)`` (from any thread) copies each numpy array into a
    pinned host tensor and on to ``device`` with ``non_blocking=True``
    on the copy stream, records an event there and returns
    ``(tensors, event)``; ``ready(tensors, event)`` (on the consumer's
    thread) makes the consumer's current stream wait on the event and
    marks the tensors as used by that stream, so the caching allocator
    does not hand their memory out while the step still reads it.  On
    the CPU ``stage`` wraps the arrays and ``event`` is None."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.stream = (torch.cuda.Stream(self.device)
                       if self.device.type == "cuda" else None)

    def stage(self, arrays):
        if self.stream is None:
            return [torch.from_numpy(np.ascontiguousarray(a))
                    for a in arrays], None
        out = []
        with torch.cuda.stream(self.stream):
            for a in arrays:
                a = np.ascontiguousarray(a)
                pinned = torch.empty(a.shape, dtype=_torch_dtype(a.dtype),
                                     pin_memory=True)
                pinned.numpy()[...] = a
                # the pinned block is not reused until this copy is done:
                # the host allocator records the copy's stream
                out.append(pinned.to(self.device, non_blocking=True))
            event = torch.cuda.Event()
            event.record(self.stream)
        return out, event

    @staticmethod
    def ready(tensors, event):
        if event is None:
            return tensors
        cur = torch.cuda.current_stream(tensors[0].device)
        cur.wait_event(event)
        for t in tensors:
            t.record_stream(cur)
        return tensors

    def synchronize(self):
        """Wait for every copy issued on the copy stream."""
        if self.stream is not None:
            self.stream.synchronize()


def _torch_dtype(np_dtype):
    return torch.from_numpy(np.zeros(0, np_dtype)).dtype


class DeviceLoader:
    """Iterate device-resident feed dicts, ``capacity`` batches ahead.

    feed_list: var names (or Variables) matching each sample field.
    Samples are field tuples; batches (lists of samples) are stacked
    per-field with np.stack before staging.  An iterator abandoned
    mid-epoch (``close()``, or dropped) stops its producer thread and
    drops the batches it staged.
    """

    def __init__(self, reader, feed_list, place, capacity=2):
        self.reader = reader
        self.names = [getattr(v, "name", v) for v in feed_list]
        self.place = place
        self.capacity = max(1, int(capacity))

    def _stack(self, samples):
        fields = list(zip(*samples))
        if len(fields) != len(self.names):
            raise ValueError(
                "sample has %d fields but feed_list names %d" %
                (len(fields), len(self.names)))
        return [np.stack([np.asarray(x) for x in f]) for f in fields]

    def __iter__(self):
        copier = StagedCopy(self.place.torch_device())
        end = object()
        q = queue.Queue(maxsize=self.capacity)
        stop = threading.Event()

        def put(item):
            # bounded put that gives up when the consumer went away, so
            # an abandoned iterator doesn't pin a thread + `capacity`
            # device-staged batches forever
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for samples in self.reader():
                    if stop.is_set() or not put(
                            copier.stage(self._stack(samples))):
                        return
            except Exception as e:  # surface reader errors to the consumer
                put(e)
            finally:
                put(end)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        empty = queue.Empty  # bind now: module globals go away first at
        try:                 # interpreter shutdown
            while True:
                item = q.get()
                if item is end:
                    return
                if isinstance(item, Exception):
                    raise item
                yield dict(zip(self.names, copier.ready(*item)))
        finally:
            stop.set()
            while True:  # drop staged batches so buffers free promptly
                try:
                    q.get_nowait()
                except empty:
                    break


class DeviceDatasetCache:
    """Serve device-resident shuffled batches from a dataset cached on
    the device.

    The whole dataset is staged once, and each epoch is a device-side
    gather under a fresh ``torch.randperm`` drawn from a device
    ``torch.Generator`` seeded from (seed, epoch): zero per-step
    host->device traffic.  Iteration yields {name: device tensor} feed
    dicts, batch-major, ``floor(n / batch_size)`` per epoch (the last
    partial batch dropped, as the JAX package's).

    ``max_bytes`` guards the device budget: building the cache raises
    ``DatasetExceedsBudget`` as soon as the running sample-byte total
    crosses it — before the dataset is fully materialized on the host —
    so callers can fall back to the streaming ``DeviceLoader``.
    """

    def __init__(self, reader, feed_list, place, batch_size, seed=0,
                 max_bytes=4 << 30):
        self.names = [getattr(v, "name", v) for v in feed_list]
        self.batch_size = int(batch_size)
        self.seed = int(seed)
        self.device = place.torch_device()
        samples = []
        total = 0
        for s in reader():
            samples.append(s)
            total += sum(np.asarray(x).nbytes for x in s)
            if total > max_bytes:
                raise DatasetExceedsBudget(
                    "dataset exceeds max_bytes=%d after %d samples — use "
                    "the streaming DeviceLoader" % (max_bytes,
                                                    len(samples)))
        if not samples:
            raise ValueError("reader yielded no samples")
        fields = list(zip(*samples))
        if len(fields) != len(self.names):
            raise ValueError(
                "sample has %d fields but feed_list names %d" %
                (len(fields), len(self.names)))
        host = [np.stack([np.asarray(x) for x in f]) for f in fields]
        del samples, fields
        self.n = host[0].shape[0]
        if self.n < self.batch_size:
            raise ValueError("dataset smaller than one batch (%d < %d)"
                             % (self.n, self.batch_size))
        self._cache = [torch.from_numpy(a).to(self.device) for a in host]
        self.nbytes = sum(a.nbytes for a in host)
        self._epoch = 0

    def permutation(self, epoch):
        """The sample order of ``epoch``: a ``torch.randperm`` on the
        cache's device from a generator seeded with (seed, epoch)."""
        g = torch.Generator(device=self.device)
        g.manual_seed((self.seed * 1000003 + int(epoch)) & 0x7FFFFFFFFFFFFFFF)
        return torch.randperm(self.n, generator=g, device=self.device)

    def __iter__(self):
        epoch = self._epoch
        self._epoch += 1
        perm = self.permutation(epoch)
        bs = self.batch_size
        for k in range(self.n // bs):
            idx = perm[k * bs:(k + 1) * bs]
            yield {name: c.index_select(0, idx)
                   for name, c in zip(self.names, self._cache)}
