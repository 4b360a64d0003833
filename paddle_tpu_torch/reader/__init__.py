"""Data readers: a reader is a zero-argument callable returning an
iterable of samples; decorators compose readers, creators build them
from arrays and files, and ``batch`` groups samples into minibatches.

Counterpart of ``paddle_tpu/reader`` without its ``DeviceLoader``,
``DeviceDatasetCache`` and recordio reader (ROADMAP queue 1 item 11).
"""
from .decorator import (map_readers, shuffle, chain, compose, buffered,
                        firstn, xmap_readers, cache,
                        ComposeNotAligned, PipeReader)  # noqa: F401
from . import creator  # noqa: F401

__all__ = ["map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "xmap_readers", "cache", "ComposeNotAligned",
           "PipeReader", "creator", "batch"]


def batch(reader, batch_size, drop_last=True):
    """Group samples into lists of ``batch_size`` (the reference's
    ``paddle.batch``; ``drop_last=True`` by default, as the JAX
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
