"""Reader creators: ``np_array``, ``text_file`` and ``recordio``, copied
from ``paddle_tpu/reader/creator.py`` (the port imports nothing of the
JAX package; ``recordio`` reads through the port's own
``paddle_tpu_torch.recordio``)."""
from __future__ import annotations

__all__ = ["np_array", "text_file", "recordio"]


def np_array(x):
    """Reader over the first axis of a numpy array."""

    def reader():
        for row in x:
            yield row

    return reader


def text_file(path):
    """Reader yielding stripped lines of a text file."""

    def reader():
        with open(path, "r") as f:
            for line in f:
                yield line.rstrip("\n")

    return reader


def recordio(paths, deserializer=None):
    """Reader over recordio file(s) (reference creator.py:60 uses the
    recordio scanner; the port's is paddle_tpu_torch.recordio).
    ``paths`` is a list or a comma-separated string; ``deserializer``
    maps raw record bytes to a sample (default: raw bytes)."""
    from paddle_tpu_torch import recordio as rio

    if isinstance(paths, str):
        paths = paths.split(",")

    def reader():
        for p in paths:
            for rec in rio.read_records(p):
                yield deserializer(rec) if deserializer else rec

    return reader
