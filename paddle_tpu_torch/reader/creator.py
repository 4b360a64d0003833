"""Reader creators: ``np_array`` and ``text_file``, copied from
``paddle_tpu/reader/creator.py`` (the port imports nothing of the JAX
package).  Its ``recordio`` reader waits for the recordio container
(ROADMAP queue 1 item 11)."""
from __future__ import annotations

__all__ = ["np_array", "text_file"]


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
