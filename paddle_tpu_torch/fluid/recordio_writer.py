"""Reader -> RecordIO conversion (parity:
python/paddle/fluid/recordio_writer.py — convert_reader_to_recordio_file
/ _files over the chunked writer).

The port's copy of ``paddle_tpu/fluid/recordio_writer.py``.  Samples are
serialized with the same framing the reader-op chain consumes
(``paddle_tpu_torch/recordio``: C++ chunk core with crc32+zlib, python
codec fallback); each record is one pickled feed tuple, so both packages
write the same bytes from the same numpy samples."""
from __future__ import annotations

import contextlib
import pickle

from paddle_tpu_torch import recordio

__all__ = ["create_recordio_writer", "convert_reader_to_recordio_file",
           "convert_reader_to_recordio_files"]


@contextlib.contextmanager
def create_recordio_writer(filename, compressor=None,
                           max_num_records=1000):
    kwargs = {"max_chunk_records": max_num_records}
    if compressor is not None:
        kwargs["compressor"] = compressor
    writer = recordio.Writer(filename, **kwargs)
    try:
        yield writer
    finally:
        writer.close()


def _serialize(sample, feeder=None):
    if feeder is not None:
        sample = feeder.feed([sample])
    return pickle.dumps(sample, protocol=pickle.HIGHEST_PROTOCOL)


def convert_reader_to_recordio_file(filename, reader_creator, feeder=None,
                                    compressor=None, max_num_records=1000,
                                    feed_order=None):
    """Write every sample of ``reader_creator()`` into one recordio
    file; returns the record count."""
    counter = 0
    with create_recordio_writer(filename, compressor,
                                max_num_records) as writer:
        for sample in reader_creator():
            writer.write(_serialize(sample, feeder))
            counter += 1
    return counter


def convert_reader_to_recordio_files(filename, batch_per_file,
                                     reader_creator, feeder=None,
                                     compressor=None, max_num_records=1000,
                                     feed_order=None):
    """Shard the reader across numbered files of ``batch_per_file``
    records each (reference recordio_writer.py:53); returns the
    per-file record counts."""
    import os

    root, ext = os.path.splitext(filename)
    ext = ext or ".recordio"
    wkwargs = {"max_chunk_records": max_num_records}
    if compressor is not None:
        wkwargs["compressor"] = compressor
    lines = []
    f_idx = 0
    counter = 0
    writer = None
    for sample in reader_creator():
        if writer is None:
            path = "%s-%05d%s" % (root, f_idx, ext)
            writer = recordio.Writer(path, **wkwargs)
        writer.write(_serialize(sample, feeder))
        counter += 1
        if counter >= batch_per_file:
            writer.close()
            writer = None
            lines.append(counter)
            counter = 0
            f_idx += 1
    if writer is not None:
        writer.close()
        lines.append(counter)
    return lines
