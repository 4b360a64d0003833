"""Data readers: a reader is a zero-argument callable returning an
iterable of samples; decorators compose readers, creators build them
from arrays, files and recordio files, ``batch`` groups samples into
minibatches, and ``DeviceLoader`` / ``DeviceDatasetCache`` feed the
device (counterpart of ``paddle_tpu/reader``)."""
from .decorator import (map_readers, shuffle, chain, compose, buffered,
                        firstn, xmap_readers, cache,
                        ComposeNotAligned, PipeReader)  # noqa: F401
from . import creator  # noqa: F401
from .device_loader import (DatasetExceedsBudget,  # noqa: F401
                            DeviceDatasetCache, DeviceLoader, batch)

__all__ = ["map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "xmap_readers", "cache", "ComposeNotAligned",
           "PipeReader", "creator", "DeviceLoader", "DeviceDatasetCache",
           "DatasetExceedsBudget", "batch"]
