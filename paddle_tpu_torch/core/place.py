"""Device places.

Counterpart of ``paddle_tpu/core/place.py``: ``CUDAPlace(i)`` takes the
place of ``TPUPlace`` and resolves, like ``CPUPlace``, to a
``torch.device`` through ``device.resolve_device`` (which raises for a
CUDA place when there is no card).
"""
from __future__ import annotations

from paddle_tpu_torch.device import resolve_device


class Place:
    device_type = None

    def __init__(self, device_id=0):
        self.device_id = device_id

    def __eq__(self, other):
        return (type(self) is type(other)
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((type(self).__name__, self.device_id))

    def __repr__(self):
        return "%s(%d)" % (type(self).__name__, self.device_id)

    def torch_device(self):
        raise NotImplementedError


class CPUPlace(Place):
    device_type = "cpu"

    def torch_device(self):
        return resolve_device("cpu")


class CUDAPlace(Place):
    device_type = "cuda"

    def torch_device(self):
        return resolve_device("cuda:%d" % self.device_id)
