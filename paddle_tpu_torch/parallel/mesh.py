"""Device-mesh construction.

Counterpart of ``paddle_tpu/parallel/mesh.py``.  Where the JAX package
builds a ``jax.sharding.Mesh``, a ``Mesh`` here is a named grid of
``torch.device`` s, held in one process: the sequence-parallel ring
(``ring.py``) places shard ``i`` of the ``sp`` axis on device ``i`` and
moves a block between shards with ``.to(device)``.  The same device may
stand at several positions of a list the caller passes, which runs the
shards of a p-way ring, one after the other, on one card.
"""
from __future__ import annotations

import math

import torch

__all__ = ["Mesh", "make_mesh"]


class Mesh:
    """``axis_names`` (tuple), ``shape`` ({name: size}, mesh order) and
    ``devices`` (the flat list of ``torch.device`` s, row-major)."""

    def __init__(self, devices, axes):
        self.devices = list(devices)
        self.shape = dict(axes)
        self.axis_names = tuple(self.shape)
        if len(self.devices) != math.prod(self.shape.values()):
            raise ValueError("mesh %r needs %d devices, got %d"
                             % (self.shape, math.prod(self.shape.values()),
                                len(self.devices)))

    @property
    def size(self):
        return len(self.devices)

    def axis_devices(self, name):
        """The devices along axis ``name`` at index 0 of every other
        axis, in axis order."""
        names = self.axis_names
        sizes = [self.shape[a] for a in names]
        stride = math.prod(sizes[names.index(name) + 1:])
        return [self.devices[i * stride] for i in range(self.shape[name])]

    def __repr__(self):
        return "Mesh(%r, %s)" % (self.shape,
                                 [str(d) for d in self.devices])


def make_mesh(axes, devices=None):
    """``axes``: {axis name: size} (insertion order = mesh order).
    ``devices``: a list of ``torch.device`` (or strings) to lay the mesh
    over, its first prod(sizes) entries taken; None means every visible
    CUDA card, each once.  Raises when the list is too short: unlike the
    JAX package, it never falls back to the CPU."""
    n = math.prod(axes.values())
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh(%r) with no device list needs CUDA; pass "
                "devices=[torch.device('cpu')] * %d to run on the host"
                % (axes, n))
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [torch.device(d) for d in devices]
    if len(devices) < n:
        raise ValueError("mesh %r needs %d devices, have %d"
                         % (axes, n, len(devices)))
    return Mesh(devices[:n], axes)
