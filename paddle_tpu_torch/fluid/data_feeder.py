"""DataFeeder: a minibatch (a list of sample tuples) -> a feed dict.

Counterpart of ``paddle_tpu/fluid/data_feeder.py`` (parity: reference
python/paddle/fluid/data_feeder.py).  A dense slot becomes a numpy
array of the slot's dtype; a slot with ``lod_level`` k > 0 (a ragged
sequence, nested k deep) becomes a ``core.lod.LoDTensor`` (the flat
data and its offset table), which the executor pads and pairs with
'<name>@LEN' lengths on the device.
"""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.lod import LoDTensor

from .framework import Variable, default_main_program

__all__ = ["DataFeeder"]


class DataToLoDTensorConverter:
    """One slot's samples: stacked into an array of the slot's dtype
    (reshaped to the slot's shape where the samples disagree), or, for
    a ragged slot, concatenated with one offset list a level."""

    def __init__(self, shape, dtype, lod_level):
        self.shape = shape
        self.dtype = dtype
        self.lod_level = lod_level
        self.data = []
        self.lod = [[0] for _ in range(lod_level)]

    def feed(self, data):
        self._feed_impl(data, self.lod, self.lod_level)

    def _feed_impl(self, data, lod, lod_level):
        if lod_level == 0:
            self.data.append(data)
        else:
            lod[0].append(lod[0][-1] + len(data))
            for item in data:
                self._feed_impl(item, lod[1:], lod_level - 1)

    def done(self):
        if self.lod_level == 0:
            arr = np.array(self.data, dtype=self.dtype)
            if self.shape:
                want = tuple(d for d in self.shape if d > 0)
                if arr.shape[1:] != want:
                    try:
                        arr = arr.reshape((-1,) + want)
                    except ValueError:
                        pass
            return arr
        if self.data:
            flat = np.concatenate(
                [np.asarray(x, dtype=self.dtype).reshape(-1, *self.shape)
                 if self.shape else np.asarray(x, dtype=self.dtype)
                 for x in self.data], axis=0)
        else:
            flat = np.zeros([0] + list(self.shape), dtype=self.dtype)
        return LoDTensor(flat, self.lod)


class DataFeeder:
    def __init__(self, feed_list, place=None, program=None):
        self.feed_dtypes = []
        self.feed_names = []
        self.feed_shapes = []
        self.feed_lod_level = []
        if program is None:
            program = default_main_program()
        for each_var in feed_list:
            if isinstance(each_var, str):
                each_var = program.global_block().var(each_var)
            if not isinstance(each_var, Variable):
                raise TypeError("feed_list entries must be Variables")
            self.feed_names.append(each_var.name)
            self.feed_lod_level.append(each_var.lod_level)
            shape = list(each_var.shape)
            if shape and shape[0] == -1:   # drop the batch dim
                shape = shape[1:]
            if each_var.lod_level > 0 and shape and shape[0] == -1:
                shape = shape[1:]          # and a ragged slot's padded T
            self.feed_shapes.append(shape)
            self.feed_dtypes.append(each_var.dtype)
        self.place = place

    def feed(self, iterable):
        converters = [
            DataToLoDTensorConverter(shape=s, dtype=d, lod_level=lod)
            for s, d, lod in zip(self.feed_shapes, self.feed_dtypes,
                                 self.feed_lod_level)]
        for each_sample in iterable:
            assert len(each_sample) == len(converters), \
                "sample arity %d != feed arity %d" % (len(each_sample),
                                                      len(converters))
            for each_converter, each_slot in zip(converters, each_sample):
                each_converter.feed(each_slot)
        return {name: conv.done()
                for name, conv in zip(self.feed_names, converters)}
