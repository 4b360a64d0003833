"""DataFeeder: a minibatch (a list of sample tuples) -> a feed dict of
numpy arrays.

Counterpart of ``paddle_tpu/fluid/data_feeder.py`` for dense slots.  A
slot with ``lod_level > 0`` (a ragged sequence) raises
NotImplementedError: ragged (LoD) feeds are not ported yet (ROADMAP
queue 1 items 1 + 6).
"""
from __future__ import annotations

import numpy as np

from .framework import Variable, default_main_program

__all__ = ["DataFeeder"]


class DataToLoDTensorConverter:
    """Stacks one dense slot's samples into an array of the slot's
    dtype, reshaped to the slot's shape where the samples disagree."""

    def __init__(self, shape, dtype, lod_level):
        if lod_level:
            raise NotImplementedError(
                "DataFeeder: a slot with lod_level %d (a ragged sequence) "
                "needs ragged (LoD) feeds, which are not ported to "
                "paddle_tpu_torch yet (ROADMAP queue 1 items 1 + 6)"
                % lod_level)
        self.shape = shape
        self.dtype = dtype
        self.data = []

    def feed(self, data):
        self.data.append(data)

    def done(self):
        arr = np.array(self.data, dtype=self.dtype)
        if self.shape:
            want = tuple(d for d in self.shape if d > 0)
            if arr.shape[1:] != want:
                try:
                    arr = arr.reshape((-1,) + want)
                except ValueError:
                    pass
        return arr


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
