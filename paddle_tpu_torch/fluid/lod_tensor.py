"""LoDTensor construction helpers (counterpart of
``paddle_tpu/fluid/lod_tensor.py``; parity:
python/paddle/fluid/lod_tensor.py — create_lod_tensor /
create_random_int_lodtensor over length-based LoD input).

The produced object is the port's LoDTensor (``core/lod.py``: flat data
+ offset-based lod), which every feed path accepts and pads into
bucketed static shapes."""
from __future__ import annotations

import numpy as np

from paddle_tpu_torch.core.lod import LoDTensor

__all__ = ["create_lod_tensor", "create_random_int_lodtensor"]


def _validate_lod(lod, tensor_height=-1):
    """lod is a list of lists of positive-int LENGTHS; inner levels must
    sum to the next level's entry count, the last to the data height."""
    if not isinstance(lod, list):
        return False
    for level in lod:
        if not isinstance(level, list):
            return False
        for span in level:
            if not isinstance(span, (int, np.integer)) or span <= 0:
                return False
    if not lod:
        return True
    for upper, lower in zip(lod, lod[1:]):
        if sum(upper) != len(lower):
            return False
    if tensor_height != -1 and sum(lod[-1]) != tensor_height:
        return False
    return True


def _lengths_to_offsets(lod):
    out = []
    for level in lod:
        offs = [0]
        for span in level:
            offs.append(offs[-1] + int(span))
        out.append(offs)
    return out


def create_lod_tensor(data, lod, place=None):
    """Build a LoDTensor from numpy / nested list / LoDTensor ``data``
    and LENGTH-based ``lod`` (e.g. [[2, 3]] = two sequences of 2 and 3
    steps); lengths convert to the internal offset form [[0, 2, 5]]."""
    if isinstance(data, LoDTensor):
        return create_lod_tensor(np.asarray(data), lod, place)
    if isinstance(data, list):
        # list-of-sequences of word ids -> [n, 1] int64 (reference
        # lod_tensor.py:129 handles exactly this case)
        new_lod = [len(seq) for seq in data]
        assert [new_lod] == lod, "data and lod do not match"
        flat = np.concatenate(
            [np.asarray(seq) for seq in data], axis=0).astype("int64")
        return create_lod_tensor(flat.reshape([len(flat), 1]), lod, place)
    if isinstance(data, np.ndarray):
        assert _validate_lod(lod, data.shape[0]), \
            "the provided lod info is invalid"
        return LoDTensor(data, _lengths_to_offsets(lod))
    raise TypeError(
        "data should be either a LoDTensor, a numpy array or a list")


def create_random_int_lodtensor(lod, base_shape, place=None, low=0,
                                high=1):
    """Random-int LoDTensor: total height = sum of the last-level
    lengths, element shape = ``base_shape`` (reference
    lod_tensor.py:153)."""
    assert isinstance(base_shape, list), "base_shape should be a list"
    converted = _lengths_to_offsets(lod)
    total = converted[-1][-1] if converted else 0
    shape = [total] + list(base_shape)
    data = np.random.randint(low, high + 1, shape).astype("int64")
    return create_lod_tensor(data, lod, place)
