"""UCI housing (parity: python/paddle/dataset/uci_housing.py —
train()/test() yielding (features[13] float32 normalized, price[1])).

Parses the real whitespace table when cached; otherwise a deterministic
synthetic linear-model dataset (so fit_a_line actually fits).

The port's copy of ``paddle_tpu/dataset/uci_housing.py``, numpy only:
``common.download`` never fetches, so without a cached file the
synthetic samples are the reference's, bit for bit."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ["train", "test", "is_synthetic"]

URL = ("https://archive.ics.uci.edu/ml/machine-learning-databases/"
       "housing/housing.data")
FEATURE_DIM = 13
_TRAIN_RATIO = 0.8
_SYN_N = 640


def is_synthetic():
    try:
        common.download(URL, "uci_housing")
        return False
    except FileNotFoundError:
        return True


def _load_real():
    path = common.download(URL, "uci_housing")
    data = np.loadtxt(path).astype(np.float32)
    feats = data[:, :-1]
    # feature-wise normalize like reference feature_range()
    mx, mn, avg = feats.max(0), feats.min(0), feats.mean(0)
    feats = (feats - avg) / np.where(mx > mn, mx - mn, 1.0)
    return np.concatenate([feats, data[:, -1:]], axis=1)


def _load_synthetic():
    rng = np.random.RandomState(42)
    x = rng.randn(_SYN_N, FEATURE_DIM).astype(np.float32)
    w = np.random.RandomState(7).randn(FEATURE_DIM, 1).astype(np.float32)
    y = x @ w + 3.0 + rng.randn(_SYN_N, 1).astype(np.float32) * 0.1
    return np.concatenate([x, y], axis=1)


def _data():
    try:
        return _load_real()
    except FileNotFoundError:
        return _load_synthetic()


def _creator(start_frac, end_frac):
    def reader():
        d = _data()
        n = d.shape[0]
        for row in d[int(n * start_frac):int(n * end_frac)]:
            yield (row[:-1], row[-1:])

    return reader


def train():
    return _creator(0.0, _TRAIN_RATIO)


def test():
    return _creator(_TRAIN_RATIO, 1.0)
