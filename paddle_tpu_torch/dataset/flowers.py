"""Flowers-102 (parity: python/paddle/dataset/flowers.py — train()/test()
yielding (image[3,224,224] float32, label int)).  The real dataset needs
network access; offline we serve deterministic synthetic 224x224 images
— the shape/dtype contract bench.py and ResNet training rely on.

The port's copy of ``paddle_tpu/dataset/flowers.py``, numpy only:
``common.download`` never fetches, so without a cached file the
synthetic samples are the reference's, bit for bit."""
from __future__ import annotations

import numpy as np

from . import common

__all__ = ["train", "test", "is_synthetic"]

URL = ("http://www.robots.ox.ac.uk/~vgg/data/flowers/102/"
       "102flowers.tgz")
CLASS_DIM = 102
_SYN_TRAIN = 1024
_SYN_TEST = 128


def is_synthetic():
    try:
        common.download(URL, "flowers")
        return False
    except FileNotFoundError:
        return True


def _synthetic_reader(n, seed):
    def reader():
        rng = np.random.RandomState(seed)
        for _ in range(n):
            lab = int(rng.randint(0, CLASS_DIM))
            # cheap deterministic texture, avoids storing n full images
            base = rng.rand(3, 14, 14).astype(np.float32)
            img = np.kron(base, np.ones((16, 16), np.float32))
            yield (img, lab)

    return reader


def _creator(n_syn, seed):
    try:
        common.download(URL, "flowers")
        raise NotImplementedError(
            "real flowers parsing requires scipy.io loadmat of the "
            "labels; cache the extracted arrays instead")
    except FileNotFoundError:
        return _synthetic_reader(n_syn, seed)


def train():
    return _creator(_SYN_TRAIN, 0)


def test():
    return _creator(_SYN_TEST, 1)
