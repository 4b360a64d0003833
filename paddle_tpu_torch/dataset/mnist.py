"""MNIST (parity: python/paddle/dataset/mnist.py — train()/test() readers
yielding (image[784] float32 in [-1,1], label int)).

Reads the real idx-ubyte .gz files when cached under DATA_HOME/mnist;
otherwise serves a deterministic synthetic set with identical
shapes/dtypes (``is_synthetic()`` reports which).

The port's copy of ``paddle_tpu/dataset/mnist.py``, numpy only:
``common.download`` never fetches, so without a cached file the
synthetic samples are the reference's, bit for bit."""
from __future__ import annotations

import gzip
import os
import struct

import numpy as np

from . import common

__all__ = ["train", "test", "is_synthetic"]

URL_PREFIX = "http://yann.lecun.com/exdb/mnist/"
TRAIN_IMAGE = "train-images-idx3-ubyte.gz"
TRAIN_LABEL = "train-labels-idx1-ubyte.gz"
TEST_IMAGE = "t10k-images-idx3-ubyte.gz"
TEST_LABEL = "t10k-labels-idx1-ubyte.gz"

_SYN_TRAIN = 2048
_SYN_TEST = 512


def is_synthetic():
    try:
        common.download(URL_PREFIX + TRAIN_IMAGE, "mnist")
        return False
    except FileNotFoundError:
        return True


def _idx_reader(image_gz, label_gz):
    def reader():
        with gzip.open(image_gz, "rb") as fi, gzip.open(label_gz,
                                                        "rb") as fl:
            magic, n, rows, cols = struct.unpack(">4I", fi.read(16))
            assert magic == 2051, "bad idx image magic"
            magic, nl = struct.unpack(">2I", fl.read(8))
            assert magic == 2049 and nl == n, "bad idx label file"
            per = rows * cols
            for _ in range(n):
                img = np.frombuffer(fi.read(per), np.uint8)
                lab = fl.read(1)[0]
                yield (img.astype(np.float32) / 127.5 - 1.0, int(lab))

    return reader


def _synthetic_reader(n, seed):
    """Deterministic stand-in: class-dependent blob images so models can
    actually fit it (same (784,) float32 in [-1,1] + int label API)."""

    def reader():
        rng = np.random.RandomState(seed)
        centers = np.random.RandomState(7).rand(10, 784).astype(
            np.float32)
        for _ in range(n):
            lab = int(rng.randint(0, 10))
            img = centers[lab] + rng.randn(784).astype(np.float32) * 0.3
            yield (np.clip(img, 0, 1) * 2.0 - 1.0, lab)

    return reader


def _creator(image_name, label_name, n_syn, seed):
    try:
        img = common.download(URL_PREFIX + image_name, "mnist")
        lab = common.download(URL_PREFIX + label_name, "mnist")
        return _idx_reader(img, lab)
    except FileNotFoundError:
        return _synthetic_reader(n_syn, seed)


def train():
    return _creator(TRAIN_IMAGE, TRAIN_LABEL, _SYN_TRAIN, 0)


def test():
    return _creator(TEST_IMAGE, TEST_LABEL, _SYN_TEST, 1)
