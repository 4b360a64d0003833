"""CIFAR-10/100 (parity: python/paddle/dataset/cifar.py — train10/test10/
train100/test100 yielding (image[3072] float32 in [0,1], label int)).

Parses the real python-pickle tarballs when cached under
DATA_HOME/cifar; otherwise deterministic synthetic data.

The port's copy of ``paddle_tpu/dataset/cifar.py``, numpy only:
``common.download`` never fetches, so without a cached file the
synthetic samples are the reference's, bit for bit."""
from __future__ import annotations

import pickle
import tarfile

import numpy as np

from . import common

__all__ = ["train10", "test10", "train100", "test100", "is_synthetic"]

URL10 = "https://www.cs.toronto.edu/~kriz/cifar-10-python.tar.gz"
URL100 = "https://www.cs.toronto.edu/~kriz/cifar-100-python.tar.gz"

_SYN_TRAIN = 2048
_SYN_TEST = 512


def is_synthetic():
    try:
        common.download(URL10, "cifar")
        return False
    except FileNotFoundError:
        return True


def _tar_reader(tar_path, sub_name):
    """Yield samples from members whose name contains sub_name
    (reference cifar.py:46)."""

    def reader():
        with tarfile.open(tar_path, "r:gz") as tf:
            names = [n for n in tf.getnames() if sub_name in n]
            for name in sorted(names):
                batch = pickle.load(tf.extractfile(name),
                                    encoding="latin1")
                labels = batch.get("labels") or batch.get("fine_labels")
                for img, lab in zip(batch["data"], labels):
                    yield (np.asarray(img, np.float32) / 255.0, int(lab))

    return reader


def _synthetic_reader(n, n_classes, seed):
    def reader():
        rng = np.random.RandomState(seed)
        centers = np.random.RandomState(13).rand(
            n_classes, 3072).astype(np.float32)
        for _ in range(n):
            lab = int(rng.randint(0, n_classes))
            img = centers[lab] + rng.randn(3072).astype(np.float32) * 0.15
            yield (np.clip(img, 0.0, 1.0), lab)

    return reader


def _creator(url, sub_name, n_classes, n_syn, seed):
    try:
        return _tar_reader(common.download(url, "cifar"), sub_name)
    except FileNotFoundError:
        return _synthetic_reader(n_syn, n_classes, seed)


def train10():
    return _creator(URL10, "data_batch", 10, _SYN_TRAIN, 0)


def test10():
    return _creator(URL10, "test_batch", 10, _SYN_TEST, 1)


def train100():
    return _creator(URL100, "train", 100, _SYN_TRAIN, 2)


def test100():
    return _creator(URL100, "test", 100, _SYN_TEST, 3)
