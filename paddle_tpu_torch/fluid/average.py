"""Python-side running averages.

Counterpart of paddle_tpu/fluid/average.py, a copy (reference
python/paddle/fluid/average.py — WeightedAverage; pure host math,
touches no Program).  Deprecated in the reference in favor of
fluid.metrics; kept for API parity."""
from __future__ import annotations

import warnings

import numpy as np

__all__ = ["WeightedAverage"]


def _is_number(v):
    return isinstance(v, (int, float)) or (
        isinstance(v, np.ndarray) and v.shape == (1,))


def _is_number_or_matrix(v):
    return _is_number(v) or isinstance(v, np.ndarray)


class WeightedAverage(object):
    def __init__(self):
        warnings.warn(
            "WeightedAverage is deprecated, use fluid.metrics.Accuracy "
            "instead.", Warning)
        self.reset()

    def reset(self):
        self.numerator = None
        self.denominator = None

    def add(self, value, weight):
        if not _is_number_or_matrix(value):
            raise ValueError(
                "The 'value' must be a number(int, float) or a numpy "
                "ndarray.")
        if not _is_number(weight):
            raise ValueError("The 'weight' must be a number(int, float).")
        if self.numerator is None or self.denominator is None:
            self.numerator = value * weight
            self.denominator = weight
        else:
            self.numerator += value * weight
            self.denominator += weight

    def eval(self):
        if self.numerator is None or self.denominator is None:
            raise ValueError(
                "There is no data to be averaged in WeightedAverage.")
        return self.numerator / self.denominator
