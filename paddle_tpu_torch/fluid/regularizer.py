"""Weight-decay regularization (counterpart of
paddle_tpu/fluid/regularizer.py): only the pass-through that
``Optimizer.minimize`` takes when no regularizer is set is ported."""
from __future__ import annotations

__all__ = ["append_regularization_ops"]


def append_regularization_ops(parameters_and_grads, regularization=None):
    """(param, grad) pairs unchanged; raises for a set regularizer."""
    for param, grad in parameters_and_grads:
        if grad is not None and (getattr(param, "regularizer", None)
                                 or regularization):
            raise NotImplementedError(
                "weight-decay regularizers are not ported to "
                "paddle_tpu_torch yet")
    return list(parameters_and_grads)
