"""Gradient clipping (counterpart of paddle_tpu/fluid/clip.py): only the
pass-through that ``Optimizer.minimize`` takes when no clip is set is
ported."""
from __future__ import annotations

__all__ = ["append_gradient_clip_ops", "error_clip_callback"]


def error_clip_callback(block, op_desc):
    pass  # hook point for error clipping on activation grads


def append_gradient_clip_ops(param_grad):
    """(param, grad) pairs unchanged; raises for a set clip attr."""
    for p, _ in param_grad:
        if getattr(p, "gradient_clip_attr", None) is not None:
            raise NotImplementedError(
                "gradient clipping is not ported to paddle_tpu_torch yet")
    return list(param_grad)
