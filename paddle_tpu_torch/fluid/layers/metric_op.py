"""Metric layers (counterpart of paddle_tpu/fluid/layers/metric_op.py;
``accuracy`` only)."""
from __future__ import annotations

from ..layer_helper import LayerHelper

__all__ = ["accuracy"]


def accuracy(input, label, k=1, correct=None, total=None):
    helper = LayerHelper("accuracy", **locals())
    from .nn import topk
    topk_out, topk_indices = topk(input, k=k)
    acc_out = helper.create_tmp_variable(dtype="float32")
    if correct is None:
        correct = helper.create_tmp_variable(dtype="int32")
    if total is None:
        total = helper.create_tmp_variable(dtype="int32")
    helper.append_op(
        type="accuracy",
        inputs={"Out": [topk_out], "Indices": [topk_indices],
                "Label": [label]},
        outputs={"Accuracy": [acc_out], "Correct": [correct],
                 "Total": [total]})
    acc_out.stop_gradient = True
    return acc_out
