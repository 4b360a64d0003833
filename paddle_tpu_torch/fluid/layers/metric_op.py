"""Metric layers (counterpart of paddle_tpu/fluid/layers/metric_op.py)."""
from __future__ import annotations

from ..layer_helper import LayerHelper
from ..initializer import ConstantInitializer

__all__ = ["accuracy", "auc"]


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


def auc(input, label, curve="ROC", num_thresholds=200):
    helper = LayerHelper("auc", **locals())
    auc_out = helper.create_tmp_variable(dtype="float32")
    stats = {}
    for name in ("TP", "FP", "TN", "FN"):
        v = helper.create_or_get_global_variable(
            name="auc_%s_%s" % (name, helper.name), dtype="int64",
            shape=[num_thresholds], persistable=True)
        helper.set_variable_initializer(v, ConstantInitializer(0))
        stats[name] = v
    helper.append_op(
        type="auc",
        inputs={"Predict": [input], "Label": [label],
                "TP": [stats["TP"]], "FP": [stats["FP"]],
                "TN": [stats["TN"]], "FN": [stats["FN"]]},
        outputs={"AUC": [auc_out], "TPOut": [stats["TP"]],
                 "FPOut": [stats["FP"]], "TNOut": [stats["TN"]],
                 "FNOut": [stats["FN"]]},
        attrs={"curve": curve, "num_thresholds": num_thresholds})
    auc_out.stop_gradient = True
    return auc_out
