"""Optimizer ops: each writes the parameter's (and its state's) var name
anew, and the executor writes those persistables back to the scope.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py`` for the ops ported
so far (the dense branches of momentum and adam).
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op


def _lr(ins):
    return ins["LearningRate"].reshape(())


def _dense(g, op_type):
    if not isinstance(g, torch.Tensor):
        raise NotImplementedError(
            "%s: SelectedRows gradients are not ported to "
            "paddle_tpu_torch yet" % op_type)
    return g


@register_op("momentum", grad_maker=None)
def _momentum(ctx, ins, attrs, op):
    p, g, v = ins["Param"], _dense(ins["Grad"], "momentum"), ins["Velocity"]
    mu = attrs.get("mu")
    lr = _lr(ins)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = p - (g + mu * v_out) * lr
    else:
        p_out = p - lr * v_out
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam", grad_maker=None)
def _adam(ctx, ins, attrs, op):
    p, g = ins["Param"], _dense(ins["Grad"], "adam")
    m1, m2 = ins["Moment1"], ins["Moment2"]
    b1p, b2p = ins["Beta1Pow"].reshape(()), ins["Beta2Pow"].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    p_out = p - lr * m1_out / (torch.sqrt(m2_out) + eps)
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out,
            "Beta1PowOut": ins["Beta1Pow"] * b1,
            "Beta2PowOut": ins["Beta2Pow"] * b2}
