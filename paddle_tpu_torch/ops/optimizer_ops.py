"""Optimizer ops: each writes the parameter's (and its state's) var name
anew, and the executor writes those persistables back to the scope.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py``, op for op: ``sgd``
(dense, and a scatter-add of a SelectedRows gradient), ``adam`` and
``adagrad`` (dense, and the lazy row-subset update of a SelectedRows
gradient, its duplicates merged at the static length K through
``selected_rows.add_rows``); the others densify a SelectedRows gradient,
as the JAX package's do (``_dense_grad``).

Each update computes in the dtypes jnp promotes to.  The learning rate
is a 0-dim float32 tensor: in jnp a 0-d float32 array promotes a
bfloat16 one to float32, while in torch a 0-dim tensor does not promote
a dimensioned tensor of its category.  So every operation with the
learning rate goes through ``_mul`` / ``_sub`` / ``_div``, which cast
both operands to ``torch.promote_types`` of them, one operation at a
time in jnp's order (a bf16-pinned parameter then leaves its first step
in float32, as the reference's does).  A row-subset update writes its
rows back in the updated tensor's own dtype, as jnp's ``.at[].set`` /
``.add`` do.
"""
from __future__ import annotations

import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.ops.math import scalar
from paddle_tpu_torch.core.selected_rows import (SelectedRows, add_rows,
                                                 gather_rows, merge_rows,
                                                 scatter_set)


def _lr(ins):
    return ins["LearningRate"].reshape(())


def _in(*ts):
    """``ts`` cast to the dtype jnp promotes them to (every tensor
    counts, whatever its rank)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return [t.to(dt) for t in ts]


def _mul(a, b):
    a, b = _in(a, b)
    return a * b


def _sub(a, b):
    a, b = _in(a, b)
    return a - b


def _div(a, b):
    a, b = _in(a, b)
    return a / b


def _dense_grad(g):
    """The optimizers without a row-subset update densify a SelectedRows
    gradient (the reference's mathematically identical fallback)."""
    return g.to_dense() if isinstance(g, SelectedRows) else g


@register_op("sgd", grad_maker=None)
def _sgd(ctx, ins, attrs, op):
    p, g, lr = ins["Param"], ins["Grad"], _lr(ins)
    if isinstance(g, SelectedRows):
        # reference sgd_op.h's SelectedRows kernel: a scatter-add over
        # the looked-up rows; duplicates accumulate
        return {"ParamOut": add_rows(p.clone(), g.rows,
                                     _mul(-lr, g.values).to(p.dtype))}
    return {"ParamOut": _sub(p, _mul(lr, g))}


@register_op("momentum", grad_maker=None)
def _momentum(ctx, ins, attrs, op):
    p, g, v = ins["Param"], _dense_grad(ins["Grad"]), ins["Velocity"]
    mu = attrs.get("mu")
    lr = _lr(ins)
    v_out = mu * v + g
    if attrs.get("use_nesterov", False):
        p_out = _sub(p, _mul(g + mu * v_out, lr))
    else:
        p_out = _sub(p, _mul(lr, v_out))
    return {"ParamOut": p_out, "VelocityOut": v_out}


@register_op("adam", grad_maker=None)
def _adam(ctx, ins, attrs, op):
    p, g = ins["Param"], ins["Grad"]
    m1, m2 = ins["Moment1"], ins["Moment2"]
    b1p, b2p = ins["Beta1Pow"].reshape(()), ins["Beta2Pow"].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    lr = _lr(ins) * torch.sqrt(1 - b2p) / (1 - b1p)
    pows = {"Beta1PowOut": ins["Beta1Pow"] * b1,
            "Beta2PowOut": ins["Beta2Pow"] * b2}
    if isinstance(g, SelectedRows):
        # reference adam_op.h's SelectedRows kernel (lazy): duplicates
        # merged, then the moments and the parameter updated at the
        # touched rows alone
        sr = merge_rows(g)
        m1_n = b1 * gather_rows(m1, sr) + (1 - b1) * sr.values
        m2_n = b2 * gather_rows(m2, sr) + (1 - b2) * torch.square(sr.values)
        p_n = _sub(gather_rows(p, sr),
                   _div(_mul(lr, m1_n), torch.sqrt(m2_n) + eps))
        return {"ParamOut": scatter_set(p, sr, p_n),
                "Moment1Out": scatter_set(m1, sr, m1_n),
                "Moment2Out": scatter_set(m2, sr, m2_n), **pows}
    m1_out = b1 * m1 + (1 - b1) * g
    m2_out = b2 * m2 + (1 - b2) * torch.square(g)
    p_out = _sub(p, _div(_mul(lr, m1_out), torch.sqrt(m2_out) + eps))
    return {"ParamOut": p_out, "Moment1Out": m1_out, "Moment2Out": m2_out,
            **pows}


@register_op("adagrad", grad_maker=None)
def _adagrad(ctx, ins, attrs, op):
    p, g, m = ins["Param"], ins["Grad"], ins["Moment"]
    eps = attrs.get("epsilon", 1e-6)
    lr = _lr(ins)
    if isinstance(g, SelectedRows):
        # reference adagrad_op.cc's SelectedRows kernel: duplicates
        # merged, then the moment and the parameter updated at the
        # touched rows alone
        sr = merge_rows(g)
        m_n = gather_rows(m, sr) + torch.square(sr.values)
        p_n = _sub(gather_rows(p, sr),
                   _div(_mul(lr, sr.values), torch.sqrt(m_n) + eps))
        return {"ParamOut": scatter_set(p, sr, p_n),
                "MomentOut": scatter_set(m, sr, m_n)}
    m_out = m + torch.square(g)
    p_out = _sub(p, _div(_mul(lr, g), torch.sqrt(m_out) + eps))
    return {"ParamOut": p_out, "MomentOut": m_out}


@register_op("adamax", grad_maker=None)
def _adamax(ctx, ins, attrs, op):
    p, g = ins["Param"], _dense_grad(ins["Grad"])
    m, inf = ins["Moment"], ins["InfNorm"]
    b1p = ins["Beta1Pow"].reshape(())
    b1 = attrs.get("beta1", 0.9)
    b2 = attrs.get("beta2", 0.999)
    eps = attrs.get("epsilon", 1e-8)
    m_out = b1 * m + (1 - b1) * g
    inf_out = torch.maximum(b2 * inf, torch.abs(g))
    lr = _div(_lr(ins), 1 - b1p)
    p_out = _sub(p, _div(_mul(lr, m_out), inf_out + eps))
    return {"ParamOut": p_out, "MomentOut": m_out, "InfNormOut": inf_out,
            "Beta1PowOut": ins["Beta1Pow"] * b1}


@register_op("decayed_adagrad", grad_maker=None)
def _decayed_adagrad(ctx, ins, attrs, op):
    p, g, m = ins["Param"], _dense_grad(ins["Grad"]), ins["Moment"]
    decay = attrs.get("decay", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    m_out = decay * m + (1 - decay) * torch.square(g)
    p_out = _sub(p, _div(_mul(_lr(ins), g), torch.sqrt(m_out) + eps))
    return {"ParamOut": p_out, "MomentOut": m_out}


@register_op("adadelta", grad_maker=None)
def _adadelta(ctx, ins, attrs, op):
    """No learning rate in the update (reference adadelta_op.h)."""
    p, g = ins["Param"], _dense_grad(ins["Grad"])
    avg_sq_g, avg_sq_u = ins["AvgSquaredGrad"], ins["AvgSquaredUpdate"]
    rho = attrs.get("rho", 0.95)
    eps = attrs.get("epsilon", 1e-6)
    g2 = rho * avg_sq_g + (1 - rho) * torch.square(g)
    upd = -torch.sqrt((avg_sq_u + eps) / (g2 + eps)) * g
    u2 = rho * avg_sq_u + (1 - rho) * torch.square(upd)
    return {"ParamOut": p + upd, "AvgSquaredGradOut": g2,
            "AvgSquaredUpdateOut": u2}


@register_op("rmsprop", grad_maker=None)
def _rmsprop(ctx, ins, attrs, op):
    p, g = ins["Param"], _dense_grad(ins["Grad"])
    ms, mom = ins["MeanSquare"], ins["Moment"]
    rho = attrs.get("decay", 0.9)
    eps = attrs.get("epsilon", 1e-10)
    momentum = attrs.get("momentum", 0.0)
    ms_out = rho * ms + (1 - rho) * torch.square(g)
    mom_out = _div(_mul(_lr(ins), g), torch.sqrt(ms_out + eps))
    mom_out = momentum * mom + mom_out
    return {"ParamOut": p - mom_out, "MeanSquareOut": ms_out,
            "MomentOut": mom_out}


@register_op("ftrl", grad_maker=None)
def _ftrl(ctx, ins, attrs, op):
    p, g = ins["Param"], _dense_grad(ins["Grad"])
    sq, lin = ins["SquaredAccumulator"], ins["LinearAccumulator"]
    l1 = attrs.get("l1", 0.0)
    l2 = attrs.get("l2", 0.0)
    lr_power = attrs.get("lr_power", -0.5)
    lr = _lr(ins)
    new_sq = sq + torch.square(g)
    if lr_power == -0.5:
        new_pow, old_pow = torch.sqrt(new_sq), torch.sqrt(sq)
    else:
        new_pow = torch.pow(new_sq, -lr_power)
        old_pow = torch.pow(sq, -lr_power)
    sigma = _div(new_pow - old_pow, lr)
    lin_out = _sub(lin + g, _mul(sigma, p))
    denom = _div(new_pow, lr) + 2 * l2
    pre = torch.clamp(lin_out, -l1, l1) - lin_out
    return {"ParamOut": _div(pre, denom), "SquaredAccumOut": new_sq,
            "LinearAccumOut": lin_out}


def _prox(prox, lr, l1, l2):
    """The proximal step: soft-threshold by lr * l1, shrink by
    1 + lr * l2 (reference proximal_gd_op.h)."""
    if l1 > 0:
        shrunk = _sub(torch.abs(prox), lr * l1)
        prox = torch.sign(prox) * torch.maximum(shrunk, scalar(shrunk, 0.0))
    return _div(prox, 1.0 + lr * l2)


@register_op("proximal_gd", grad_maker=None)
def _proximal_gd(ctx, ins, attrs, op):
    p, g = ins["Param"], _dense_grad(ins["Grad"])
    lr = _lr(ins)
    return {"ParamOut": _prox(_sub(p, _mul(lr, g)), lr,
                              attrs.get("l1", 0.0), attrs.get("l2", 0.0))}


@register_op("proximal_adagrad", grad_maker=None)
def _proximal_adagrad(ctx, ins, attrs, op):
    p, g, m = ins["Param"], _dense_grad(ins["Grad"]), ins["Moment"]
    m_out = m + torch.square(g)
    lr = _div(_lr(ins), torch.sqrt(m_out))
    return {"ParamOut": _prox(_sub(p, _mul(lr, g)), lr,
                              attrs.get("l1", 0.0), attrs.get("l2", 0.0)),
            "MomentOut": m_out}


@register_op("average_accumulates", grad_maker=None)
def _average_accumulates(ctx, ins, attrs, op):
    """ModelAverage's sums (reference average_accumulates_op.cc, as the
    JAX package's): sum_1 gathers the parameter each update; once the
    window fills, sum_1 rolls into sum_2, and once old_num reaches twice
    the window, sum_2 into sum_3.  All on the device: the counts stay
    tensors, so a captured step replays it."""
    param = ins["Param"]
    sum1, sum2, sum3 = ins["in_sum_1"], ins["in_sum_2"], ins["in_sum_3"]
    num_acc = ins["in_num_accumulates"].reshape(())
    old_num = ins["in_old_num_accumulates"].reshape(())
    num_upd = ins["in_num_updates"].reshape(())
    avg_window = attrs.get("average_window", 0.0)
    max_avg = attrs.get("max_average_window", 10000)
    min_avg = attrs.get("min_average_window", 10000)
    num_acc = num_acc + 1
    num_upd = num_upd + 1
    sum1 = sum1 + param
    window = torch.clamp(num_upd.to(torch.float32) * avg_window,
                         max=float(max_avg))
    window = torch.clamp_min(window, float(min_avg))
    roll = num_acc.to(torch.float32) >= window
    sum2 = torch.where(roll, sum2 + sum1, sum2)
    sum1 = torch.where(roll, torch.zeros_like(sum1), sum1)
    old_num = torch.where(roll, old_num + num_acc, old_num)
    num_acc = torch.where(roll, torch.zeros_like(num_acc), num_acc)
    big = old_num.to(torch.float32) >= 2.0 * window
    sum3 = torch.where(big, sum2, sum3)
    sum2 = torch.where(big, torch.zeros_like(sum2), sum2)
    old_num = torch.where(big, num_acc, old_num)
    return {"out_sum_1": sum1, "out_sum_2": sum2, "out_sum_3": sum3,
            "out_num_accumulates": num_acc.reshape((1,)),
            "out_old_num_accumulates": old_num.reshape((1,)),
            "out_num_updates": num_upd.reshape((1,))}
