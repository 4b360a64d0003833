"""Optimizer ops: each writes the parameter's (and its state's) var name
anew, and the executor writes those persistables back to the scope.

Counterpart of ``paddle_tpu/ops/optimizer_ops.py`` for the ops ported
so far: ``sgd`` (dense, and a scatter-add of a SelectedRows gradient),
``momentum`` (a SelectedRows gradient densified), and ``adam`` and
``adagrad`` (dense, and the lazy row-subset update of a SelectedRows
gradient, its duplicates merged at the static length K through
``selected_rows.add_rows``).

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
