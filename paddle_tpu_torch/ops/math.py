"""Math / elementwise / activation / reduce ops.

Counterpart of ``paddle_tpu/ops/math.py`` for the ops ported so far.
Gradients come from the generic autograd lowering
(``core/lowering.generic_grad_lower``).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.core.types import proto_to_torch_dtype


# ---------------------------------------------------------------------------
# Elementwise binary ops with the reference's axis-broadcast rule
# (elementwise_op_function.h): y's dims align to x's starting at `axis`.
# ---------------------------------------------------------------------------

def broadcast_y_to_x(x, y, axis):
    if x.shape == y.shape or y.dim() == 0:
        return y
    if axis < 0:
        axis = x.dim() - y.dim()
    new_shape = [1] * axis + list(y.shape) + [1] * (x.dim() - axis - y.dim())
    return y.reshape(new_shape)


def _ew(name, fn):
    def lower(ctx, ins, attrs, op):
        x = ins["X"]
        y = broadcast_y_to_x(x, ins["Y"], attrs.get("axis", -1))
        return {"Out": fn(x, y)}

    register_op(name, lower=lower)


_ew("elementwise_add", torch.add)
_ew("elementwise_mul", torch.mul)


@register_op("relu")
def _relu(ctx, ins, attrs, op):
    return {"Out": torch.relu(ins["X"])}


@register_op("scale")
def _scale(ctx, ins, attrs, op):
    x = ins["X"]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if attrs.get("bias_after_scale", True):
        return {"Out": x * scale + bias}
    return {"Out": (x + bias) * scale}


@register_op("cast")
def _cast(ctx, ins, attrs, op):
    return {"Out": ins["X"].to(proto_to_torch_dtype(attrs["out_dtype"]))}


# ---------------------------------------------------------------------------
# Linear algebra
# ---------------------------------------------------------------------------

@register_op("mul")
def _mul(ctx, ins, attrs, op):
    """reference mul_op.cc: flatten X to 2-D by x_num_col_dims, Y by
    y_num_col_dims, matmul, restore leading dims.  A plain product: the
    JAX package leaves it to XLA, the port to torch.matmul."""
    x, y = ins["X"], ins["Y"]
    xn = attrs.get("x_num_col_dims", 1)
    yn = attrs.get("y_num_col_dims", 1)
    xs, ys = tuple(x.shape), tuple(y.shape)
    x2 = x.reshape((int(np.prod(xs[:xn])), -1))
    y2 = y.reshape((int(np.prod(ys[:yn])), -1))
    return {"Out": torch.matmul(x2, y2).reshape(xs[:xn] + ys[yn:])}


@register_op("sum")
def _sum(ctx, ins, attrs, op):
    xs = [x for x in ins.list("X") if x is not None]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean")
def _mean(ctx, ins, attrs, op):
    """Mean over all elements, as a [1] tensor."""
    return {"Out": torch.mean(ins["X"]).reshape((1,))}


# ---------------------------------------------------------------------------
# Reduce family (reference reduce_op.cc)
# ---------------------------------------------------------------------------

@register_op("reduce_sum")
def _reduce_sum(ctx, ins, attrs, op):
    x = ins["X"]
    dims = attrs.get("dim", [0])
    if isinstance(dims, int):
        dims = [dims]
    keep = attrs.get("keep_dim", False)
    if attrs.get("reduce_all", False):
        out = torch.sum(x)
        out = out.reshape((1,) * x.dim()) if keep else out.reshape((1,))
    else:
        axes = tuple(d if d >= 0 else d + x.dim() for d in dims)
        out = torch.sum(x, dim=axes, keepdim=keep)
    return {"Out": out}
