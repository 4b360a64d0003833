"""Math / elementwise / activation / reduce ops.

Counterpart of ``paddle_tpu/ops/math.py`` for the ops ported so far.
Gradients come from the generic autograd lowering
(``core/lowering.generic_grad_lower``).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.core.selected_rows import SelectedRows, concat_rows
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
_ew("elementwise_sub", torch.sub)
_ew("elementwise_mul", torch.mul)
_ew("elementwise_div", torch.div)
_ew("elementwise_max", torch.maximum)
_ew("elementwise_min", torch.minimum)
_ew("elementwise_pow", torch.pow)


@register_op("relu")
def _relu(ctx, ins, attrs, op):
    return {"Out": torch.relu(ins["X"])}


@register_op("gelu")
def _gelu(ctx, ins, attrs, op):
    """The tanh form (the reference's ``jax.nn.gelu(approximate=True)``),
    as K4's epilogue computes it."""
    from paddle_tpu_torch.kernels.matmul_fused import apply_act

    return {"Out": apply_act(ins["X"], "gelu")}


@register_op("tanh")
def _tanh(ctx, ins, attrs, op):
    return {"Out": torch.tanh(ins["X"])}


@register_op("sigmoid")
def _sigmoid(ctx, ins, attrs, op):
    return {"Out": torch.sigmoid(ins["X"])}


@register_op("square")
def _square(ctx, ins, attrs, op):
    return {"Out": torch.square(ins["X"])}


@register_op("scale")
def _scale(ctx, ins, attrs, op):
    x = ins["X"]
    scale = attrs.get("scale", 1.0)
    bias = attrs.get("bias", 0.0)
    if isinstance(x, SelectedRows):     # a sparse gradient's scaling
        if bias != 0.0:
            raise ValueError("scale of a SelectedRows takes bias 0 only, "
                             "got %r" % (bias,))
        return {"Out": x.scale(scale)}
    if attrs.get("bias_after_scale", True):
        return {"Out": x * scale + bias}
    return {"Out": (x + bias) * scale}


@register_op("cast")
def _cast(ctx, ins, attrs, op):
    return {"Out": ins["X"].to(proto_to_torch_dtype(attrs["out_dtype"]))}


# ---------------------------------------------------------------------------
# Comparison / logical (bool outputs, not differentiable)
# ---------------------------------------------------------------------------

def _cmp(name, fn):
    def lower(ctx, ins, attrs, op):
        x = ins["X"]
        y = broadcast_y_to_x(x, ins["Y"], attrs.get("axis", -1))
        return {"Out": fn(x, y)}

    register_op(name, lower=lower, grad_maker=None)


_cmp("less_than", torch.lt)
_cmp("less_equal", torch.le)
_cmp("greater_than", torch.gt)
_cmp("greater_equal", torch.ge)
_cmp("equal", torch.eq)
_cmp("not_equal", torch.ne)


def _logical(name, fn, unary=False):
    def lower(ctx, ins, attrs, op):
        if unary:
            return {"Out": fn(ins["X"])}
        return {"Out": fn(ins["X"], ins["Y"])}

    register_op(name, lower=lower, grad_maker=None)


_logical("logical_and", torch.logical_and)
_logical("logical_or", torch.logical_or)
_logical("logical_xor", torch.logical_xor)
_logical("logical_not", torch.logical_not, unary=True)


@register_op("increment")
def _increment(ctx, ins, attrs, op):
    """X + step in X's dtype: a Python scalar, so no host value is
    copied to the card (an integer X takes the step as an integer, as
    the JAX package's cast of it does)."""
    x = ins["X"]
    step = attrs.get("step", 1.0)
    return {"Out": x + (step if x.is_floating_point() else int(step))}


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


@register_op("matmul")
def _matmul(ctx, ins, attrs, op):
    """reference matmul_op.cc: batched ``X @ Y`` with the last two dims
    of each transposed on request, times ``alpha``."""
    x, y = ins["X"], ins["Y"]
    if attrs.get("transpose_X", False) and x.dim() > 1:
        x = x.transpose(-1, -2)
    if attrs.get("transpose_Y", False) and y.dim() > 1:
        y = y.transpose(-1, -2)
    out = torch.matmul(x, y)
    alpha = attrs.get("alpha", 1.0)
    if alpha != 1.0:
        out = out * alpha
    return {"Out": out}


@register_op("sum")
def _sum(ctx, ins, attrs, op):
    """Elementwise sum; of SelectedRows alone, their rows concatenated
    (reference sum_op's SelectedRows kernel); a mix densifies."""
    xs = [x for x in ins.list("X") if x is not None]
    sparse = [isinstance(x, SelectedRows) for x in xs]
    if xs and all(sparse):
        return {"Out": concat_rows(xs)}
    if any(sparse):
        xs = [x.to_dense() if isinstance(x, SelectedRows) else x
              for x in xs]
    out = xs[0]
    for x in xs[1:]:
        out = out + x
    return {"Out": out}


@register_op("mean", seq_aware=True)
def _mean(ctx, ins, attrs, op):
    """Mean over all elements, as a [1] tensor; over the valid elements
    of a ragged input (the reference averages over its sum_T packed
    tokens, lod_tensor.h:58, so a padded batch must not count its
    padding)."""
    x = ins["X"]
    lens = None
    if op is not None:
        names = op.inputs.get("X") or []
        if names and names[0]:
            lens = ctx.seq_len_of(names[0])
    if lens is not None and x.dim() >= 2:
        mask = (torch.arange(x.shape[1], device=x.device)[None, :]
                < lens[:, None]).to(x.dtype)
        mask = mask.reshape(mask.shape + (1,) * (x.dim() - 2))
        denom = mask.sum() * float(np.prod(x.shape[2:]) or 1.0)
        return {"Out": ((x * mask).sum()
                        / torch.clamp(denom, min=1.0)).reshape((1,))}
    return {"Out": torch.mean(x).reshape((1,))}


# ---------------------------------------------------------------------------
# Reduce family (reference reduce_op.cc)
# ---------------------------------------------------------------------------

def _reduce(name, fn):
    def lower(ctx, ins, attrs, op):
        x = ins["X"]
        dims = attrs.get("dim", [0])
        if isinstance(dims, int):
            dims = [dims]
        keep = attrs.get("keep_dim", False)
        if attrs.get("reduce_all", False):
            out = fn(x)
            out = out.reshape((1,) * x.dim()) if keep else out.reshape((1,))
        else:
            axes = tuple(d if d >= 0 else d + x.dim() for d in dims)
            out = fn(x, dim=axes, keepdim=keep)
        return {"Out": out}

    register_op(name, lower=lower)


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)
