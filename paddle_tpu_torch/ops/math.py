"""Math / elementwise / activation / reduce ops.

Counterpart of ``paddle_tpu/ops/math.py``, op for op.  Gradients come
from the generic autograd lowering (``core/lowering.generic_grad_lower``).
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
# Python's signs, as jnp.mod / jnp.floor_divide
_ew("elementwise_mod", torch.remainder)
_ew("elementwise_floordiv", torch.floor_divide)


# ---------------------------------------------------------------------------
# Activations: one table, as the JAX package's (reference
# activation_op.cc).  ``fn(x, attrs)``; each lowering reads X and writes
# Out alone, so ``fluid/layers/ops.py`` generates its layer.
# ---------------------------------------------------------------------------

def _act(name, fn, **reg_kwargs):
    def lower(ctx, ins, attrs, op):
        return {"Out": fn(ins["X"], attrs)}

    register_op(name, lower=lower, **reg_kwargs)


def _gelu(x, a):
    """The tanh form (the reference's ``jax.nn.gelu(approximate=True)``),
    as K4's epilogue computes it."""
    from paddle_tpu_torch.kernels.matmul_fused import apply_act

    return apply_act(x, "gelu")


def _softplus(x):
    # jax.nn.softplus: logaddexp(x, 0), no linear cut-off (F.softplus
    # has one at 20)
    return torch.logaddexp(x, torch.zeros_like(x))


def _where0(cond, x):
    return torch.where(cond, x, torch.zeros_like(x))


def scalar(x, v):
    """``v`` as a 0-d tensor of x's dtype on x's device, made by a fill
    on the device (a captured step may copy nothing from the host)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def _max(x, v):
    """jnp.maximum against a scalar: a tie splits the gradient evenly,
    as jax's does (clamp gives it all to x)."""
    return torch.maximum(x, scalar(x, v))


class _Abs(torch.autograd.Function):
    """``torch.abs`` with jax's gradient: ``select(x >= 0, g, -g)``, so
    +1 at both zeros where torch's ``sgn`` gives 0."""

    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.abs(x)

    @staticmethod
    def backward(ctx, g):
        x, = ctx.saved_tensors
        return torch.where(x >= 0, g, -g)


def absolute(x):
    """|x| as ``jnp.abs``: the value of ``torch.abs`` (+0.0 at -0.0),
    the gradient +1 at an exact zero."""
    return _Abs.apply(x)


def _min(x, v):
    return torch.minimum(x, scalar(x, v))


def clip(x, lo, hi):
    """jnp.clip: minimum(maximum(x, lo), hi), with jax's tie gradients."""
    if lo is not None:
        x = _max(x, lo)
    return x if hi is None else _min(x, hi)


_act("relu", lambda x, a: torch.relu(x))
_act("sigmoid", lambda x, a: torch.sigmoid(x))
_act("logsigmoid", lambda x, a: -_softplus(-x))
_act("tanh", lambda x, a: torch.tanh(x))
_act("tanh_shrink", lambda x, a: x - torch.tanh(x))
_act("sqrt", lambda x, a: torch.sqrt(x))
_act("abs", lambda x, a: absolute(x))
_act("ceil", lambda x, a: torch.ceil(x), grad_maker=None)
_act("floor", lambda x, a: torch.floor(x), grad_maker=None)
# half to even, as jnp.round
_act("round", lambda x, a: torch.round(x), grad_maker=None)
_act("cos", lambda x, a: torch.cos(x))
_act("sin", lambda x, a: torch.sin(x))
_act("exp", lambda x, a: torch.exp(x))
_act("log", lambda x, a: torch.log(x))
_act("square", lambda x, a: torch.square(x))
_act("reciprocal", lambda x, a: 1.0 / x)
_act("softplus", lambda x, a: _softplus(x))
_act("softsign", lambda x, a: x / (1 + torch.abs(x)))
_act("relu6", lambda x, a: clip(x, 0.0, a.get("threshold", 6.0)))
_act("pow", lambda x, a: torch.pow(x, a.get("factor", 1.0)))
_act("stanh", lambda x, a: a.get("scale_b", 1.7159) * torch.tanh(
    a.get("scale_a", 2.0 / 3.0) * x))
_act("hard_sigmoid", lambda x, a: clip(
    a.get("slope", 0.2) * x + a.get("offset", 0.5), 0.0, 1.0))
_act("elu", lambda x, a: torch.where(
    x > 0, x, a.get("alpha", 1.0) * (torch.exp(_min(x, 0.0)) - 1)))
_act("leaky_relu", lambda x, a: torch.where(x > 0, x,
                                            a.get("alpha", 0.02) * x))
_act("brelu", lambda x, a: clip(x, a.get("t_min", 0.0),
                                 a.get("t_max", 24.0)))
_act("soft_relu", lambda x, a: torch.log(
    1 + torch.exp(clip(x, -a.get("threshold", 40.0),
                       a.get("threshold", 40.0)))))
_act("thresholded_relu", lambda x, a: _where0(
    x > a.get("threshold", 1.0), x))
_act("hard_shrink", lambda x, a: _where0(
    torch.abs(x) > a.get("threshold", 0.5), x))
_act("softshrink", lambda x, a: torch.sign(x) * _max(
    torch.abs(x) - a.get("lambda", 0.5), 0.0))
_act("swish", lambda x, a: x * torch.sigmoid(a.get("beta", 1.0) * x))
_act("gelu", _gelu)
_act("sign", lambda x, a: torch.sign(x), grad_maker=None)


@register_op("prelu")
def _prelu(ctx, ins, attrs, op):
    x, alpha = ins["X"], ins["Alpha"]
    mode = attrs.get("mode", "all")
    if mode == "channel":
        alpha = alpha.reshape((1, -1) + (1,) * (x.dim() - 2))
    elif mode == "element":
        alpha = alpha.reshape((1,) + tuple(x.shape[1:]))
    return {"Out": torch.where(x > 0, x, alpha * x)}


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


@register_op("minus")
def _minus(ctx, ins, attrs, op):
    return {"Out": ins["X"] - ins["Y"]}


@register_op("cos_sim")
def _cos_sim(ctx, ins, attrs, op):
    x, y = ins["X"], ins["Y"]
    xn = torch.sqrt(torch.sum(x * x, dim=1, keepdim=True))
    yn = torch.sqrt(torch.sum(y * y, dim=1, keepdim=True))
    z = torch.sum(x * y, dim=1, keepdim=True) / (xn * yn)
    return {"Out": z, "XNorm": xn, "YNorm": yn}


@register_op("clip")
def _clip(ctx, ins, attrs, op):
    return {"Out": clip(ins["X"], attrs.get("min"), attrs.get("max"))}


@register_op("clip_by_norm")
def _clip_by_norm(ctx, ins, attrs, op):
    x = ins["X"]
    max_norm = attrs.get("max_norm")
    norm = torch.sqrt(torch.sum(x * x))
    scale = torch.where(norm > max_norm,
                        max_norm / _max(norm, 1e-12),
                        torch.ones_like(norm))
    return {"Out": x * scale}


@register_op("squared_l2_norm")
def _squared_l2_norm(ctx, ins, attrs, op):
    return {"Out": torch.sum(torch.square(ins["X"])).reshape((1,))}


@register_op("squared_l2_distance")
def _squared_l2_distance(ctx, ins, attrs, op):
    diff = ins["X"] - ins["Y"]
    return {"sub_result": diff,
            "Out": torch.sum(torch.square(diff), dim=1, keepdim=True)}


@register_op("l1_norm")
def _l1_norm(ctx, ins, attrs, op):
    return {"Out": torch.sum(absolute(ins["X"])).reshape((1,))}


@register_op("cumsum")
def _cumsum(ctx, ins, attrs, op):
    x = ins["X"]
    axis = attrs.get("axis", -1)
    rev = attrs.get("reverse", False)
    src = torch.flip(x, (axis,)) if rev else x
    out = torch.cumsum(src, dim=axis)
    if attrs.get("exclusive", False):
        out = out - src
    return {"Out": torch.flip(out, (axis,)) if rev else out}


@register_op("norm")
def _norm(ctx, ins, attrs, op):
    x = ins["X"]
    axis = attrs.get("axis", 1)
    eps = attrs.get("epsilon", 1e-10)
    norm = torch.sqrt(torch.sum(x * x, dim=axis, keepdim=True) + eps)
    return {"Out": x / norm, "Norm": norm}


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


def _prod(x, dim=None, keepdim=False):
    """torch.prod over several dims (it takes one at a time)."""
    if dim is None:
        return torch.prod(x)
    for d in sorted(dim, reverse=True):
        x = torch.prod(x, dim=d, keepdim=keepdim)
    return x


_reduce("reduce_sum", torch.sum)
_reduce("reduce_mean", torch.mean)
# amax / amin split a tie's gradient evenly, as jnp.max / jnp.min do
_reduce("reduce_max", torch.amax)
_reduce("reduce_min", torch.amin)
_reduce("reduce_prod", _prod)


@register_op("isfinite", grad_maker=None)
def _isfinite(ctx, ins, attrs, op):
    return {"Out": torch.isfinite(ins["X"]).all().reshape((1,))}


@register_op("maxout")
def _maxout(ctx, ins, attrs, op):
    x = ins["X"]    # NCHW
    groups = attrs["groups"]
    n, c, h, w = x.shape
    return {"Out": torch.amax(x.reshape(n, c // groups, groups, h, w),
                              dim=2)}
