"""Fused transformer-block ops.

Counterpart of ``paddle_tpu/ops/fused_ops.py``: the ops
FuseTransformerBlockPass (``fluid/transpiler/transformer_fuse.py``)
emits, backed by the kernels in ``kernels/matmul_fused.py``:

- ``fused_qkv_matmul``: X @ [W_q | W_k | W_v] — one wide matmul (K4)
  feeding attention's q/k/v instead of three reads of X.
- ``fused_matmul_bias_act``: matmul + bias (+relu/gelu) (+residual add)
  with the elementwise tail in the matmul's epilogue (K4).  With
  ``dropout_prob > 0`` K4 computes matmul + bias + act, and the dropout
  mask (``ops/random.keep_mask``, drawn at the op-output shape, so an
  explicit seed draws the unfused ``dropout`` op's mask) and the
  residual add follow in torch, as the reference composes them; in
  test mode the output scales by 1 - p ("downgrade_in_infer").
- ``fused_add_ln``: LayerNorm(X + Y) with the sum and the statistics
  from one pass over the rows (K5); the sum is also an output (the
  residual stream reads it downstream).

Each has an EXPLICIT grad lowering consuming the forward's saved
activations (MulOut / Sum): the backward never re-executes the forward
matmul or activation chain.  Its two products are plain large matmuls
(``torch.matmul``, or cuBLAS through ``torch.mm(..., out_dtype=)``), as
the reference leaves them to XLA.  Under bf16 AMP the grads take the
reference's casts (``_compute_dtype``): both products run on bf16
operands with float32 sums, dX in X's dtype and dW in W's (float32),
as the reference's ``preferred_element_type`` names them.  Each forward
op registers an ``infer_shape``: build-time shape inference runs on
``meta`` tensors, which the kernel wrappers do not take.

The reference's ``force_xla`` /
``interpret`` attrs select its XLA branch or the Pallas interpreter;
they are accepted and ignored.
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels import matmul_fused
from paddle_tpu_torch.ops import random as _random
from paddle_tpu_torch.ops.nn import test_mode


def _flat2(x, num_col_dims):
    lead = tuple(x.shape[:num_col_dims])
    return x.reshape(int(np.prod(lead)), -1), lead


def _compute_dtype(ctx, *vals):
    """The grads' product dtype: bf16 under AMP, else the operands'
    promoted dtype (the reference's ``_compute_dtype``)."""
    if getattr(ctx, "amp", False):
        return torch.bfloat16
    dt = vals[0].dtype
    for v in vals[1:]:
        dt = torch.promote_types(dt, v.dtype)
    return dt


def _dot(a, b, out_dtype):
    """``a @ b`` of two operands of one dtype, the products summed in
    float32 and the result in ``out_dtype`` (``jnp.dot``'s
    ``preferred_element_type``): bf16 operands into a float32 result
    without a bf16 rounding between."""
    if a.dtype == out_dtype:
        return torch.matmul(a, b)
    if a.dtype == torch.bfloat16 and out_dtype == torch.float32:
        if a.is_cuda:
            return torch.mm(a, b, out_dtype=out_dtype)
        return torch.matmul(a.float(), b.float())
    return torch.matmul(a, b).to(out_dtype)


def _meta(shape, like):
    return torch.empty(tuple(shape), dtype=like.dtype, device=like.device)


# ---------------------------------------------------------------------------
# fused_qkv_matmul
# ---------------------------------------------------------------------------

def _qkv_infer(ins, attrs, op):
    x = ins["X"]
    lead = tuple(x.shape[:attrs.get("x_num_col_dims", 1)])
    return {"Out": [_meta(lead + (w.shape[1],), x) for w in ins.list("W")]}


@register_op("fused_qkv_matmul", infer_shape=_qkv_infer)
def _qkv_lower(ctx, ins, attrs, op):
    x = ins["X"]
    ws = [w for w in ins.list("W") if w is not None]
    x2, lead = _flat2(x, attrs.get("x_num_col_dims", 1))
    y2 = matmul_fused.matmul_epilogue(x2.contiguous(), torch.cat(ws, dim=1))
    outs = []
    off = 0
    for w in ws:
        n = w.shape[1]
        outs.append(y2[:, off:off + n].reshape(lead + (n,)))
        off += n
    return {"Out": outs}


@register_op("fused_qkv_matmul_grad", grad_maker=None)
def _qkv_grad(ctx, ins, attrs, op):
    """One wide backward pair: dX = dYcat @ Wcat^T and
    dWcat = X^T @ dYcat, sliced back per head — the same two matmuls
    the unfused three-mul chain needs, at a third of the X reads.  A
    missing ``Out@GRAD`` slice counts as zeros."""
    x = ins["X"]
    ws = list(ins.list("W"))
    x2, _ = _flat2(x, attrs.get("x_num_col_dims", 1))
    m = x2.shape[0]
    d2s = [torch.zeros((m, w.shape[1]), device=x2.device,
                       dtype=torch.promote_types(x2.dtype, w.dtype))
           if dy is None else dy.reshape(m, w.shape[1])
           for w, dy in zip(ws, ins.list("Out@GRAD"))]
    dcat = torch.cat(d2s, dim=1)
    wcat = torch.cat(ws, dim=1)
    cdt = _compute_dtype(ctx, x2, wcat)
    dcat = dcat.to(cdt)
    dx2 = _dot(dcat, wcat.to(cdt).t(), x2.dtype)
    dwcat = _dot(x2.to(cdt).t(), dcat, wcat.dtype)
    dws = []
    off = 0
    for w in ws:
        n = w.shape[1]
        dws.append(dwcat[:, off:off + n].to(w.dtype))
        off += n
    return {"X@GRAD": dx2.reshape(x.shape).to(x.dtype), "W@GRAD": dws}


# ---------------------------------------------------------------------------
# fused_matmul_bias_act
# ---------------------------------------------------------------------------

def _mba_infer(ins, attrs, op):
    x, w = ins["X"], ins["W"]
    shp = tuple(x.shape[:attrs.get("x_num_col_dims", 1)]) + (w.shape[1],)
    return {"Out": _meta(shp, x), "MulOut": _meta(shp, x),
            "Mask": _meta(shp, x)}


@register_op("fused_matmul_bias_act", infer_shape=_mba_infer,
             stateful=True)
def _mba_lower(ctx, ins, attrs, op):
    x, w = ins["X"], ins["W"]
    bias = ins.get("Bias")
    residual = ins.get("Residual")
    x2, lead = _flat2(x, attrs.get("x_num_col_dims", 1))
    n = w.shape[1]
    res2 = residual.reshape(-1, n).contiguous() \
        if residual is not None else None
    save_pre = bool(op.outputs.get("MulOut"))
    p = float(attrs.get("dropout_prob", 0.0))
    outs = {}
    # with dropout, K4 runs matmul + bias + act alone: the mask and the
    # residual tail follow in torch
    r = matmul_fused.matmul_epilogue(
        x2.contiguous(), w, bias, None if p > 0.0 else res2,
        attrs.get("act", ""), save_preact=save_pre)
    y2, pre2 = r if save_pre else (r, None)
    if p > 0.0 and not test_mode(attrs, ctx):
        keep = _random.keep_mask(ctx, lead + (n,), 1.0 - p,
                                 attrs.get("seed", 0))
        mask2 = keep.to(y2.dtype).reshape(y2.shape)
        if attrs.get("dropout_implementation",
                     "downgrade_in_infer") == "upscale_in_train":
            mask2 = mask2 / (1.0 - p)
        y2 = y2 * mask2
        if res2 is not None:
            y2 = y2 + res2
        outs["Mask"] = mask2.reshape(lead + (n,))
    elif p > 0.0:
        if attrs.get("dropout_implementation",
                     "downgrade_in_infer") != "upscale_in_train":
            y2 = y2 * (1.0 - p)
        if res2 is not None:
            y2 = y2 + res2
        if op.outputs.get("Mask"):
            outs["Mask"] = torch.ones(lead + (n,), dtype=y2.dtype,
                                      device=y2.device)
    outs["Out"] = y2.reshape(lead + (n,)).to(x.dtype)
    if save_pre:
        outs["MulOut"] = pre2.reshape(lead + (n,))
    return outs


def _act_grad(pre2, dh, act):
    """d act(pre) / d pre applied to ``dh``, by autograd of the
    epilogue's own activation (the executor runs under no_grad)."""
    with torch.enable_grad():
        t = pre2.detach().requires_grad_(True)
        dpre, = torch.autograd.grad(matmul_fused.apply_act(t, act), t,
                                    dh.to(pre2.dtype))
    return dpre


@register_op("fused_matmul_bias_act_grad", grad_maker=None)
def _mba_grad(ctx, ins, attrs, op):
    """Backward from saved residuals only: the activation derivative
    comes from MulOut (or the Out sign for plain relu), the dropout tail
    replays the saved Mask, and the two grad matmuls run on the
    forward's operands — no forward re-execution."""
    x, w = ins["X"], ins["W"]
    bias = ins.get("Bias")
    residual = ins.get("Residual")
    dy = ins["Out@GRAD"]
    act = attrs.get("act", "")
    x2, _ = _flat2(x, attrs.get("x_num_col_dims", 1))
    n = w.shape[1]
    dh = dy.reshape(-1, n)

    out_grads = {}
    if residual is not None:
        out_grads["Residual@GRAD"] = dy.reshape(
            residual.shape).to(residual.dtype)
    p = float(attrs.get("dropout_prob", 0.0))
    is_test = bool(attrs.get("is_test", False))
    mask = ins.get("Mask")
    if p > 0.0 and not is_test and mask is not None:
        dh = dh * mask.reshape(-1, n)
    elif p > 0.0 and is_test and attrs.get(
            "dropout_implementation",
            "downgrade_in_infer") != "upscale_in_train":
        dh = dh * (1.0 - p)
    if act:
        pre = ins.get("MulOut")
        if pre is not None:
            dpre = _act_grad(pre.reshape(-1, n), dh, act)
        elif act == "relu":
            # no saved pre-activation: Out IS relu(pre) (the pass only
            # omits MulOut when nothing follows the activation)
            out = ins["Out"].reshape(-1, n)
            dpre = torch.where(out > 0, dh, torch.zeros_like(dh))
        else:
            raise ValueError(
                "fused_matmul_bias_act_grad: act %r needs the saved "
                "MulOut output" % (act,))
    else:
        dpre = dh
    # a direct MulOut consumer (a test harness differentiating through
    # the saved pre-activation) contributes straight into dpre
    dmul = ins.get("MulOut@GRAD")
    if dmul is not None:
        dpre = dpre + dmul.reshape(-1, n).to(dpre.dtype)

    if bias is not None:
        out_grads["Bias@GRAD"] = dpre.sum(dim=0).to(bias.dtype)
    cdt = _compute_dtype(ctx, x2, w)
    dpre = dpre.to(cdt)
    dx2 = _dot(dpre, w.to(cdt).t(), x2.dtype)
    dw = _dot(x2.to(cdt).t(), dpre, w.dtype)
    out_grads["X@GRAD"] = dx2.reshape(x.shape).to(x.dtype)
    out_grads["W@GRAD"] = dw.to(w.dtype)
    return out_grads


# ---------------------------------------------------------------------------
# fused_add_ln
# ---------------------------------------------------------------------------

def _add_ln_infer(ins, attrs, op):
    x = ins["X"]
    lead = tuple(x.shape[:attrs.get("begin_norm_axis", 1)])
    return {"Out": _meta(x.shape, x), "Sum": _meta(x.shape, x),
            "Mean": _meta(lead, x), "Variance": _meta(lead, x)}


@register_op("fused_add_ln", infer_shape=_add_ln_infer)
def _add_ln_lower(ctx, ins, attrs, op):
    x, y = ins["X"], ins["Y"]
    begin = attrs.get("begin_norm_axis", 1)
    lead = tuple(x.shape[:begin])
    d = int(np.prod(x.shape[begin:]))
    out2, sum2, mean, var = matmul_fused.add_ln(
        x.reshape(-1, d).contiguous(), y.reshape(-1, d).contiguous(),
        ins.get("Scale"), ins.get("Bias"), attrs.get("epsilon", 1e-5))
    return {"Out": out2.reshape(x.shape), "Sum": sum2.reshape(x.shape),
            "Mean": mean.reshape(lead), "Variance": var.reshape(lead)}


@register_op("fused_add_ln_grad", grad_maker=None)
def _add_ln_grad(ctx, ins, attrs, op):
    """Backward from the SAVED residual sum: the LN normalization is
    replayed from Sum through ``ln_from_sum`` (the layer_norm lowering's
    order, so its autograd matches the unfused chain's) and dX = dY =
    d(Sum) — the X+Y add is never re-executed.  Cotangents of Mean,
    Variance (test harnesses; real programs mark them stop_gradient)
    and a direct Sum@GRAD fold in."""
    x, y = ins["X"], ins["Y"]
    scale, bias = ins.get("Scale"), ins.get("Bias")
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    d = int(np.prod(x.shape[begin:]))
    s2 = ins["Sum"].reshape(-1, d)
    rows = s2.shape[0]
    with torch.enable_grad():
        leaves = [s2.detach().requires_grad_(True)]
        sc = bi = None
        if scale is not None:
            sc = scale.detach().requires_grad_(True)
            leaves.append(sc)
        if bias is not None:
            bi = bias.detach().requires_grad_(True)
            leaves.append(bi)
        replay = matmul_fused.ln_from_sum(leaves[0], sc, bi, eps,
                                          stats64=False)
        outputs, cots = [replay[0]], [
            ins["Out@GRAD"].reshape(-1, d).to(s2.dtype)]
        for val, slot in zip(replay[1:], ("Mean@GRAD", "Variance@GRAD")):
            g = ins.get(slot)
            if g is not None:
                outputs.append(val)
                cots.append(g.reshape(rows).to(s2.dtype))
        grads = torch.autograd.grad(outputs, leaves, cots)
    dsum = grads[0].reshape(x.shape)
    dsum_in = ins.get("Sum@GRAD")
    if dsum_in is not None:
        dsum = dsum + dsum_in.to(dsum.dtype)
    out = {"X@GRAD": dsum.to(x.dtype), "Y@GRAD": dsum.to(y.dtype)}
    if scale is not None:
        out["Scale@GRAD"] = grads[1].to(scale.dtype)
    if bias is not None:
        out["Bias@GRAD"] = grads[-1].to(bias.dtype)
    return out
