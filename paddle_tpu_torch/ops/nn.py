"""Neural-network ops.

Counterpart of ``paddle_tpu/ops/nn.py``: ``conv2d`` and the rest of the
conv family (``depthwise_conv2d``, ``conv3d``, ``conv2d_transpose``,
``row_conv``, ``spp``), ``pool2d`` (adaptive too), ``batch_norm``,
``layer_norm``, ``softmax``, ``dropout`` (its mask drawn by
``ops/random.keep_mask`` from the step's stream) and the fused conv
stage ``fused_conv2d_bn_act``.  Plain convolutions are ``F.conv2d`` /
``F.conv3d`` / ``F.conv_transpose2d`` (cuDNN on the card, TF32 off), as
the JAX package leaves them to ``lax.conv_general_dilated``; their
gradients are explicit ``convolution_backward`` calls that never re-run
the forward (``conv2d_grad``; the other three through their
``grad_lower``); with ``FLAGS_cudnn_deterministic`` cuDNN runs them on
its deterministic algorithms (its default weight gradients add with
atomics).  The fused stage's forward conv is the hand-written kernel K6
(``kernels/conv_fused.py``).

``log_softmax``, ``lrn``, ``row_conv`` and ``spp`` are plain torch too.
Not ported: the legacy per-op ``FLAGS.conv_nhwc`` experiment (the
layout transpiler replaced it).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

import contextlib

from paddle_tpu_torch.core.flags import FLAGS
from paddle_tpu_torch.core.lowering import amp_cast_ins
from paddle_tpu_torch.core.desc import OpDesc
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.kernels import conv_fused
from paddle_tpu_torch.ops import random as _random


def _pair(v):
    if isinstance(v, (list, tuple)):
        return [int(x) for x in v]
    return [int(v), int(v)]


def _cudnn(x):
    """cuDNN's deterministic algorithms for a conv on the card when
    ``FLAGS.cudnn_deterministic`` asks for them (TF32 stays off)."""
    if FLAGS.cudnn_deterministic and x.is_cuda:
        return torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                          deterministic=True,
                                          allow_tf32=False)
    return contextlib.nullcontext()


def _wanted(op, slot):
    """Whether the grad op asks for ``slot`` (not a '' hole)."""
    names = op.outputs.get(slot) or []
    return any(names)


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

def _conv_views(x, w, attrs):
    """NCHW / OIHW views of the op's operands for torch's conv, and
    whether the data travels NHWC.  The layout transpiler pins NHWC
    data and HWIO filters; torch takes the permuted views as they are,
    so nothing is copied here."""
    data_format = attrs.get("data_format", "NCHW")
    filter_format = attrs.get("filter_format",
                              "HWIO" if data_format == "NHWC" else "OIHW")
    nhwc, hwio = data_format == "NHWC", filter_format == "HWIO"
    x, w = conv_fused.nchw_views(x, w, nhwc, hwio)
    return x, w, nhwc, hwio


def _conv2d(ctx, ins, attrs, op):
    xv, wv, nhwc, _ = _conv_views(ins["Input"], ins["Filter"], attrs)
    with _cudnn(xv):
        out = F.conv2d(xv, wv, None, _pair(attrs.get("strides", [1, 1])),
                       _pair(attrs.get("paddings", [0, 0])),
                       _pair(attrs.get("dilations", [1, 1])),
                       attrs.get("groups", 1))
    return {"Output": out.permute(0, 2, 3, 1) if nhwc else out}


register_op("conv2d", lower=_conv2d)


def _conv2d_grad(ctx, ins, attrs, op):
    """dInput and dFilter from Output@GRAD, in the op's own layouts.
    Explicit, so the backward does not re-run the forward conv (the
    generic autograd lowering would).  Under AMP the grad convs run in
    bf16, as the forward did (its casts, Output@GRAD's too), and each
    gradient comes back in its operand's own dtype.  ``depthwise_conv2d``'s
    gradient too (its casts are conv2d's)."""
    x_dtype, w_dtype = ins["Input"].dtype, ins["Filter"].dtype
    if ctx.amp:
        ins = amp_cast_ins("conv2d", ins, getattr(op, "role", 0))
    x, w = ins["Input"], ins["Filter"]
    xv, wv, nhwc, hwio = _conv_views(x, w, attrs)
    dy = ins["Output@GRAD"]
    want = [_wanted(op, "Input@GRAD"), _wanted(op, "Filter@GRAD")]
    dx, dw = _conv_backward(dy.permute(0, 3, 1, 2) if nhwc else dy, xv, wv,
                            _pair(attrs.get("strides", [1, 1])),
                            _pair(attrs.get("paddings", [0, 0])),
                            _pair(attrs.get("dilations", [1, 1])),
                            attrs.get("groups", 1), want)
    out = {}
    if dx is not None:
        out["Input@GRAD"] = (dx.permute(0, 2, 3, 1) if nhwc
                             else dx).to(x_dtype)
    if dw is not None:
        out["Filter@GRAD"] = (dw.permute(2, 3, 1, 0).contiguous() if hwio
                              else dw).to(w_dtype)
    return out


register_op("conv2d_grad", lower=_conv2d_grad, grad_maker=None)
# depthwise conv is grouped conv (groups = C), as in the JAX package;
# its gradient lowers through conv2d's (core/lowering.generic_grad_lower
# hands a ``<type>_grad`` to its forward's ``grad_lower``)
register_op("depthwise_conv2d", lower=_conv2d, grad_lower=_conv2d_grad)


def _conv_backward(dy, xv, wv, strides, paddings, dilations, groups, want,
                   transposed=False):
    """(dx, dw) of the convolution of ``xv`` by ``wv`` (``F.conv2d`` /
    ``F.conv3d``, or ``F.conv_transpose2d`` when ``transposed``) in
    NC... / OI... layout, None where not wanted."""
    if not any(want):
        return None, None
    with _cudnn(xv):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            dy.to(xv.dtype), xv, wv, None, strides, paddings, dilations,
            transposed, [0] * len(strides), groups,
            [want[0], want[1], False])
    return dx, dw


def _explicit_conv_grad(op_type, attr_fn):
    """The explicit gradient of ``op_type`` (NC... data, the filter as
    its forward takes it): ``attr_fn(attrs)`` gives (strides, paddings,
    dilations, groups, transposed).  AMP as ``conv2d_grad``."""

    def grad(ctx, ins, attrs, op):
        x_dtype, w_dtype = ins["Input"].dtype, ins["Filter"].dtype
        if ctx.amp:
            ins = amp_cast_ins(op_type, ins, getattr(op, "role", 0))
        strides, paddings, dilations, groups, transposed = attr_fn(attrs)
        dx, dw = _conv_backward(
            ins["Output@GRAD"], ins["Input"], ins["Filter"], strides,
            paddings, dilations, groups,
            [_wanted(op, "Input@GRAD"), _wanted(op, "Filter@GRAD")],
            transposed)
        out = {}
        if dx is not None:
            out["Input@GRAD"] = dx.to(x_dtype)
        if dw is not None:
            out["Filter@GRAD"] = dw.to(w_dtype)
        return out

    return grad


# ---------------------------------------------------------------------------
# conv3d, conv2d_transpose
# ---------------------------------------------------------------------------

def _conv3d_attrs(attrs):
    return ([int(v) for v in attrs.get("strides", [1, 1, 1])],
            [int(v) for v in attrs.get("paddings", [0, 0, 0])],
            [int(v) for v in attrs.get("dilations", [1, 1, 1])],
            int(attrs.get("groups", 1)), False)


def _conv3d(ctx, ins, attrs, op):
    """NCDHW x OIDHW (``F.conv3d``)."""
    strides, paddings, dilations, groups, _ = _conv3d_attrs(attrs)
    with _cudnn(ins["Input"]):
        return {"Output": F.conv3d(ins["Input"], ins["Filter"], None,
                                   strides, paddings, dilations, groups)}


register_op("conv3d", lower=_conv3d,
            grad_lower=_explicit_conv_grad("conv3d", _conv3d_attrs))


def _conv2d_transpose_attrs(attrs):
    # the reference's op ignores ``groups`` (its filter is
    # [C_in, C_out, kH, kW] whatever the layer was given)
    return (_pair(attrs.get("strides", [1, 1])),
            _pair(attrs.get("paddings", [0, 0])),
            _pair(attrs.get("dilations", [1, 1])), 1, True)


def _conv2d_transpose(ctx, ins, attrs, op):
    """Filter (C_in, C_out, kH, kW) as in reference
    conv_transpose_op.cc: ``F.conv_transpose2d``, whose output extent
    (H - 1) * s - 2p + d (k - 1) + 1 is the JAX package's lhs-dilated
    conv with the flipped kernel padded by d (k - 1) - p."""
    strides, paddings, dilations, _, _ = _conv2d_transpose_attrs(attrs)
    with _cudnn(ins["Input"]):
        return {"Output": F.conv_transpose2d(ins["Input"], ins["Filter"],
                                             None, strides, paddings, 0, 1,
                                             dilations)}


register_op("conv2d_transpose", lower=_conv2d_transpose,
            grad_lower=_explicit_conv_grad("conv2d_transpose",
                                           _conv2d_transpose_attrs))


# ---------------------------------------------------------------------------
# pool2d
# ---------------------------------------------------------------------------

@register_op("pool2d")
def _pool2d(ctx, ins, attrs, op):
    x = ins["X"]
    ptype = attrs.get("pooling_type", "max")
    ksize = _pair(attrs.get("ksize", [2, 2]))
    strides = _pair(attrs.get("strides", [1, 1]))
    paddings = _pair(attrs.get("paddings", [0, 0]))
    nhwc = attrs.get("data_format", "NCHW") == "NHWC"
    hd, wd = (1, 2) if nhwc else (2, 3)
    if attrs.get("global_pooling", False):
        ksize = [x.shape[hd], x.shape[wd]]
        paddings = [0, 0]
        strides = [1, 1]
    if attrs.get("adaptive", False):
        # ksize output bins over equal windows (the reference reshapes:
        # H and W must divide by the bins)
        oh, ow = ksize
        if nhwc:
            n, h, w_, c = x.shape
            x6, dims = x.reshape(n, oh, h // oh, ow, w_ // ow, c), (2, 4)
        else:
            n, c, h, w_ = x.shape
            x6, dims = x.reshape(n, c, oh, h // oh, ow, w_ // ow), (3, 5)
        if ptype == "max":
            return {"Out": x6.amax(dim=dims)}
        return {"Out": x6.mean(dim=dims)}
    xv = x.permute(0, 3, 1, 2) if nhwc else x
    # output extent floor((H + 2p - k) / s) + 1, as the reference's
    # reduce_window (ceil_mode is not honoured there either)
    if ptype == "max":
        out = F.max_pool2d(xv, ksize, strides, paddings)
    else:
        # exclusive: a padded window divides by its in-image count;
        # otherwise by the window size
        out = F.avg_pool2d(xv, ksize, strides, paddings,
                           count_include_pad=not attrs.get("exclusive",
                                                           True))
    return {"Out": out.permute(0, 2, 3, 1) if nhwc else out}


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------

def test_mode(attrs, ctx):
    """An op's ``is_test`` attr, or a run in test mode (a program cloned
    for test, ``ctx.mode``)."""
    return bool(attrs.get("is_test", False)) or \
        getattr(ctx, "mode", "train") == "test"


def _dropout_lower(ctx, ins, attrs, op):
    """reference dropout_op.cc: in training Out = X * Mask, Mask the
    keep draw (``keep_mask``), over 1 - p under "upscale_in_train";
    in test mode Out = X * (1 - p) ("downgrade_in_infer", the default)
    or X, with a Mask of ones."""
    x = ins["X"]
    p = float(attrs.get("dropout_prob", 0.5))
    impl = attrs.get("dropout_implementation", "downgrade_in_infer")
    if test_mode(attrs, ctx):
        out = x if impl == "upscale_in_train" else x * (1.0 - p)
        return {"Out": out, "Mask": torch.ones_like(x)}
    if x.device.type == "meta":
        return {"Out": torch.empty_like(x), "Mask": torch.empty_like(x)}
    mask = _random.keep_mask(ctx, x.shape, 1.0 - p,
                             attrs.get("seed", 0)).to(x.dtype)
    if impl == "upscale_in_train":
        mask = mask / (1.0 - p)
    return {"Out": x * mask, "Mask": mask}


def _dropout_grad_maker(op, block, no_grad_set):
    xg = op.input("X")[0] + "@GRAD"
    g = OpDesc("dropout_grad",
               inputs={"Mask": op.output("Mask"),
                       "Out@GRAD": [op.output("Out")[0] + "@GRAD"]},
               outputs={"X@GRAD": [xg]},
               attrs={k: a.value for k, a in op.attrs.items()})
    return [g], {xg: op.input("X")[0]}


register_op("dropout", lower=_dropout_lower, stateful=True,
            grad_maker=_dropout_grad_maker)


@register_op("dropout_grad", grad_maker=None)
def _dropout_grad(ctx, ins, attrs, op):
    """Out@GRAD * Mask: the forward's saved mask, never a new draw."""
    return {"X@GRAD": ins["Out@GRAD"] * ins["Mask"]}


# ---------------------------------------------------------------------------
# batch_norm
# ---------------------------------------------------------------------------

@register_op("batch_norm")
def _batch_norm(ctx, ins, attrs, op):
    """reference batch_norm_op.cc: in train mode normalizes with the
    batch statistics and blends them into the running ones (MeanOut /
    VarianceOut alias Mean / Variance); in test mode normalizes with
    the running statistics.

    The order is the JAX package's, not ``F.batch_norm``'s: f32
    var = mean(x^2) - mean^2 (biased), blended with ``momentum``.  New
    tensors come out for MeanOut / VarianceOut; the persistables are
    never updated in place (the generic grad lowering re-runs this
    forward)."""
    x = ins["X"]
    scale, bias = ins["Scale"], ins["Bias"]
    mean_in, var_in = ins["Mean"], ins["Variance"]
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    c_axis = 1 if attrs.get("data_layout", "NCHW") == "NCHW" \
        else x.dim() - 1
    red = tuple(i for i in range(x.dim()) if i != c_axis)
    bshape = [1] * x.dim()
    bshape[c_axis] = x.shape[c_axis]

    if test_mode(attrs, ctx):
        mean, var = mean_in, var_in
        mean_out, var_out = mean_in, var_in
    else:
        xf = x.float()
        mean = torch.mean(xf, dim=red)
        var = torch.mean(torch.square(xf), dim=red) - torch.square(mean)
        mean = mean.to(mean_in.dtype)
        var = var.to(var_in.dtype)
        mean_out = mean_in * momentum + mean * (1 - momentum)
        var_out = var_in * momentum + var * (1 - momentum)

    inv_std = torch.rsqrt(var.to(x.dtype).reshape(bshape) + eps)
    y = (x - mean.to(x.dtype).reshape(bshape)) * inv_std
    y = y * scale.to(x.dtype).reshape(bshape) \
        + bias.to(x.dtype).reshape(bshape)
    return {"Y": y, "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": mean, "SavedVariance": var}


@register_op("layer_norm")
def _layer_norm(ctx, ins, attrs, op):
    x = ins["X"]
    begin = attrs.get("begin_norm_axis", 1)
    eps = attrs.get("epsilon", 1e-5)
    axes = tuple(range(begin, x.dim()))
    # statistics in f32, the normalized output in x.dtype (as the JAX
    # package does for bf16 inputs)
    xf = x.float()
    mean = torch.mean(xf, dim=axes, keepdim=True)
    var = torch.mean(torch.square(xf - mean), dim=axes, keepdim=True)
    mean = mean.to(x.dtype)
    var = var.to(x.dtype)
    y = (x - mean) * torch.rsqrt(var + eps)
    fshape = (1,) * begin + tuple(x.shape[begin:])
    scale = ins.get("Scale")
    bias = ins.get("Bias")
    if scale is not None:
        y = y * scale.to(x.dtype).reshape(fshape)
    if bias is not None:
        y = y + bias.to(x.dtype).reshape(fshape)
    lead = tuple(x.shape[:begin])
    return {"Y": y, "Mean": mean.reshape(lead),
            "Variance": var.reshape(lead)}


@register_op("softmax")
def _softmax(ctx, ins, attrs, op):
    return {"Out": torch.softmax(ins["X"], dim=-1)}


@register_op("log_softmax")
def _log_softmax(ctx, ins, attrs, op):
    return {"Out": torch.log_softmax(ins["X"], dim=attrs.get("axis", -1))}


@register_op("lrn")
def _lrn(ctx, ins, attrs, op):
    """Local response norm across channels (reference lrn_op.cc, as the
    JAX package writes it): mid = k + alpha * (the sum of x^2 over the n
    channels centred on each), out = x / mid^beta.  Not
    ``F.local_response_norm``, which divides alpha by n and pads
    otherwise.  The window sum is added slice by slice in the JAX
    package's order."""
    x = ins["X"]    # NCHW
    n = attrs.get("n", 5)
    k = attrs.get("k", 2.0)
    alpha = attrs.get("alpha", 1e-4)
    beta = attrs.get("beta", 0.75)
    half = n // 2
    pad = F.pad(torch.square(x), (0, 0, 0, 0, half, half))
    c = x.shape[1]
    acc = sum(pad[:, i:i + c] for i in range(n))
    mid = k + alpha * acc
    return {"Out": x / torch.pow(mid, beta), "MidOut": mid}


# ---------------------------------------------------------------------------
# Fused conv + BN (+ residual) (+ relu) stage, NHWC / HWIO — the op
# FuseConvBNActPass emits (fluid/transpiler/layout_transpiler.py).  The
# training forward takes the conv and its per-channel statistics from K6
# in one pass; the backward is an EXPLICIT grad lowering over the
# forward's saved ConvOut / SavedMean / SavedInvStd that never re-runs
# the forward, with its two grad convs in the pinned layout.
# ---------------------------------------------------------------------------

def _fused_conv_bn_lower(ctx, ins, attrs, op):
    x, w = ins["Input"], ins["Filter"]
    scale, bias = ins["Scale"], ins["Bias"]
    mean_in, var_in = ins["Mean"], ins["Variance"]
    residual = ins.get("Residual")
    strides = _pair(attrs.get("strides", [1, 1]))
    paddings = _pair(attrs.get("paddings", [0, 0]))
    eps = attrs.get("epsilon", 1e-5)
    momentum = attrs.get("momentum", 0.9)
    act = attrs.get("act", "")
    if attrs.get("force_xla", False) and x.is_cuda:
        # the reference's XLA branch; the port has only K6 on the card
        raise NotImplementedError(
            "fused_conv2d_bn_act: force_xla has no counterpart on CUDA "
            "(the conv stage always runs the K6 kernel)")
    x = x.contiguous()
    if residual is not None:
        residual = residual.contiguous()
    co = w.shape[3]

    if test_mode(attrs, ctx):
        inv = torch.rsqrt(var_in.float() + eps)
        a = scale.float() * inv
        b = bias.float() - mean_in.float() * a
        y = conv_fused.conv2d_nhwc(x, w, strides, paddings, affine=(a, b),
                                   residual=residual, act=act)
        # fully fused: the raw conv output never reaches memory, and a
        # test-mode program has no grad op to read it
        return {"Y": y, "MeanOut": mean_in, "VarianceOut": var_in,
                "SavedMean": mean_in.float(), "SavedInvStd": inv,
                "ConvOut": None}

    conv_out, s, ss = conv_fused.conv2d_nhwc(x, w, strides, paddings,
                                             stats=True)
    m = conv_out.numel() // co                     # N * Ho * Wo
    mean = s / m
    var = ss / m - torch.square(mean)              # f32, from f32 sums
    inv = torch.rsqrt(var + eps)
    a = scale.float() * inv
    b = bias.float() - mean * a
    yf = conv_out.float() * a + b
    if residual is not None:
        yf += residual.float()
    if act == "relu":
        yf.relu_()
    mean_out = mean_in * momentum + mean.to(mean_in.dtype) * (1 - momentum)
    var_out = var_in * momentum + var.to(var_in.dtype) * (1 - momentum)
    return {"Y": yf.to(x.dtype), "ConvOut": conv_out,
            "MeanOut": mean_out, "VarianceOut": var_out,
            "SavedMean": mean, "SavedInvStd": inv}


def _fused_conv_bn_infer(ins, attrs, op):
    """Shapes without touching the kernel: conv arithmetic + [Co]."""
    x, w = ins["Input"], ins["Filter"]
    sh, sw = _pair(attrs.get("strides", [1, 1]))
    ph, pw = _pair(attrs.get("paddings", [0, 0]))
    n, h, wd, _ = x.shape
    kh, kw, _, co = w.shape
    ho = (h + 2 * ph - kh) // sh + 1
    wo = (wd + 2 * pw - kw) // sw + 1

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=x.device)

    return {"Y": meta((n, ho, wo, co), x.dtype),
            "ConvOut": meta((n, ho, wo, co), x.dtype),
            "MeanOut": meta((co,), ins["Mean"].dtype),
            "VarianceOut": meta((co,), ins["Variance"].dtype),
            "SavedMean": meta((co,), torch.float32),
            "SavedInvStd": meta((co,), torch.float32)}


register_op("fused_conv2d_bn_act", lower=_fused_conv_bn_lower,
            infer_shape=_fused_conv_bn_infer)


@register_op("fused_conv2d_bn_act_grad", grad_maker=None)
def _fused_conv_bn_grad(ctx, ins, attrs, op):
    """Backward from saved residuals only (no forward re-execution):
    relu mask from the reconstructed pre-activation, batch-statistics BN
    gradient from (ConvOut, SavedMean, SavedInvStd) in f32, and the two
    conv gradients in the pinned NHWC / HWIO layout, in bf16 under AMP
    (the reference's ``cdt``), each gradient in its operand's dtype."""
    x, w = ins["Input"], ins["Filter"]
    scale = ins["Scale"]
    conv_out = ins["ConvOut"]
    mean, inv = ins["SavedMean"], ins["SavedInvStd"]
    residual = ins.get("Residual")
    dy = ins["Y@GRAD"]
    strides = _pair(attrs.get("strides", [1, 1]))
    paddings = _pair(attrs.get("paddings", [0, 0]))
    co = w.shape[3]
    red = (0, 1, 2)                                  # N, Ho, Wo

    a = scale.float() * inv
    b = ins["Bias"].float() - mean * a
    cf = conv_out.float()
    xhat = (cf - mean) * inv
    dyf = dy.float()
    if attrs.get("act", "") == "relu":
        pre = cf * a + b
        if residual is not None:
            pre = pre + residual.float()
        dyf = torch.where(pre > 0, dyf, torch.zeros_like(dyf))
        del pre
    dscale = (dyf * xhat).sum(dim=red)
    dbias = dyf.sum(dim=red)
    if attrs.get("is_test", False):
        dconv = dyf * a
    else:
        m = conv_out.numel() // co
        dconv = a * (dyf - dbias / m - xhat * dscale / m)
    del xhat, cf

    cdt = torch.bfloat16 if ctx.amp else torch.promote_types(x.dtype,
                                                             w.dtype)
    xv, wv = conv_fused.nchw_views(x.to(cdt), w.to(cdt))
    dx, dw = _conv_backward(
        dconv.permute(0, 3, 1, 2), xv, wv, strides, paddings, [1, 1], 1,
        [_wanted(op, "Input@GRAD"), _wanted(op, "Filter@GRAD")])
    out = {"Scale@GRAD": dscale.to(scale.dtype),
           "Bias@GRAD": dbias.to(ins["Bias"].dtype)}
    if dx is not None:
        out["Input@GRAD"] = dx.permute(0, 2, 3, 1).to(x.dtype)
    if dw is not None:
        out["Filter@GRAD"] = dw.permute(2, 3, 1, 0).contiguous().to(w.dtype)
    if residual is not None:
        out["Residual@GRAD"] = dyf.to(residual.dtype)
    # Running stats are stop_gradient in real programs; when a harness
    # declares their grads anyway, the only dependency is the momentum
    # blend into MeanOut / VarianceOut.
    momentum = attrs.get("momentum", 0.9)
    for slot, gslot in (("Mean", "MeanOut@GRAD"),
                        ("Variance", "VarianceOut@GRAD")):
        if slot + "@GRAD" in op.outputs:
            src = ins.get(gslot)
            out[slot + "@GRAD"] = (src * momentum if src is not None
                                   else torch.zeros_like(ins[slot]))
    return out


# ---------------------------------------------------------------------------
# row_conv, spp
# ---------------------------------------------------------------------------

@register_op("row_conv")
def _row_conv(ctx, ins, attrs, op):
    """Lookahead row convolution (reference row_conv_op.cc), dense batch
    form: x [N, T, D], filter [future_ctx, D]; x padded with zeros after
    T, the window's terms added in the JAX package's order."""
    x, f = ins["X"], ins["Filter"]
    ctx_len = f.shape[0]
    t = x.shape[1]
    xp = F.pad(x, (0, 0, 0, ctx_len - 1))
    return {"Out": sum(xp[:, i:i + t] * f[i] for i in range(ctx_len))}


@register_op("spp")
def _spp(ctx, ins, attrs, op):
    """Spatial pyramid pooling (reference spp_op.cc): level l pools
    2**l x 2**l bins of ceil(H / 2**l) x ceil(W / 2**l), the map padded
    after its end with -inf (max) or 0 (avg); the levels' [N, C * bins^2]
    concatenated.  ``amax``'s gradient splits a tie evenly, as jax's
    max reduction does."""
    x = ins["X"]
    levels = attrs.get("pyramid_height", 1)
    is_max = attrs.get("pooling_type", "max") == "max"
    n, c, h, w = x.shape
    outs = []
    for lvl in range(levels):
        bins = 2 ** lvl
        kh, kw = -(-h // bins), -(-w // bins)
        xp = F.pad(x, (0, kw * bins - w, 0, kh * bins - h),
                   value=-float("inf") if is_max else 0.0)
        x6 = xp.reshape(n, c, bins, kh, bins, kw)
        red = x6.amax(dim=(3, 5)) if is_max else x6.mean(dim=(3, 5))
        outs.append(red.reshape(n, -1))
    return {"Out": torch.cat(outs, dim=1)}
