"""Tensor manipulation ops.

Counterpart of ``paddle_tpu/ops/tensor.py``, op for op.  The 64-bit
index outputs (``arg_max``, ``argsort``'s, ``top_k``'s, ``shape``) are
int64 tensors that the descs record as int32, as the JAX package's x32
inference does (``lowering._X32``).
"""
from __future__ import annotations

import numpy as np
import torch

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.core.selected_rows import SelectedRows, add_rows
from paddle_tpu_torch.core.types import DataType, proto_to_torch_dtype


@register_op("reshape")
def _reshape(ctx, ins, attrs, op):
    x = ins["X"]
    shape = list(attrs.get("shape"))
    # 0 = keep input dim (reference reshape semantics), -1 = infer
    shape = [x.shape[i] if d == 0 else d for i, d in enumerate(shape)]
    return {"Out": x.reshape(shape)}


@register_op("concat")
def _concat(ctx, ins, attrs, op):
    # torch.cat promotes mixed float dtypes as jnp.concatenate does
    xs = [x for x in ins.list("X") if x is not None]
    return {"Out": torch.cat(xs, attrs.get("axis", 0))}


@register_op("transpose")
def _transpose(ctx, ins, attrs, op):
    # a view: a consumer that needs contiguous memory (a kernel) copies
    return {"Out": ins["X"].permute(*attrs.get("axis"))}


def _top_k_infer(ins, attrs, op):
    """The desc records the indices as int32, as the JAX package's does
    (its int64 narrows to int32 without jax_enable_x64), so programs
    serialize alike; the lowering's tensor is int64."""
    x = ins["X"]
    shape = tuple(x.shape[:-1]) + (attrs.get("k", 1),)
    return {"Out": torch.empty(shape, dtype=x.dtype, device=x.device),
            "Indices": torch.empty(shape, dtype=torch.int32,
                                   device=x.device)}


def top_k(x, k):
    """(values, indices) of the ``k`` largest along the last dim, as
    ``jax.lax.top_k``: equal values in index order, the lower first, on
    both devices (``torch.topk``'s order among ties is unspecified and
    differs between the CPU and CUDA), by a stable descending sort."""
    idx = torch.argsort(x, dim=-1, descending=True, stable=True)[..., :k]
    return torch.gather(x, -1, idx), idx


@register_op("top_k", grad_maker=None, infer_shape=_top_k_infer)
def _top_k(ctx, ins, attrs, op):
    vals, idx = top_k(ins["X"], attrs.get("k", 1))
    return {"Out": vals, "Indices": idx}


@register_op("assign")
def _assign(ctx, ins, attrs, op):
    return {"Out": ins["X"]}


def assign_value_tensor(attrs, device, shape_of=None):
    """The constant an ``assign_value`` op's attrs hold, on ``device``
    (``shape_of``: see CONSTANT_OPS)."""
    dtype = proto_to_torch_dtype(attrs.get("dtype", DataType.FP32))
    shape = attrs.get("shape")
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    if attrs.get("fp32_values"):
        vals = np.asarray(attrs["fp32_values"], dtype=np.float32)
    else:
        vals = np.asarray(attrs.get("int32_values", []), dtype=np.int32)
    return torch.from_numpy(vals.reshape(shape)).to(device=device,
                                                    dtype=dtype)


@register_op("assign_value", grad_maker=None)
def _assign_value(ctx, ins, attrs, op):
    """The op's constant: in a prepared step the device tensor made once
    at ``prepare()`` (``ctx.constants``, so a captured graph reads it
    from the card, copying nothing from the host), else made from the
    attrs."""
    const = ctx.constants.get(id(op)) if op is not None else None
    if const is not None:
        return {"Out": const}
    return {"Out": assign_value_tensor(attrs, ctx.device)}


@register_op("fill_constant", grad_maker=None)
def _fill_constant(ctx, ins, attrs, op):
    dtype = proto_to_torch_dtype(attrs.get("dtype", DataType.FP32))
    return {"Out": torch.full(tuple(attrs.get("shape", [1])),
                              attrs.get("value", 0.0), dtype=dtype,
                              device=ctx.device)}


@register_op("fill_constant_batch_size_like", grad_maker=None)
def _fill_cbsl(ctx, ins, attrs, op):
    """``shape`` with dim ``output_dim_idx`` taken from the input's dim
    ``input_dim_idx`` (its batch), filled with ``value``."""
    dtype = proto_to_torch_dtype(attrs.get("dtype", DataType.FP32))
    shape = list(attrs.get("shape"))
    shape[attrs.get("output_dim_idx", 0)] = \
        ins["Input"].shape[attrs.get("input_dim_idx", 0)]
    return {"Out": torch.full(tuple(shape), attrs.get("value", 0.0),
                              dtype=dtype, device=ctx.device)}


@register_op("fill_zeros_like", grad_maker=None)
def _fill_zeros_like(ctx, ins, attrs, op):
    return {"Out": torch.zeros_like(ins["X"])}


def _lookup_idx(ids):
    return ids.reshape(ids.shape[:-1]) if ids.shape[-1] == 1 else ids


@register_op("lookup_table")
def _lookup_table(ctx, ins, attrs, op):
    """Embedding lookup (reference lookup_table_op.cc).  Ids [..., 1]
    int64, kept int64 (the JAX package narrows them to int32)."""
    w, ids = ins["W"], ins["Ids"]
    padding_idx = attrs.get("padding_idx", -1)
    idx = _lookup_idx(ids).long()
    out = w[idx]
    if padding_idx != -1:
        out = out.masked_fill((idx == padding_idx)[..., None], 0.0)
    return {"Out": out}


@register_op("lookup_table_grad", grad_maker=None)
def _lookup_table_grad(ctx, ins, attrs, op):
    """W@GRAD of the lookup: with ``is_sparse`` a SelectedRows (rows =
    the looked-up ids, duplicates kept; values = the out-grad rows),
    else the out-grad rows scatter-added into a zero table
    (``selected_rows.add_rows``, the same bits on every run; reference
    lookup_table_op.cc's grad kernels)."""
    ids, g = ins["Ids"], ins["Out@GRAD"]
    w = ins.get("W")
    # a distributed table never lives on the trainer: its shape comes
    # from the 'table_shape' attr the transpiler stamps
    if w is not None:
        height, d, wdtype = int(w.shape[0]), int(w.shape[1]), w.dtype
    else:
        height, d = [int(v) for v in attrs["table_shape"]]
        wdtype = g.dtype
    padding_idx = attrs.get("padding_idx", -1)
    rows = _lookup_idx(ids).reshape(-1).long()
    vals = g.reshape(-1, d).to(wdtype)
    if padding_idx != -1:
        # the vjp of the padding mask: those rows contribute nothing
        vals = vals.masked_fill((rows == padding_idx)[:, None], 0.0)
    if attrs.get("is_sparse", False):
        return {"W@GRAD": SelectedRows(rows, vals, height)}
    if w is None:
        raise ValueError(
            "lookup_table_grad without W requires is_sparse=True "
            "(distributed tables always ship sparse grads)")
    return {"W@GRAD": add_rows(torch.zeros_like(w), rows, vals)}


@register_op("split")
def _split(ctx, ins, attrs, op):
    x = ins["X"]
    axis = attrs.get("axis", 0)
    sections = attrs.get("sections", [])
    if not sections:
        num = attrs.get("num", 0)
        if x.shape[axis] % num:
            raise ValueError("split: dim %d of %s does not divide into %d"
                             % (axis, tuple(x.shape), num))
        sections = [x.shape[axis] // num] * num
    return {"Out": list(torch.split(x, list(sections), dim=axis))}


def _xshape(x):
    """The reshape2 / transpose2 'XShape' output: an empty [0, *x.shape]
    tensor that records the input's shape."""
    return torch.zeros((0,) + tuple(x.shape), dtype=x.dtype, device=x.device)


@register_op("reshape2")
def _reshape2(ctx, ins, attrs, op):
    out = _reshape(ctx, ins, attrs, op)
    out["XShape"] = _xshape(ins["X"])
    return out


@register_op("transpose2")
def _transpose2(ctx, ins, attrs, op):
    x = ins["X"]
    return {"Out": x.permute(*attrs.get("axis")), "XShape": _xshape(x)}


@register_op("squeeze")
def _squeeze(ctx, ins, attrs, op):
    x = ins["X"]
    axes = attrs.get("axes", [])
    if axes:
        shape = [d for i, d in enumerate(x.shape)
                 if not (i in axes or i - x.dim() in axes) or d != 1]
        return {"Out": x.reshape(shape)}
    return {"Out": torch.squeeze(x)}


@register_op("unsqueeze")
def _unsqueeze(ctx, ins, attrs, op):
    x = ins["X"]
    for ax in sorted(attrs.get("axes", [])):
        x = torch.unsqueeze(x, ax)
    return {"Out": x}


@register_op("expand")
def _expand(ctx, ins, attrs, op):
    return {"Out": torch.tile(ins["X"], tuple(attrs.get("expand_times")))}


@register_op("gather")
def _gather(ctx, ins, attrs, op):
    idx = ins["Index"].reshape(-1).long()
    return {"Out": torch.index_select(ins["X"], 0, idx)}


@register_op("scatter")
def _scatter(ctx, ins, attrs, op):
    ids = ins["Ids"].reshape(-1).long()
    return {"Out": ins["X"].index_copy(0, ids, ins["Updates"])}


@register_op("pad")
def _pad(ctx, ins, attrs, op):
    x = ins["X"]
    p = attrs.get("paddings")
    # F.pad takes the pairs from the last dim backwards
    pads = [v for i in reversed(range(x.dim()))
            for v in (p[2 * i], p[2 * i + 1])]
    return {"Out": torch.nn.functional.pad(
        x, pads, value=attrs.get("pad_value", 0.0))}


@register_op("crop")
def _crop(ctx, ins, attrs, op):
    x = ins["X"]
    offsets = attrs.get("offsets")
    shape = tuple(ins["Y"].shape) if ins.has("Y") else attrs.get("shape")
    return {"Out": x[tuple(slice(o, o + s)
                           for o, s in zip(offsets, shape))]}


@register_op("slice")
def _slice(ctx, ins, attrs, op):
    x = ins["Input"]
    slices = [slice(None)] * x.dim()
    for ax, st, en in zip(attrs.get("axes"), attrs.get("starts"),
                          attrs.get("ends")):
        slices[ax] = slice(st, en)
    return {"Out": x[tuple(slices)]}


@register_op("reverse")
def _reverse(ctx, ins, attrs, op):
    axis = attrs.get("axis")
    return {"Out": torch.flip(ins["X"], tuple(axis) if isinstance(
        axis, (list, tuple)) else (axis,))}


@register_op("shape", grad_maker=None)
def _shape(ctx, ins, attrs, op):
    """The input's shape as int64 (the desc records int32, as the JAX
    package's x32 inference does: ``lowering._X32``), written by fills
    on the device, so a captured step replays it."""
    x = ins["Input"]
    out = torch.empty((x.dim(),), dtype=torch.int64, device=ctx.device)
    for i, d in enumerate(x.shape):     # fills: no copy from the host
        out[i] = d
    return {"Out": out}


@register_op("arg_max", grad_maker=None)
def _arg_max(ctx, ins, attrs, op):
    # the first maximum, as jnp.argmax
    return {"Out": torch.argmax(ins["X"], dim=attrs.get("axis", -1))}


@register_op("arg_min", grad_maker=None)
def _arg_min(ctx, ins, attrs, op):
    return {"Out": torch.argmin(ins["X"], dim=attrs.get("axis", -1))}


@register_op("argsort", grad_maker=None)
def _argsort(ctx, ins, attrs, op):
    # stable, as jnp.argsort
    vals, idx = torch.sort(ins["X"], dim=attrs.get("axis", -1), stable=True)
    return {"Out": vals, "Indices": idx}


@register_op("one_hot", grad_maker=None)
def _one_hot(ctx, ins, attrs, op):
    """float32 [..., depth]; an index out of [0, depth) gives a row of
    zeros, as jax.nn.one_hot's."""
    x = ins["X"]
    depth = attrs.get("depth")
    flat = x.reshape(x.shape[:-1]) if x.shape[-1] == 1 else x
    classes = torch.arange(depth, device=x.device)
    return {"Out": (flat.long()[..., None] == classes).to(torch.float32)}


def fill_tensor(attrs, device, shape_of=None):
    """The constant a ``fill`` op's attrs hold, on ``device``."""
    dtype = proto_to_torch_dtype(attrs.get("dtype", DataType.FP32))
    shape = attrs.get("shape")
    if device.type == "meta":
        return torch.empty(shape, dtype=dtype, device=device)
    vals = np.asarray(attrs.get("value"), dtype=np.float32)
    return torch.from_numpy(vals.reshape(shape)).to(device=device,
                                                    dtype=dtype)


@register_op("fill", grad_maker=None)
def _fill(ctx, ins, attrs, op):
    """As assign_value: the prepared step's device constant, else made
    from the attrs."""
    const = ctx.constants.get(id(op)) if op is not None else None
    if const is not None:
        return {"Out": const}
    return {"Out": fill_tensor(attrs, ctx.device)}


# the ops whose output is a constant of their attrs (and of their
# inputs' static shapes, ``prior_box``'s: ops/detection.py adds it): a
# prepared step makes each one's value on the device once (step_graph),
# ``make(attrs, device, shape_of)``, ``shape_of(slot)`` the desc shape of
# the op's input in ``slot``; None where it cannot be made there
CONSTANT_OPS = {"assign_value": assign_value_tensor, "fill": fill_tensor}


@register_op("multiplex")
def _multiplex(ctx, ins, attrs, op):
    ids = ins["Ids"].reshape(-1).long()
    xs = torch.stack(list(ins.list("X")), dim=0)    # [K, N, D]
    rows = torch.arange(ids.shape[0], device=ids.device)
    return {"Out": xs[ids, rows]}


@register_op("bilinear_interp")
def _bilinear_interp(ctx, ins, attrs, op):
    """Align-corners bilinear resize of NCHW x to (out_h, out_w) (the
    attrs win over an OutSize input, as in the JAX package)."""
    x = ins["X"]
    oh, ow = attrs.get("out_h"), attrs.get("out_w")
    if ins.has("OutSize"):
        pass    # the attrs win, as in the JAX package (static shapes)
    n, c, h, w = x.shape
    ratio_h = (h - 1.0) / (oh - 1.0) if oh > 1 else 0.0
    ratio_w = (w - 1.0) / (ow - 1.0) if ow > 1 else 0.0
    hi = torch.arange(oh, device=x.device) * ratio_h
    wi = torch.arange(ow, device=x.device) * ratio_w
    h0, w0 = torch.floor(hi).long(), torch.floor(wi).long()
    h1 = torch.clamp_max(h0 + 1, h - 1)
    w1 = torch.clamp_max(w0 + 1, w - 1)
    lh = (hi - h0)[None, None, :, None]
    lw = (wi - w0)[None, None, None, :]
    v00 = x[:, :, h0][:, :, :, w0]
    v01 = x[:, :, h0][:, :, :, w1]
    v10 = x[:, :, h1][:, :, :, w0]
    v11 = x[:, :, h1][:, :, :, w1]
    out = (v00 * (1 - lh) * (1 - lw) + v01 * (1 - lh) * lw
           + v10 * lh * (1 - lw) + v11 * lh * lw)
    return {"Out": out}


@register_op("label_smooth")
def _label_smooth(ctx, ins, attrs, op):
    x = ins["X"]
    eps = attrs.get("epsilon", 0.0)
    if ins.has("PriorDist"):
        return {"Out": (1 - eps) * x + eps * ins["PriorDist"]}
    return {"Out": (1 - eps) * x + eps / x.shape[-1]}


@register_op("mean_iou", grad_maker=None)
def _mean_iou(ctx, ins, attrs, op):
    pred = ins["Predictions"].reshape(-1).long()
    label = ins["Labels"].reshape(-1).long()
    num = attrs.get("num_classes")
    cm = torch.zeros(num * num, dtype=torch.int64, device=pred.device)
    cm = cm.index_add(0, label * num + pred, torch.ones_like(pred))
    cm = cm.reshape(num, num)
    diag = torch.diagonal(cm)
    inter = diag.to(torch.float32)
    union = (cm.sum(0) + cm.sum(1)).to(torch.float32) - inter
    valid = union > 0
    iou = torch.where(valid, inter / torch.clamp_min(union, 1.0),
                      torch.zeros_like(inter))
    miou = iou.sum() / torch.clamp_min(valid.sum().to(torch.float32), 1.0)
    return {"OutMeanIou": miou.reshape(()),
            "OutWrong": (cm.sum(1) - diag).to(torch.int32),
            "OutCorrect": diag.to(torch.int32)}


@register_op("im2sequence")
def _im2sequence(ctx, ins, attrs, op):
    """Patches (reference im2sequence_op.cc), dense form: NCHW x to
    [N * OH * OW, C * kh * kw], channel-major features."""
    x = ins["X"]
    kh, kw = attrs.get("kernels")
    sh, sw = attrs.get("strides", [1, 1])
    p = attrs.get("paddings", [0, 0, 0, 0])
    xp = torch.nn.functional.pad(x, (p[1], p[3], p[0], p[2]))
    n, c = xp.shape[:2]
    cols = torch.nn.functional.unfold(xp, (kh, kw), stride=(sh, sw))
    return {"Out": cols.transpose(1, 2).reshape(-1, c * kh * kw)}


@register_op("random_crop", stateful=True, grad_maker=None)
def _random_crop(ctx, ins, attrs, op):
    """A crop of the trailing dims to ``shape`` at a start drawn per dim
    from the step's stream (the same start for the whole batch, as the
    JAX package's)."""
    x = ins["X"]
    shape = list(attrs.get("shape"))
    lead = x.dim() - len(shape)
    if ctx.device.type == "meta":
        out = torch.empty(tuple(x.shape[:lead]) + tuple(shape),
                          dtype=x.dtype, device=x.device)
        return {"Out": out, "SeedOut": ins.get("Seed")}
    gen = ctx.generator(attrs.get("seed", 0))
    out = x
    for i, s in enumerate(shape):
        limit = max(x.shape[lead + i] - s, 0)
        start = torch.randint(0, limit + 1, (), generator=gen,
                              device=x.device)
        idx = start + torch.arange(s, device=x.device)
        out = torch.index_select(out, lead + i, idx)
    return {"Out": out, "SeedOut": ins.get("Seed")}
