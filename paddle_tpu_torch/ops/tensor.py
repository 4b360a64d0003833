"""Tensor manipulation ops.

Counterpart of ``paddle_tpu/ops/tensor.py`` for the ops ported so far.
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


@register_op("top_k", grad_maker=None, infer_shape=_top_k_infer)
def _top_k(ctx, ins, attrs, op):
    vals, idx = torch.topk(ins["X"], attrs.get("k", 1), dim=-1)
    return {"Out": vals, "Indices": idx}


@register_op("assign")
def _assign(ctx, ins, attrs, op):
    return {"Out": ins["X"]}


@register_op("assign_value", grad_maker=None)
def _assign_value(ctx, ins, attrs, op):
    dtype = proto_to_torch_dtype(attrs.get("dtype", DataType.FP32))
    shape = attrs.get("shape")
    if attrs.get("fp32_values"):
        vals = np.asarray(attrs["fp32_values"], dtype=np.float32)
    else:
        vals = np.asarray(attrs.get("int32_values", []), dtype=np.int32)
    if ctx.device.type == "meta":
        return {"Out": torch.empty(shape, dtype=dtype, device=ctx.device)}
    return {"Out": torch.from_numpy(vals.reshape(shape)).to(
        device=ctx.device, dtype=dtype)}


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
