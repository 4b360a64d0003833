"""SelectedRows: the sparse row-subset gradient.

Counterpart of ``paddle_tpu/core/selected_rows.py`` (reference
framework/selected_rows.h:30): a (rows, values) pair whose ``rows``
index into a logical [height, ...] tensor.  ``lookup_table_grad`` makes
one when ``is_sparse=True``; ``scale`` and ``sum`` keep it sparse, and
the optimizer ops update only the rows it names (``sgd``, ``adam``) or
densify it (``momentum``).

``rows`` keeps a static length K (the looked-up ids, duplicates
included), as in the JAX package, so a captured step keeps its shapes:
duplicates are merged by a scatter-add or by :func:`merge_rows` (a sort
and a segment sum at length K), never by ``torch.unique``, whose size
depends on the data.  XLA drops an out-of-bounds scatter update; torch
raises a device-side assert instead, so the inactive slots that
``merge_rows`` points at row == height are masked explicitly
(:func:`scatter_set`).  Every scatter-add here and in the ops goes
through :func:`add_rows`, so duplicates sum in one order on every run.
"""
from __future__ import annotations

import torch


class SelectedRows:
    __slots__ = ("rows", "values", "height")

    def __init__(self, rows, values, height):
        self.rows = rows          # [K] int64 row indices (dups allowed)
        self.values = values      # [K, ...] per-row values
        self.height = int(height)  # dim 0 of the dense tensor

    @property
    def dense_shape(self):
        return (self.height,) + tuple(self.values.shape[1:])

    @property
    def device(self):
        return self.values.device

    def to_dense(self):
        """Scatter-add into the dense [height, ...] tensor (duplicate
        rows accumulate)."""
        dense = torch.zeros(self.dense_shape, dtype=self.values.dtype,
                            device=self.values.device)
        return add_rows(dense, self.rows, self.values)

    def scale(self, factor):
        return SelectedRows(self.rows, self.values * factor, self.height)

    def to(self, device):
        return SelectedRows(self.rows.to(device), self.values.to(device),
                            self.height)

    def clone(self):
        return SelectedRows(self.rows.clone(), self.values.clone(),
                            self.height)

    def __repr__(self):
        return "SelectedRows(rows=%s, values=%s, height=%d)" % (
            tuple(self.rows.shape), tuple(self.values.shape), self.height)


def add_rows(dst, rows, vals):
    """``dst`` with ``vals`` added in place at ``rows`` along dim 0,
    duplicate rows summed in the same order at every call: on CUDA
    ``index_put_`` with ``accumulate`` (a kernel that sorts the rows and
    sums each row's values in their order), on the CPU ``scatter_add_``
    (one pass over the rows in order, the JAX package's serial order;
    the CPU's ``index_put_`` splits the rows over threads).
    ``index_add_`` adds them on CUDA with atomics, in whatever order
    they land, so an f32 sum's last bits change from run to run, where
    the JAX package's scatter-add gives the same bits every time."""
    if dst.device.type == "cpu":
        idx = rows.long().reshape((-1,) + (1,) * (vals.dim() - 1)).expand_as(
            vals)
        return dst.scatter_add_(0, idx, vals)
    return dst.index_put_((rows,), vals, accumulate=True)


def concat_rows(srs):
    """Sum of several SelectedRows over the same dense shape: their rows
    and values concatenated (scatter-add makes the concatenation a
    sum)."""
    if len({s.height for s in srs}) != 1:
        raise ValueError("concat_rows over different heights %s"
                         % sorted({s.height for s in srs}))
    return SelectedRows(torch.cat([s.rows for s in srs], 0),
                        torch.cat([s.values for s in srs], 0),
                        srs[0].height)


def merge_rows(sr):
    """Merge duplicate rows by summation at the static length K
    (reference math::scatter::MergeAdd): the merged rows in ascending
    order in the first slots, each with the sum of its values; the
    inactive slots point at row == height, with zero values."""
    k = sr.rows.shape[0]
    if k == 0:
        return sr
    r, order = torch.sort(sr.rows, stable=True)
    v = sr.values[order]
    is_start = torch.ones(k, dtype=torch.bool, device=r.device)
    if k > 1:
        is_start[1:] = r[1:] != r[:-1]
    seg = torch.cumsum(is_start.to(torch.int64), 0) - 1     # [K] segments
    merged = add_rows(torch.zeros_like(v), seg, v)
    # every slot of a segment holds the same row, so the scatter's
    # duplicate writes agree
    rows_m = torch.full((k,), sr.height, dtype=r.dtype,
                        device=r.device).scatter(0, seg, r)
    return SelectedRows(rows_m, merged, sr.height)


def gather_rows(t, sr):
    """``t``'s rows at the slots of merged ``sr``, the inactive slots
    (row == height) reading row 0: safe gather indices, whose values
    ``scatter_set`` drops."""
    return t[torch.where(sr.rows < sr.height, sr.rows,
                         torch.zeros_like(sr.rows))]


def scatter_set(t, sr, vals):
    """``t`` with the rows of merged ``sr`` set to ``vals``.  XLA drops
    the inactive slots' out-of-bounds updates; here they land in one
    scratch row past the end, which is cut off."""
    pad = torch.cat([t, t[:1]], 0)
    return pad.index_copy_(0, sr.rows, vals.to(t.dtype))[:sr.height]
