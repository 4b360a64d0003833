"""LoDTensor: dense data + Level-of-Detail ragged-sequence offsets.

A copy of ``paddle_tpu/core/lod.py`` (numpy only; the port imports
nothing of the JAX package).  Parity: reference
framework/lod_tensor.h:58-110.  The LoD (an offset table per nesting
level) stays on the host; the executor pads the concatenated data into
a dense [N, T, ...] tensor and puts it, with '<name>@LEN' lengths, on
the device (``core/executor_impl._prepare_lod_feeds``), where the
sequence ops (``ops/sequence.py``) mask by those lengths.
"""
from __future__ import annotations

import numpy as np


class LoDTensor:
    __slots__ = ("data", "lod")

    def __init__(self, data, lod=None):
        self.data = data
        # lod: list of offset lists, e.g. [[0, 2, 5]] = two seqs len 2 and 3
        self.lod = [list(l) for l in (lod or [])]

    @property
    def shape(self):
        return tuple(np.shape(self.data))

    @property
    def dtype(self):
        return np.asarray(self.data).dtype

    def lod_level(self):
        return len(self.lod)

    def sequence_lengths(self, level=-1):
        offs = self.lod[level]
        return [offs[i + 1] - offs[i] for i in range(len(offs) - 1)]

    def num_sequences(self, level=0):
        return len(self.lod[level]) - 1

    def __array__(self, dtype=None):
        arr = np.asarray(self.data)
        return arr.astype(dtype) if dtype is not None else arr

    def __repr__(self):
        return "LoDTensor(shape=%s, lod=%s)" % (self.shape, self.lod)

    def to_padded(self, pad_value=0.0, max_len=None):
        """[sum_T, D...] + lod -> ([N, max_len, D...], [N] lengths).
        The ragged->dense bucketing bridge to static shapes."""
        data = np.asarray(self.data)
        lens = self.sequence_lengths(0)
        n = len(lens)
        t = max_len or (max(lens) if lens else 0)
        out = np.full((n, t) + data.shape[1:], pad_value, dtype=data.dtype)
        offs = self.lod[0]
        for i in range(n):
            seq = data[offs[i]:offs[i + 1]]
            out[i, : len(seq)] = seq[:t]
        return out, np.asarray(lens, dtype=np.int64)

    @staticmethod
    def from_sequences(seqs):
        """Build from a list of [T_i, D...] arrays (level-1 LoD)."""
        seqs = [np.asarray(s) for s in seqs]
        offs = [0]
        for s in seqs:
            offs.append(offs[-1] + len(s))
        data = (np.concatenate(seqs, axis=0) if seqs
                else np.zeros((0,), np.float32))
        return LoDTensor(data, [offs])

    def to_padded_2level(self, pad_value=0.0, max_seq=None,
                         max_word=None):
        """Level-2 LoD -> ([N, S, W, D...], outer_lens [N],
        inner_lens [N, S]).  N sentences of up to S sub-sequences of up
        to W tokens — the nested analog of :meth:`to_padded` (reference
        lod_tensor.h:58 hierarchical LoD).  max_seq/max_word truncate
        (lengths report the truncated sizes)."""
        if len(self.lod) != 2:
            raise NotImplementedError(
                "to_padded_2level needs exactly a level-2 LoD, got "
                "%d levels" % len(self.lod))
        data = np.asarray(self.data)
        outer, inner = self.lod[0], self.lod[1]
        n = len(outer) - 1
        outer_lens = [outer[i + 1] - outer[i] for i in range(n)]
        s = max_seq or (max(outer_lens) if outer_lens else 0)
        inner_lens_all = [inner[j + 1] - inner[j]
                          for j in range(len(inner) - 1)]
        w = max_word or (max(inner_lens_all) if inner_lens_all else 0)
        out = np.full((n, s, w) + data.shape[1:], pad_value,
                      dtype=data.dtype)
        inner_lens = np.zeros((n, s), np.int64)
        for i in range(n):
            for si, j in enumerate(range(outer[i], outer[i + 1])):
                if si >= s:
                    break                     # truncated by max_seq
                seq = data[inner[j]:inner[j + 1]][:w]
                out[i, si, : len(seq)] = seq
                inner_lens[i, si] = len(seq)  # post-truncation length
        outer_clipped = np.minimum(np.asarray(outer_lens, np.int64), s)
        return out, outer_clipped, inner_lens

    def to_padded_klevel(self, pad_value=0.0, max_dims=None):
        """Arbitrary-depth LoD -> (padded [N, S1, ..., S_{k-1}, D...],
        [lens_0 [N], lens_1 [N,S1], ..., lens_{k-1} [N,..,S_{k-2}]]).

        The general form of :meth:`to_padded` / :meth:`to_padded_2level`
        — the reference LoD is a vector of levels with no depth cap
        (framework/lod_tensor.h:58-110).  Level j's segments nest inside
        level j-1's; the padded array gains one dense dim per level
        (level 0's fan-out is the batch dim N; the deepest level is the
        time dim).  ``max_dims`` (one entry per level: [cap_1, ...,
        cap_{k-1}, cap_time]) truncates; lengths report post-truncation
        sizes."""
        k = len(self.lod)
        if k == 0:
            raise ValueError("to_padded_klevel needs a LoD")
        data = np.asarray(self.data)
        seg_lens = [self.sequence_lengths(j) for j in range(k)]
        # dims[j] = padded fan-out OF level j (max segment length);
        # dims[0].. dims[k-1] become the S1..S_{k-1},W dims
        dims = [max(l, default=1) or 1 for l in seg_lens]
        if max_dims is not None:
            dims = [md or d for md, d in zip(max_dims, dims)]
        n = len(seg_lens[0])
        out = np.full((n,) + tuple(dims) + data.shape[1:], pad_value,
                      dtype=data.dtype)
        # lens_arrays[j] indexes by the j+1 leading dims of `out`
        lens_arrays = [np.zeros((n,) + tuple(dims[:j]), np.int64)
                       for j in range(k)]

        def fill(level, seg, idx):
            length = seg_lens[level][seg]
            if level == k - 1:      # deepest: segments are data rows
                start = self.lod[level][seg]
                used = min(length, dims[level])
                out[idx + (slice(0, used),)] = data[start:start + used]
                lens_arrays[level][idx] = used
                return
            kids_start = self.lod[level][seg]
            used = min(length, dims[level])
            lens_arrays[level][idx] = used
            for si in range(used):
                fill(level + 1, kids_start + si, idx + (si,))

        for i in range(n):
            fill(0, i, (i,))
        return out, lens_arrays

    @staticmethod
    def from_padded_klevel(padded, lens_arrays):
        """Inverse of :meth:`to_padded_klevel`."""
        padded = np.asarray(padded)
        k = len(lens_arrays)
        lod = [[0] for _ in range(k)]
        parts = []

        def walk(level, idx):
            length = int(np.asarray(lens_arrays[level])[idx])
            lod[level].append(lod[level][-1] + length)
            if level == k - 1:
                parts.append(padded[idx][:length])
                return
            for si in range(length):
                walk(level + 1, idx + (si,))

        for i in range(np.shape(lens_arrays[0])[0]):
            walk(0, (i,))
        # structural dims are [N, S1..S_{k-1}, W] = k+1; features follow
        # (fresh zeros: reshape can't shrink a nonempty padded block)
        data = (np.concatenate(parts, axis=0) if parts
                else np.zeros((0,) + padded.shape[k + 1:], padded.dtype))
        return LoDTensor(data, lod)

    @staticmethod
    def from_padded_2level(padded, outer_lens, inner_lens):
        """Inverse of :meth:`to_padded_2level`."""
        padded = np.asarray(padded)
        outer_lens = np.asarray(outer_lens).reshape(-1)
        inner_lens = np.asarray(inner_lens)
        parts = []
        outer_offs, inner_offs = [0], [0]
        for i, ol in enumerate(outer_lens):
            outer_offs.append(outer_offs[-1] + int(ol))
            for si in range(int(ol)):
                il = int(inner_lens[i, si])
                inner_offs.append(inner_offs[-1] + il)
                parts.append(padded[i, si, :il])
        data = (np.concatenate(parts, axis=0) if parts
                else np.zeros((0,) + padded.shape[3:], padded.dtype))
        return LoDTensor(data, [outer_offs, inner_offs])

    @staticmethod
    def from_padded(padded, lengths):
        padded = np.asarray(padded)
        lengths = [int(l) for l in np.asarray(lengths).reshape(-1)]
        parts = [padded[i, :l] for i, l in enumerate(lengths)]
        data = (np.concatenate(parts, axis=0) if parts
                else np.zeros((0,) + padded.shape[2:], padded.dtype))
        offs = [0]
        for l in lengths:
            offs.append(offs[-1] + l)
        return LoDTensor(data, [offs])
