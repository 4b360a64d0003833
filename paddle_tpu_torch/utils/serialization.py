"""Tensor file format used by the save / load ops and checkpoints.

Counterpart of ``paddle_tpu/utils/serialization.py``, in the same
format, so a file written by either package loads in the other and the
same tensor gives the same bytes in both.  Format (little-endian):

  magic  b"PTPU"
  u32    version (=1)
  u32    proto dtype
  u32    ndim
  i64[n] dims
  bytes  raw row-major data

A combined file is a u32 count, then per tensor a u32 name length, the
utf-8 name and the tensor as above.

Values go in as numpy arrays or torch tensors (on any device) and come
out as numpy arrays, or as CPU torch tensors with ``as_torch=True``.
bfloat16 goes through torch: its bits are written from an int16 view
and read back as ``torch.bfloat16``, so no numpy bfloat16 (ml_dtypes)
is needed; a numpy read of a bf16 tensor needs ml_dtypes.  A 0-d value
is written with dims [1], as the JAX package writes it
(``np.ascontiguousarray`` gives every array at least one dimension), so
it reads back with shape [1] in both packages.
"""
from __future__ import annotations

import struct

import numpy as np
import torch

from paddle_tpu_torch.core.types import (DataType, np_dtype_to_proto,
                                         proto_to_np_dtype,
                                         proto_to_torch_dtype)

__all__ = ["tensor_to_bytes", "tensor_from_bytes", "save_tensor",
           "load_tensor", "save_combined", "load_combined"]

_MAGIC = b"PTPU"
_VERSION = 1


def _parts(value):
    """(header bytes, contiguous numpy payload) of one tensor."""
    if isinstance(value, torch.Tensor):
        t = value.detach()
        proto = np_dtype_to_proto(t.dtype)
        shape = tuple(t.shape) or (1,)
        t = t.cpu().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        data = t.reshape(shape).numpy()
    else:
        data = np.asarray(value)
        proto = np_dtype_to_proto(data.dtype)
        data = np.ascontiguousarray(data.reshape(data.shape or (1,)))
    header = struct.pack("<4sII", _MAGIC, _VERSION, proto) + \
        struct.pack("<I", data.ndim) + \
        struct.pack("<%dq" % data.ndim, *data.shape)
    return header, data


def _write(f, value):
    header, data = _parts(value)
    f.write(header)
    if data.size:
        f.write(memoryview(data.reshape(-1)).cast("B"))
    return len(header) + data.nbytes


def tensor_to_bytes(value):
    header, data = _parts(value)
    return header + data.tobytes()


def tensor_from_bytes(buf, offset=0, as_torch=False):
    """(value, offset past it) of the tensor at ``offset`` of ``buf``."""
    magic, version, proto = struct.unpack_from("<4sII", buf, offset)
    if magic != _MAGIC:
        raise ValueError("bad tensor magic %r" % magic)
    if version != _VERSION:
        raise ValueError("unsupported tensor version %d" % version)
    offset += 12
    (ndim,) = struct.unpack_from("<I", buf, offset)
    offset += 4
    dims = struct.unpack_from("<%dq" % ndim, buf, offset)
    offset += 8 * ndim
    count = int(np.prod(dims)) if ndim else 1
    bf16 = proto == DataType.BF16
    if bf16 and not as_torch:
        np_dtype = proto_to_np_dtype(proto)   # raises without ml_dtypes
    else:
        np_dtype = np.dtype(np.int16) if bf16 else proto_to_np_dtype(proto)
    arr = np.frombuffer(buf, dtype=np_dtype, count=count,
                        offset=offset).reshape(dims)
    offset += arr.nbytes
    if not as_torch:
        return arr.copy(), offset
    t = torch.from_numpy(arr.copy())
    if bf16:
        t = t.view(proto_to_torch_dtype(proto))
    return t, offset


def save_tensor(path, value):
    """Write one tensor to ``path``; returns the bytes written."""
    with open(path, "wb") as f:
        return _write(f, value)


def load_tensor(path, as_torch=False):
    with open(path, "rb") as f:
        value, _ = tensor_from_bytes(f.read(), as_torch=as_torch)
    return value


def save_combined(path, names_values):
    """Write ``[(name, tensor), ...]`` to one file; returns the bytes
    written."""
    with open(path, "wb") as f:
        n = f.write(struct.pack("<I", len(names_values)))
        for name, value in names_values:
            nb = name.encode("utf-8")
            n += f.write(struct.pack("<I", len(nb)) + nb)
            n += _write(f, value)
    return n


def load_combined(path, as_torch=False):
    with open(path, "rb") as f:
        buf = f.read()
    (n,) = struct.unpack_from("<I", buf, 0)
    offset = 4
    result = []
    for _ in range(n):
        (ln,) = struct.unpack_from("<I", buf, offset)
        offset += 4
        name = buf[offset:offset + ln].decode("utf-8")
        offset += ln
        value, offset = tensor_from_bytes(buf, offset, as_torch=as_torch)
        result.append((name, value))
    return result
