"""int8 weight-quantized matmul for the port's int8 serving tenants.

Counterpart of the int8 half of ``paddle_tpu/kernels/matmul_fused.py``:
``apply_act``, ``quantize_weight``, ``dequantize_weight`` and
``matmul_int8_dequant``.  The quantizer is host numpy and rounds
exactly as the reference's (``distributed/compress.quantize_symmetric``
along K, one f32 scale per (K-chunk, column)), so both packages serve
the same int8 bytes.

``matmul_int8_dequant`` wraps the hand-written CUDA kernel
``csrc/matmul_int8.cu`` with its plain PyTorch version
(``matmul_int8_reference``) beside it: a CPU tensor runs the plain
version, a CUDA tensor launches the kernel or raises.
``matmul_int8_dequant.launches`` counts kernel launches.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.compress import CHUNK, quantize_symmetric
from . import _build
from ._build import ptr, require, route, stream

__all__ = ["apply_act", "quantize_weight", "dequantize_weight",
           "matmul_int8_reference", "matmul_int8_dequant"]

_ACTS = {"": 0, "relu": 1, "gelu": 2}
_BK = 32   # the kernel's K tile depth (BK in csrc/matmul_int8.cu)


def apply_act(y, act):
    """The epilogue activation: '' / 'relu' / 'gelu' (tanh form, as the
    reference's ``jax.nn.gelu(approximate=True)``)."""
    if act == "relu":
        return torch.relu(y)
    if act == "gelu":
        return F.gelu(y, approximate="tanh")
    if act:
        raise ValueError("unsupported fused activation %r" % (act,))
    return y


def quantize_weight(w, chunk=None):
    """Quantize a [K, N] weight matrix int8, per-(K-chunk, column):
    returns numpy ``(q int8 [K, N], scales f32 [K//chunk, N], chunk)``.
    ``chunk`` defaults to ``CHUNK`` and clamps to a divisor of K (whole
    K when K does not divide) — the reference's rule."""
    w = np.ascontiguousarray(np.asarray(w), np.float32)
    k, n = w.shape
    chunk = int(chunk or CHUNK)
    chunk = min(chunk, k)
    if k % chunk:
        chunk = k
    nc = k // chunk
    cols = w.reshape(nc, chunk, n).transpose(0, 2, 1).reshape(-1, chunk)
    q, scales = quantize_symmetric(cols)
    q = q.reshape(nc, n, chunk).transpose(0, 2, 1).reshape(k, n)
    return np.ascontiguousarray(q), \
        np.ascontiguousarray(scales.reshape(nc, n)), chunk


def dequantize_weight(q, scales, chunk):
    """The [K, N] f32 weights ``quantize_weight``'s output reconstructs
    (torch tensors in, tensor out)."""
    k, n = q.shape
    nc = k // chunk
    return (q.float().reshape(nc, chunk, n)
            * scales.reshape(nc, 1, n)).reshape(k, n)


def matmul_int8_reference(x2, wq, scales, chunk, bias=None, residual=None,
                          act=""):
    """Plain version: dequantize, matmul, then + bias, act, + residual
    (the reference's XLA fallback order)."""
    y = torch.matmul(x2.float(), dequantize_weight(wq, scales, chunk))
    if bias is not None:
        y = y + bias
    y = apply_act(y, act)
    if residual is not None:
        y = y + residual
    return y


def matmul_int8_dequant(x2, wq, scales, chunk, bias=None, residual=None,
                        act=""):
    """``[M, K] @ dequant(int8 [K, N])`` with the bias/act/residual
    epilogue; float32 out."""
    extra = [t for t in (bias, residual) if t is not None]
    where = route(x2, wq, scales, *extra)
    require(x2.dim() == 2 and wq.dim() == 2, "want x [M, K], wq [K, N]")
    m, k = x2.shape
    k2, n = wq.shape
    chunk = int(chunk)
    require(k == k2, "x %s does not match wq %s"
            % (tuple(x2.shape), tuple(wq.shape)))
    require(chunk > 0 and k % chunk == 0, "chunk %d must divide K %d"
            % (chunk, k))
    require(tuple(scales.shape) == (k // chunk, n),
            "scales must be [K/chunk, N] = %r" % ((k // chunk, n),))
    require(x2.dtype == torch.float32 and wq.dtype == torch.int8
            and scales.dtype == torch.float32,
            "want x f32, wq int8, scales f32")
    require(bias is None or (tuple(bias.shape) == (n,)
                             and bias.dtype == torch.float32),
            "bias must be f32 [N]")
    require(residual is None or (tuple(residual.shape) == (m, n)
                                 and residual.dtype == torch.float32),
            "residual must be f32 [M, N]")
    require(act in _ACTS, "unsupported fused activation %r" % (act,))
    if where == "cpu":
        return matmul_int8_reference(x2, wq, scales, chunk, bias,
                                     residual, act)
    require(all(t.is_contiguous() for t in [x2, wq, scales] + extra),
            "int8 matmul kernel needs contiguous inputs")
    require(m > 0 and k % _BK == 0 and chunk % _BK == 0 and n % 4 == 0,
            "int8 matmul kernel needs K and chunk multiples of %d and "
            "N a multiple of 4" % _BK)
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    fn = _build.function(
        "matmul_int8", "matmul_int8_f32",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    null = ctypes.c_void_p(None)
    rc = fn(ptr(x2), ptr(wq), ptr(scales),
            ptr(bias) if bias is not None else null,
            ptr(residual) if residual is not None else null,
            ptr(out), m, n, k, chunk, _ACTS[act], stream())
    _build.check(rc, "matmul_int8")
    matmul_int8_dequant.launches += 1
    return out


matmul_int8_dequant.launches = 0
