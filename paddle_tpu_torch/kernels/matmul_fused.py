"""Fused matmul-stage kernels of the transformer block, and the int8
weight-quantized matmul of the int8 serving tenants.

Counterpart of ``paddle_tpu/kernels/matmul_fused.py``:

- ``matmul_epilogue`` (K4, ``csrc/matmul_fused.cu``): [M, K] @ [K, N]
  with the bias / activation / residual tail applied from the f32
  accumulator, and optionally the pre-activation as a second output;
- ``add_ln`` (K5, ``csrc/matmul_fused.cu``): LayerNorm(x + y) with the
  sum and the row statistics as outputs;
- ``matmul_int8_dequant`` (K8, ``csrc/matmul_int8.cu``) with
  ``quantize_weight`` / ``dequantize_weight``.  The quantizer is host
  numpy and rounds exactly as the reference's
  (``distributed/compress.quantize_symmetric`` along K, one f32 scale
  per (K-chunk, column)), so both packages serve the same int8 bytes.

Each kernel's wrapper has its plain PyTorch version beside it
(``matmul_epilogue_reference``, ``add_ln_reference``,
``matmul_int8_reference``): a CPU tensor runs the plain version, a CUDA
tensor launches the kernel or raises.  ``<wrapper>.launches`` counts
kernel launches.  The reference's Pallas-only knobs (``config``,
``force_xla``, ``interpret``: tile sizes and its XLA branch) have no
counterpart here.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.compress import CHUNK, quantize_symmetric
from . import _build
from ._build import ptr, require, route, stream

__all__ = ["apply_act", "matmul_epilogue_reference", "matmul_epilogue",
           "ln_from_sum", "add_ln_reference", "add_ln", "quantize_weight",
           "dequantize_weight", "matmul_int8_reference",
           "matmul_int8_dequant", "tile_form"]

_ACTS = {"": 0, "relu": 1, "gelu": 2}
_BK = 32   # the GEMM tile's K depth (Tile::BK in csrc/gemm_tile.cuh)
_LN_MAX_D = 1024   # add_ln_kernel keeps a row in one warp's registers


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


def _kernel_operands(tensors, what):
    """The CUDA kernels here read float32, contiguous, 16-byte aligned
    operands (float4 loads); raise on anything else."""
    require(all(t.dtype == torch.float32 for t in tensors),
            "%s kernel takes float32" % what)
    require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in tensors),
            "%s kernel needs contiguous, 16-byte aligned operands" % what)


# ---------------------------------------------------------------------------
# K4: matmul with the bias / activation / residual epilogue
# ---------------------------------------------------------------------------

def matmul_epilogue_reference(x2, w, bias=None, residual=None, act="",
                              out_dtype=None):
    """Plain version, in the order of the UNFUSED mul -> elementwise_add
    -> act -> elementwise_add chain.  Returns ``(out, pre)`` with pre =
    x @ w + bias, the activation's input."""
    out_dtype = out_dtype or x2.dtype
    y = torch.matmul(x2, w)
    if bias is not None:
        y = y + bias
    pre = y
    y = apply_act(y, act)
    if residual is not None:
        y = y + residual
    return y.to(out_dtype), pre


def matmul_epilogue(x2, w, bias=None, residual=None, act="", *,
                    save_preact=False, out_dtype=None):
    """``[M, K] @ [K, N]`` with + bias [N], act ('' / relu / tanh-gelu)
    and + residual [M, N] applied from the accumulator.  Returns ``out``
    or, with ``save_preact``, ``(out, pre)`` (pre = x @ w + bias, the
    saved residual the explicit grad lowering consumes).  The kernel
    takes float32 and K a multiple of 4; any M and N."""
    extra = [t for t in (bias, residual) if t is not None]
    where = route(x2, w, *extra)
    require(x2.dim() == 2 and w.dim() == 2, "want x [M, K], w [K, N]")
    m, k = x2.shape
    k2, n = w.shape
    require(k == k2, "x %s does not match w %s"
            % (tuple(x2.shape), tuple(w.shape)))
    require(bias is None or tuple(bias.shape) == (n,), "bias must be [N]")
    require(residual is None or tuple(residual.shape) == (m, n),
            "residual must be [M, N] = %r" % ((m, n),))
    require(act in _ACTS, "unsupported fused activation %r" % (act,))
    if where == "cpu":
        y, pre = matmul_epilogue_reference(x2, w, bias, residual, act,
                                           out_dtype)
        return (y, pre.to(y.dtype)) if save_preact else y
    _kernel_operands([x2, w] + extra, "matmul epilogue")
    require(out_dtype in (None, torch.float32),
            "matmul epilogue kernel writes float32")
    require(m > 0 and n > 0 and k > 0 and k % 4 == 0,
            "matmul epilogue kernel needs K a multiple of 4, got %d" % k)
    out = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    pre = torch.empty_like(out) if save_preact else None
    fn = _build.function(
        "matmul_fused", "matmul_epilogue_f32",
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    null = ctypes.c_void_p(None)
    rc = fn(ptr(x2), ptr(w),
            ptr(bias) if bias is not None else null,
            ptr(residual) if residual is not None else null,
            ptr(out), ptr(pre) if pre is not None else null,
            m, n, k, _ACTS[act], stream())
    _build.check(rc, "matmul_epilogue")
    matmul_epilogue.launches += 1
    return (out, pre) if save_preact else out


matmul_epilogue.launches = 0


# ---------------------------------------------------------------------------
# K5: residual add + LayerNorm
# ---------------------------------------------------------------------------

def ln_from_sum(s, scale=None, bias=None, eps=1e-5):
    """The layer_norm lowering's order applied to an already-summed
    [M, D] input: f32 statistics (var = mean((s - mean)^2)), cast back to
    the input dtype BEFORE the normalize, scale / bias cast per use.
    The plain ``add_ln`` and the ``fused_add_ln`` grad replay (which
    differentiates this under autograd) share it.  Returns (out, mean,
    var) with mean / var [M]."""
    sf = s.float()
    mean = torch.mean(sf, dim=1, keepdim=True)
    var = torch.mean(torch.square(sf - mean), dim=1, keepdim=True)
    mean = mean.to(s.dtype)
    var = var.to(s.dtype)
    yn = (s - mean) * torch.rsqrt(var + eps)
    if scale is not None:
        yn = yn * scale.to(s.dtype)[None, :]
    if bias is not None:
        yn = yn + bias.to(s.dtype)[None, :]
    return yn, mean[:, 0], var[:, 0]


def add_ln_reference(x2, y2, scale=None, bias=None, eps=1e-5):
    """Plain version: elementwise_add, then ``ln_from_sum``.  Returns
    (out, sum, mean, var) with mean / var [M]."""
    s = x2 + y2
    yn, mean, var = ln_from_sum(s, scale, bias, eps)
    return yn, s, mean, var


def add_ln(x2, y2, scale=None, bias=None, eps=1e-5):
    """LayerNorm(x + y) over the rows of [M, D]: returns (out, sum, mean,
    var), mean / var [M].  The kernel takes float32 and D a multiple of
    4 up to 1024."""
    extra = [t for t in (scale, bias) if t is not None]
    where = route(x2, y2, *extra)
    require(x2.dim() == 2 and tuple(y2.shape) == tuple(x2.shape),
            "want x, y [M, D], got %s and %s"
            % (tuple(x2.shape), tuple(y2.shape)))
    m, d = x2.shape
    require(all(tuple(t.shape) == (d,) for t in extra),
            "scale / bias must be [D] = [%d]" % d)
    if where == "cpu":
        return add_ln_reference(x2, y2, scale, bias, eps)
    _kernel_operands([x2, y2] + extra, "add_ln")
    require(m > 0 and 0 < d <= _LN_MAX_D and d % 4 == 0,
            "add_ln kernel needs D a multiple of 4 up to %d, got %d"
            % (_LN_MAX_D, d))
    out = torch.empty((m, d), dtype=torch.float32, device=x2.device)
    sm = torch.empty_like(out)
    mean = torch.empty((m,), dtype=torch.float32, device=x2.device)
    var = torch.empty_like(mean)
    fn = _build.function(
        "matmul_fused", "add_ln_f32",
        [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_void_p])
    null = ctypes.c_void_p(None)
    rc = fn(ptr(x2), ptr(y2),
            ptr(scale) if scale is not None else null,
            ptr(bias) if bias is not None else null,
            ptr(out), ptr(sm), ptr(mean), ptr(var), m, d, float(eps),
            stream())
    _build.check(rc, "add_ln")
    add_ln.launches += 1
    return out, sm, mean, var


add_ln.launches = 0


# ---------------------------------------------------------------------------
# K8: int8 weight-quantized matmul
# ---------------------------------------------------------------------------

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
    require(all(t.data_ptr() % 16 == 0 for t in [x2, wq, scales] + extra),
            "int8 matmul kernel needs 16-byte aligned inputs")
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


def tile_form(kernel, m, n):
    """The form the CUDA launcher of ``kernel`` ('matmul_epilogue', K4,
    or 'matmul_int8', K8) runs for an [m, n] output: 'tile BMxBN' (the
    split-TF32 GEMM tile's shape) or 'decode' (K8 at M <= 16), as the
    launcher itself decides (from the card's SM count)."""
    require(kernel in ("matmul_epilogue", "matmul_int8"),
            "no tile form for %r" % (kernel,))
    fn = _build.function(
        "matmul_fused" if kernel == "matmul_epilogue" else "matmul_int8",
        kernel + "_tile",
        [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
         ctypes.POINTER(ctypes.c_int)])
    bm, bn = ctypes.c_int(), ctypes.c_int()
    _build.check(fn(m, n, ctypes.byref(bm), ctypes.byref(bn)), kernel)
    return "tile %dx%d" % (bm.value, bn.value) if bm.value else "decode"
