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
kernel launches.  K4 and K5 take float32 or bfloat16 operands (the
fused LM under bf16 AMP); a bf16 call launches the kernel's bf16 form,
whose launches ``matmul_epilogue_bf16`` and ``add_ln_bf16`` count (K4's
bf16 form is the wgmma tile of ``csrc/wgmma_gemm.cuh``, which TMA
feeds: its operands must start on 16-byte boundaries).  K4
has two plain versions, as the reference has two numerics: the CPU path
``matmul_epilogue_reference`` rounds after every op (the reference's XLA
branch), the card's yardstick ``matmul_epilogue_f32acc_reference``
rounds once from the f32 accumulator (its Pallas kernel).  The reference's Pallas-only knobs (``config``,
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

__all__ = ["apply_act", "matmul_epilogue_reference",
           "matmul_epilogue_f32acc_reference", "matmul_epilogue",
           "matmul_epilogue_bf16", "ln_from_sum", "add_ln_reference",
           "add_ln", "add_ln_bf16", "quantize_weight",
           "dequantize_weight", "matmul_int8_reference",
           "matmul_int8_dequant", "tile_form"]

_ACTS = {"": 0, "relu": 1, "gelu": 2}
_SQRT_2_OVER_PI = (2.0 / np.pi) ** 0.5
_BK = 32   # the GEMM tile's K depth (Tile::BK in csrc/gemm_tile.cuh)
_LN_MAX_D = 1024   # add_ln_kernel keeps a row in one warp's registers
# the operand dtypes of K4 and K5: (C entry suffix, the multiple of
# elements a 16-byte copy carries, which K / N / D must be)
_FORMS = {torch.float32: ("f32", 4), torch.bfloat16: ("bf16", 8)}


def apply_act(y, act):
    """The epilogue activation: '' / 'relu' / 'gelu' (tanh form, as the
    reference's ``jax.nn.gelu(approximate=True)``).  relu is the
    reference's ``jnp.maximum(y, 0)``, whose derivative at y == 0 is 1/2
    (the fused grad differentiates it; bf16 pre-activations hit 0
    exactly).  Below float32 (a bf16 product under AMP) the tanh form
    runs op by op in y's dtype, each op rounding as the reference's
    does, its constant rounded to y's dtype too."""
    if act == "relu":
        return torch.maximum(y, y.new_zeros(()))
    if act == "gelu":
        if y.dtype in (torch.float32, torch.float64):
            return F.gelu(y, approximate="tanh")
        # torch.full, not torch.tensor: a fill on the device, where a
        # copy from the host could not be captured in a CUDA graph
        c = torch.full((), _SQRT_2_OVER_PI, dtype=y.dtype, device=y.device)
        return y * (0.5 * (1.0 + torch.tanh(c * (y + 0.044715 * y ** 3))))
    if act:
        raise ValueError("unsupported fused activation %r" % (act,))
    return y


def _kernel_operands(tensors, what):
    """The CUDA kernels here read contiguous, 16-byte aligned operands
    of one dtype, float32 or bfloat16 (16-byte loads); raise on anything
    else.  Returns that dtype."""
    dt = tensors[0].dtype
    require(dt in _FORMS and all(t.dtype == dt for t in tensors),
            "%s kernel takes all float32 or all bfloat16, got %s"
            % (what, [str(t.dtype) for t in tensors]))
    require(all(t.is_contiguous() and t.data_ptr() % 16 == 0
                for t in tensors),
            "%s kernel needs contiguous, 16-byte aligned operands" % what)
    return dt


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


def matmul_epilogue_f32acc_reference(x2, w, bias=None, residual=None,
                                     act="", out_dtype=None):
    """Plain version of the kernel's numerics (the reference's Pallas
    ``_matmul_kernel``): the product summed in float32 from operands
    widened exactly, + bias, act and + residual in float32, and ``pre``
    and ``out`` each rounded once to ``out_dtype`` (x's dtype by
    default).  The card's yardstick for K4; on no path.  Returns
    ``(out, pre)``."""
    out_dtype = out_dtype or x2.dtype
    y = torch.matmul(x2.float(), w.float())
    if bias is not None:
        y = y + bias.float()
    pre = y.to(out_dtype)
    y = apply_act(y, act)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype), pre


def matmul_epilogue(x2, w, bias=None, residual=None, act="", *,
                    save_preact=False, out_dtype=None):
    """``[M, K] @ [K, N]`` with + bias [N], act ('' / relu / tanh-gelu)
    and + residual [M, N] applied from the accumulator.  Returns ``out``
    or, with ``save_preact``, ``(out, pre)`` (pre = x @ w + bias, the
    saved residual the explicit grad lowering consumes).  The kernel
    takes x, w, bias and residual all float32 (K a multiple of 4) or all
    bfloat16 (K and N multiples of 8), writes x's dtype, and sums the
    product in float32 and runs the epilogue in float32 from the
    accumulator, rounding ``pre`` and ``out`` once each; any M and N."""
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
    dt = _kernel_operands([x2, w] + extra, "matmul epilogue")
    form, mult = _FORMS[dt]
    require(out_dtype in (None, dt),
            "matmul epilogue kernel writes its operands' dtype %s" % dt)
    require(m > 0 and n > 0 and k > 0 and k % mult == 0
            and (dt == torch.float32 or n % mult == 0),
            "matmul epilogue kernel (%s) needs K%s a multiple of %d, got "
            "K=%d N=%d" % (dt, "" if dt == torch.float32 else " and N",
                           mult, k, n))
    out = torch.empty((m, n), dtype=dt, device=x2.device)
    pre = torch.empty_like(out) if save_preact else None
    fn = _build.function(
        "matmul_fused", "matmul_epilogue_" + form,
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    null = ctypes.c_void_p(None)
    rc = fn(ptr(x2), ptr(w),
            ptr(bias) if bias is not None else null,
            ptr(residual) if residual is not None else null,
            ptr(out), ptr(pre) if pre is not None else null,
            m, n, k, _ACTS[act], stream())
    _build.check(rc, "matmul_epilogue")
    if dt == torch.bfloat16:
        _build.count(matmul_epilogue_bf16)
    else:
        _build.count(matmul_epilogue)
    return (out, pre) if save_preact else out


matmul_epilogue.launches = 0


def matmul_epilogue_bf16(x2, w, *args, **kw):
    """``matmul_epilogue`` on bfloat16 operands (the fused LM under AMP);
    its ``launches`` counts the bf16 form's launches, which
    ``matmul_epilogue`` makes for any bf16 call."""
    require(x2.dtype == torch.bfloat16 and w.dtype == torch.bfloat16,
            "want bfloat16 x and w")
    return matmul_epilogue(x2, w, *args, **kw)


matmul_epilogue_bf16.launches = 0


# ---------------------------------------------------------------------------
# K5: residual add + LayerNorm
# ---------------------------------------------------------------------------

def ln_from_sum(s, scale=None, bias=None, eps=1e-5, stats64=True):
    """The layer_norm lowering's order applied to an already-summed
    [M, D] input: f32 statistics (var = mean((s - mean)^2)), cast back to
    the input dtype BEFORE the normalize, scale / bias cast per use,
    each op of the normalize rounding to the input dtype.  The plain
    ``add_ln`` and the ``fused_add_ln`` grad replay (which
    differentiates this under autograd) share it.  Returns (out, mean,
    var) with mean / var [M].

    For a bfloat16 ``s`` the f32 statistics are taken from float64 sums
    (``stats64``): a row of bf16 values sums exactly in float64, so the
    f32 mean is the correctly rounded one in any summation order, and
    K5's bf16 form reproduces it bit for bit.  An f32 sum's last bit
    depends on the order, and rounding the statistics to bf16 turns that
    bit into a whole bf16 ulp of the mean in about one row in a
    thousand, which moves the row's normalized values by far more than
    an ulp.  The grad replay passes ``stats64=False``: its derivative
    does not need the forward's last bit, and float64 [M, D] tensors
    under autograd cost it four times the bytes."""
    if s.dtype == torch.bfloat16 and stats64:
        sd = s.double()
        mean = torch.mean(sd, dim=1, keepdim=True).float()
        var = torch.mean(torch.square(sd - mean.double()), dim=1,
                         keepdim=True).float()
    else:
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
    var), mean / var [M], all in x's dtype.  The kernel takes x and y
    both float32 (D a multiple of 4) or both bfloat16 (D a multiple of
    8), D up to 1024; scale and bias float32, or in the bf16 form
    float32 or bfloat16 (each is rounded to bf16 per use, as
    ``ln_from_sum`` does)."""
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
    dt = _kernel_operands([x2, y2], "add_ln")
    form, mult = _FORMS[dt]
    if dt == torch.bfloat16:
        # the bf16 form reads f32 scale / bias and rounds them itself;
        # a bf16 one widens exactly
        scale, bias = (t.float().contiguous() if t is not None else None
                       for t in (scale, bias))
    extra = [t for t in (scale, bias) if t is not None]
    require(all(t.dtype == torch.float32 and t.is_contiguous()
                and t.data_ptr() % 16 == 0 for t in extra),
            "add_ln kernel takes contiguous, 16-byte aligned float32 scale "
            "and bias")
    require(m > 0 and 0 < d <= _LN_MAX_D and d % mult == 0,
            "add_ln kernel (%s) needs D a multiple of %d up to %d, got %d"
            % (dt, mult, _LN_MAX_D, d))
    out = torch.empty((m, d), dtype=dt, device=x2.device)
    sm = torch.empty_like(out)
    mean = torch.empty((m,), dtype=dt, device=x2.device)
    var = torch.empty_like(mean)
    fn = _build.function(
        "matmul_fused", "add_ln_" + form,
        [ctypes.c_void_p] * 8 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                                 ctypes.c_void_p])
    null = ctypes.c_void_p(None)
    rc = fn(ptr(x2), ptr(y2),
            ptr(scale) if scale is not None else null,
            ptr(bias) if bias is not None else null,
            ptr(out), ptr(sm), ptr(mean), ptr(var), m, d, float(eps),
            stream())
    _build.check(rc, "add_ln")
    if dt == torch.bfloat16:
        _build.count(add_ln_bf16)
    else:
        _build.count(add_ln)
    return out, sm, mean, var


add_ln.launches = 0


def add_ln_bf16(x2, y2, *args, **kw):
    """``add_ln`` on bfloat16 x and y (the fused LM under AMP); its
    ``launches`` counts the bf16 form's launches, which ``add_ln`` makes
    for any bf16 call."""
    require(x2.dtype == torch.bfloat16 and y2.dtype == torch.bfloat16,
            "want bfloat16 x and y")
    return add_ln(x2, y2, *args, **kw)


add_ln_bf16.launches = 0


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
    _build.count(matmul_int8_dequant)
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
