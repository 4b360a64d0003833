"""The arithmetic of the port's GEMM tile (``csrc/gemm_tile.cuh``: K4,
and K8's prefill form), emulated in torch on the CPU and held against
the JAX package's ``matmul_epilogue`` and ``matmul_int8_dequant`` (their
XLA path on the CPU) on the same numpy inputs.

The emulation follows the kernel: an f32 operand splits into hi =
TF32 round-to-nearest-away (``cvt.rna.tf32.f32``) and lo = x - hi, of
which the MMA reads only the TF32 part (lo truncated); a product is
lo*hi + hi*lo + hi*hi for f32 weights (three MMAs) and x_lo*q + x_hi*q
for int8 ones (two: q is exact in TF32).  Each 32-deep K tile sums in a
fresh fragment (here exactly, in float64, then rounded to f32 once) and
joins the f32 accumulator by an f32 add, or for int8 by an FMA with the
tile's chunk scale.  The epilogue is the plain version's.

Tolerance atol = rtol = 1e-4, the card tests' and ``chip_smoke.py``'s.
The negative case shows the bar separates the schemes: single-pass TF32
(both operands rounded, one MMA) misses it at K = 4096.  The kernels
themselves run only on the card (``tests/test_torch_cuda.py``).
"""
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import matmul_fused as jmm
from paddle_tpu_torch.kernels import matmul_fused as pmm

TOL = dict(atol=1e-4, rtol=1e-4)
BK = 32          # the tile's K depth
M, N = 64, 256


def _tf32_rna(x):
    """Round f32 to TF32 (10 mantissa bits), ties away from zero."""
    u = x.view(torch.int32)
    return ((u + 0x1000) & ~0x1FFF).view(torch.float32)


def _tf32_trunc(x):
    """The TF32 part of an f32 operand as the MMA reads it."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _split(x):
    """The kernel's split: hi = x rounded to TF32, lo = x - hi (exact),
    of which the MMA reads the TF32 part."""
    hi = _tf32_rna(x)
    return hi, _tf32_trunc(x - hi)


def _tile_partials(pairs):
    """[K / BK, M, N] float64 sums of each K tile's products over the
    (a, b) operand pairs (the MMAs of a product)."""
    m, k = pairs[0][0].shape
    n = pairs[0][1].shape[1]
    out = torch.zeros(k // BK, m, n, dtype=torch.float64)
    for a, b in pairs:
        out += torch.einsum("mtk,tkn->tmn",
                            a.double().reshape(m, k // BK, BK),
                            b.double().reshape(k // BK, BK, n))
    return out


def _epilogue(y, bias, res, act):
    if bias is not None:
        y = y + bias
    y = pmm.apply_act(y, act)
    return y if res is None else y + res


def emulate_f32(x, w, bias=None, res=None, act="", single_pass=False):
    """K4's sums: split-TF32, three MMAs a product, a fresh fragment a K
    tile added in f32 (single_pass: one MMA of the rounded operands)."""
    (xh, xl), (wh, wl) = _split(x), _split(w)
    pairs = [(xh, wh)] if single_pass else [(xl, wh), (xh, wl), (xh, wh)]
    parts = _tile_partials(pairs)
    acc = torch.zeros(x.shape[0], w.shape[1], dtype=torch.float32)
    for p in parts.float():
        acc = acc + p
    return _epilogue(acc, bias, res, act)


def emulate_int8(x, q, scales, chunk, bias=None, res=None, act="",
                 single_pass=False):
    """K8's prefill sums: x split, q exact, two MMAs a product, each K
    tile's f32 partial times its chunk's scale row into the f32
    accumulator by one FMA (single_pass: x rounded, one MMA)."""
    xh, xl = _split(x)
    qf = q.float()
    pairs = [(xh, qf)] if single_pass else [(xl, qf), (xh, qf)]
    parts = _tile_partials(pairs).float()
    acc = torch.zeros(x.shape[0], q.shape[1], dtype=torch.float32)
    for kt, p in enumerate(parts):
        s = scales[kt * BK // chunk]
        acc = (acc.double() + s.double() * p.double()).float()   # FMA
    return _epilogue(acc, bias, res, act)


def _operands(seed, k):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, k).astype(np.float32)
    w = (rng.randn(k, N) * k ** -0.5).astype(np.float32)
    bias = rng.randn(N).astype(np.float32)
    res = rng.randn(M, N).astype(np.float32)
    return x, w, bias, res


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


EPILOGUES = [("", False, False), ("relu", True, False),
             ("gelu", True, True)]


@pytest.mark.parametrize("act,with_bias,with_res", EPILOGUES)
@pytest.mark.parametrize("k", [1024, 4096])
def test_split_tf32_gemm_matches_jax_matmul_epilogue(k, act, with_bias,
                                                     with_res):
    x, w, bias, res = _operands(0, k)
    bias = bias if with_bias else None
    res = res if with_res else None
    want = np.array(jmm.matmul_epilogue(x, w, bias, res, act))
    got = emulate_f32(_t(x), _t(w), _t(bias), _t(res), act)
    torch.testing.assert_close(got, torch.from_numpy(want), **TOL)


@pytest.mark.parametrize("act,with_bias,with_res", EPILOGUES)
@pytest.mark.parametrize("k,chunk", [(1024, None), (4096, None),
                                     (4096, 256)])
def test_split_tf32_int8_gemm_matches_jax_matmul_int8(k, chunk, act,
                                                      with_bias, with_res):
    x, w, bias, res = _operands(1, k)
    bias = bias if with_bias else None
    res = res if with_res else None
    q, s, ch = jmm.quantize_weight(w, chunk=chunk)
    assert ch == (chunk or min(2048, k)) and ch % BK == 0
    want = np.array(jmm.matmul_int8_dequant(x, q, s, ch, bias, res, act))
    got = emulate_int8(_t(x), _t(q), _t(s), ch, _t(bias), _t(res), act)
    torch.testing.assert_close(got, torch.from_numpy(want), **TOL)


@pytest.mark.parametrize("form", ["f32", "int8"])
def test_single_pass_tf32_misses_the_bar_at_k4096(form):
    """The guard tells the schemes apart: at K = 4096 single-pass TF32
    misses atol = rtol = 1e-4 where split-TF32 meets it."""
    x, w, _, _ = _operands(2, 4096)
    if form == "f32":
        want = torch.from_numpy(np.array(jmm.matmul_epilogue(x, w)))
        split = emulate_f32(_t(x), _t(w))
        single = emulate_f32(_t(x), _t(w), single_pass=True)
    else:
        q, s, ch = jmm.quantize_weight(w)
        want = torch.from_numpy(np.array(
            jmm.matmul_int8_dequant(x, q, s, ch)))
        split = emulate_int8(_t(x), _t(q), _t(s), ch)
        single = emulate_int8(_t(x), _t(q), _t(s), ch, single_pass=True)
    torch.testing.assert_close(split, want, **TOL)
    assert not torch.allclose(single, want, **TOL)


def test_tf32_rounding_and_the_split():
    """cvt.rna keeps 10 mantissa bits, halfway cases away from zero; the
    split is exact (hi + (x - hi) == x), hi and lo's MMA parts are TF32,
    and |x - hi| <= 2^-11 |x|."""
    one = 1.0
    ulp = 2.0 ** -10
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 4,
                      one + 3 * ulp / 4, 3.0e-3, -7.77], dtype=torch.float32)
    hi = _tf32_rna(x)
    assert hi[:4].tolist() == [one + ulp, -(one + ulp), one, one + ulp]
    assert ((hi.view(torch.int32) & 0x1FFF) == 0).all()
    x = torch.from_numpy(np.random.RandomState(3).randn(1000)
                         .astype(np.float32))
    hi, lo = _split(x)
    assert torch.equal(hi + (x - hi), x)
    for part in (hi, lo):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((x - hi).abs() <= x.abs() * 2.0 ** -11).all()
    assert (lo.abs() <= (x - hi).abs()).all()
