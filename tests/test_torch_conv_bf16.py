"""The bf16 form of the conv-stage kernel K6: its plain version against
the JAX package's ``conv2d_nhwc`` on bf16 inputs, on the CPU.

The reference's CPU branch (its XLA fallback) convolves bf16 x and w
with f32 accumulation, applies the epilogue in f32 and rounds the
output once to bf16; its statistics are f32 sums of the f32
accumulator.  ``conv2d_nhwc_reference`` (what a CPU tensor runs, and
what the card's bf16 form is held to) must do the same: Y within one
bf16 ulp of the reference's (plus 1e-6 of max |Y|: each value is one
rounding of two f32 sums that differ only in order), the statistics
within ``STATS_RTOL`` (1e-6) of the sum of their terms' magnitudes, at
the stem (Ci = 3, 7x7, stride 2), a 3x3 and a strided 1x1 stage, in the
statistics form and with affine + residual + relu.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import conv_fused as jconv
from paddle_tpu_torch.kernels import conv_fused as tconv
from paddle_tpu_torch.kernels.conv_fused import (STATS_RTOL, bf16_ulp,
                                                 within_bf16_ulp)

# (N, H, Ci, Co, k, stride, pad)
SHAPES = {"stem": (2, 30, 3, 64, 7, 2, 3),
          "3x3": (2, 14, 64, 64, 3, 1, 1),
          "1x1 stride 2": (2, 14, 64, 128, 1, 2, 0)}


def _inputs(shape, seed=0):
    n, h, ci, co, k, s, p = shape
    ho = (h + 2 * p - k) // s + 1
    rng = np.random.RandomState(seed)
    x = rng.randn(n, h, h, ci).astype(np.float32)
    w = (rng.randn(k, k, ci, co) / np.sqrt(k * k * ci)).astype(np.float32)
    a = (rng.rand(co) + 0.5).astype(np.float32)
    b = rng.randn(co).astype(np.float32)
    r = rng.randn(n, ho, ho, co).astype(np.float32)
    return x, w, a, b, r, (s, s), (p, p)


def _bf16_torch(v):
    return torch.from_numpy(v).to(torch.bfloat16)


def _bf16_jax(v):
    return jnp.asarray(v).astype(jnp.bfloat16)


def _f32(v):
    if isinstance(v, torch.Tensor):
        return v.float().numpy()
    return np.asarray(v.astype(jnp.float32))


def _assert_within_one_ulp(got, want):
    want_t = torch.from_numpy(want)
    bound = bf16_ulp(want_t).numpy() + 1e-6 * np.abs(want).max()
    err = np.abs(got.astype(np.float64) - want)
    assert np.all(err <= bound), float((err / bound).max())


def _terms(x, w, strides, paddings):
    """Float64 raw conv output of the bf16 operands, [M, Co]."""
    xv, wv = tconv.nchw_views(x.double(), w.double())
    acc = torch.nn.functional.conv2d(xv, wv, None, strides, paddings)
    return acc.permute(0, 2, 3, 1).reshape(-1, acc.shape[1])


@pytest.mark.parametrize("name", list(SHAPES))
@pytest.mark.parametrize("mode", ["stats", "affine+residual+relu"])
def test_plain_bf16_conv_stage_matches_the_reference(name, mode):
    x, w, a, b, r, strides, paddings = _inputs(SHAPES[name])
    tx, tw, tr = _bf16_torch(x), _bf16_torch(w), _bf16_torch(r)
    jx, jw, jr = _bf16_jax(x), _bf16_jax(w), _bf16_jax(r)
    if mode == "stats":
        got = tconv.conv2d_nhwc(tx, tw, strides, paddings, stats=True)
        want = jconv.conv2d_nhwc(jx, jw, strides, paddings, stats=True)
    else:
        got = (tconv.conv2d_nhwc(
            tx, tw, strides, paddings, affine=(torch.from_numpy(a),
                                               torch.from_numpy(b)),
            residual=tr, act="relu"),)
        want = (jconv.conv2d_nhwc(jx, jw, strides, paddings,
                                  affine=(jnp.asarray(a), jnp.asarray(b)),
                                  residual=jr, act="relu"),)
    y, jy = got[0], want[0]
    assert y.dtype == torch.bfloat16 and jy.dtype == jnp.bfloat16
    assert tuple(y.shape) == tuple(jy.shape)
    _assert_within_one_ulp(_f32(y), _f32(jy).astype(np.float64))
    if mode != "stats":
        return
    terms = _terms(tx, tw, strides, paddings)
    for got_s, want_s, t in ((got[1], want[1], terms),
                             (got[2], want[2], terms.square())):
        assert got_s.dtype == torch.float32
        mag = t.abs().sum(0).numpy()
        exact = t.sum(0).numpy()
        for v in (got_s.double().numpy(), np.asarray(want_s, np.float64)):
            assert np.all(np.abs(v - exact) <= STATS_RTOL * mag)


def test_stats_come_from_the_f32_accumulator_not_the_rounded_output():
    """Sums of the bf16-rounded Y would miss the f32 sums by ~2**-9 of
    their magnitude, far past STATS_RTOL."""
    x, w, _, _, _, strides, paddings = _inputs(SHAPES["3x3"], seed=1)
    tx, tw = _bf16_torch(x), _bf16_torch(w)
    y, s, _ = tconv.conv2d_nhwc(tx, tw, strides, paddings, stats=True)
    terms = _terms(tx, tw, strides, paddings)
    mag, exact = terms.abs().sum(0), terms.sum(0)
    assert torch.all((s.double() - exact).abs() <= STATS_RTOL * mag)
    rounded = y.double().reshape(-1, y.shape[-1]).sum(0)
    assert torch.any((rounded - exact).abs() > STATS_RTOL * mag)


def test_stats_error_of_the_bf16_form_on_the_cpu():
    x, w, _, _, _, strides, paddings = _inputs(SHAPES["1x1 stride 2"])
    tx, tw = _bf16_torch(x), _bf16_torch(w)
    _, s, ss = tconv.conv2d_nhwc(tx, tw, strides, paddings, stats=True)
    _, rel = tconv.stats_error(tx, tw, strides, paddings, s, ss)
    assert rel <= STATS_RTOL


@pytest.mark.parametrize("v", [1.0, 1.5, 1.99, 2.0, 3.0, 0.75, 6.1e-5])
def test_bf16_ulp_is_the_spacing_of_bf16_numbers(v):
    b = torch.tensor([v]).to(torch.bfloat16)
    above = (b.view(torch.int16) + 1).view(torch.bfloat16)
    assert float(bf16_ulp(b.float())[0]) == float(above.float() - b.float())
    assert float(bf16_ulp(-b.float())[0]) == float(above.float() - b.float())


@pytest.mark.parametrize("floor", [0.0, 2.0 ** -12])
def test_within_bf16_ulp_holds_one_ulp_plus_the_floor(floor):
    want = torch.tensor([1.0, -3.0, 0.5, 0.0])
    slack = floor * 3.0
    ulp = bf16_ulp(want)
    err, ok = within_bf16_ulp(want + ulp + slack, want, floor)
    assert ok and err == float((ulp + slack).max())
    err, ok = within_bf16_ulp(want + 2 * ulp + slack, want, floor)
    assert not ok and err == float((2 * ulp + slack).max())
