"""The plain versions of K4's and K1's bf16 forms against the JAX package
at the shapes the card tests hold the wgmma kernels to, on the CPU.

The card tests (``tests/test_torch_cuda.py``, marker ``cuda``) hold K4's
bf16 form (``csrc/wgmma_gemm.cuh``) to
``matmul_epilogue_f32acc_reference`` and K1's (``csrc/flash_fwd.cu``) to
``attention_reference`` at ragged M, N and K (TMA's zero fill and the
epilogue's masks) and at ragged T and Tk.  Here those plain versions
meet the reference's functions on the same bf16 operands, made with
numpy from a seed:

- K4 at the ragged shapes, every epilogue (act x bias x residual, out
  and pre): the port's CPU path (the per-op plain version) against the
  JAX package's ``matmul_epilogue`` (its XLA branch: these shapes do not
  tile) within 2**-7, relative and absolute, and the one-rounding plain
  version within one bf16 ulp (plus 1e-6 of max |Y|, the card's bar: a
  float32 sum near 0 carries its terms' rounding) of a float64 product
  with the float32 epilogue, rounded once;
- K4 at a shape that tiles: the one-rounding plain version within one
  bf16 ulp (plus 1e-6 of max |Y|, the card's bar) of the JAX package's
  Pallas kernel ``_matmul_kernel`` run in interpret mode, which rounds
  once from its float32 accumulator as the plain version does;
- K1 at the card tests' ragged shapes and at one query row: the port's
  flash forward on the CPU (its plain version) against the JAX package's
  ``flash_attention_fwd_lse`` (its XLA branch on the CPU): out within
  2**-7, the LSE within 1e-5.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import matmul_fused as jmf
from paddle_tpu_torch.kernels import matmul_fused as tmf
from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

TOL = 2 ** -7   # two bf16 ulps, relative and absolute
# (M, K, N): ragged M (not a multiple of the 128-row tile), N (not of
# 256) and K (not of the 64-deep K tile), and K = 4096
K4_SHAPES = [(129, 72, 136), (255, 72, 136), (17, 264, 24),
             (129, 4096, 136)]
EPILOGUES = [(act, bias, res) for act in ("", "relu", "gelu")
             for bias, res in ((False, False), (True, False),
                               (True, True), (False, True))]
# (B, H, T, Tk, causal): the card tests' ragged shapes at head_dim 128,
# and one query row
K1_SHAPES = [(2, 3, 200, 200, True), (1, 2, 77, 130, False),
             (1, 2, 130, 77, False), (2, 8, 100, 100, True),
             (1, 1, 1, 1, True), (1, 2, 1, 300, False)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rand(rng, *shape, scale=1.0):
    return (rng.randn(*shape) * scale).astype(np.float32)


def _bf16(pkg, a):
    if a is None:
        return None
    if pkg == "jax":
        return jnp.asarray(a).astype(jnp.bfloat16)
    return torch.from_numpy(a).to(torch.bfloat16)


def _host(v):
    return np.asarray(v.astype(jnp.float32), dtype=np.float64)


def _k4_operands(seed, m, k, n, bias, res):
    rng = np.random.RandomState(seed)
    x = _rand(rng, m, k)
    w = _rand(rng, k, n, scale=k ** -0.5)
    b = _rand(rng, n) if bias else None
    r = _rand(rng, m, n) if res else None
    return x, w, b, r


def _one_rounding(tx, tw, tb, tr, act):
    """(out, pre) from a float64 product of the widened bf16 operands,
    the float32 epilogue, each rounded once to bf16."""
    acc = torch.from_numpy(
        (tx.double().numpy() @ tw.double().numpy()).astype(np.float32))
    pre = acc + tb.float() if tb is not None else acc
    y = tmf.apply_act(pre, act)
    if tr is not None:
        y = y + tr.float()
    return y.to(torch.bfloat16).float(), pre.to(torch.bfloat16).float()


@pytest.mark.parametrize("act,bias,res", EPILOGUES)
@pytest.mark.parametrize("m,k,n", K4_SHAPES)
def test_k4_plain_versions_at_ragged_shapes(m, k, n, act, bias, res):
    x, w, b, r = _k4_operands(m + k + n, m, k, n, bias, res)
    jargs = [_bf16("jax", a) for a in (x, w, b, r)]
    targs = [_bf16("port", a) for a in (x, w, b, r)]
    jy, jpre = jmf.matmul_epilogue(*jargs, act=act, save_preact=True)
    ty, tpre = tmf.matmul_epilogue(*targs, act=act, save_preact=True)
    for got, want in ((ty, jy), (tpre, jpre)):
        assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
        w_ = _host(want)
        err = np.abs(got.double().numpy() - w_)
        assert np.all(err <= TOL + TOL * np.abs(w_)), float(err.max())
    # the card's yardstick rounds once
    y, pre = tmf.matmul_epilogue_f32acc_reference(*targs, act=act)
    assert y.dtype == pre.dtype == torch.bfloat16
    for got, want in zip((y, pre), _one_rounding(*targs, act)):
        bar = bf16_ulp(want) + 1e-6 * want.abs().max()
        assert torch.all((got.float() - want).abs() <= bar)


@pytest.mark.parametrize("act", ["", "relu", "gelu"])
def test_k4_one_rounding_plain_version_matches_the_pallas_kernel(act):
    m, k, n = 64, 256, 256
    x, w, b, r = _k4_operands(7, m, k, n, True, True)
    jargs = [_bf16("jax", a) for a in (x, w, b, r)]
    targs = [_bf16("port", a) for a in (x, w, b, r)]
    config = {"block_m": 32, "block_n": 128, "block_k": 128}
    assert jmf.plan_matmul(m, k, n, jnp.bfloat16, config)[3]
    jy, jpre = jmf.matmul_epilogue(*jargs, act=act, save_preact=True,
                                   config=config, interpret=True)
    ty, tpre = tmf.matmul_epilogue_f32acc_reference(*targs, act=act)
    for got, want in ((ty, jy), (tpre, jpre)):
        w_ = torch.from_numpy(_host(want)).float()
        bar = bf16_ulp(w_) + 1e-6 * w_.abs().max()
        assert torch.all((got.float() - w_).abs() <= bar)


@pytest.mark.parametrize("b,h,t,tk,causal", K1_SHAPES)
def test_k1_plain_version_at_the_card_shapes(b, h, t, tk, causal):
    rng = np.random.RandomState(t + tk)
    q = _rand(rng, b, h, t, 128)
    k, v = (_rand(rng, b, h, tk, 128) for _ in range(2))
    jout, jlse = jfa.flash_attention_fwd_lse(
        *(_bf16("jax", a) for a in (q, k, v)), causal=causal)
    tout, tlse = tfa.flash_attention_fwd_lse(
        *(_bf16("port", a) for a in (q, k, v)), causal=causal)
    assert tout.dtype == torch.bfloat16 and tlse.dtype == torch.float32
    w_ = _host(jout)
    err = np.abs(tout.double().numpy() - w_)
    assert np.all(err <= TOL + TOL * np.abs(w_)), float(err.max())
    np.testing.assert_allclose(tlse.numpy(), _host(jlse), rtol=1e-5,
                               atol=1e-5)
