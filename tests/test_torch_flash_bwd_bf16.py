"""The plain versions that K2's and K3's bf16 forms are held to on the card,
against the JAX package, on the CPU.

The card tests (``tests/test_torch_cuda.py``, marker ``cuda``) hold the
wgmma kernels of ``csrc/flash_bwd.cu`` (``flash_bwd_dq_bf16``,
``flash_bwd_dkv_bf16``) to ``flash_attention_bwd_reference`` at the
flagship and ragged shapes, and to ``chunk_bwd_reference`` at a causal
``k_offset``.  Here those plain versions meet the reference's functions
on the same bf16 operands, made with numpy from a seed, and the same
float32 lse and bf16 O (the JAX package's own forward):

- ``flash_attention_bwd_reference`` against the JAX package's
  ``flash_attention_bwd`` through its Pallas kernels ``_dq_kernel`` and
  ``_dkv_kernel`` in interpret mode (its tiles: the whole sequence up to
  1024 rows, 64-row tiles where a shape splits into them) and through its
  XLA branch (the path it takes off the TPU);
- ``chunk_bwd_reference`` against the JAX package's
  ``flash_attention_chunk_bwd`` (its blockwise XLA scan) at the card
  tests' k_offset cases.

Both sides take float32 sums of the widened bf16 operands and round each
gradient once, in different orders, so each gradient is held within one
bf16 ulp of the JAX value plus 2**-12 of its max |value| (the card's
bar).  At T = Tk = 1, dS = dP - delta is a difference of two equal sums,
0 up to their rounding, so dQ and dK are held to 2**-12 of the terms that
cancel (scale |dO . V| |K| and |Q|) instead.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

FLOOR = 2.0 ** -12
D = 128
# (B, H, T, Tk, causal): the card tests' shapes short of the flagship
SHAPES = [(1, 8, 256, 256, True), (2, 3, 200, 200, True),
          (1, 2, 77, 130, False), (1, 2, 130, 77, False),
          (2, 8, 100, 100, True), (2, 3, 129, 129, True),
          (1, 2, 129, 129, False), (1, 2, 1, 1, True)]
# (T, Tk, causal, k_offset): the card tests' ring-step cases
K_OFFSET_CASES = [(256, 256, True, 0), (200, 130, True, 37),
                  (130, 200, True, -50), (256, 256, True, -256),
                  (128, 128, True, 200), (129, 300, False, 64)]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _operands(seed, b, h, t, tk):
    """q, k, v, dO as bf16 float32 arrays (exact in both packages)."""
    rng = np.random.RandomState(seed)
    shapes = [(b, h, t, D), (b, h, tk, D), (b, h, tk, D), (b, h, t, D)]
    return [np.asarray(jnp.asarray(rng.randn(*s).astype(np.float32))
                       .astype(jnp.bfloat16).astype(jnp.float32))
            for s in shapes]


def _jax(a, dtype=jnp.bfloat16):
    return jnp.asarray(a).astype(dtype)


def _port(a, dtype=torch.bfloat16):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _host(v):
    return torch.from_numpy(np.array(v.astype(jnp.float32)))


def _check(got, want, terms=None):
    """got (the port's bf16) within one bf16 ulp of want (the JAX
    package's) plus 2**-12 of max |want|, or of max ``terms``."""
    assert got.dtype == torch.bfloat16
    want = _host(want)
    scale = want.abs().max() if terms is None else terms.max()
    err = (got.float() - want).abs()
    bar = bf16_ulp(want) + FLOOR * scale
    assert bool((err <= bar).all()), float(err.max())


# each shape through the XLA branch and the Pallas kernels (64-row tiles
# too where the shape splits into them)
CASES = [(route,) + shape for shape in SHAPES
         for route in ("xla", "pallas") + (
             ("pallas_tiled",) if shape[2] % 64 == shape[3] % 64 == 0
             else ())]


@pytest.mark.parametrize("route,b,h,t,tk,causal", CASES)
def test_k2_k3_plain_version_matches_the_reference(route, b, h, t, tk,
                                                   causal):
    q, k, v, do = _operands(t * 7 + tk, b, h, t, tk)
    jq, jk, jv, jdo = (_jax(a) for a in (q, k, v, do))
    jout, jlse = jfa.flash_attention_fwd_lse(jq, jk, jv, causal=causal)
    kw = {"xla": {"force_xla": True},
          "pallas": {"interpret": True},
          "pallas_tiled": {"interpret": True, "block_q": 64,
                           "block_k": 64}}[route]
    want = jfa.flash_attention_bwd(jq, jk, jv, jout, jlse, jdo,
                                   causal=causal, **kw)
    tq, tk_, tv, tdo = (_port(a) for a in (q, k, v, do))
    got = tfa.flash_attention_bwd_reference(
        tq, tk_, tv, _port(_host(jout)), _port(np.asarray(jlse),
                                               torch.float32),
        tdo, D ** -0.5, causal)
    _check(got[2], want[2])
    if t == tk == 1:
        dot = (_host(jdo) * _host(jv)).abs().sum(-1, keepdim=True)
        _check(got[0], want[0], D ** -0.5 * dot * _host(jk).abs())
        _check(got[1], want[1], D ** -0.5 * dot * _host(jq).abs())
    else:
        _check(got[0], want[0])
        _check(got[1], want[1])


@pytest.mark.parametrize("t,tk,causal,k_offset", K_OFFSET_CASES)
def test_chunk_bwd_plain_version_matches_the_reference(t, tk, causal,
                                                       k_offset):
    q, k, v, do = _operands(t + tk, 2, 3, t, tk)
    s = np.einsum("bhtd,bhsd->bhts", q, k) * D ** -0.5
    if causal:
        dead = np.arange(t)[:, None] < k_offset + np.arange(tk)[None, :]
        s = np.where(dead, -np.inf, s)
    m = s.max(-1, keepdims=True)
    with np.errstate(invalid="ignore"):
        e = np.exp(s - m)
    e = np.nan_to_num(e)
    l = e.sum(-1, keepdims=True)
    lse = np.where(l[..., 0] > 0, m[..., 0] + np.log(np.maximum(l[..., 0],
                                                                1e-30)),
                   jfa.NEG_INF).astype(np.float32)
    p = e / np.maximum(l, 1e-30)
    out = np.asarray(_jax(np.einsum("bhts,bhsd->bhtd", p, v))
                     .astype(jnp.float32))
    delta = (do * out).sum(-1).astype(np.float32)
    want = jfa.flash_attention_chunk_bwd(
        *(_jax(a) for a in (q, k, v, do)), _jax(lse, jnp.float32),
        _jax(delta, jnp.float32), causal=causal, k_offset=k_offset)
    got = tfa.chunk_bwd_reference(
        *(_port(a) for a in (q, k, v, do)), _port(lse, torch.float32),
        _port(delta, torch.float32), D ** -0.5, causal, k_offset)
    for a, w in zip(got, want):
        _check(a, w)
