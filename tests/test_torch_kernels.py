"""paddle_tpu_torch kernels against the JAX package's kernels.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold that version against the JAX function on the same numpy
inputs, both through its XLA branch (``force_xla=True``) and through
the Pallas kernel in interpret mode, at f32 atol 1e-5.  The CUDA
kernels themselves are held against the plain versions on the card by
tests/test_torch_cuda.py and chip_smoke.py.
"""
import importlib

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import compress as jax_compress
from paddle_tpu.kernels import matmul_fused as jmm
from paddle_tpu.serving import tiny_lm as jax_tiny_lm
from paddle_tpu_torch.distributed import compress as port_compress
from paddle_tpu_torch.kernels import (KERNELS, flash_attention,
                                      flash_attention_bwd,
                                      flash_attention_fwd_lse,
                                      flash_attention_train,
                                      matmul_int8_dequant,
                                      paged_attention)
from paddle_tpu_torch.kernels.flash_attention import attention_reference
from paddle_tpu_torch.kernels import matmul_fused as pmm
from paddle_tpu_torch.serving import tiny_lm as port_tiny_lm

ATOL = 1e-5
# the package re-exports the function under the module's name
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# ------------------------------------------------------------ K1 flash

def _qkv(seed, b=2, h=2, t=64, tk=64, d=32):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32),
            rng.randn(b, h, tk, d).astype(np.float32))


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["force_xla", "interpret"])
def test_flash_fwd_lse_plain_matches_jax(causal, mode):
    q, k, v = _qkv(1)
    kw = ({"force_xla": True} if mode == "force_xla" else
          {"interpret": True, "block_q": 32, "block_k": 32})
    jo, jl = jfa.flash_attention_fwd_lse(q, k, v, causal=causal, **kw)
    po, pl = flash_attention_fwd_lse(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(po.numpy(), np.asarray(jo), atol=ATOL)
    np.testing.assert_allclose(pl.numpy(), np.asarray(jl), atol=ATOL)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_attention_plain_matches_jax(causal):
    q, k, v = _qkv(2, t=32, tk=32)
    ref = np.asarray(jfa.flash_attention(q, k, v, causal=causal,
                                         force_xla=True))
    out = flash_attention(_t(q), _t(k), _t(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_flash_wrapper_validates_inputs():
    q, k, v = (_t(a) for a in _qkv(3, t=8, tk=8))
    with pytest.raises(ValueError, match="float32"):
        flash_attention(q.double(), k.double(), v.double())
    with pytest.raises(ValueError, match="shape"):
        flash_attention(q, k[:, :1], v[:, :1])
    with pytest.raises(ValueError, match="B, H, T, D"):
        flash_attention(q[0], k[0], v[0])


# ------------------------------------------------------------ K7 paged

def _paged_case(seed):
    rng = np.random.RandomState(seed)
    b, h, d, bs, nb, n = 3, 2, 16, 8, 4, 32
    q = rng.randn(b, h, d).astype(np.float32)
    kp = rng.randn(n, bs, h, d).astype(np.float32)
    vp = rng.randn(n, bs, h, d).astype(np.float32)
    tables = rng.randint(1, n, size=(b, nb)).astype(np.int32)
    lens = np.array([1, 17, 32], np.int32)          # ragged, incl. 1
    return q, kp, vp, tables, lens


@pytest.mark.parametrize("mode", ["force_xla", "interpret"])
def test_paged_attention_plain_matches_jax(mode):
    q, kp, vp, tables, lens = _paged_case(4)
    ref = np.asarray(jfa.paged_attention(q, kp, vp, tables, lens,
                                         **{mode: True}))
    out = paged_attention(_t(q), _t(kp), _t(vp), _t(tables), _t(lens))
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_paged_wrapper_validates_inputs():
    q, kp, vp, tables, lens = (_t(a) for a in _paged_case(5))
    with pytest.raises(ValueError, match="int32"):
        paged_attention(q, kp, vp, tables.long(), lens)
    with pytest.raises(ValueError, match="does not match"):
        paged_attention(q[:, :1], kp, vp, tables, lens)


# ------------------------------------------------------------ K8 int8

@pytest.mark.parametrize("epilogue", ["none", "bias_gelu_residual",
                                      "relu"])
@pytest.mark.parametrize("mode", ["force_xla", "interpret"])
def test_matmul_int8_plain_matches_jax(epilogue, mode):
    rng = np.random.RandomState(6)
    x = rng.randn(8, 256).astype(np.float32)
    w = (rng.randn(256, 128) * 0.1).astype(np.float32)
    bias = rng.randn(128).astype(np.float32)
    res = rng.randn(8, 128).astype(np.float32)
    q, s, chunk = jmm.quantize_weight(w, chunk=128)
    kw = {"none": {}, "relu": {"act": "relu"},
          "bias_gelu_residual": {"act": "gelu"}}[epilogue]
    jb = jr = pb = pr = None
    if epilogue == "bias_gelu_residual":
        jb, jr, pb, pr = bias, res, _t(bias), _t(res)
    # K tiles of 128 fit the 128-row chunks, so interpret mode really
    # runs the Pallas kernel (two K tiles, two scale rows)
    mode_kw = ({"force_xla": True} if mode == "force_xla" else
               {"interpret": True, "config": {"block_m": 8,
                                              "block_n": 128,
                                              "block_k": 128}})
    ref = np.asarray(jmm.matmul_int8_dequant(
        x, q, s, chunk, bias=jb, residual=jr, **kw, **mode_kw))
    out = matmul_int8_dequant(_t(x), _t(q), _t(s), chunk, bias=pb,
                              residual=pr, **kw)
    np.testing.assert_allclose(out.numpy(), ref, atol=ATOL)


def test_matmul_int8_wrapper_validates_inputs():
    x = torch.zeros(4, 64)
    q = torch.zeros(64, 32, dtype=torch.int8)
    s = torch.ones(2, 32)
    with pytest.raises(ValueError, match="chunk"):
        matmul_int8_dequant(x, q, s, 48)
    with pytest.raises(ValueError, match="scales"):
        matmul_int8_dequant(x, q, torch.ones(1, 32), 32)
    with pytest.raises(ValueError, match="activation"):
        matmul_int8_dequant(x, q, s, 32, act="swish")


def test_apply_act_matches_jax():
    y = np.linspace(-4, 4, 101).astype(np.float32)
    for act in ("", "relu", "gelu"):
        np.testing.assert_allclose(pmm.apply_act(_t(y), act).numpy(),
                                   np.asarray(jmm.apply_act(y, act)),
                                   atol=1e-6)


# ------------------------------------- bit-identical host-side copies

@pytest.mark.parametrize("shape,chunk", [((256, 96), None),
                                         ((1024, 64), None),
                                         ((4096, 32), None),
                                         ((192, 40), 64),
                                         ((100, 8), 48)])
def test_quantize_weight_bit_identical(shape, chunk):
    rng = np.random.RandomState(7)
    w = (rng.randn(*shape) * 0.1).astype(np.float32)
    w[:, 0] = 0.0                            # an all-zero column chunk
    jq, js, jc = jmm.quantize_weight(w, chunk=chunk)
    pq, ps, pc = pmm.quantize_weight(w, chunk=chunk)
    assert jc == pc
    assert pq.dtype == np.int8 and ps.dtype == np.float32
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(ps, js)
    np.testing.assert_array_equal(
        pmm.dequantize_weight(_t(pq), _t(ps), pc).numpy(),
        np.asarray(jmm.dequantize_weight(jq, js, jc)))


def test_quantize_symmetric_bit_identical():
    rng = np.random.RandomState(8)
    chunks = rng.randn(5, 2048).astype(np.float32) * 3
    chunks[2] = 0.0
    assert port_compress.CHUNK == jax_compress.CHUNK
    jq, js = jax_compress.quantize_symmetric(chunks)
    pq, ps = port_compress.quantize_symmetric(chunks)
    np.testing.assert_array_equal(pq, jq)
    np.testing.assert_array_equal(ps, js)


def test_tiny_lm_bit_identical():
    kw = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              block_size=8, max_blocks=8, max_batch=4)
    jcfg, jp = jax_tiny_lm(11, **kw)
    pcfg, pp = port_tiny_lm(11, **kw)
    assert pcfg.todict() == jcfg.todict()
    assert sorted(pp) == sorted(jp)
    for k in jp:
        assert pp[k].dtype == jp[k].dtype
        np.testing.assert_array_equal(pp[k], jp[k])


def test_cpu_path_launches_no_kernel():
    before = {k: fn.launches for k, fn in KERNELS.items()}
    q, k, v = (_t(a).requires_grad_() for a in _qkv(9, t=8, tk=8))
    flash_attention(q, k, v, causal=True)
    out, _ = flash_attention_train(q, k, v, causal=True)
    out.sum().backward()
    assert {k: fn.launches for k, fn in KERNELS.items()} == before


# ------------------------------------------------------- K2/K3 flash bwd

def _bwd_case(seed, causal, t=64, tk=64):
    q, k, v = _qkv(seed, t=t, tk=tk)
    do = np.random.RandomState(seed + 100).randn(*q.shape).astype(
        np.float32)
    out, lse = jfa.flash_attention_fwd_lse(q, k, v, causal=causal,
                                           force_xla=True)
    return q, k, v, np.asarray(out), np.asarray(lse), do


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", ["force_xla", "interpret"])
def test_flash_bwd_plain_matches_jax(causal, mode):
    """The port's flash_attention_bwd (its plain version on the CPU)
    against the JAX package's, through its XLA branch and through the
    Pallas dQ / dK-dV kernels in interpret mode."""
    args = _bwd_case(5, causal)
    kw = ({"force_xla": True} if mode == "force_xla" else
          {"interpret": True, "block_q": 32, "block_k": 32})
    want = jfa.flash_attention_bwd(*args, causal=causal, **kw)
    got = flash_attention_bwd(*(_t(a) for a in args), causal=causal)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


def test_flash_bwd_ragged_kv_matches_jax():
    """Tk != T under the top-left causal mask."""
    args = _bwd_case(6, True, t=32, tk=48)
    want = jfa.flash_attention_bwd(*args, causal=True, force_xla=True)
    got = flash_attention_bwd(*(_t(a) for a in args), causal=True)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5,
                                   atol=1e-5)


@pytest.mark.parametrize("causal", [False, True])
def test_flash_train_autograd_matches_plain_autograd(causal):
    """flash_attention_train's backward (the flash backward from the
    saved lse) equals autograd through the plain forward."""
    q, k, v = _qkv(7, t=32, tk=32)
    w = _t(np.random.RandomState(8).randn(*q.shape).astype(np.float32))
    leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    out, lse = flash_attention_train(*leaves, causal=causal)
    assert not lse.requires_grad
    got = torch.autograd.grad((out * w).sum(), leaves)
    ref_leaves = [_t(a).requires_grad_() for a in (q, k, v)]
    ref, _ = attention_reference(*ref_leaves, 32 ** -0.5, causal)
    want = torch.autograd.grad((ref * w).sum(), ref_leaves)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-5,
                                   atol=1e-5)


def test_flash_bwd_wrapper_validates_inputs():
    q, k, v, out, lse, do = (_t(a) for a in _bwd_case(9, True, t=8, tk=8))
    with pytest.raises(ValueError, match="float32"):
        flash_attention_bwd(q.double(), k, v, out, lse, do)
    with pytest.raises(ValueError, match="shape"):
        flash_attention_bwd(q, k, v, out, lse[:, :, :4], do)
    with pytest.raises(ValueError, match="B, H, T, D"):
        flash_attention_bwd(q[0], k, v, out, lse, do)
