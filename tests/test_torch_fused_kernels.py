"""The port's fused matmul epilogue (K4) and add + LayerNorm (K5)
against the JAX package's Pallas kernels, on the CPU.

On the CPU each wrapper runs its kernel's plain PyTorch version; these
tests hold it against the JAX function run through its Pallas kernel in
interpret mode (the tiling of ``tests/test_matmul_fused.py``: 8 x 128 x
128 matmul tiles, 8-row LN tiles), on the same numpy inputs.
Tolerance: f32, rtol 1e-5 and atol 1e-5 * max |ref| — the two sum in
another order (the Pallas kernel in 128-deep K tiles, torch.matmul in
its own).  The CUDA kernels are held against the plain versions on the
card by tests/test_torch_cuda.py and chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.kernels import matmul_fused as jmm
from paddle_tpu_torch.kernels import KERNELS, _build
from paddle_tpu_torch.kernels import matmul_fused as pmm

TILES = {"block_m": 8, "block_n": 128, "block_k": 128}
M, K, N = 64, 256, 256


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _t(a):
    return None if a is None else torch.from_numpy(np.ascontiguousarray(a))


def _close(got, ref, what):
    ref = np.asarray(ref, np.float32)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max(), err_msg=what)


def _operands(seed, with_bias, with_residual):
    rng = np.random.RandomState(seed)
    x = rng.randn(M, K).astype(np.float32)
    w = (rng.randn(K, N) * 0.1).astype(np.float32)
    bias = rng.randn(N).astype(np.float32) if with_bias else None
    res = rng.randn(M, N).astype(np.float32) if with_residual else None
    return x, w, bias, res


@pytest.mark.parametrize("act", ["", "relu", "gelu"])
@pytest.mark.parametrize("with_bias,with_residual", [
    (True, False), (True, True), (False, False), (False, True)])
def test_matmul_epilogue_plain_matches_pallas(act, with_bias,
                                              with_residual):
    x, w, bias, res = _operands(0, with_bias, with_residual)
    ref = jmm.matmul_epilogue(x, w, bias, res, act, config=TILES,
                              interpret=True)
    got = pmm.matmul_epilogue(_t(x), _t(w), _t(bias), _t(res), act)
    _close(got, ref, "out")


@pytest.mark.parametrize("act", ["", "relu", "gelu"])
def test_matmul_epilogue_save_preact_matches_pallas(act):
    x, w, bias, res = _operands(1, True, True)
    ref_y, ref_pre = jmm.matmul_epilogue(x, w, bias, res, act,
                                         save_preact=True, config=TILES,
                                         interpret=True)
    y, pre = pmm.matmul_epilogue(_t(x), _t(w), _t(bias), _t(res), act,
                                 save_preact=True)
    _close(y, ref_y, "out")
    _close(pre, ref_pre, "pre")


@pytest.mark.parametrize("with_affine", [True, False])
def test_add_ln_plain_matches_pallas(with_affine):
    rng = np.random.RandomState(3)
    x = rng.randn(M, N).astype(np.float32)
    y = rng.randn(M, N).astype(np.float32)
    scale = (rng.rand(N) + 0.5).astype(np.float32) if with_affine else None
    bias = rng.randn(N).astype(np.float32) if with_affine else None
    ref = jmm.add_ln(x, y, scale, bias, config={"block_m": 8},
                     interpret=True)
    got = pmm.add_ln(_t(x), _t(y), _t(scale), _t(bias))
    for g, r, name in zip(got, ref, ("out", "sum", "mean", "var")):
        assert tuple(g.shape) == tuple(np.shape(r)), name
        _close(g, r, name)


def test_ln_from_sum_is_the_references():
    rng = np.random.RandomState(4)
    s = rng.randn(16, 40).astype(np.float32)
    scale = (rng.rand(40) + 0.5).astype(np.float32)
    ref = jmm.ln_from_sum(s, scale, None, 1e-5)
    got = pmm.ln_from_sum(_t(s), _t(scale), None, 1e-5)
    for g, r, name in zip(got, ref, ("out", "mean", "var")):
        _close(g, r, name)


def test_cpu_tensors_run_the_plain_version_and_count_no_launch():
    before = (pmm.matmul_epilogue.launches, pmm.add_ln.launches)
    x = torch.randn(6, 8)
    pmm.matmul_epilogue(x, torch.randn(8, 5), act="relu")
    pmm.add_ln(x, x)
    assert (pmm.matmul_epilogue.launches, pmm.add_ln.launches) == before
    assert KERNELS["matmul_epilogue"] is pmm.matmul_epilogue
    assert KERNELS["add_ln"] is pmm.add_ln
    assert "matmul_fused" in _build.SOURCES


@pytest.mark.parametrize("call", [
    lambda: pmm.matmul_epilogue(torch.randn(4, 8), torch.randn(6, 5)),
    lambda: pmm.matmul_epilogue(torch.randn(4, 8), torch.randn(8, 5),
                                torch.randn(4)),
    lambda: pmm.matmul_epilogue(torch.randn(4, 8), torch.randn(8, 5),
                                act="tanh"),
    lambda: pmm.add_ln(torch.randn(4, 8), torch.randn(4, 6)),
    lambda: pmm.add_ln(torch.randn(4, 8), torch.randn(4, 8),
                       torch.randn(6)),
])
def test_wrappers_reject_mismatched_shapes(call):
    with pytest.raises(ValueError):
        call()
