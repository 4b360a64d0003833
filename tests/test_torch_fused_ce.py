"""The port's fused softmax cross-entropy (K10) against the JAX
package's, on the CPU at [64, 512].

On the CPU the wrapper runs its plain version; it is held against the
JAX function through its Pallas kernel in interpret mode (block_n 16,
so the class axis streams in tiles of its default block_c, fitted to
512) and through its XLA branch, on the same numpy inputs.  Tolerance
rtol = atol = 1e-5: the same f32 logsumexp summed in another order (the
reference's own kernel-vs-XLA pin).  The CUDA kernel is held against
the plain version on the card by tests/test_torch_cuda.py and
chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.kernels.fused import \
    fused_softmax_cross_entropy as jax_fused_ce
from paddle_tpu_torch.kernels import KERNELS, _build
from paddle_tpu_torch.kernels import fused as pfused


def _inputs(seed, n=64, c=512):
    rng = np.random.RandomState(seed)
    return ((rng.randn(n, c) * 3).astype(np.float32),
            rng.randint(0, c, n).astype(np.int64))


@pytest.mark.parametrize("mode", [{"interpret": True, "block_n": 16},
                                  {"force_xla": True}])
def test_fused_ce_matches_jax(mode):
    logits, labels = _inputs(0)
    want = np.asarray(jax_fused_ce(jnp.asarray(logits),
                                   jnp.asarray(labels, jnp.int32), **mode))
    got = pfused.fused_softmax_cross_entropy(torch.from_numpy(logits),
                                             torch.from_numpy(labels))
    assert got.dtype == torch.float32 and got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_fused_ce_takes_int32_and_column_labels_and_counts_no_launch():
    logits, labels = _inputs(1)
    before = pfused.fused_softmax_cross_entropy.launches
    a = pfused.fused_softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels).int())
    b = pfused.fused_softmax_cross_entropy(
        torch.from_numpy(logits), torch.from_numpy(labels)[:, None])
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert pfused.fused_softmax_cross_entropy.launches == before
    assert KERNELS["fused_ce"] is pfused.fused_softmax_cross_entropy
    assert "fused_ce" in _build.SOURCES


@pytest.mark.parametrize("logits,labels", [
    (torch.randn(4, 8).double(), torch.zeros(4, dtype=torch.long)),
    (torch.randn(4, 8), torch.zeros(3, dtype=torch.long)),
    (torch.randn(4, 8), torch.zeros(4)),
    (torch.randn(2, 4, 8), torch.zeros(8, dtype=torch.long)),
])
def test_fused_ce_refuses_bad_inputs(logits, labels):
    with pytest.raises(ValueError):
        pfused.fused_softmax_cross_entropy(logits, labels)
