"""The port's ring-step chunk functions and sequence-parallel ring
attention against the JAX package's, on the CPU at small sizes.

The port's plain versions run here (a CUDA kernel has no CPU mode); the
JAX package runs its chunk functions through the XLA branch
(``force_xla=True``) and the Pallas kernel in interpret mode, and its
ring under ``shard_map`` over p host CPU devices (jitted, so each
configuration compiles once).  Inputs are made with numpy from a seed.
Tolerances, with their reasons:

- chunk carry: 1e-6 absolute and relative, the same f32 fold summed in
  another order (l, a sum of up to 32 exps, is ~1e1: 1e-6 of it is an
  ulp or two); a wholly masked block leaves the carry bit-identical;
- chunk backward: 2e-5, the JAX package's own pin for its two branches
  (tests/test_ring_longctx.py);
- ring out and lse: 1e-5 (the JAX package's PARITY_TOL); ring grads:
  1e-5 of the largest |grad|, its ring-vs-flash pin.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.parallel import make_mesh as jmake_mesh
from paddle_tpu.parallel import ring as jring
from paddle_tpu_torch.parallel import make_mesh, ring as tring

jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
tfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

NEG_INF = -1e30
SHAPES = [(1, 2, 32, 8), (2, 3, 32, 8)]


def _arrays(shape, n, seed, scale=0.5):
    rng = np.random.RandomState(seed)
    return [(rng.randn(*shape) * scale).astype(np.float32)
            for _ in range(n)]


def _fresh_carry(shape):
    return (np.full(shape[:3], NEG_INF, np.float32),
            np.zeros(shape[:3], np.float32), np.zeros(shape, np.float32))


def _seeded_carry(shape, seed):
    """A carry after one earlier non-causal fold of another K/V block."""
    q, k, v = _arrays(shape, 3, seed)
    m, l, acc = jfa.flash_attention_chunk(
        *map(jnp.asarray, (q, k, v) + _fresh_carry(shape)), force_xla=True)
    return tuple(np.array(x) for x in (m, l, acc))


def _port(fn, *arrays, **kw):
    out = fn(*map(torch.from_numpy, arrays), **kw)
    return tuple(x.numpy() for x in out)


def _jax(fn, *arrays, **kw):
    return tuple(np.array(x) for x in fn(*map(jnp.asarray, arrays), **kw))


# ------------------------------------------------------------ the chunk

@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,k_offset", [(True, 0), (True, 13),
                                             (True, 32), (False, 0)])
def test_chunk_matches_jax(shape, causal, k_offset):
    q, k, v = _arrays(shape, 3, seed=1)
    for carry in (_fresh_carry(shape), _seeded_carry(shape, seed=2)):
        got = _port(tfa.flash_attention_chunk, q, k, v, *carry,
                    causal=causal, k_offset=k_offset)
        for mode in ({"force_xla": True}, {"interpret": True}):
            want = _jax(jfa.flash_attention_chunk, q, k, v, *carry,
                        causal=causal, k_offset=k_offset, **mode)
            for g, w, name in zip(got, want, ("m", "l", "acc")):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                           err_msg="%s %s" % (name, mode))
        if k_offset >= shape[2]:     # wholly in the future
            for g, c in zip(got, carry):
                np.testing.assert_array_equal(g, c)


def test_chunk_streams_k_in_tiles():
    """Sk = 2048 streams in two 1024-row tiles (the JAX package's
    default tile), and a carry threaded over split blocks equals one
    fold over the whole block.  Sums of 2048 terms in another order:
    held to 1e-5 of the largest |value|."""
    assert tfa._chunk_block_k(2048) == 1024
    assert tfa._chunk_block_k(1536) == 512 and tfa._chunk_block_k(96) == 96
    shape = (1, 2, 16, 8)
    q, = _arrays(shape, 1, seed=3)
    k, v = _arrays((1, 2, 2048, 8), 2, seed=4)
    whole = _port(tfa.flash_attention_chunk, q, k, v, *_fresh_carry(shape))
    want = _jax(jfa.flash_attention_chunk, q, k, v, *_fresh_carry(shape),
                force_xla=True)
    carry = _fresh_carry(shape)
    for lo, hi in ((0, 700), (700, 2048)):
        carry = _port(tfa.flash_attention_chunk, q, k[:, :, lo:hi],
                      v[:, :, lo:hi], *carry)
    for a, b, w in zip(whole, carry, want):
        for got in (a, b):
            assert np.abs(got - w).max() <= 1e-5 * np.abs(w).max()


def test_chunk_finalize_matches_jax_with_dead_rows():
    shape = (2, 3, 32, 8)
    q, k, v = _arrays(shape, 3, seed=5)
    # keys start at position 13: rows 0..12 never see a live key
    carry = _port(tfa.flash_attention_chunk, q, k, v, *_fresh_carry(shape),
                  causal=True, k_offset=13)
    out, lse = _port(lambda m, l, a: tfa.chunk_finalize(
        m, l, a, torch.float32), *carry)
    jout, jlse = _jax(lambda m, l, a: jfa.chunk_finalize(
        m, l, a, jnp.float32), *carry)
    np.testing.assert_allclose(out, jout, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(lse, jlse, rtol=1e-6, atol=1e-6)
    assert np.isfinite(out).all()
    assert np.abs(out[:, :, :13]).max() == 0.0
    assert (lse[:, :, :13] == np.float32(NEG_INF)).all()
    assert np.abs(out[:, :, 13:]).max() > 0


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,k_offset", [(True, 0), (True, 13),
                                             (False, 0)])
def test_chunk_bwd_matches_jax(shape, causal, k_offset):
    q, k, v, do = _arrays(shape, 4, seed=6)
    m, l, acc = _jax(jfa.flash_attention_chunk, q, k, v,
                     *_fresh_carry(shape), causal=causal, k_offset=k_offset,
                     force_xla=True)
    out, lse = _jax(lambda m, l, a: jfa.chunk_finalize(m, l, a,
                                                       jnp.float32),
                    m, l, acc)
    delta = (do * out).sum(-1)
    got = _port(tfa.flash_attention_chunk_bwd, q, k, v, do, lse, delta,
                causal=causal, k_offset=k_offset)
    want = _jax(jfa.flash_attention_chunk_bwd, q, k, v, do, lse, delta,
                causal=causal, k_offset=k_offset, force_xla=True)
    for g, w, name in zip(got, want, ("dq", "dk", "dv")):
        assert np.abs(g - w).max() <= 2e-5, name
    if k_offset:      # dead rows (q_pos < k_offset) take no gradient
        assert np.abs(got[0][:, :, :k_offset]).max() == 0.0


# ------------------------------------------------------------- the ring

def _jax_ring(p, causal, q, k, v, do):
    mesh = jmake_mesh({"sp": p}, devices=jax.devices("cpu")[:p])

    def both(q, k, v, do):
        out, lse = jring.ring_attention_fwd_lse(q, k, v, mesh,
                                                causal=causal)
        return out, lse, jring.ring_attention_bwd(q, k, v, out, lse, do,
                                                  mesh, causal=causal)

    out, lse, grads = jax.jit(both)(*map(jnp.asarray, (q, k, v, do)))
    return np.asarray(out), np.asarray(lse), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("p", [2, 4, 8])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_matches_jax(p, causal):
    q, k, v, do = _arrays((2, 3, 32, 8), 4, seed=7)
    jout, jlse, jgrads = _jax_ring(p, causal, q, k, v, do)
    mesh = make_mesh({"sp": p}, [torch.device("cpu")] * p)
    tq, tk, tv, tdo = map(torch.from_numpy, (q, k, v, do))
    out, lse = tring.ring_attention_fwd_lse(tq, tk, tv, mesh, causal=causal)
    np.testing.assert_allclose(out.numpy(), jout, atol=1e-5, rtol=0)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=0)
    grads = tring.ring_attention_bwd(tq, tk, tv, out, lse, tdo, mesh,
                                     causal=causal)
    for g, w, name in zip(grads, jgrads, "qkv"):
        rel = np.abs(g.numpy() - w).max() / np.abs(w).max()
        assert rel <= 1e-5, (name, rel)
    # autograd through ring_attention runs the same reverse ring
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    auto = torch.autograd.grad(
        tring.ring_attention(*leaves, mesh, causal=causal), leaves, tdo)
    for a, g in zip(auto, grads):
        torch.testing.assert_close(a, g, rtol=0, atol=0)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("direction", ["fwd", "bwd"])
def test_causal_step_counts_match_jax(causal, direction):
    jmesh = jmake_mesh({"sp": 8}, devices=jax.devices("cpu")[:8])
    want = [int(c) for c in np.asarray(jax.jit(
        lambda: jring.causal_step_counts(jmesh, causal=causal,
                                         direction=direction))())]
    mesh = make_mesh({"sp": 8}, [torch.device("cpu")] * 8)
    got = tring.causal_step_counts(mesh, causal=causal, direction=direction)
    assert got == want
    assert sum(got) == (36 if causal else 64)


def test_ring_folds_each_live_block_once(monkeypatch):
    """Forward runs p(p+1)/2 chunk folds at causal, one per live step,
    the diagonal one causal; backward as many chunk backward calls."""
    calls = {"fwd": [], "bwd": []}
    fold, back = tring.flash_attention_chunk, tring.flash_attention_chunk_bwd

    def spy_fold(*a, **kw):
        calls["fwd"].append(kw["causal"])
        return fold(*a, **kw)

    def spy_back(*a, **kw):
        calls["bwd"].append(kw["causal"])
        return back(*a, **kw)

    monkeypatch.setattr(tring, "flash_attention_chunk", spy_fold)
    monkeypatch.setattr(tring, "flash_attention_chunk_bwd", spy_back)
    q, k, v, do = map(torch.from_numpy, _arrays((1, 2, 16, 8), 4, seed=8))
    mesh = make_mesh({"sp": 4}, [torch.device("cpu")] * 4)
    out, lse = tring.ring_attention_fwd_lse(q, k, v, mesh, causal=True)
    tring.ring_attention_bwd(q, k, v, out, lse, do, mesh, causal=True)
    for d in ("fwd", "bwd"):
        assert len(calls[d]) == 10 and sum(calls[d]) == 4, calls


def test_make_mesh_needs_enough_devices():
    cpu = torch.device("cpu")
    mesh = make_mesh({"dp": 1, "sp": 4}, ["cpu"] * 5)
    assert mesh.devices == [cpu] * 4 and mesh.axis_devices("sp") == [cpu] * 4
    with pytest.raises(ValueError, match="needs 4 devices"):
        make_mesh({"sp": 4}, [cpu] * 3)


def test_chunk_cpu_tensors_count_no_launch():
    from paddle_tpu_torch.kernels import KERNELS, _build

    before = tfa.flash_attention_chunk.launches
    shape = (1, 2, 8, 4)
    q, k, v = map(torch.from_numpy, _arrays(shape, 3, seed=9))
    tfa.flash_attention_chunk(q, k, v, *map(torch.from_numpy,
                                            _fresh_carry(shape)))
    assert tfa.flash_attention_chunk.launches == before
    assert KERNELS["flash_chunk"] is tfa.flash_attention_chunk
    assert "flash_chunk" in _build.SOURCES
    with pytest.raises(ValueError, match="float32"):
        tfa.flash_attention_chunk(q.double(), k, v, *map(
            torch.from_numpy, _fresh_carry(shape)))
