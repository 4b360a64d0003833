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

The same on bf16 q/k/v (the sp LM under AMP), with the carry, lse and
delta float32: the carry and lse as above (the same f32 math on the
same widened operands); a bf16 output (the chunk backward's gradients,
the ring's out) within one bf16 ulp of the reference's plus 2**-12 of
its max |value| (one rounding of f32 sums taken in another order); the
ring's gradients, each a sum of p bf16-rounded steps in f32 in both
packages, within one ulp plus p ulps of the max |value| (a step's
rounding may fall on either side in the two).
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


def _bf16(a):
    """``a`` rounded to bf16 and widened back: the exact values both
    packages' bf16 arrays hold."""
    return torch.from_numpy(a).bfloat16().float().numpy()


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


# ------------------------------------------------------- bf16 (AMP)

def _port_bf16(fn, *arrays, bf16=3, **kw):
    """``fn`` on the port with the first ``bf16`` arrays as bf16 tensors
    (the rest f32); outputs widened to f32 numpy, with their dtypes."""
    args = [torch.from_numpy(a) for a in arrays]
    args[:bf16] = [a.bfloat16() for a in args[:bf16]]
    out = fn(*args, **kw)
    return ([x.float().numpy() for x in out],
            [str(x.dtype).replace("torch.", "") for x in out])


def _jax_bf16(fn, *arrays, bf16=3, **kw):
    args = [jnp.asarray(a) for a in arrays]
    args[:bf16] = [a.astype(jnp.bfloat16) for a in args[:bf16]]
    out = fn(*args, **kw)
    return ([np.array(x.astype(jnp.float32)) for x in out],
            [jnp.dtype(x.dtype).name for x in out])


def _within_ulp(got, want, floor):
    from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

    w = torch.from_numpy(want)
    err = (torch.from_numpy(got) - w).abs()
    return bool((err <= bf16_ulp(w) + floor * w.abs().max()).all())


def _seeded_bf16_carry(shape, seed):
    q, k, v = map(_bf16, _arrays(shape, 3, seed))
    return tuple(np.array(x) for x in jfa.flash_attention_chunk(
        *[jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v)],
        *map(jnp.asarray, _fresh_carry(shape)), force_xla=True))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,k_offset", [(True, 0), (True, 13),
                                             (True, 32), (False, 0)])
def test_chunk_bf16_matches_jax(shape, causal, k_offset):
    """The fold on bf16 q/k/v into an f32 carry against the reference's
    Pallas kernel in interpret mode and its XLA branch."""
    q, k, v = _arrays(shape, 3, seed=11)
    for carry in (_fresh_carry(shape), _seeded_bf16_carry(shape, 12)):
        got, dts = _port_bf16(tfa.flash_attention_chunk, q, k, v, *carry,
                              causal=causal, k_offset=k_offset)
        assert dts == ["float32"] * 3
        for mode in ({"force_xla": True}, {"interpret": True}):
            want, wdts = _jax_bf16(jfa.flash_attention_chunk, q, k, v,
                                   *carry, causal=causal,
                                   k_offset=k_offset, **mode)
            assert wdts == dts
            for g, w, name in zip(got, want, ("m", "l", "acc")):
                np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                           err_msg="%s %s" % (name, mode))
        if k_offset >= shape[2]:     # wholly in the future
            for g, c in zip(got, carry):
                np.testing.assert_array_equal(g, c)


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("causal,k_offset", [(True, 0), (True, 13),
                                             (False, 0)])
def test_chunk_bwd_bf16_matches_jax(shape, causal, k_offset):
    """The chunk backward on bf16 q/k/v, gradients in bf16: an f32
    cotangent against the reference's XLA branch (which widens it, as
    the port's CPU path does), a bf16 one also against its Pallas
    kernels in interpret mode (which cast dO to q's dtype, as the
    port's card path does) where that branch takes the mask."""
    q, k, v, do = _arrays(shape, 4, seed=13)
    qb, kb, vb = (jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v))
    m, l, acc = jfa.flash_attention_chunk(
        qb, kb, vb, *map(jnp.asarray, _fresh_carry(shape)), causal=causal,
        k_offset=k_offset, force_xla=True)
    out, lse = jfa.chunk_finalize(m, l, acc, jnp.bfloat16)
    out, lse = np.array(out.astype(jnp.float32)), np.array(lse)
    # (dO, how many leading operands are bf16): f32 dO, then bf16 dO
    for dof, n_bf16 in ((do, 3), (_bf16(do), 4)):
        delta = (dof * out).sum(-1)
        modes = [{"force_xla": True}]
        if n_bf16 == 4 and not (causal and k_offset):
            modes.append({"interpret": True})
        got, dts = _port_bf16(tfa.flash_attention_chunk_bwd, q, k, v, dof,
                              lse, delta, bf16=n_bf16, causal=causal,
                              k_offset=k_offset)
        assert dts == ["bfloat16"] * 3
        for mode in modes:
            want, wdts = _jax_bf16(jfa.flash_attention_chunk_bwd, q, k, v,
                                   dof, lse, delta, bf16=n_bf16,
                                   causal=causal, k_offset=k_offset, **mode)
            assert wdts == dts
            for g, w, name in zip(got, want, ("dq", "dk", "dv")):
                assert _within_ulp(g, w, 2 ** -12), (name, mode)
        if k_offset:      # dead rows take no gradient
            assert np.abs(got[0][:, :, :k_offset]).max() == 0.0


def test_chunk_bwd_keeps_an_f32_cotangent_on_the_cpu():
    """On the CPU the chunk backward widens an f32 dO as it is, as the
    reference's off-TPU branch does: not the bf16-rounded dO's result."""
    shape = (1, 2, 32, 8)
    q, k, v, do = _arrays(shape, 4, seed=14)
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    tdo = torch.from_numpy(do)
    out, lse = tfa.chunk_finalize(*tfa.flash_attention_chunk(
        tq, tk, tv, *map(torch.from_numpy, _fresh_carry(shape))),
        torch.bfloat16)
    delta = (tdo * out.float()).sum(-1)
    f32 = tfa.flash_attention_chunk_bwd(tq, tk, tv, tdo, lse, delta)
    want = tfa.chunk_bwd_reference(tq, tk, tv, tdo, lse, delta,
                                   8 ** -0.5, False)
    for a, w in zip(f32, want):
        assert torch.equal(a, w)
    rounded = tfa.flash_attention_chunk_bwd(tq, tk, tv, tdo.bfloat16(),
                                            lse, delta)
    assert any(not torch.equal(a, b) for a, b in zip(f32, rounded))


def _jax_ring_bf16(p, causal, q, k, v, do):
    mesh = jmake_mesh({"sp": p}, devices=jax.devices("cpu")[:p])

    def both(q, k, v, do):
        out, lse = jring.ring_attention_fwd_lse(q, k, v, mesh,
                                                causal=causal)
        return out, lse, jring.ring_attention_bwd(q, k, v, out, lse, do,
                                                  mesh, causal=causal)

    args = [jnp.asarray(a).astype(jnp.bfloat16) for a in (q, k, v, do)]
    out, lse, grads = jax.jit(both)(*args)
    assert out.dtype == jnp.bfloat16 and lse.dtype == jnp.float32
    assert all(g.dtype == jnp.bfloat16 for g in grads)
    f32 = lambda x: np.array(x.astype(jnp.float32))  # noqa: E731
    return f32(out), f32(lse), [f32(g) for g in grads]


@pytest.mark.parametrize("p", [2, 4])
@pytest.mark.parametrize("causal", [True, False])
def test_ring_bf16_matches_jax(p, causal):
    """The ring on bf16 q/k/v/dO (the sp LM under AMP) against the
    reference's ring on p host devices: out in bf16, lse in f32, the
    gradients in bf16; autograd runs the same reverse ring."""
    q, k, v, do = _arrays((2, 3, 32, 8), 4, seed=15)
    jout, jlse, jgrads = _jax_ring_bf16(p, causal, q, k, v, do)
    mesh = make_mesh({"sp": p}, [torch.device("cpu")] * p)
    tq, tk, tv, tdo = (torch.from_numpy(a).bfloat16()
                       for a in (q, k, v, do))
    out, lse = tring.ring_attention_fwd_lse(tq, tk, tv, mesh, causal=causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _within_ulp(out.float().numpy(), jout, 2 ** -12)
    np.testing.assert_allclose(lse.numpy(), jlse, atol=1e-5, rtol=0)
    grads = tring.ring_attention_bwd(tq, tk, tv, out, lse, tdo, mesh,
                                     causal=causal)
    for g, w, name in zip(grads, jgrads, "qkv"):
        assert g.dtype == torch.bfloat16
        assert _within_ulp(g.float().numpy(), w, p * 2 ** -8), name
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv)]
    auto = torch.autograd.grad(
        tring.ring_attention(*leaves, mesh, causal=causal), leaves, tdo)
    for a, g in zip(auto, grads):
        assert torch.equal(a, g)
