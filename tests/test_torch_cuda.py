"""paddle_tpu_torch's CUDA kernels against their plain PyTorch versions
on the card.  Every test is marked ``cuda`` and skips without a card
(the kernels have no CPU mode).  The file imports neither jax nor
paddle_tpu, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance atol = rtol = 1e-4: both sides accumulate in float32, in a
different order.
"""
import time

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import (flash_attention_bwd,
                                      flash_attention_fwd_lse,
                                      flash_attention_train,
                                      matmul_int8_dequant, paged_attention)
from paddle_tpu_torch.kernels import matmul_fused as pmm
from paddle_tpu_torch.kernels.flash_attention import (
    attention_reference, flash_attention_bwd_reference,
    paged_attention_reference)

TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    from paddle_tpu_torch import resolve_device

    return resolve_device("cuda")    # f32 cuBLAS and cuDNN, no TF32


@pytest.mark.cuda
@pytest.mark.parametrize("t,tk", [(16, 16), (100, 100), (256, 256),
                                  (64, 200), (1000, 1000), (300, 2048)])
def test_flash_kernel_matches_plain_on_card(cuda, t, tk):
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(2, 8, t, 128, device=cuda, generator=g)
    k, v = (torch.randn(2, 8, tk, 128, device=cuda, generator=g)
            for _ in range(2))
    for causal in (False, True):
        out, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
        ro, rl = attention_reference(q, k, v, 128 ** -0.5, causal)
        torch.testing.assert_close(out, ro, **TOL)
        torch.testing.assert_close(lse, rl, **TOL)


@pytest.mark.cuda
def test_flash_kernel_at_the_prefill_shape_on_card(cuda):
    """[1, 8, 2048, 128] causal: the serving prefill's shape, 32 Q tiles
    a head, so most K tiles of a block lie on or below the diagonal."""
    g = torch.Generator(device=cuda).manual_seed(5)
    q, k, v = (torch.randn(1, 8, 2048, 128, device=cuda, generator=g)
               for _ in range(3))
    out, lse = flash_attention_fwd_lse(q, k, v, causal=True)
    ro, rl = attention_reference(q, k, v, 128 ** -0.5, True)
    torch.testing.assert_close(out, ro, **TOL)
    torch.testing.assert_close(lse, rl, **TOL)


def _tf32_truncated(x):
    """x with the low 13 mantissa bits cleared: single-pass TF32."""
    return (x.view(torch.int32) & ~0x1FFF).view(torch.float32)


def _misses(got, want):
    return not torch.allclose(got, want, **TOL)


def _split_tf32_guard(cuda, b, seed):
    """With q and k [b, 8, 256, 128] scaled by 4 (scores of std ~16),
    the plain version fed single-pass TF32 q and k misses atol = rtol =
    1e-4, and K1 and K9, whose products are split-TF32, meet it."""
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (4 * torch.randn(b, 8, 256, 128, device=cuda, generator=g)
            for _ in range(2))
    v = torch.randn(b, 8, 256, 128, device=cuda, generator=g)
    scale = 128 ** -0.5
    ro, rl = attention_reference(q, k, v, scale, True)
    to, tl = attention_reference(_tf32_truncated(q), _tf32_truncated(k), v,
                                 scale, True)
    assert _misses(to, ro) or _misses(tl, rl)
    out, lse = flash_attention_fwd_lse(q, k, v, causal=True)
    torch.testing.assert_close(out, ro, **TOL)
    torch.testing.assert_close(lse, rl, **TOL)

    fresh = (torch.full((b, 8, 256), pfa.NEG_INF, device=cuda),
             torch.zeros(b, 8, 256, device=cuda),
             torch.zeros(b, 8, 256, 128, device=cuda))
    want = pfa.chunk_update_reference(q, k, v, *fresh, scale, True, 0)
    trunc = pfa.chunk_update_reference(_tf32_truncated(q),
                                       _tf32_truncated(k), v, *fresh, scale,
                                       True, 0)
    assert any(_misses(a, w) for a, w in zip(trunc, want))
    got = pfa.flash_attention_chunk(q, k, v, *fresh, causal=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)


@pytest.mark.cuda
def test_split_tf32_keeps_float32_precision_on_card(cuda):
    """The precision guard on 16 heads: 32 blocks of 128 rows, so the
    launchers take the 64 x 16 (Small) tiles.  This pins the hi/lo
    split of every operand there."""
    _split_tf32_guard(cuda, 2, 6)


@pytest.mark.cuda
def test_split_tf32_keeps_float32_precision_in_large_tiles_on_card(cuda):
    """The precision guard on 288 heads: 576 blocks of 128 rows, more
    than the H100's 132 SMs, so the launchers take the 128 x 32
    (Large) tiles, the form training and the ring run, whose 256
    threads split and load the tiles in other chunks than Small's."""
    _split_tf32_guard(cuda, 36, 7)


@pytest.mark.cuda
def test_flash_kernels_refuse_a_misaligned_view_on_card(cuda):
    """A contiguous view one float into its storage is not on a 16-byte
    boundary: K1 and K9 raise before any launch (their 16-byte copies
    would fault and poison the context), and the card still works."""
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    n = 8 * 64 * 128
    base = torch.randn(n + 1, device=cuda)
    bad = base[1:].view(1, 8, 64, 128)
    assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
    good = torch.randn(1, 8, 64, 128, device=cuda)
    launches = (pfa.flash_attention_fwd_lse.launches,
                pfa.flash_attention_chunk.launches)
    for args in ((bad, good, good), (good, bad, good), (good, good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_fwd_lse(*args, causal=True)
    carry = (torch.full((1, 8, 64), pfa.NEG_INF, device=cuda),
             torch.zeros(1, 8, 64, device=cuda))
    for q, acc in ((bad, torch.zeros_like(good)), (good, bad)):
        with pytest.raises(ValueError, match="16-byte"):
            pfa.flash_attention_chunk(q, good, good, *carry, acc)
    assert (pfa.flash_attention_fwd_lse.launches,
            pfa.flash_attention_chunk.launches) == launches
    out, lse = flash_attention_fwd_lse(bad.clone(), good, good, causal=True)
    ro, rl = attention_reference(bad, good, good, 128 ** -0.5, True)
    torch.testing.assert_close(out, ro, **TOL)
    torch.testing.assert_close(lse, rl, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,t,tk", [(2, 16, 16), (2, 100, 100),
                                    (1, 256, 256), (2, 64, 200),
                                    (1, 200, 64)])
def test_flash_bwd_kernels_match_plain_on_card(cuda, b, t, tk):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, do = (torch.randn(b, 8, t, 128, device=cuda, generator=g)
             for _ in range(2))
    k, v = (torch.randn(b, 8, tk, 128, device=cuda, generator=g)
            for _ in range(2))
    for causal in (False, True):
        out, lse = attention_reference(q, k, v, 128 ** -0.5, causal)
        got = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        want = flash_attention_bwd_reference(q, k, v, out, lse, do,
                                             128 ** -0.5, causal)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **TOL)


def _bwd_inputs(cuda, b, t, seed, qk_mul=1.0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, k = (qk_mul * torch.randn(b, 8, t, 128, device=cuda, generator=g)
            for _ in range(2))
    v, do = (torch.randn(b, 8, t, 128, device=cuda, generator=g)
             for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
def test_flash_bwd_split_tf32_keeps_float32_precision_on_card(cuda):
    """The precision guard for K2/K3: _split_tf32_guard's inputs (q and k
    [2, 8, 256, 128] scaled by 4) through the backward.  The plain
    backward fed single-pass TF32 q and k misses atol = rtol = 1e-4;
    K2 and K3, whose seven products are split-TF32, meet it."""
    q, k, v, do = _bwd_inputs(cuda, 2, 256, 6, qk_mul=4.0)
    scale = 128 ** -0.5
    out, lse = attention_reference(q, k, v, scale, True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, scale, True)
    trunc = flash_attention_bwd_reference(
        _tf32_truncated(q), _tf32_truncated(k), v, out, lse, do, scale, True)
    assert any(_misses(a, w) for a, w in zip(trunc, want))
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)


@pytest.mark.cuda
def test_flash_bwd_kernels_are_deterministic_on_card(cuda):
    """Each gradient element is written by exactly one block, with no
    atomics: two calls on the same inputs are bit-identical."""
    q, k, v, do = _bwd_inputs(cuda, 2, 1000, 9)
    for causal in (True, False):
        out, lse = attention_reference(q, k, v, 128 ** -0.5, causal)
        first = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        second = flash_attention_bwd(q, k, v, out, lse, do, causal=causal)
        for a, b in zip(first, second):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_bwd_kernels_refuse_a_misaligned_view_on_card(cuda):
    """K2 and K3 copy q, k, v and dO in 16-byte chunks: a contiguous view
    one float into its storage raises ValueError before any launch, and
    the card still works afterwards."""
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    n = 8 * 64 * 128
    base = torch.randn(n + 1, device=cuda)
    bad = base[1:].view(1, 8, 64, 128)
    assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
    q, k, v, do = _bwd_inputs(cuda, 1, 64, 3)
    out, lse = attention_reference(q, k, v, 128 ** -0.5, True)
    launches = (pfa.flash_bwd_dq.launches, pfa.flash_bwd_dkv.launches)
    for i in (0, 1, 2, 5):               # q, k, v, do
        args = [q, k, v, out, lse, do]
        args[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_bwd(*args, causal=True)
    assert (pfa.flash_bwd_dq.launches,
            pfa.flash_bwd_dkv.launches) == launches
    got = flash_attention_bwd(q, k, v, out, lse, bad.clone(), causal=True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, bad,
                                         128 ** -0.5, True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)


@pytest.mark.cuda
def test_flash_chunk_bwd_ring_diagonal_on_card(cuda):
    """The ring's causal diagonal step at [2, 8, 512, 128] (a shard of a
    2048-token sequence at sp = 4) through K2/K3 against
    chunk_bwd_reference."""
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    q, k, v, do = _bwd_inputs(cuda, 2, 512, 10)
    scale = 128 ** -0.5
    out, lse = attention_reference(q, k, v, scale, True)
    delta = (do * out).sum(-1)
    got = pfa.flash_attention_chunk_bwd(q, k, v, do, lse, delta,
                                        causal=True)
    want = pfa.chunk_bwd_reference(q, k, v, do, lse, delta, scale, True)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)


@pytest.mark.cuda
def test_flash_train_autograd_runs_the_kernels(cuda):
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(1, 8, 128, 128, device=cuda, generator=g,
                           requires_grad=True) for _ in range(3))
    w = torch.randn(1, 8, 128, 128, device=cuda, generator=g)
    out, _ = flash_attention_train(q, k, v, causal=True)
    grads = torch.autograd.grad((out * w).sum(), (q, k, v))
    qd, kd, vd = (x.detach().requires_grad_() for x in (q, k, v))
    ref, _ = attention_reference(qd, kd, vd, 128 ** -0.5, True)
    want = torch.autograd.grad((ref * w).sum(), (qd, kd, vd))
    for a, b in zip(grads, want):
        torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("b,nb", [(1, 1), (3, 8), (16, 128)])
def test_paged_kernel_matches_plain_on_card(cuda, b, nb):
    bs = 16
    g = torch.Generator(device=cuda).manual_seed(0)
    q = torch.randn(b, 8, 128, device=cuda, generator=g)
    kp = torch.randn(64, bs, 8, 128, device=cuda, generator=g)
    vp = torch.randn(64, bs, 8, 128, device=cuda, generator=g)
    tables = torch.randint(1, 64, (b, nb), device=cuda, generator=g,
                           dtype=torch.int32)
    lens = torch.randint(1, nb * bs + 1, (b,), device=cuda, generator=g,
                         dtype=torch.int32)
    out = paged_attention(q, kp, vp, tables, lens)
    ref = paged_attention_reference(q, kp, vp, tables, lens, 128 ** -0.5)
    torch.testing.assert_close(out, ref, **TOL)


def _paged_distinct(cuda, lens, nb, seed):
    """q, pages and tables for ``lens`` at width ``nb``: every live
    page a distinct id from a pool of B x NB + 1 (page 0 unused), slots
    past the live pages 0, as the engine pads them."""
    b, bs = len(lens), 16
    g = torch.Generator(device=cuda).manual_seed(seed)
    n = b * nb + 1
    q = torch.randn(b, 8, 128, device=cuda, generator=g)
    kp = torch.randn(n, bs, 8, 128, device=cuda, generator=g)
    vp = torch.randn(n, bs, 8, 128, device=cuda, generator=g)
    ids = torch.randperm(n - 1, device=cuda, generator=g).reshape(b, nb)
    live = torch.arange(nb, device=cuda)[None] * bs < torch.tensor(
        lens, device=cuda)[:, None]
    tables = torch.where(live, ids + 1, 0).to(torch.int32)
    return q, kp, vp, tables, torch.tensor(lens, dtype=torch.int32,
                                           device=cuda)


def _paged_check(q, kp, vp, tables, lens):
    out = paged_attention(q, kp, vp, tables, lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, paged_attention_reference(
        q, kp, vp, tables, lens, 128 ** -0.5), **TOL)
    return out


@pytest.mark.cuda
def test_paged_kernel_one_long_row_on_card(cuda):
    """B = 1 at NB = 128 with 2048 tokens on distinct pages: 16 spans
    a head, folded by the second launch."""
    _paged_check(*_paged_distinct(cuda, [2048], 128, 1))


@pytest.mark.cuda
def test_paged_kernel_at_span_boundaries_on_card(cuda):
    """Contexts around the span length P x 16 tokens: one position, a
    span short by one, one span, one past it, two spans, the table."""
    from paddle_tpu_torch.kernels.flash_attention import paged_span_pages

    t = paged_span_pages() * 16
    lens = [1, 15, 16, 17, t - 1, t, t + 1, 2 * t, 2 * t + 1, 2048]
    _paged_check(*_paged_distinct(cuda, lens, 128, 2))


@pytest.mark.cuda
@pytest.mark.parametrize("row", [0, 1, 5, 15])
def test_paged_kernel_rows_are_batch_invariant_on_card(cuda, row):
    """A row alone, in its own block-count bucket, gives bit for bit its
    row of a B = 16, NB = 128 call."""
    lens = [2048, 1, 129, 700, 1024, 128, 16, 17, 1500, 300, 64, 2000,
            5, 777, 1023, 1025]
    q, kp, vp, tables, lens_t = _paged_distinct(cuda, lens, 128, 3)
    wide = _paged_check(q, kp, vp, tables, lens_t)
    pages = -(-lens[row] // 16)
    nb_own = 1 << (pages - 1).bit_length()
    alone = paged_attention(q[row:row + 1].contiguous(), kp, vp,
                            tables[row:row + 1, :nb_own].contiguous(),
                            lens_t[row:row + 1].contiguous())
    assert torch.equal(alone[0], wide[row])


@pytest.mark.cuda
def test_paged_kernel_is_deterministic_on_card(cuda):
    args = _paged_distinct(cuda, [2048, 5, 1000, 129], 128, 4)
    assert torch.equal(paged_attention(*args), paged_attention(*args))


@pytest.mark.cuda
@pytest.mark.parametrize("hole", [-1, 2 ** 31 - 1])
def test_paged_kernel_never_reads_slots_past_the_context_on_card(cuda,
                                                                 hole):
    """Table slots past each row's context hold an id no page has: the
    kernel runs without a fault and gives the result of real pages."""
    lens = [1, 16, 17, 128, 129, 1000, 2047]
    q, kp, vp, tables, lens_t = _paged_distinct(cuda, lens, 128, 5)
    live = torch.arange(128, device=cuda)[None] * 16 < lens_t[:, None]
    holes = torch.where(live, tables, hole).to(torch.int32)
    out = paged_attention(q, kp, vp, holes, lens_t)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, paged_attention_reference(
        q, kp, vp, tables, lens_t, 128 ** -0.5), **TOL)


@pytest.mark.cuda
def test_paged_kernel_refuses_a_misaligned_q_on_card(cuda):
    q, kp, vp, tables, lens = _paged_distinct(cuda, [40], 8, 6)
    flat = torch.zeros(q.numel() + 1, device=cuda)
    q1 = flat[1:].view_as(q)
    q1.copy_(q)
    launches = paged_attention.launches
    with pytest.raises(ValueError, match="16-byte"):
        paged_attention(q1, kp, vp, tables, lens)
    assert paged_attention.launches == launches
    _paged_check(q, kp, vp, tables, lens)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 3, 8, 16, 100])
def test_int8_kernel_matches_plain_on_card(cuda, m):
    rng = np.random.RandomState(0)
    w = (rng.randn(1024, 256) * 0.1).astype(np.float32)
    q, s, chunk = pmm.quantize_weight(w, chunk=256)
    q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    x = torch.from_numpy(rng.randn(m, 1024).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(256).astype(np.float32)).to(cuda)
    res = torch.from_numpy(rng.randn(m, 256).astype(np.float32)).to(cuda)
    for act in ("", "relu", "gelu"):
        out = matmul_int8_dequant(x, q, s, chunk, bias, res, act)
        ref = pmm.matmul_int8_reference(x, q, s, chunk, bias, res, act)
        torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.cuda
def test_int8_decode_rows_are_batch_invariant(cuda):
    """A row's result does not depend on how many rows share the call
    (decode buckets M = 1..16 run one kernel with one summation order)."""
    rng = np.random.RandomState(1)
    w = (rng.randn(1024, 512) * 0.1).astype(np.float32)
    q, s, chunk = pmm.quantize_weight(w)
    q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    x = torch.from_numpy(rng.randn(16, 1024).astype(np.float32)).to(cuda)
    full = matmul_int8_dequant(x, q, s, chunk)
    for m in (1, 2, 4, 8):
        assert torch.equal(matmul_int8_dequant(x[:m].contiguous(), q, s,
                                               chunk), full[:m])


def _epilogues(bias, res):
    """Every epilogue: act x (bias, residual) combinations."""
    return [(act, b, r) for act in ("", "relu", "gelu")
            for b, r in ((None, None), (bias, None), (bias, res),
                         (None, res))]


@pytest.mark.cuda
@pytest.mark.parametrize("chunk", [None, 256])
@pytest.mark.parametrize("m", [17, 100, 1000, 1024, 2048])
def test_int8_prefill_kernel_matches_plain_on_card(cuda, m, chunk):
    """K8's prefill form (M > 16, the split-TF32 GEMM tile) at K = 4096:
    two default chunks of 2048 or sixteen of 256, every epilogue; N =
    1536 (16-byte weight rows; both tile forms over the M range) and
    N = 1000 (4-byte copies)."""
    rng = np.random.RandomState(2)
    k = 4096
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda)
    for n in (1536, 1000):
        w = (rng.randn(k, n) * 0.1).astype(np.float32)
        q, s, ch = pmm.quantize_weight(w, chunk=chunk)
        assert ch == (chunk or 2048)
        q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
        bias = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
        res = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(cuda)
        for act, b, r in _epilogues(bias, res):
            out = matmul_int8_dequant(x, q, s, ch, b, r, act)
            ref = pmm.matmul_int8_reference(x, q, s, ch, b, r, act)
            torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m", [1, 5, 16])
def test_int8_decode_kernel_on_4byte_rows_on_card(cuda, m):
    """K8's decode form (M <= 16) where N % 16 != 0, so its weight rows
    take 4-byte copies: K = 4096 over sixteen chunks of 256, every
    epilogue."""
    rng = np.random.RandomState(5)
    k, n = 4096, 1000
    w = (rng.randn(k, n) * 0.1).astype(np.float32)
    q, s, chunk = pmm.quantize_weight(w, chunk=256)
    q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    x = torch.from_numpy(rng.randn(m, k).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(n).astype(np.float32)).to(cuda)
    res = torch.from_numpy(rng.randn(m, n).astype(np.float32)).to(cuda)
    assert pmm.tile_form("matmul_int8", m, n) == "decode"
    for act, b, r in _epilogues(bias, res):
        out = matmul_int8_dequant(x, q, s, chunk, b, r, act)
        ref = pmm.matmul_int8_reference(x, q, s, chunk, b, r, act)
        torch.testing.assert_close(out, ref, **TOL)


@pytest.mark.cuda
def test_int8_prefill_rows_are_batch_invariant(cuda):
    """A prefill row's result does not depend on the batch it is in:
    rows of an M = 64 call (the Small tile form) equal the same rows of
    an M = 1024 call (the Large form) bit for bit."""
    rng = np.random.RandomState(3)
    w = (rng.randn(1024, 3072) * 0.1).astype(np.float32)
    q, s, chunk = pmm.quantize_weight(w)
    q, s = torch.from_numpy(q).to(cuda), torch.from_numpy(s).to(cuda)
    x = torch.from_numpy(rng.randn(1024, 1024).astype(np.float32)).to(cuda)
    assert pmm.tile_form("matmul_int8", 64, 3072) != \
        pmm.tile_form("matmul_int8", 1024, 3072)
    full = matmul_int8_dequant(x, q, s, chunk)
    for r0 in (0, 512, 960):
        part = matmul_int8_dequant(x[r0:r0 + 64].contiguous(), q, s, chunk)
        assert torch.equal(part, full[r0:r0 + 64])


@pytest.mark.cuda
@pytest.mark.parametrize("m,n", [(4096, 1024), (300, 1001)])
def test_matmul_epilogue_kernel_at_k4096_on_card(cuda, m, n):
    """K4 over K = 4096 (fc2's depth, 128 K tiles each summed in a fresh
    fragment), every epilogue, out and pre: the Large form with
    16-byte copies and the Small form with 4-byte ones."""
    rng = np.random.RandomState(4)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(cuda)

    x, w = t(m, 4096), t(4096, n, scale=4096 ** -0.5)
    bias, res = t(n), t(m, n)
    for act, b, r in _epilogues(bias, res):
        out, pre = pmm.matmul_epilogue(x, w, b, r, act, save_preact=True)
        want, want_pre = pmm.matmul_epilogue_reference(x, w, b, r, act)
        torch.testing.assert_close(out, want, **TOL)
        torch.testing.assert_close(pre, want_pre, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", [(33, 4, 7), (100, 68, 130),
                                   (128, 256, 256), (257, 1024, 3072),
                                   (2048, 1024, 1024)])
def test_matmul_epilogue_kernel_matches_plain_on_card(cuda, m, k, n):
    """K4 for every epilogue (act x bias x residual x pre), ragged M and
    N edges and N % 4 != 0 (the scalar-load instantiation) included."""
    rng = np.random.RandomState(0)

    def t(*shape, scale=1.0):
        return torch.from_numpy(
            (rng.randn(*shape) * scale).astype(np.float32)).to(cuda)

    x, w = t(m, k), t(k, n, scale=k ** -0.5)
    bias, res = t(n), t(m, n)
    for act in ("", "relu", "gelu"):
        for b, r in ((None, None), (bias, None), (bias, res), (None, res)):
            out, pre = pmm.matmul_epilogue(x, w, b, r, act,
                                           save_preact=True)
            want, want_pre = pmm.matmul_epilogue_reference(x, w, b, r, act)
            torch.testing.assert_close(out, want, **TOL)
            torch.testing.assert_close(pre, want_pre, **TOL)
            torch.testing.assert_close(
                pmm.matmul_epilogue(x, w, b, r, act), want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(1, 4), (37, 100), (64, 256), (8, 640),
                                 (300, 1024)])
def test_add_ln_kernel_matches_plain_on_card(cuda, m, d):
    rng = np.random.RandomState(1)
    x, y = (torch.from_numpy(rng.randn(m, d).astype(np.float32)).to(cuda)
            for _ in range(2))
    scale = torch.from_numpy(
        (rng.rand(d) + 0.5).astype(np.float32)).to(cuda)
    bias = torch.from_numpy(rng.randn(d).astype(np.float32)).to(cuda)
    for sc, bi in ((None, None), (scale, bias), (scale, None)):
        got = pmm.add_ln(x, y, sc, bi)
        want = pmm.add_ln_reference(x, y, sc, bi)
        for a, b in zip(got, want):
            torch.testing.assert_close(a, b, **TOL)


@pytest.mark.cuda
def test_fused_wrappers_raise_on_what_the_kernels_do_not_take(cuda):
    x = torch.randn(8, 6, device=cuda)                   # K = 6
    with pytest.raises(ValueError, match="multiple of 4"):
        pmm.matmul_epilogue(x, torch.randn(6, 8, device=cuda))
    w = torch.randn(8, 4, device=cuda).t()               # not contiguous
    with pytest.raises(ValueError, match="contiguous"):
        pmm.matmul_epilogue(torch.randn(3, 4, device=cuda), w)
    big = torch.randn(4, 2048, device=cuda)              # D > 1024
    with pytest.raises(ValueError, match="1024"):
        pmm.add_ln(big, big)


@pytest.mark.cuda
def test_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    q = torch.randn(1, 2, 16, 96, device=cuda)       # head_dim 96
    with pytest.raises(ValueError, match="head_dim"):
        flash_attention_fwd_lse(q, q, q)
    q = torch.randn(1, 2, 16, 128, device=cuda).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        flash_attention_fwd_lse(q, q, q)
    pages = torch.randn(4, 8, 2, 128, device=cuda)   # block_size 8
    tables = torch.ones(1, 2, dtype=torch.int32, device=cuda)
    lens = torch.ones(1, dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError, match="block_size"):
        paged_attention(torch.randn(1, 2, 128, device=cuda), pages, pages,
                        tables, lens)


@pytest.mark.cuda
def test_executor_step_on_card_runs_the_flash_kernels(cuda):
    """One training step of a small LM with head_dim 128 through
    Executor(CUDAPlace(0)): K1 once and K2/K3 once per layer, and the
    card's loss is the CPU executor's from the same parameters."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(
            vocab_size=64, seq_len=128, d_model=256, n_head=2, n_layers=2,
            d_ff=64)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    toks = np.random.RandomState(0).randint(0, 64, (2, 129))
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    reset_launches()
    got, = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=[loss], scope=card)
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 2, counts
    want, = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=[loss], scope=host)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.cuda
def test_executor_fused_step_on_card_runs_the_fused_kernels(cuda):
    """One training step of the small fused LM (FLAGS_transformer_fuse)
    through Executor(CUDAPlace(0)): per layer one QKV, three epilogue
    matmuls and two add + LN seams, plus the lm_head; the card's loss
    and gradients are the CPU executor's from the same parameters."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(
            vocab_size=64, seq_len=128, d_model=256, n_head=2, n_layers=2,
            d_ff=64, fuse_transformer=True)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    fetch = [loss.name] + sorted(p.name + "@GRAD"
                                 for p in main.all_parameters())
    toks = np.random.RandomState(0).randint(0, 64, (2, 129))
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=card)
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    assert counts["matmul_epilogue"] == 2 * 4 + 1, counts
    assert counts["add_ln"] == 2 * 2, counts
    assert counts["flash_fwd"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 2, counts
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        # relative Frobenius norm, as chip_smoke.py's oracle: a relu
        # input within rounding of 0 may take the other branch
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), name


# K6: every epilogue combination on ragged shapes -- M not a multiple of
# the tile, the stem's 4-byte gather (Ci = 3, 7x7, stride 2, padding 3),
# Co = 64, 3x3 and 1x1 stages with 16-byte gathers, Ci = 40 (K tiles
# that span taps), a stride-2 1x1
CONV_SHAPES = [(3, 23, 3, 64, 7, 2, 3), (2, 9, 64, 128, 3, 1, 1),
               (2, 7, 256, 68, 1, 2, 0), (1, 5, 40, 256, 3, 1, 1)]


# K6 at the widths of the ResNet-50 path: K = 4608 with M = 196 (ragged
# against the 128-row tile), a Co = 64 3x3 stage at 56 x 56, the stem at
# 224 x 224 (Ci = 3, K = 147: the 4-byte gather)
CONV_WIDE_SHAPES = [(4, 7, 512, 512, 3, 1, 1), (2, 56, 64, 64, 3, 1, 1),
                    (2, 224, 3, 64, 7, 2, 3)]


def _conv_operands(cuda, shape, seed=3):
    n, h, ci, co, k, s, p = shape
    g = torch.Generator(device=cuda).manual_seed(seed)
    x = torch.randn(n, h, h, ci, device=cuda, generator=g)
    w = torch.randn(k, k, ci, co, device=cuda, generator=g) * \
        (k * k * ci) ** -0.5
    ho = (h + 2 * p - k) // s + 1
    a = torch.rand(co, device=cuda, generator=g) + 0.5
    b = torch.randn(co, device=cuda, generator=g)
    r = torch.randn(n, ho, ho, co, device=cuda, generator=g)
    return x, w, a, b, r


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES)
def test_conv_stage_kernel_matches_plain_on_card(cuda, shape):
    _conv_every_epilogue(cuda, shape)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_WIDE_SHAPES)
def test_conv_stage_kernel_at_path_widths_on_card(cuda, shape):
    _conv_every_epilogue(cuda, shape)


def _conv_every_epilogue(cuda, shape):
    from paddle_tpu_torch.kernels import conv_fused as pcf

    n, h, ci, co, k, s, p = shape
    x, w, a, b, r = _conv_operands(cuda, shape)
    for stats in (False, True):
        for affine in (None, (a, b)):
            for res in (None, r):
                for act in ("", "relu"):
                    kw = dict(stats=stats, affine=affine, residual=res,
                              act=act)
                    got = pcf.conv2d_nhwc(x, w, (s, s), (p, p), **kw)
                    want = pcf.conv2d_nhwc_reference(x, w, (s, s), (p, p),
                                                     **kw)
                    if not stats:
                        got, want = (got,), (want,)
                    torch.testing.assert_close(got[0], want[0], **TOL)
                    if stats:
                        _, rel = pcf.stats_error(x, w, (s, s), (p, p),
                                                 got[1], got[2])
                        assert rel <= pcf.STATS_RTOL, rel


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_WIDE_SHAPES)
def test_conv_stage_kernel_is_deterministic_on_card(cuda, shape):
    """Two calls with stats give bit-identical outputs and sums: no
    atomics, one summation order."""
    from paddle_tpu_torch.kernels import conv_fused as pcf

    _, _, _, _, _, s, p = shape
    x, w, a, b, r = _conv_operands(cuda, shape, seed=4)
    for kw in (dict(stats=True),
               dict(stats=True, affine=(a, b), residual=r, act="relu")):
        one = pcf.conv2d_nhwc(x, w, (s, s), (p, p), **kw)
        two = pcf.conv2d_nhwc(x, w, (s, s), (p, p), **kw)
        for u, v in zip(one, two):
            assert torch.equal(u, v)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_SHAPES + CONV_WIDE_SHAPES)
def test_conv_stage_tile_gives_the_partials_rows(cuda, shape):
    """conv_stage_tile's rows are the output pixels the kernel writes a
    row of partials for (its M tile, 128): it fills ceil(M / rows) rows
    and not one more, and their sums are the output's."""
    from paddle_tpu_torch.kernels import conv_fused as pcf

    n, h, ci, co, k, s, p = shape
    x, w, _, _, _ = _conv_operands(cuda, shape)
    ho = (h + 2 * p - k) // s + 1
    m = n * ho * ho
    bm, bn = pcf.conv_stage_tile(ci, co)
    assert (bm, bn) == (128, 64)
    assert pcf.conv_stage_form(ci, co) == "mma.sync 128x64"
    rows = -(-m // bm)
    parts = torch.full((rows + 1, 2, co), float("nan"), device=cuda)
    out = torch.empty(n, ho, ho, co, device=cuda)
    pcf._launch(x, w, (s, s), (p, p), None, None, "", out, parts)
    torch.cuda.synchronize()
    assert torch.isfinite(parts[:rows]).all()
    assert torch.isnan(parts[rows]).all()
    flat = out.reshape(-1, co).double()
    torch.testing.assert_close(parts[:rows].double().sum(0),
                               torch.stack([flat.sum(0),
                                            flat.square().sum(0)]),
                               rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_conv_stage_wrapper_raises_on_what_the_kernel_does_not_take(cuda):
    from paddle_tpu_torch.kernels import conv_fused as pcf

    x = torch.randn(1, 8, 8, 16, device=cuda)
    with pytest.raises(ValueError, match="multiple of 4"):
        pcf.conv2d_nhwc(x, torch.randn(3, 3, 16, 6, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        pcf.conv2d_nhwc(x.transpose(1, 2), torch.randn(3, 3, 16, 8,
                                                       device=cuda))
    with pytest.raises(ValueError, match="float32"):
        pcf.conv2d_nhwc(x.double(), torch.randn(3, 3, 16, 8, device=cuda,
                                                dtype=torch.float64))


# K6's bf16 form: on mma.sync the stem (Ci = 3, padded to 4 channels for
# the 8-byte gather) at a ragged size and at 224 x 224 and Ci = 12 (the
# 8-byte gather unpadded); on wgmma (x by TMA's im2col mode) Ci = 5
# (padded to 8), a ragged K tail (Ci = 40: each tap's 64-channel box
# past Ci), a Co = 64 3x3 stage at 56 x 56 (the 128 x 64 tile), Co =
# 2048 (the last 1x1 expansion), a strided 1x1 at ragged M (M = 75), a
# 7 x 7 3x3 stage at Ci = Co = 512 (K = 4608, M = 98) and a Co = 64 1x1
# at ragged M (M = 363)
CONV_BF16_SHAPES = [(3, 23, 3, 64, 7, 2, 3), (2, 224, 3, 64, 7, 2, 3),
                    (2, 9, 12, 64, 3, 1, 1), (2, 9, 5, 64, 3, 1, 1),
                    (1, 5, 40, 256, 3, 1, 1), (2, 56, 64, 64, 3, 1, 1),
                    (4, 7, 512, 2048, 1, 1, 0), (3, 9, 256, 512, 1, 2, 0),
                    (2, 7, 512, 512, 3, 1, 1), (3, 11, 256, 64, 1, 1, 0)]


def _assert_within_one_bf16_ulp(got, want):
    """Each value one rounding of two f32 sums that differ in order:
    within one bf16 ulp of the plain value, plus 1e-6 of max |Y|."""
    from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

    assert got.dtype == want.dtype == torch.bfloat16
    want = want.float()
    err = (got.float() - want).abs()
    bound = bf16_ulp(want) + 1e-6 * want.abs().max()
    assert bool((err <= bound).all()), float((err / bound).max())


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_BF16_SHAPES)
def test_conv_stage_bf16_kernel_matches_plain_on_card(cuda, shape):
    from paddle_tpu_torch.kernels import conv_fused as pcf

    n, h, ci, co, k, s, p = shape
    x, w, a, b, r = _conv_operands(cuda, shape, seed=6)
    x, w, r = (t.to(torch.bfloat16) for t in (x, w, r))
    for stats in (False, True):
        for affine in (None, (a, b)):
            for res in (None, r):
                for act in ("", "relu"):
                    kw = dict(stats=stats, affine=affine, residual=res,
                              act=act)
                    got = pcf.conv2d_nhwc(x, w, (s, s), (p, p), **kw)
                    want = pcf.conv2d_nhwc_reference(x, w, (s, s), (p, p),
                                                     **kw)
                    if not stats:
                        got, want = (got,), (want,)
                    _assert_within_one_bf16_ulp(got[0], want[0])
                    if stats:
                        assert got[1].dtype == got[2].dtype == torch.float32
                        _, rel = pcf.stats_error(x, w, (s, s), (p, p),
                                                 got[1], got[2])
                        assert rel <= pcf.STATS_RTOL, rel


@pytest.mark.cuda
def test_conv_stage_forms_count_their_own_launches_on_card(cuda):
    """float32 operands launch the split-TF32 form, bf16 operands the
    bf16 form, each counted on its own wrapper."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.kernels import conv_fused as pcf

    x, w, _, _, _ = _conv_operands(cuda, (2, 9, 64, 128, 3, 1, 1))
    reset_launches()
    pcf.conv2d_nhwc(x, w, (1, 1), (1, 1), stats=True)
    assert (KERNELS["conv_stage"].launches,
            KERNELS["conv_stage_bf16"].launches) == (1, 0)
    y = pcf.conv2d_nhwc(x.bfloat16(), w.bfloat16(), (1, 1), (1, 1))
    pcf.conv2d_nhwc_bf16(x.bfloat16(), w.bfloat16(), (1, 1), (1, 1))
    assert y.dtype == torch.bfloat16
    assert (KERNELS["conv_stage"].launches,
            KERNELS["conv_stage_bf16"].launches) == (1, 2)


@pytest.mark.cuda
def test_conv_stage_bf16_form_refuses_mixed_dtypes_on_card(cuda):
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.kernels import conv_fused as pcf

    x, w, a, b, r = _conv_operands(cuda, (2, 9, 64, 128, 3, 1, 1))
    xb, wb, rb = x.bfloat16(), w.bfloat16(), r.bfloat16()
    reset_launches()
    for args, kw in (((xb, w), {}), ((x, wb), {}),
                     ((xb, wb), dict(residual=r)),
                     ((x, w), dict(residual=rb))):
        with pytest.raises(ValueError, match="all float32 or all bfloat16"):
            pcf.conv2d_nhwc(*args, (1, 1), (1, 1), **kw)
    with pytest.raises(ValueError, match="multiple of 8"):
        pcf.conv2d_nhwc(xb, torch.randn(3, 3, 64, 12, device=cuda,
                                        dtype=torch.bfloat16))
    assert KERNELS["conv_stage"].launches == 0
    assert KERNELS["conv_stage_bf16"].launches == 0
    # bf16 x and w with the f32 affine (a, b) is the form's own input
    y = pcf.conv2d_nhwc(xb, wb, (1, 1), (1, 1), affine=(a, b),
                        residual=rb, act="relu")
    _assert_within_one_bf16_ulp(y, pcf.conv2d_nhwc_reference(
        xb, wb, (1, 1), (1, 1), affine=(a, b), residual=rb, act="relu"))


@pytest.mark.cuda
def test_conv_stage_bf16_kernel_is_deterministic_on_card(cuda):
    from paddle_tpu_torch.kernels import conv_fused as pcf

    x, w, a, b, r = _conv_operands(cuda, (4, 7, 512, 512, 3, 1, 1), seed=4)
    x, w, r = x.bfloat16(), w.bfloat16(), r.bfloat16()
    for kw in (dict(stats=True),
               dict(stats=True, affine=(a, b), residual=r, act="relu")):
        one = pcf.conv2d_nhwc(x, w, (1, 1), (1, 1), **kw)
        two = pcf.conv2d_nhwc(x, w, (1, 1), (1, 1), **kw)
        for u, v in zip(one, two):
            assert torch.equal(u, v)


# K6's bf16 wgmma form on windows that are not square: x [N, H, W, Ci],
# w [KH, KW, Ci, Co], strides and paddings (h, w), where TMA's im2col
# corners and offsets {W, H} would show a swap
CONV_BF16_RECT = [(2, 9, 11, 16, 64, 1, 3, (2, 1), (0, 1)),
                  (3, 7, 5, 24, 128, 3, 1, (1, 2), (1, 0)),
                  (2, 12, 10, 8, 64, 5, 3, (2, 3), (2, 1))]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_BF16_RECT)
def test_conv_stage_bf16_rectangular_windows_on_card(cuda, shape):
    from paddle_tpu_torch.kernels import conv_fused as pcf

    n, h, wd, ci, co, kh, kw, s, p = shape
    g = torch.Generator(device=cuda).manual_seed(10)
    x = torch.randn(n, h, wd, ci, device=cuda, generator=g).bfloat16()
    w = (torch.randn(kh, kw, ci, co, device=cuda, generator=g)
         * (kh * kw * ci) ** -0.5).bfloat16()
    ho, wo = (h + 2 * p[0] - kh) // s[0] + 1, (wd + 2 * p[1] - kw) // s[1] + 1
    a = torch.rand(co, device=cuda, generator=g) + 0.5
    b = torch.randn(co, device=cuda, generator=g)
    r = torch.randn(n, ho, wo, co, device=cuda, generator=g).bfloat16()
    assert pcf.conv_stage_form(ci, co, torch.bfloat16).startswith("wgmma")
    for kw_ in (dict(stats=True),
                dict(stats=True, affine=(a, b), residual=r, act="relu")):
        got = pcf.conv2d_nhwc(x, w, s, p, **kw_)
        want = pcf.conv2d_nhwc_reference(x, w, s, p, **kw_)
        _assert_within_one_bf16_ulp(got[0], want[0])
        _, rel = pcf.stats_error(x, w, s, p, got[1], got[2])
        assert rel <= pcf.STATS_RTOL, rel


def _bf16_launch(x, w, s, p, blocks=0, **kw):
    """One launch of K6's bf16 form through its launcher, the grid
    capped to ``blocks`` if > 0: (out, partials)."""
    from paddle_tpu_torch.kernels import conv_fused as pcf

    n, h, _, ci = x.shape
    k, _, _, co = w.shape
    ho = (h + 2 * p - k) // s + 1
    rows, _ = pcf.conv_stage_tile(ci, co, torch.bfloat16)
    out = torch.empty(n, ho, ho, co, device=x.device, dtype=torch.bfloat16)
    parts = torch.empty(-(-n * ho * ho // rows), 2, co, device=x.device)
    pcf._launch(x, w, (s, s), (p, p), kw.get("affine"), kw.get("residual"),
                kw.get("act", ""), out, parts, blocks=blocks)
    return out, parts


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 7, 512, 512, 3, 1, 1),
                                   (3, 11, 256, 64, 1, 1, 0),
                                   (3, 9, 256, 512, 1, 2, 0)])
def test_conv_stage_bf16_wgmma_sums_in_one_order_on_card(cuda, shape):
    """The wgmma form's outputs and partials are bit-identical across
    calls and on a persistent grid capped to 1 or 3 blocks: each tile
    walks its K tiles and groups in one order whatever the grid."""
    _, _, ci, co, _, s, p = shape
    x, w, a, b, r = _conv_operands(cuda, shape, seed=7)
    x, w, r = x.bfloat16(), w.bfloat16(), r.bfloat16()
    kw = dict(affine=(a, b), residual=r, act="relu")
    one = _bf16_launch(x, w, s, p, **kw)
    for blocks in (0, 1, 3):
        two = _bf16_launch(x, w, s, p, blocks, **kw)
        assert torch.equal(one[0], two[0]) and torch.equal(one[1], two[1])


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CONV_BF16_SHAPES)
def test_conv_stage_bf16_tile_gives_the_partials_rows(cuda, shape):
    """conv_stage_tile for bf16 names the rows of partials the running
    form writes -- a warpgroup's 64 on the wgmma tile, 128 on mma.sync --
    and the tile's width: it fills ceil(M / rows) rows and not one more,
    and their sums are the raw conv's."""
    from paddle_tpu_torch.kernels import conv_fused as pcf

    n, h, ci, co, k, s, p = shape
    x, w, _, _, _ = _conv_operands(cuda, shape, seed=8)
    x, w = x.bfloat16(), w.bfloat16()
    cil = ci + (-ci) % 4   # as launched: the wrapper pads Ci to 4
    rows, bn = pcf.conv_stage_tile(cil, co, torch.bfloat16)
    if cil % 8 == 0:
        assert (rows, bn) == (64, 128 if co >= 128 else 64)
        assert pcf.conv_stage_form(cil, co, torch.bfloat16) == \
            "wgmma 128x%d" % bn
    else:
        assert (rows, bn) == (128, 64)
        assert pcf.conv_stage_form(cil, co, torch.bfloat16) == \
            "mma.sync 128x64"
    if cil != ci:
        x = torch.nn.functional.pad(x, (0, cil - ci))
        w = torch.nn.functional.pad(w, (0, 0, 0, cil - ci))
    ho = (h + 2 * p - k) // s + 1
    m = n * ho * ho
    used = -(-m // rows)
    parts = torch.full((used + 1, 2, co), float("nan"), device=cuda)
    out = torch.empty(n, ho, ho, co, device=cuda, dtype=torch.bfloat16)
    pcf._launch(x, w, (s, s), (p, p), None, None, "", out, parts)
    torch.cuda.synchronize()
    assert torch.isfinite(parts[:used]).all()
    assert torch.isnan(parts[used]).all()
    sums = parts[:used].sum(0)
    _, rel = pcf.stats_error(x, w, (s, s), (p, p), sums[0], sums[1])
    assert rel <= pcf.STATS_RTOL, rel


def _conv_kernel_names(x, w, s=1, p=1):
    from paddle_tpu_torch.kernels.conv_fused import conv2d_nhwc

    names = _kernel_names(lambda: conv2d_nhwc(x, w, (s, s), (p, p),
                                              stats=True))
    wgmma = any("conv_wgmma_kernel" in n for n in names)
    mma_sync = any("gemm::bf16_kernel" in n for n in names)
    return wgmma, mma_sync, names


@pytest.mark.cuda
def test_conv_stage_bf16_forms_reach_their_kernels_on_card(cuda):
    """A bf16 conv stage with Ci % 8 == 0 runs the wgmma kernel (either
    width) and not mma.sync's bf16_kernel; the stem (Ci = 3) and Ci = 12
    run bf16_kernel and not the wgmma kernel; the wgmma form refuses a
    stride past TMA's 8."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.kernels.conv_fused import conv2d_nhwc

    g = torch.Generator(device=cuda).manual_seed(9)

    def ops(n, h, ci, co, k):
        return (torch.randn(n, h, h, ci, device=cuda,
                            generator=g).bfloat16(),
                torch.randn(k, k, ci, co, device=cuda,
                            generator=g).bfloat16())

    for ci, co in ((16, 32), (64, 64), (256, 128), (40, 256)):
        wgmma, mma_sync, names = _conv_kernel_names(*ops(2, 8, ci, co, 3))
        assert wgmma and not mma_sync, names
    for ci, k, s, p in ((3, 7, 2, 3), (12, 3, 1, 1)):
        wgmma, mma_sync, names = _conv_kernel_names(*ops(2, 23, ci, 64, k),
                                                    s, p)
        assert mma_sync and not wgmma, names
    x, w = ops(1, 20, 16, 32, 1)
    reset_launches()
    with pytest.raises(ValueError, match="strides up to 8"):
        conv2d_nhwc(x, w, (9, 9), (0, 0))
    assert KERNELS["conv_stage_bf16"].launches == 0


@pytest.mark.cuda
def test_executor_fused_resnet_amp_step_on_card_runs_the_bf16_form(cuda):
    """One Momentum step of the fused cifar10 ResNet, depth 8, batch 4,
    under Float16Transpiler: K6's bf16 form once per conv stage (9), the
    f32 form never; the loss is the CPU executor's to bf16 resolution
    and the parameter gradients stay float32."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = resnet.get_model(data_set="cifar10", depth=8,
                                      data_format="NHWC", fused_stages=True)
    fluid.transpiler.Float16Transpiler().transpile(main)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    fetch = [loss.name] + sorted(p.name + "@GRAD"
                                 for p in main.all_parameters()
                                 if p.trainable)
    rng = np.random.RandomState(0)
    feed = {"data": rng.rand(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=card, return_numpy=False)
    assert KERNELS["conv_stage_bf16"].launches == 9
    assert KERNELS["conv_stage"].launches == 0
    assert all(g.dtype == torch.float32 for g in got[1:])
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0], rtol=1e-2)


@pytest.mark.cuda
def test_executor_fused_resnet_step_on_card_runs_the_conv_stage(cuda):
    """One Momentum step of the fused cifar10 ResNet, depth 8, batch 4
    (FLAGS_conv_layout=NHWC) through Executor(CUDAPlace(0)): K6 once per
    conv stage (9); the card's loss and gradients are the CPU
    executor's from the same parameters."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import resnet

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = resnet.get_model(data_set="cifar10", depth=8,
                                      data_format="NHWC", fused_stages=True)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    fetch = [loss.name] + sorted(p.name + "@GRAD"
                                 for p in main.all_parameters()
                                 if p.trainable)
    rng = np.random.RandomState(0)
    feed = {"data": rng.rand(4, 3, 32, 32).astype(np.float32),
            "label": rng.randint(0, 10, (4, 1)).astype(np.int64)}
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=card)
    assert KERNELS["conv_stage"].launches == 9
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), name


# K9: the ring-step chunk fold -- ragged Sq/Sk, causal on the diagonal,
# a partial k_offset, a block wholly in the future, non-causal; from a
# fresh carry and from one seeded by an earlier fold
@pytest.mark.cuda
@pytest.mark.parametrize("t,tk", [(64, 64), (100, 200), (256, 256),
                                  (200, 100)])
def test_flash_chunk_kernel_matches_plain_on_card(cuda, t, tk):
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(2, 8, t, 128, device=cuda, generator=g)
    k, v, k0, v0 = (torch.randn(2, 8, tk, 128, device=cuda, generator=g)
                    for _ in range(4))
    fresh = (torch.full((2, 8, t), pfa.NEG_INF, device=cuda),
             torch.zeros(2, 8, t, device=cuda),
             torch.zeros(2, 8, t, 128, device=cuda))
    seeded = pfa.flash_attention_chunk(q, k0, v0, *fresh)
    for carry in (fresh, seeded):
        for causal, off in ((True, 0), (True, t // 2), (True, t),
                            (False, 0)):
            got = pfa.flash_attention_chunk(q, k, v, *carry, causal=causal,
                                            k_offset=off)
            want = pfa.chunk_update_reference(q, k, v, *carry,
                                              128 ** -0.5, causal, off)
            for a, w in zip(got, want):
                torch.testing.assert_close(a, w, **TOL)
            if causal and off >= t:     # wholly in the future
                for a, c in zip(got, carry):
                    assert torch.equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("t,tk,off", [(100, 200, 37), (256, 256, 37),
                                      (200, 100, -37)])
def test_flash_chunk_kernel_at_an_unaligned_offset_on_card(cuda, t, tk,
                                                           off):
    """A causal k_offset that is not a multiple of 16 (or of the 8-key
    groups a warp skips by), from a fresh and from a seeded carry."""
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(7)
    q = torch.randn(2, 8, t, 128, device=cuda, generator=g)
    k, v, k0, v0 = (torch.randn(2, 8, tk, 128, device=cuda, generator=g)
                    for _ in range(4))
    fresh = (torch.full((2, 8, t), pfa.NEG_INF, device=cuda),
             torch.zeros(2, 8, t, device=cuda),
             torch.zeros(2, 8, t, 128, device=cuda))
    seeded = pfa.flash_attention_chunk(q, k0, v0, *fresh)
    for carry in (fresh, seeded):
        got = pfa.flash_attention_chunk(q, k, v, *carry, causal=True,
                                        k_offset=off)
        want = pfa.chunk_update_reference(q, k, v, *carry, 128 ** -0.5,
                                          True, off)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("t,tk", [(100, 100), (300, 200)])
def test_flash_kernels_on_a_large_grid_on_card(cuda, t, tk):
    """288 heads: enough blocks that K1 and K9 take their 128 x 32 tile
    shape (the training step's), at ragged T and Tk, causal and not, K9
    from a seeded carry at an unaligned k_offset."""
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn(36, 8, t, 128, device=cuda, generator=g)
    k, v, k0, v0 = (torch.randn(36, 8, tk, 128, device=cuda, generator=g)
                    for _ in range(4))
    scale = 128 ** -0.5
    for causal in (False, True):
        out, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
        ro, rl = attention_reference(q, k, v, scale, causal)
        torch.testing.assert_close(out, ro, **TOL)
        torch.testing.assert_close(lse, rl, **TOL)
    fresh = (torch.full((36, 8, t), pfa.NEG_INF, device=cuda),
             torch.zeros(36, 8, t, device=cuda),
             torch.zeros(36, 8, t, 128, device=cuda))
    seeded = pfa.flash_attention_chunk(q, k0, v0, *fresh)
    for causal, off in ((True, 0), (True, 37), (False, 0), (True, t)):
        got = pfa.flash_attention_chunk(q, k, v, *seeded, causal=causal,
                                        k_offset=off)
        want = pfa.chunk_update_reference(q, k, v, *seeded, scale, causal,
                                          off)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **TOL)
        if causal and off >= t:
            for a, c in zip(got, seeded):
                assert torch.equal(a, c)


@pytest.mark.cuda
def test_flash_chunk_bwd_on_card_runs_k2_k3(cuda):
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(5)
    q, do = (torch.randn(2, 8, 128, 128, device=cuda, generator=g)
             for _ in range(2))
    k, v = (torch.randn(2, 8, 128, 128, device=cuda, generator=g)
            for _ in range(2))
    # the diagonal block, a non-causal one, and causal blocks at an
    # offset (K2/K3 take it in their mask), one of them unaligned to
    # every tile; lse and delta are the diagonal forward's, so rows the
    # offset leaves without a live key in this block take no gradient
    out, lse = attention_reference(q, k, v, 128 ** -0.5, True)
    delta = (do * out).sum(-1)
    for causal, off in ((True, 0), (False, 0), (True, 64), (True, 37)):
        dq0, dkv0 = pfa.flash_bwd_dq.launches, pfa.flash_bwd_dkv.launches
        got = pfa.flash_attention_chunk_bwd(q, k, v, do, lse, delta,
                                            causal=causal, k_offset=off)
        assert (pfa.flash_bwd_dq.launches - dq0,
                pfa.flash_bwd_dkv.launches - dkv0) == (1, 1)
        want = pfa.chunk_bwd_reference(q, k, v, do, lse, delta,
                                       128 ** -0.5, causal, off)
        for a, w in zip(got, want):
            torch.testing.assert_close(a, w, **TOL)
        if off:
            assert got[0][:, :, :off].abs().max().item() == 0.0


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
def test_ring_on_one_card_matches_dense_flash(cuda, p):
    """The ring over a p-shard mesh laid on one card: out, lse and the
    gradients against the dense flash path; p(p+1)/2 K9 folds and as
    many K2/K3 launches, no K1."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.parallel import make_mesh, ring

    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do = (torch.randn(1, 8, 256, 128, device=cuda, generator=g)
                   for _ in range(4))
    mesh = make_mesh({"sp": p}, [cuda] * p)
    reset_launches()
    out, lse = ring.ring_attention_fwd_lse(q, k, v, mesh, causal=True)
    grads = ring.ring_attention_bwd(q, k, v, out, lse, do, mesh,
                                    causal=True)
    n = p * (p + 1) // 2
    assert {k_: f.launches for k_, f in KERNELS.items()
            if f.launches} == {"flash_chunk": n, "flash_bwd_dq": n,
                               "flash_bwd_dkv": n}
    ro, rl = attention_reference(q, k, v, 128 ** -0.5, True)
    torch.testing.assert_close(out, ro, **TOL)
    torch.testing.assert_close(lse, rl, **TOL)
    want = flash_attention_bwd_reference(q, k, v, ro, rl, do, 128 ** -0.5,
                                         True)
    for a, w in zip(grads, want):
        torch.testing.assert_close(a, w, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("n,c", [(64, 512), (37, 1001), (8, 8192)])
def test_fused_ce_kernel_matches_plain_on_card(cuda, n, c):
    from paddle_tpu_torch.kernels import fused as pfused

    g = torch.Generator(device=cuda).manual_seed(7)
    logits = torch.randn(n, c, device=cuda, generator=g) * 3
    labels = torch.randint(0, c, (n,), device=cuda, generator=g)
    before = pfused.fused_softmax_cross_entropy.launches
    got = pfused.fused_softmax_cross_entropy(logits, labels)
    assert pfused.fused_softmax_cross_entropy.launches == before + 1
    torch.testing.assert_close(
        got, pfused.softmax_ce_reference(logits, labels), **TOL)
    # a row that does not start 16-byte aligned takes the scalar loads
    if c % 4 == 0:
        off = logits.reshape(-1)[1:1 + n * (c - 4)].reshape(n, c - 4)
        torch.testing.assert_close(
            pfused.fused_softmax_cross_entropy(off, labels % (c - 4)),
            pfused.softmax_ce_reference(off, labels % (c - 4)), **TOL)


@pytest.mark.cuda
def test_executor_core_sp_mesh_step_on_card_runs_the_ring(cuda):
    """One Adam step of a small sp LM with head_dim 128 on a 4-shard mesh
    laid on one card (ExecutorCore with the mesh) against the same step
    on a 4-shard CPU mesh from the same parameters: 10 K9 folds and 10
    K2/K3 launches a layer, no K1; loss and gradients agree."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.executor_impl import ExecutorCore
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import transformer
    from paddle_tpu_torch.parallel import make_mesh

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(
            vocab_size=64, seq_len=128, d_model=256, n_head=2, n_layers=2,
            d_ff=64, sp=True)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    fetch = [loss.name] + sorted(p.name + "@GRAD"
                                 for p in main.all_parameters())
    toks = np.random.RandomState(0).randint(0, 64, (2, 129))
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    reset_launches()
    got = ExecutorCore(fluid.CUDAPlace(0),
                       mesh=make_mesh({"sp": 4}, [cuda] * 4)).run(
        main.desc, card, 0, feed, fetch)
    counts = {k: fn.launches for k, fn in KERNELS.items()}
    assert counts["flash_chunk"] == counts["flash_bwd_dq"] == \
        counts["flash_bwd_dkv"] == 2 * 10, counts
    assert counts["flash_fwd"] == 0, counts
    want = ExecutorCore(fluid.CPUPlace(),
                        mesh=make_mesh({"sp": 4}, ["cpu"] * 4)).run(
        main.desc, host, 0, feed, fetch)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    for name, a, b in zip(fetch[1:], got[1:], want[1:]):
        assert np.linalg.norm(a - b) <= 1e-2 * np.linalg.norm(b), name


@pytest.mark.cuda
def test_parallel_executor_lays_its_mesh_on_the_cards(cuda):
    """ParallelExecutor with no use_cuda runs on the cards: a mesh wider
    than the visible cards raises; an sp=1 mesh cut by num_devices runs
    Adam steps on the card from per-device feed dicts, its losses those
    of the same steps on the CPU, through the prepared (captured) step:
    the second step launches K1 once, by its replay.  (An sp > 1 ring
    under ParallelExecutor needs as many cards; the one-card ring is
    driven through ExecutorCore above.)"""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(
            vocab_size=64, seq_len=128, d_model=256, n_head=2, n_layers=1,
            d_ff=64, sp=True)
    n = torch.cuda.device_count()
    with pytest.raises(ValueError, match="needs %d devices" % (n + 1)):
        fluid.ParallelExecutor(main_program=main, mesh_axes={"sp": n + 1})
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [k for k, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    pe = fluid.ParallelExecutor(main_program=main, scope=card,
                                num_devices=1, mesh_axes={"sp": 1})
    assert [d.type for d in pe.mesh.devices] == ["cuda"]
    cpu_pe = fluid.ParallelExecutor(use_cuda=False, main_program=main,
                                    scope=host, mesh_axes={"sp": 1})
    rng = np.random.RandomState(1)
    for rtol in (1e-5, 1e-4):    # the first step, then one after Adam's
        # the first step captures (its warm-up steps launch too)
        reset_launches()
        toks = rng.randint(0, 64, (2, 129))
        halves = [{"src": toks[i:i + 1, :-1],
                   "label": toks[i:i + 1, 1:, None]} for i in range(2)]
        got, = pe.run([loss.name], feed=halves)
        want, = cpu_pe.run([loss.name], feed=halves)
        np.testing.assert_allclose(got, want, rtol=rtol)
    assert KERNELS["flash_fwd"].launches == 1
    assert KERNELS["flash_chunk"].launches == 0
    assert len(pe._prepared) == 1


# The bf16 forms of K1-K5 (the LM under AMP), each against its plain
# version (K4: the one that rounds once from the f32 accumulator) on the
# same bf16 inputs, at the training step's shapes and at ragged ones,
# under the bars chip_smoke.py holds them to: K1's out and K2/K3's
# gradients within one bf16 ulp of the plain value plus 2**-12 of the
# tensor's max |plain|, K1's LSE at TOL; K4's out and pre within one ulp
# plus 1e-6 of max |Y|; K5's Sum exact, its out, mean and var within
# one ulp.  (T = 1 is left to the forward: with one key, dS = P (dP -
# delta) is a difference of two equal f32 sums, exactly 0, whose
# reordering noise no bar relative to the gradients' 0 can hold.)

def _within_ulp(got, want, floor):
    from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

    want = want.float()
    err = (got.float() - want).abs()
    return bool((err <= bf16_ulp(want) + floor * want.abs().max()).all())


FLASH_BF16_SHAPES = [(16, 8, 2048, 2048, True), (1, 8, 256, 256, True),
                     (2, 3, 200, 200, True), (1, 2, 77, 130, False),
                     (1, 2, 130, 77, False), (2, 8, 100, 100, True),
                     (2, 3, 129, 129, True), (1, 2, 129, 129, False)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,tk,causal", FLASH_BF16_SHAPES)
def test_flash_bf16_forms_match_plain_on_card(cuda, b, h, t, tk, causal):
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    g = torch.Generator(device=cuda).manual_seed(t + tk)
    q = torch.randn(b, h, t, 128, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(b, h, tk, 128, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    do = torch.randn(b, h, t, 128, device=cuda, generator=g).bfloat16()
    reset_launches()
    out, lse = flash_attention_fwd_lse(q, k, v, causal=causal)
    ro, rl = attention_reference(q, k, v, 128 ** -0.5, causal)
    assert out.dtype == torch.bfloat16 and lse.dtype == torch.float32
    assert _within_ulp(out, ro, 2 ** -12)
    torch.testing.assert_close(lse, rl, **TOL)
    got = flash_attention_bwd(q, k, v, ro, rl, do, causal=causal)
    want = flash_attention_bwd_reference(q, k, v, ro, rl, do, 128 ** -0.5,
                                         causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and _within_ulp(a, w, 2 ** -12)
    assert {k_: f.launches for k_, f in KERNELS.items() if f.launches} == {
        "flash_fwd_bf16": 1, "flash_bwd_dq_bf16": 1,
        "flash_bwd_dkv_bf16": 1}


@pytest.mark.cuda
def test_flash_bf16_forward_at_one_query_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v = (torch.randn(1, 1, 1, 128, device=cuda, generator=g)
               .bfloat16() for _ in range(3))
    out, lse = flash_attention_fwd_lse(q, k, v, causal=True)
    ro, rl = attention_reference(q, k, v, 128 ** -0.5, True)
    assert torch.equal(out, ro)
    torch.testing.assert_close(lse, rl, **TOL)


@pytest.mark.cuda
def test_flash_bf16_forward_one_query_over_many_keys_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(4)
    q = torch.randn(1, 2, 1, 128, device=cuda, generator=g).bfloat16()
    k, v = (torch.randn(1, 2, 300, 128, device=cuda, generator=g)
            .bfloat16() for _ in range(2))
    out, lse = flash_attention_fwd_lse(q, k, v, causal=False)
    ro, rl = attention_reference(q, k, v, 128 ** -0.5, False)
    assert _within_ulp(out, ro, 2 ** -12)
    torch.testing.assert_close(lse, rl, **TOL)


@pytest.mark.cuda
def test_flash_bf16_backward_casts_the_cotangent_on_card(cuda):
    """An f32 dO of a bf16 O: the card backward rounds it to bf16 first
    and sums delta in f32 (``flash_delta``), as the reference's kernel
    branch does; the result is the bf16 dO's."""
    g = torch.Generator(device=cuda).manual_seed(2)
    q, k, v = (torch.randn(2, 8, 256, 128, device=cuda, generator=g)
               .bfloat16() for _ in range(3))
    do = torch.randn(2, 8, 256, 128, device=cuda, generator=g)
    out, lse = flash_attention_fwd_lse(q, k, v, causal=True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = flash_attention_bwd(q, k, v, out, lse, do.bfloat16(),
                               causal=True)
    for a, w in zip(got, want):
        assert torch.equal(a, w)


@pytest.mark.cuda
def test_flash_bf16_forms_are_deterministic_on_card(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    q, k, v, do = (torch.randn(2, 8, 300, 128, device=cuda, generator=g)
                   .bfloat16() for _ in range(4))
    out, lse = flash_attention_fwd_lse(q, k, v, causal=True)
    again = flash_attention_fwd_lse(q, k, v, causal=True)
    assert torch.equal(out, again[0]) and torch.equal(lse, again[1])
    one = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    two = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    for a, b in zip(one, two):
        assert torch.equal(a, b)


def _bf16_bwd_operands(cuda, b, h, t, tk, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    q, do = (torch.randn(b, h, t, 128, device=cuda, generator=g).bfloat16()
             for _ in range(2))
    k, v = (torch.randn(b, h, tk, 128, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    return q, k, v, do


@pytest.mark.cuda
def test_flash_bf16_backward_at_one_query_on_card(cuda):
    """T = Tk = 1: p = 1, so dV = dO within one ulp; dS = dP - delta is a
    difference of two equal f32 sums taken in different orders, 0 up to
    their rounding, so dQ and dK are held to 2**-12 of the terms that
    cancel (scale |dO . V| |K| and |Q|), not of their 0."""
    q, k, v, do = _bf16_bwd_operands(cuda, 1, 2, 1, 1, 11)
    scale = 128 ** -0.5
    out, lse = attention_reference(q, k, v, scale, True)
    got = flash_attention_bwd(q, k, v, out, lse, do, causal=True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, do, scale, True)
    assert _within_ulp(got[2], want[2], 2 ** -12)
    dot = (do.float() * v.float()).abs().sum(-1, keepdim=True)
    for a, w, x in ((got[0], want[0], k), (got[1], want[1], q)):
        terms = scale * dot * x.float().abs()
        err = (a.float() - w.float()).abs()
        assert bool((err <= 2 ** -12 * terms.max()).all()), float(err.max())


# (T, Tk, causal, k_offset): a ring step's K2/K3 call, the mask q_pos <
# k_offset + k_pos: on the diagonal, a block partly above and partly
# below it from either side (ragged), a block wholly visible and one
# wholly masked, and non-causal
K_OFFSET_CASES = [(256, 256, True, 0), (200, 130, True, 37),
                  (130, 200, True, -50), (256, 256, True, -256),
                  (128, 128, True, 200), (129, 300, False, 64)]


@pytest.mark.cuda
@pytest.mark.parametrize("t,tk,causal,k_offset", K_OFFSET_CASES)
def test_flash_bwd_bf16_kernels_at_a_k_offset_on_card(cuda, t, tk, causal,
                                                     k_offset):
    """The bf16 K2/K3 called directly with k_offset against
    chunk_bwd_reference, from the lse of the masked block itself
    (NEG_INF where a row sees no key)."""
    from paddle_tpu_torch.kernels.flash_attention import (
        chunk_bwd_reference, flash_bwd_dkv_bf16, flash_bwd_dq_bf16)

    q, k, v, do = _bf16_bwd_operands(cuda, 2, 3, t, tk, t + tk)
    scale = 128 ** -0.5
    s = torch.einsum("bhtd,bhsd->bhts", q.float(), k.float()) * scale
    if causal:
        pos = torch.arange(t, device=cuda)[:, None]
        dead = pos < k_offset + torch.arange(tk, device=cuda)[None, :]
        s = s.masked_fill(dead, float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - lse[..., None]).nan_to_num(0.0)
    out = torch.einsum("bhts,bhsd->bhtd", p, v.float()).bfloat16()
    delta = (do.float() * out.float()).sum(-1)
    got = (flash_bwd_dq_bf16(q, k, v, do, lse, delta, scale, causal,
                             k_offset),
           *flash_bwd_dkv_bf16(q, k, v, do, lse, delta, scale, causal,
                               k_offset))
    want = chunk_bwd_reference(q, k, v, do, lse, delta, scale, causal,
                               k_offset)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and _within_ulp(a, w, 2 ** -12)


@pytest.mark.cuda
def test_flash_bwd_bf16_forms_sum_in_one_order_on_card(cuda):
    """A head's gradients are bit-identical whether its blocks run in the
    128-row form (64 heads of 512 rows fill the card) or the 64-row one
    (the head alone), and from call to call."""
    from paddle_tpu_torch.kernels.flash_attention import (
        flash_bwd_dkv_bf16, flash_bwd_dq_bf16)

    q, k, v, do = _bf16_bwd_operands(cuda, 8, 8, 500, 500, 12)
    scale = 128 ** -0.5
    out, lse = attention_reference(q, k, v, scale, True)
    delta = (do.float() * out.float()).sum(-1)

    def grads(sl):
        args = [x[sl].contiguous() for x in (q, k, v, do, lse, delta)]
        return (flash_bwd_dq_bf16(*args, scale, True),
                *flash_bwd_dkv_bf16(*args, scale, True))

    every = grads(slice(None))
    assert all(torch.equal(a, b) for a, b in zip(every,
                                                 grads(slice(None))))
    one = grads(slice(3, 4))
    for a, b in zip(every, one):
        assert torch.equal(a[3:4], b)


@pytest.mark.cuda
def test_flash_bwd_bf16_kernels_refuse_a_misaligned_view_on_card(cuda):
    """TMA reads q, k, v and dO from 16-byte boundaries: a bf16 view one
    element into its storage raises ValueError before any launch, and
    the card still works afterwards."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    n = 2 * 64 * 128
    base = torch.randn(n + 1, device=cuda).bfloat16()
    bad = base[1:].view(1, 2, 64, 128)
    assert bad.is_contiguous() and bad.data_ptr() % 16 != 0
    q, k, v, do = _bf16_bwd_operands(cuda, 1, 2, 64, 64, 13)
    out, lse = attention_reference(q, k, v, 128 ** -0.5, True)
    reset_launches()
    for i in (0, 5):                     # q, do
        args = [q, k, v, out, lse, do]
        args[i] = bad
        with pytest.raises(ValueError, match="16-byte"):
            flash_attention_bwd(*args, causal=True)
    assert KERNELS["flash_bwd_dq_bf16"].launches == 0
    assert KERNELS["flash_bwd_dkv_bf16"].launches == 0
    got = flash_attention_bwd(q, k, v, out, lse, bad.clone(), causal=True)
    want = flash_attention_bwd_reference(q, k, v, out, lse, bad,
                                         128 ** -0.5, True)
    for a, w in zip(got, want):
        assert _within_ulp(a, w, 2 ** -12)


@pytest.mark.cuda
def test_flash_wrappers_refuse_mixed_dtypes_on_card(cuda):
    from paddle_tpu_torch.kernels.flash_attention import flash_bwd_dq

    q = torch.randn(1, 2, 64, 128, device=cuda).bfloat16()
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        flash_attention_fwd_lse(q, q.float(), q)
    lse = torch.zeros(1, 2, 64, device=cuda)
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        flash_bwd_dq(q, q, q.float(), q, lse, lse, 0.1, True)


# K9's bf16 form: the ring-step fold on bf16 q/k/v into the f32 carry
# (the sp LM under AMP), on K1 bf16's wgmma mainloop.  Carry at TOL (K9
# f32's bar: P's hi + lo split keeps the products f32-accurate); a
# wholly masked block leaves the carry bit-identical.

def _chunk_bf16_operands(cuda, b, h, t, tk, seed):
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")
    g = torch.Generator(device=cuda).manual_seed(seed)
    q = torch.randn(b, h, t, 128, device=cuda, generator=g).bfloat16()
    k, v, k0, v0 = (torch.randn(b, h, tk, 128, device=cuda, generator=g)
                    .bfloat16() for _ in range(4))
    fresh = (torch.full((b, h, t), pfa.NEG_INF, device=cuda),
             torch.zeros(b, h, t, device=cuda),
             torch.zeros(b, h, t, 128, device=cuda))
    seeded = pfa.flash_attention_chunk(q, k0, v0, *fresh)
    return pfa, q, k, v, fresh, seeded


# (B, H, T, Tk): the ring's shard of the training step at sp = 4 (128
# heads x 4 Q tiles: the 128-row form), ragged T and Tk in the 64-row
# form, and a ragged grid large enough for the 128-row form
CHUNK_BF16_SHAPES = [(16, 8, 512, 512), (2, 8, 100, 200), (2, 3, 256, 256),
                     (1, 2, 200, 100), (36, 8, 300, 200)]


@pytest.mark.cuda
@pytest.mark.parametrize("b,h,t,tk", CHUNK_BF16_SHAPES)
def test_flash_chunk_bf16_kernel_matches_plain_on_card(cuda, b, h, t, tk):
    """Every mask the ring and its tests give K9: the diagonal, a block
    half masked (k_offset T // 2), one wholly masked (k_offset T), an
    unaligned offset that leaves a 128-row block's two warpgroups
    different tiles (37) and non-causal; from a fresh and a seeded
    carry.  The bf16 form launches, the f32 form never."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    pfa, q, k, v, fresh, seeded = _chunk_bf16_operands(cuda, b, h, t, tk,
                                                       t + tk)
    cases = ((True, 0), (True, t // 2), (True, t), (True, 37), (False, 0))
    reset_launches()
    for carry in (fresh, seeded):
        for causal, off in cases:
            got = pfa.flash_attention_chunk(q, k, v, *carry, causal=causal,
                                            k_offset=off)
            want = pfa.chunk_update_reference(q, k, v, *carry,
                                              128 ** -0.5, causal, off)
            for a, w in zip(got, want):
                assert a.dtype == torch.float32
                torch.testing.assert_close(a, w, **TOL)
            if causal and off >= t:     # wholly in the future
                for a, c in zip(got, carry):
                    assert torch.equal(a, c)
    assert {k_: f.launches for k_, f in KERNELS.items() if f.launches} == \
        {"flash_chunk_bf16": 2 * len(cases)}


@pytest.mark.cuda
def test_flash_chunk_bf16_keeps_a_settled_max_bit_for_bit_on_card(cuda):
    """A row whose max does not rise keeps m bit for bit: a carry whose m
    lies above every score of the block (m + 50) comes back with that m
    exactly, l and acc scaled by alpha = 1 plus the block's terms."""
    pfa, q, k, v, _, seeded = _chunk_bf16_operands(cuda, 2, 8, 256, 256, 3)
    m, l, acc = seeded
    high = (m + 50.0, l, acc)
    got = pfa.flash_attention_chunk(q, k, v, *high, causal=False)
    assert torch.equal(got[0], high[0])
    want = pfa.chunk_update_reference(q, k, v, *high, 128 ** -0.5, False)
    for a, w in zip(got, want):
        torch.testing.assert_close(a, w, **TOL)


@pytest.mark.cuda
def test_flash_chunk_bf16_is_deterministic_on_card(cuda):
    pfa, q, k, v, _, seeded = _chunk_bf16_operands(cuda, 16, 8, 512, 512, 5)
    for causal in (True, False):
        one = pfa.flash_attention_chunk(q, k, v, *seeded, causal=causal)
        two = pfa.flash_attention_chunk(q, k, v, *seeded, causal=causal)
        for a, b in zip(one, two):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_chunk_bf16_refusals_never_run_the_plain_version_on_card(
        cuda, monkeypatch):
    """A CUDA bf16 fold the kernel cannot take raises before any launch
    and never falls back to chunk_update_reference: head_dim 64, a
    misaligned q, a non-contiguous carry, mixed q/k/v dtypes and a bf16
    carry."""
    import importlib

    pfa = importlib.import_module("paddle_tpu_torch.kernels.flash_attention")

    def plain(*a, **kw):
        raise AssertionError("the plain version ran on CUDA tensors")

    monkeypatch.setattr(pfa, "chunk_update_reference", plain)
    g = torch.Generator(device=cuda).manual_seed(8)

    def operands(d):
        q, k, v = (torch.randn(1, 2, 64, d, device=cuda, generator=g)
                   .bfloat16() for _ in range(3))
        carry = (torch.full((1, 2, 64), pfa.NEG_INF, device=cuda),
                 torch.zeros(1, 2, 64, device=cuda),
                 torch.zeros(1, 2, 64, d, device=cuda))
        return [q, k, v, *carry]

    base = torch.randn(2 * 64 * 128 + 1, device=cuda).bfloat16()
    bad_q = base[1:].view(1, 2, 64, 128)
    ops = operands(128)
    strided = torch.zeros(1, 2, 128, 64, device=cuda).transpose(2, 3)
    cases = [(operands(64), "head_dim"),
             ([bad_q] + ops[1:], "16-byte"),
             (ops[:5] + [strided], "contiguous"),
             ([ops[0], ops[1].float()] + ops[2:],
              "all float32 or all bfloat16"),
             (ops[:3] + [x.bfloat16() for x in ops[3:]], "float32 carry")]
    before = pfa.flash_chunk_bf16.launches
    for args, match in cases:
        with pytest.raises(ValueError, match=match):
            pfa.flash_attention_chunk(*args, causal=True)
    assert pfa.flash_chunk_bf16.launches == before
    # and the card still works
    pfa.flash_attention_chunk(*ops, causal=True)
    torch.cuda.synchronize()
    assert pfa.flash_chunk_bf16.launches == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [False, True])
def test_flash_chunk_bwd_bf16_at_the_ring_shard_on_card(cuda, causal):
    """The ring's backward steps under AMP at its shard [16, 8, 512, 128]
    through the chunk backward: non-causal (36 of a step's 60 calls) and
    the causal diagonal (24), K2/K3 bf16 against chunk_bwd_reference
    within one bf16 ulp plus 2**-12 of max |plain|, from an f32
    cotangent the card casts to bf16."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    pfa, q, k, v, fresh, _ = _chunk_bf16_operands(cuda, 16, 8, 512, 512, 9)
    scale = 128 ** -0.5
    m, l, acc = pfa.flash_attention_chunk(q, k, v, *fresh, causal=causal)
    out, lse = pfa.chunk_finalize(m, l, acc, torch.bfloat16)
    do = torch.randn(q.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(10))
    delta = (do.float() * out.float()).sum(-1)
    reset_launches()
    got = pfa.flash_attention_chunk_bwd(q, k, v, do, lse, delta,
                                        causal=causal)
    assert {k_: f.launches for k_, f in KERNELS.items() if f.launches} == {
        "flash_bwd_dq_bf16": 1, "flash_bwd_dkv_bf16": 1}
    want = pfa.chunk_bwd_reference(q, k, v, do.bfloat16(), lse, delta,
                                   scale, causal)
    for a, w in zip(got, want):
        assert a.dtype == torch.bfloat16 and _within_ulp(a, w, 2 ** -12)


@pytest.mark.cuda
@pytest.mark.parametrize("p", [2, 4])
def test_ring_bf16_on_one_card_matches_plain(cuda, p):
    """The ring on bf16 q/k/v over a p-shard mesh on one card: out within
    one bf16 ulp plus 2**-12 of max |plain| of plain attention, lse at
    TOL; p(p+1)/2 launches of each bf16 form and no f32 form.  The
    gradients sum p bf16-rounded steps in f32, as the reference's ring
    does, so each is held to one ulp plus p ulps of its max |plain|."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.parallel import make_mesh, ring

    g = torch.Generator(device=cuda).manual_seed(6)
    q, k, v, do = (torch.randn(1, 8, 256, 128, device=cuda, generator=g)
                   .bfloat16() for _ in range(4))
    mesh = make_mesh({"sp": p}, [cuda] * p)
    reset_launches()
    out, lse = ring.ring_attention_fwd_lse(q, k, v, mesh, causal=True)
    grads = ring.ring_attention_bwd(q, k, v, out, lse, do, mesh,
                                    causal=True)
    n = p * (p + 1) // 2
    assert {k_: f.launches for k_, f in KERNELS.items()
            if f.launches} == {"flash_chunk_bf16": n,
                               "flash_bwd_dq_bf16": n,
                               "flash_bwd_dkv_bf16": n}
    scale = 128 ** -0.5
    ro, rl = attention_reference(q, k, v, scale, True)
    assert out.dtype == torch.bfloat16 and _within_ulp(out, ro, 2 ** -12)
    torch.testing.assert_close(lse, rl, **TOL)
    want = flash_attention_bwd_reference(q, k, v, ro, rl, do, scale, True)
    for a, w in zip(grads, want):
        assert a.dtype == torch.bfloat16
        assert _within_ulp(a, w, p * 2 ** -8)


# (M, K, N): the fused step's five projections at M = 16 x 2048, then
# ragged M, N and K, multiples of 8 but not of the wgmma tile's 128 x 256
# or its 64-deep K tile, and K = 4096
MATMUL_BF16_SHAPES = [(32768, 1024, 3072), (32768, 1024, 1024),
                      (32768, 1024, 4096), (32768, 4096, 1024),
                      (32768, 1024, 8192), (1000, 1024, 1000),
                      (333, 264, 1000), (17, 72, 24), (129, 72, 136),
                      (255, 72, 136), (129, 4096, 136)]


@pytest.mark.cuda
@pytest.mark.parametrize("m,k,n", MATMUL_BF16_SHAPES)
def test_matmul_epilogue_bf16_form_matches_plain_on_card(cuda, m, k, n):
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    x = torch.randn(m, k, device=cuda, generator=g).bfloat16()
    w = (torch.randn(k, n, device=cuda, generator=g) * k ** -0.5).bfloat16()
    bias = torch.randn(n, device=cuda, generator=g).bfloat16()
    res = torch.randn(m, n, device=cuda, generator=g).bfloat16()
    cases = [("relu", bias, None)] if m == 32768 else [
        (act, b, r) for act in ("", "relu", "gelu")
        for b, r in ((None, None), (bias, None), (bias, res), (None, res))]
    for act, b, r in cases:
        out, pre = pmm.matmul_epilogue(x, w, b, r, act, save_preact=True)
        want, want_pre = pmm.matmul_epilogue_f32acc_reference(x, w, b, r,
                                                              act)
        assert out.dtype == pre.dtype == torch.bfloat16
        assert _within_ulp(out, want, 1e-6), (act, b is None, r is None)
        assert _within_ulp(pre, want_pre, 1e-6), (act, b is None, r is None)


@pytest.mark.cuda
def test_matmul_epilogue_bf16_form_counts_and_refuses_on_card(cuda):
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    x = torch.randn(64, 64, device=cuda).bfloat16()
    reset_launches()
    pmm.matmul_epilogue(x, x)
    pmm.matmul_epilogue(x.float(), x.float())
    assert KERNELS["matmul_epilogue_bf16"].launches == 1
    assert KERNELS["matmul_epilogue"].launches == 1
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        pmm.matmul_epilogue(x, x.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        pmm.matmul_epilogue(x[:, :60].contiguous(), x[:60])
    with pytest.raises(ValueError, match="multiple of 8"):
        pmm.matmul_epilogue(x, x[:, :60].contiguous())


@pytest.mark.cuda
def test_matmul_epilogue_bf16_form_refuses_a_misaligned_base_on_card(cuda):
    """TMA reads x and w from 16-byte boundaries: a contiguous view 8
    bytes off one is refused, never run another way."""
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    buf = torch.randn(64 * 64 + 4, device=cuda).bfloat16()
    off = buf[4:].view(64, 64)
    ok = buf[:64 * 64].view(64, 64)
    assert off.data_ptr() % 16 == 8 and off.is_contiguous()
    reset_launches()
    for x, w in ((off, ok), (ok, off)):
        with pytest.raises(ValueError, match="16-byte aligned"):
            pmm.matmul_epilogue(x, w)
    assert KERNELS["matmul_epilogue_bf16"].launches == 0


def _kernel_names(fn):
    """The CUDA kernels ``fn()`` launches, by the profiler's names (a
    first call outside the profiler builds and loads the kernels)."""
    fn()
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        fn()
        torch.cuda.synchronize()
    return {e.key for e in prof.key_averages()}


@pytest.mark.cuda
def test_bf16_calls_reach_the_wgmma_kernels_on_card(cuda):
    """A bf16 matmul_epilogue runs the wgmma tile and no mma.sync
    bf16_kernel; a bf16 conv stage (K6) at Ci = 16 runs its own wgmma
    kernel on the same mainloop, and neither K4's kernel nor mma.sync's
    bf16_kernel; a bf16 flash forward runs its one wgmma kernel."""
    from paddle_tpu_torch.kernels.conv_fused import conv2d_nhwc

    g = torch.Generator(device=cuda).manual_seed(5)
    x = torch.randn(256, 128, device=cuda, generator=g).bfloat16()
    w = torch.randn(128, 256, device=cuda, generator=g).bfloat16()
    names = _kernel_names(lambda: pmm.matmul_epilogue(x, w, act="relu"))
    assert any("gemm_bf16_kernel" in n for n in names), names
    assert not any("bf16_kernel" in n and "gemm_bf16_kernel" not in n
                   for n in names), names
    xi = torch.randn(2, 8, 8, 16, device=cuda, generator=g).bfloat16()
    wi = torch.randn(3, 3, 16, 32, device=cuda, generator=g).bfloat16()
    names = _kernel_names(lambda: conv2d_nhwc(xi, wi, (1, 1), (1, 1)))
    assert any("conv_wgmma_kernel" in n for n in names), names
    assert not any("bf16_kernel" in n for n in names), names
    q = torch.randn(1, 2, 64, 128, device=cuda, generator=g).bfloat16()
    names = _kernel_names(lambda: flash_attention_fwd_lse(q, q, q,
                                                          causal=True))
    assert any("flash_fwd_bf16_kernel" in n for n in names), names


@pytest.mark.cuda
def test_bf16_flash_backward_reaches_the_wgmma_kernels_on_card(cuda):
    """A bf16 flash backward runs K2's and K3's wgmma kernels, one
    launch each, and no other kernel of flash_bwd.cu."""
    q, k, v, do = _bf16_bwd_operands(cuda, 1, 2, 64, 64, 14)
    out, lse = attention_reference(q, k, v, 128 ** -0.5, True)
    names = _kernel_names(lambda: flash_attention_bwd(q, k, v, out, lse, do,
                                                      causal=True))
    ours = sorted(n for n in names if "flash_bwd" in n)
    assert len(ours) == 2, names
    assert any("flash_bwd_dq_bf16_kernel" in n for n in ours), names
    assert any("flash_bwd_dkv_bf16_kernel" in n for n in ours), names


@pytest.mark.cuda
def test_flash_chunk_bf16_reaches_its_wgmma_kernel_on_card(cuda):
    """A bf16 fold launches the carry form of the wgmma forward
    (flash_chunk_bf16_kernel), not K1's entry and no split-TF32 chunk
    kernel."""
    pfa, q, k, v, fresh, _ = _chunk_bf16_operands(cuda, 1, 2, 64, 64, 6)
    names = _kernel_names(lambda: pfa.flash_attention_chunk(
        q, k, v, *fresh, causal=True))
    assert any("flash_chunk_bf16_kernel" in n for n in names), names
    assert not any("flash_fwd_bf16_kernel" in n or "flash_chunk_kernel" in n
                   for n in names), names


@pytest.mark.cuda
@pytest.mark.parametrize("m,d", [(32768, 1024), (1000, 1024), (77, 8),
                                 (50, 264), (33, 512)])
def test_add_ln_bf16_form_matches_plain_on_card(cuda, m, d):
    from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

    g = torch.Generator(device=cuda).manual_seed(m + d)
    x, y = (torch.randn(m, d, device=cuda, generator=g).bfloat16()
            for _ in range(2))
    scale = torch.rand(d, device=cuda, generator=g) + 0.5
    bias = torch.randn(d, device=cuda, generator=g)
    for s_, b_ in ((scale, bias), (None, None), (scale.bfloat16(), None)):
        got = pmm.add_ln(x, y, s_, b_)
        want = pmm.add_ln_reference(x, y, s_, b_)
        assert all(a.dtype == torch.bfloat16 for a in got)
        assert torch.equal(got[1], want[1])
        for a, w in zip((got[0], got[2], got[3]),
                        (want[0], want[2], want[3])):
            assert bool(((a.float() - w.float()).abs()
                         <= bf16_ulp(w)).all())


@pytest.mark.cuda
def test_add_ln_bf16_form_counts_and_refuses_on_card(cuda):
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    x = torch.randn(16, 64, device=cuda).bfloat16()
    reset_launches()
    pmm.add_ln(x, x)
    assert KERNELS["add_ln_bf16"].launches == 1
    assert KERNELS["add_ln"].launches == 0
    with pytest.raises(ValueError, match="all float32 or all bfloat16"):
        pmm.add_ln(x, x.float())
    with pytest.raises(ValueError, match="multiple of 8"):
        pmm.add_ln(x[:, :60].contiguous(), x[:, :60].contiguous())


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_executor_lm_amp_step_on_card_runs_the_bf16_forms(cuda, fuse):
    """One Adam step of a small LM (d_model 256, 2 heads of 128, 2
    layers, sequence 128, batch 2) under Float16Transpiler: the bf16
    forms of K1-K3 (and K4/K5 fused) as often as the f32 program runs
    its f32 forms, the f32 forms never; the loss is the CPU executor's
    to bf16 resolution and the parameter gradients stay float32."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.models import transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = transformer.get_model(
            vocab_size=64, seq_len=128, d_model=256, n_head=2, n_layers=2,
            d_ff=512, fuse_transformer=fuse)
    fluid.transpiler.Float16Transpiler().transpile(main)
    card = fluid.Scope()
    fluid.Executor(fluid.CUDAPlace(0)).run(startup, scope=card)
    persist = [n for n, v in main.desc.blocks[0].vars.items()
               if v.persistable]
    host = fluid.Scope()
    set_scope_arrays(host, get_scope_arrays(card, persist), "cpu")
    fetch = [loss.name] + sorted(p.name + "@GRAD"
                                 for p in main.all_parameters())
    toks = np.random.RandomState(0).randint(0, 64, (2, 129))
    feed = {"src": toks[:, :-1], "label": toks[:, 1:, None]}
    reset_launches()
    got = fluid.Executor(fluid.CUDAPlace(0)).run(
        main, feed=feed, fetch_list=fetch, scope=card, return_numpy=False)
    want_launches = {"flash_fwd_bf16": 2, "flash_bwd_dq_bf16": 2,
                     "flash_bwd_dkv_bf16": 2}
    if fuse:
        want_launches.update(matmul_epilogue_bf16=9, add_ln_bf16=4)
    assert {k: f.launches for k, f in KERNELS.items() if f.launches} == \
        want_launches
    assert all(g.dtype == torch.float32 for g in got[1:])
    want = fluid.Executor(fluid.CPUPlace()).run(
        main, feed=feed, fetch_list=fetch, scope=host)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0], rtol=1e-2)


# The prepared step captured as one CUDA graph (core/step_graph.py): a
# small LM (d_model 256, 2 heads of 128, 2 layers, sequence 128, batch
# 2; the fused-block program) and the fused cifar10 ResNet (depth 8,
# batch 4), both under Float16Transpiler.

def _prepared_program(kind):
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.models import resnet, transformer

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if kind == "lm":
            loss, _, _ = transformer.get_model(
                vocab_size=64, seq_len=128, d_model=256, n_head=2,
                n_layers=2, d_ff=512, fuse_transformer=True)
        else:
            loss, _, _ = resnet.get_model(data_set="cifar10", depth=8,
                                          data_format="NHWC",
                                          fused_stages=True)
    fluid.transpiler.Float16Transpiler().transpile(main)
    return main, startup, loss


def _prepared_feeds(kind, n):
    rng = np.random.RandomState(3)
    out = []
    for _ in range(n):
        if kind == "lm":
            toks = rng.randint(0, 64, (2, 129))
            out.append({"src": toks[:, :-1], "label": toks[:, 1:, None]})
        else:
            out.append({"data": rng.rand(4, 3, 32, 32).astype(np.float32),
                        "label": rng.randint(0, 10, (4, 1))
                        .astype(np.int64)})
    return out


# a step's launches: K1-K3 and K4/K5's bf16 forms (LM), K6's (ResNet)
PREPARED_LAUNCHES = {
    "lm": {"flash_fwd_bf16": 2, "flash_bwd_dq_bf16": 2,
           "flash_bwd_dkv_bf16": 2, "matmul_epilogue_bf16": 9,
           "add_ln_bf16": 4},
    "resnet": {"conv_stage_bf16": 9}}


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["lm", "resnet"])
def test_captured_step_matches_run_on_card(cuda, kind):
    """From one starting scope, 3 prepared (captured) steps against 3
    run() steps: bit for bit where run() is bit-identical run to run,
    else losses within rtol 1e-2 (bf16 resolution) and persistables
    within 1e-2 of their largest magnitude; a replay launches each
    kernel as often as a run() step does, and the held loss of one
    step is not overwritten by the next."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays
    from paddle_tpu_torch.kernels import KERNELS, reset_launches

    main, startup, loss = _prepared_program(kind)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    start = fluid.Scope()
    exe.run(startup, scope=start)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    init = get_scope_arrays(start, persist)
    feeds = _prepared_feeds(kind, 3)

    def by_run():
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        losses = [exe.run(main, feed=f, fetch_list=[loss], scope=scope)[0]
                  for f in feeds]
        return losses, get_scope_arrays(scope, persist)

    run_a, run_b = by_run(), by_run()
    scope = fluid.Scope()
    set_scope_arrays(scope, init, "cuda")
    held = []
    with exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                     scope=scope) as prep:
        for i, f in enumerate(feeds):
            if i == 1:
                reset_launches()
            held.append(prep.run_prepared(f)[0])
        copies = [h.clone() for h in held]
        prep.run_prepared(feeds[0])         # a fourth step
    launches = {k: fn.launches for k, fn in KERNELS.items() if fn.launches}
    want = {k: 3 * n for k, n in PREPARED_LAUNCHES[kind].items()}
    assert launches == want
    for h, c in zip(held, copies):
        assert torch.equal(h, c)
    got_l = [h.float().cpu().numpy() for h in held]
    # the state after three steps: a fresh prepared run of three
    scope = fluid.Scope()
    set_scope_arrays(scope, init, "cuda")
    with exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                     scope=scope) as prep:
        for f in feeds:
            prep.run_prepared(f)
    got_p = get_scope_arrays(scope, persist)
    deterministic = (
        all(np.array_equal(a, b) for a, b in zip(run_a[0], run_b[0]))
        and all(np.array_equal(run_a[1][n], run_b[1][n]) for n in persist))
    if deterministic:
        for g, w in zip(got_l, run_a[0]):
            np.testing.assert_array_equal(g, w)
        for n in persist:
            np.testing.assert_array_equal(got_p[n], run_a[1][n], err_msg=n)
    else:
        np.testing.assert_allclose(np.ravel(got_l), np.ravel(run_a[0]),
                                   rtol=1e-2)
        for n in persist:
            w = run_a[1][n].astype(np.float64)
            scale = max(float(np.abs(w).max()), 1e-6)
            assert float(np.abs(got_p[n] - w).max()) <= 1e-2 * scale, n


@pytest.mark.cuda
def test_captured_step_copies_feeds_and_keeps_its_addresses_on_card(cuda):
    """A feed is copied into the graph's static buffer, never rebound:
    a source tensor changed after a step is read anew by the next one,
    and the static feed and state tensors keep their addresses (the
    kernels' tensor maps were encoded with them at capture), across an
    external write to the scope too."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays

    main, startup, loss = _prepared_program("lm")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    f1, f2 = _prepared_feeds("lm", 2)
    src = torch.from_numpy(f1["src"]).to(cuda)
    feed = {"src": src, "label": f1["label"]}
    prep = exe.prepare(main, feed_specs=feed, fetch_list=[loss, "src"],
                       scope=scope)
    _, got = prep.run_prepared(feed)
    assert torch.equal(got, src)
    step = prep._prep._step
    (cap,) = step._captures.values()
    feed_ptr = cap.feeds["src"].data_ptr()
    state_ptrs = {n: t.data_ptr() for n, t in step.state.items()}
    assert feed_ptr != src.data_ptr()
    src.copy_(torch.from_numpy(f2["src"]))
    _, got = prep.run_prepared(feed)
    assert torch.equal(got.cpu(), torch.from_numpy(f2["src"]))
    w = main.all_parameters()[0].name
    new = get_scope_arrays(scope, [w])[w] * 0.5          # flushes
    scope.set(w, torch.from_numpy(new).to(cuda))         # external write
    prep.run_prepared(feed)
    assert cap.feeds["src"].data_ptr() == feed_ptr
    assert {n: t.data_ptr() for n, t in step.state.items()} == state_ptrs


def _random_program(fluid):
    """uniform noise added to a persistable each step: a random op in a
    captured step."""
    from paddle_tpu_torch.core.types import DataType

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        w = fluid.layers.create_global_var([4096], 0.0, "float32",
                                           persistable=True, name="rw")
        block = main.global_block()
        noise = block.create_var(name="noise", shape=[4096],
                                 dtype="float32")
        block.append_op(type="uniform_random", outputs={"Out": [noise]},
                        attrs={"shape": [4096], "min": -1.0, "max": 1.0,
                               "dtype": DataType.FP32})
        block.append_op(type="elementwise_add",
                        inputs={"X": [w], "Y": [noise]},
                        outputs={"Out": [w]})
    main.random_seed = 7
    return main, startup, w


@pytest.mark.cuda
def test_prepare_refuses_a_random_op_on_card(cuda):
    """(Its name is kept from when prepare() refused random ops on a
    card.)  A random op in a captured step draws afresh at every replay,
    the numbers run() draws at the same step, bit for bit."""
    import paddle_tpu_torch.fluid as fluid

    out = {}
    for prepared in (False, True):
        main, startup, w = _random_program(fluid)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if prepared:
            with exe.prepare(main, fetch_list=["noise", w],
                             scope=scope) as prep:
                out[prepared] = [[t.cpu().numpy()
                                  for t in prep.run_prepared()]
                                 for _ in range(4)]
        else:
            out[prepared] = [exe.run(main, fetch_list=["noise", w],
                                     scope=scope) for _ in range(4)]
    for a, b in zip(out[False], out[True]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    noise = [o[0] for o in out[True]]
    for i in range(3):
        assert not np.array_equal(noise[i], noise[i + 1])


@pytest.mark.cuda
def test_a_failed_capture_raises_runtime_error_on_card(cuda, monkeypatch):
    """An op that waits for the host (``.item()``) cannot be captured:
    the prepared step raises RuntimeError naming the op -- not a
    ValueError, which the bench entry and ParallelExecutor would take
    as their cue to fall back to run()."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core import registry

    def lower(ctx, ins, attrs, op):
        x = ins["X"]
        return {"Out": x * float(x.sum().item())}

    monkeypatch.setitem(registry._registry, "host_sync_probe",
                        registry.OpInfo("host_sync_probe", lower=lower,
                                        grad_maker=None))
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        block = main.global_block()
        out = block.create_var(name="probe_out", shape=[-1, 4],
                               dtype="float32")
        block.append_op(type="host_sync_probe", inputs={"X": [x]},
                        outputs={"Out": [out]}, infer_shape=False)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    feed = {"x": np.ones((2, 4), np.float32)}
    prep = exe.prepare(main, feed_specs=feed, fetch_list=[out], scope=scope)
    with pytest.raises(RuntimeError, match="host_sync_probe") as err:
        prep.run_prepared(feed)
    assert not isinstance(err.value, ValueError)
    torch.cuda.synchronize()
    # the card is usable after the failed capture
    got, = exe.run(main, feed=feed, fetch_list=[out], scope=scope)
    np.testing.assert_array_equal(got, np.full((2, 4), 8.0, np.float32))


def _probe_program():
    """A fed block writing a persistable it never reads: probe = mean(x)."""
    import paddle_tpu_torch.fluid as fluid

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[4], dtype="float32")
        probe = fluid.layers.create_global_var([1], 0.0, "float32",
                                               persistable=True,
                                               name="probe")
        m = fluid.layers.mean(x)
        main.global_block().append_op(type="assign", inputs={"X": [m]},
                                      outputs={"Out": [probe]})
    return main, startup


@pytest.mark.cuda
@pytest.mark.parametrize("between", ["external_write", "run"])
def test_captured_step_keeps_write_only_persistables_on_card(cuda,
                                                             between):
    """A persistable the step writes and never reads still reaches the
    scope after a re-stage (an external write, or a run() between two
    replays): each replay puts the graph's output back."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays

    main, startup = _probe_program()
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    prep = exe.prepare(main, feed_specs=["x"], fetch_list=[], scope=scope)
    prep.run_prepared({"x": np.ones((2, 4), np.float32)})   # captures
    prep.run_prepared({"x": np.full((2, 4), 2.0, np.float32)})
    if between == "run":
        exe.run(main, feed={"x": np.full((2, 4), 3.0, np.float32)},
                scope=scope)
        seen = 3.0
    else:
        scope.set("probe", torch.full((1,), 123.0, device=cuda))
        seen = 123.0
    assert get_scope_arrays(scope, ["probe"])["probe"][0] == seen
    prep.run_prepared({"x": np.full((2, 4), 8.0, np.float32)})
    prep.sync_scope()
    assert get_scope_arrays(scope, ["probe"])["probe"][0] == 8.0


@pytest.mark.cuda
def test_prepare_refuses_assign_value_and_parallel_executor_runs_it_on_card(
        cuda):
    """assign_value copied from host memory each step and was refused;
    now the prepared step reads a device constant made at prepare():
    prepare() takes it, the captured steps are run()'s bit for bit, and
    ParallelExecutor runs it prepared."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.types import DataType

    def build():
        main, startup = fluid.Program(), fluid.Program()
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            w = fluid.layers.create_global_var([3], 0.0, "float32",
                                               persistable=True, name="av_w")
            block = main.global_block()
            c = block.create_var(name="av_c", shape=[3], dtype="float32")
            block.append_op(type="assign_value", outputs={"Out": [c]},
                            attrs={"shape": [3], "dtype": DataType.FP32,
                                   "fp32_values": [1.0, 2.0, 3.0]})
            block.append_op(type="elementwise_add",
                            inputs={"X": [w], "Y": [c]},
                            outputs={"Out": [w]})
        return main, startup, w

    exe = fluid.Executor(fluid.CUDAPlace(0))
    out = {}
    for how in ("prepared", "run"):
        main, startup, w = build()
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        if how == "prepared":
            prep = exe.prepare(main, feed_specs={}, fetch_list=[w],
                               scope=scope)
            out[how] = [prep.run_prepared({}, return_numpy=True)[0]
                        for _ in range(3)]
            assert sum(c["replays"] for c in
                       prep._prep._step.buckets.values()) == 3
        else:
            out[how] = [exe.run(main, fetch_list=[w], scope=scope)[0]
                        for _ in range(3)]
    for k, (a, b) in enumerate(zip(out["prepared"], out["run"])):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, (k + 1) * np.float32([1, 2, 3]))
    main, startup, w = build()
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    pe = fluid.ParallelExecutor(main_program=main, scope=scope,
                                num_devices=1)
    for step in (1, 2):
        got, = pe.run([w.name])
        np.testing.assert_array_equal(
            got, step * np.array([1.0, 2.0, 3.0], np.float32))
    assert pe._prepared and not pe._unpreparable


def _sched_fc(fluid, schedule):
    """A small fc regression under ``schedule`` (piecewise or noam),
    Adam with a global-norm clip and L2Decay; returns (loss, lr)."""
    L = fluid.layers
    x = L.data(name="x", shape=[32], dtype="float32")
    y = L.data(name="y", shape=[1], dtype="float32")
    loss = L.mean(L.square_error_cost(L.fc(L.fc(x, 64, act="relu"), 1), y))
    fluid.clip.set_gradient_clip(fluid.clip.GradientClipByGlobalNorm(0.1))
    lr = (L.piecewise_decay([2, 4], [1e-2, 5e-3, 2.5e-3])
          if schedule == "piecewise" else L.noam_decay(64, 3))
    fluid.optimizer.Adam(learning_rate=lr,
                         regularization=fluid.regularizer.L2Decay(1e-3)
                         ).minimize(loss)
    return loss, lr


def _sched_feed(seed):
    rng = np.random.RandomState(seed)
    return {"x": rng.randn(16, 32).astype(np.float32),
            "y": rng.randn(16, 1).astype(np.float32)}


@pytest.mark.cuda
def test_captured_piecewise_decay_is_run_bit_for_bit_on_card(cuda):
    """piecewise_decay's table (an assign_value) and the step counter's
    increment inside the captured graph: 6 replays cross both
    boundaries, their learning rates the table's, and every fetch and
    persistable equals a run() loop's bit for bit."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, lr = _sched_fc(fluid, "piecewise")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    out, state = {}, {}
    for how in ("prepared", "run"):
        main.random_seed = startup.random_seed = 3
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        feeds = [_sched_feed(i) for i in range(6)]
        if how == "prepared":
            prep = exe.prepare(main, feed_specs=feeds[0],
                               fetch_list=[loss, lr], scope=scope)
            out[how] = [prep.run_prepared(f, return_numpy=True)
                        for f in feeds]
            prep.sync_scope()
        else:
            out[how] = [exe.run(main, feed=f, fetch_list=[loss, lr],
                                scope=scope) for f in feeds]
        state[how] = get_scope_arrays(scope, persist)
    lrs = [float(o[1][0]) for o in out["prepared"]]
    assert lrs == [np.float32(v) for v in
                   (1e-2, 5e-3, 5e-3, 2.5e-3, 2.5e-3, 2.5e-3)]
    for a, b in zip(out["prepared"], out["run"]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for n in persist:
        np.testing.assert_array_equal(state["prepared"][n],
                                      state["run"][n], err_msg=n)
    assert state["run"]["@LR_DECAY_COUNTER@"][0] == 6.0


@pytest.mark.cuda
def test_the_step_counter_survives_a_mid_loop_save_on_card(cuda, tmp_path):
    """Three captured steps under noam_decay, save_checkpoint in the
    loop (no sync_scope by hand), three more; a fresh scope that loads
    the checkpoint and prepares again continues the schedule: its
    learning rates, losses and persistables equal the uninterrupted
    run's bit for bit, and its counter ends at 6."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, lr = _sched_fc(fluid, "noam")
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    feeds = [_sched_feed(10 + i) for i in range(6)]
    scope = fluid.Scope()
    exe.run(startup, scope=scope)
    prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss, lr],
                       scope=scope)
    whole = [prep.run_prepared(f, return_numpy=True) for f in feeds[:3]]
    ckpt = str(tmp_path / "ckpt")
    with fluid.scope_guard(scope):
        fluid.io.save_checkpoint(exe, ckpt, main_program=main)
    whole += [prep.run_prepared(f, return_numpy=True) for f in feeds[3:]]
    prep.sync_scope()
    done = get_scope_arrays(scope, persist)
    resumed = fluid.Scope()
    exe.run(startup, scope=resumed)
    with fluid.scope_guard(resumed):
        fluid.io.load_checkpoint(exe, ckpt, main_program=main)
    assert get_scope_arrays(resumed, ["@LR_DECAY_COUNTER@"])[
        "@LR_DECAY_COUNTER@"][0] == 3.0
    prep2 = exe.prepare(main, feed_specs=feeds[3], fetch_list=[loss, lr],
                        scope=resumed)
    again = [prep2.run_prepared(f, return_numpy=True) for f in feeds[3:]]
    prep2.sync_scope()
    for a, b in zip(whole[3:], again):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for s, o in enumerate(whole, 1):
        want = 64 ** -0.5 * min(s ** -0.5, 3 ** -1.5 * s)
        assert abs(float(o[1][0]) - want) <= float(
            np.spacing(np.float32(want)))
    redo = get_scope_arrays(resumed, persist)
    for n in persist:
        np.testing.assert_array_equal(redo[n], done[n], err_msg=n)
    assert redo["@LR_DECAY_COUNTER@"][0] == 6.0


# The serving engine's bucket steps, each captured as one CUDA graph
# (serving/generative.py over core/step_graph.capture), at a narrow
# config the kernels take: head_dim 128, 16-token blocks.

SERVE_LM = dict(vocab=512, d_model=256, n_heads=2, n_layers=2, d_ff=512,
                block_size=16)


def _serve_engine(quant="", warm=False, max_batch=4, max_blocks=16,
                  kv_blocks=64, name="", **kw):
    from paddle_tpu_torch.serving import GenerativeEngine, tiny_lm

    cfg, params = tiny_lm(3, max_batch=max_batch, max_blocks=max_blocks,
                          **SERVE_LM)
    return GenerativeEngine(cfg, params, quant=quant, kv_blocks=kv_blocks,
                            device="cuda", warm=warm, name=name, **kw)


def _draft(max_batch=4, max_blocks=16):
    from paddle_tpu_torch.serving import tiny_lm

    return tiny_lm(4, max_batch=max_batch, max_blocks=max_blocks,
                   **dict(SERVE_LM, n_layers=1))


def _fill_pages(eng, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    for t in (eng._kp, eng._vp):
        t.copy_(torch.randn(t.shape, device="cuda", generator=g))


def _replay_vs_eager(eng, step, host):
    """(replay outputs, pages after) and (eager outputs, pages after)
    of ``step`` on ``host`` inputs, both from the same pages.  The pages
    are those past the scratch block 0, into which a prefill's padding
    positions write at once, in no defined order."""
    pages = [t.clone() for t in (eng._kp, eng._vp)]
    with torch.no_grad():
        got = [t.clone() for t in step.run(**host)]
        after = [t[:, 1:].clone() for t in (eng._kp, eng._vp)]
        for t, p in zip((eng._kp, eng._vp), pages):
            t.copy_(p)
        want = step.fn()
    return (got, after), (list(want), [eng._kp[:, 1:], eng._vp[:, 1:]])


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["", "int8"])
def test_captured_bucket_steps_match_the_eager_step_on_card(cuda, quant):
    """A captured decode bucket and a captured prefill bucket against the
    same step function run eagerly on the card, bit for bit (tokens,
    logits and every page but the scratch block), at two lengths inside
    each bucket: the lengths are device buffers, not values baked into
    the graph."""
    eng = _serve_engine(quant)
    try:
        _fill_pages(eng, 0)
        dec = eng._compile_decode((4, 8), with_logits=True)
        pre = eng._compile_prefill((64,))
        assert dec.graph is not None and pre.graph is not None
        assert dec.launches.get("paged_attention") == 2
        assert pre.launches.get("flash_fwd") == 2
        assert dec.launches.get("matmul_int8", 0) == (8 if quant else 0)
        rng = np.random.RandomState(1)
        for lens in ([5, 70, 127, 0], [100, 3, 16, 64]):
            tables = np.zeros((4, 8), np.int32)
            tables[:3] = rng.choice(np.arange(1, 64), (3, 8), replace=False)
            host = dict(tables=tables, lens=np.array(lens, np.int32),
                        toks=rng.randint(0, 512, 4).astype(np.int64))
            (got, gp), (want, wp) = _replay_vs_eager(eng, dec, host)
            for a, b in zip(got + gp, want + wp):
                assert torch.equal(a, b)
        for n in (17, 50):
            ids = np.zeros(4, np.int64)
            ids[:-(-n // 16)] = rng.choice(np.arange(1, 64), -(-n // 16),
                                           replace=False)
            toks = np.zeros(64, np.int64)
            toks[:n] = rng.randint(0, 512, n)
            host = dict(toks=toks, length=np.array([n], np.int64), ids=ids)
            (got, gp), (want, wp) = _replay_vs_eager(eng, pre, host)
            for a, b in zip(got + gp, want + wp):
                assert torch.equal(a, b)
    finally:
        eng.close()


@pytest.mark.cuda
def test_decode_rows_same_bits_at_any_table_width_on_card(cuda):
    """K7 gives a row the same bits at any table width: one decode step
    at (16, 64) and at (16, 128), the same 16 rows (at most 40 blocks
    each), gives the same tokens, logits and pages bit for bit, so a
    covering bucket changes nothing a row computes."""
    eng = _serve_engine(max_batch=16, max_blocks=128, kv_blocks=16 * 40 + 1)
    try:
        _fill_pages(eng, 2)
        rng = np.random.RandomState(3)
        blocks = rng.permutation(np.arange(1, 16 * 40 + 1)).reshape(16, 40)
        nbs = rng.randint(1, 41, 16)
        blocks_list = [list(b[:n]) for b, n in zip(blocks, nbs)]
        lens = [int(rng.randint(16 * (n - 1), 16 * n)) for n in nbs]
        toks = rng.randint(0, 512, 16).tolist()
        out = {}
        pages = [t.clone() for t in (eng._kp, eng._vp)]
        for key in ((16, 64), (16, 128)):
            for t, p in zip((eng._kp, eng._vp), pages):
                t.copy_(p)
            eng._decode_logits.warm([key])
            nxt, logits = eng.decode_step(blocks_list, lens, toks,
                                          with_logits=True)
            assert eng.last_decode_key == key
            out[key] = (nxt, logits, eng._kp.clone(), eng._vp.clone())
            # (16, 128) covered the miss of (16, 64), captured meanwhile
            eng._decode_logits.drain()
            eng._decode_logits.clear()
        a, b = out[(16, 64)], out[(16, 128)]
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])
        assert torch.equal(a[2], b[2]) and torch.equal(a[3], b[3])
    finally:
        eng.close()


@pytest.mark.cuda
def test_a_miss_captures_in_the_background_while_a_tenant_serves_on_card(
        cuda):
    """Tenant A's decode misses its bucket: the covering graph answers at
    once and the exact bucket captures in a background thread (thread-
    local capture mode), while tenant B's thread replays its own
    decode step the whole time.  B's tokens equal those of the same
    steps run alone, A's exact bucket lands with no failure, and A's
    rows get the same bits from both buckets."""
    import threading

    a = _serve_engine(warm=True, name="a")
    b = _serve_engine(quant="int8", warm=True, name="b")
    try:
        for eng, seed in ((a, 4), (b, 5)):
            _fill_pages(eng, seed)
        rows = ([[1, 2], [3], [4, 5]], [20, 5, 17], [7, 8, 9])
        a._decode_logits.warm([(4, 16)])
        b._decode.warm([(4, 2)])             # B replays its exact bucket
        b_pages = [t.clone() for t in (b._kp, b._vp)]

        def b_steps(n):
            for t, p in zip((b._kp, b._vp), b_pages):
                t.copy_(p)
            return [b.decode_step(*rows).tolist() for _ in range(n)]

        alone = b_steps(40)
        during, stop = [], threading.Event()
        a_pages = [t.clone() for t in (a._kp, a._vp)]

        def serve_b():
            while not stop.is_set():
                during.append(b_steps(40))

        t = threading.Thread(target=serve_b)
        t.start()
        try:
            while not during:
                time.sleep(0.01)
            covered = a.decode_step(*rows, with_logits=True)
            assert a.last_decode_key == (4, 16)
            a._decode_logits.drain()
        finally:
            stop.set()
            t.join(120)
        assert a._decode_logits.warm_keys == [(4, 2), (4, 16)]
        assert a._decode_logits.compile_failures == 0
        assert all(d == alone for d in during) and len(during) >= 2
        for x, p in zip((a._kp, a._vp), a_pages):
            x.copy_(p)
        exact = a.decode_step(*rows, with_logits=True)
        assert a.last_decode_key == (4, 2)
        np.testing.assert_array_equal(covered[0], exact[0])
        np.testing.assert_array_equal(covered[1], exact[1])
    finally:
        a.close()
        b.close()


@pytest.mark.cuda
def test_a_failed_bucket_capture_runs_nothing_eagerly_on_card(
        cuda, monkeypatch):
    """A step that waits for the host cannot be captured.  With nothing
    covering, the decode raises RuntimeError naming the bucket and the
    row's page is untouched (the step never ran on it; the warm-ups
    wrote block 0 only).  With a covering bucket warm, the background
    capture fails, warns, and traffic stays on the covering graph."""
    eng = _serve_engine()
    try:
        eng._decode.warm([(4, 16)])
        head = eng._head

        def host_sync(h):
            return head(h) * float(h.sum().item() * 0 + 1)

        monkeypatch.setattr(eng, "_head", host_sync)
        blocks = eng.pool.alloc(2)
        pages = eng._kp[:, blocks].clone()
        with pytest.raises(RuntimeError, match=r"decode_logits \(1, 2\)") \
                as err:
            eng.decode_step([blocks], [20], [7], with_logits=True)
        assert not isinstance(err.value, ValueError)
        assert torch.equal(eng._kp[:, blocks], pages)
        assert eng._decode_logits.warm_keys == [] and eng.replays == 0
        with pytest.warns(UserWarning, match="traffic stays on covering"):
            eng.decode_step([blocks], [20], [7])
            assert eng.last_decode_key == (4, 16)
            eng._decode.drain()
        assert eng._decode.compile_failures == 1
        assert eng._decode.warm_keys == [(4, 16)] and eng.replays == 1
    finally:
        eng.close()


@pytest.mark.cuda
@pytest.mark.parametrize("quant", ["", "int8"])
def test_captured_prefix_and_spec_steps_match_the_eager_step_on_card(
        cuda, quant):
    """A captured suffix-prefill bucket, verify bucket and (the draft's)
    propose bucket against the same step function run eagerly on the
    card, bit for bit (tokens, logits and every page but the scratch
    block), at two inputs each: the starts, counts and lengths are
    device buffers, not values baked into the graph.  Each graph records
    K7 once a layer and step (K8 four times a layer under int8) and no
    K1."""
    eng = _serve_engine(quant, prefix_cache=True, spec_k=3,
                        draft=_draft())
    d = eng.draft
    try:
        _fill_pages(eng, 6)
        _fill_pages(d, 7)
        pre = eng._compile_prefill_cached((64,))
        ver = eng._compile_verify((4, 8, 4), with_logits=True)
        pro = d._compile_propose((4, 8, 3))
        int8 = 8 if quant else 0
        assert pre.launches.get("paged_attention") == 2
        assert ver.launches.get("paged_attention") == 2
        assert pro.launches.get("paged_attention") == 3
        assert pre.launches.get("flash_fwd", 0) == 0
        assert pre.launches.get("matmul_int8", 0) == int8
        assert ver.launches.get("matmul_int8", 0) == int8
        assert pro.launches.get("matmul_int8", 0) == 0
        rng = np.random.RandomState(2)
        ids = np.zeros(16, np.int32)
        ids[:8] = rng.choice(np.arange(1, 64), 8, replace=False)
        for start, count in ((40, 50), (100, 3)):
            toks = np.zeros(64, np.int64)
            toks[:count] = rng.randint(0, 512, count)
            host = dict(toks=toks, start=np.array([start], np.int64),
                        count=np.array([count], np.int64), ids=ids)
            (got, gp), (want, wp) = _replay_vs_eager(eng, pre, host)
            for a, b in zip(got + gp, want + wp):
                assert torch.equal(a, b)
        for lens in ([5, 70, 100, 0], [30, 3, 16, 64]):
            tables = np.zeros((4, 8), np.int32)
            tables[:3] = rng.choice(np.arange(1, 64), (3, 8), replace=False)
            for step, e, toks in (
                    (ver, eng, rng.randint(0, 512, (4, 4))),
                    (pro, d, rng.randint(0, 512, 4))):
                host = dict(tables=tables, lens=np.array(lens, np.int32),
                            toks=toks.astype(np.int64))
                (got, gp), (want, wp) = _replay_vs_eager(e, step, host)
                for a, b in zip(got + gp, want + wp):
                    assert torch.equal(a, b)
    finally:
        eng.close()


@pytest.mark.cuda
def test_copy_block_matches_a_host_copy_on_card(cuda):
    """copy_block (the COW copy) moves one block's K/V across all layers
    and touches no other page: the pages equal a host copy of them."""
    eng = _serve_engine(prefix_cache=True)
    try:
        _fill_pages(eng, 8)
        want = [t.cpu() for t in (eng._kp, eng._vp)]
        for t in want:
            t[:, 9] = t[:, 5]
        eng.copy_block(5, 9)
        for t, w in zip((eng._kp, eng._vp), want):
            assert torch.equal(t.cpu(), w)
    finally:
        eng.close()


@pytest.mark.cuda
def test_prefix_and_spec_certificate_at_a_small_width_on_card(cuda):
    """The captured tenants on the card, at a small width: the prefix
    tenant's and the speculative tenant's greedy tokens equal the plain
    tenant's, the prefix tenant shares blocks, and the speculative
    accounting closes (proposed = k x rows, the tokens emitted within k
    of those delivered a request).  Every step of each tenant, the
    draft's included, is a replay."""
    from paddle_tpu_torch.serving import InferenceServer, tiny_lm

    cfg, params = tiny_lm(3, max_batch=4, max_blocks=16, **SERVE_LM)
    rng = np.random.RandomState(9)
    system = rng.randint(0, 512, 70).tolist()
    prompts = [system + rng.randint(0, 512, n).tolist()
               for n in (5, 30, 17, 60)] + [rng.randint(0, 512, 40).tolist()]
    out = {}
    with InferenceServer(device="cuda") as srv:
        for name, kw in (("plain", {}), ("prefix", {"prefix_cache": True}),
                         ("spec", {"spec_k": 3, "draft": _draft()})):
            eng = srv.load_generative(name, cfg, params, kv_blocks=128, **kw)
            res = [srv.generate(name, p, 20).result(300) for p in prompts[:2]]
            res += [f.result(300) for f in [srv.generate(name, p, 20)
                                            for p in prompts[2:]]]
            out[name] = [r["tokens"] for r in res]
            eng.drain()
            for e in (eng, eng.draft):
                if e is not None:
                    assert e.replays == e.steps > 0
            if name == "prefix":
                assert eng.pool.prefix_hits > 0
            if name == "spec":
                assert eng.spec_rounds > 0
                assert eng.spec_proposed == 3 * eng.decode_rows
                emitted = eng.prefills + eng.spec_accepted + eng.decode_rows
                delivered = sum(len(t) for t in out[name])
                assert delivered <= emitted <= delivered + 3 * len(prompts)
    assert out["prefix"] == out["plain"]
    assert out["spec"] == out["plain"]


@pytest.mark.cuda
def test_export_import_round_trip_between_two_engines_on_card(cuda):
    """export_blocks on one card engine and import_blocks into another
    move a block set's K/V bit for bit, into the destination's page
    tensors in place (same storage), touching no other block."""
    src, dst = _serve_engine(name="src"), _serve_engine(name="dst")
    try:
        _fill_pages(src, 10)
        _fill_pages(dst, 11)
        blocks_src, blocks_dst = [5, 9, 2, 40], [7, 3, 60, 11]
        want = [t[:, blocks_src].cpu() for t in (src._kp, src._vp)]
        before = [t.cpu() for t in (dst._kp, dst._vp)]
        ptrs = [t.data_ptr() for t in (dst._kp, dst._vp)]
        k, v, _ = src.export_blocks(blocks_src)
        assert isinstance(k, np.ndarray) and k.dtype == np.float32
        for got, w in zip((k, v), want):
            assert torch.equal(torch.from_numpy(got), w)
        dst.import_blocks(blocks_dst, k, v)
        assert [t.data_ptr() for t in (dst._kp, dst._vp)] == ptrs
        for t, w, b in zip((dst._kp, dst._vp), want, before):
            b[:, blocks_dst] = w
            assert torch.equal(t.cpu(), b)
    finally:
        src.close()
        dst.close()


@pytest.mark.cuda
def test_an_import_after_a_capture_is_read_by_its_replay_on_card(cuda):
    """A decode bucket captured, THEN a prompt's pages imported into
    fresh blocks of that engine: replays of the captured graph over
    those blocks give the tokens and logits of the same prompt prefilled
    locally and decoded through the same graph, bit for bit."""
    src, dst = _serve_engine(name="src"), _serve_engine(name="dst")
    try:
        dst._decode_logits.warm([(1, 4)])
        step = dst._decode_logits.get((1, 4))
        assert step.graph is not None
        prompt = np.random.RandomState(12).randint(0, 512, 50).tolist()
        sb = src.pool.alloc(4)         # 50 + 6 positions, 16 a block
        first = src.prefill_tokens(prompt, sb)
        k, v, _ = src.export_blocks(sb)
        out = {}
        for how in ("imported", "local"):
            blocks = dst.pool.alloc(4)
            if how == "imported":
                dst.import_blocks(blocks, k, v)
                tok = first
            else:
                tok = dst.prefill_tokens(prompt, blocks)
            toks, logits = [tok], []
            for i in range(6):
                nxt, lg = dst.decode_step([blocks], [50 + i], [toks[-1]],
                                          with_logits=True)
                assert dst.last_decode_key == (1, 4)
                toks.append(int(nxt[0]))
                logits.append(lg[0])
            out[how] = (toks, np.stack(logits))
            dst.pool.free(blocks)
        assert dst._decode_logits.get((1, 4)) is step
        assert out["imported"][0] == out["local"][0]
        np.testing.assert_array_equal(out["imported"][1], out["local"][1])
    finally:
        src.close()
        dst.close()


@pytest.mark.cuda
def test_export_returns_after_its_copy_completes_on_card(cuda):
    """export_blocks synchronises before it returns: the blocks freed and
    re-prefilled at once with another prompt, the exported host pages,
    read straight after the return, still equal the pages as they were
    (and differ from the new ones)."""
    eng = _serve_engine()
    try:
        rng = np.random.RandomState(13)
        blocks = eng.pool.alloc(16)
        eng.prefill_tokens(rng.randint(0, 512, 250).tolist(), blocks)
        want = [t[:, blocks].cpu() for t in (eng._kp, eng._vp)]
        k, v, _ = eng.export_blocks(blocks)
        snap = [k.copy(), v.copy()]
        eng.pool.free(blocks)
        again = eng.pool.alloc(16)
        assert sorted(again) == sorted(blocks)
        eng.prefill_tokens(rng.randint(0, 512, 250).tolist(), blocks)
        torch.cuda.synchronize()
        for got, s, w, t in zip((k, v), snap, want, (eng._kp, eng._vp)):
            assert torch.equal(torch.from_numpy(s), w)
            assert torch.equal(torch.from_numpy(got), w)
            assert not torch.equal(t[:, blocks].cpu(), w)
    finally:
        eng.close()


# ---------------------------------------------------------------- slice 21:
# dropout and its random stream in a captured step, K4's dropout
# branch, the sparse updates

def _dropout_chain(fluid, seed, fuse, d=256, rows=64, amp=False):
    """x [rows, d] -> fc(4d, gelu) -> dropout(0.1, seed) -> fc(d) ->
    + x -> mean, Adam; fused (K4 + the mask in torch) with ``fuse``."""
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = fluid.layers.data(name="x", shape=[d], dtype="float32")
        h = fluid.layers.fc(x, size=4 * d, act="gelu")
        h = fluid.layers.dropout(h, dropout_prob=0.1, seed=seed)
        h = fluid.layers.fc(h, size=d)
        loss = fluid.layers.mean(fluid.layers.elementwise_add(x, h))
        if fuse:
            counts = fluid.transpiler.TransformerFuseTranspiler().transpile(
                main)
            assert counts.get("matmul_bias_act"), counts
        fluid.optimizer.Adam(learning_rate=1e-3).minimize(loss)
    if amp:
        fluid.transpiler.Float16Transpiler().transpile(main)
    main.random_seed = 3
    masks = [op.output("Mask")[0] for op in main.desc.blocks[0].ops
             if op.type in ("dropout", "fused_matmul_bias_act")
             and op.output("Mask", [])]
    return main, startup, loss, masks


def _chain_feed(d=256, rows=64):
    return {"x": np.random.RandomState(1).randn(rows, d).astype(np.float32)}


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_explicit_seed_draws_one_mask_under_replay_on_card(cuda, fuse):
    """dropout(seed=11): every replay draws the same mask (a replay
    does not advance the op's generator), the mask run() draws, and the
    fused program's mask is the unfused one's."""
    import paddle_tpu_torch.fluid as fluid

    got = {}
    for f in (False, True):
        main, startup, loss, masks = _dropout_chain(fluid, 11, f)
        exe = fluid.Executor(fluid.CUDAPlace(0))
        scope = fluid.Scope()
        exe.run(startup, scope=scope)
        with exe.prepare(main, feed_specs=_chain_feed(),
                         fetch_list=masks, scope=scope) as prep:
            got[f] = [prep.run_prepared(_chain_feed())[0].cpu().numpy()
                      for _ in range(3)]
        got[f, "run"] = exe.run(main, feed=_chain_feed(), fetch_list=masks,
                                scope=scope)[0]
    a = got[fuse]
    np.testing.assert_array_equal(a[0], a[1])
    np.testing.assert_array_equal(a[0], a[2])
    np.testing.assert_array_equal(a[0], got[fuse, "run"])
    np.testing.assert_array_equal(got[False][0], got[True][0])


@pytest.mark.cuda
@pytest.mark.parametrize("fuse", [False, True])
def test_warmup_leaves_the_stream_untouched_on_card(cuda, fuse):
    """The capture's warm-up steps draw but move no counter: from one
    start, N prepared (captured) steps and N run() steps of a run-seeded
    dropout program give bit-identical losses, masks and persistables,
    each step's mask new, the scope's counter advanced N times."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    n = 6
    main, startup, loss, masks = _dropout_chain(fluid, None, fuse)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    start = fluid.Scope()
    exe.run(startup, scope=start)
    persist = sorted(k for k, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    init = get_scope_arrays(start, persist)
    out = {}
    for prepared in (False, True):
        scope = fluid.Scope()
        set_scope_arrays(scope, init, "cuda")
        if prepared:
            with exe.prepare(main, feed_specs=_chain_feed(),
                             fetch_list=[loss] + masks, scope=scope) as prep:
                steps = [[t.cpu().numpy() for t in
                          prep.run_prepared(_chain_feed())]
                         for _ in range(n)]
        else:
            steps = [exe.run(main, feed=_chain_feed(),
                             fetch_list=[loss] + masks, scope=scope)
                     for _ in range(n)]
        assert scope._rng_counter == n
        out[prepared] = steps, get_scope_arrays(scope, persist)
    for a, b in zip(out[False][0], out[True][0]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for k in persist:
        np.testing.assert_array_equal(out[False][1][k], out[True][1][k],
                                      err_msg=k)
    m = [s[1] for s in out[True][0]]
    assert all(not np.array_equal(m[i], m[i + 1]) for i in range(n - 1))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k4_dropout_branch_matches_plain_on_card(cuda, dtype, monkeypatch):
    """fused_matmul_bias_act with dropout_prob 0.1: K4 computes matmul +
    bias + gelu, the mask and the residual follow in torch.  On one
    fixed mask, Out and MulOut against the plain version of the same
    composition on the same card tensors (f32 atol = rtol = 1e-4; bf16
    MulOut one ulp plus 1e-6 of max |Y|, Out that ulp carried through
    the residual add plus the add's rounding), and K4 launched once."""
    from paddle_tpu_torch.core.lowering import Ins, LoweringContext
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.kernels import KERNELS, reset_launches
    from paddle_tpu_torch.ops import random as prandom

    dt = getattr(torch, dtype)
    g = torch.Generator(device=cuda).manual_seed(4)
    m, k, n = 300, 256, 512
    x = torch.randn(m, k, device=cuda, generator=g).to(dt)
    w = (torch.randn(k, n, device=cuda, generator=g) / 16).to(dt)
    b = torch.randn(n, device=cuda, generator=g).to(dt)
    r = torch.randn(m, n, device=cuda, generator=g).to(dt)
    keep = torch.rand(m, n, device=cuda, generator=g) < 0.9
    monkeypatch.setattr(prandom, "keep_mask",
                        lambda ctx, shape, kp, seed=0: keep)

    class _Op:
        outputs = {"Out": ["o"], "MulOut": ["p"], "Mask": ["m"]}

    class _Prog:
        blocks = [None]

    ctx = LoweringContext(_Prog(), 0, {}, cuda)
    reset_launches()
    outs = get_op_info("fused_matmul_bias_act").lower(
        ctx, Ins({"X": [x], "W": [w], "Bias": [b], "Residual": [r]}),
        {"act": "gelu", "dropout_prob": 0.1}, _Op())
    name = "matmul_epilogue_bf16" if dtype == "bfloat16" else \
        "matmul_epilogue"
    assert KERNELS[name].launches == 1
    ref = pmm.matmul_epilogue_f32acc_reference if dtype == "bfloat16" \
        else pmm.matmul_epilogue_reference
    h, pre = ref(x, w, b, None, "gelu")
    mask = keep.to(h.dtype)
    want = h * mask + r
    torch.testing.assert_close(outs["Mask"], mask)
    if dtype == "bfloat16":
        from paddle_tpu_torch.kernels.conv_fused import bf16_ulp

        _assert_within_one_bf16_ulp(outs["MulOut"], pre)
        # K4's one ulp of h, carried through the bf16 residual add, plus
        # that add's own rounding
        w32 = want.float()
        err = (outs["Out"].float() - w32).abs()
        bound = bf16_ulp(h.float()) + bf16_ulp(w32) + 1e-6 * w32.abs().max()
        assert bool((err <= bound).all()), float((err / bound).max())
    else:
        torch.testing.assert_close(outs["MulOut"], pre, **TOL)
        torch.testing.assert_close(outs["Out"], want, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("optimizer", ["sgd", "momentum", "adam"])
def test_sparse_update_with_duplicate_ids_in_a_captured_step(cuda,
                                                              optimizer):
    """An is_sparse embedding (duplicate ids in every batch) under sgd,
    momentum and lazy adam: 3 captured steps on the card against 3
    run() steps on the CPU from the same start, to 1e-6."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    vocab, dim, seq = 512, 64, 16
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        ids = fluid.layers.data(name="ids", shape=[seq, 1], dtype="int64")
        e = fluid.layers.embedding(ids, size=[vocab, dim], is_sparse=True)
        loss = fluid.layers.mean(fluid.layers.fc(e, size=1))
        {"sgd": lambda: fluid.optimizer.SGD(learning_rate=0.5),
         "momentum": lambda: fluid.optimizer.Momentum(0.5, 0.9),
         "adam": lambda: fluid.optimizer.Adam(1e-3)}[optimizer]().minimize(
            loss)
    rng = np.random.RandomState(2)
    feeds = []
    for _ in range(3):
        x = rng.randint(0, vocab, (8, seq, 1)).astype(np.int64)
        x[:, :4] = x[0, 0]               # duplicates
        feeds.append({"ids": x})
    cpu = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=cpu)
    persist = sorted(k for k, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    init = get_scope_arrays(cpu, persist)
    want = [fluid.Executor(fluid.CPUPlace()).run(
        main, feed=f, fetch_list=[loss], scope=cpu)[0] for f in feeds]
    card = fluid.Scope()
    set_scope_arrays(card, init, "cuda")
    with fluid.Executor(fluid.CUDAPlace(0)).prepare(
            main, feed_specs=feeds[0], fetch_list=[loss],
            scope=card) as prep:
        got = [prep.run_prepared(f)[0].cpu().numpy() for f in feeds]
    np.testing.assert_allclose(np.ravel(got), np.ravel(want), rtol=1e-6,
                               atol=1e-6)
    a, b = get_scope_arrays(card, persist), get_scope_arrays(cpu, persist)
    for k in persist:
        np.testing.assert_allclose(a[k], b[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# checkpoints and the host-op runtime: tensors saved from and loaded onto
# the card, a save and a load around a captured prepared step, the
# Trainer's default place

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "int64"])
def test_save_load_round_trip_of_cuda_tensors_on_card(cuda, dtype, tmp_path):
    """A CUDA tensor is written as its CPU copy is (bf16 through its
    int16 bits) and read back bit for bit; through the save and load
    ops of an executor on the card, one file and combined, it comes back
    on the card in its dtype."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.utils import serialization

    g = torch.Generator(device=cuda).manual_seed(0)
    if dtype == "bfloat16":
        t = torch.randn(64, 33, device=cuda, generator=g).to(torch.bfloat16)
    else:
        t = torch.randint(-2 ** 40, 2 ** 40, (64, 33), device=cuda,
                          generator=g, dtype=torch.int64)
    assert serialization.tensor_to_bytes(t) == \
        serialization.tensor_to_bytes(t.cpu())
    serialization.save_tensor(str(tmp_path / "t"), t)
    back = serialization.load_tensor(str(tmp_path / "t"), as_torch=True)
    assert back.dtype == t.dtype and torch.equal(back, t.cpu())
    prog = fluid.Program()
    with fluid.program_guard(prog):
        prog.global_block().create_var(name="v", shape=list(t.shape),
                                       dtype=dtype, persistable=True)
    scope = fluid.Scope()
    scope.set("v", t)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    with fluid.scope_guard(scope):
        fluid.io.save_persistables(exe, str(tmp_path / "d"), prog)
        fluid.io.save_persistables(exe, str(tmp_path / "c"), prog,
                                   filename="all")
    for name, filename in (("d", None), ("c", "all")):
        fresh = fluid.Scope()
        with fluid.scope_guard(fresh):
            fluid.io.load_persistables(exe, str(tmp_path / name), prog,
                                       filename=filename)
        got = fresh.find_var("v")
        assert got.device.type == "cuda" and got.dtype == t.dtype
        assert torch.equal(got, t)


@pytest.mark.cuda
def test_a_save_mid_loop_and_a_load_on_a_captured_step_on_card(cuda,
                                                               tmp_path):
    """The small AMP LM's captured step: a save_checkpoint after 3
    replays, with no sync_scope by hand, writes the state after the
    third step and leaves the replays after it on the uninterrupted
    run's losses; a load into the scope while the prepared program lives
    is what its next replay reads; all bit for bit."""
    import os

    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.utils import serialization

    main, startup, loss = _prepared_program("lm")
    exe = fluid.Executor(fluid.CUDAPlace(0))
    start = fluid.Scope()
    exe.run(startup, scope=start)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    init = {n: start.find_var(n).clone() for n in persist}
    feeds = _prepared_feeds("lm", 6)

    def fresh():
        s = fluid.Scope()
        for n, v in init.items():
            s.set(n, v.clone())
        return s

    scope = fresh()
    want = []
    with exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                     scope=scope) as prep:
        for i, f in enumerate(feeds):
            want.append(prep.run_prepared(f)[0])
            if i == 2:
                prep.sync_scope()
                mid = {n: scope.find_var(n).clone() for n in persist}
    ckpt = str(tmp_path / "ckpt")
    scope = fresh()
    prep = exe.prepare(main, feed_specs=feeds[0], fetch_list=[loss],
                       scope=scope)
    got = []
    for i, f in enumerate(feeds):
        if i == 3:
            with fluid.scope_guard(scope):
                fluid.io.save_checkpoint(exe, ckpt, main_program=main)
        got.append(prep.run_prepared(f)[0])
    assert prep._prep._step._captures                # captured
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    files = os.path.join(ckpt, "checkpoint_0", "__model__")
    for n in persist:
        saved = serialization.load_tensor(os.path.join(files, n),
                                          as_torch=True)
        assert saved.dtype == mid[n].dtype
        assert torch.equal(saved, mid[n].cpu().reshape(saved.shape)), n
    with fluid.scope_guard(scope):
        fluid.io.load_checkpoint(exe, ckpt, main_program=main)
    assert all(scope.find_var(n).device.type == "cuda" for n in persist)
    assert torch.equal(prep.run_prepared(feeds[3])[0], want[3])


@pytest.mark.cuda
def test_trainer_defaults_to_the_card_on_card(cuda, tmp_path, monkeypatch):
    """fluid.Trainer and fluid.Inferencer with no place run on
    CUDAPlace(0); the Trainer's steps are captured prepared steps; the
    losses those of the same Trainer on the CPU (constant initial
    parameters) within rtol 1e-5, f32 on both."""
    import paddle_tpu_torch as pt
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid import executor as fexecutor

    w_true = np.random.RandomState(3).randn(8, 1).astype(np.float32)

    def reader():
        rng = np.random.RandomState(0)
        for _ in range(32):
            x = rng.randn(8).astype(np.float32)
            yield x, (x @ w_true).astype(np.float32)

    def net():
        x = fluid.layers.data(name="x", shape=[8], dtype="float32")
        const = fluid.initializer.ConstantInitializer(0.0)
        return x, fluid.layers.fc(
            x, size=1, param_attr=fluid.ParamAttr(name="w",
                                                  initializer=const),
            bias_attr=fluid.ParamAttr(name="b", initializer=const))

    def train_func():
        _, pred = net()
        y = fluid.layers.data(name="y", shape=[1], dtype="float32")
        return [fluid.layers.mean(fluid.layers.square_error_cost(pred, y))]

    prepared = []
    real = fexecutor.Executor.prepare

    def recording(self, *a, **k):
        prepared.append(real(self, *a, **k))
        return prepared[-1]

    monkeypatch.setattr(fexecutor.Executor, "prepare", recording)
    out = {}
    for name, place in (("card", None), ("cpu", fluid.CPUPlace())):
        t = fluid.Trainer(train_func=train_func,
                          optimizer_func=lambda: fluid.optimizer.SGD(0.05),
                          place=place)
        seen = []
        t.train(num_epochs=2,
                event_handler=lambda ev: seen.append(
                    float(ev.metrics[0].reshape(-1)[0]))
                if isinstance(ev, fluid.EndStepEvent) else None,
                reader=pt.batch(reader, 8), feed_order=["x", "y"])
        out[name] = (t, seen)
    t, seen = out["card"]
    assert t.place == fluid.CUDAPlace(0)
    assert t.scope.find_var("w").device.type == "cuda"
    assert prepared[0]._prep._step._captures
    np.testing.assert_allclose(seen, out["cpu"][1], rtol=1e-5)
    assert seen[-1] < seen[0]
    params = str(tmp_path / "params")
    t.save_params(params)
    inf = fluid.Inferencer(infer_func=lambda: net()[1], param_path=params)
    assert inf.place == fluid.CUDAPlace(0)
    assert inf.scope.find_var("w").device.type == "cuda"
    xs = np.ones((4, 8), np.float32)
    got, = inf.infer({"x": xs})
    w = inf.scope.find_var("w").cpu().numpy()
    b = inf.scope.find_var("b").cpu().numpy()
    np.testing.assert_allclose(got, xs @ w + b, rtol=1e-5)


@pytest.mark.cuda
def test_embedding_grad_sums_duplicates_in_one_order_on_card(cuda):
    """lookup_table_grad at the flagship LM's step (16 x 2048 ids, most
    repeated, into 8192 x 1024 rows) gives the same bits at every call,
    eager and as a CUDA graph replay (selected_rows.add_rows: the
    duplicates sum in one order; index_add_'s atomics sum them in the
    order they land), within f32 rounding of the float64 sum."""
    from paddle_tpu_torch.core.registry import get_op_info

    g = torch.Generator(device=cuda).manual_seed(0)
    ids = torch.randint(0, 8192, (16, 2048, 1), device=cuda, generator=g)
    w = torch.zeros(8192, 1024, device=cuda)
    dout = torch.randn(16, 2048, 1024, device=cuda, generator=g)
    lower = get_op_info("lookup_table_grad").lower

    def grad():
        return lower(None, {"Ids": ids, "W": w, "Out@GRAD": dout},
                     {"padding_idx": -1}, None)["W@GRAD"]

    first = grad()
    for _ in range(4):
        assert torch.equal(grad(), first)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        grad()
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = grad()
    for _ in range(3):
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out, first)
    want = torch.zeros(8192, 1024, dtype=torch.float64, device=cuda)
    want.index_add_(0, ids.reshape(-1), dout.reshape(-1, 1024).double())
    torch.testing.assert_close(first.double(), want, atol=1e-5, rtol=1e-6)


def _lstm_program(fluid, hidden=64, stacks=2, vocab=500):
    from paddle_tpu_torch.models import stacked_dynamic_lstm

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, _ = stacked_dynamic_lstm.get_model(
            dict_dim=vocab, hidden_dim=hidden, stacked_num=stacks)
    return main, startup, loss, slots


def _ragged_batch(fluid, main, slots, lens, seed, vocab=500):
    rng = np.random.RandomState(seed)
    return fluid.DataFeeder(slots, program=main).feed(
        [(rng.randint(0, vocab, int(n)).tolist(), [int(rng.randint(2))])
         for n in lens])


def _lstm_start(fluid, main, startup, device):
    from paddle_tpu_torch.fluid.io import get_scope_arrays

    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    s = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=s)
    return persist, get_scope_arrays(s, persist)


@pytest.mark.cuda
def test_ragged_lengths_reach_the_card_as_int32_in_a_captured_step(cuda):
    """A ragged feed's '@LEN' is staged on the card as int32 beside the
    padded ids, and the step captures as one CUDA graph with
    capture_error_mode "global": a host read of a length inside the step
    (``.item()``, a shape from a length) would fail the capture."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import set_scope_arrays

    main, startup, loss, slots = _lstm_program(fluid)
    _, init = _lstm_start(fluid, main, startup, cuda)
    feed = _ragged_batch(fluid, main, slots, [9, 3, 16, 5], 0)
    scope = fluid.Scope()
    set_scope_arrays(scope, init, "cuda")
    prep = fluid.Executor(fluid.CUDAPlace(0)).prepare(
        main, feed_specs=feed, fetch_list=[loss], scope=scope)
    out = prep.run_prepared(feed)[0]
    step = prep._prep._step
    (cap,) = step._captures.values()
    lens = cap.feeds["words@LEN"]
    assert lens.dtype == torch.int32 and lens.device.type == "cuda"
    assert lens.tolist() == [9, 3, 16, 5]
    assert cap.feeds["words"].shape == (4, 16, 1)
    assert out.device.type == "cuda" and torch.isfinite(out).all()


@pytest.mark.cuda
def test_prepared_step_over_three_buckets_is_run_bit_for_bit(cuda):
    """Batches of padded T 24, 16 and 8, stepped 0 1 2 0 1 2 0: one
    captured graph a bucket, each replayed as often as its batch comes,
    all three in one memory pool; the losses and every persistable equal
    run()'s bit for bit."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    main, startup, loss, slots = _lstm_program(fluid)
    persist, init = _lstm_start(fluid, main, startup, cuda)
    batches = [_ragged_batch(fluid, main, slots, lens, i)
               for i, lens in enumerate(([24, 3, 17], [16, 9, 2],
                                         [5, 8, 1]))]
    order = (0, 1, 2, 0, 1, 2, 0)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    sa, sb = fluid.Scope(), fluid.Scope()
    set_scope_arrays(sa, init, "cuda")
    set_scope_arrays(sb, init, "cuda")
    la = [exe.run(main, feed=batches[i], fetch_list=[loss], scope=sa)[0]
          for i in order]
    with exe.prepare(main, feed_specs=batches[0], fetch_list=[loss],
                     scope=sb) as prep:
        lb = [prep.run_prepared(batches[i], return_numpy=True)[0]
              for i in order]
        buckets = prep._prep._step.buckets
        pools = {c.graph.pool() for c in prep._prep._step._captures.values()}
    assert sorted(v["replays"] for v in buckets.values()) == [2, 2, 3]
    assert len(pools) == 1
    assert all(v["captures"] == 1 for v in buckets.values())
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    pa, pb = get_scope_arrays(sa, persist), get_scope_arrays(sb, persist)
    for n in persist:
        np.testing.assert_array_equal(pa[n], pb[n])


@pytest.mark.cuda
def test_lstm_step_on_card_matches_the_cpu(cuda):
    """One f32 step of a 2-stack LSTM (hidden 64) on 4 ragged sequences:
    the loss and every parameter gradient on the card against
    Executor(CPUPlace()) from the same parameters, at 1e-4."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import set_scope_arrays

    main, startup, loss, slots = _lstm_program(fluid)
    _, init = _lstm_start(fluid, main, startup, cuda)
    params = sorted(p.name for p in main.all_parameters())
    fetch = [loss.name] + [p + "@GRAD" for p in params]
    feed = _ragged_batch(fluid, main, slots, [5, 11, 17, 23], 3)
    out = {}
    for place, dev in ((fluid.CUDAPlace(0), "cuda"),
                       (fluid.CPUPlace(), "cpu")):
        scope = fluid.Scope()
        set_scope_arrays(scope, init, dev)
        out[dev] = fluid.Executor(place).run(main, feed=feed,
                                             fetch_list=fetch, scope=scope)
    for n, a, b in zip(fetch, out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a, b, err_msg=n, **TOL)


@pytest.mark.cuda
def test_sparse_adagrad_gives_one_result_in_ten_calls(cuda):
    """adagrad on a SelectedRows gradient of 16 x 2048 ids (most
    repeated) into an 8192 x 1024 table: the duplicates merge through
    selected_rows.add_rows (index_put_ with accumulate), so 10 calls
    give the same bits; rows no id touched stay as they were."""
    from paddle_tpu_torch.core.registry import get_op_info
    from paddle_tpu_torch.core.selected_rows import SelectedRows

    g = torch.Generator(device=cuda).manual_seed(1)
    ids = torch.randint(0, 8192, (16 * 2048,), device=cuda, generator=g)
    vals = torch.randn(16 * 2048, 1024, device=cuda, generator=g)
    p = torch.randn(8192, 1024, device=cuda, generator=g)
    m = torch.rand(8192, 1024, device=cuda, generator=g)
    lr = torch.full((1,), 0.01, device=cuda)
    lower = get_op_info("adagrad").lower

    def step():
        return lower(None, {"Param": p, "Grad": SelectedRows(ids, vals,
                                                             8192),
                            "Moment": m, "LearningRate": lr},
                     {"epsilon": 1e-6}, None)

    first = step()
    for _ in range(9):
        out = step()
        assert torch.equal(out["ParamOut"], first["ParamOut"])
        assert torch.equal(out["MomentOut"], first["MomentOut"])
    untouched = torch.ones(8192, dtype=torch.bool, device=cuda)
    untouched[ids] = False
    assert untouched.any()
    assert torch.equal(first["ParamOut"][untouched], p[untouched])
    dense = torch.zeros_like(p).index_put_((ids,), vals, accumulate=True)
    m_want = m + dense * dense
    torch.testing.assert_close(first["MomentOut"][~untouched],
                               m_want[~untouched], **TOL)


def _dyn_rnn_program(fluid, vocab=500):
    from paddle_tpu_torch.models import understand_sentiment

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, slots, _ = understand_sentiment.get_model(
            vocab, net="dyn_rnn", emb_dim=16, hid_dim=32)
    return main, startup, loss, slots


@pytest.mark.cuda
def test_dynamic_rnn_step_captured_over_two_buckets_is_run_bit_for_bit(
        cuda):
    """The sentiment DynamicRNN on batches of padded T 16 and 8, stepped
    0 1 0 1: one captured graph a bucket in one memory pool (the
    recurrent op's loop and its replayed gradient inside it); the losses
    and every persistable equal run()'s bit for bit."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    main, startup, loss, slots = _dyn_rnn_program(fluid)
    persist, init = _lstm_start(fluid, main, startup, cuda)
    batches = [_ragged_batch(fluid, main, slots, lens, 20 + i)
               for i, lens in enumerate(([16, 3, 11], [5, 8, 1]))]
    order = (0, 1, 0, 1)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    sa, sb = fluid.Scope(), fluid.Scope()
    set_scope_arrays(sa, init, "cuda")
    set_scope_arrays(sb, init, "cuda")
    la = [exe.run(main, feed=batches[i], fetch_list=[loss], scope=sa)[0]
          for i in order]
    with exe.prepare(main, feed_specs=batches[0], fetch_list=[loss],
                     scope=sb) as prep:
        lb = [prep.run_prepared(batches[i], return_numpy=True)[0]
              for i in order]
        buckets = prep._prep._step.buckets
        pools = {c.graph.pool() for c in prep._prep._step._captures.values()}
    assert sorted(v["replays"] for v in buckets.values()) == [2, 2]
    assert len(pools) == 1
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    pa, pb = get_scope_arrays(sa, persist), get_scope_arrays(sb, persist)
    for n in persist:
        np.testing.assert_array_equal(pa[n], pb[n])


def _host_read_in_a_body(fluid, kind):
    """A DynamicRNN whose body holds a ``kind`` op (while or
    conditional_block), which reads its condition on the host."""
    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        x = L.data(name="x", shape=[3], dtype="float32", lod_level=1)
        rnn = L.DynamicRNN()
        with rnn.block():
            x_t = rnn.step_input(x)
            h = rnn.memory(shape=[3], value=0.0)
            h_new = L.elementwise_add(h, x_t)
            if kind == "while":
                i = L.fill_constant([1], "float32", 0.0)
                n = L.fill_constant([1], "float32", 2.0)
                cond = L.less_than(i, n)
                with L.While(cond=cond).block():
                    L.assign(L.scale(h_new, scale=0.5), h_new)
                    L.increment(i, value=1.0)
                    L.less_than(i, n, cond=cond)
            else:
                cond = L.greater_than(L.reduce_sum(x_t),
                                      L.fill_constant([1], "float32", 0.0))
                with L.ConditionalBlock([cond]).block():
                    L.assign(L.scale(h_new, scale=0.5), h_new)
            rnn.update_memory(h, h_new)
            rnn.output(h_new)
        loss = L.mean(rnn())
    return main, startup, loss


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["while", "conditional_block"])
def test_host_read_control_flow_in_a_body_is_uncapturable(cuda, kind):
    """prepare() on the card raises Uncapturable for a while and for a
    conditional_block nested in a recurrent body (a replay cannot read
    a condition); run() on the card gives the CPU's output."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.executor_impl import Uncapturable
    from paddle_tpu_torch.core.lod import LoDTensor

    main, startup, loss = _host_read_in_a_body(fluid, kind)
    data = np.random.RandomState(0).randn(9, 3).astype(np.float32)
    feed = {"x": LoDTensor(data, [[0, 4, 6, 9]])}
    out = {}
    for dev, place in (("cuda", fluid.CUDAPlace(0)),
                       ("cpu", fluid.CPUPlace())):
        scope = fluid.Scope()
        exe = fluid.Executor(place)
        exe.run(startup, scope=scope)
        if dev == "cuda":
            with pytest.raises(Uncapturable, match=kind):
                exe.prepare(main, feed_specs=feed, fetch_list=[loss],
                            scope=scope)
        out[dev] = exe.run(main, feed=feed, fetch_list=[loss],
                           scope=scope)[0]
    np.testing.assert_allclose(out["cuda"], out["cpu"], **TOL)


@pytest.mark.cuda
def test_tensor_array_on_card_has_no_host_sync_in_a_replay(cuda):
    """A TensorArray written and read at device indices (one write past
    the capacity, clamped) inside a captured step: the replay runs under
    torch.cuda.set_sync_debug_mode("error"), so any host sync in it
    raises; the values and the length equal run()'s."""
    import paddle_tpu_torch.fluid as fluid

    L = fluid.layers
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        v = L.fill_constant([4, 8], "float32", 1.5)
        arr = L.create_array("float32", element_shape=[4, 8], capacity=4)
        idx = [L.fill_constant([1], "int64", k) for k in (0, 2, 7)]
        for k, i in enumerate(idx):
            L.array_write(L.scale(v, scale=float(k + 1)), i, array=arr)
        fetch = [L.array_read(arr, i) for i in idx] + [L.array_length(arr)]
    exe = fluid.Executor(fluid.CUDAPlace(0))
    scope = fluid.Scope()
    want = exe.run(main, fetch_list=fetch, scope=scope)
    prep = exe.prepare(main, feed_specs={}, fetch_list=fetch, scope=scope)
    prep.run_prepared({})           # the capture
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = prep.run_prepared({})
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert all(t.device.type == "cuda" for t in got)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.cpu().numpy(), b)
    assert int(want[3][0]) == 8
    np.testing.assert_array_equal(want[2], np.full((4, 8), 4.5, np.float32))


def _book_program(fluid, model):
    """The book models at small widths: machine_translation (dicts 80,
    emb and hidden 32), the recommender (its fixed widths), SRL (hidden
    16, depth 2, the word table trained)."""
    from paddle_tpu_torch import dataset
    from paddle_tpu_torch.models import (label_semantic_roles,
                                         machine_translation, recommender)

    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        if model == "machine_translation":
            loss, slots, _ = machine_translation.get_model(80, 80, 32, 32)
        elif model == "recommender":
            loss, slots, _ = recommender.get_model()
        else:
            word, verb, label = dataset.conll05.get_dict()
            loss, slots, _ = label_semantic_roles.get_model(
                len(word), len(label), len(verb), hidden_dim=16, depth=2,
                train_word_emb=True)
    return main, startup, loss, slots


def _book_rows(model):
    """Two batches of 8 of the model's adapter samples whose ragged
    slots pad to two buckets: short and long sentences (wmt14, conll05);
    for movielens, whose titles all pad to 8, the second batch's titles
    lengthened to 9-12 words by repeating their own."""
    from paddle_tpu_torch import dataset

    if model == "machine_translation":
        rows = list(dataset.wmt14.train(80)())
        return [[r for r in rows if len(r[0]) <= 8][:8],
                [r for r in rows if len(r[0]) > 8][:8]]
    if model == "recommender":
        rows = list(dataset.movielens.train()())
        long_ = [list(r) for r in rows[8:16]]
        for i, r in enumerate(long_):
            r[6] = (r[6] * 12)[:9 + i % 4]
        return [rows[:8], long_]
    rows = list(dataset.conll05.test()())
    return [[r for r in rows if len(r[0]) <= 8][:8],
            [r for r in rows if len(r[0]) > 8][:8]]


@pytest.mark.cuda
@pytest.mark.parametrize("model", ["machine_translation", "recommender",
                                   "label_semantic_roles"])
def test_book_model_captured_over_two_buckets_is_run_bit_for_bit(cuda,
                                                                 model):
    """Each book model on two batches whose ragged slots pad to two
    buckets, stepped 0 1 0 1: one captured graph a bucket in one memory
    pool (the SRL's CRF loops, the recommender's sparse tables inside
    it); the losses and every persistable equal run()'s bit for bit."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    main, startup, loss, slots = _book_program(fluid, model)
    persist = sorted(n for n, v in main.desc.blocks[0].vars.items()
                     if v.persistable)
    s0 = fluid.Scope()
    fluid.Executor(fluid.CPUPlace()).run(startup, scope=s0)
    init = get_scope_arrays(s0, persist)
    feeder = fluid.DataFeeder(slots, program=main)
    batches = [feeder.feed(rows) for rows in _book_rows(model)]
    order = (0, 1, 0, 1)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    sa, sb = fluid.Scope(), fluid.Scope()
    set_scope_arrays(sa, init, "cuda")
    set_scope_arrays(sb, init, "cuda")
    la = [exe.run(main, feed=batches[i], fetch_list=[loss], scope=sa)[0]
          for i in order]
    with exe.prepare(main, feed_specs=batches[0], fetch_list=[loss],
                     scope=sb) as prep:
        lb = [prep.run_prepared(batches[i], return_numpy=True)[0]
              for i in order]
        buckets = prep._prep._step.buckets
        pools = {c.graph.pool() for c in prep._prep._step._captures.values()}
    assert sorted(v["replays"] for v in buckets.values()) == [2, 2]
    assert len(pools) == 1
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(np.concatenate([np.ravel(a) for a in la])).all()
    pa, pb = get_scope_arrays(sa, persist), get_scope_arrays(sb, persist)
    for n in persist:
        np.testing.assert_array_equal(pa[n], pb[n])


def _select_on(device, fn, *arrays):
    return [o.cpu().numpy() for o in fn(*[torch.as_tensor(a, device=device)
                                          for a in arrays])]


@pytest.mark.cuda
def test_beam_search_and_top_k_ties_on_card_equal_the_cpu(cuda):
    """Tied scores, where torch.topk's order is unspecified and differs
    between the CPU and CUDA: the beam_search op's selections and the
    top_k op's indices on the card equal the CPU's (the lower index
    first, as jax.lax.top_k), at a decode step's width too."""
    import paddle_tpu_torch.ops  # noqa: F401  (registers the ops)
    from paddle_tpu_torch.core.lowering import Ins
    from paddle_tpu_torch.core.registry import get_op_info

    rng = np.random.RandomState(0)
    beam = get_op_info("beam_search").lower
    top_k = get_op_info("top_k").lower
    for nb, k, hi in ((4, 6, 1), (32, 999, 3), (64, 4096, 2)):
        scores = -rng.randint(0, hi + 1, (nb, k)).astype(np.float32)
        ids = np.tile(np.arange(k, dtype=np.int64), (nb, 1))
        pre_ids = rng.randint(0, 5, (nb, 1)).astype(np.int64)
        pre_scores = -rng.randint(0, 2, (nb, 1)).astype(np.float32)

        def select(pi, ps, i, s):
            out = beam(None, Ins({"pre_ids": [pi], "pre_scores": [ps],
                                  "ids": [i], "scores": [s]}),
                       {"beam_size": 4, "end_id": 0})
            return [out["selected_ids"], out["selected_scores"],
                    out["parent_idx"]]

        def topk(s):
            out = top_k(None, Ins({"X": [s]}), {"k": min(k, 64)}, None)
            return [out["Out"], out["Indices"]]

        for fn, args in ((select, (pre_ids, pre_scores, ids, scores)),
                         (topk, (scores,))):
            for a, b in zip(_select_on(cuda, fn, *args),
                            _select_on("cpu", fn, *args)):
                np.testing.assert_array_equal(a, b)


@pytest.mark.cuda
def test_crf_and_ctc_on_card_equal_the_cpu(cuda):
    """linear_chain_crf's loss and gradients and warpctc's (labels CTC
    cannot align included) within 1e-5 of the CPU's; crf_decoding on
    tied and integer scores and ctc_align give the CPU's ids exactly."""
    import paddle_tpu_torch.ops  # noqa: F401  (registers the ops)
    from paddle_tpu_torch.core.lowering import Ins
    from paddle_tpu_torch.core.registry import get_op_info

    rng = np.random.RandomState(1)
    crf = get_op_info("linear_chain_crf").lower
    dec = get_op_info("crf_decoding").lower
    ctc = get_op_info("warpctc").lower
    align = get_op_info("ctc_align").lower
    em = rng.randn(8, 24, 13).astype(np.float32)
    tr = rng.randn(15, 13).astype(np.float32)
    lab = rng.randint(0, 13, (8, 24, 1)).astype(np.int64)
    logits = rng.randn(8, 40, 32).astype(np.float32)
    clab = rng.randint(1, 32, (8, 30)).astype(np.int64)
    best = np.argmax(np.round(logits), -1)
    out = {}
    for dev in (cuda, "cpu"):
        t = {k: torch.tensor(v, device=dev, requires_grad=v.dtype ==
                             np.float32)
             for k, v in (("em", em), ("tr", tr), ("lg", logits))}
        ll = crf(None, Ins({"Emission": [t["em"]], "Transition": [t["tr"]],
                            "Label": [torch.as_tensor(lab, device=dev)]}),
                 {})["LogLikelihood"]
        loss = ctc(None, Ins({"Logits": [t["lg"]],
                              "Label": [torch.as_tensor(clab, device=dev)]}),
                   {"blank": 0})["Loss"]
        grads = torch.autograd.grad(ll.sum() + loss[:, 0].clamp_max(1e6)
                                    .sum(), [t["em"], t["tr"], t["lg"]])
        ties = torch.as_tensor(np.round(em), device=dev)
        paths = [dec(None, Ins({"Emission": [e], "Transition": [
            torch.as_tensor(np.round(tr), device=dev)]}), {})["ViterbiPath"]
            for e in (t["em"].detach(), ties, torch.zeros_like(ties))]
        greedy = align(None, Ins({"Input": [torch.as_tensor(
            best, device=dev)]}), {"blank": 0})
        out[str(dev)] = [x.detach().cpu().numpy() for x in
                         [ll, loss] + list(grads) + paths +
                         [greedy["Output"]]]
    got, want = out[str(cuda)], out["cpu"]
    for a, b in zip(got[:5], want[:5]):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)
    for a, b in zip(got[5:], want[5:]):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# slice 27: the conv family, the detection / misc / metric ops, SSD
# --------------------------------------------------------------------------

def _chip_smoke():
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _op_on(device, op_type, arrays, attrs, wrt=()):
    """One op's lowering on ``device`` over numpy ``arrays``: its outputs
    and the gradients of the sum of its first float output weighted by a
    seeded cotangent w.r.t. ``wrt``, all as numpy."""
    import paddle_tpu_torch.ops  # noqa: F401  (registers the ops)
    from paddle_tpu_torch.core.desc import ProgramDesc
    from paddle_tpu_torch.core.lowering import Ins, LoweringContext
    from paddle_tpu_torch.core.registry import get_op_info

    ctx = LoweringContext(ProgramDesc(), 0, {}, torch.device(device))
    ins = {k: torch.as_tensor(v, device=device).requires_grad_(k in wrt)
           for k, v in arrays.items()}
    with torch.enable_grad():
        outs = get_op_info(op_type).lower(
            ctx, Ins({k: [v] for k, v in ins.items()}), dict(attrs), None)
        res = {k: v.detach().cpu().numpy() for k, v in outs.items()}
        if wrt:
            first = next(v for v in outs.values() if v.is_floating_point())
            cot = torch.as_tensor(np.random.RandomState(1).randn(
                *first.shape).astype(np.float32), device=device)
            grads = torch.autograd.grad(first, [ins[k] for k in wrt], cot)
            res.update({k + "@GRAD": g.cpu().numpy()
                        for k, g in zip(wrt, grads)})
    return res


def _assert_on_card_as_cpu(cuda, op_type, arrays, attrs, wrt=(), tol=1e-5):
    got = _op_on(cuda, op_type, arrays, attrs, wrt)
    want = _op_on("cpu", op_type, arrays, attrs, wrt)
    assert got.keys() == want.keys()
    for k, a in want.items():
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(got[k], a, err_msg=k)
        else:
            s = max(float(np.abs(a).max()), 1.0)
            np.testing.assert_allclose(got[k] / s, a / s, rtol=tol,
                                       atol=tol, err_msg=k)


@pytest.mark.cuda
def test_detection_misc_and_metric_ops_on_card_equal_the_cpu(cuda):
    """Every device op of ops/detection.py, ops/misc.py and the two
    metric ops on the card against the CPU at SSD-like shapes: integer
    outputs (matches, mined negatives, Mask, Argmax, the AUC counts)
    exact, floats within 1e-5 (of the tensor's largest |value| when
    above 1), gradients where the op has them."""
    rng = np.random.RandomState(0)

    def boxes(*lead):
        c = np.sort(rng.uniform(0, 1, lead + (2, 2)), axis=-2)
        return np.swapaxes(c, -1, -2).reshape(lead + (4,)).astype(
            np.float32)

    prior, gt = boxes(600), boxes(16, 8)
    pvar = np.full((600, 4), 0.1, np.float32)
    dist = rng.uniform(0, 1, (16, 8, 600)).astype(np.float32)
    match = rng.randint(-1, 8, (16, 600)).astype(np.int32)
    cases = [
        ("prior_box", {"Input": np.zeros((2, 8, 19, 19), np.float32),
                       "Image": np.zeros((2, 3, 300, 300), np.float32)},
         {"min_sizes": [60.0], "max_sizes": [111.0],
          "aspect_ratios": [2.0, 3.0], "flip": True, "clip": False},
         ()),
        ("iou_similarity", {"X": gt, "Y": prior}, {}, ()),
        ("box_coder", {"PriorBox": prior, "PriorBoxVar": pvar,
                       "TargetBox": gt}, {"code_type": "encode_center_size"},
         ()),
        ("box_coder", {"PriorBox": prior, "PriorBoxVar": pvar,
                       "TargetBox": rng.randn(16, 600, 4).astype(
                           np.float32)},
         {"code_type": "decode_center_size"}, ()),
        ("bipartite_match", {"DistMat": np.round(dist, 1)},
         {"match_type": "per_prediction", "dist_threshold": 0.5}, ()),
        ("target_assign", {"X": rng.randn(16, 8, 1).astype(np.float32),
                           "MatchIndices": match,
                           "NegIndices": (match < 0).astype(np.int32)},
         {"mismatch_value": 0}, ()),
        ("gather_encoded_target", {"Encoded": rng.randn(
            16, 8, 600, 4).astype(np.float32), "MatchIndices": match}, {},
         ()),
        ("conv_shift", {"X": rng.randn(64, 128).astype(np.float32),
                        "Y": rng.randn(64, 3).astype(np.float32)}, {},
         ("X", "Y")),
        ("fake_dequantize_max_abs", {
            "X": rng.randint(-127, 128, (64, 256)).astype(np.float32),
            "Scale": np.asarray([0.37], np.float32)},
         {"max_range": 127.0}, ()),
        ("polygon_box_transform", {"Input": rng.randn(4, 8, 32, 32).astype(
            np.float32)}, {}, ()),
        ("max_pool2d_with_index", {"X": rng.randint(
            0, 4, (4, 16, 32, 32)).astype(np.float32)},
         {"ksize": [3, 3], "strides": [2, 2], "paddings": [1, 1]}, ("X",)),
        ("roi_pool", {"X": rng.randint(0, 5, (2, 16, 19, 25)).astype(
            np.float32), "ROIs": np.asarray(
                [[0, 10, 20, 200, 150], [1, 0, 0, 390, 300],
                 [1, 100, 40, 110, 50], [0, 50, 60, 250, 280]],
                np.float32)},
         {"pooled_height": 7, "pooled_width": 7, "spatial_scale": 0.0625},
         ("X",)),
        ("scale_sub_region", {"X": rng.randn(4, 3, 8, 8).astype(np.float32),
                              "Indices": np.asarray(
                                  [[1, 2, 1, 8, 2, 5]] * 4, np.int32)},
         {"value": 2.0}, ("X",)),
        ("auc", {"Predict": rng.uniform(0, 1, (4096, 2)).astype(np.float32),
                 "Label": rng.randint(0, 2, (4096, 1)).astype(np.int64),
                 "TP": np.zeros(200, np.int64), "FP": np.zeros(200, np.int64),
                 "TN": np.zeros(200, np.int64), "FN": np.zeros(200, np.int64)},
         {"num_thresholds": 200}, ()),
        ("precision_recall", {
            "MaxProbs": rng.uniform(0, 1, (4096, 1)).astype(np.float32),
            "Indices": rng.randint(0, 21, (4096, 1)).astype(np.int64),
            "Labels": rng.randint(0, 21, (4096, 1)).astype(np.int64),
            "Weights": rng.uniform(0, 2, (4096, 1)).astype(np.float32)},
         {"class_number": 21}, ()),
    ]
    for op_type, arrays, attrs, wrt in cases:
        _assert_on_card_as_cpu(cuda, op_type, arrays, attrs, wrt)


@pytest.mark.cuda
def test_conv_family_on_card_equals_the_cpu(cuda):
    """chip_smoke.py's CONV_FAMILY ops at small shapes through
    ``family_call`` (the convs' explicit gradients): forward and
    gradients on the card within atol = rtol = 1e-4 of the CPU's, each
    tensor scaled by its largest |CPU value|; Mask and Argmax exact."""
    cs = _chip_smoke()
    small = {"conv2d_transpose": {"Input": (4, 16, 14, 14),
                                  "Filter": (16, 8, 4, 4)},
             "conv3d": {"Input": (2, 8, 6, 14, 14),
                        "Filter": (16, 8, 3, 3, 3)},
             "depthwise_conv2d": {"Input": (4, 32, 19, 19),
                                  "Filter": (32, 1, 3, 3)},
             "row_conv": {"X": (4, 50, 64), "Filter": (21, 64)},
             "spp": {"X": (4, 16, 13, 13)},
             "roi_pool": {"X": (2, 16, 38, 50), "ROIs": "rois"},
             "max_pool2d_with_index": {"X": (2, 8, 56, 56)},
             "unpool": {"X": (2, 8, 28, 28), "Indices": "mask"},
             "conv_shift": {"X": (16, 128), "Y": (16, 3)}}
    for op, _, attrs in cs.CONV_FAMILY:
        attrs = dict(attrs, groups=32) if op == "depthwise_conv2d" \
            else attrs
        arrays = cs.family_arrays(np, op, small[op], attrs, seed=2)
        got = cs.family_call(torch, op, arrays, attrs, cuda)()
        want = cs.family_call(torch, op, arrays, attrs, "cpu")()
        for a, b in zip(got, want):
            a = a.cpu()
            if not b.is_floating_point():
                assert torch.equal(a, b), op
                continue
            s = max(float(b.abs().max()), 1e-30)
            torch.testing.assert_close(a / s, b / s, **TOL, msg=op)


@pytest.mark.cuda
def test_mine_hard_examples_on_tied_losses_on_card(cuda):
    """Tied negative losses (an untrained head's), at an SSD step's
    width: the card mines the CPU's negatives (a stable ranking), and
    the same ones at every call."""
    rng = np.random.RandomState(3)
    cls = np.round(rng.uniform(0, 3, (32, 2278)), 0).astype(np.float32)
    match = np.where(rng.rand(32, 2278) < 0.02, 0, -1).astype(np.int32)
    arrays = {"ClsLoss": cls[..., None], "MatchIndices": match}
    attrs = {"neg_pos_ratio": 3.0, "mining_type": "max_negative"}
    want = _op_on("cpu", "mine_hard_examples", arrays, attrs)
    for _ in range(3):
        got = _op_on(cuda, "mine_hard_examples", arrays, attrs)
        np.testing.assert_array_equal(got["NegIndices"],
                                      want["NegIndices"])
    assert want["NegIndices"].sum() > 0


@pytest.mark.cuda
def test_unpool_with_overlapping_windows_on_card(cuda):
    """3 x 3 windows at stride 1 over maps with a few large values: one
    position recorded many times.  Forward and gradient on the card are
    the CPU's bit for bit at every call (the winner among duplicates by
    an amax of ids, never arrival order), and the gradient reaches one
    duplicate of each position."""
    rng = np.random.RandomState(4)
    x = rng.rand(8, 16, 40, 40).astype(np.float32)
    x[:, :, 10::7, 10::7] += 5.0
    attrs = {"ksize": [3, 3], "strides": [1, 1], "paddings": [0, 0]}
    pooled = _op_on("cpu", "max_pool2d_with_index", {"X": x}, attrs)
    arrays = {"X": pooled["Out"], "Indices": pooled["Mask"]}
    want = _op_on("cpu", "unpool", arrays, attrs, ("X",))
    for _ in range(3):
        got = _op_on(cuda, "unpool", arrays, attrs, ("X",))
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    mask = pooled["Mask"].reshape(8 * 16, -1)
    assert np.count_nonzero(want["X@GRAD"]) == sum(
        len(np.unique(r)) for r in mask)


@pytest.mark.cuda
def test_precision_recall_is_bit_identical_across_runs_on_card(cuda):
    """100,000 rows over 21 classes (every class summed ~5,000 times):
    the card's states and metrics are one result in ten calls (a fixed
    summation order, not index_add_'s atomics), within the f32 bar
    (1e-4) of the CPU's serial order."""
    rng = np.random.RandomState(5)
    n = 100_000
    arrays = {"MaxProbs": rng.uniform(0, 1, (n, 1)).astype(np.float32),
              "Indices": rng.randint(0, 21, (n, 1)).astype(np.int64),
              "Labels": rng.randint(0, 21, (n, 1)).astype(np.int64),
              "Weights": rng.uniform(0, 1, (n, 1)).astype(np.float32)}
    attrs = {"class_number": 21}
    first = _op_on(cuda, "precision_recall", arrays, attrs)
    for _ in range(9):
        again = _op_on(cuda, "precision_recall", arrays, attrs)
        for k in first:
            np.testing.assert_array_equal(again[k], first[k], err_msg=k)
    want = _op_on("cpu", "precision_recall", arrays, attrs)
    for k in want:
        np.testing.assert_allclose(first[k], want[k], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_ssd_step_captured_over_two_buckets_is_run_bit_for_bit(
        cuda, monkeypatch):
    """MobileNet-SSD (width 0.25, 64 x 64 images, batch 4) on two
    batches whose ragged gt pad to buckets 8 and 16, stepped 0 1 0 1 on
    cuDNN's deterministic algorithms (FLAGS_cudnn_deterministic): one
    captured graph a bucket in one pool, each prior_box a device
    constant of the capture, the bipartite match's loop with no host
    read; the losses and every persistable equal run()'s bit for bit."""
    import paddle_tpu_torch.fluid as fluid
    from paddle_tpu_torch.core.flags import FLAGS
    from paddle_tpu_torch.core.lod import LoDTensor
    from paddle_tpu_torch.fluid.io import get_scope_arrays, set_scope_arrays

    monkeypatch.setattr(FLAGS, "cudnn_deterministic", True)

    cs = _chip_smoke()
    main, startup = fluid.Program(), fluid.Program()
    with fluid.program_guard(main, startup), fluid.unique_name.guard():
        loss, _, _ = cs.build_mobilenet_ssd(fluid, image=64, scale=0.25)
    persist, init = cs.start_arrays(fluid, main, startup, fluid.CPUPlace())
    batches = [cs.ssd_feed(LoDTensor, *cs.ssd_batch(4, image=64, max_gt=g,
                                                    seed=10 + g))
               for g in (8, 16)]
    order = (0, 1, 0, 1)
    exe = fluid.Executor(fluid.CUDAPlace(0))
    sa, sb = fluid.Scope(), fluid.Scope()
    set_scope_arrays(sa, init, "cuda")
    set_scope_arrays(sb, init, "cuda")
    la = [exe.run(main, feed=batches[i], fetch_list=[loss], scope=sa)[0]
          for i in order]
    with exe.prepare(main, feed_specs=batches[0], fetch_list=[loss],
                     scope=sb) as prep:
        lb = [prep.run_prepared(batches[i], return_numpy=True)[0]
              for i in order]
        step = prep._prep._step
        buckets = step.buckets
        pools = {c.graph.pool() for c in step._captures.values()}
        consts = step._constants
    assert sorted(v["replays"] for v in buckets.values()) == [2, 2]
    assert len(pools) == 1
    assert len(consts) == 6 and all(
        t.is_cuda for c in consts.values() for t in c.values())
    for a, b in zip(la, lb):
        np.testing.assert_array_equal(a, b)
    assert np.isfinite(np.concatenate([np.ravel(a) for a in la])).all()
    pa, pb = get_scope_arrays(sa, persist), get_scope_arrays(sb, persist)
    for n in persist:
        np.testing.assert_array_equal(pa[n], pb[n], err_msg=n)


@pytest.mark.cuda
def test_conv_grads_repeat_bit_for_bit_under_the_deterministic_flag(
        cuda, monkeypatch):
    """A dense 1 x 1 and a 3 x 3 stride-2 conv's gradients (cuDNN's
    default weight-gradient algorithms add with atomics) are one result
    in five calls under FLAGS_cudnn_deterministic, through conv2d_grad
    and conv3d's and conv2d_transpose's explicit gradients."""
    from paddle_tpu_torch.core.flags import FLAGS

    monkeypatch.setattr(FLAGS, "cudnn_deterministic", True)
    cs = _chip_smoke()
    cases = [("conv2d_transpose", {"Input": (8, 64, 28, 28),
                                   "Filter": (64, 32, 4, 4)},
              {"strides": [2, 2], "paddings": [1, 1],
               "dilations": [1, 1]}),
             ("conv3d", {"Input": (2, 16, 8, 28, 28),
                         "Filter": (32, 16, 3, 3, 3)},
              {"strides": [1, 1, 1], "paddings": [1, 1, 1],
               "dilations": [1, 1, 1], "groups": 1})]
    for op, slots, attrs in cases:
        arrays = cs.family_arrays(np, op, slots, attrs, seed=3)
        call = cs.family_call(torch, op, arrays, attrs, cuda)
        first = call()
        for _ in range(4):
            for a, b in zip(call(), first):
                assert torch.equal(a, b), op
    import paddle_tpu_torch.ops  # noqa: F401  (registers the ops)
    from paddle_tpu_torch.core.desc import OpDesc, ProgramDesc
    from paddle_tpu_torch.core.lowering import Ins, LoweringContext
    from paddle_tpu_torch.core.registry import get_op_info

    ctx = LoweringContext(ProgramDesc(), 0, {}, torch.device(cuda))
    g = torch.Generator(device=cuda).manual_seed(0)
    for xs, ws, st, pd in (((32, 32, 150, 150), (64, 32, 1, 1), 1, 0),
                           ((32, 256, 10, 10), (512, 256, 3, 3), 2, 1)):
        x = torch.randn(xs, device=cuda, generator=g)
        w = torch.randn(ws, device=cuda, generator=g)
        ho = (xs[2] + 2 * pd - ws[2]) // st + 1
        dy = torch.randn((xs[0], ws[0], ho, ho), device=cuda, generator=g)
        attrs = {"strides": [st, st], "paddings": [pd, pd]}
        gop = OpDesc("conv2d_grad", inputs={"Input": ["x"], "Filter": ["w"],
                                            "Output@GRAD": ["dy"]},
                     outputs={"Input@GRAD": ["dx"], "Filter@GRAD": ["dw"]},
                     attrs=attrs)
        outs = [get_op_info("conv2d_grad").lower(ctx, Ins({
            "Input": [x], "Filter": [w], "Output@GRAD": [dy]}), attrs, gop)
            for _ in range(5)]
        for o in outs[1:]:
            for k in ("Input@GRAD", "Filter@GRAD"):
                assert torch.equal(o[k], outs[0][k]), k
