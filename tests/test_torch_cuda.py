"""paddle_tpu_torch's CUDA kernels against their plain PyTorch versions
on the card.  Every test is marked ``cuda`` and skips without a card
(the kernels have no CPU mode).  The file imports neither jax nor
paddle_tpu, so it also runs where only the port is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest

Tolerance atol = rtol = 1e-4: both sides accumulate in float32, in a
different order.
"""
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
    """conv_stage_tile's BM is the M tile the kernel writes partials for:
    it fills ceil(M / BM) rows and not one more, and their sums are the
    output's."""
    from paddle_tpu_torch.kernels import conv_fused as pcf

    n, h, ci, co, k, s, p = shape
    x, w, _, _, _ = _conv_operands(cuda, shape)
    ho = (h + 2 * p - k) // s + 1
    m = n * ho * ho
    bm, bn = pcf.conv_stage_tile(m, co)
    assert (bm, bn) == (128, 64)
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
    of the same steps on the CPU.  (An sp > 1 ring under
    ParallelExecutor needs as many cards; the one-card ring is driven
    through ExecutorCore above.)"""
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
    reset_launches()
    for rtol in (1e-5, 1e-4):    # the first step, then one after Adam's
        toks = rng.randint(0, 64, (2, 129))
        halves = [{"src": toks[i:i + 1, :-1],
                   "label": toks[i:i + 1, 1:, None]} for i in range(2)]
        got, = pe.run([loss.name], feed=halves)
        want, = cpu_pe.run([loss.name], feed=halves)
        np.testing.assert_allclose(got, want, rtol=rtol)
    assert KERNELS["flash_fwd"].launches == 2
    assert KERNELS["flash_chunk"].launches == 0
