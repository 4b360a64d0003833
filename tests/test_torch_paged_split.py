"""K7's order of work, emulated in plain PyTorch, against the JAX
package's paged attention.

The CUDA kernel (``paddle_tpu_torch/kernels/csrc/paged_attention.cu``)
cuts each row's live pages into spans of P pages, keeps an online
softmax (m, l, acc) per span and folds the spans in order 0 .. n - 1.
``split_emulation`` does the same in torch: a row's result depends only
on its own length and pages, never on the batch or the table width, and
table slots past a row's context are never dereferenced (the emulation
refuses a negative page id it is asked to read).  On the CPU these hold
it against ``paddle_tpu.kernels.flash_attention.paged_attention``
through its XLA branch and its Pallas kernel in interpret mode at
atol 1e-5; the kernel itself is held to the plain version on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import importlib

import numpy as np
import pytest
import torch

from paddle_tpu_torch.kernels import paged_attention
from paddle_tpu_torch.kernels.flash_attention import (
    NEG_INF, paged_attention_reference)

ATOL = 1e-5
jfa = importlib.import_module("paddle_tpu.kernels.flash_attention")
H, D, BS, NB = 2, 16, 8, 32        # H, D, bs as tests/test_torch_kernels.py
# pages a span: a full row of NB pages has two; the card tests hold the
# kernel at its own span length (paged_span_pages())
SPAN = 16


def split_emulation(q, kp, vp, tables, lens, scale, span_pages):
    """Paged decode in the kernel's order: per row, spans of
    ``span_pages`` live pages, each span's (m, l, acc) over its live
    positions, then the spans folded in span order in one online pass (a
    row with one span is its acc / l)."""
    b, h, d = q.shape
    bs, nb = kp.shape[1], tables.shape[1]
    out = torch.empty_like(q)
    for i in range(b):
        ctx = int(lens[i])
        pages = min(nb, -(-ctx // bs))
        qs = q[i] * scale
        states = []
        for p0 in range(0, pages, span_pages):
            ids = tables[i, p0:min(pages, p0 + span_pages)].long()
            if int(ids.min()) < 0:
                raise IndexError("read a negative page id %d" % ids.min())
            k = kp[ids].reshape(-1, h, d)
            v = vp[ids].reshape(-1, h, d)
            live = p0 * bs + torch.arange(k.shape[0]) < ctx
            s = torch.einsum("hd,shd->hs", qs, k).masked_fill(~live, NEG_INF)
            m = s.max(dim=1).values
            p = torch.exp(s - m[:, None]) * live
            states.append((m, p.sum(1), torch.einsum("hs,shd->hd", p, v)))
        if len(states) == 1:
            m, l, acc = states[0]
            out[i] = acc / l[:, None]
            continue
        mt, lt, o = torch.full((h,), NEG_INF), torch.zeros(h), \
            torch.zeros(h, d)
        for m, l, acc in states:         # the kernel's one online pass
            mn = torch.maximum(mt, m)
            c0, c1 = torch.exp(mt - mn), torch.exp(m - mn)
            lt = lt * c0 + l * c1
            o = o * c0[:, None] + acc * c1[:, None]
            mt = mn
        out[i] = o / lt[:, None]
    return out


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _case(seed, lens, nb=NB, n_pages=None):
    """q, pages and tables for ``lens``: each row's live pages distinct
    ids from a pool of ``n_pages`` (page 0 unused), slots past the live
    pages 0, as the engine pads them."""
    rng = np.random.RandomState(seed)
    b = len(lens)
    n = n_pages or b * nb + 1
    q = rng.randn(b, H, D).astype(np.float32)
    kp = rng.randn(n, BS, H, D).astype(np.float32)
    vp = rng.randn(n, BS, H, D).astype(np.float32)
    ids = rng.permutation(np.arange(1, n))[:b * nb].reshape(b, nb)
    tables = np.zeros((b, nb), np.int32)
    for i, c in enumerate(lens):
        live = min(nb, -(-c // BS))
        tables[i, :live] = ids[i, :live]
    return q, kp, vp, tables, np.asarray(lens, np.int32)


def _boundary_lens(p):
    """1, P bs, P bs + 1 and NB bs, and a padding row (length 1, its
    table all page 0)."""
    return [1, p * BS, p * BS + 1, NB * BS, 1]


@pytest.mark.parametrize("p", [1, 2, SPAN])
@pytest.mark.parametrize("mode", ["force_xla", "interpret"])
def test_split_emulation_matches_jax(mode, p):
    lens = _boundary_lens(p)
    q, kp, vp, tables, lens = _case(0, lens)
    tables[-1] = 0
    ref = np.asarray(jfa.paged_attention(q, kp, vp, tables, lens,
                                         **{mode: True}))
    got = split_emulation(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                          D ** -0.5, p)
    np.testing.assert_allclose(got.numpy(), ref, atol=ATOL)


@pytest.mark.parametrize("p", [1, 3, SPAN, 32])
def test_split_emulation_matches_plain_version(p):
    """Any span length computes the plain version's function, at ragged
    lengths with a span cut mid-row and a last page partly live."""
    lens = [1, 7, 8, 9, 63, 64, 65, 100, 127, 128]
    q, kp, vp, tables, lens = (_t(a) for a in _case(1, lens))
    want = paged_attention_reference(q, kp, vp, tables, lens, D ** -0.5)
    got = split_emulation(q, kp, vp, tables, lens, D ** -0.5, p)
    torch.testing.assert_close(got, want, atol=ATOL, rtol=0)


@pytest.mark.parametrize("row", [0, 2, 3])
def test_split_rows_are_batch_invariant(row):
    """A row computed alone, in its own block-count bucket, is bit for
    bit the same row inside a wider batch with a larger NB bucket."""
    lens = [SPAN * BS + 1, 5, NB * BS, 3 * BS]
    q, kp, vp, tables, lens = _case(2, lens)
    wide = split_emulation(_t(q), _t(kp), _t(vp), _t(tables), _t(lens),
                           D ** -0.5, SPAN)
    pages = -(-int(lens[row]) // BS)
    nb_own = 1 << (pages - 1).bit_length()        # its pow2 bucket
    alone = split_emulation(
        _t(q[row:row + 1]), _t(kp), _t(vp),
        _t(tables[row:row + 1, :nb_own]), _t(lens[row:row + 1]),
        D ** -0.5, SPAN)
    assert torch.equal(alone[0], wide[row])


def test_split_never_reads_slots_past_the_context():
    """Table slots past each row's live pages may hold -1: the
    emulation, which raises on a negative id it reads, gives the result
    of the same tables with those slots on real pages."""
    lens = [1, SPAN * BS, SPAN * BS + 1, 70]
    q, kp, vp, tables, lens = _case(3, lens)
    holes = tables.copy()
    for i, c in enumerate(lens):
        holes[i, -(-c // BS):] = -1
    args = (_t(q), _t(kp), _t(vp))
    got = split_emulation(*args, _t(holes), _t(lens), D ** -0.5,
                          SPAN)
    want = split_emulation(*args, _t(tables), _t(lens), D ** -0.5,
                           SPAN)
    assert torch.equal(got, want)
    torch.testing.assert_close(
        got, paged_attention_reference(*args, _t(tables), _t(lens),
                                       D ** -0.5), atol=ATOL, rtol=0)
    holes[1, 0] = -1                 # a live slot: the guard is armed
    with pytest.raises(IndexError, match="negative page id"):
        split_emulation(*args, _t(holes), _t(lens), D ** -0.5,
                        SPAN)


def test_wrapper_on_cpu_runs_the_plain_version_with_distinct_pages():
    """The CPU route is the plain version, at the boundary lengths of
    the product's span and with every page distinct."""
    q, kp, vp, tables, lens = (
        _t(a) for a in _case(4, _boundary_lens(SPAN)))
    got = paged_attention(q, kp, vp, tables, lens)
    assert torch.equal(got, paged_attention_reference(
        q, kp, vp, tables, lens, D ** -0.5))


def test_profile_serve_counts_overlapping_device_time_once():
    """K7's combine is scheduled while its span kernel runs, so their
    profiled spans overlap: profile_serve's device time is the union of
    the intervals, not their sum."""
    from paddle_tpu_torch.tools.profile_serve import _union_ms

    assert _union_ms([]) == 0.0
    assert _union_ms([(20.0, 25.0), (0.0, 10.0), (5.0, 12.0),
                      (21.0, 22.0)]) == pytest.approx(0.017)


def test_paged_forms_reads_the_serve_phases_decode_calls(tmp_path):
    """paged_forms --calls weights each logged decode step once, with
    the batch bucket's padding rows at one position."""
    from paddle_tpu_torch.tools.paged_forms import serve_calls

    log = tmp_path / "smoke.txt"
    log.write_text(
        "NVIDIA H100 80GB HBM3, 700.00 W\n"
        '{"phase": "kernels", "rows": []}\n'
        '{"phase": "serve_f32", "paged_calls": [[4, 8, 17, 31, 71], '
        '[4, 8, 18, 32, 72]]}\n'
        '{"phase": "serve_int8", "paged_calls": [[4, 8, 17, 31, 71]]}\n')
    assert serve_calls(str(log)) == {(4, 8, 17, 31, 71, 1): 2,
                                     (4, 8, 18, 32, 72, 1): 1}
