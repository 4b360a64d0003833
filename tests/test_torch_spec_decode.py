"""paddle_tpu_torch's speculative decoding against the JAX package's.

A target LM and a 1-layer draft of the same vocab and paging geometry
(the reference's ``_spec_pair``) at tests/test_torch_serving.py's small
config.  The draft's fused proposal and the target's verify (tokens and
f32 logits, atol = rtol = 1e-4) against the JAX engine's on the same
sequences; served streams identical to the port's plain decode and to
the JAX spec tenant's; the reference's accept-rate accounting, spec_k=0
as plain decode, staggered admissions through both ladders, and the
plain-decode fallback near max_seq (tests/test_generative_serving.py).
"""
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving import GenerativeEngine as JaxEngine
from paddle_tpu.serving import InferenceServer as JaxServer
from paddle_tpu.serving.generative import GenRequest as JaxRequest
from paddle_tpu_torch.core.flags import FLAGS
from paddle_tpu_torch.serving import (GenerativeEngine, GenRequest,
                                      InferenceServer, tiny_lm)

CFG_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              block_size=8, max_blocks=8, max_batch=4)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _spec_pair(seed=13):
    cfg, params = tiny_lm(seed, **CFG_KW)
    dcfg, dparams = tiny_lm(seed + 1, **dict(CFG_KW, n_layers=1))
    return cfg, params, dcfg, dparams


def _prompts(seed, n, lo=3, hi=15):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _serve(server, kw, cfg, params, prompts, max_new, stagger=0.0, **load):
    """Tokens of every prompt through one tenant, and its engine's
    counters as they stood after the run."""
    with server(**kw) as srv:
        eng = srv.load_generative("g", cfg, params, kv_blocks=64,
                                  warm=False, **load)
        futs = []
        for p in prompts:
            futs.append(srv.generate("g", p, max_new_tokens=max_new))
            time.sleep(stagger)
        res = [f.result(300) for f in futs]
        stats = {k: getattr(eng, k, None) for k in (
            "spec_rounds", "spec_proposed", "spec_accepted", "decode_rows",
            "decode_steps", "prefills", "spec_draft_s", "spec_verify_s")}
        if getattr(eng, "draft", None) is not None and server is \
                InferenceServer:
            stats["verify_keys"] = eng._verify.warm_keys
            stats["propose_keys"] = eng.draft._propose.warm_keys
    return [r["tokens"] for r in res], stats


def _plain(cfg, params, prompts, max_new):
    return _serve(InferenceServer, {"device": "cpu"}, cfg, params, prompts,
                  max_new)[0]


def test_propose_and_verify_match_jax():
    """The draft's fused k-step proposal and the target's verify of it
    over the same sequences: proposals and verified tokens identical,
    verify logits within 1e-4 of the JAX engine's."""
    k = 3
    cfg, params, dcfg, dparams = _spec_pair()
    prompts = _prompts(31, 3, lo=5, hi=20)
    engines = (
        GenerativeEngine(cfg, params, kv_blocks=64, device="cpu", warm=False,
                         spec_k=k, draft=(dcfg, dparams)),
        JaxEngine(cfg.todict(), params, kv_blocks=64, warm=False, spec_k=k,
                  draft=(dcfg.todict(), dparams)))
    out = []
    try:
        for eng, req_cls in zip(engines, (GenRequest, JaxRequest)):
            seqs = []
            for p in prompts:
                r = req_cls(p, 20, None, None)
                r.blocks = eng.pool.alloc(eng.pool.blocks_for(len(p) + k + 1))
                r.out.append(int(eng.prefill(r)))
                eng.draft.prefill_tokens(p, r.blocks)
                r.draft_len = len(p)
                seqs.append(r)
            props = eng.draft.propose_step(
                [s.blocks for s in seqs], [s.draft_len for s in seqs],
                [s.out[-1] for s in seqs], k)
            nxt, logits = eng.verify_step(seqs, props, with_logits=True)
            out.append((np.asarray(props), np.asarray(nxt),
                        np.asarray(logits)))
            for s in seqs:
                eng.free_sequence(s)
    finally:
        for eng in engines:
            eng.close()
    (pp, pn, pl), (jp, jn, jl) = out
    assert pp.shape == (3, k) and pn.shape == (3, k + 1)
    np.testing.assert_array_equal(pp, jp)
    np.testing.assert_array_equal(pn, jn)
    np.testing.assert_allclose(pl, jl, **TOL)


def test_spec_decode_streams_match_plain_and_jax():
    """Served through the decode loop, the speculative stream equals the
    port's plain greedy decode and the JAX spec tenant's, bit for bit."""
    cfg, params, dcfg, dparams = _spec_pair()
    prompts = _prompts(21, 4, lo=4, hi=12)
    plain = _plain(cfg, params, prompts, 14)
    spec, stats = _serve(InferenceServer, {"device": "cpu"}, cfg, params,
                         prompts, 14, spec_k=3, draft=(dcfg, dparams))
    ref, _ = _serve(JaxServer, {}, cfg.todict(), params, prompts, 14,
                    spec_k=3, draft=(dcfg.todict(), dparams))
    assert stats["spec_rounds"] > 0
    assert spec == plain == ref


def test_spec_accept_rate_accounting():
    """Per (round, sequence) the engine proposes k, accepts m <= k and
    emits m + 1: proposed == k x rows, accepted within proposed, and
    the tokens delivered between the emission sum less the last
    round's trim (k a request) and the sum."""
    k = 3
    cfg, params, dcfg, dparams = _spec_pair()
    prompts = _prompts(21, 3, lo=4, hi=10)
    toks, st = _serve(InferenceServer, {"device": "cpu"}, cfg, params,
                      prompts, 12, spec_k=k, draft=(dcfg, dparams))
    assert st["spec_rounds"] > 0
    assert st["spec_proposed"] == k * st["decode_rows"]
    assert 0 <= st["spec_accepted"] <= st["spec_proposed"]
    delivered = sum(len(t) for t in toks)
    emitted = st["prefills"] + st["spec_accepted"] + st["decode_rows"]
    assert delivered <= emitted <= delivered + k * len(prompts)
    assert st["spec_verify_s"] > 0 and st["spec_draft_s"] > 0


def test_spec_k0_equals_plain():
    """spec_k=0 is plain decode: the same tokens, no draft, no round;
    the flag supplies the default."""
    cfg, params, dcfg, dparams = _spec_pair()
    prompts = _prompts(23, 2, lo=4, hi=9)
    base = _plain(cfg, params, prompts, 10)
    k0, st = _serve(InferenceServer, {"device": "cpu"}, cfg, params,
                    prompts, 10, spec_k=0, draft=(dcfg, dparams))
    assert k0 == base and st["spec_rounds"] == 0
    prev = FLAGS.serve_spec_k
    FLAGS.serve_spec_k = 2
    try:
        eng = GenerativeEngine(cfg, params, kv_blocks=16, device="cpu",
                               warm=False, draft=(dcfg, dparams))
        assert eng.spec_k == 2 and eng.draft is not None
        eng.close()
    finally:
        FLAGS.serve_spec_k = prev


def test_spec_draft_target_bucket_ladder_coexistence():
    """Staggered admissions (landing mid-round) through the spec tenant
    stay identical to plain solo decode, with the target's verify and
    the draft's propose ladders both used."""
    cfg, params, dcfg, dparams = _spec_pair()
    prompts = _prompts(29, 3, lo=4, hi=10)
    with InferenceServer(device="cpu") as srv:
        srv.load_generative("g", cfg, params, kv_blocks=64, warm=False)
        solo = [srv.generate("g", p, max_new_tokens=14).result(300)
                ["tokens"] for p in prompts]
    batched, st = _serve(InferenceServer, {"device": "cpu"}, cfg, params,
                         prompts, 14, stagger=0.02, spec_k=3,
                         draft=(dcfg, dparams))
    assert st["verify_keys"], "target verify ladder never used"
    assert st["propose_keys"], "draft propose ladder never used"
    assert batched == solo


def test_spec_falls_back_to_plain_decode_near_max_seq():
    """A sequence within k + 1 positions of max_seq (64 here) runs plain
    decode steps: the tokens still equal plain decode's, up to the token
    emitted from the last position (context max_seq, 65 in all)."""
    cfg, params, dcfg, dparams = _spec_pair()
    prompts = _prompts(37, 2, lo=50, hi=56)
    plain = _plain(cfg, params, prompts, 20)
    spec, st = _serve(InferenceServer, {"device": "cpu"}, cfg, params,
                      prompts, 20, spec_k=3, draft=(dcfg, dparams))
    assert spec == plain
    assert [len(p) + len(t) for p, t in zip(prompts, spec)] == [65, 65]
    assert st["spec_rounds"] > 0
    assert st["decode_steps"] > st["spec_rounds"], "never fell back"


@pytest.mark.parametrize("b", [1, 3])
def test_new_steps_give_k7_contiguous_int32_inputs(monkeypatch, b):
    """K7 on a card takes contiguous inputs and int32 tables and
    lengths, and raises otherwise; the suffix prefill, the verify and
    the proposal hand it such at B = 1 (where a reshape of an expanded
    table stays a zero-stride view) and above."""
    from paddle_tpu_torch.serving import generative

    real, calls = generative.paged_attention, []

    def checked(q, kp, vp, tables, lens, *args):
        assert all(x.is_contiguous() for x in (q, kp, vp, tables, lens))
        assert tables.dtype == lens.dtype == torch.int32
        calls.append(tuple(tables.shape))
        return real(q, kp, vp, tables, lens, *args)

    monkeypatch.setattr(generative, "paged_attention", checked)
    cfg, params, dcfg, dparams = _spec_pair()
    eng = GenerativeEngine(cfg, params, kv_blocks=16, device="cpu",
                           warm=False, prefix_cache=True, spec_k=3,
                           draft=(dcfg, dparams))
    try:
        for step in (eng._compile_prefill_cached((8 * b,)),
                     eng._compile_verify((b, 8, 4)),
                     eng.draft._compile_propose((b, 8, 3))):
            step.fn()
    finally:
        eng.close()
    nb = cfg.max_blocks
    assert calls == [(8 * b, nb)] * 2 + [(4 * b, 8)] * 2 + [(b, 8)] * 3
