"""paddle_tpu_torch generative serving against the JAX package's.

The same ``tiny_lm`` params go through both packages' GenerativeEngine
(prefill, then decode steps with logits) and both packages'
InferenceServer.generate, at the reference tests' small config; greedy
tokens must be identical and logits within atol = rtol = 1e-4 (f32 on
the CPU, sums in another order).  The rest ports the reference's
contracts (tests/test_generative_serving.py) to the port alone.
"""
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving import GenerativeEngine as JaxEngine
from paddle_tpu.serving import InferenceServer as JaxServer
from paddle_tpu.serving import engine as jax_buckets
from paddle_tpu.serving.generative import GenRequest as JaxRequest
from paddle_tpu_torch.serving import (GenerativeEngine, GenRequest,
                                      InferenceServer, bucket_ladder,
                                      dense_forward, pow2_bucket, tiny_lm)

CFG_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              block_size=8, max_blocks=8, max_batch=4)
STEPS = 8


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _prompts(seed, n, lo=3, hi=15):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


def _run_engine(eng, req_cls, prompts):
    """Prefill every prompt, then STEPS batched decode steps with
    logits: (first tokens, [B, STEPS] tokens, [STEPS, B, V] logits)."""
    seqs = []
    for p in prompts:
        r = req_cls(p, STEPS + 1, None, None)
        r.blocks = eng.pool.alloc(eng.pool.blocks_for(len(p) + STEPS))
        r.out.append(int(eng.prefill(r)))
        seqs.append(r)
    firsts = [s.out[0] for s in seqs]
    logits = []
    for _ in range(STEPS):
        nxt, lg = eng.decode(seqs, with_logits=True)
        for s, t in zip(seqs, nxt):
            s.out.append(int(t))
        logits.append(np.asarray(lg))
    for s in seqs:
        eng.free_sequence(s)
    return firsts, [s.out[1:] for s in seqs], np.stack(logits)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_engine_matches_jax_engine(quant):
    cfg, params = tiny_lm(7, **CFG_KW)
    prompts = _prompts(1, 3)
    jeng = JaxEngine(cfg.todict(), params, quant=quant, kv_blocks=32,
                     warm=False)
    peng = GenerativeEngine(cfg, params, quant=quant, kv_blocks=32,
                            device="cpu", warm=False)
    try:
        jf, jt, jl = _run_engine(jeng, JaxRequest, prompts)
        pf, pt, pl = _run_engine(peng, GenRequest, prompts)
    finally:
        jeng.close()
        peng.close()
    assert pf == jf
    assert pt == jt
    np.testing.assert_allclose(pl, jl, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_server_generate_matches_jax_server(quant):
    cfg, params = tiny_lm(5, **CFG_KW)
    prompts = _prompts(2, 4)
    with JaxServer() as srv:
        srv.load_generative("g", cfg.todict(), params, quant=quant,
                            kv_blocks=32, warm=False)
        ref = [f.result(180)["tokens"]
               for f in [srv.generate("g", p, 6) for p in prompts]]
    with InferenceServer(device="cpu") as srv:
        srv.load_generative("g", cfg, params, quant=quant, kv_blocks=32,
                            warm=False)
        got = [f.result(180) for f in [srv.generate("g", p, 6)
                                       for p in prompts]]
        assert srv.engine("g").pool.used_blocks == 0
    assert [r["tokens"] for r in got] == ref
    for r in got:
        assert r["ttft_ms"] is not None and len(r["itl_ms"]) == 5
        assert r["preempted"] == 0


def test_engine_matches_dense_forward():
    """The paged engine (prefill + decode steps) against the plain
    dense causal forward over the whole sequence."""
    cfg, params = tiny_lm(3, **CFG_KW)
    prompt = _prompts(4, 1)[0]
    eng = GenerativeEngine(cfg, params, kv_blocks=32, device="cpu",
                           warm=False)
    first, toks, logits = _run_engine(eng, GenRequest, [prompt])
    eng.close()
    dense = dense_forward(cfg, params, prompt + first + toks[0][:-1],
                          device="cpu").numpy()
    n = len(prompt)
    assert dense[n - 1].argmax() == first[0]
    np.testing.assert_allclose(dense[n:], logits[:, 0], atol=1e-4,
                               rtol=1e-4)
    assert dense[n:].argmax(-1).tolist() == toks[0]


def test_buckets_match_jax():
    for cap in (1, 3, 4, 12, 16, 128):
        assert bucket_ladder(cap) == jax_buckets.bucket_ladder(cap)
        for n in range(1, 2 * cap + 2):
            assert pow2_bucket(n, cap) == jax_buckets.pow2_bucket(n, cap)


# --------------------------------------------- port-only contracts

def test_prefill_admitted_mid_decode_bit_identical():
    cfg, params = tiny_lm(11, **CFG_KW)
    prompts = _prompts(3, 4)
    with InferenceServer(device="cpu") as srv:
        srv.load_generative("g", cfg, params, kv_blocks=64, warm=False)
        solo = [srv.generate("g", p, max_new_tokens=16).result(180)
                ["tokens"] for p in prompts]
    with InferenceServer(device="cpu") as srv:
        eng = srv.load_generative("g", cfg, params, kv_blocks=64,
                                  warm=False)
        # the rest arrive once the first is decoding: admission lands
        # mid-decode
        futs = [srv.generate("g", prompts[0], max_new_tokens=16)]
        while eng.decode_steps == 0 and not futs[0].done():
            time.sleep(0.0002)
        futs += [srv.generate("g", p, max_new_tokens=16)
                 for p in prompts[1:]]
        batched = [f.result(180)["tokens"] for f in futs]
        assert eng.decode_rows > eng.decode_steps, \
            "sequences never overlapped — test is vacuous"
        assert eng.pool.used_blocks == 0
    assert solo == batched


def test_pool_exhaustion_preempts_and_requeues():
    cfg, params = tiny_lm(11, **CFG_KW)
    prompts = _prompts(9, 3, lo=6, hi=12)
    with InferenceServer(device="cpu") as srv:
        srv.load_generative("g", cfg, params, kv_blocks=64, warm=False)
        solo = [srv.generate("g", p, max_new_tokens=20).result(180)
                ["tokens"] for p in prompts]
    with InferenceServer(device="cpu") as srv:
        # 7 usable blocks cannot hold 3 growing sequences
        eng = srv.load_generative("g", cfg, params, kv_blocks=8,
                                  warm=False)
        res = [f.result(300) for f in [srv.generate("g", p, 20)
                                       for p in prompts]]
        assert eng.pool.preemptions > 0, "pool never exhausted"
        assert eng.pool.alloc_failures > 0
        assert eng.pool.used_blocks == 0
    assert any(r["preempted"] for r in res)
    assert [r["tokens"] for r in res] == solo


def test_lone_sequence_too_big_for_pool_fails_cleanly():
    cfg, params = tiny_lm(11, **CFG_KW)
    with InferenceServer(device="cpu") as srv:
        srv.load_generative("g", cfg, params, kv_blocks=3, warm=False)
        fut = srv.generate("g", list(range(10)), max_new_tokens=16)
        with pytest.raises(RuntimeError, match="pool too small"):
            fut.result(180)


def test_generate_validation():
    cfg, params = tiny_lm(7, **CFG_KW)
    with InferenceServer(device="cpu") as srv:
        srv.load_generative("g", cfg, params, kv_blocks=3, warm=False)
        with pytest.raises(ValueError):
            srv.generate("g", [], max_new_tokens=4)
        with pytest.raises(ValueError):
            srv.generate("g", [999], max_new_tokens=4)   # out of vocab
        with pytest.raises(ValueError):
            srv.generate("g", [1], max_new_tokens=0)
        with pytest.raises(ValueError, match="max_seq"):
            srv.generate("g", [1] * 130, max_new_tokens=4)
        with pytest.raises(ValueError, match="KV blocks"):
            srv.generate("g", [1] * 20, max_new_tokens=2)
        with pytest.raises(KeyError):
            srv.generate("ghost", [1], max_new_tokens=1)
        with pytest.raises(ValueError, match="already loaded"):
            srv.load_generative("g", cfg, params, warm=False)
        assert srv.models() == ["g"]
        srv.unload("g")
        assert srv.models() == []


def test_generate_eos_stops_early():
    cfg, params = tiny_lm(7, **CFG_KW)
    with InferenceServer(device="cpu") as srv:
        srv.load_generative("g", cfg, params, kv_blocks=32, warm=False)
        ref = srv.generate("g", [1, 2, 3], 12).result(180)["tokens"]
        eos = ref[4]
        res = srv.generate("g", [1, 2, 3], 12,
                           eos_id=eos).result(180)["tokens"]
    assert res == ref[:ref.index(eos) + 1]


@pytest.mark.parametrize("kw", [{"spec_k": 2}, {"spec_k": -1},
                                {"spec_k": 2, "draft": {"block_size": 16}}])
def test_deferred_features_raise(kw):
    """The reference's argument errors of the speculative tenant: spec_k
    without a draft, a negative spec_k, a draft of another block size."""
    cfg, params = tiny_lm(7, **CFG_KW)
    kw = dict(kw)
    if "draft" in kw:
        kw["draft"] = tiny_lm(8, **dict(CFG_KW, n_layers=1, **kw["draft"]))
    match = ("block_size mismatch" if "draft" in kw else
             "needs a draft model" if kw["spec_k"] > 0 else
             "spec_k must be >= 0")
    with InferenceServer(device="cpu") as srv:
        with pytest.raises(ValueError, match=match):
            srv.load_generative("g", cfg, params, warm=False, **kw)
        assert srv.models() == []


def test_unsupported_quant_rejected():
    cfg, params = tiny_lm(7, **CFG_KW)
    with pytest.raises(ValueError, match="quant"):
        GenerativeEngine(cfg, params, quant="int4", device="cpu",
                         warm=False)
