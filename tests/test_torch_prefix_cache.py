"""paddle_tpu_torch's copy-on-write prefix cache against the JAX package's.

The reference's contracts (tests/test_prefix_cache.py) ported to the
port: the block-granular trie's hit, miss and partial-tail lookups, COW
write isolation, the refcount-ordered LRU, a shared block counted once,
eviction dropping the unreachable subtree, tokens the same with the
cache on and off, and preemption with the cache on.  Then the port held
against the JAX package on the same inputs: one sequence of pool
operations gives the same ids and refcounts in both pools, ``probe``
agrees, and a suffix prefill gives the same first token and pages within
atol = rtol = 1e-4.  The reference's sanitizer cases (the double-free
trip, the lifetime checker) have no subject in the port yet.
"""
import numpy as np
import pytest
import torch

from paddle_tpu.serving import BlockPool as JaxPool
from paddle_tpu.serving import GenerativeEngine as JaxEngine
from paddle_tpu.serving import InferenceServer as JaxServer
from paddle_tpu.serving.generative import GenRequest as JaxRequest
from paddle_tpu_torch.core.flags import FLAGS
from paddle_tpu_torch.serving import (BlockPool, GenerativeEngine,
                                      GenRequest, InferenceServer, tiny_lm)

CFG_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              block_size=8, max_blocks=8, max_batch=4)
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Req:
    """The two attributes PrefixCache.acquire contracts on."""

    def __init__(self, prompt):
        self.prompt = list(prompt)
        self.blocks = None
        self.cached_len = 0


def _engine(**kw):
    cfg, params = tiny_lm(7, **CFG_KW)
    kw.setdefault("kv_blocks", 32)
    return GenerativeEngine(cfg, params, prefix_cache=True, device="cpu",
                            warm=False, **kw)


def _pages(eng, blocks):
    return [t[:, blocks].clone() for t in (eng._kp, eng._vp)]


# ------------------------------------------------------- the trie

def test_radix_hit_miss_partial_boundary():
    """A cold prompt misses; a re-walked prompt hits its full chunks;
    the final prompt token is never served from the cache; a
    divergent-suffix prompt gets the shared full chunks plus a COW tail
    capped at the divergence."""
    eng = _engine()
    try:
        idx = eng.prefix_cache
        bs = eng.config.block_size
        prompt = list(np.random.RandomState(0).randint(0, 64, 20))

        assert idx.probe(prompt) == (0, 0)
        a = _Req(prompt)
        assert idx.acquire(a) and a.cached_len == 0
        assert len(a.blocks) == eng.pool.blocks_for(20)
        idx.insert(a)
        assert idx.nodes == 2          # 20 // 8 full chunks

        assert idx.probe(prompt) == (2, 16)
        # a prompt that IS the indexed chunks: the walk stops a chunk
        # early and the last chunk becomes a COW tail of bs - 1 tokens
        assert idx.probe(prompt[:2 * bs]) == (2, 2 * bs - 1)
        assert idx.probe([63] * 20) == (0, 0)

        b_prompt = prompt[:12] + [(prompt[12] + 1) % 64]
        assert idx.probe(b_prompt) == (2, 12)   # 8 full + 4 COW tail
        b = _Req(b_prompt)
        cow0 = eng.pool.cow_copies
        assert idx.acquire(b) and b.cached_len == 12
        assert eng.pool.cow_copies == cow0 + 1
        assert b.blocks[0] == a.blocks[0]       # shared
        assert b.blocks[1] != a.blocks[1]       # a private copy
        assert eng.pool.ref(a.blocks[0]) == 2
        assert eng.pool.ref(b.blocks[1]) == 1
        assert eng.pool.prefix_hits == 1
        assert eng.pool.prefix_tokens == 20 + 13
        assert eng.pool.prefix_tokens_cached == 12
        eng.pool.free(a.blocks)
        eng.pool.free(b.blocks)
    finally:
        eng.close()


def test_cow_write_isolation():
    """The COW copy carries the shared prefix's pages; a suffix prefill
    writing into the copy leaves the original's pages untouched."""
    eng = _engine()
    try:
        idx = eng.prefix_cache
        prompt = list(range(16))
        a = _Req(prompt)
        assert idx.acquire(a)
        eng.prefill_tokens(a.prompt, a.blocks)
        idx.insert(a)

        b = _Req(prompt[:12] + [63])
        assert idx.acquire(b)
        assert b.blocks[1] != a.blocks[1]
        for x, y in zip(_pages(eng, [a.blocks[1]]),
                        _pages(eng, [b.blocks[1]])):
            assert torch.equal(x, y)
        before = _pages(eng, [a.blocks[1]])
        eng._prefill_suffix(b.prompt, b.blocks, 12)
        for x, y in zip(before, _pages(eng, [a.blocks[1]])):
            assert torch.equal(x, y)
        assert not torch.equal(_pages(eng, [b.blocks[1]])[0], before[0])
        eng.pool.free(a.blocks)
        eng.pool.free(b.blocks)
    finally:
        eng.close()


# ------------------------------------------------- refcount eviction

def test_refcount_eviction_order():
    """Released cacheable blocks PARK in the LRU; allocation pressure
    reclaims the oldest parked first, and a revived block re-parks at
    the recent end."""
    evicted = []
    pool = BlockPool(6, 8)             # 5 usable
    pool.set_evict_callback(lambda b: evicted.append(b) or ())
    a = pool.alloc(3)
    pool.set_cacheable(a)
    pool.free(a)                       # park a0, a1, a2 (oldest first)
    assert pool.used_blocks == 0 and pool.cached_blocks == 3
    assert pool.free_blocks == 5

    assert pool.share([a[0]])
    assert pool.ref(a[0]) == 1
    pool.free([a[0]])
    assert pool.cached_blocks == 3

    got = pool.alloc(4)
    assert got is not None
    assert evicted == [a[1], a[2]]
    assert pool.cached_blocks == 1
    pool.free(got)
    pool.close()


def test_shared_block_counts_once_and_decref_is_not_free():
    pool = BlockPool(6, 8)
    blk = pool.alloc(1)
    assert pool.share(blk) and pool.ref(blk[0]) == 2
    assert pool.used_blocks == 1 and pool.shared_blocks == 1
    pool.free(blk)                     # decref to 1: NOT a free
    assert pool.used_blocks == 1 and pool.ref(blk[0]) == 1
    assert pool.shared_blocks == 0 and pool.free_blocks == 4
    pool.free(blk)                     # the last reference
    assert pool.used_blocks == 0 and pool.free_blocks == 5
    pool.free(blk)                     # an unmatched decref is ignored
    assert pool.free_blocks == 5
    with pytest.raises(ValueError, match="reserved"):
        pool.free([0])
    pool.close()


def test_eviction_drops_unreachable_subtree():
    """Reclaiming a parked parent chunk drops its node AND every parked
    descendant: a lookup can never walk through a missing parent."""
    eng = _engine(kv_blocks=8)        # 7 usable
    try:
        idx = eng.prefix_cache
        a = _Req(list(range(24)))     # 3 full chunks: a parent chain
        assert idx.acquire(a)
        idx.insert(a)
        eng.pool.free(a.blocks)       # all parked
        assert idx.nodes == 3 and eng.pool.cached_blocks >= 3
        got = eng.pool.alloc(eng.pool.free_blocks)
        assert got is not None
        assert idx.nodes == 0 and eng.pool.cached_blocks == 0
        eng.pool.free(got)
    finally:
        eng.close()


# --------------------------------------------------------------- e2e

def _shared_prompts():
    shared = list(np.random.RandomState(3).randint(0, 64, 17))
    return [shared + [t] for t in (1, 2, 3)] + [shared[:10] + [5]]


def test_bit_identical_tokens_cache_on_vs_off_and_jax():
    """Greedy tokens are identical with the cache on and off, and equal
    the JAX package's prefix-cache tenant's; the cached run shares (3
    warm lookups hit)."""
    cfg, params = tiny_lm(7, **CFG_KW)
    prompts = _shared_prompts()

    def run(on):
        with InferenceServer(device="cpu") as srv:
            eng = srv.load_generative("g", cfg, params, kv_blocks=64,
                                      warm=False, prefix_cache=on)
            toks = [srv.generate("g", p, max_new_tokens=12).result(300)
                    ["tokens"] for p in prompts]
            assert eng.pool.used_blocks == 0
            return toks, eng.pool.prefix_hits, eng.pool.prefix_tokens_cached

    off, hits_off, _ = run(False)
    on, hits_on, cached = run(True)
    with JaxServer() as srv:
        srv.load_generative("g", cfg.todict(), params, kv_blocks=64,
                            warm=False, prefix_cache=True)
        ref = [srv.generate("g", p, max_new_tokens=12).result(300)
               ["tokens"] for p in prompts]
    assert on == off == ref
    assert (hits_off, hits_on) == (0, 3) and cached > 0


def test_prefix_cache_follows_the_flag():
    cfg, params = tiny_lm(7, **CFG_KW)
    prev = FLAGS.serve_prefix_cache
    FLAGS.serve_prefix_cache = True
    try:
        eng = GenerativeEngine(cfg, params, kv_blocks=16, device="cpu",
                               warm=False)
        assert eng.prefix_cache is not None
        eng.close()
        eng = GenerativeEngine(cfg, params, kv_blocks=16, device="cpu",
                               warm=False, prefix_cache=False)
        assert eng.prefix_cache is None
        eng.close()
    finally:
        FLAGS.serve_prefix_cache = prev


def test_pool_exhaustion_preemption_with_prefix_cache():
    """Pool exhaustion with the cache on: parked prefix blocks are
    reclaimed under pressure, sequences preempt and requeue, and every
    request still produces its solo tokens."""
    cfg, params = tiny_lm(11, **CFG_KW)
    shared = list(np.random.RandomState(5).randint(0, 64, 9))
    prompts = [shared + [t] for t in (1, 2, 3)]
    with InferenceServer(device="cpu") as srv:
        srv.load_generative("g", cfg, params, kv_blocks=64, warm=False)
        solo = [srv.generate("g", p, max_new_tokens=20).result(300)
                ["tokens"] for p in prompts]
    with InferenceServer(device="cpu") as srv:
        # 7 usable blocks for 3 growing sequences + parked prefix
        eng = srv.load_generative("g", cfg, params, kv_blocks=8,
                                  warm=False, prefix_cache=True)
        res = [f.result(300) for f in [srv.generate("g", p, 20)
                                       for p in prompts]]
        assert eng.pool.preemptions > 0, "pool never exhausted"
    assert [r["tokens"] for r in res] == solo


# ------------------------------------------- against the JAX package

def _pool_state(pool, n):
    return ([pool.ref(b) for b in range(1, n)], pool.free_blocks,
            pool.used_blocks, pool.cached_blocks)


def test_pool_protocol_matches_jax_pool():
    """One seeded sequence of alloc / share / cow / set_cacheable / free
    gives the same ids, results, evictions and refcounts in both
    pools."""
    n = 12
    pools = (BlockPool(n, 8), JaxPool(n, 8))
    evicted = ([], [])
    for pool, ev in zip(pools, evicted):
        pool.set_evict_callback(lambda b, ev=ev: ev.append(b) or ())
    rng = np.random.RandomState(0)
    held = []                          # references the test holds
    try:
        for _ in range(300):
            op = rng.randint(5)
            if op == 0:
                args = (int(rng.randint(1, 4)),)
                got = [p.alloc(*args) for p in pools]
                if got[0] is not None:
                    held.extend(got[0])
            elif op == 1:
                args = (rng.randint(1, n, rng.randint(1, 3)).tolist(),)
                got = [p.share(*args) for p in pools]
                if got[0]:
                    held.extend(args[0])
            elif op == 2 and held:
                b = held.pop(rng.randint(len(held)))
                got = [p.cow(b) for p in pools]
                held.append(b if got[0] is None else got[0])
            elif op == 3:
                args = (rng.randint(1, n, 3).tolist(), bool(rng.rand() < .8))
                got = [p.set_cacheable(*args) for p in pools]
            elif held:
                rng.shuffle(held)
                k = rng.randint(1, len(held) + 1)
                args, held = (held[:k],), held[k:]
                got = [p.free(*args) for p in pools]
            else:
                continue
            assert got[0] == got[1]
            assert _pool_state(pools[0], n) == _pool_state(pools[1], n)
            assert evicted[0] == evicted[1]
        assert pools[0].cow_copies > 0 and evicted[0]
    finally:
        for p in pools:
            p.close()


def _engines(kv_blocks=32):
    cfg, params = tiny_lm(7, **CFG_KW)
    return (GenerativeEngine(cfg, params, kv_blocks=kv_blocks, device="cpu",
                             warm=False, prefix_cache=True),
            JaxEngine(cfg.todict(), params, kv_blocks=kv_blocks, warm=False,
                      prefix_cache=True))


def test_probe_and_suffix_prefill_match_jax():
    """The same admissions through both engines' prefix caches: every
    probe agrees, the blocks are the same ids, and each suffix prefill
    (a full-chunk hit, a COW tail, the exact-chunks prompt whose last
    token alone runs) gives the JAX engine's first token and pages
    within 1e-4."""
    peng, jeng = _engines()
    rng = np.random.RandomState(4)
    base = rng.randint(0, 64, 30).tolist()
    prompts = [base, base[:20] + [1, 2, 3], base[:13] + [60] * 9,
               base[:16], rng.randint(0, 64, 11).tolist(),
               base[:24] + rng.randint(0, 64, 20).tolist()]
    held = []
    try:
        for prompt in prompts:
            assert peng.prefix_cache.probe(prompt) == \
                jeng.prefix_cache.probe(prompt)
            reqs = (GenRequest(prompt, 4, None, None),
                    JaxRequest(prompt, 4, None, None))
            for eng, req in zip((peng, jeng), reqs):
                assert eng.prefix_cache.acquire(req)
            p, j = reqs
            assert p.blocks == j.blocks and p.cached_len == j.cached_len
            assert peng.prefill(p) == jeng.prefill(j)
            got = [t.numpy() for t in _pages(peng, p.blocks)]
            want = [np.asarray(t)[:, j.blocks] for t in (jeng._kp, jeng._vp)]
            for g, w in zip(got, want):
                # positions past the prompt hold nothing yet
                np.testing.assert_allclose(
                    g.reshape(g.shape[0], -1, *g.shape[3:])[:, :len(prompt)],
                    w.reshape(w.shape[0], -1, *w.shape[3:])[:, :len(prompt)],
                    **TOL)
            for eng, req in zip((peng, jeng), reqs):
                eng.prefix_cache.insert(req)
            held.append(reqs)
        assert [r[0].cached_len for r in held] == [0, 20, 13, 15, 0, 24]
        assert peng.pool.cow_copies == 3
        assert peng.prefix_cache.nodes == jeng.prefix_cache.nodes
    finally:
        for p, j in held:
            peng.free_sequence(p)
            jeng.free_sequence(j)
        peng.close()
        jeng.close()


def test_suffix_prefill_token_matches_cold_prefill():
    """A suffix prefill's first token and logits equal a cold prefill's
    of the same prompt (the dense oracle's row within 1e-4)."""
    from paddle_tpu_torch.serving import dense_forward

    peng, jeng = _engines()
    jeng.close()
    cfg, params = tiny_lm(7, **CFG_KW)
    try:
        prompt = list(np.random.RandomState(6).randint(0, 64, 27))
        a = _Req(prompt[:19])
        assert peng.prefix_cache.acquire(a)
        peng.prefill_tokens(a.prompt, a.blocks)
        peng.prefix_cache.insert(a)
        b = _Req(prompt)
        assert peng.prefix_cache.acquire(b) and b.cached_len == 16
        tok, logits = peng._prefill_suffix(b.prompt, b.blocks, 16,
                                           with_logits=True)
        dense = dense_forward(cfg, params, prompt, device="cpu").numpy()
        assert tok == int(dense[-1].argmax())
        np.testing.assert_allclose(logits, dense[-1], **TOL)
        peng.pool.free(a.blocks)
        peng.pool.free(b.blocks)
    finally:
        peng.close()
