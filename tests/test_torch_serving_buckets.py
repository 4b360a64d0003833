"""paddle_tpu_torch's bucket steps (``StepCache``) against the JAX
package's.

Both packages keep one step per bucket in a ``StepCache``: the JAX
engine an AOT executable, the port a CUDA graph on a card and the same
step run eagerly on the CPU, as here.  At the reference tests' small
config (``CFG_KW`` of tests/test_torch_serving.py): the cache's own
contract, the warm ladders, prefill and decode through ``pick`` (a
decode served by a covering bucket included) with tokens identical and
logits within atol = rtol = 1e-4, the warm-up's padding step, and
``close``.  One warmed JAX engine serves the module.
"""
import threading
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving import GenerativeEngine as JaxEngine
from paddle_tpu.serving.engine import StepCache as JaxStepCache
from paddle_tpu.serving.generative import GenRequest as JaxRequest
from paddle_tpu_torch.kernels import KERNELS, _build
from paddle_tpu_torch.serving import (GenerativeEngine, GenRequest,
                                      InferenceServer, pow2_bucket, tiny_lm)
from paddle_tpu_torch.serving.engine import StepCache

CFG_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              block_size=8, max_blocks=8, max_batch=4)
STEPS = 6
TOL = dict(atol=1e-4, rtol=1e-4)


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def lm():
    return tiny_lm(7, **CFG_KW)


@pytest.fixture(scope="module")
def jax_engine(lm):
    cfg, params = lm
    eng = JaxEngine(cfg.todict(), params, kv_blocks=32, warm=True)
    yield eng
    eng.close()


def _prompts(seed, n, lo=3, hi=15):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, size=rng.randint(lo, hi)).tolist()
            for _ in range(n)]


@pytest.mark.parametrize("cache_cls", [JaxStepCache, StepCache],
                         ids=["jax", "torch"])
def test_step_cache_covering_and_sync_compile(cache_cls):
    compiled = []

    def build(key):
        compiled.append(key)
        return ("exe",) + key

    cache = cache_cls(build, name="t")
    cache.warm([(2, 8), (4, 8)])
    assert cache.warm_keys == [(2, 8), (4, 8)]
    # exact hit
    key, exe = cache.pick((2, 8))
    assert key == (2, 8) and exe == ("exe", 2, 8)
    # covered miss: smallest covering answers, ideal compiles in bg
    key, exe = cache.pick((2, 4))
    assert key == (2, 8)
    deadline = time.time() + 30
    while (2, 4) not in cache.warm_keys and time.time() < deadline:
        time.sleep(0.01)
    assert (2, 4) in cache.warm_keys
    # nothing covers: synchronous compile
    key, exe = cache.pick((8, 8))
    assert key == (8, 8) and (8, 8) in cache.warm_keys
    cache.drain()
    assert compiled.count((2, 4)) == 1


def test_step_cache_counts_and_a_failed_background_build_warns():
    """The reference's metrics counters as attributes; a background
    build that raises warns, and traffic stays on the covering key."""
    def build(key):
        if key == (1, 1):
            raise RuntimeError("capture failed")
        return key

    cache = StepCache(build, name="t")
    cache.warm([(2, 2)])
    with pytest.warns(UserWarning, match="traffic stays on covering"):
        assert cache.pick((1, 1)) == ((2, 2), (2, 2))
        cache.drain()
        assert (cache.compiles, cache.misses, cache.compile_failures) \
            == (1, 1, 1)
        assert cache.pick((1, 1))[0] == (2, 2)      # tries again
        cache.drain()
    assert cache.compile_failures == 2 and cache.warm_keys == [(2, 2)]
    # with nothing covering, the build's error reaches the caller
    with pytest.raises(RuntimeError, match="capture failed"):
        StepCache(build).pick((1, 1))


def test_warm_keys_match_jax(lm, jax_engine):
    cfg, params = lm
    eng = GenerativeEngine(cfg, params, kv_blocks=32, device="cpu",
                           warm=True)
    try:
        assert eng.batch_ladder == jax_engine.batch_ladder
        assert eng.nb_top == jax_engine.nb_top
        assert eng.prefill_ladder == jax_engine.prefill_ladder
        assert eng.warm_decode_buckets == jax_engine.warm_decode_buckets
        assert eng._prefill.warm_keys == jax_engine._prefill.warm_keys
        assert eng._decode_logits.warm_keys == []
    finally:
        eng.close()


@pytest.mark.parametrize("role", ["decode", "prefill"])
def test_warm_role_grid_matches_jax(lm, role):
    cfg, params = lm
    jeng = JaxEngine(cfg.todict(), params, kv_blocks=32, warm=False)
    eng = GenerativeEngine(cfg, params, kv_blocks=32, device="cpu",
                           warm=False)
    try:
        jeng.warm_role(role)
        eng.warm_role(role)
        assert eng.warm_decode_buckets == jeng.warm_decode_buckets
        assert eng._prefill.warm_keys == jeng._prefill.warm_keys
        with pytest.raises(ValueError):
            eng.warm_role("router")
    finally:
        jeng.close()
        eng.close()


def _run(eng, req_cls, prompts, track=None):
    """Prefill every prompt, then STEPS decode steps with logits over
    them all; ``track(step)`` is called before each decode step.
    Returns (first tokens, [B, STEPS] tokens, [STEPS, B, V] logits)."""
    seqs = []
    for p in prompts:
        r = req_cls(p, STEPS + 1, None, None)
        r.blocks = eng.pool.alloc(eng.pool.blocks_for(len(p) + STEPS))
        r.out.append(int(eng.prefill(r)))
        seqs.append(r)
    logits = []
    for i in range(STEPS):
        if track is not None:
            track(i)
        nxt, lg = eng.decode(seqs, with_logits=True)
        for s, t in zip(seqs, nxt):
            s.out.append(int(t))
        logits.append(np.asarray(lg))
    for s in seqs:
        eng.free_sequence(s)
    return [s.out[0] for s in seqs], [s.out[1:] for s in seqs], \
        np.stack(logits)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_pick_with_a_covering_decode_matches_jax(lm, jax_engine, quant):
    """Prefill through the warm ladder; the first decode step runs on
    the covering (B, nb_top) bucket while the exact one is built in the
    background, the later ones on the exact bucket.  Tokens equal the
    JAX engine's (through the same picks), logits within 1e-4."""
    cfg, params = lm
    prompts = _prompts(3, 3)
    nb = max(-(-(len(p) + STEPS) // cfg.block_size) for p in prompts)
    want = (pow2_bucket(len(prompts), cfg.max_batch),
            pow2_bucket(nb, cfg.max_blocks))
    cover = (want[0], cfg.max_blocks)
    assert want != cover
    if quant:
        jeng = JaxEngine(cfg.todict(), params, quant=quant, kv_blocks=32,
                         warm=True)
    else:
        jeng = jax_engine
    eng = GenerativeEngine(cfg, params, quant=quant, kv_blocks=32,
                           device="cpu", warm=True)
    keys = []      # the bucket each decode step ran at

    def track(step):
        if step:
            keys.append(eng.last_decode_key)
        if step == 1:
            eng._decode_logits.drain()     # the exact bucket is built

    try:
        for e in (jeng, eng):
            e._decode_logits.warm([cover])
        jf, jt, jl = _run(jeng, JaxRequest, prompts)
        pf, pt, pl = _run(eng, GenRequest, prompts, track)
        keys.append(eng.last_decode_key)
        assert keys == [cover] + [want] * (STEPS - 1)
        assert eng._decode_logits.warm_keys == sorted([cover, want])
        assert eng._decode_logits.misses == 1
        assert eng.prefills == len(prompts) and eng.replays == 0
    finally:
        eng.close()
        if quant:
            jeng.close()
    assert pf == jf
    assert pt == jt
    np.testing.assert_allclose(pl, jl, **TOL)


def test_prefill_served_by_a_covering_bucket_matches_jax(lm, jax_engine):
    """With only the top prefill bucket warm, a short prompt runs padded
    to it (the bucket pick returned), then on its own bucket: the same
    first token as the JAX engine's, and the same K/V in its pages."""
    cfg, params = lm
    prompt = _prompts(4, 1, 3, 6)[0]
    eng = GenerativeEngine(cfg, params, kv_blocks=32, device="cpu",
                           warm=False)
    try:
        eng._prefill.warm([(cfg.max_seq,)])
        blocks = eng.pool.alloc(1)
        first = eng.prefill_tokens(prompt, blocks)
        kv = eng._kp[:, blocks].clone()
        eng._prefill.drain()
        assert eng._prefill.warm_keys == [(cfg.block_size,),
                                          (cfg.max_seq,)]
        again = eng.prefill_tokens(prompt, blocks)
        torch.testing.assert_close(eng._kp[:, blocks], kv, **TOL)
        jblocks = jax_engine.pool.alloc(1)
        try:
            want = jax_engine.prefill_tokens(prompt, jblocks)
        finally:
            jax_engine.pool.free(jblocks)
    finally:
        eng.close()
    assert first == again == want


@pytest.mark.parametrize("kind", ["decode", "prefill"])
def test_padding_step_writes_only_block_0(lm, kind):
    """A warm-up step runs on a bucket's padding inputs while live
    sequences hold pages: every page but the scratch block 0 stays as
    it was."""
    cfg, params = lm
    eng = GenerativeEngine(cfg, params, kv_blocks=32, device="cpu",
                           warm=False)
    try:
        for p in _prompts(5, 3, 9, 30):
            r = GenRequest(p, 2, None, None)
            r.blocks = eng.pool.alloc(eng.pool.blocks_for(len(p)))
            eng.prefill(r)
        assert eng.pool.used_blocks >= 4
        before = [t.clone() for t in (eng._kp, eng._vp)]
        step = eng._compile_decode((cfg.max_batch, cfg.max_blocks)) \
            if kind == "decode" else eng._compile_prefill((cfg.max_seq,))
        with torch.no_grad():
            step.fn()
        for got, want in zip((eng._kp, eng._vp), before):
            assert bool(want[:, 1:].abs().sum() > 0)
            assert torch.equal(got[:, 1:], want[:, 1:])
            assert not torch.equal(got[:, 0], want[:, 0])
    finally:
        eng.close()


def test_close_drains_the_caches(lm):
    """close() joins a background build in flight, then drops every
    step before the pages; unload does the same through the server."""
    cfg, params = lm
    eng = GenerativeEngine(cfg, params, kv_blocks=32, device="cpu",
                           warm=True)
    build = eng._decode._build_fn
    started = threading.Event()

    def slow(key):
        started.set()
        time.sleep(0.3)
        return build(key)

    eng._decode._build_fn = slow
    blocks = eng.pool.alloc(1)
    eng.decode_step([blocks], [0], [1])
    assert eng.last_decode_key == (1, cfg.max_blocks)
    assert started.wait(30)
    threads = list(eng._decode._threads)
    assert threads and threads[0].is_alive()
    eng.close()
    assert not any(t.is_alive() for t in threads)
    for cache in (eng._decode, eng._decode_logits, eng._prefill):
        assert cache.warm_keys == []
    assert eng._kp is None and eng._vp is None

    srv = InferenceServer(device="cpu")
    try:
        e = srv.load_generative("g", cfg, params, kv_blocks=32)
        assert e.warm_decode_buckets
        out = srv.generate("g", [1, 2, 3], 3).result(60)
        assert len(out["tokens"]) == 3
        srv.unload("g")
        assert e.warm_decode_buckets == [] and e._kp is None
    finally:
        srv.close()


def test_launch_recording_counts_this_thread_only():
    """``_build.recording`` counts the launches of the thread that
    opened it; another thread's launches meanwhile reach the wrappers'
    counts but not the recording."""
    fn = KERNELS["paged_attention"]
    before = fn.launches
    with _build.recording() as rec:
        _build.count(fn)
        t = threading.Thread(target=lambda: [_build.count(fn)
                                             for _ in range(5)])
        t.start()
        t.join()
    assert rec == {fn: 1}
    assert fn.launches == before + 6
    fn.launches = before


def test_launch_counts_lose_no_update_across_threads():
    """Two tenants launch (``_build.count``) and replay
    (``add_launches``) from their own threads: under a short switch
    interval, 8 threads' counts and adds all land."""
    import sys

    from paddle_tpu_torch.kernels import add_launches

    fn = KERNELS["matmul_int8"]
    before = fn.launches
    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(2000):
                if i % 2:
                    _build.count(fn)
                else:
                    add_launches({"matmul_int8": 1})

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(prev)
    assert fn.launches == before + 8 * 2000
    fn.launches = before
