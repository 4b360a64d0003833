"""paddle_tpu_torch's serving fleet against the JAX package's.

The reference's contracts (tests/test_serve_fleet.py, the router and
fleet cases) ported to the port: rendezvous placement remaps only a
dead worker's share (and places every key where the reference's router
does), the fleet SLO spec, request-id dedup and exactly-once, a
validation error surfacing without a retry, and a graceful drain.  Then
the fleet as a whole: a kill drill on LocalTransport loses no request,
evicts the killed worker once, re-prefills its in-flight requests and
gives the JAX fleet's tokens; the migrated-in admission branches of
TokenScheduler and DecodeLoop; a FleetEndpoint / SocketTransport round
trip on 127.0.0.1 and the ``python -m paddle_tpu_torch.serving.fleet``
worker process; and a migrated request admitted past a decode worker's
prefix cache without touching its index.  The fault injector and the
retry backoff against the reference's on one seed.
"""
import os
import subprocess
import sys
import time
from concurrent.futures import Future

import numpy as np
import pytest
import torch

from paddle_tpu.distributed import resilience as jax_resilience
from paddle_tpu.serving.fleet import FleetWorker as JaxWorker
from paddle_tpu.serving.fleet import LocalTransport as JaxTransport
from paddle_tpu.serving.generative import tiny_lm as jax_tiny_lm
from paddle_tpu.serving.router import FleetRouter as JaxRouter
from paddle_tpu.serving.router import _Member as JaxMember
from paddle_tpu.serving.router import default_fleet_slos as jax_slos
from paddle_tpu_torch.core.flags import FLAGS
from paddle_tpu_torch.distributed import resilience
from paddle_tpu_torch.serving import (FleetEndpoint, FleetRemoteError,
                                      FleetRouter, FleetWorker,
                                      GenerativeEngine, GenRequest,
                                      LocalTransport, SocketTransport,
                                      default_fleet_slos, tiny_lm)
from paddle_tpu_torch.serving.batcher import RequestQueue, TokenScheduler
from paddle_tpu_torch.serving.fleet import (M_CALL, decode_call,
                                            encode_call)
from paddle_tpu_torch.serving.generative import DecodeLoop
from paddle_tpu_torch.serving.router import _Member

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CFG_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              block_size=8, max_blocks=8, max_batch=4)
FLEET = (("p0", "prefill"), ("d0", "decode"), ("d1", "decode"))


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _fleet(specs, kv_blocks=24, jax=False, quant=""):
    """Workers of ``specs`` ((name, role), ...) over one LocalTransport
    of their package (the port's on the CPU)."""
    if jax:
        cfg, params = jax_tiny_lm(3, **CFG_KW)
        tr = JaxTransport()
        workers = [JaxWorker(n, r, cfg, params, quant=quant,
                             kv_blocks=kv_blocks, warm=False, transport=tr)
                   for n, r in specs]
    else:
        cfg, params = tiny_lm(3, **CFG_KW)
        tr = LocalTransport()
        workers = [FleetWorker(n, r, cfg, params, quant=quant,
                               kv_blocks=kv_blocks, warm=False,
                               transport=tr, device="cpu")
                   for n, r in specs]
    for w in workers:
        tr.register(w)
    return tr, workers


def _router(tr, workers, jax=False, **kw):
    kw.setdefault("lease_s", 5.0)
    kw.setdefault("lease_interval_s", 1.0)
    kw.setdefault("deadline_s", 60.0)
    cls = JaxRouter if jax else FleetRouter
    return cls(tr, [(w.name, "local:%s" % w.name, w.role)
                    for w in workers], **kw)


def _close(router, workers):
    router.close()
    for w in workers:
        w.shutdown()


def _prompts(n, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randint(0, 64, int(rng.randint(3, 30))).tolist()
            for _ in range(n)]


# ------------------------------------------------------- placement

def test_prefix_affinity_minimal_remap():
    """Rendezvous hashing over the token-id prefix: the same prefix
    always lands on the same prefill worker, the reference's router
    places every key on the same worker, and removing one member remaps
    only THAT member's share."""
    members = [_Member("p%d" % i, "addr%d" % i, "prefill")
               for i in range(4)]
    jmembers = [JaxMember("p%d" % i, "addr%d" % i, "prefill")
                for i in range(4)]
    keys = [",".join(str((7 * i + j) % 64) for j in range(8))
            for i in range(200)]
    place = {k: FleetRouter._rendezvous(k, members).name for k in keys}
    assert place == {k: FleetRouter._rendezvous(k, members).name
                     for k in keys}
    assert place == {k: JaxRouter._rendezvous(k, jmembers).name
                     for k in keys}
    survivors = members[:2] + members[3:]           # p2 evicted
    moved = 0
    for k in keys:
        now = FleetRouter._rendezvous(k, survivors).name
        if place[k] == "p2":
            assert now != "p2"
            moved += 1
        else:
            assert now == place[k], \
                "key not owned by the dead worker was remapped"
    assert moved > 0


def test_default_fleet_slos_spec():
    spec = default_fleet_slos(["d0", "d1"], ttft_p99_ms=1500.0)
    assert "serve_fleet_availability >= 1" in spec
    assert "fleet_ttft_ms_d0.p99 <= 1500" in spec
    assert "fleet_ttft_ms_d1.p99 <= 1500" in spec
    assert spec == jax_slos(["d0", "d1"], ttft_p99_ms=1500.0)


# ------------------------------------------------- router behavior

def test_request_id_dedup_and_exactly_once():
    """The same req_id submitted twice returns the SAME future (one
    generation), and a fleet round trip resolves it exactly once,
    through a migration."""
    tr, workers = _fleet(FLEET[:2])
    router = _router(tr, workers)
    try:
        f1 = router.generate([5, 6, 7], 4, req_id="same")
        f2 = router.generate([5, 6, 7], 4, req_id="same")
        assert f1 is f2
        res = f1.result(timeout=120)
        assert len(res["tokens"]) == 4
        assert res["req_id"] == "same" and res["worker"] == "d0"
        assert workers[1].migrations == 1 and router.requests == 1
        assert len(workers[0].migrate_ms) == 1
        assert len(router.ttft_ms) == 1 and \
            router.ttft_ms_by_worker["d0"] == router.ttft_ms
    finally:
        _close(router, workers)


def test_validation_error_not_retried():
    """A non-retryable remote error (a prompt token outside the vocab)
    surfaces at once as FleetRemoteError: no attempt budget burnt on a
    request that can never succeed."""
    tr, workers = _fleet(FLEET[:2])
    router = _router(tr, workers)
    try:
        fut = router.generate([2, 999], 4, req_id="bad")
        with pytest.raises(FleetRemoteError, match="vocab"):
            fut.result(timeout=60)
        assert router._recs["bad"].attempts == 1, \
            "validation error was retried"
    finally:
        _close(router, workers)


def test_graceful_drain_stops_admission():
    """drain() removes the worker from routing; the worker refuses new
    admissions by name while reporting drained once quiet; requests
    after the drain run on the survivor."""
    tr, workers = _fleet(FLEET)
    router = _router(tr, workers)
    try:
        ack = router.drain("d1", timeout=10.0)
        assert ack["drained"] is True
        rep = decode_call(workers[2].handle(M_CALL, memoryview(
            encode_call({"op": "generate",
                         "req": {"id": "x", "prompt": [1, 2],
                                 "max_new": 2, "eos": None}}))))
        assert rep["ok"] is False and rep["kind"] == "Draining"
        res = router.generate([4, 4, 4], 3, req_id="after").result(120)
        assert res["worker"] == "d0"
        assert len(res["tokens"]) == 3
        assert router.availability == 2 / 3
        assert router.status()["members"]["d1"]["live"] is False
    finally:
        _close(router, workers)


# ------------------------------------------------- the fleet end to end

def _jax_fleet_tokens(prompts, max_new):
    tr, workers = _fleet(FLEET, kv_blocks=48, jax=True)
    router = _router(tr, workers, jax=True)
    try:
        futs = [router.generate(p, max_new) for p in prompts]
        return [f.result(120)["tokens"] for f in futs]
    finally:
        _close(router, workers)


def test_kill_drill_loses_nothing_and_matches_the_jax_fleet():
    """One prefill and two decode workers behind the router.  The first
    half of the requests is admitted; then a delay at the prefill
    injection point holds the second half in their prompt passes, and
    d1 is killed.  Every request completes (zero lost) with the JAX
    fleet's tokens, d1 is evicted once, and the requests it owned are
    re-prefilled on the survivor."""
    prompts = _prompts(8, seed=1)
    max_new = 24
    want = _jax_fleet_tokens(prompts, max_new)
    tr, workers = _fleet(FLEET, kv_blocks=48)
    p0, d0, d1 = workers
    router = _router(tr, workers, lease_s=0.5, lease_interval_s=0.05)
    try:
        futs = [router.generate(p, max_new) for p in prompts[:4]]
        deadline = time.monotonic() + 60
        while len(p0.migrate_ms) < 4 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert d1.migrations >= 1
        resilience.install_faults("fleet_prefill:delay:2.0:4")
        futs += [router.generate(p, max_new) for p in prompts[4:]]
        while resilience.get_injector().stats.get("fleet_prefill", 0) < 4:
            time.sleep(0.005)
        tr.kill("d1")
        res = [f.result(120) for f in futs]
    finally:
        resilience.install_faults("")
        _close(router, workers)
    assert [r["tokens"] for r in res] == want
    assert {r["worker"] for r in res[4:]} == {"d0"}
    assert [e["reason"] for e in router.evictions] == ["fleet:eviction:d1"]
    assert router.reprefills >= 1
    assert sum(r["reprefilled"] for r in res) == router.reprefills
    assert router.availability == 2 / 3


def test_migrated_in_admission_branches():
    """TokenScheduler admits a request that arrives with blocks as it
    is: no allocation, no prefix-cache lookup.  DecodeLoop joins it to
    the batch without a prefill; a migrated request whose max_new is 1,
    or whose first token is its eos, finishes at once with that token
    and returns its blocks."""
    cfg, params = tiny_lm(3, **CFG_KW)
    eng = GenerativeEngine(cfg, params, kv_blocks=24, device="cpu",
                           warm=False, prefix_cache=True)
    prompt = [7, 3, 9, 1, 60, 2, 2, 14, 5, 33, 12]

    def migrated(max_new, first, eos=None):
        req = GenRequest(prompt, max_new, eos, Future())
        req.blocks = eng.pool.alloc(eng.pool.blocks_for(len(prompt)))
        eng.prefill_tokens(prompt, req.blocks)
        req.context_len = len(prompt)
        req.out = [first]
        return req

    try:
        want = [eng.prefill_tokens(prompt, [1, 2])]
        req = migrated(5, want[0])
        free0 = eng.pool.free_blocks
        q = RequestQueue()
        q.put(req)
        sched = TokenScheduler(eng.pool, 4, prefix_cache=eng.prefix_cache)
        assert sched.try_admit(q, 0) == [req]
        assert eng.pool.free_blocks == free0
        assert eng.pool.prefix_tokens == 0 and eng.prefix_cache.nodes == 0
        eng.pool.free(req.blocks)

        q = RequestQueue()
        loop = DecodeLoop(eng, q, label="t")
        try:
            prefills = eng.prefills
            one = migrated(1, want[0])
            eos = migrated(8, want[0], eos=want[0])
            full = migrated(6, want[0])
            for r in (one, eos, full):
                q.put(r)
            assert one.future.result(60)["tokens"] == want
            assert eos.future.result(60)["tokens"] == want
            got = full.future.result(60)["tokens"]
        finally:
            loop.stop()
        assert eng.prefills == prefills, "a migrated request was prefilled"
        assert eng.prefix_cache.nodes == 0
        assert eng.pool.used_blocks == 0
        with torch.no_grad():
            ref = GenRequest(prompt, 6, None, Future())
            ref.blocks = eng.pool.alloc(eng.pool.blocks_for(len(prompt) + 6))
            toks = [eng.prefill(ref)]
            ref.out = list(toks)
            while len(toks) < 6:
                toks.append(int(eng.decode([ref])[0]))
                ref.out.append(toks[-1])
            eng.free_sequence(ref)
        assert got == toks
    finally:
        eng.close()


def test_migration_past_a_prefix_cache_leaves_the_index_alone():
    """With FLAGS_serve_prefix_cache on at the decode worker, a migrated
    request is admitted by its blocks: the prefix index is neither
    looked up nor grown, and the tokens are those of the cache-off
    fleet."""
    prompts = _prompts(3, seed=2)
    tr, workers = _fleet(FLEET[:2])
    router = _router(tr, workers)
    try:
        want = [router.generate(p, 6).result(120)["tokens"]
                for p in prompts]
    finally:
        _close(router, workers)
    old = FLAGS.serve_prefix_cache
    FLAGS.serve_prefix_cache = True
    try:
        tr, workers = _fleet(FLEET[:2])
    finally:
        FLAGS.serve_prefix_cache = old
    router = _router(tr, workers)
    try:
        eng = workers[1].engine
        assert eng.prefix_cache is not None
        got = [router.generate(p, 6).result(120)["tokens"]
               for p in prompts]
        assert workers[1].migrations == len(prompts)
        assert eng.prefix_cache.nodes == 0
        assert eng.pool.prefix_tokens == 0 and eng.pool.prefix_hits == 0
    finally:
        _close(router, workers)
    assert got == want


def test_socket_round_trip():
    """The same fleet behind FleetEndpoints on 127.0.0.1, spoken to over
    SocketTransport (the prefill worker migrates over a socket too):
    the tokens equal the LocalTransport fleet's."""
    prompts = _prompts(2, seed=3)
    tr, workers = _fleet(FLEET[:2])
    router = _router(tr, workers)
    try:
        want = [router.generate(p, 5).result(120)["tokens"]
                for p in prompts]
    finally:
        router.close()
    sock = SocketTransport(timeout=30.0)
    eps = [FleetEndpoint(w) for w in workers]
    workers[0].transport = sock
    router = FleetRouter(sock, [(w.name, ep.addr, w.role)
                                for w, ep in zip(workers, eps)],
                         lease_s=5.0, lease_interval_s=1.0, deadline_s=60.0)
    try:
        got = [router.generate(p, 5, req_id="s%d" % i).result(120)["tokens"]
               for i, p in enumerate(prompts)]
        st = decode_call(sock.call(eps[1].addr, M_CALL,
                                   encode_call({"op": "status"})))
        assert st["counters"]["migrations"] == 2 * len(prompts)
        assert st["slo_alerts"] == []
    finally:
        router.close()
        for ep in eps:
            ep.stop()
        sock.close()
        for w in workers:
            w.shutdown()
    assert got == want


def test_worker_process_serves_and_drains():
    """``python -m paddle_tpu_torch.serving.fleet --role decode --name
    d0 --device cpu`` with FLEETW_* dims prints its READY line, answers
    a generate over the socket, and exits 0 on a drain."""
    env = dict(os.environ, FLEETW_DMODEL="32", FLEETW_HEADS="2",
               FLEETW_LAYERS="1", FLEETW_DFF="64", FLEETW_BLOCK="8",
               FLEETW_KV_BLOCKS="16", FLEETW_MAX_BATCH="4",
               PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.Popen(
        [sys.executable, "-m", "paddle_tpu_torch.serving.fleet",
         "--role", "decode", "--name", "d0", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env, cwd=REPO)
    sock = SocketTransport(timeout=60.0)
    try:
        seen = []
        for line in proc.stdout:     # runpy's warnings come first
            seen.append(line)
            if line.startswith("FLEET_READY"):
                break
        assert line.startswith("FLEET_READY name=d0 role=decode"), seen
        addr = "127.0.0.1:%s" % line.split("port=")[1].split()[0]

        def call(head):
            return decode_call(sock.call(addr, M_CALL, encode_call(head)))

        assert call({"op": "ping"})["role"] == "decode"
        req = {"id": "a", "prompt": [1, 2, 3], "max_new": 4, "eos": None}
        assert call({"op": "generate", "req": req})["ok"]
        res = call({"op": "wait", "id": "a", "timeout": 60})
        assert res["done"] and len(res["result"]["tokens"]) == 4
        assert call({"op": "drain", "timeout": 10})["drained"] is True
        assert proc.wait(timeout=60) == 0
    finally:
        sock.close()
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        proc.stdout.close()


# ---------------------------------------------- the resilience copy

@pytest.mark.parametrize("spec", ["fleet_prefill:drop:0.5",
                                  "fleet_migrate:error:0.3:2,"
                                  "fleet_migrate_tear:drop:1:1"])
def test_fault_injector_and_backoff_match_the_reference(spec):
    """The same spec and seed fire the same faults, in the same order,
    in both packages, and RetryPolicy's backoff draws the same
    delays."""
    def trace(mod):
        inj = mod.FaultInjector(spec, seed=11)
        out = []
        for i in range(40):
            point = ("fleet_prefill", "fleet_migrate",
                     "fleet_migrate_tear")[i % 3]
            try:
                inj.fire(point)
                out.append(None)
            except mod.InjectedFault as e:
                out.append((e.point, e.action, e.retryable))
        return out, inj.stats

    assert trace(resilience) == trace(jax_resilience)
    import random

    mine = resilience.RetryPolicy(base_backoff=0.02, max_backoff=0.5,
                                  rng=random.Random(5))
    ref = jax_resilience.RetryPolicy(base_backoff=0.02, max_backoff=0.5,
                                     rng=random.Random(5))
    assert [mine.backoff(a) for a in range(1, 9)] == \
        [ref.backoff(a) for a in range(1, 9)]
    with pytest.raises(ValueError, match="bad fault action"):
        resilience.FaultInjector("x:corrupt:1")
