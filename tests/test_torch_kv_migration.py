"""paddle_tpu_torch's MigrateKV handoff against the JAX package's.

The reference's contracts (tests/test_kv_migration.py) ported to the
port: the double free of a migrated-away block trips the sanitizer by
name and leaves the free list whole; an export racing a step in flight
trips the epoch guard; a torn frame is rolled back and named
``kv_migration:<id>`` (one sanitizer trip); a re-delivered frame is
installed once and the migrated-in decode gives a local generate's
tokens; a frame of another geometry is refused before any allocation.
``import_blocks`` writes into the page tensors in place and refuses
block 0 and mis-shaped pages.  Then the port held against the JAX
package on the same inputs: exported pages agree within atol = rtol =
1e-4, and a frame written by either package's prefill worker, installed
by the other's decode worker, gives the reference's tokens exactly, in
f32 and int8.
"""
import json
import struct
import time

import numpy as np
import pytest
import torch

from paddle_tpu.serving.fleet import FleetWorker as JaxWorker
from paddle_tpu.serving.fleet import LocalTransport as JaxTransport
from paddle_tpu.serving.generative import tiny_lm as jax_tiny_lm
from paddle_tpu_torch.core import sanitizer
from paddle_tpu_torch.core.flags import FLAGS
from paddle_tpu_torch.serving import (FleetWorker, GenerativeEngine,
                                      GenRequest, LocalTransport, tiny_lm)
from paddle_tpu_torch.serving.fleet import (M_MIGRATE, decode_call,
                                            encode_call, encode_migrate)

CFG_KW = dict(vocab=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              block_size=8, max_blocks=8, max_batch=4)
TOL = dict(atol=1e-4, rtol=1e-4)
PROMPT = [3, 9, 27, 17, 50, 8, 8, 1, 40, 22, 5, 61, 7]


@pytest.fixture(autouse=True, scope="module")
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def buffers_on():
    old = FLAGS.sanitizer
    FLAGS.sanitizer = "buffers"
    try:
        yield
    finally:
        FLAGS.sanitizer = old


def _worker(name, role, quant="", jax=False, kv_blocks=24):
    """One fleet worker of the port (on the CPU) or of the JAX package,
    registered with a LocalTransport of its own package."""
    if jax:
        cfg, params = jax_tiny_lm(3, **CFG_KW)
        w = JaxWorker(name, role, cfg, params, quant=quant,
                      kv_blocks=kv_blocks, warm=False,
                      transport=JaxTransport())
    else:
        cfg, params = tiny_lm(3, **CFG_KW)
        w = FleetWorker(name, role, cfg, params, quant=quant,
                        kv_blocks=kv_blocks, warm=False,
                        transport=LocalTransport(), device="cpu")
    w.transport.register(w)
    return w


def _pair(quant="", jax_side=()):
    """One prefill and one decode worker; ``jax_side`` names the roles
    built from the JAX package."""
    return [_worker(name, role, quant, role in jax_side)
            for name, role in (("mp0", "prefill"), ("md0", "decode"))]


def _migrate_frame(pw, rid, prompt, max_new=4, tear=False):
    """Run a real prefill + export on ``pw`` (either package's prefill
    worker) and capture the MigrateKV frame it would send (optionally
    torn mid-payload).  The capture SWALLOWS the delivery, so the test
    controls the first delivery itself."""
    calls = []
    orig_call = pw.transport.call

    def capture(addr, method, payload, timeout=None):
        if method != M_MIGRATE:
            return orig_call(addr, method, payload, timeout=timeout)
        calls.append(b"".join(payload) if isinstance(payload, (list, tuple))
                     else bytes(payload))
        return encode_call({"ok": True, "dup": False, "blocks": [],
                            "epoch": 1})

    pw.transport.call = capture
    try:
        rep = pw._op_prefill({"op": "prefill", "dest": "local:md0",
                              "req": {"id": rid, "prompt": prompt,
                                      "max_new": max_new, "eos": None}})
    finally:
        pw.transport.call = orig_call
    assert rep["ok"]
    frame, = calls
    if tear:
        frame = frame[:len(frame) - len(frame) // 4]
    return frame, rep


def _generate(dw, rid, prompt, max_new):
    dw._op_generate({"op": "generate",
                     "req": {"id": rid, "prompt": prompt,
                             "max_new": max_new, "eos": None}})
    got = dw._op_wait({"id": rid, "timeout": 120.0})
    assert got["done"]
    return got["result"]["tokens"]


def _shutdown(*workers):
    for w in workers:
        w.shutdown()


# ---------------------------------------- the reference's contracts

def test_double_free_of_migrated_block(buffers_on):
    """A second free of a migrated-away block set raises the NAMED
    error and leaves the free list uncorrupted: the next alloc hands
    out no duplicates."""
    pw, dw = _pair()
    try:
        pool = pw.engine.pool
        blocks = pool.alloc(3)
        pool.free(blocks)          # the migrated-away free (legitimate)
        free0 = pool.free_blocks
        trips0 = sanitizer.trips
        with pytest.raises(sanitizer.BufferLifetimeError,
                           match="kv_block"):
            pool.free(blocks)      # the double free
        assert sanitizer.trips == trips0 + 1
        assert pool.free_blocks == free0, "free list grew on a double free"
        seen = pool.alloc(free0)
        assert len(set(seen)) == free0, "duplicate ids after double free"
        pool.free(seen)
    finally:
        _shutdown(pw, dw)


def test_double_free_ignored_with_the_sanitizer_off():
    """With FLAGS_sanitizer off an unmatched decref is ignored, as in the
    reference: no error, and the free list does not grow."""
    pw, dw = _pair()
    try:
        pool = pw.engine.pool
        blocks = pool.alloc(2)
        pool.free(blocks)
        free0 = pool.free_blocks
        pool.free(blocks)
        assert pool.free_blocks == free0
    finally:
        _shutdown(pw, dw)


def test_migration_racing_inflight_dispatch(buffers_on):
    """export_blocks while a step owns the pages trips the epoch guard,
    instead of copying pages being rewritten under it."""
    pw, dw = _pair()
    eng = pw.engine
    try:
        blocks = eng.pool.alloc(2)
        eng._kv_guard.begin("decode", step=7)     # a step owns the pool
        try:
            with pytest.raises(sanitizer.BufferLifetimeError,
                               match="dispatch in flight"):
                eng.export_blocks(blocks)
        finally:
            eng._kv_guard.rebind()
            eng.pool.free(blocks)
        # quiesced: the same export now succeeds
        blocks = eng.pool.alloc(2)
        kp, vp, epoch = eng.export_blocks(blocks)
        assert kp.shape[1] == 2 and vp.shape[1] == 2
        assert epoch == eng.kv_epoch
        eng.check_kv_epoch(epoch)
        eng.pool.free(blocks)
    finally:
        _shutdown(pw, dw)


def test_steps_advance_the_epoch_under_the_sanitizer(buffers_on):
    """Every step that writes the pages (prefill, decode, COW copy,
    import) bumps the epoch, so a handle taken before it is stale."""
    pw, dw = _pair()
    eng = dw.engine
    try:
        blocks = eng.pool.alloc(2)
        _, _, e0 = eng.kv_pages()
        eng.prefill_tokens(PROMPT[:9], blocks)
        with pytest.raises(sanitizer.BufferLifetimeError,
                           match="stale epoch"):
            eng.check_kv_epoch(e0)
        e1 = eng.kv_epoch
        eng.decode_step([blocks], [9], [4])
        eng.copy_block(blocks[0], blocks[1])
        kp, vp, _ = eng.export_blocks(blocks)
        eng.import_blocks(blocks, kp, vp)
        assert eng.kv_epoch == e1 + 3
        eng.pool.free(blocks)
    finally:
        _shutdown(pw, dw)


def test_partial_migration_rollback():
    """A frame torn mid-payload comes back as a named ok=false reply
    (BufferLifetimeError carrying kv_migration:<rid>, "rolled back"),
    frees the destination's blocks, admits nothing and counts one
    sanitizer trip, whatever FLAGS_sanitizer says: a torn frame is data
    loss."""
    pw, dw = _pair()
    try:
        trips0 = sanitizer.trips
        frame, _ = _migrate_frame(pw, "tear1", list(range(5, 17)),
                                  tear=True)
        free0 = dw.engine.pool.free_blocks
        rep = decode_call(dw.handle(M_MIGRATE, memoryview(frame)))
        assert rep["ok"] is False
        assert rep["kind"] == "BufferLifetimeError"
        assert "kv_migration:tear1" in rep["error"]
        assert "rolled back" in rep["error"]
        assert dw.engine.pool.free_blocks == free0, \
            "torn migration stranded destination blocks"
        assert sanitizer.trips == trips0 + 1
        with dw._flock:
            assert "tear1" not in dw._futures, \
                "torn migration admitted a request"
    finally:
        _shutdown(pw, dw)


def test_migrate_dedup_and_parity():
    """The same migration delivered twice installs once (the second
    reply dup=true, no allocation), and the migrated-in decode finishes
    with a local generate's tokens; every block goes home after."""
    pw, dw = _pair()
    try:
        prompt = PROMPT[:9]
        frame, prep = _migrate_frame(pw, "dup1", prompt, max_new=6)
        rep1 = decode_call(dw.handle(M_MIGRATE, memoryview(frame)))
        assert rep1["ok"] and not rep1["dup"]
        # the epoch handshake: the destination's post-install epoch (0
        # with the sanitizer off: rebind advances only under buffers)
        assert rep1["epoch"] == dw.engine.kv_epoch
        dups0 = dw.migration_dups
        rep2 = decode_call(dw.handle(M_MIGRATE, memoryview(frame)))
        assert rep2["ok"] and rep2["dup"]
        assert dw.migration_dups == dups0 + 1 and dw.migrations == 1
        got = dw._op_wait({"id": "dup1", "timeout": 120.0})
        assert got["done"]
        migrated = got["result"]["tokens"]
        assert migrated[0] == prep["first"]
        assert migrated == _generate(dw, "ref1", prompt, 6), \
            "migrated-in decode diverged from local generate"
        for _ in range(200):
            if dw.engine.pool.used_blocks == 0:
                break
            time.sleep(0.01)
        assert dw.engine.pool.used_blocks == 0
        assert pw.engine.pool.used_blocks == 0
        st = decode_call(dw.handle(11, memoryview(encode_call(
            {"op": "status"}))))
        assert st["counters"] == {"migrations": 1, "migration_dups": 1}
    finally:
        _shutdown(pw, dw)


def test_migrate_geometry_mismatch_rejected():
    """A frame whose kv header disagrees with the destination's geometry
    is refused before any allocation."""
    pw, dw = _pair()
    try:
        frame, _ = _migrate_frame(pw, "geo1", list(range(9)))
        view = memoryview(bytes(frame))
        (hlen,) = struct.unpack("<I", view[:4])
        head = json.loads(bytes(view[4:4 + hlen]).decode())
        head["kv"]["n_heads"] = 5
        free0 = dw.engine.pool.free_blocks
        bad = encode_migrate(head, b"", b"")
        rep = decode_call(dw.handle(
            M_MIGRATE, memoryview(b"".join(bad) + bytes(view[4 + hlen:]))))
        assert rep["ok"] is False and rep["kind"] == "ValueError"
        assert "geometry" in rep["error"]
        assert dw.engine.pool.free_blocks == free0
    finally:
        _shutdown(pw, dw)


# ------------------------------------------------- import_blocks itself

def _engine(**kw):
    cfg, params = tiny_lm(3, **CFG_KW)
    return GenerativeEngine(cfg, params, kv_blocks=24, device="cpu",
                            warm=False, name="imp", **kw)


def test_import_writes_the_pages_in_place():
    """import_blocks writes into the page tensors (same storage before
    and after), touches no other block, and a decode step built before
    the import reads the imported pages: its token equals the one after
    a local prefill of the same prompt."""
    src, dst = _engine(), _engine()
    try:
        prompt = PROMPT
        nb = src.pool.blocks_for(len(prompt) + 1)
        sb = src.pool.alloc(nb)
        first = src.prefill_tokens(prompt, sb)
        kp, vp, _ = src.export_blocks(sb)
        step = dst._decode.get(dst._decode.pick((1, 2))[0])
        ptrs = [t.untyped_storage().data_ptr() for t in (dst._kp, dst._vp)]
        before = [t.clone() for t in (dst._kp, dst._vp)]
        db = dst.pool.alloc(nb)
        dst.import_blocks(db, kp, vp)
        assert [t.untyped_storage().data_ptr()
                for t in (dst._kp, dst._vp)] == ptrs
        others = [b for b in range(24) if b not in db]
        for t, b0, got in zip((dst._kp, dst._vp), before, (kp, vp)):
            assert torch.equal(t[:, others], b0[:, others])
            assert torch.equal(t[:, db], torch.from_numpy(got))
        assert dst._decode.get((1, 2)) is step
        tok = dst.decode_step([db], [len(prompt)], [first])
        want = src.decode_step([sb], [len(prompt)], [first])
        assert tok.tolist() == want.tolist()
    finally:
        src.close()
        dst.close()


@pytest.mark.parametrize("case", ["block0", "shape", "dtype"])
def test_import_refusals(case):
    """Block 0 is refused with ValueError; pages of another shape or
    dtype trip the sanitizer naming the pool, before any write."""
    eng = _engine()
    try:
        shape = (2, 2, 8, 2, 16)
        k = np.ones(shape, np.float32)
        blocks = eng.pool.alloc(2)
        before = eng._kp.clone()
        if case == "block0":
            with pytest.raises(ValueError, match="reserved block 0"):
                eng.import_blocks([0, blocks[0]], k, k)
        else:
            bad = np.ones((2, 3, 8, 2, 16), np.float32) if case == "shape" \
                else k.astype(np.float64)
            with pytest.raises(sanitizer.BufferLifetimeError,
                               match="kv_pool:imp"):
                eng.import_blocks(blocks, k, bad)
        assert torch.equal(eng._kp, before)
    finally:
        eng.close()


# ---------------------------------------------- across the two packages

def _prefill_export(w):
    """``w``'s engine prefills PROMPT and exports its pages: (k, v, first
    token)."""
    from concurrent.futures import Future

    from paddle_tpu.serving.generative import GenRequest as JaxRequest

    eng = w.engine
    cls = GenRequest if isinstance(w, FleetWorker) else JaxRequest
    seq = cls(PROMPT, 4, None, Future())
    seq.blocks = eng.pool.alloc(eng.pool.blocks_for(len(PROMPT)))
    try:
        first = eng.prefill(seq)
        k, v, _ = eng.export_blocks(seq.blocks)
    finally:
        eng.free_sequence(seq)
    return np.asarray(k), np.asarray(v), int(first)


@pytest.mark.parametrize("quant", ["", "int8"])
def test_export_pages_match_the_jax_engine(quant):
    """The same prompt prefilled by each package's prefill worker: the
    exported K/V pages agree within atol = rtol = 1e-4 and the first
    tokens are equal."""
    jp = _worker("mp0", "prefill", quant, jax=True)
    pp = _worker("mp0", "prefill", quant)
    try:
        (jk, jv, jt), (pk, pv, pt) = _prefill_export(jp), \
            _prefill_export(pp)
        assert jt == pt
        assert jk.shape == pk.shape == (2, 2, 8, 2, 16)
        np.testing.assert_allclose(pk, jk, **TOL)
        np.testing.assert_allclose(pv, jv, **TOL)
    finally:
        _shutdown(jp, pp)


@pytest.mark.parametrize("quant", ["", "int8"])
@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_frames_cross_the_packages(direction, quant):
    """A MigrateKV frame written by one package's prefill worker,
    installed by the other's decode worker: the migrated-in decode gives
    the tokens of the JAX decode worker's own local generate exactly,
    and the port's local generate agrees."""
    jax_side = ("prefill",) if direction == "jax_to_port" else ("decode",)
    pw, dw = _pair(quant=quant, jax_side=jax_side)
    jref = dw if "decode" in jax_side else _worker("jd", "decode", quant,
                                                   jax=True)
    pref = _worker("pd", "decode", quant)
    try:
        frame, prep = _migrate_frame(pw, "x1", PROMPT, max_new=8)
        rep = decode_call(dw.handle(M_MIGRATE, memoryview(frame)))
        assert rep["ok"] and not rep["dup"], rep
        got = dw._op_wait({"id": "x1", "timeout": 120.0})
        assert got["done"]
        tokens = got["result"]["tokens"]
        assert tokens[0] == prep["first"] and len(tokens) == 8
        want = _generate(jref, "ref", PROMPT, 8)
        assert tokens == want
        assert _generate(pref, "ref", PROMPT, 8) == want
    finally:
        _shutdown(*{pw, dw, jref, pref})
