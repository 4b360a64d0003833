"""The port's predict tier (``paddle_tpu_torch/serving``: ModelEngine,
Dispatcher, InferenceServer.load / submit / swap, the socket endpoint)
against the JAX package's, on the CPU.

The reference's cases (tests/test_serving.py, all but its serve_bench
smoke) for the port, with its metrics read off the port's plain counters
(``Dispatcher.batches``, ``ModelEngine.misses``), and:

- the port's InferenceServer and the reference's serve the same model
  directory: replies within 1e-5 (the same f32 math in another order);
- the wire: the two packages' request and reply frames are the same
  bytes, the port's PredictClient talks to the reference's
  PredictEndpoint and the reverse.

Every blocking call (a future, a join, a socket) has its own timeout.
"""
import threading
import time

import numpy as np
import pytest

import paddle_tpu_torch.fluid as fluid
from paddle_tpu_torch.serving import (InferenceServer, PredictClient,
                                      RemoteError, bucket_ladder)
from paddle_tpu_torch.serving import engine as engine_mod
from paddle_tpu_torch.serving import wire

D_IN, HIDDEN, D_OUT = 6, 5, 3
TIMEOUT = 60


def _server(**kw):
    return InferenceServer(device="cpu", **kw)


def _save_model(dirname, seed, aot_batch=1, fl=fluid):
    """Deterministic little fc model saved by ``fl``'s package; ``seed``
    differentiates the parameter draw between versions.  Returns a
    reference fn computing outputs through the plain executor path."""
    main, startup = fl.Program(), fl.Program()
    scope = fl.Scope() if fl is fluid else \
        __import__("paddle_tpu.core.scope", fromlist=["Scope"]).Scope()
    init = fl.initializer.UniformInitializer
    with fl.scope_guard(scope):
        with fl.program_guard(main, startup), fl.unique_name.guard():
            x = fl.layers.data(name="x", shape=[D_IN], dtype="float32")
            h = fl.layers.fc(x, size=HIDDEN, act="tanh",
                             param_attr=fl.ParamAttr(
                                 initializer=init(-0.5, 0.5, seed=seed)))
            out = fl.layers.fc(h, size=D_OUT, act="softmax",
                               param_attr=fl.ParamAttr(
                                   initializer=init(-0.5, 0.5,
                                                    seed=seed + 1)))
        exe = fl.Executor(fl.CPUPlace())
        exe.run(startup)
        fl.io.save_inference_model(
            dirname, ["x"], [out], exe, main_program=main,
            aot_feed_specs={"x": ((aot_batch, D_IN), "float32")})
        infer = main.clone(for_test=True)

    def ref(xs):
        with fl.scope_guard(scope):
            r, = exe.run(infer, feed={"x": np.asarray(xs)},
                         fetch_list=[out])
        return np.asarray(r)

    return ref


def _xs(rng, n=1):
    return rng.uniform(-1, 1, size=(n, D_IN)).astype(np.float32)


def _one(result):
    return next(iter(result.values()))


def _join(threads):
    for t in threads:
        t.join(TIMEOUT * 2)
    assert not any(t.is_alive() for t in threads), "thread hung"


# ---------------------------------------------------------------- unit

def test_bucket_ladder_is_the_references():
    from paddle_tpu.serving import engine as jengine

    for cap in (1, 2, 12, 16, 17):
        assert bucket_ladder(cap) == jengine.bucket_ladder(cap)
    assert bucket_ladder(16) == [1, 2, 4, 8, 16]
    assert bucket_ladder(12) == [1, 2, 4, 8, 12]


def test_request_validation(tmp_path):
    d = str(tmp_path / "m")
    _save_model(d, seed=3)
    with _server(max_batch=4) as srv:
        srv.load("m", d)
        rng = np.random.RandomState(0)
        with pytest.raises(KeyError):
            srv.submit("nope", {"x": _xs(rng)})
        with pytest.raises(ValueError):
            srv.submit("m", {})                       # missing feed
        with pytest.raises(ValueError):
            srv.submit("m", {"x": _xs(rng)[:, :3]})   # wrong sample dim
        with pytest.raises(ValueError):
            srv.submit("m", {"x": _xs(rng).astype(np.float64)})
        with pytest.raises(ValueError):
            srv.submit("m", {"x": _xs(rng, 5)})       # > max_batch
        with pytest.raises(ValueError):
            srv.load("m", d)                          # dup tenant
        with pytest.raises(TypeError):
            srv.generate("m", [1, 2], 4)              # a predict tenant


# ------------------------------------------------- correctness / e2e

def test_serial_bit_exact_vs_direct_aot(tmp_path):
    """max_wait=0 serial traffic forms batches of 1 on bucket 1 — the
    exported bucket, adopted from disk; the server's answers are BIT-exact
    with a direct run of that bucket's executable."""
    d = str(tmp_path / "m")
    _save_model(d, seed=5)
    rng = np.random.RandomState(1)
    with _server(max_batch=4, max_wait_us=0) as srv:
        eng = srv.load("m", d)
        assert eng.artifact_bucket == 1 and eng.warm_buckets == [1, 2, 4]
        direct = eng.executable(1)
        for _ in range(5):
            xs = _xs(rng)
            got = _one(srv.predict("m", {"x": xs}, timeout=TIMEOUT))
            np.testing.assert_array_equal(got, direct.run({"x": xs})[0])


def test_concurrent_clients_e2e(tmp_path):
    """Concurrent client threads over BOTH request planes (in-process
    futures + the fastwire-framed socket); every response matches the
    plain-executor reference for its own input."""
    d = str(tmp_path / "m")
    ref = _save_model(d, seed=7)
    errors = []
    with _server(max_batch=8, max_wait_us=2000) as srv:
        srv.load("m", d)
        port = srv.start_endpoint()

        def client(tid):
            rng = np.random.RandomState(100 + tid)
            try:
                cli = PredictClient("127.0.0.1", port, timeout=TIMEOUT) \
                    if tid % 3 == 0 else None
                for _ in range(12):
                    xs = _xs(rng)
                    got = _one(cli.predict("m", {"x": xs}) if cli else
                               srv.predict("m", {"x": xs}, timeout=TIMEOUT))
                    np.testing.assert_allclose(got, ref(xs), atol=1e-5)
                if cli is not None:
                    cli.close()
            except Exception as e:
                errors.append(e)

        ts = [threading.Thread(target=client, args=(i,)) for i in range(6)]
        for t in ts:
            t.start()
        _join(ts)
        assert srv._tenant("m").dispatcher.failed_batches == 0
    assert not errors, errors[0]


def test_wire_error_paths(tmp_path):
    d = str(tmp_path / "m")
    _save_model(d, seed=9)
    rng = np.random.RandomState(2)
    with _server(max_batch=4) as srv:
        srv.load("m", d)
        port = srv.start_endpoint()
        with pytest.raises(RuntimeError, match="already running"):
            srv.start_endpoint()
        with PredictClient("127.0.0.1", port, timeout=TIMEOUT) as cli:
            with pytest.raises(RemoteError, match="unknown model"):
                cli.predict("ghost", {"x": _xs(rng)})
            with pytest.raises(RemoteError, match="serve_max_batch"):
                cli.predict("m", {"x": _xs(rng, 9)})
            # the connection survives error replies
            assert _one(cli.predict("m", {"x": _xs(rng)})).shape == \
                (1, D_OUT)


# ------------------------------------------------- batching behavior

def test_deadline_launches_partial_batch(tmp_path):
    """A lone request launches when the max_wait deadline expires, never
    waiting for a full batch; a burst that FILLS the batch launches
    immediately, well before the deadline."""
    d = str(tmp_path / "m")
    _save_model(d, seed=11)
    rng = np.random.RandomState(3)
    wait_s = 0.3
    with _server(max_batch=4, max_wait_us=int(wait_s * 1e6)) as srv:
        srv.load("m", d)
        srv.predict("m", {"x": _xs(rng)}, timeout=TIMEOUT)   # warm
        disp = srv._tenant("m").dispatcher
        batches0, rows0 = disp.batches, disp.rows
        t0 = time.perf_counter()
        srv.predict("m", {"x": _xs(rng)}, timeout=TIMEOUT)
        lone = time.perf_counter() - t0
        assert wait_s * 0.5 <= lone < wait_s + 10.0, lone
        t0 = time.perf_counter()
        futs = [srv.submit("m", {"x": _xs(rng)}) for _ in range(4)]
        for f in futs:
            f.result(TIMEOUT)
        burst = time.perf_counter() - t0
        assert burst < wait_s * 0.5, \
            "full batch waited for the deadline (%.3fs)" % burst
        assert disp.batches - batches0 == 2, \
            "expected lone + one coalesced burst batch"
        # 1 row on bucket 1, 4 on bucket 4: no padding
        assert disp.rows - rows0 == 5 and disp.padding_rows == 0


def test_bucket_miss_falls_to_warm_and_backfills(tmp_path):
    """With only bucket 1 warm, a coalesced batch dispatches row-by-row
    on the warm bucket (right answers, the miss counted) while the ideal
    bucket builds in the background; once it lands, traffic uses it."""
    d = str(tmp_path / "m")
    ref = _save_model(d, seed=13, aot_batch=3)    # not on the ladder
    rng = np.random.RandomState(4)
    with _server(max_batch=8, max_wait_us=50000) as srv:
        eng = srv.load("m", d, warm=[1])
        assert eng.warm_buckets == [1] and eng.artifact_bucket is None
        inputs = [_xs(rng) for _ in range(6)]
        futs = [srv.submit("m", {"x": xs}) for xs in inputs]
        for xs, f in zip(inputs, futs):
            np.testing.assert_allclose(_one(f.result(TIMEOUT)), ref(xs),
                                       atol=1e-5)
        assert eng.misses > 0
        deadline = time.time() + TIMEOUT
        while time.time() < deadline and 8 not in eng.warm_buckets:
            time.sleep(0.05)
        assert 8 in eng.warm_buckets, "background bucket never landed"
        assert eng.compile_failures == 0 and eng.compile_error(8) is None
        futs = [srv.submit("m", {"x": xs}) for xs in inputs]
        for xs, f in zip(inputs, futs):
            np.testing.assert_allclose(_one(f.result(TIMEOUT)), ref(xs),
                                       atol=1e-5)


def test_unknown_warm_bucket_rejected(tmp_path):
    d = str(tmp_path / "m")
    _save_model(d, seed=15)
    with pytest.raises(ValueError, match="not on the ladder"):
        engine_mod.ModelEngine(d, device="cpu", max_batch=4, warm=[3])


# ------------------------------------------------------------- swap

def test_hot_swap_under_load_zero_dropped(tmp_path):
    """swap() under continuous traffic: every request completes, and
    every response is EXACTLY one model version — zero dropped, zero
    torn."""
    d1, d2 = str(tmp_path / "v1"), str(tmp_path / "v2")
    _save_model(d1, seed=21)
    _save_model(d2, seed=87)
    xs = _xs(np.random.RandomState(5))
    results, errors = [], []
    lock = threading.Lock()
    stop = threading.Event()
    with _server(max_batch=8, max_wait_us=1000) as srv:
        srv.load("m", d1)
        ref_v1 = _one(srv.predict("m", {"x": xs}, timeout=TIMEOUT))

        def drain(futs):
            for f in futs:
                try:
                    out = np.asarray(_one(f.result(TIMEOUT)))
                    with lock:
                        results.append(out)
                except Exception as e:
                    with lock:
                        errors.append(e)
            del futs[:]

        def load_gen():
            futs = []
            while not stop.is_set():
                futs.append(srv.submit("m", {"x": xs}))
                if len(futs) >= 16:
                    drain(futs)
                time.sleep(0.001)
            drain(futs)

        gen = threading.Thread(target=load_gen)
        gen.start()
        time.sleep(0.15)              # traffic flowing on v1
        old = srv.engine("m")
        new = srv.swap("m", d2)       # shadow build + atomic flip
        assert srv.engine("m") is new and new is not old
        time.sleep(0.15)              # traffic flowing on v2
        stop.set()
        _join([gen])
        ref_v2 = _one(srv.predict("m", {"x": xs}, timeout=TIMEOUT))
    assert not errors, "dropped/failed requests: %r" % errors[:3]
    assert not np.allclose(ref_v1, ref_v2, atol=1e-5)
    v1 = sum(1 for o in results if np.allclose(o, ref_v1, atol=1e-5))
    v2 = sum(1 for o in results if np.allclose(o, ref_v2, atol=1e-5))
    assert v1 + v2 == len(results), "torn: %d of %d" % (
        len(results) - v1 - v2, len(results))
    assert v1 > 0 and v2 > 0, (v1, v2)


def test_multi_tenant_isolation(tmp_path):
    d1, d2 = str(tmp_path / "a"), str(tmp_path / "b")
    ref_a = _save_model(d1, seed=31)
    ref_b = _save_model(d2, seed=77)
    xs = _xs(np.random.RandomState(6))
    with _server(max_batch=4, max_wait_us=0) as srv:
        srv.load("a", d1)
        srv.load("b", d2)
        assert srv.models() == ["a", "b"]
        got_a = _one(srv.predict("a", {"x": xs}, timeout=TIMEOUT))
        got_b = _one(srv.predict("b", {"x": xs}, timeout=TIMEOUT))
        srv.unload("a")
        assert srv.models() == ["b"]
    np.testing.assert_allclose(got_a, ref_a(xs), atol=1e-5)
    np.testing.assert_allclose(got_b, ref_b(xs), atol=1e-5)
    assert not np.allclose(got_a, got_b, atol=1e-5)


def test_cross_row_fetch_rejected_at_load(tmp_path):
    """A fetch without a leading batch dim cannot be sliced back per
    request: the engine refuses the model at load."""
    d = str(tmp_path / "m")
    main, startup = fluid.Program(), fluid.Program()
    scope = fluid.Scope()
    with fluid.scope_guard(scope):
        with fluid.program_guard(main, startup), fluid.unique_name.guard():
            x = fluid.layers.data(name="x", shape=[D_IN], dtype="float32")
            scalar = fluid.layers.mean(fluid.layers.fc(x, size=D_OUT))
        exe = fluid.Executor(fluid.CPUPlace())
        exe.run(startup)
        fluid.io.save_inference_model(d, ["x"], [scalar], exe,
                                      main_program=main)
    with _server(max_batch=4) as srv:
        with pytest.raises(ValueError, match="batch dim leading"):
            srv.load("m", d)
        assert srv.models() == []


def test_dispatcher_survives_launch_failure(tmp_path):
    """An exception escaping the launch path fails THAT batch's futures
    and leaves the dispatcher alive for later traffic."""
    d = str(tmp_path / "m")
    ref = _save_model(d, seed=41)
    rng = np.random.RandomState(8)
    with _server(max_batch=4, max_wait_us=0) as srv:
        engine = srv.load("m", d)
        orig = engine.pick_bucket
        trips = {"n": 0}

        def bomb(rows):
            trips["n"] += 1
            raise RuntimeError("synthetic scheduler fault")

        engine.pick_bucket = bomb
        fut = srv.submit("m", {"x": _xs(rng)})
        with pytest.raises(RuntimeError, match="synthetic"):
            fut.result(TIMEOUT)
        engine.pick_bucket = orig
        assert trips["n"] == 1
        assert srv._tenant("m").dispatcher.failed_batches == 1
        xs = _xs(rng)
        got = _one(srv.predict("m", {"x": xs}, timeout=TIMEOUT))
        np.testing.assert_allclose(got, ref(xs), atol=1e-5)


# --------------------------------------------- against the JAX package

def test_server_matches_reference_server(tmp_path):
    """The port's InferenceServer and the reference's, each over the
    directory the other package saved and its own: replies within 1e-5
    across buckets 1-8."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.serving import InferenceServer as JaxServer

    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}
    _save_model(dirs["jax"], seed=51, fl=jfluid)
    _save_model(dirs["port"], seed=51)
    rng = np.random.RandomState(9)
    reqs = [_xs(rng, n) for n in (1, 3, 8, 2)]
    with _server(max_batch=8, max_wait_us=0) as tsrv, \
            JaxServer(max_batch=8, max_wait_us=0) as jsrv:
        for name, d in dirs.items():
            tsrv.load(name, d)
            jsrv.load(name, d)
        for name in dirs:
            for xs in reqs:
                got = _one(tsrv.predict(name, {"x": xs}, timeout=TIMEOUT))
                want = _one(jsrv.predict(name, {"x": xs}, timeout=TIMEOUT))
                np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5,
                                           atol=1e-6)


def test_wire_frames_are_the_references():
    from paddle_tpu.serving import wire as jwire

    rng = np.random.RandomState(10)
    feed = {"x": _xs(rng, 3), "ids": rng.randint(0, 9, (3, 4))}
    assert wire.encode_request("m", feed) == jwire.encode_request("m", feed)
    outs = {"p": _xs(rng, 2), "k": np.arange(6, dtype=np.int64)}
    assert wire.encode_reply(outputs=outs) == jwire.encode_reply(outputs=outs)
    assert wire.encode_reply(error="E: x") == jwire.encode_reply(error="E: x")
    model, got = wire.decode_request(jwire.encode_request("m", feed))
    assert model == "m"
    for k, v in feed.items():
        np.testing.assert_array_equal(got[k], v)
    with pytest.raises(wire.RemoteError, match="E: x"):
        wire.decode_reply(jwire.encode_reply(error="E: x"))


@pytest.mark.parametrize("client,endpoint", [("port", "jax"),
                                             ("jax", "port")])
def test_wire_interop(client, endpoint, tmp_path):
    """The port's PredictClient against the reference's PredictEndpoint,
    and the reverse: the same answers as the endpoint's own predict."""
    import paddle_tpu.fluid as jfluid
    from paddle_tpu.serving import InferenceServer as JaxServer
    from paddle_tpu.serving import PredictClient as JaxClient

    d = str(tmp_path / "m")
    _save_model(d, seed=61, fl=jfluid if endpoint == "jax" else fluid)
    srv = JaxServer(max_batch=4, max_wait_us=0) if endpoint == "jax" \
        else _server(max_batch=4, max_wait_us=0)
    cli_cls = PredictClient if client == "port" else JaxClient
    rng = np.random.RandomState(11)
    with srv:
        srv.load("m", d)
        port = srv.start_endpoint()
        with cli_cls("127.0.0.1", port, timeout=TIMEOUT) as cli:
            for n in (1, 4):
                xs = _xs(rng, n)
                got = _one(cli.predict("m", {"x": xs}))
                want = _one(srv.predict("m", {"x": xs}, timeout=TIMEOUT))
                np.testing.assert_array_equal(got, np.asarray(want))
            exc = RemoteError if client == "port" else \
                __import__("paddle_tpu.serving", fromlist=["RemoteError"]
                           ).RemoteError
            with pytest.raises(exc, match="unknown model"):
                cli.predict("ghost", {"x": _xs(rng)})


def test_client_counts_a_reconnect(tmp_path):
    """A connection that dies between calls is absorbed: the client
    reconnects, resends, and counts the failure."""
    d = str(tmp_path / "m")
    _save_model(d, seed=71)
    rng = np.random.RandomState(12)
    with _server(max_batch=4, max_wait_us=0) as srv:
        srv.load("m", d)
        port = srv.start_endpoint()
        with PredictClient("127.0.0.1", port, timeout=TIMEOUT,
                           base_backoff=0.01) as cli:
            cli.predict("m", {"x": _xs(rng)})
            before = wire.CONN_FAILURES
            cli._sock.close()              # the connection dies
            assert _one(cli.predict("m", {"x": _xs(rng)})).shape == \
                (1, D_OUT)
            assert wire.CONN_FAILURES == before + 1
