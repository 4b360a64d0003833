"""Disaggregated serving fleet: prefill workers, decode workers, and
the MigrateKV handoff between them.

Counterpart of ``paddle_tpu/serving/fleet.py``, on the same wire, so a
worker of either package installs the other's frames:

- **Prefill workers** (``FleetWorker(role='prefill')``) run only the
  prompt pass: prefill through the engine's captured prefill ladder
  (K1), export the prompt's KV pages to host memory
  (``GenerativeEngine.export_blocks``), free the local blocks
  (migrated away), and push the pages to a decode worker over fastwire
  method ``MigrateKV``.
- **Decode workers** (``role='decode'``) wrap the same engine and a
  DecodeLoop; a migrated request joins the continuous batch WITHOUT a
  prefill (``TokenScheduler`` / ``DecodeLoop`` admit it by its
  resident blocks) and every decode step runs K7 over its pages.  Each
  worker keeps a request-id -> future table, so a hedged or re-sent
  migration is installed once (exactly-once per worker) and ``wait``
  can be called from any router attempt.  ``generate`` is the local
  prefill fallback.
- **Torn migrations are named**: a payload whose size disagrees with
  the header's block table rolls back the destination's blocks and
  answers ``BufferLifetimeError`` naming ``kv_migration:<req_id>``;
  the page install itself is bracketed by the engine's epoch guard.

Workers run as separate processes (``python -m
paddle_tpu_torch.serving.fleet --role decode --name d0``) speaking the
fastwire framing over TCP (``FleetEndpoint`` / ``SocketTransport``), or
in one process behind ``LocalTransport`` with the same byte codec.
All workers of one process share its card.  The router in front is
``router.FleetRouter``.

Wire formats (the reference's MIGRATION.md "MigrateKV wire contract"):

``FleetCall`` (method 11)   u32 head_len | json head   (both directions)
``MigrateKV`` (method 10)   u32 head_len | json head | K pages | V pages
  head: {"v": 1, "req": {"id","prompt","first","max_new","eos"},
         "kv": {"n_blocks","block_size","n_layers","n_heads",
                "head_dim","dtype"},
         "epoch": <source kv epoch>, "src": <worker name>}
  pages: C-order fp32 ``[L, n_blocks, bs, H, d]``, K then V.
  reply: u32 head_len | json {"ok": true, "blocks": [...],
         "epoch": <dest post-install epoch>}

The reference's metrics become worker attributes: ``migrations``,
``migration_dups`` and ``migrate_ms`` (each MigrateKV send to ack, ms,
on the prefill side).  Not in this port: the weaver's yield point at
the wire, and ``status``'s SLO alerts (always ``[]``).
"""
from __future__ import annotations

import argparse
import json
import os
import signal
import socket
import struct
import sys
import threading
import time
from concurrent.futures import Future

import numpy as np

from ..core import sanitizer as _san
from ..core.flags import FLAGS
from ..distributed.fastwire import MAGIC, METHODS
from ..distributed.resilience import InjectedFault, fault_point
from .batcher import RequestQueue
from .generative import DecodeLoop, GenerativeEngine, GenRequest, tiny_lm

__all__ = ["FleetWorker", "FleetEndpoint", "SocketTransport",
           "LocalTransport", "FleetRemoteError", "Draining",
           "PoolExhausted", "encode_call", "decode_call", "encode_migrate",
           "M_MIGRATE", "M_CALL"]

M_MIGRATE = METHODS["MigrateKV"]
M_CALL = METHODS["FleetCall"]


class FleetRemoteError(RuntimeError):
    """A worker answered ok=false.  ``kind`` is the remote exception
    class name; ``retryable`` mirrors RetryPolicy's classification:
    transient serving states (draining, pool pressure, a torn migration
    whose request is intact) retry on another worker, validation errors
    surface."""

    _RETRYABLE = ("Draining", "PoolExhausted", "BufferLifetimeError",
                  "InjectedFault", "ConnectionError", "TimeoutError")

    def __init__(self, kind, message):
        super().__init__("%s: %s" % (kind, message))
        self.kind = str(kind)
        self.retryable = self.kind in self._RETRYABLE


class Draining(RuntimeError):
    """Worker is draining; admission refused (retryable elsewhere)."""


class PoolExhausted(RuntimeError):
    """Worker's block pool cannot hold the request right now."""


# -- codec --------------------------------------------------------------

def encode_call(obj):
    hj = json.dumps(obj).encode()
    return struct.pack("<I", len(hj)) + hj


def decode_call(view):
    view = memoryview(view)
    (hlen,) = struct.unpack("<I", view[:4])
    return json.loads(bytes(view[4:4 + hlen]).decode())


def encode_migrate(head, k_bytes, v_bytes):
    """MigrateKV payload parts (send each; receivers reassemble by the
    frame length)."""
    hj = json.dumps(head).encode()
    return [struct.pack("<I", len(hj)), hj, k_bytes, v_bytes]


def _byte_view(pages):
    """A flat byte view of a C-contiguous numpy array, no copy."""
    return memoryview(np.ascontiguousarray(pages)).cast("B")


# -- transports ---------------------------------------------------------

def _recv_exact(sock, n):
    buf = np.empty(n, np.uint8)
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed (%d of %d)" % (got, n))
        got += r
    return memoryview(buf)


class SocketTransport:
    """Blocking fastwire-framed calls to ``host:port`` addresses, one
    pooled connection per outstanding call (a blocking ``wait`` holds
    its connection; parallel calls to the same worker open more)."""

    def __init__(self, timeout=60.0):
        self._timeout = float(timeout)
        self._idle = {}
        self._lock = threading.Lock()

    def _checkout(self, addr):
        with self._lock:
            conns = self._idle.get(addr)
            if conns:
                return conns.pop()
        host, port = addr.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)),
                                        timeout=self._timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(MAGIC)
            if bytes(_recv_exact(sock, len(MAGIC))) != MAGIC:
                raise ConnectionError("%s is not a fastwire endpoint"
                                      % addr)
        except BaseException:
            sock.close()
            raise
        return sock

    def call(self, addr, method, payload, timeout=None):
        parts = payload if isinstance(payload, (list, tuple)) \
            else [payload]
        total = sum(len(p) for p in parts)
        sock = self._checkout(addr)
        try:
            sock.settimeout(timeout if timeout is not None
                            else self._timeout)
            sock.sendall(struct.pack("<BQ", method, total))
            for p in parts:
                sock.sendall(p)
            (ln,) = struct.unpack("<Q", _recv_exact(sock, 8))
            reply = bytes(_recv_exact(sock, ln))
        except BaseException:
            sock.close()
            raise
        with self._lock:
            self._idle.setdefault(addr, []).append(sock)
        return reply

    def close(self):
        with self._lock:
            conns = [c for lst in self._idle.values() for c in lst]
            self._idle.clear()
        for c in conns:
            try:
                c.close()
            except OSError:
                pass


class LocalTransport:
    """In-process transport: the same byte codec, dispatched straight
    into the worker's handler, no sockets.  ``kill`` simulates a worker
    death: the worker stops serving and every call to it (one already
    blocked in ``wait`` included) raises ConnectionError, as a
    SIGKILL'd TCP peer does."""

    def __init__(self):
        self._workers = {}
        self._lock = threading.Lock()

    def register(self, worker):
        addr = "local:%s" % worker.name
        with self._lock:
            self._workers[addr] = worker
        return addr

    def kill(self, name):
        addr = "local:%s" % name
        with self._lock:
            worker = self._workers.get(addr)
        if worker is not None:
            worker.kill()

    def call(self, addr, method, payload, timeout=None):
        with self._lock:
            worker = self._workers.get(addr)
        if worker is None or worker.killed:
            raise ConnectionError("fleet worker %s is dead" % addr)
        if isinstance(payload, (list, tuple)):
            payload = b"".join(payload)
        return worker.handle(method, memoryview(payload))

    def close(self):
        pass


# -- the worker ---------------------------------------------------------

class FleetWorker:
    """One fleet member: a GenerativeEngine plus the fastwire-facing op
    surface.  ``role='prefill'`` serves the ``prefill`` op (prompt pass
    + MigrateKV push to a decode worker); ``role='decode'`` runs a
    DecodeLoop and serves ``generate`` (local prefill fallback),
    ``MigrateKV`` receive, and blocking ``wait``.  Both serve ``ping`` /
    ``status`` / ``drain``.  ``device`` is the engine's (None: cuda);
    ``warm`` captures the role's ladders (``warm_role``) at once."""

    def __init__(self, name, role, config, params, quant="",
                 kv_blocks=None, warm=True, transport=None,
                 call_timeout=60.0, device=None):
        if role not in ("prefill", "decode"):
            raise ValueError("role must be 'prefill'/'decode'")
        self.name = str(name)
        self.role = role
        self.transport = transport
        self._call_timeout = float(call_timeout)
        self.engine = GenerativeEngine(config, params, quant=quant,
                                       kv_blocks=kv_blocks,
                                       name="fleet-%s" % self.name,
                                       device=device, warm=False)
        # migrations installed and deduplicated here (decode), and each
        # MigrateKV send to ack in ms (prefill)
        self.migrations = 0
        self.migration_dups = 0
        self.migrate_ms = []
        self._draining = False
        self._killed = threading.Event()
        self._futures = {}
        self._flock = threading.Lock()
        # prefill admission bound: every call past this count queues on
        # the semaphore, so concurrent prompts cannot race the block
        # pool into exhaustion
        self._slots = threading.BoundedSemaphore(
            max(1, int(FLAGS.fleet_prefill_slots))) \
            if role == "prefill" else None
        try:
            if warm:
                self.engine.warm_role(role)
        except Exception:
            self.engine.close()
            raise
        if role == "decode":
            self._queue = RequestQueue()
            self._loop = DecodeLoop(self.engine, self._queue,
                                    label="fleet-%s" % self.name)
        else:
            self._queue = self._loop = None

    @property
    def killed(self):
        return self._killed.is_set()

    def kill(self):
        """Abrupt death (the LocalTransport kill drill): stop serving and
        abandon in-flight work; futures stay unresolved, as in a
        SIGKILL'd process.  The engine stays alive: ``shutdown`` closes
        it."""
        self._killed.set()
        if self._loop is not None:
            self._loop.stop(join=False)

    def shutdown(self):
        """Orderly local teardown (after drain or kill, or test
        cleanup)."""
        self._killed.set()
        if self._loop is not None:
            self._loop.stop()
        self.engine.close()

    def _count(self, attr):
        with self._flock:
            setattr(self, attr, getattr(self, attr) + 1)

    # -- transport-facing dispatch -------------------------------------

    def handle(self, method, payload):
        """One fastwire frame in, one reply payload out.  Never raises
        for op-level errors: they travel as ok=false replies the router
        classifies; an unknown method raises (the endpoint closes the
        connection)."""
        if method == M_MIGRATE:
            return self._handle_migrate(payload)
        if method == M_CALL:
            head = decode_call(payload)
            op = head.get("op")
            fn = getattr(self, "_op_%s" % op, None)
            if fn is None:
                return encode_call({"ok": False, "kind": "ValueError",
                                    "error": "unknown op %r" % (op,)})
            try:
                return encode_call(fn(head))
            except Exception as e:
                return encode_call({"ok": False,
                                    "kind": type(e).__name__,
                                    "error": str(e)})
        raise ValueError("unknown fleet method %d" % method)

    # -- control ops ---------------------------------------------------

    def _op_ping(self, head):
        return {"ok": True, "name": self.name, "role": self.role,
                "draining": self._draining}

    def _op_status(self, head):
        with self._flock:
            inflight = sum(1 for f in self._futures.values()
                           if not f.done())
            counters = {"migrations": self.migrations,
                        "migration_dups": self.migration_dups}
        return {"ok": True, "name": self.name, "role": self.role,
                "draining": self._draining, "inflight": inflight,
                "kv_free": self.engine.pool.free_blocks,
                "counters": counters, "slo_alerts": []}

    def _op_drain(self, head):
        """Graceful drain: stop admitting, finish the running decodes,
        then report done (the ``__main__`` worker exits 0 on it)."""
        self._draining = True
        deadline = time.monotonic() + float(head.get("timeout", 60.0))
        while time.monotonic() < deadline:
            with self._flock:
                busy = sum(1 for f in self._futures.values()
                           if not f.done())
            if not busy:
                return {"ok": True, "drained": True}
            time.sleep(0.02)
        return {"ok": False, "kind": "TimeoutError",
                "error": "drain timed out with requests in flight"}

    # -- prefill role --------------------------------------------------

    def _validate(self, prompt, max_new):
        cfg = self.engine.config
        if not prompt:
            raise ValueError("empty prompt")
        if len(prompt) > cfg.max_seq:
            raise ValueError("prompt length %d exceeds max_seq %d"
                             % (len(prompt), cfg.max_seq))
        if int(max_new) < 1:
            raise ValueError("max_new_tokens must be >= 1")
        bad = [t for t in prompt if not 0 <= int(t) < cfg.vocab]
        if bad:
            raise ValueError("prompt token %d outside vocab [0, %d)"
                             % (bad[0], cfg.vocab))

    def _op_prefill(self, head):
        """The disaggregated prompt pass: prefill locally, export the KV
        pages, free the local blocks (migrated away), push the pages to
        the decode worker named in ``dest`` via MigrateKV, and hand the
        first token back to the router."""
        if self.role != "prefill":
            raise ValueError("prefill op on a %s worker" % self.role)
        if self._draining:
            raise Draining("%s is draining" % self.name)
        req = head["req"]
        prompt = [int(t) for t in req["prompt"]]
        self._validate(prompt, req["max_new"])
        self._slots.acquire()        # bounded admission: see the flag
        try:
            fault_point("fleet_prefill")
            cfg = self.engine.config
            seq = GenRequest(prompt, req["max_new"], req.get("eos"),
                             Future())
            blocks = self.engine.pool.alloc(
                self.engine.pool.blocks_for(len(prompt)))
            if blocks is None:
                raise PoolExhausted(
                    "%s: no blocks for a %d-token prompt"
                    % (self.name, len(prompt)))
            seq.blocks = blocks
            try:
                first = self.engine.prefill(seq)
                kp, vp, epoch = self.engine.export_blocks(blocks)
            finally:
                # migrated away: the host export is the only live copy
                self.engine.free_sequence(seq)
            mhead = {"v": 1, "src": self.name, "epoch": int(epoch),
                     "req": {"id": req["id"], "prompt": prompt,
                             "first": int(first),
                             "max_new": int(req["max_new"]),
                             "eos": req.get("eos")},
                     "kv": {"n_blocks": len(blocks),
                            "block_size": cfg.block_size,
                            "n_layers": cfg.n_layers,
                            "n_heads": cfg.n_heads,
                            "head_dim": cfg.head_dim,
                            "dtype": "float32"}}
            k_bytes, v_bytes = _byte_view(kp), _byte_view(vp)
            migrate_error = dest_reply = None
            t0 = time.perf_counter()
            try:
                fault_point("fleet_migrate")
                try:
                    fault_point("fleet_migrate_tear")
                except InjectedFault:
                    # the crash-lab tear: full-size header, page body
                    # cut mid-payload; the receiver must roll back and
                    # name it
                    v_bytes = v_bytes[:len(v_bytes) // 2]
                reply = self.transport.call(
                    head["dest"], M_MIGRATE,
                    encode_migrate(mhead, k_bytes, v_bytes),
                    timeout=self._call_timeout)
                dest_reply = decode_call(reply)
                if not dest_reply.get("ok"):
                    migrate_error = dest_reply
            except Exception as e:
                migrate_error = {"kind": type(e).__name__,
                                 "error": str(e)}
            self.migrate_ms.append((time.perf_counter() - t0) * 1e3)
        finally:
            self._slots.release()
        return {"ok": True, "first": int(first), "epoch": int(epoch),
                "migrated": migrate_error is None,
                "dest_epoch": (dest_reply or {}).get("epoch"),
                "dup": bool((dest_reply or {}).get("dup")),
                "migrate_error": migrate_error}

    # -- decode role ---------------------------------------------------

    def _register(self, rid):
        """Reserve ``rid``'s future (exactly-once admission); None when
        it already exists (a hedge or retry replay)."""
        with self._flock:
            if rid in self._futures:
                return None
            fut = Future()
            self._futures[rid] = fut
            return fut

    def _op_generate(self, head):
        """Local-prefill fallback and re-prefill path: the whole request
        runs on this decode worker (greedy decode regenerates the tokens
        a migrated run would have produced)."""
        if self.role != "decode":
            raise ValueError("generate op on a %s worker" % self.role)
        if self._draining:
            raise Draining("%s is draining" % self.name)
        req = head["req"]
        prompt = [int(t) for t in req["prompt"]]
        self._validate(prompt, req["max_new"])
        fut = self._register(req["id"])
        if fut is None:
            return {"ok": True, "dup": True}
        self._queue.put(GenRequest(prompt, req["max_new"],
                                   req.get("eos"), fut))
        return {"ok": True, "dup": False}

    def _op_wait(self, head):
        """Block until ``id`` finishes (or ``timeout``); the router calls
        this on its own pooled connection per attempt."""
        rid = head["id"]
        deadline = time.monotonic() + float(head.get("timeout", 60.0))
        with self._flock:
            fut = self._futures.get(rid)
        if fut is None:
            raise KeyError("unknown request id %r" % (rid,))
        # event-based: hundreds of outstanding waits must not spin-poll
        # a core out from under the decode loop
        done = threading.Event()
        fut.add_done_callback(lambda _f: done.set())
        while True:
            if fut.done():
                err = fut.exception()
                if err is not None:
                    raise err
                return {"ok": True, "done": True,
                        "result": fut.result()}
            if self._killed.is_set():
                raise ConnectionError("worker killed")
            now = time.monotonic()
            if now >= deadline:
                return {"ok": True, "done": False}
            done.wait(timeout=min(0.25, deadline - now))

    def _handle_migrate(self, payload):
        """MigrateKV receive: allocate destination blocks, install the
        pages (``import_blocks``, in place, under the epoch guard), admit
        the request into the decode loop.  A payload shorter than the
        header's block table is a TORN migration: the destination blocks
        are freed (rollback) and the failure is a named
        BufferLifetimeError, never pages of garbage served as context."""
        try:
            view = memoryview(payload)
            (hlen,) = struct.unpack("<I", view[:4])
            head = json.loads(bytes(view[4:4 + hlen]).decode())
            if self.role != "decode":
                raise ValueError("MigrateKV sent to a %s worker"
                                 % self.role)
            if self._draining:
                raise Draining("%s is draining" % self.name)
            req = head["req"]
            rid = req["id"]
            kv = head["kv"]
            cfg = self.engine.config
            if (int(kv["block_size"]) != cfg.block_size
                    or int(kv["n_layers"]) != cfg.n_layers
                    or int(kv["n_heads"]) != cfg.n_heads
                    or int(kv["head_dim"]) != cfg.head_dim
                    or kv.get("dtype", "float32") != "float32"):
                raise ValueError("migration geometry %r does not match "
                                 "this worker's engine" % (kv,))
            with self._flock:
                if rid in self._futures:
                    self.migration_dups += 1
                    return encode_call({"ok": True, "dup": True})
            n_blocks = int(kv["n_blocks"])
            shape = (cfg.n_layers, n_blocks, cfg.block_size,
                     cfg.n_heads, cfg.head_dim)
            page_bytes = int(np.prod(shape, dtype=np.int64)) * 4
            blocks = self.engine.pool.alloc(n_blocks)
            if blocks is None:
                raise PoolExhausted("%s: no room for %d migrated blocks"
                                    % (self.name, n_blocks))
            try:
                off = 4 + hlen
                body = len(view) - off
                if body != 2 * page_bytes:
                    rollback, blocks = blocks, None
                    self.engine.pool.free(rollback)
                    _san.trip(
                        "kv_migration:%s" % rid, op="migrate_in",
                        site="%s: page body %d B != 2x%d B from the "
                             "block-table header (torn mid-payload; "
                             "%d dest blocks rolled back)"
                             % (self.name, body, page_bytes,
                                len(rollback)),
                        epoch=head.get("epoch"))
                k = np.frombuffer(view[off:off + page_bytes],
                                  np.float32).reshape(shape)
                v = np.frombuffer(view[off + page_bytes:
                                       off + 2 * page_bytes],
                                  np.float32).reshape(shape)
                dest_epoch = self.engine.import_blocks(blocks, k, v)
            except BaseException:
                if blocks is not None:
                    self.engine.pool.free(blocks)
                raise
            fut = self._register(rid)
            if fut is None:                  # a replay raced us in
                self.engine.pool.free(blocks)
                self._count("migration_dups")
                return encode_call({"ok": True, "dup": True})
            gr = GenRequest(req["prompt"], req["max_new"],
                            req.get("eos"), fut)
            gr.blocks = list(blocks)
            gr.context_len = len(gr.prompt)
            gr.out = [int(req["first"])]
            gr.t_first = gr.t_last = time.perf_counter()
            self._queue.put(gr)
            self._count("migrations")
            return encode_call({"ok": True, "dup": False,
                                "blocks": [int(b) for b in blocks],
                                "epoch": int(dest_epoch)})
        except Exception as e:
            return encode_call({"ok": False, "kind": type(e).__name__,
                                "error": str(e)})


# -- socket endpoint ----------------------------------------------------

class FleetEndpoint:
    """Accept loop + one thread per connection, serving MigrateKV and
    FleetCall frames into a FleetWorker.  Each connection is
    sequential: the router's transport opens one per outstanding
    call."""

    def __init__(self, worker, host="127.0.0.1", port=0):
        self._worker = worker
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(256)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._accept_loop, daemon=True,
            name="fleet-endpoint-%s" % worker.name)
        self._thread.start()

    @property
    def addr(self):
        return "%s:%d" % (self.host, self.port)

    def _accept_loop(self):
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return
            conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             daemon=True).start()

    def _serve_conn(self, conn):
        try:
            if bytes(_recv_exact(conn, len(MAGIC))) != MAGIC:
                return
            conn.sendall(MAGIC)
            while not self._stop.is_set():
                try:
                    head = _recv_exact(conn, 9)
                except ConnectionError:
                    return
                method, ln = struct.unpack("<BQ", head)
                payload = _recv_exact(conn, ln)
                try:
                    reply = self._worker.handle(method, payload)
                except ValueError:
                    return          # unknown method: raw-v1 close
                conn.sendall(struct.pack("<Q", len(reply)))
                conn.sendall(reply)
        except (ConnectionError, OSError):
            pass
        finally:
            conn.close()

    def stop(self):
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass


# -- subprocess worker entrypoint ---------------------------------------

def _env_int(name, default):
    return int(os.environ.get(name, default))


def worker_main(argv=None):
    """``python -m paddle_tpu_torch.serving.fleet --role decode --name
    d0``: build the model (``FLEETW_*`` env dims), bind a FleetEndpoint,
    print the READY line a spawner parses, and serve until drained (exit
    0) or killed.  On the card unless ``--device cpu``.  Model dims must match across the whole fleet:
    MigrateKV checks geometry, not weights."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--role", required=True,
                    choices=("prefill", "decode"))
    ap.add_argument("--name", required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--kv-blocks", type=int,
                    default=_env_int("FLEETW_KV_BLOCKS", 96))
    ap.add_argument("--max-batch", type=int,
                    default=_env_int("FLEETW_MAX_BATCH", 8))
    ap.add_argument("--quant", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    cfg, params = tiny_lm(
        _env_int("FLEETW_SEED", 3),
        vocab=_env_int("FLEETW_VOCAB", 64),
        d_model=_env_int("FLEETW_DMODEL", 128),
        n_heads=_env_int("FLEETW_HEADS", 4),
        n_layers=_env_int("FLEETW_LAYERS", 3),
        d_ff=_env_int("FLEETW_DFF", 256),
        block_size=_env_int("FLEETW_BLOCK", 16),
        max_blocks=_env_int("FLEETW_MAX_BLOCKS", 8),
        max_batch=args.max_batch)
    transport = SocketTransport()
    worker = FleetWorker(args.name, args.role, cfg, params,
                         quant=args.quant, kv_blocks=args.kv_blocks,
                         transport=transport, device=args.device)
    endpoint = FleetEndpoint(worker, host=args.host, port=args.port)
    print("FLEET_READY name=%s role=%s port=%d pid=%d"
          % (args.name, args.role, endpoint.port, os.getpid()),
          flush=True)
    signal.signal(signal.SIGTERM, lambda *a: worker._killed.set())
    try:
        while not (worker._draining or worker._killed.is_set()):
            time.sleep(0.05)
        if worker._draining:
            # drain already waited for in-flight work in _op_drain;
            # give the reply a beat to flush, then leave cleanly
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    endpoint.stop()
    return 0


if __name__ == "__main__":
    sys.exit(worker_main())
