"""Socket request plane: the fastwire-framed Predict method.

Counterpart of ``paddle_tpu/serving/wire.py``, byte for byte on the
wire: a client or endpoint of either package talks to one of the other.
Framing is the fastwire protocol (``distributed/fastwire.py`` — magic
``FW1\\n`` both directions once per connection, then per message
``u8 method | u64 len | payload`` with a ``u64 len | payload`` reply),
with method ``Predict`` (5) of ``fastwire.METHODS``.  Pure Python
sockets: the predict payloads are request-sized (KBs).

Payload encoding (both directions):
    u32 head_len | json head (utf-8) | raw tensor bytes back-to-back
request head  {"model": str, "inputs": [{"name","dtype","shape"}...]}
reply head    {"ok": true, "outputs": [{"name","dtype","shape"}...]}
           or {"ok": false, "error": str}
Tensor bytes are C-order; sizes derive from shape x dtype, so the head
carries no lengths.
"""
from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time

import numpy as np

from paddle_tpu_torch.distributed.fastwire import MAGIC, METHODS

__all__ = ["PredictEndpoint", "PredictClient", "RemoteError",
           "encode_request", "decode_request", "encode_reply",
           "decode_reply"]

_PREDICT = METHODS["Predict"]

# PredictClient connection failures absorbed by reconnect + resend, in
# this process (the JAX package's serve_conn_failures_total, as a plain
# count): a client quietly riding reconnects must stay visible
CONN_FAILURES = 0
_CONN_LOCK = threading.Lock()


def _count_conn_failure():
    global CONN_FAILURES
    with _CONN_LOCK:
        CONN_FAILURES += 1


class RemoteError(RuntimeError):
    """The server answered with ok=false; the message is the remote
    exception text."""


# -- payload codec ------------------------------------------------------

def _pack(head, arrays):
    hj = json.dumps(head).encode()
    return b"".join([struct.pack("<I", len(hj)), hj] +
                    [a.tobytes() for a in arrays])


def _unpack(view):
    view = memoryview(view)
    (hlen,) = struct.unpack("<I", view[:4])
    head = json.loads(bytes(view[4:4 + hlen]).decode())
    off = 4 + hlen
    tensors = {}
    for spec in head.get("inputs") or head.get("outputs") or ():
        dt = np.dtype(spec["dtype"])
        shape = tuple(spec["shape"])
        n = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        arr = np.frombuffer(view[off:off + n], dt).reshape(shape)
        tensors[spec["name"]] = arr
        off += n
    return head, tensors


def encode_request(model, feed):
    arrays = [np.ascontiguousarray(np.asarray(v)) for v in feed.values()]
    head = {"model": str(model),
            "inputs": [{"name": k, "dtype": a.dtype.name,
                        "shape": list(a.shape)}
                       for k, a in zip(feed, arrays)]}
    return _pack(head, arrays)


def decode_request(view):
    head, tensors = _unpack(view)
    return head["model"], tensors


def encode_reply(outputs=None, error=None):
    if error is not None:
        return _pack({"ok": False, "error": str(error)}, [])
    arrays = [np.ascontiguousarray(np.asarray(v))
              for v in outputs.values()]
    head = {"ok": True,
            "outputs": [{"name": k, "dtype": a.dtype.name,
                         "shape": list(a.shape)}
                        for k, a in zip(outputs, arrays)]}
    return _pack(head, arrays)


def decode_reply(view):
    head, tensors = _unpack(view)
    if not head.get("ok"):
        raise RemoteError(head.get("error", "unknown server error"))
    return tensors


# -- socket plumbing ----------------------------------------------------

def _recv_exact(sock, n):
    buf = np.empty(n, np.uint8)     # np.empty: bytearray(n) zeroes
    view = memoryview(buf)
    got = 0
    while got < n:
        r = sock.recv_into(view[got:], n - got)
        if r == 0:
            raise ConnectionError("peer closed (%d of %d)" % (got, n))
        got += r
    return memoryview(buf)


class PredictEndpoint:
    """Accept loop + one thread per connection; each connection serves
    requests sequentially (clients that want in-flight parallelism open
    more connections, one a client thread), and every
    request goes through ``server.submit`` so the continuous batcher
    coalesces across ALL connections."""

    def __init__(self, server, host="127.0.0.1", port=0):
        self._server = server
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(256)
        self.host, self.port = self._sock.getsockname()[:2]
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._accept_loop,
                                        daemon=True,
                                        name="serve-endpoint")
        self._thread.start()

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
                    return                    # orderly client close
                method, ln = struct.unpack("<BQ", head)
                payload = _recv_exact(conn, ln)
                if method != _PREDICT:
                    return
                try:
                    model, feed = decode_request(payload)
                    # copy out of the recv buffer: the batcher holds
                    # the feed beyond this loop iteration
                    feed = {k: np.array(v) for k, v in feed.items()}
                    outs = self._server.predict(model, feed)
                    reply = encode_reply(outputs=outs)
                except Exception as e:
                    reply = encode_reply(error="%s: %s"
                                         % (type(e).__name__, e))
                conn.sendall(struct.pack("<Q", len(reply)) + reply)
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


class PredictClient:
    """One connection, sequential predict() calls (not thread-safe —
    one client per thread, like a connection checked out of
    FastConnPool).

    A connection death mid-request (ECONNRESET, broken pipe, a server
    restart between calls) is absorbed, not surfaced: the client
    reconnects with capped jittered exponential backoff and RESENDS the
    whole request on the fresh connection.  Predict is read-only
    against the model, so a resend after a torn reply at worst computes
    the same answer twice — never a duplicated side effect.  Failures
    count in ``serve_conn_failures_total`` (always-on registry);
    ``max_attempts`` exhausted re-raises the last socket error."""

    def __init__(self, host, port, timeout=60.0, max_attempts=4,
                 base_backoff=0.05, max_backoff=2.0):
        self._host, self._port = host, int(port)
        self._timeout = timeout
        self._max_attempts = max(1, int(max_attempts))
        self._base_backoff = float(base_backoff)
        self._max_backoff = float(max_backoff)
        self._rng = random.Random()
        self._sock = None
        self._connect()

    def _connect(self):
        sock = socket.create_connection((self._host, self._port),
                                        timeout=self._timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            sock.sendall(MAGIC)
            if bytes(_recv_exact(sock, len(MAGIC))) != MAGIC:
                raise ConnectionError("not a fastwire predict endpoint")
        except BaseException:
            sock.close()
            raise
        self._sock = sock

    def predict(self, model, feed):
        payload = encode_request(model, feed)
        attempt = 0
        while True:
            try:
                if self._sock is None:
                    self._connect()
                self._sock.sendall(struct.pack("<BQ", _PREDICT,
                                               len(payload)))
                self._sock.sendall(payload)
                (ln,) = struct.unpack("<Q", _recv_exact(self._sock, 8))
                outs = decode_reply(_recv_exact(self._sock, ln))
                # own the buffers (the recv view wraps a reusable array)
                return {k: np.array(v) for k, v in outs.items()}
            except RemoteError:
                raise                   # the server ANSWERED; no resend
            except OSError:
                # covers ConnectionError/BrokenPipeError/timeouts; the
                # connection is in an unknown framing state either way
                _count_conn_failure()
                self.close()
                self._sock = None
                attempt += 1
                if attempt >= self._max_attempts:
                    raise
                span = min(self._max_backoff,
                           self._base_backoff * (2 ** (attempt - 1)))
                time.sleep(span * self._rng.uniform(0.5, 1.0))

    def close(self):
        if self._sock is None:
            return
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
