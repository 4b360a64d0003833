"""Fleet router: cache-aware, health-aware placement over the prefill
and decode workers of ``serving/fleet.py``.

Counterpart of ``paddle_tpu/serving/router.py``.  Placement:

- **Prefix-affinity hashing**: prefill placement is rendezvous (HRW)
  hashing over the request's first FLAGS_fleet_prefix_tokens token ids,
  so requests sharing a prompt prefix land on the same prefill worker,
  and a membership change remaps only the dead worker's share.
- **Decode placement** is least-loaded: the live decode worker with the
  fewest router-tracked requests in flight (ties broken by rendezvous
  on the request id), behind a per-worker credit valve
  (FLAGS_fleet_decode_credits).

Health:

- **Lease-based membership**: a background sweep pings every member
  each FLAGS_fleet_lease_interval_s; a worker silent past
  FLAGS_fleet_lease_s is EVICTED, and its in-flight requests are
  re-prefilled on survivors.  Request-id dedup at the decode workers
  and the set-once future here keep a retried generation exactly-once
  from the caller's view.
- **Bounded retry + hedging**: each attempt loop is capped by
  FLAGS_fleet_max_attempts with RetryPolicy's capped jittered backoff;
  a request unfinished after FLAGS_fleet_hedge_s gets a second
  independent attempt, first completion wins.
- **Graceful drain**: ``drain(name)`` removes the worker from routing,
  then asks it to finish its running decodes.

The reference's metrics are router attributes here: the counts
``requests``, ``reprefills``, ``hedges``, ``migration_failures``; the
lists ``ttft_ms`` and ``request_ms`` (router arrival to the first token
known at the router, and to the result), and ``ttft_ms_by_worker``
(per decode replica); ``workers_live`` and ``availability`` (live /
expected members, recomputed each sweep); and ``evictions``, one entry
per eviction in place of the reference's flight-recorder dump:
``{"reason": "fleet:eviction:<worker>", "blocked": {...}}``.
"""
from __future__ import annotations

import threading
import time
import zlib
from concurrent.futures import Future

from ..core.flags import FLAGS
from ..distributed.resilience import DeadlineExceeded, RetryPolicy
from .fleet import M_CALL, FleetRemoteError, decode_call, encode_call

__all__ = ["FleetRouter", "default_fleet_slos"]


def default_fleet_slos(decode_names, ttft_p99_ms=2000.0):
    """The fleet SLO set, in the reference's FLAGS_slo_spec inline
    grammar: full availability plus a TTFT p99 objective per decode
    replica."""
    specs = ["serve_fleet_availability >= 1"]
    for name in decode_names:
        specs.append("fleet_ttft_ms_%s.p99 <= %g" % (name, ttft_p99_ms))
    return ",".join(specs)


class _Member:
    __slots__ = ("name", "addr", "role", "live", "last_ok", "ttft")

    def __init__(self, name, addr, role):
        self.name = name
        self.addr = addr
        self.role = role
        self.live = True
        self.last_ok = time.monotonic()
        # router-measured TTFT attributed to this decode replica, ms
        self.ttft = [] if role == "decode" else None


class _Rec:
    __slots__ = ("rid", "prompt", "max_new", "eos", "future", "done_evt",
                 "lock", "t_arrival", "t_first", "owner", "attempts",
                 "active", "last_error", "migrate_errors", "hedged",
                 "reprefilled")

    def __init__(self, rid, prompt, max_new, eos):
        self.rid = rid
        self.prompt = [int(t) for t in prompt]
        self.max_new = int(max_new)
        self.eos = eos
        self.future = Future()
        self.done_evt = threading.Event()
        self.lock = threading.Lock()
        self.t_arrival = time.perf_counter()
        self.t_first = None
        self.owner = None
        self.attempts = 0
        self.active = 0
        self.last_error = None
        self.migrate_errors = []
        self.hedged = False
        self.reprefilled = 0


class FleetRouter:
    """The process in front: accepts generate() calls, places them on
    the fleet, and survives member deaths.  ``workers`` is a list of
    ``(name, addr, role)``; ``transport`` is fleet.SocketTransport or
    fleet.LocalTransport."""

    def __init__(self, transport, workers, lease_s=None,
                 lease_interval_s=None, hedge_s=None, max_attempts=None,
                 deadline_s=None, call_timeout=60.0,
                 decode_credits=None):
        self.transport = transport
        self.lease_s = float(lease_s if lease_s is not None
                             else FLAGS.fleet_lease_s)
        self.lease_interval_s = float(
            lease_interval_s if lease_interval_s is not None
            else FLAGS.fleet_lease_interval_s)
        self.hedge_s = float(hedge_s if hedge_s is not None
                             else FLAGS.fleet_hedge_s)
        self.max_attempts = int(max_attempts if max_attempts is not None
                                else FLAGS.fleet_max_attempts)
        self.deadline_s = float(deadline_s if deadline_s is not None
                                else FLAGS.fleet_request_deadline_s)
        self.call_timeout = float(call_timeout)
        self._members = {}
        for name, addr, role in workers:
            self._members[name] = _Member(name, addr, role)
        self._expected = max(1, len(self._members))
        self._mlock = threading.Lock()
        self._recs = {}
        self._rlock = threading.Lock()
        self._rid_seq = 0
        self._inflight = {}          # decode name -> outstanding count
        self.credits = int(decode_credits if decode_credits is not None
                           else FLAGS.fleet_decode_credits)
        self._ccond = threading.Condition(self._rlock)
        self._retry = RetryPolicy(base_backoff=0.02, max_backoff=0.5)
        # the reference's counters, histograms and gauges
        self._stat_lock = threading.Lock()
        self.requests = 0
        self.reprefills = 0
        self.hedges = 0
        self.migration_failures = 0
        self.evictions = []
        self.ttft_ms = []
        self.request_ms = []
        self.ttft_ms_by_worker = {m.name: m.ttft
                                  for m in self._members.values()
                                  if m.ttft is not None}
        self.workers_live = 0
        self.availability = 0.0
        self._stop = threading.Event()
        self._refresh_gauges()
        self._lease_thread = threading.Thread(
            target=self._lease_loop, daemon=True, name="fleet-lease")
        self._lease_thread.start()

    def _bump(self, attr):
        with self._stat_lock:
            setattr(self, attr, getattr(self, attr) + 1)

    # -- membership ----------------------------------------------------

    def _live(self, role):
        with self._mlock:
            return [m for m in self._members.values()
                    if m.live and m.role == role]

    def _refresh_gauges(self):
        with self._mlock:
            live = sum(1 for m in self._members.values() if m.live)
        self.workers_live = live
        self.availability = live / float(self._expected)

    def _lease_loop(self):
        while not self._stop.wait(self.lease_interval_s):
            members = self._live("prefill") + self._live("decode")
            threads = [threading.Thread(target=self._ping, args=(m,),
                                        daemon=True) for m in members]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=self.lease_s + 1.0)
            now = time.monotonic()
            for m in members:
                if m.live and now - m.last_ok > self.lease_s:
                    self._evict(m, now - m.last_ok)
            self._refresh_gauges()

    def _ping(self, member):
        try:
            rep = decode_call(self.transport.call(
                member.addr, M_CALL, encode_call({"op": "ping"}),
                timeout=max(0.2, self.lease_s)))
            if rep.get("ok"):
                member.last_ok = time.monotonic()
        except Exception:
            pass

    def _evict(self, member, lease_age):
        member.live = False
        self._refresh_gauges()
        with self._ccond:
            orphans = [rec for rec in self._recs.values()
                       if rec.owner == member.name
                       and not rec.done_evt.is_set()]
            # dead worker's credits are void: wake queued acquirers so
            # they re-place on the survivors
            self._inflight[member.name] = 0
            self._ccond.notify_all()
        with self._stat_lock:
            self.evictions.append({
                "reason": "fleet:eviction:%s" % member.name,
                "blocked": {"worker": member.name, "addr": member.addr,
                            "role": member.role,
                            "lease_age_s": round(lease_age, 3),
                            "inflight_requeued": [r.rid for r in orphans]}})
        for rec in orphans:
            self._bump("reprefills")
            rec.reprefilled += 1
            with rec.lock:
                rec.active += 1
            threading.Thread(target=self._attempt_loop,
                             args=(rec, "evict"), daemon=True).start()

    # -- placement -----------------------------------------------------

    @staticmethod
    def _rendezvous(key, members):
        return max(members, key=lambda m: zlib.crc32(
            (key + "|" + m.name).encode()))

    def _pick_prefill(self, rec):
        live = self._live("prefill")
        if not live:
            return None
        k = int(FLAGS.fleet_prefix_tokens)
        key = ",".join(str(t) for t in rec.prompt[:k])
        return self._rendezvous(key, live)

    def _acquire_decode(self, rec, exclude=()):
        """Pick the least-loaded live decode worker AND take a dispatch
        credit on it: at most ``self.credits`` requests are outstanding
        per decode worker, and excess arrivals queue here, released in
        arrival order by the condition.  Blocks until a credit frees;
        None when the request resolved elsewhere, its deadline passed,
        the router is closing, or no decode worker is live at all."""
        deadline = rec.t_arrival + self.deadline_s
        with self._ccond:
            while True:
                if rec.done_evt.is_set() or self._stop.is_set():
                    return None
                live = [m for m in self._live("decode")
                        if m.name not in exclude]
                if not live:
                    live = self._live("decode")
                if not live:
                    return None
                ready = [m for m in live
                         if self._inflight.get(m.name, 0)
                         < self.credits]
                if ready:
                    lo = min(self._inflight.get(m.name, 0)
                             for m in ready)
                    tied = [m for m in ready
                            if self._inflight.get(m.name, 0) == lo]
                    m = self._rendezvous(rec.rid, tied)
                    self._inflight[m.name] = \
                        self._inflight.get(m.name, 0) + 1
                    return m
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    return None
                self._ccond.wait(min(0.25, remaining))

    def _release_decode(self, name):
        with self._ccond:
            self._inflight[name] = max(
                0, self._inflight.get(name, 0) - 1)
            self._ccond.notify_all()

    # -- the request path ----------------------------------------------

    def generate(self, prompt, max_new_tokens, eos_id=None, req_id=None):
        """Place one generate request on the fleet; returns a Future
        resolving to the worker's result dict plus routing metadata."""
        with self._rlock:
            self._rid_seq += 1
            rid = str(req_id) if req_id is not None \
                else "r%06d" % self._rid_seq
            if rid in self._recs:
                return self._recs[rid].future      # request-id dedup
            rec = _Rec(rid, prompt, max_new_tokens, eos_id)
            self._recs[rid] = rec
        self._bump("requests")
        with rec.lock:
            rec.active += 1
        threading.Thread(target=self._run_request, args=(rec,),
                         daemon=True).start()
        return rec.future

    def _run_request(self, rec):
        primary = threading.Thread(target=self._attempt_loop,
                                   args=(rec, "primary"), daemon=True)
        primary.start()
        if self.hedge_s > 0:
            if not rec.done_evt.wait(self.hedge_s) \
                    and not self._stop.is_set():
                self._bump("hedges")
                rec.hedged = True
                with rec.lock:
                    rec.active += 1
                self._attempt_loop(rec, "hedge")
        remaining = self.deadline_s - (time.perf_counter()
                                       - rec.t_arrival)
        if not rec.done_evt.wait(max(0.0, remaining)):
            self._fail(rec, DeadlineExceeded(
                "request %s exceeded %.1fs fleet deadline"
                % (rec.rid, self.deadline_s),
                last_error=rec.last_error, attempts=rec.attempts))

    def _attempt_loop(self, rec, tag):
        """One bounded dispatch loop (primary, hedge and post-eviction
        re-prefill all run this).  Never double-resolves: completion
        goes through the set-once _complete / _fail."""
        deadline = rec.t_arrival + self.deadline_s
        failed_on = set()
        attempt = 0
        try:
            while (not rec.done_evt.is_set()
                    and attempt < self.max_attempts
                    and time.perf_counter() < deadline):
                attempt += 1
                rec.attempts += 1
                dw = self._acquire_decode(
                    rec, exclude=failed_on if tag != "hedge"
                    else failed_on | {rec.owner})
                if dw is None:
                    if rec.done_evt.is_set():
                        return
                    rec.last_error = rec.last_error or RuntimeError(
                        "no live decode workers")
                    time.sleep(self._retry.backoff(attempt))
                    continue
                pf = self._pick_prefill(rec)
                try:
                    self._dispatch(rec, pf, dw)
                    return
                except FleetRemoteError as e:
                    rec.last_error = e
                    if not e.retryable:
                        self._fail(rec, e)
                        return
                    failed_on.add(dw.name)
                except (ConnectionError, TimeoutError, OSError) as e:
                    rec.last_error = e
                    failed_on.add(dw.name)
                time.sleep(self._retry.backoff(attempt))
        finally:
            with rec.lock:
                rec.active -= 1
                last = rec.active == 0
            if last and not rec.done_evt.is_set() \
                    and (rec.attempts >= self.max_attempts
                         or time.perf_counter() >= deadline):
                self._fail(rec, DeadlineExceeded(
                    "request %s failed after %d attempts (%s)"
                    % (rec.rid, rec.attempts, rec.last_error),
                    last_error=rec.last_error, attempts=rec.attempts))

    def _call(self, addr, head, timeout=None):
        rep = decode_call(self.transport.call(
            addr, M_CALL, encode_call(head),
            timeout=timeout if timeout is not None
            else self.call_timeout))
        if not rep.get("ok"):
            raise FleetRemoteError(rep.get("kind", "RuntimeError"),
                                   rep.get("error", "unknown"))
        return rep

    def _dispatch(self, rec, pf, dw):
        """One full attempt: disaggregated prefill + migrate when a
        prefill worker is live, local generate on the decode worker
        otherwise (also the fallback when the migration itself fails),
        then a blocking wait for the result."""
        req = {"id": rec.rid, "prompt": rec.prompt,
               "max_new": rec.max_new, "eos": rec.eos}
        rec.owner = dw.name
        # the dispatch credit was taken in _acquire_decode; released
        # (with a waiter wake-up) however this attempt ends
        try:
            migrated = False
            if pf is not None:
                # a dead or draining prefill worker must not sink the
                # request: the decode worker can prefill locally, so
                # every retryable prefill-leg failure degrades to the
                # fallback instead of burning a whole attempt
                try:
                    rep = self._call(pf.addr,
                                     {"op": "prefill", "req": req,
                                      "dest": dw.addr})
                except FleetRemoteError as e:
                    if not e.retryable:
                        raise
                    rec.migrate_errors.append(
                        {"kind": e.kind, "error": str(e)})
                    rep = None
                except (ConnectionError, TimeoutError, OSError) as e:
                    rec.migrate_errors.append(
                        {"kind": type(e).__name__, "error": str(e)})
                    rep = None
                if rep is not None:
                    self._note_first(rec, dw)
                    migrated = bool(rep.get("migrated"))
                    if not migrated:
                        self._bump("migration_failures")
                        rec.migrate_errors.append(
                            rep.get("migrate_error"))
            if not migrated:
                self._call(dw.addr, {"op": "generate", "req": req})
            remaining = max(0.5, rec.t_arrival + self.deadline_s
                            - time.perf_counter())
            rep = self._call(dw.addr,
                             {"op": "wait", "id": rec.rid,
                              "timeout": remaining},
                             timeout=remaining + 5.0)
            if not rep.get("done"):
                raise TimeoutError("request %s still running on %s"
                                   % (rec.rid, dw.name))
            self._note_first(rec, dw)
            self._complete(rec, dw, rep["result"])
        finally:
            self._release_decode(dw.name)

    def _note_first(self, rec, dw):
        """The first point the router KNOWS a first token exists for
        this request: the TTFT the fleet SLOs watch (per replica, so a
        killed replica's blip is attributable)."""
        if rec.t_first is not None:
            return
        rec.t_first = time.perf_counter()
        ttft = (rec.t_first - rec.t_arrival) * 1e3
        self.ttft_ms.append(ttft)
        if dw.ttft is not None:
            dw.ttft.append(ttft)

    def _complete(self, rec, dw, result):
        with rec.lock:
            if rec.done_evt.is_set():
                return
            rec.done_evt.set()
        out = dict(result)
        out["req_id"] = rec.rid
        out["worker"] = dw.name
        out["router_ttft_ms"] = ((rec.t_first or time.perf_counter())
                                 - rec.t_arrival) * 1e3
        out["reprefilled"] = rec.reprefilled
        out["hedged"] = rec.hedged
        self.request_ms.append((time.perf_counter() - rec.t_arrival) * 1e3)
        rec.future.set_result(out)

    def _fail(self, rec, err):
        with rec.lock:
            if rec.done_evt.is_set():
                return
            rec.done_evt.set()
        rec.future.set_exception(err)

    # -- control plane -------------------------------------------------

    def drain(self, name, timeout=60.0):
        """Graceful removal: stop routing to ``name``, then ask it to
        finish in-flight work.  Returns the worker's ack."""
        with self._mlock:
            member = self._members[name]
            member.live = False
        self._refresh_gauges()
        return self._call(member.addr,
                          {"op": "drain", "timeout": timeout},
                          timeout=timeout + 5.0)

    def status(self):
        with self._mlock:
            members = {m.name: {"addr": m.addr, "role": m.role,
                                "live": m.live}
                       for m in self._members.values()}
        with self._rlock:
            pending = sum(1 for r in self._recs.values()
                          if not r.done_evt.is_set())
        return {"members": members, "pending": pending,
                "expected": self._expected, "slo_alerts": []}

    def close(self):
        self._stop.set()
        with self._ccond:
            self._ccond.notify_all()     # release queued acquirers
        self._lease_thread.join(timeout=5.0)
