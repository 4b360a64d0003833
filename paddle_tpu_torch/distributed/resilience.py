"""Failure-path machinery the serving fleet uses: the port's copy of
part of ``paddle_tpu/distributed/resilience.py``.

- ``RetryPolicy``: capped exponential backoff with jitter (the fleet
  router's retries);
- ``FaultInjector``: fault hooks at named injection points, driven by
  ``FLAGS_fault_spec`` (``point:action:value[:limit],...``), which drop,
  delay or hard-error a call; the fleet's points are ``fleet_prefill``,
  ``fleet_migrate`` and ``fleet_migrate_tear``;
- ``InjectedFault`` and ``DeadlineExceeded``.

Not in this port: ``RetryPolicy``'s deadline, classification and
``run`` loop, the ``corrupt`` action and ``maybe_corrupt`` (the
parameter server's numerics crash lab), ``EndpointResolver`` and
``watchdog_error``; the reference's fault and retry counters and
flight-recorder notes (an injector's firings are in ``stats``); the
``rpc_*`` backoff flags and ``FLAGS_fault_seed`` (the router passes its
backoff, and an injector built from ``FLAGS_fault_spec`` draws from OS
entropy; pass ``seed`` to ``FaultInjector`` to pin it).
"""
from __future__ import annotations

import random
import threading
import time

from ..core.flags import FLAGS

__all__ = ["RetryPolicy", "FaultInjector", "InjectedFault",
           "DeadlineExceeded", "fault_point", "get_injector",
           "install_faults"]


class InjectedFault(ConnectionError):
    """A fault fired by FaultInjector.  ``retryable`` mirrors how a real
    failure of that kind would classify (drop = transient network loss;
    error = a poisoned/fatal reply)."""

    def __init__(self, point, action, retryable=True):
        super().__init__("injected fault at %r: %s" % (point, action))
        self.point = point
        self.action = action
        self.retryable = retryable


class DeadlineExceeded(TimeoutError):
    """An operation ran out of retry budget (time or attempts)."""

    def __init__(self, message, last_error=None, attempts=0, elapsed=0.0):
        super().__init__(message)
        self.last_error = last_error
        self.attempts = attempts
        self.elapsed = elapsed


class RetryPolicy:
    """Capped exponential backoff with jitter: the part of the
    reference's RetryPolicy the fleet router uses (its per-call deadline,
    attempt cap, error classification and ``run`` loop are not copied:
    the router keeps its own deadline and attempt loop)."""

    def __init__(self, base_backoff, max_backoff, multiplier=2.0,
                 jitter=0.5, rng=None):
        self.base_backoff = float(base_backoff)
        self.max_backoff = float(max_backoff)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self._rng = rng or random.Random()

    def backoff(self, attempt):
        """Capped exponential with +-jitter (attempt counts from 1)."""
        raw = min(self.max_backoff,
                  self.base_backoff * (self.multiplier ** (attempt - 1)))
        lo = max(0.0, 1.0 - self.jitter)
        return raw * self._rng.uniform(lo, 1.0 + self.jitter)


class _Rule:
    __slots__ = ("point", "action", "value", "limit", "fired")

    def __init__(self, point, action, value, limit=0):
        self.point = point
        self.action = action
        self.value = value
        self.limit = int(limit)
        self.fired = 0


class FaultInjector:
    """Probabilistic fault hooks at named injection points.

    Spec grammar (comma-separated entries, colon-separated fields):
      <point>:drop:<prob>[:<limit>]    raise a RETRYABLE InjectedFault
                                       with probability <prob>
      <point>:delay:<secs>[:<limit>]   sleep <secs> before the call
      <point>:error:<prob>[:<limit>]   raise a FATAL InjectedFault
    ``limit`` caps total firings of that rule (0 / omitted = unlimited).
    """

    ACTIONS = ("drop", "delay", "error")

    def __init__(self, spec="", seed=None):
        self.rules = self._parse(spec)
        self._rng = random.Random(seed or None)
        self._lock = threading.Lock()
        self.stats = {}

    @classmethod
    def from_env(cls):
        return cls(FLAGS.fault_spec)

    @staticmethod
    def _parse(spec):
        rules = []
        for entry in (spec or "").split(","):
            entry = entry.strip()
            if not entry:
                continue
            fields = entry.split(":")
            if len(fields) not in (3, 4):
                raise ValueError(
                    "bad fault spec entry %r: want "
                    "point:action:value[:limit]" % entry)
            point, action, value = fields[0], fields[1], fields[2]
            if action not in FaultInjector.ACTIONS:
                raise ValueError("bad fault action %r in %r (want one of "
                                 "%s)" % (action, entry,
                                          "/".join(FaultInjector.ACTIONS)))
            limit = int(fields[3]) if len(fields) == 4 else 0
            rules.append(_Rule(point, action, float(value), limit))
        return rules

    def fire(self, point):
        """Run every rule registered for ``point``: may sleep or raise."""
        for rule in self.rules:
            if rule.point != point:
                continue
            with self._lock:
                if rule.limit and rule.fired >= rule.limit:
                    continue
                if rule.action == "delay":
                    hit = True
                else:
                    hit = self._rng.random() < rule.value
                if not hit:
                    continue
                rule.fired += 1
                self.stats[point] = self.stats.get(point, 0) + 1
            if rule.action == "delay":
                time.sleep(rule.value)
            elif rule.action == "drop":
                raise InjectedFault(point, "drop", retryable=True)
            else:
                raise InjectedFault(point, "error", retryable=False)


_injector = None
_injector_lock = threading.Lock()


def get_injector():
    global _injector
    if _injector is None:
        with _injector_lock:
            if _injector is None:
                _injector = FaultInjector.from_env()
    return _injector


def install_faults(spec, seed=None):
    """Replace the process-wide injector (tests, drills).  Returns it."""
    global _injector
    with _injector_lock:
        _injector = FaultInjector(spec, seed=seed)
    return _injector


def fault_point(name):
    """Injection hook: a no-op unless the installed spec names ``name``."""
    inj = get_injector()
    if inj.rules:
        inj.fire(name)
