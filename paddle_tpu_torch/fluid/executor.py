"""User-facing Executor (counterpart of paddle_tpu/fluid/executor.py).

Feed dict maps names -> numpy arrays (or tensors); fetch_list holds
Variables or names.  The block runs in core/executor_impl.py.
``Executor()`` with no place means ``CUDAPlace(0)`` and raises without a
card: the CPU is asked for explicitly with ``CPUPlace()``.
``Executor.prepare`` returns the prepared step (``PreparedProgram``),
which on a card runs as one CUDA graph replay a step.
"""
from __future__ import annotations

import contextlib

import numpy as np

from paddle_tpu_torch.core.executor_impl import (ExecutorCore,
                                                 fetches_to_host)
from paddle_tpu_torch.core.place import CUDAPlace
from paddle_tpu_torch.core.scope import global_scope

from .framework import Variable, default_main_program

__all__ = ["Executor", "PreparedProgram", "global_scope", "scope_guard",
           "fetch_var"]

_scope_stack = [global_scope()]


def _current_scope():
    return _scope_stack[-1]


@contextlib.contextmanager
def scope_guard(scope):
    _scope_stack.append(scope)
    try:
        yield
    finally:
        _scope_stack.pop()


def fetch_var(name, scope=None, return_numpy=True):
    scope = scope or _current_scope()
    val = scope.find_var(name)
    if return_numpy and hasattr(val, "detach"):
        return val.detach().cpu().numpy()
    return np.asarray(val) if return_numpy else val


def _fetch_names(fetch_list):
    return [f.name if isinstance(f, Variable) else f
            for f in (fetch_list or [])]


def _mode(program):
    """'test' for a program cloned for test (its dropout and batch norm
    run in inference mode), else 'train'."""
    return "test" if getattr(program, "_is_test", False) else "train"


def _check_feed(feed):
    for v in (feed or {}).values():
        if isinstance(v, Variable):
            raise TypeError("feed values must be arrays, got Variable")


class PreparedProgram:
    """Fluid view over the core PreparedProgram: optional numpy
    conversion and the sync-on-exit context manager.  The int64 feed
    guard (values past the int32 range raise, as the JAX package's
    ``_guard_int64``) runs where the core stages each feed, as for
    ``Executor.run``.  Obtain one via ``Executor.prepare``."""

    def __init__(self, core_prep):
        self._prep = core_prep

    @property
    def fetch_names(self):
        return self._prep.fetch_names

    @property
    def is_stale(self):
        return self._prep.is_stale

    def run_prepared(self, feed=None, return_numpy=False):
        """One prepared step.  With ``return_numpy=False`` (the default)
        the fetches come back as tensors on the device: convert when a
        value is consumed, and the host need not wait for the step."""
        _check_feed(feed)
        outs = self._prep.run_prepared(feed)
        return fetches_to_host(outs) if return_numpy else outs

    def sync_scope(self):
        self._prep.sync_scope()

    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        return self._prep.__exit__(exc_type, exc, tb)


class Executor:
    def __init__(self, place=None):
        self.place = place if place is not None else CUDAPlace(0)
        self._core = ExecutorCore(self.place)

    @property
    def device(self):
        return self._core.device

    def run(self, program=None, feed=None, fetch_list=None,
            feed_var_name="feed", fetch_var_name="fetch", scope=None,
            return_numpy=True, use_program_cache=True):
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = _current_scope()
        _check_feed(feed)
        return self._core.run(program.desc, scope, 0, dict(feed or {}),
                              _fetch_names(fetch_list),
                              return_numpy=return_numpy,
                              mode=_mode(program))

    def prepare(self, program=None, feed_specs=None, fetch_list=None,
                scope=None):
        """Executor::Prepare analog: a PreparedProgram whose
        ``run_prepared(feed)`` keeps the train state on the device
        between steps (core/executor_impl.PreparedProgram; on a card the
        step is captured as one CUDA graph).  ``feed_specs`` is a sample
        feed dict (the first batch) or an iterable of feed names.
        Raises ValueError for programs with host ops: callers fall back
        to run()."""
        if program is None:
            program = default_main_program()
        if scope is None:
            scope = _current_scope()
        return PreparedProgram(self._core.prepare(
            program.desc, feed_specs, _fetch_names(fetch_list),
            scope=scope, mode=_mode(program)))

    def close(self):
        pass
