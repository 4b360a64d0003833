"""User-facing Executor (counterpart of paddle_tpu/fluid/executor.py).

Feed dict maps names -> numpy arrays (or tensors); fetch_list holds
Variables or names.  The block runs in core/executor_impl.py.
``Executor()`` with no place means ``CUDAPlace(0)`` and raises without a
card: the CPU is asked for explicitly with ``CPUPlace()``.
"""
from __future__ import annotations

import contextlib

import numpy as np

from paddle_tpu_torch.core.executor_impl import ExecutorCore
from paddle_tpu_torch.core.place import CUDAPlace
from paddle_tpu_torch.core.scope import global_scope

from .framework import Variable, default_main_program

__all__ = ["Executor", "global_scope", "scope_guard", "fetch_var"]

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
        names = [f.name if isinstance(f, Variable) else f
                 for f in (fetch_list or [])]
        for v in (feed or {}).values():
            if isinstance(v, Variable):
                raise TypeError("feed values must be arrays, got Variable")
        return self._core.run(program.desc, scope, 0, dict(feed or {}),
                              names, return_numpy=return_numpy)

    def close(self):
        pass
