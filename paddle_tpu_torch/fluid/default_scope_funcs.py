"""Default-scope helpers (parity:
python/paddle/fluid/default_scope_funcs.py — a thread-local stack of
scopes over the global scope, with enter/leave and a scoped_function
decorator).  The port's copy of ``paddle_tpu/fluid/default_scope_funcs.py``,
over the port's ``core/scope.py``."""
from __future__ import annotations

import threading

from paddle_tpu_torch.core.scope import global_scope

__all__ = [
    "get_cur_scope", "enter_local_scope", "leave_local_scope", "var",
    "find_var", "scoped_function",
]

_tls = threading.local()


def _stack():
    if not hasattr(_tls, "stack"):
        _tls.stack = [global_scope()]
    return _tls.stack


def get_cur_scope():
    """The innermost scope of the current thread."""
    return _stack()[-1]


def enter_local_scope():
    cur = get_cur_scope()
    _stack().append(cur.new_scope())


def leave_local_scope():
    stack = _stack()
    if len(stack) == 1:
        raise RuntimeError("cannot leave the global scope")
    stack.pop()


def var(name):
    """Create or fetch ``name`` in the current scope."""
    return get_cur_scope().var(name)


def find_var(name):
    return get_cur_scope().find_var(name)


def scoped_function(func):
    """Run ``func`` inside a fresh local scope (reference
    default_scope_funcs.py:88)."""
    enter_local_scope()
    try:
        return func()
    finally:
        leave_local_scope()
