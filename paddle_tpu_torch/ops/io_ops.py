"""Host IO ops: feed / fetch / save / load / print / delete_var.

Counterpart of ``paddle_tpu/ops/io_ops.py``.  These run on the host:
the executor runs them itself, before the block's device ops (a
prelude), after them (a postlude) or, when they sit between device ops,
in order with them (``core/executor_impl.py``).  Each takes
``(executor, op, scope, feed, env)``: ``env`` is the run's environment
when the op reads temporaries of the block or writes values the block
returns, else None.

A save reads its tensor to the host, bfloat16 included
(``utils/serialization.py``).  A load puts the file's tensor on the
executor's device, in the file's dtype, into the scope that owns the
name (``Scope.set``, so the write version moves and a live prepared
program re-stages from it before its next step).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from paddle_tpu_torch.core.executor_impl import fetches_to_host
from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.utils import serialization


def _host(name):
    def deco(impl):
        register_op(name, lower=impl, host_op=True, grad_maker=None)
        return impl

    return deco


def _read(name, scope, env):
    return (env[name] if env is not None and name in env
            else scope.find_var(name))


def _install(executor, scope, env, name, value):
    value = value.to(executor.device)
    if env is not None:
        env[name] = value
    (scope.find_scope_of(name) or scope).set(name, value)


@_host("feed")
def _feed(executor, op, scope, feed, env=None):
    out = op.output("Out")[0]
    val = feed.get(out)
    if val is None:
        return
    if not isinstance(val, torch.Tensor):
        val = torch.from_numpy(np.ascontiguousarray(np.asarray(val)))
    val = val.to(executor.device)
    if env is not None:
        env[out] = val
    else:
        scope.set(out, val)


@_host("fetch")
def _fetch(executor, op, scope, feed, env=None):
    # the executor's fetch_list returns the values; the op keeps the
    # program's record of what an inference model returns
    pass


@_host("save")
def _save(executor, op, scope, feed, env=None):
    path = op.attr("file_path")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    serialization.save_tensor(path, _read(op.input("X")[0], scope, env))


@_host("load")
def _load(executor, op, scope, feed, env=None):
    value = serialization.load_tensor(op.attr("file_path"), as_torch=True)
    _install(executor, scope, env, op.output("Out")[0], value)


@_host("save_combine")
def _save_combine(executor, op, scope, feed, env=None):
    path = op.attr("file_path")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    serialization.save_combined(
        path, [(name, _read(name, scope, env)) for name in op.input("X")])


@_host("load_combine")
def _load_combine(executor, op, scope, feed, env=None):
    loaded = dict(serialization.load_combined(op.attr("file_path"),
                                              as_torch=True))
    for name in op.output("Out"):
        _install(executor, scope, env, name, loaded[name])


def _dtype_name(val):
    if isinstance(val, torch.Tensor):
        return str(val.dtype).replace("torch.", "")
    return str(np.asarray(val).dtype)


@_host("print")
def _print(executor, op, scope, feed, env=None):
    name = op.input("In")[0]
    val = _read(name, scope, env)
    arr, = fetches_to_host([val])     # bf16 read as float32, exactly
    msg = op.attr("message", "")
    parts = [msg or name]
    if op.attr("print_tensor_shape", True):
        parts.append("shape=%s" % (arr.shape,))
    if op.attr("print_tensor_type", True):
        parts.append("dtype=%s" % _dtype_name(val))
    if op.attr("summarize", -1) != 0:
        parts.append("data=%s" % np.array2string(arr, threshold=20))
    print("\t".join(parts))
    if env is not None and op.output("Out", []):
        env[op.output("Out")[0]] = val


@_host("delete_var")
def _delete_var(executor, op, scope, feed, env=None):
    scope.erase(op.input("X"))
