"""ParallelExecutor: a program run over a device mesh.

Counterpart of ``paddle_tpu/fluid/parallel_executor.py``, which compiles
the program once as an SPMD computation over a ``jax.sharding.Mesh`` of
the process's devices.  Here the mesh is a ``parallel.Mesh`` over a list
of ``torch.device`` s in one process, and ``core/executor_impl.py`` runs
the program on its first device; the ops that shard over the mesh (the
ring attention op under an ``sp`` axis) lay their shards over all of it.

Ported: ``mesh_axes`` with an ``sp`` axis (``dp`` 1).  Data and tensor
parallelism (``dp``, ``tp`` > 1), the other axes and multi-host
training (``num_trainers`` > 1) raise NotImplementedError.

``run`` goes through the prepared step (``Executor.prepare``; on a card
one CUDA graph replay a step), one per (fetch, feed) signature, as the
JAX package's does: a program with host ops is remembered, per program
version, as needing ``run()``, and so is one whose step a CUDA graph
cannot replay (``Uncapturable``: ``assign_value``, a mesh
over distinct cards); a program that changed since it was
prepared is synced and prepared again; a batch whose shape differs from
the prepared one runs through ``run()``.

The executor has no op scheduling to tune and keeps no temporaries in
the scope to drop, so it has no ``BuildStrategy`` or
``ExecutionStrategy`` (nor the latter's ``num_iteration_per_drop_scope``
sync cadence: every read of the scope flushes the prepared state):
passing one raises NotImplementedError.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from paddle_tpu_torch.core.executor_impl import (ExecutorCore,
                                                 PreparedShapeMismatch,
                                                 Uncapturable,
                                                 fetches_to_host)
from paddle_tpu_torch.core.place import CPUPlace, CUDAPlace
from paddle_tpu_torch.parallel.mesh import make_mesh

from .executor import _current_scope
from .framework import Variable, default_main_program

__all__ = ["ParallelExecutor"]

_PORTED_AXES = ("sp",)


class ParallelExecutor:
    """``use_cuda=True`` (the default) lays the mesh over the visible
    CUDA cards, each once, and raises when there are fewer than the mesh
    needs; ``use_cuda=False`` over the CPU, the one torch CPU device
    repeated ``n`` times.  ``num_devices`` cuts the device list;
    ``mesh_axes`` ({axis: size}) shapes the mesh, by default one ``dp``
    axis over every device.  ``loss_name`` is read by nothing, as in the
    JAX package: the loss is a mean over the whole batch already."""

    def __init__(self, use_cuda=True, loss_name=None, main_program=None,
                 share_vars_from=None, exec_strategy=None,
                 build_strategy=None, num_trainers=1, trainer_id=0,
                 scope=None, use_tpu=None, num_devices=None,
                 mesh_axes=None):
        if use_tpu is not None:
            use_cuda = use_tpu    # the JAX package's name for the card
        if exec_strategy is not None or build_strategy is not None:
            raise NotImplementedError(
                "ParallelExecutor: the eager executor has no exec_strategy "
                "or build_strategy knobs")
        if num_trainers != 1 or trainer_id != 0:
            raise NotImplementedError(
                "ParallelExecutor(num_trainers=%d): multi-host training is "
                "not ported to paddle_tpu_torch yet" % num_trainers)
        self._program = main_program or default_main_program()
        self._scope = scope or _current_scope()
        if share_vars_from is not None:
            self._scope = share_vars_from._scope

        if use_cuda:
            if not torch.cuda.is_available():
                raise RuntimeError("ParallelExecutor(use_cuda=True) needs "
                                   "CUDA; pass use_cuda=False for the CPU")
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
            place = CUDAPlace(0)
        else:
            n = num_devices or (math.prod(mesh_axes.values())
                                if mesh_axes else 1)
            devices = [torch.device("cpu")] * n
            place = CPUPlace()
        if num_devices:
            devices = devices[:num_devices]
        axes = dict(mesh_axes) if mesh_axes else {"dp": len(devices)}
        for axis, size in axes.items():
            if size > 1 and axis not in _PORTED_AXES:
                raise NotImplementedError(
                    "ParallelExecutor mesh axis %s=%d: only %s is ported "
                    "to paddle_tpu_torch yet" % (axis, size,
                                                 "/".join(_PORTED_AXES)))
        self.mesh = make_mesh(axes, devices)
        self._core = ExecutorCore(place, mesh=self.mesh)
        # the prepared step per (fetch names, feed names); signatures
        # that need run() (host ops), per program version
        self._prepared = {}
        self._unpreparable = {}

    @property
    def device_count(self):
        return self.mesh.size

    def run(self, fetch_list, feed=None, feed_dict=None, return_numpy=True):
        feed = feed if feed is not None else feed_dict
        if isinstance(feed, list):
            # per-device feed dicts (the reference API): concat on batch
            feed = {k: np.concatenate([np.asarray(d[k]) for d in feed],
                                      axis=0) for k in feed[0]}
        feed = dict(feed or {})
        names = [f.name if isinstance(f, Variable) else f
                 for f in fetch_list]
        prep = self._prepared_for(names, feed)
        if prep is not None:
            try:
                outs = prep.run_prepared(feed)
            except PreparedShapeMismatch:
                pass    # a drifted batch: run() flushes the state first
            else:
                return fetches_to_host(outs) if return_numpy else outs
        return self._core.run(self._program.desc, self._scope, 0, feed,
                              names, return_numpy=return_numpy)

    def _prepared_for(self, names, feed):
        """The prepared step of this (fetch, feed) signature, made on
        first use from the live feed; None when the program needs run()
        (host ops; on a card, a step a graph cannot replay).  A changed
        program is synced and prepared again."""
        desc = self._program.desc
        key = (tuple(names), tuple(sorted(feed)))
        prep = self._prepared.get(key)
        if prep is not None and prep.is_stale:
            if prep._dirty:
                prep.sync_scope()
            del self._prepared[key]
            prep = None
        if prep is None and self._unpreparable.get(key) != desc.version:
            try:
                prep = self._core.prepare(desc, feed, names,
                                          scope=self._scope)
            except (ValueError, Uncapturable):
                self._unpreparable[key] = desc.version
            else:
                self._prepared[key] = prep
        return prep
