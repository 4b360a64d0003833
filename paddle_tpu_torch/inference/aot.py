"""AOT inference export: save the inference program's block 0 as one
``torch.export`` program next to the saved model, so that a server loads
and runs it without lowering the program's ops again.

Counterpart of ``paddle_tpu/inference/aot.py``.  The JAX package
serializes the XLA executable compiled for the exported feed specs; the
port serializes a ``torch.export`` program of block 0 traced at those
specs.  It takes the feeds and the scope's parameters as inputs (the
parameters are staged once at load, as the JAX package stages them) and
returns the fetches and the persistables the block writes.  The kernels
on the path are ``torch.library`` custom ops (``kernels/custom_ops.py``):
the program calls them, and they launch the hand-written kernels on a
card and run their plain versions on the CPU.  Running it lowers no op
(``core/lowering.LOWERINGS`` stays put).  On a card the loaded program
is captured as one CUDA graph at load, which every run replays.

Artifacts inside the model dir (names of the port's own, so that the
JAX package's ``__aot__.pkl`` / ``__aot__.json`` may sit beside them):
  __aot_torch__.pt2   ``torch.export.save`` of the program
  __aot_torch__.json  {"specs": {feed: [shape, dtype]}, "input_names":
                       [...], "persists": [...], "fetch": [...],
                       "platform": "cuda" | "cpu", "torch": version}

``build_aot`` is the serving tier's bucket: an ``AotExecutable`` over the
executor's prepared step (``core/step_graph.StepGraph``, the step
``Executor.prepare`` runs) for the bucket's specs, on a card one CUDA
graph.  Its parameters are staged from the scope once and the
persistables it writes stay in its own state, as the JAX package's
executable writes them into its own staged arguments.

A platform mismatch, a JAX-package artifact with none of the port's, or
a load error falls back to the normal executor path, never fails: each
is counted in ``FALLBACK_COUNT`` (a plain integer) with a bounded reason
record in ``FALLBACKS``.
"""
from __future__ import annotations

import json
import os
import threading
import time
import warnings

import numpy as np
import torch

from ..core import lowering as _lowering
from ..core.executor_impl import (ExecutorCore, _segment, fetches_to_host,
                                  run_block, to_device)
from ..core.types import np_dtype_to_proto, proto_to_torch_dtype

__all__ = ["save_aot", "AotExecutable", "load_aot", "build_aot",
           "FALLBACKS", "AOT_PROGRAM", "AOT_META"]

AOT_PROGRAM = "__aot_torch__.pt2"
AOT_META = "__aot_torch__.json"
# the JAX package's serialized executable: not loadable here
JAX_AOT_BIN = "__aot__.pkl"

FALLBACKS = []          # newest-last [{dir, reason, detail}], bounded
FALLBACK_COUNT = 0      # load_aot fallbacks in this process
_FALLBACK_KEEP = 64
_FALLBACK_LOCK = threading.Lock()


def _note_fallback(dirname, reason, detail=""):
    global FALLBACK_COUNT
    with _FALLBACK_LOCK:
        FALLBACK_COUNT += 1
        FALLBACKS.append({"dir": str(dirname), "reason": reason,
                          "detail": str(detail)[:500]})
        del FALLBACKS[:-_FALLBACK_KEEP]


def _desc(program):
    return program.desc if hasattr(program, "desc") else program


def _plan(core, inference_program, fetch_names):
    """(desc, plan) of block 0; ValueError for a program with host ops
    besides its feed and fetch ops."""
    desc = _desc(inference_program)
    prelude, _, postlude, mixed = _segment(desc.blocks[0])
    host_tail = [op.type for op in prelude + postlude
                 if op.type not in ("feed", "fetch")]
    if mixed or host_tail:
        raise ValueError(
            "AOT export needs a pure-compute inference program; found "
            "host ops %r" % (host_tail or "mixed segment"))
    return desc, core._entry(desc, 0, list(fetch_names))


def _meta(feed_specs, entry, fetch_names, device):
    return {"specs": {k: [[int(d) for d in shape], np.dtype(dtype).name]
                      for k, (shape, dtype) in feed_specs.items()},
            "input_names": list(entry.input_names),
            "persists": list(entry.persist_outs),
            "fetch": list(fetch_names),
            "platform": device.type,
            "torch": torch.__version__}


def _zeros(block, core, specs):
    """{feed: zero tensor of its spec} on the host."""
    return {name: core._feed_host(block, name, np.zeros(shape, dtype))
            for name, (shape, dtype) in specs.items()}


class _Block(torch.nn.Module):
    """Block 0 as a module: ``forward(*inputs)`` (the plan's input names
    in order) returns the fetches, then the written persistables."""

    def __init__(self, desc, entry, device, mode):
        super().__init__()
        self._desc = desc
        self._entry = entry
        self._device = device
        self._mode = mode

    def forward(self, *inputs):
        env = dict(zip(self._entry.input_names, inputs))
        run_block(_lowering.LoweringContext(self._desc, 0, env, self._device,
                                            mode=self._mode), self._entry)
        return tuple(env[n] for n in self._entry.fetch_names) + \
            tuple(env[n] for n in self._entry.persist_outs)


def _export(inference_program, feed_specs, fetch_names, scope, place,
            mode="test"):
    """Trace block 0 at ``feed_specs`` ({name: (shape, dtype)}); returns
    (the ``torch.export`` program, meta)."""
    core = ExecutorCore(place)
    desc, entry = _plan(core, inference_program, fetch_names)
    feeds = _zeros(desc.blocks[0], core, feed_specs)
    flat = []
    for name in entry.input_names:
        if name in feeds:
            flat.append(feeds[name].to(core.device))
        else:
            flat.append(_scope_input(scope, name, core.device))
    # traced under no_grad, as the executor runs the block: the program
    # then records no grad-mode switch around its ops
    with torch.no_grad():
        ep = torch.export.export(_Block(desc, entry, core.device, mode),
                                 tuple(flat), strict=False)
    return ep, _meta(feed_specs, entry, fetch_names, core.device)


def _scope_input(scope, name, device):
    if not scope.has_var(name):
        raise KeyError("AOT executable input %r missing from the loaded "
                       "parameter scope" % name)
    return to_device(scope.find_var(name), device)


def save_aot(dirname, inference_program, feed_specs, fetch_names, scope,
             place, mode="test"):
    """Trace block 0 of ``inference_program`` for ``feed_specs``
    ({name: (shape, dtype)}) and write the program into ``dirname``."""
    ep, meta = _export(inference_program, dict(feed_specs),
                       list(fetch_names), scope, place, mode)
    torch.export.save(ep, os.path.join(dirname, AOT_PROGRAM))
    with open(os.path.join(dirname, AOT_META), "w") as f:
        json.dump(meta, f, indent=1)
    return meta


def build_aot(inference_program, feed_specs, fetch_names, scope, place,
              mode="test"):
    """The serving tier's bucket: an ``AotExecutable`` over the prepared
    step of block 0 for ``feed_specs``, built now (on a card: captured
    as one CUDA graph, on a stream of its own and in ``thread_local``
    capture mode, since another bucket may replay meanwhile)."""
    from ..core.step_graph import StepGraph

    t0 = time.perf_counter()
    core = ExecutorCore(place)
    desc, entry = _plan(core, inference_program, fetch_names)
    specs = dict(feed_specs)
    if core.device.type == "cuda":
        core._refuse_uncapturable(entry)
    state_names = [n for n in entry.input_names if n not in specs]
    block = desc.blocks[0]
    step = StepGraph(core, desc, 0, entry, state_names,
                     {n: tuple(s) for n, (s, _) in specs.items()}, mode,
                     capture_error_mode="thread_local")
    for name in state_names:
        step.load_state(name, _scope_input(scope, name, core.device))
    exe = AotExecutable(_meta(specs, entry, fetch_names, core.device),
                        core.device, _PreparedStep(step, block, core))
    exe.warm()
    exe.build_seconds = time.perf_counter() - t0
    return exe


class _PreparedStep:
    """A built bucket's step: the executor's ``StepGraph``."""

    def __init__(self, step, block, core):
        self._step = step
        self._block = block
        self._core = core
        # the persistables written back into the step's own state
        self.persist_slots = list(step.write_back)
        # the state the step reads and writes, and its generators: one
        # call at a time
        self.locked = True

    def __call__(self, feed):
        staged = {name: self._core._feed_host(self._block, name, val)
                  for name, val in feed.items()}
        self._step.check(staged)
        return self._step.run(staged, 0)

    @property
    def graphs(self):
        return len(self._step.buckets)

    @property
    def replays(self):
        return sum(b["replays"] for b in self._step.buckets.values())


class _ExportedStep:
    """A loaded bucket's step: the ``torch.export`` program over
    parameters staged once; on a card one CUDA graph, captured here."""

    def __init__(self, module, meta, scope, device):
        self._module = module
        self._device = device
        self._args = []
        self._feed_slots = {}
        name_index = {}
        specs = meta["specs"]
        for i, name in enumerate(meta["input_names"]):
            name_index[name] = i
            if name in specs:
                shape, dtype = specs[name]
                self._feed_slots[name] = i
                self._args.append(torch.zeros(
                    shape, dtype=_torch_dtype(dtype), device=device))
            else:
                self._args.append(_scope_input(scope, name, device))
        self._n_fetch = len(meta["fetch"])
        # (output index, input slot): the persistables the program writes
        # go back into the staged inputs, as the JAX package writes the
        # donated buffers back
        self.persist_slots = [
            (self._n_fetch + j, name_index[n])
            for j, n in enumerate(meta.get("persists", []))
            if n in name_index]
        self._graph = None
        self.launches = {}
        self.replays = 0
        # on a card the persistables are copied into the staged slots in
        # place (the graph's addresses stay), on the CPU rebound
        self._in_place = device.type == "cuda"
        if self._in_place:
            # the graph writes the persistables into the staged slots in
            # place: those are the executable's own copies, not the
            # scope's tensors
            for _, i in self.persist_slots:
                self._args[i] = self._args[i].clone()
            self._capture()
        # a CUDA graph's static buffers are shared by every caller
        self.locked = bool(self.persist_slots) or self._graph is not None

    def _call(self, args):
        outs = self._module(*args)
        for j, i in self.persist_slots:
            if not self._in_place:
                args[i] = outs[j]
            elif outs[j].data_ptr() != args[i].data_ptr():
                args[i].copy_(outs[j])
        return list(outs[:self._n_fetch])

    def _capture(self):
        from ..core import step_graph

        saved = {i: self._args[i].clone() for _, i in self.persist_slots}

        def restore():
            for i, v in saved.items():
                self._args[i].copy_(v)

        with torch.no_grad():
            self._graph, self._out, self.launches = step_graph.capture(
                lambda: self._call(self._args), "the AOT program",
                restore=restore, capture_error_mode="thread_local",
                stream=torch.cuda.Stream(self._device))

    def __call__(self, feed):
        from .. import kernels

        if self._graph is None:
            args = list(self._args)
            for name, i in self._feed_slots.items():
                args[i] = _tensor(feed[name])
            with torch.no_grad():
                outs = self._call(args)
            for _, i in self.persist_slots:
                self._args[i] = args[i]
            return outs
        for name, i in self._feed_slots.items():
            self._args[i].copy_(_tensor(feed[name]))
        self._graph.replay()
        self.replays += 1
        kernels.add_launches(self.launches)
        return self._out

    @property
    def graphs(self):
        return int(self._graph is not None)


def _tensor(v):
    if isinstance(v, torch.Tensor):
        return v
    return torch.from_numpy(np.ascontiguousarray(np.asarray(v)))


def _torch_dtype(dtype):
    return proto_to_torch_dtype(np_dtype_to_proto(np.dtype(dtype)))


class AotExecutable:
    """A bucket executable + its feed contract.

    ``run(feed)`` stages the feed values and runs the step (on a card one
    CUDA graph replay) — no op is lowered for a loaded program; returns
    the fetches as host numpy arrays.  ``matches(feed)`` tells the
    predictor whether this executable serves a given feed.  Calls that
    share state (a step writing persistables, a graph's static buffers)
    take ``_run_lock``; a CPU program that writes none runs unlocked, so
    cloned predictors overlap."""

    def __init__(self, meta, device, step):
        self.meta = meta
        self.device = device
        self._step = step
        self._run_lock = threading.Lock()
        self.specs = {k: (tuple(s), np.dtype(d))
                      for k, (s, d) in meta["specs"].items()}
        self.fetch = list(meta["fetch"])
        # seconds this executable took to load or build (a capture on a
        # card included)
        self.build_seconds = None

    @property
    def _persist_slots(self):
        """What one run writes back into the executable's own state."""
        return self._step.persist_slots

    @property
    def graphs(self):
        """CUDA graphs this executable replays (0 on the CPU)."""
        return self._step.graphs

    @property
    def replays(self):
        """Graph replays made so far (every run on a card is one)."""
        return self._step.replays

    def matches(self, feed):
        if set(feed) != set(self.specs):
            return False
        for k, v in feed.items():
            shape, dtype = self.specs[k]
            if tuple(v.shape if hasattr(v, "shape")
                     else np.shape(v)) != shape:
                return False
            if (v.dtype != _torch_dtype(dtype)
                    if isinstance(v, torch.Tensor)
                    else np.asarray(v).dtype != dtype):
                return False
        return True

    def warm(self):
        """Run once on zero feeds (on a card: the capture of a built
        bucket happens here), so no request pays for it."""
        self.run({name: np.zeros(shape, dtype)
                  for name, (shape, dtype) in self.specs.items()})

    def run(self, feed):
        missing = [n for n in self.specs if n not in feed]
        if missing:
            raise KeyError("AOT executable expects feed(s) %r" % missing)
        feed = {n: feed[n] for n in self.specs}
        if not self._step.locked:
            return fetches_to_host(self._step(feed))
        with self._run_lock:
            return fetches_to_host(self._step(feed))


def load_aot(dirname, scope, place):
    """Load the exported program if present AND usable on this device;
    None otherwise (counted, with its reason) — callers fall back to the
    executor path."""
    prog_path = os.path.join(dirname, AOT_PROGRAM)
    meta_path = os.path.join(dirname, AOT_META)
    if not (os.path.exists(prog_path) and os.path.exists(meta_path)):
        if os.path.exists(os.path.join(dirname, JAX_AOT_BIN)):
            _note_fallback(dirname, "jax_artifact",
                           "%s is the JAX package's serialized XLA "
                           "executable; the port loads %s"
                           % (JAX_AOT_BIN, AOT_PROGRAM))
        return None
    with open(meta_path) as f:
        meta = json.load(f)
    device = place.torch_device()
    if meta.get("platform") != device.type:
        _note_fallback(dirname, "platform_mismatch",
                       "artifact %r vs runtime %r" %
                       (meta.get("platform"), device.type))
        return None
    try:
        t0 = time.perf_counter()
        ep = torch.export.load(prog_path)
        exe = AotExecutable(meta, device,
                            _ExportedStep(ep.module(), meta, scope, device))
        exe.build_seconds = time.perf_counter() - t0
        return exe
    except Exception as e:
        # torch version drift, a corrupt file: the executor path still
        # works, but say so AND count it
        _note_fallback(dirname, "load_error",
                       "%s: %s" % (type(e).__name__, e))
        warnings.warn("AOT program in %s could not be loaded (%s: %s); "
                      "falling back to the executor" %
                      (dirname, type(e).__name__, e))
        return None
