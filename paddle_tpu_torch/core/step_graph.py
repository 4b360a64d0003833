"""The prepared training step, captured on a card as one CUDA graph.

No file of the JAX package corresponds: this stands in for the
``jax.jit`` of the block with its persistable inputs donated
(``paddle_tpu/core/executor_impl.py`` ``_build``), which lets XLA
update parameters and optimizer state in place and run the step as one
dispatch.

``StepGraph`` keeps one static tensor per input of the block that is
not fed (``state``: parameters, optimizer state, a learning rate), and
runs one step function on every device:

- the feeds and the state are read from the environment of static
  tensors, and the block's ops run through the shared plan
  (``executor_impl.run_block``);
- each persistable the step both reads and writes is copied back into
  its static input tensor at the end of the step.  That copy is the
  analog of donation: the next step reads the new value from the same
  address.  (It costs one read and one write of the state a step: ~1.1
  GB for the flagship LM's Adam state, ~0.2 GB for ResNet-50's.)
  Persistables the step writes but does not read stay in ``outs``
  (on a card, the graph's output tensors, put back after every replay);
- a fetch or an output that shares storage with a static tensor is
  cloned first, so that the copy-back never changes a value the step
  returns.

On the CPU the function runs eagerly, every step.  On a card it is
captured once, at the first step, with that step's feed shapes: two
warm-up steps on a side stream (they build the kernels and let cuDNN
and cuBLAS choose their algorithms; the state is restored after them),
then ``torch.cuda.graph(..., capture_error_mode="global")``, then one
``replay()`` a step.  The feeds are copied into static buffers, never
rebound, so the addresses the graph (and the tensor maps the kernels
encode on the host) baked in stay valid; fetches come back as clones,
so a held loss is not overwritten by the next replay.  A feed whose
shape or dtype differs from the captured one raises
``PreparedShapeMismatch`` (``check``), as on the CPU when the
prepared step was given a sample feed.  The flags the lowering reads
(``LOWERING_FLAGS``) are those of prepare(): a replay bakes them in, so
a step after one of them changed raises RuntimeError on both devices.
The kernels' launch counts made while capturing
are taken back and added again at every replay.  A capture that fails
raises RuntimeError naming the op being captured; nothing falls back to
running the step eagerly.

Random ops draw from the step's ``lowering.RandomStream``: its
generators are registered with the graph before the capture, and reset
to the step's seed (the program's random seed and the scope's run
counter, drawn once per step) before every step, eager or replayed. A
replay therefore draws new numbers at every step, the ones ``run()``
draws at that step, and an op with an explicit ``seed`` draws the same
numbers at every step; the warm-up steps draw from the first step's seed
and move no counter.

``capture`` is that warm-up and capture alone, for any step function:
the serving engine (``serving/generative.py``) captures each prefill
and decode bucket with it.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..kernels import _build
from .executor_impl import PreparedShapeMismatch, run_block, to_device
from .flags import FLAGS
from .lowering import LoweringContext, RandomStream

# steps run before the capture (their updates are undone)
WARMUP_STEPS = 2
# the flags the lowering reads while it runs
LOWERING_FLAGS = ("bn_bf16",)


def _lowering_flags():
    return {name: getattr(FLAGS, name) for name in LOWERING_FLAGS}


class StepGraph:
    def __init__(self, core, program, block_id, entry, state_names,
                 fixed_shapes, mode="train"):
        self._program = program
        self._block_id = block_id
        self._entry = entry
        self._device = core.device
        self._mesh = core.mesh
        self._mode = mode
        self._capture = self._device.type == "cuda"
        # {feed name: shape} the step takes (None: any, on the CPU)
        self._fixed = fixed_shapes
        self._flags = _lowering_flags()
        self.state = {}     # name -> static input tensor
        self.outs = {}      # written, not read -> the latest value
        state = set(state_names)
        self.write_back = [n for n in entry.persist_outs if n in state]
        self._outs_only = [n for n in entry.persist_outs if n not in state]
        # the card: static feed buffers, the graph, its fetch and
        # write-only outputs, and the launches one replay makes
        self._feeds = None
        self._graph = None
        self._fetch_out = None
        self._graph_outs = {}
        self._launches = {}
        # the step's generators (lowering.RandomStream): reset to the
        # step's seed before each step, and registered with the graph
        self._stream = RandomStream(self._device)

    def load_state(self, name, value):
        """Copy a scope value into the static tensor of ``name``."""
        src = to_device(value, self._device)
        cur = self.state.get(name)
        if cur is not None and cur.shape == src.shape \
                and cur.dtype == src.dtype:
            cur.copy_(src)
            return
        if self._graph is not None:
            raise PreparedShapeMismatch(
                "state %r is now %s %s, the captured step's %s %s: "
                "prepare again" % (name, tuple(src.shape), src.dtype,
                                   tuple(cur.shape), cur.dtype))
        self.state[name] = torch.empty(src.shape, dtype=src.dtype,
                                       device=self._device).copy_(src)

    def current(self, name):
        """The step's latest value of written persistable ``name``, or
        None."""
        if name in self.state:
            return self.state[name]
        return self.outs.get(name)

    def run(self, feeds, seed):
        """One step on ``feeds`` ({name: tensor}, passed by ``check``);
        returns the fetches."""
        if not self._capture:
            env = dict(self.state)
            env.update((n, t.to(self._device)) for n, t in feeds.items())
            self._stream.reset(seed)
            fetches, outs = self._step(self._ctx(env, seed))
            self.outs.update(outs)
            return fetches
        if self._graph is None:
            self._feeds = {n: t.to(self._device, copy=True)
                           for n, t in feeds.items()}
            self._build_graph(seed)
        else:
            for n, t in feeds.items():
                self._feeds[n].copy_(t)
        # the replay reads the generators' seeds and offsets as they
        # stand: this step's
        self._stream.reset(seed)
        self._graph.replay()
        kernels.add_launches(self._launches)
        # a re-stage drops the write-only outputs: the replay made them
        self.outs.update(self._graph_outs)
        return [t.clone() for t in self._fetch_out]

    def check(self, feeds):
        """Before a step: raise PreparedShapeMismatch for a feed of
        another shape (or, on a card, dtype) than the step's, and
        RuntimeError if a flag of ``LOWERING_FLAGS`` changed."""
        if self._flags != _lowering_flags():
            raise RuntimeError(
                "FLAGS %s changed since prepare() (%s then): the prepared "
                "step keeps the flags it was prepared with; prepare again"
                % (_lowering_flags(), self._flags))
        if self._fixed is None:
            if not self._capture:
                return
            self._fixed = {n: tuple(t.shape) for n, t in feeds.items()}
        for name, t in feeds.items():
            want = self._fixed.get(name)
            if want is not None and tuple(t.shape) != want:
                raise PreparedShapeMismatch(
                    "feed %r shape %s != the prepared step's %s: prepare "
                    "again for the new batch shape, or use run()"
                    % (name, tuple(t.shape), want))
            if self._feeds is not None and t.dtype != self._feeds[name].dtype:
                raise PreparedShapeMismatch(
                    "feed %r dtype %s != the captured step's %s"
                    % (name, t.dtype, self._feeds[name].dtype))

    def _ctx(self, env, seed):
        return LoweringContext(self._program, self._block_id, env,
                               self._device, seed=seed, mesh=self._mesh,
                               stream=self._stream, mode=self._mode)

    def _step(self, ctx):
        """The step function: run the block over ``ctx.env``, copy the
        read-and-written persistables back into their static tensors;
        returns (fetches, {write-only persistable: value})."""
        run_block(ctx, self._entry)
        env = ctx.env
        static = {t.untyped_storage().data_ptr()
                  for t in self.state.values()}

        def own(t):
            if isinstance(t, torch.Tensor) and \
                    t.untyped_storage().data_ptr() in static:
                return t.clone()
            return t

        fetches = [own(env[n]) for n in self._entry.fetch_names]
        outs = {n: own(env[n]) for n in self._entry.persist_outs}
        for name in self.write_back:
            dst, val = self.state[name], outs[name]
            if val.shape == dst.shape and val.dtype == dst.dtype:
                dst.copy_(val)
            elif self._capture:
                raise RuntimeError(
                    "the step writes persistable %r as %s %s, read as %s "
                    "%s: a captured step keeps its state's shapes and "
                    "dtypes" % (name, tuple(val.shape), val.dtype,
                                tuple(dst.shape), dst.dtype))
            else:
                self.state[name] = val
        return fetches, {n: outs[n] for n in self._outs_only}

    def _build_graph(self, seed):
        env = {**self.state, **self._feeds}
        saved = {n: self.state[n].clone() for n in self.write_back}
        ctxs = [None]      # the latest step's context, and no other

        def step():
            ctxs[0] = None
            # each call's explicit-seed draws take their generators in op
            # order again; the capture records draws that each replay
            # makes from the generators' states as ``run`` resets them
            self._stream.rewind()
            ctxs[0] = self._ctx(dict(env), seed)
            return self._step(ctxs[0])

        def restore():
            for name, val in saved.items():
                self.state[name].copy_(val)
            saved.clear()
            # the warm-ups made every generator the step draws from
            self._stream.frozen = True

        def at_op():
            op = ctxs[0].op
            return " at op %s" % (op.type if op is not None
                                  else "(after the ops)")

        graph, (fetches, outs), launches = capture(
            step, "the prepared step", at_op, restore=restore,
            generators=self._stream.generators)
        self._graph, self._fetch_out, self._launches = graph, fetches, \
            launches
        self._graph_outs = outs


def capture(step, what, where=None, restore=None,
            capture_error_mode="global", stream=None, generators=None):
    """Capture one call of ``step()`` as a CUDA graph; returns (graph,
    what that call returned, {kernel name: launches one replay makes}).

    ``WARMUP_STEPS`` calls run first on a side stream (``stream``, else
    a new one): they build the kernels and let cuBLAS and cuDNN choose
    their algorithms; ``restore()`` then undoes what they wrote.  The
    capture runs on ``stream`` (else ``torch.cuda.graph``'s own) into a
    private memory pool.  ``generators()`` (after the warm-ups) lists
    the ``torch.Generator``s the step draws from: they are registered
    with the graph, so that each replay draws from their seeds and
    offsets as they stand then (``lowering.RandomStream``).  The
    launches the wrappers count
    while this thread captures are taken back: recording a launch is
    not making one, so the caller adds them at each replay.  A capture
    that fails raises RuntimeError naming ``what`` (and ``where()``, the
    place it failed); nothing runs in its place."""
    dev = torch.cuda.current_stream().device
    side = stream if stream is not None else torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(WARMUP_STEPS):
            step()
    torch.cuda.current_stream(dev).wait_stream(side)
    if restore is not None:
        restore()
    graph = torch.cuda.CUDAGraph()
    gens = list(generators()) if generators is not None else []
    if gens and not hasattr(graph, "register_generator_state"):
        raise RuntimeError(
            "capturing %s: torch %s cannot register a generator with a "
            "CUDA graph (CUDAGraph.register_generator_state), so a replay "
            "would repeat its random draws" % (what, torch.__version__))
    for g in gens:
        graph.register_generator_state(g)
    with _build.recording() as rec:
        try:
            with torch.cuda.graph(graph, stream=stream,
                                  capture_error_mode=capture_error_mode):
                out = step()
        except Exception as e:
            cause = e.__context__
            raise RuntimeError(
                "capturing %s as a CUDA graph failed%s: %s: %s%s" % (
                    what, where() if where is not None else "",
                    type(e).__name__, e,
                    "" if cause is None else " (after %s: %s)" % (
                        type(cause).__name__, cause))) from e
        finally:
            launches = {name: rec[fn] for name, fn in kernels.KERNELS.items()
                        if fn in rec}
            kernels.add_launches({k: -n for k, n in launches.items()})
    return graph, out, launches
