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
prepared step was given a sample feed, except a ragged feed (one that
carries '<name>@LEN', and the lengths themselves): a batch whose
padded signature is new is captured as a graph of its own at its
first step and replayed from then on, one graph per bucket
(``buckets`` counts each one's captures and replays), as the serving
engine keeps one per bucket.  Padding T to a multiple of 8 bounds the
number of buckets by the longest sequence / 8.  Every capture of a step
allocates from one memory pool, the first capture's: a replay's
temporaries are dead once its fetches are cloned and its write-only
outputs handed on, and replays never overlap, so the graphs reuse one
another's blocks and the pool holds about the largest bucket's step,
not the sum over the buckets; their warm-ups and captures all run on
one side stream, whose cached blocks each later bucket's warm-ups reuse
(the allocator keeps a stream's blocks to that stream).  The flags the
lowering reads (``LOWERING_FLAGS``) are those of prepare(): a replay
bakes them in, so a step after one of them changed raises RuntimeError
on both devices.  The kernels' launch counts made while capturing are
taken back and added again at every replay.  A capture that fails
raises RuntimeError naming the op being captured; nothing falls back to
running the step eagerly.

Random ops draw from the step's ``lowering.RandomStream``: its
generators are registered with the graph before the capture, and reset
to the step's seed (the program's random seed and the scope's run
counter, drawn once per step) before every step, eager or replayed. A
replay therefore draws new numbers at every step, the ones ``run()``
draws at that step, and an op with an explicit ``seed`` draws the same
numbers at every step; the warm-up steps draw from the first step's seed
and move no counter.  Each ``assign_value`` (a learning-rate table of
``piecewise_decay``), ``fill`` and ``prior_box`` (SSD's priors) is a
device constant made once when the step is prepared, which every step
reads (``LoweringContext.constants``).

``capture`` is that warm-up and capture alone, for any step function:
the serving engine (``serving/generative.py``) captures each prefill
and decode bucket with it.
"""
from __future__ import annotations

import torch

from .. import kernels
from ..kernels import _build
from .executor_impl import (LEN_SUFFIX, PreparedShapeMismatch, is_len_name,
                            run_block, to_device)
from .flags import FLAGS
from .lowering import LoweringContext, RandomStream
from ..ops.tensor import CONSTANT_OPS

# steps run before the capture (their updates are undone)
WARMUP_STEPS = 2
# the flags the lowering reads while it runs
LOWERING_FLAGS = ("bn_bf16", "cudnn_deterministic")


def _lowering_flags():
    return {name: getattr(FLAGS, name) for name in LOWERING_FLAGS}


def _ragged(name, feeds):
    """A feed whose padded shape may change from batch to batch: a
    ragged one (it has '@LEN') or a length itself."""
    return is_len_name(name) or name + LEN_SUFFIX in feeds


def _signature(feeds):
    return tuple(sorted((n, tuple(t.shape), t.dtype)
                        for n, t in feeds.items()))


class _Capture:
    """One captured graph: its static feed buffers, its fetch and
    write-only outputs, the launches one replay makes, and the replays
    made."""

    __slots__ = ("feeds", "graph", "fetch_out", "outs", "launches",
                 "replays")

    def __init__(self, feeds, graph, fetch_out, outs, launches):
        self.feeds = feeds
        self.graph = graph
        self.fetch_out = fetch_out
        self.outs = outs
        self.launches = launches
        self.replays = 0


class StepGraph:
    def __init__(self, core, program, block_id, entry, state_names,
                 fixed_shapes, mode="train", capture_error_mode="global"):
        self._program = program
        # "thread_local" where another thread may replay or launch while
        # this one captures (a serving bucket's background capture)
        self._capture_error_mode = capture_error_mode
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
        # the card: {feed signature: _Capture}, the memory pool they all
        # capture into (the first capture's) and the stream they warm up
        # and capture on
        self._captures = {}
        self._pool = None
        self._side = None
        # the step's generators (lowering.RandomStream): reset to the
        # step's seed before each step, and registered with the graph
        self._stream = RandomStream(self._device)
        # each assign_value's, fill's and prior_box's constant, on the
        # device once: a replay reads it there (its lowering would copy
        # from the host)
        self._constants = {}
        for op in entry.ops + entry.body_ops:
            make = CONSTANT_OPS.get(op.type)
            if make is None:
                continue
            const = make({k: a.value for k, a in op.attrs.items()},
                         self._device,
                         lambda slot, op=op: self._desc_shape(op, slot))
            if const is not None:
                self._constants[id(op)] = const

    def _desc_shape(self, op, slot):
        """The desc shape of ``op``'s (first) input in ``slot``."""
        name = op.input(slot)[0]
        for block in self._program.blocks:
            if name in block.vars:
                return tuple(block.vars[name].shape)
        raise KeyError("var %r of %s not found" % (name, op.type))

    def load_state(self, name, value):
        """Copy a scope value into the static tensor of ``name``."""
        src = to_device(value, self._device)
        cur = self.state.get(name)
        if cur is not None and cur.shape == src.shape \
                and cur.dtype == src.dtype:
            cur.copy_(src)
            return
        if self._captures:
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
        sig = _signature(feeds)
        cap = self._captures.get(sig)
        if cap is None:
            cap = self._build_graph({n: t.to(self._device, copy=True)
                                     for n, t in feeds.items()}, seed)
            self._captures[sig] = cap
        else:
            for n, t in feeds.items():
                cap.feeds[n].copy_(t)
        # the replay reads the generators' seeds and offsets as they
        # stand: this step's
        self._stream.reset(seed)
        cap.graph.replay()
        cap.replays += 1
        kernels.add_launches(cap.launches)
        # a re-stage drops the write-only outputs: the replay made them
        self.outs.update(cap.outs)
        return [t.clone() for t in cap.fetch_out]

    @property
    def buckets(self):
        """{feed shapes: {"captures", "replays"}}: each captured graph
        (one per padded signature of the ragged feeds) and the replays it
        made."""
        return {" ".join("%s%s" % (n, list(shape)) for n, shape, _ in sig):
                {"captures": 1, "replays": cap.replays}
                for sig, cap in self._captures.items()}

    def check(self, feeds):
        """Before a step: raise PreparedShapeMismatch for a dense feed of
        another shape than the step's or, on a card, a feed of another
        dtype, and RuntimeError if a flag of ``LOWERING_FLAGS`` changed.
        A ragged feed's shape may change (a new bucket)."""
        if self._flags != _lowering_flags():
            raise RuntimeError(
                "FLAGS %s changed since prepare() (%s then): the prepared "
                "step keeps the flags it was prepared with; prepare again"
                % (_lowering_flags(), self._flags))
        if self._fixed is None:
            if not self._capture:
                return
            self._fixed = {n: tuple(t.shape) for n, t in feeds.items()}
        # every capture stages a feed in the same dtype
        cap = next(iter(self._captures.values()), None)
        for name, t in feeds.items():
            want = self._fixed.get(name)
            if want is not None and tuple(t.shape) != want and \
                    not _ragged(name, feeds):
                raise PreparedShapeMismatch(
                    "feed %r shape %s != the prepared step's %s: prepare "
                    "again for the new batch shape, or use run()"
                    % (name, tuple(t.shape), want))
            if cap is not None and t.dtype != cap.feeds[name].dtype:
                raise PreparedShapeMismatch(
                    "feed %r dtype %s != the captured step's %s"
                    % (name, t.dtype, cap.feeds[name].dtype))

    def _ctx(self, env, seed):
        return LoweringContext(self._program, self._block_id, env,
                               self._device, seed=seed, mesh=self._mesh,
                               stream=self._stream, mode=self._mode,
                               constants=self._constants)

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

    def _build_graph(self, feeds, seed):
        """Warm up and capture the step on static ``feeds``; returns its
        _Capture."""
        env = {**self.state, **feeds}
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

        if self._side is None:
            self._side = torch.cuda.Stream(self._device)
        graph, (fetches, outs), launches = capture(
            step, "the prepared step", at_op, restore=restore,
            stream=self._side, generators=self._stream.generators,
            pool=self._pool, capture_error_mode=self._capture_error_mode)
        if self._pool is None:
            self._pool = graph.pool()
        return _Capture(feeds, graph, fetches, outs, launches)


def capture(step, what, where=None, restore=None,
            capture_error_mode="global", stream=None, generators=None,
            pool=None):
    """Capture one call of ``step()`` as a CUDA graph; returns (graph,
    what that call returned, {kernel name: launches one replay makes}).

    ``WARMUP_STEPS`` calls run first on a side stream (``stream``, else
    a new one): they build the kernels and let cuBLAS and cuDNN choose
    their algorithms; ``restore()`` then undoes what they wrote.  The
    capture runs on ``stream`` (else ``torch.cuda.graph``'s own) into
    ``pool`` (a ``graph.pool()`` handle), else a private memory pool.
    ``generators()`` (after the warm-ups) lists the ``torch.Generator``s
    the step draws from: they are registered with the graph, so that
    each replay draws from their seeds and offsets as they stand then
    (``lowering.RandomStream``).  The launches the wrappers count while
    this thread captures are taken back: recording a launch is not
    making one, so the caller adds them at each replay.  A capture
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
            with torch.cuda.graph(graph, pool=pool, stream=stream,
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
