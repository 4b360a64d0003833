"""Core Executor: runs a block of a ProgramDesc against a Scope.

Counterpart of ``paddle_tpu/core/executor_impl.py``'s ``ExecutorCore``
and ``PreparedProgram``.  Where the JAX package functionalizes the block
into one jitted XLA computation, this runs the block's ops eagerly, in
order, on the place's device (``lowering.run_op``):

- feeds become tensors on the device (int64 ids stay int64, after the
  JAX package's out-of-range check);
- a value neither fed nor written earlier in the block is read from the
  scope;
- every persistable variable the block writes (parameters, optimizer
  state) is written back to the scope after the run;
- a non-persistable, non-fetched value is dropped after its last reader
  in the block, so a training step does not keep every activation and
  every gradient alive to the end;
- everything runs under ``torch.no_grad()``: gradients come from the
  program's own ``*_grad`` ops.

The block's plan (its core ops, the names it reads from outside in
order, the persistables it writes, the fetches and the free plan) is the
port's analog of the JAX package's compiled entry: ``_CacheEntry``,
shared by ``run()`` and ``prepare()``.  Unlike a compiled executable it
depends on no feed shape and no flag (the lowering reads the flags each
time it runs), so it is keyed on the program's uid and version, the
block, the fetch list and AMP alone.

``prepare()`` returns a ``PreparedProgram``: the block's inputs that are
not fed and the persistables it writes stay device-resident from step
to step in a ``step_graph.StepGraph``, which on a card captures the
step as one CUDA graph (the analog of ``jax.jit`` with donated
parameters); ``sync_scope`` writes them back to the scope, and every
read of the scope flushes them first.

With a ``mesh`` (``parallel.Mesh``), the ops that shard over it (the
ring attention op under an ``sp`` axis) place their shards on the
mesh's devices; every other op runs on the place's device.

A SelectedRows (a sparse gradient, ``core/selected_rows.py``) travels
through the block's environment like a tensor; a fetch of one comes back
as a SelectedRows with numpy rows and values.  A program cloned for test
runs in test mode (``LoweringContext.mode``: dropout and batch norm
infer), as the JAX package's executor does.

Under bf16 AMP (``program.amp_bf16``) the lowering casts each op's
inputs (``lowering.amp_cast_ins``), on a mesh as without one: the ring
attention runs its shards' folds and backward steps in bf16 (K9's and
K2/K3's bf16 forms on a card).

Host ops (``ops/io_ops.py``: feed, fetch, save, load, print, ...) run on
the host as in the JAX package: those before the first device op as a
prelude, those after the last as a postlude (handed, through an env,
the temporaries they read and the fetches they write), and a block with
host ops between device ops op by op (``_run_interpreted``); an
all-host program (a save or a load) makes no plan.  ``prepare()``
refuses a block with host ops (ValueError): callers run() it.

A ragged (LoD) feed (``core/lod.LoDTensor``) is padded on the host
(``_prepare_lod_feeds``, the JAX package's bridge: T up to a multiple of
``LOD_PAD_MULTIPLE``, nested levels to ``LOD_SEQ_PAD_MULTIPLE``) and
goes to the device beside its int32 lengths '<name>@LEN' (and
'<name>@LEN@j' for level j of a nested LoD); the sequence ops read
them from the env (``lowering.LoweringContext.seq_len_of``).  A length
never becomes a variable: no '@LEN' name reaches the scope, a fetch of
one the block did not make is None, and the prepared step keeps them
with its feeds, not its state.  On a card the prepared step keeps one
captured graph per padded signature of its ragged feeds
(``step_graph.StepGraph``); a dense feed of another shape still raises
``PreparedShapeMismatch``.

Not ported yet: GSPMD's partition of the whole step over a mesh, and
the prepared step's numerics twin (``entry_health``, bisect
snapshots), buffer sanitizer and telemetry spans and counters (no
observability module is ported).
"""
from __future__ import annotations

import numpy as np
import torch

from .flags import FLAGS
from .lod import LoDTensor
from .lowering import LoweringContext, run_op
from .registry import get_op_info
from .selected_rows import SelectedRows
from .types import proto_to_np_dtype

_INT32_MAX = 2 ** 31 - 1
_INT32_MIN = -(2 ** 31)

# a callable op -> context manager that every op runs inside, e.g. CUDA
# events around it for its device time (tools/profile_train.py); None,
# the loop pays one test per op
OP_HOOK = None


LEN_SUFFIX = "@LEN"
# a ragged batch's time dim is padded up to a multiple of this, so the
# number of distinct shapes (and of captured graphs) stays bounded
LOD_PAD_MULTIPLE = 8
# nested feeds bucket their outer (sub-sequence count) dims too
LOD_SEQ_PAD_MULTIPLE = 4


def _prepare_lod_feeds(feed):
    """The JAX package's feed bridge, unchanged: LoDTensor feeds ->
    padded dense array + '<name>@LEN' lengths.  Level-2 LoD pads to
    [N, S, W, ...] with '@LEN' = outer sentence lengths and '@LEN@1' =
    [N, S] inner sub-sequence lengths; deeper LoD generalizes
    recursively, one padded dim and one '@LEN@j' array per level
    (reference lod_tensor.h:58 depth-unbounded LoD).  Dense feeds pass
    through, and a feed without a LoDTensor returns as it came."""
    for v in feed.values():
        if isinstance(v, LoDTensor) and v.lod:
            break
    else:
        return feed

    for name, v in list(feed.items()):
        if not (isinstance(v, LoDTensor) and v.lod):
            continue
        if len(v.lod) > 2:
            # level k >= 3: the outer ragged dims bucket to
            # LOD_SEQ_PAD_MULTIPLE, the innermost (time) to
            # LOD_PAD_MULTIPLE; '@LEN@j' carries level j's lengths
            k = len(v.lod)
            max_dims = []
            for j in range(k):
                mult = LOD_PAD_MULTIPLE if j == k - 1 \
                    else LOD_SEQ_PAD_MULTIPLE
                mx = max(v.sequence_lengths(j), default=1)
                max_dims.append(-(-max(mx, 1) // mult) * mult)
            padded, lens = v.to_padded_klevel(max_dims=max_dims)
            feed[name] = padded
            feed[name + LEN_SUFFIX] = lens[0].astype(np.int32)
            for j in range(1, k):
                feed[name + LEN_SUFFIX + "@%d" % j] = \
                    lens[j].astype(np.int32)
            continue
        if len(v.lod) == 2:
            # both ragged dims bucket; the sequence ops fold '@LEN@1'
            # and work at the finest level (ops/sequence._fold_level2)
            s_max = max((v.lod[0][i + 1] - v.lod[0][i]
                         for i in range(len(v.lod[0]) - 1)), default=1)
            w_max = max((v.lod[1][j + 1] - v.lod[1][j]
                         for j in range(len(v.lod[1]) - 1)), default=1)
            s_max = -(-max(s_max, 1) // LOD_SEQ_PAD_MULTIPLE) * \
                LOD_SEQ_PAD_MULTIPLE
            w_max = -(-max(w_max, 1) // LOD_PAD_MULTIPLE) * \
                LOD_PAD_MULTIPLE
            padded, outer, inner = v.to_padded_2level(
                max_seq=s_max, max_word=w_max)
            feed[name] = padded
            feed[name + LEN_SUFFIX] = outer.astype(np.int32)
            feed[name + LEN_SUFFIX + "@1"] = inner.astype(np.int32)
            continue
        lens = v.sequence_lengths(0)
        t = max(lens) if lens else 1
        t = -(-max(t, 1) // LOD_PAD_MULTIPLE) * LOD_PAD_MULTIPLE
        padded, lengths = v.to_padded(max_len=t)
        feed[name] = padded
        feed[name + LEN_SUFFIX] = lengths.astype(np.int32)
    return feed


def is_len_name(name):
    """True for a sequence-length companion ('<name>@LEN[@j]')."""
    return LEN_SUFFIX in name


def lod_feed_names(block, names):
    """``names`` with the '@LEN' companions of every ragged one (its
    var's ``lod_level`` k > 0: '@LEN' and '@LEN@1' .. '@LEN@{k-1}'),
    for a prepared step given feed names alone."""
    out = list(names)
    for name in names:
        vd = block.find_var_recursive(name)
        k = getattr(vd, "lod_level", 0) if vd is not None else 0
        if k:
            out.append(name + LEN_SUFFIX)
            out.extend(name + LEN_SUFFIX + "@%d" % j for j in range(1, k))
    return out


class PreparedShapeMismatch(ValueError):
    """A feed's shape differs from the one the prepared step was built
    (on a card: captured) for; the caller should run() this batch or
    prepare again."""


class Uncapturable(NotImplementedError):
    """prepare() on a card refuses a block whose step a CUDA graph replay
    cannot reproduce; ParallelExecutor runs such a program through
    run()."""


class _CacheEntry:
    """A block's plan: ``ops`` (the core ops), ``input_names`` (the names
    read before the block writes them, in order: feeds and scope
    values), ``persist_outs`` (the persistables it writes, sorted),
    ``fetch_names``, ``free_after`` (``_free_plan``) and ``body_ops``
    (the ops of the sub-blocks its control-flow ops run, at any
    depth)."""

    __slots__ = ("ops", "input_names", "persist_outs", "fetch_names",
                 "free_after", "body_ops")

    def __init__(self, ops, input_names, persist_outs, fetch_names,
                 free_after, body_ops):
        self.ops = ops
        self.input_names = input_names
        self.persist_outs = persist_outs
        self.fetch_names = fetch_names
        self.free_after = free_after
        self.body_ops = body_ops


def _cache_key(program, block_id, fetch_list):
    """The one plan-cache key, shared by run() and prepare(): what the
    plan depends on.  (The flags the lowering reads are read as it runs;
    a prepared step holds those it was prepared with, step_graph.)"""
    return (program.uid, program.version, block_id, tuple(fetch_list),
            bool(getattr(program, "amp_bf16", False)))


def run_block(ctx, entry):
    """Run ``entry``'s ops over ``ctx.env`` under no_grad, dropping each
    value after its last reader; ``ctx.op`` names the op running."""
    env = ctx.env
    free_after = entry.free_after
    with torch.no_grad():
        for i, op in enumerate(entry.ops):
            ctx.op = op
            if OP_HOOK is None:
                run_op(ctx, op)
            else:
                with OP_HOOK(op):
                    run_op(ctx, op)
            for name in free_after.get(i, ()):
                env.pop(name, None)
    ctx.op = None


def flush_prepared(scope, exclude=None):
    """sync_scope() every dirty prepared program attached to ``scope``
    or an ancestor."""
    s = scope
    while s is not None:
        if s._prepared_registry:
            s.flush_prepared(exclude)
        s = s._parent


def seen_entry(scope, name):
    """(owning scope, write version) of ``name``: recorded when a value
    is read or installed, compared later to tell one's own writes from
    someone else's."""
    s = scope.find_scope_of(name)
    return (s, s._write_versions.get(name) if s is not None else None)


def seen_changed(scope, name, seen):
    """True when ``name`` was written since ``seen`` was recorded (or
    never recorded): the scope's value wins over device state."""
    if seen is None:
        return True
    cur = seen_entry(scope, name)
    return cur[0] is not seen[0] or cur[1] != seen[1]


class PreparedProgram:
    """Reference Executor::Prepare + RunPreparedContext: the block's plan
    is made once, and its state (every input that is not fed, and every
    persistable it writes) stays on the device from step to step in a
    ``step_graph.StepGraph``.  ``run_prepared`` stages the feeds and runs
    one step (on a card, one CUDA graph replay) and returns the fetches
    as tensors; ``sync_scope`` writes the state back to the scope (on
    every run()'s and every scope read's flush, and on context exit).

    A write to the scope bumps its version, so the next step re-stages
    the state from the scope; the per-name write versions tell this
    program's own write-backs from external writes, and a name someone
    else wrote always wins over the device copy."""

    def __init__(self, core, program, block_id, entry, scope, feed_names,
                 fixed_shapes, mode="train"):
        from .step_graph import StepGraph

        self._core = core
        self._program = program
        self._block_id = block_id
        self._entry = entry
        self._scope = scope
        self._feed_names = frozenset(feed_names)
        self._program_version = program.version
        block = program.blocks[block_id]
        self._state_names = [n for n in entry.input_names
                             if n not in self._feed_names]
        written = set(entry.persist_outs)
        self._read_only = [n for n in self._state_names if n not in written]
        self._seen = {}   # name -> (owning scope, write version) we saw
        self._step = StepGraph(core, program, block_id, entry,
                               self._state_names, fixed_shapes, mode)
        self._block = block
        # another prepared program may hold newer values of our state
        flush_prepared(scope)
        self._refresh_from_scope()
        self._dirty = False
        self._scope_epoch = scope.chain_version()
        # register on every scope that owns a resident name too: a
        # reader rooted at an ancestor never walks down to ``scope``
        owners = {id(scope): scope}
        for name in self._state_names + list(entry.persist_outs):
            s = scope.find_scope_of(name)
            if s is not None:
                owners.setdefault(id(s), s)
        for s in owners.values():
            s.attach_prepared(self)

    @property
    def fetch_names(self):
        return self._entry.fetch_names

    @property
    def is_stale(self):
        """True once the program changed after prepare() (its version
        moved): sync_scope and prepare again."""
        return self._program.version != self._program_version

    def _refresh_from_scope(self):
        """Re-stage the resident inputs from the scope (after a run() or
        an external write), reading each owning scope's storage (other
        prepared programs were flushed already) and recording its write
        version."""
        scope = self._scope
        for name in self._state_names:
            s = scope.find_scope_of(name)
            if s is None:
                raise KeyError(
                    "variable %r is neither fed nor in the scope (run the "
                    "startup program first?)" % name)
            self._step.load_state(name, s._vars[name])
            self._seen[name] = (s, s._write_versions.get(name))
        # write-only persistables are rebuilt by the next step: drop the
        # old output, keep a baseline to catch an external write
        for name in self._entry.persist_outs:
            if name not in self._step.state:
                self._step.outs.pop(name, None)
                self._seen[name] = seen_entry(scope, name)

    def run_prepared(self, feed=None):
        """Stage ``feed`` and run one step; returns the fetch list as
        tensors (fresh ones, which the next step leaves alone)."""
        if self.is_stale:
            raise RuntimeError(
                "program mutated since prepare() (version %d -> %d): the "
                "prepared step is stale; prepare again" %
                (self._program_version, self._program.version))
        scope = self._scope
        flush_prepared(scope, exclude=self)
        if scope.chain_version() != self._scope_epoch:
            # someone wrote the scope since our last sync: install our
            # updates first, so the re-stage reads a whole scope
            if self._dirty:
                self.sync_scope()
            self._refresh_from_scope()
            self._scope_epoch = scope.chain_version()
        feed = _prepare_lod_feeds(dict(feed or {}))
        if feed.keys() != self._feed_names:
            self._check_feed_names(feed)
        staged = {name: self._core._feed_host(self._block, name, feed[name])
                  for name in self._feed_names}
        # a refused step draws no seed: the run() that takes its batch
        # draws the one this step would have
        self._step.check(staged)
        fetches = self._step.run(staged, _run_seed(self._program, scope))
        self._dirty = True
        return fetches

    def _check_feed_names(self, feed):
        missing = self._feed_names - feed.keys()
        if missing:
            raise KeyError(
                "prepared program expects feed(s) %s (prepared "
                "signature: %s)" % (sorted(missing),
                                    sorted(self._feed_names)))
        resident = feed.keys() & set(self._state_names)
        if resident:
            raise ValueError(
                "feed(s) %s are device-resident state of this prepared "
                "program; sync_scope() + run(), or prepare again with them "
                "in feed_specs" % sorted(resident))
        # extra feeds the block never reads are ignored, like run()

    def sync_scope(self):
        """Write the written persistables back to the scope, each as a
        copy of the device state (the next step updates the state in
        place).  A name written externally since we last read or
        installed it wins: our copy is dropped and re-staged from the
        scope before the next step."""
        scope = self._scope
        stale = False
        for name in self._entry.persist_outs:
            val = self._step.current(name)
            if val is None:
                continue
            if seen_changed(scope, name, self._seen.get(name)):
                self._step.outs.pop(name, None)
                self._seen.pop(name, None)
                stale = True
                continue
            s = scope.find_scope_of(name) or scope
            s.set(name, val.clone())
            self._seen[name] = (s, s._write_versions[name])
        # an external write to read-only state (a learning rate) must
        # be caught here: installing our outputs moves the epoch past it
        if not stale:
            stale = any(seen_changed(scope, name, self._seen.get(name))
                        for name in self._read_only)
        self._dirty = False
        self._scope_epoch = None if stale else scope.chain_version()

    # ``with exe.prepare(...) as prep:`` syncs on exit
    def __enter__(self):
        return self

    def __exit__(self, exc_type, exc, tb):
        if self._dirty:
            self.sync_scope()
        return False


class ExecutorCore:
    """place: the device every op runs on.  mesh: an optional
    ``parallel.Mesh`` that the sharded ops lay their shards over."""

    def __init__(self, place, mesh=None):
        self.place = place
        self.device = place.torch_device()
        self.mesh = mesh
        self._cache = {}

    def run(self, program, scope, block_id=0, feed=None, fetch_list=None,
            return_numpy=True, mode="train"):
        # device-resident prepared state lands in the scope first
        flush_prepared(scope)
        block = program.blocks[block_id]
        feed = _prepare_lod_feeds(dict(feed or {}))
        fetch_list = list(fetch_list or [])
        prelude, core_ops, postlude, mixed = _segment(block)
        if mixed:
            # the op-by-op path runs every op, host ops included: running
            # a prelude or postlude here too would run them twice
            fetches = self._run_interpreted(program, block_id, scope, feed,
                                            fetch_list, mode)
        else:
            for op in prelude:
                _run_host_op(self, op, scope, feed)
            # postlude host ops may read temporaries the block computed
            # (a print of an activation): the block returns those too,
            # and they reach the ops through an env, not the scope; and
            # the fetches the postlude writes come out of that env
            post_writes = {n for op in postlude
                           for n in op.output_arg_names() if n}
            core_fetch = [n for n in fetch_list if n not in post_writes]
            post_in = [n for op in postlude for n in op.input_arg_names()
                       if n]
            # the '@LEN' companions ride along, so a host op sees the
            # real sequence lengths, not the padded T (None where the
            # block made none)
            post_in += [n + LEN_SUFFIX for n in list(post_in)]
            post_reads = sorted({
                n for n in post_in
                if n not in feed and not scope.has_var(n)
                and n not in post_writes})
            if core_ops or core_fetch or post_reads:
                outs = self._run_core(program, block_id, scope, feed,
                                      core_fetch + post_reads, mode)
            else:
                outs = []   # an all-host program (save, load): no plan
            by_name = dict(zip(core_fetch, outs[:len(core_fetch)]))
            post_env = dict(zip(post_reads, outs[len(core_fetch):]))
            for op in postlude:
                _run_host_op(self, op, scope, feed,
                             post_env if (post_reads or post_writes)
                             else None)
            fetches = [by_name[n] if n in by_name else post_env.get(n)
                       for n in fetch_list]
        if return_numpy:
            fetches = fetches_to_host(fetches)
        return fetches

    def _run_core(self, program, block_id, scope, feed, fetch_list, mode):
        """Run the block's device ops through its plan; returns the
        fetches as tensors."""
        block = program.blocks[block_id]
        env = {name: self._feed_host(block, name, val).to(self.device)
               for name, val in feed.items()}
        entry = self._entry(program, block_id, fetch_list)
        for name in entry.input_names:
            if name not in env:
                env[name] = self._scope_tensor(scope, name)
        ctx = LoweringContext(program, block_id, env, self.device,
                              seed=_run_seed(program, scope), mesh=self.mesh,
                              mode=mode)
        run_block(ctx, entry)
        for name in entry.persist_outs:
            (scope.find_scope_of(name) or scope).set(name, env[name])
        return [env.get(name) if is_len_name(name) else env[name]
                for name in fetch_list]

    def _run_interpreted(self, program, block_id, scope, feed, fetch_list,
                         mode):
        """A block with host ops between its device ops: every op in
        order, each host op once, over an env that reads the scope as it
        stands when an op first asks for a name (so a value a host op
        loaded is what the device ops after it read)."""
        block = program.blocks[block_id]
        env = _ScopeEnv(scope, self.device)
        for name, val in feed.items():
            env[name] = self._feed_host(block, name, val).to(self.device)
        ctx = LoweringContext(program, block_id, env, self.device,
                              seed=_run_seed(program, scope), mesh=self.mesh,
                              mode=mode)
        with torch.no_grad():
            for op in block.ops:
                if get_op_info(op.type).host_op:
                    _run_host_op(self, op, scope, feed, env)
                    continue
                ctx.op = op
                if OP_HOOK is None:
                    run_op(ctx, op)
                else:
                    with OP_HOOK(op):
                        run_op(ctx, op)
        ctx.op = None
        for name in env.written:
            vd = block.find_var_recursive(name)
            if vd is not None and vd.persistable:
                (scope.find_scope_of(name) or scope).set(name, env[name])
        return [env.get(n) for n in fetch_list]

    def prepare(self, program, feed_specs, fetch_list, scope=None,
                block_id=0, mode="train"):
        """Reference Executor::Prepare: make the block's plan once and
        return a PreparedProgram whose step is feed staging and one
        dispatch (on a card, one CUDA graph replay).

        ``feed_specs`` is a sample feed dict (the first batch: its
        shapes fix the step's, and a batch of another shape raises
        PreparedShapeMismatch) or an iterable of feed names (on a card
        the first run_prepared's feed fixes the shapes).  A ragged feed
        may change its padded shape from batch to batch: the step takes
        each new bucket (on a card, captures a graph for it).  Raises
        ValueError for a block holding host ops, so that callers fall
        back to run()."""
        if scope is None:
            raise ValueError(
                "prepare() requires the scope holding the program's "
                "persistables (run the startup program into it first)")
        if feed_specs is None:      # a block fed from the scope alone
            feed_specs = {}
        fetch_list = list(fetch_list or [])
        block = program.blocks[block_id]
        prelude, _, postlude, mixed = _segment(block)
        if mixed or prelude or postlude:
            host = sorted({op.type for op in block.ops
                           if get_op_info(op.type).host_op})
            raise ValueError(
                "block %d has host op(s) %s; the prepared step runs the "
                "whole block on the device: use run()" % (block_id, host))
        fixed = None
        if hasattr(feed_specs, "keys"):
            feed_specs = _prepare_lod_feeds(dict(feed_specs))
            fixed = {name: tuple(self._feed_host(block, name, val).shape)
                     for name, val in feed_specs.items()}
        else:
            feed_specs = lod_feed_names(block, list(feed_specs))
        entry = self._entry(program, block_id, fetch_list)
        if self.device.type == "cuda":
            self._refuse_uncapturable(entry)
        return PreparedProgram(self, program, block_id, entry, scope,
                               feed_specs, fixed, mode)

    def _entry(self, program, block_id, fetch_list):
        key = _cache_key(program, block_id, fetch_list)
        entry = self._cache.get(key)
        if entry is None:
            entry = self._build(program, block_id, fetch_list)
            self._cache[key] = entry
        return entry

    def _build(self, program, block_id, fetch_list):
        block = program.blocks[block_id]
        _, core_ops, _, _ = _segment(block)
        written, external, seen = set(), [], set()
        for op in core_ops:
            for name in op.input_arg_names():
                if name and name not in written and name not in seen:
                    seen.add(name)
                    external.append(name)
            written.update(n for n in op.output_arg_names() if n)
        # fetching a name the block does not write reads it; a '@LEN'
        # fetch is a length the run makes in the env (or None), never
        # read from outside
        for name in fetch_list:
            if name not in written and name not in seen and \
                    not is_len_name(name):
                seen.add(name)
                external.append(name)
        persist_outs = sorted(
            n for n in written
            if (vd := block.find_var_recursive(n)) is not None
            and vd.persistable)
        from ..ops.control_flow import body_ops

        bodies = [o for op in core_ops if "sub_block" in op.attrs
                  for o in body_ops(program,
                                    int(op.attrs["sub_block"].value))]
        return _CacheEntry(list(core_ops), external, persist_outs,
                           list(fetch_list),
                           _free_plan(block, core_ops, set(fetch_list)),
                           bodies)

    def _refuse_uncapturable(self, entry):
        """A card captures the prepared step as one CUDA graph; refuse
        (Uncapturable) what a replay cannot reproduce, in the block and
        in every sub-block its control-flow ops run, at any depth.
        (Random ops are not refused: ``lowering.RandomStream`` draws
        afresh at each replay; nor is ``assign_value``: the step reads a
        device constant made at ``prepare()``.)"""
        ops = entry.ops + entry.body_ops
        host_read = sorted({op.type for op in ops
                            if op.type in ("while", "conditional_block")})
        if host_read:
            raise Uncapturable(
                "prepare() on a card: %s read(s) its condition on the host "
                "at every step, which a CUDA graph replay cannot repeat; "
                "use run()" % host_read)
        if any(op.type == "lod_reset" and not op.inputs.get("Y")
               for op in ops):
            raise Uncapturable(
                "prepare() on a card: lod_reset copies its target_lod "
                "lengths from host memory at every step, which a CUDA "
                "graph cannot capture; use run()")
        if self.mesh is not None and any(
                d != self.device for d in map(_indexed, self.mesh.devices)):
            raise Uncapturable(
                "prepare() on a mesh over distinct cards %s: the captured "
                "step runs on one card (ROADMAP queue 1 item 10)"
                % sorted({str(d) for d in self.mesh.devices}))

    def _feed_host(self, block, name, val):
        """A feed as a tensor, as given (a tensor) or from the host
        value in the variable's dtype, int64 range-checked."""
        if isinstance(val, torch.Tensor):
            return val
        vd = block.find_var_recursive(name)
        if vd is not None and not hasattr(val, "dtype"):
            arr = np.asarray(val, dtype=proto_to_np_dtype(vd.dtype))
        else:
            arr = np.asarray(val)
        if arr.dtype.kind in "iu" and arr.dtype.itemsize == 8 and arr.size:
            _check_int32_range(name, arr)
        return torch.from_numpy(np.ascontiguousarray(arr))

    def _scope_tensor(self, scope, name):
        try:
            val = scope.find_var(name)
        except KeyError:
            raise KeyError(
                "variable %r is neither fed nor in the scope (run the "
                "startup program first?)" % name) from None
        return to_device(val, self.device)


def to_device(val, device):
    """A scope value as a tensor (or a SelectedRows) on ``device``
    (numpy converted)."""
    if isinstance(val, SelectedRows):
        return val.to(device) if val.device != device else val
    if isinstance(val, np.ndarray):
        val = torch.from_numpy(val)
    if isinstance(val, torch.Tensor) and val.device != device:
        val = val.to(device)
    return val


def _indexed(device):
    """``device`` with its index filled in (``cuda`` -> ``cuda:N``)."""
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def _check_int32_range(name, arr):
    """The JAX package narrows int64 feeds to int32 and refuses values
    that do not fit (fluid/executor.py ``_guard_int64``).  The port keeps
    them int64 but keeps the refusal, so a program runs on the same feeds
    in both."""
    amax, amin = int(arr.max()), int(arr.min())
    if amax > _INT32_MAX or amin < _INT32_MIN:
        raise ValueError(
            "feed %r: int64 value out of the int32 range ([%d, %d] vs "
            "[-2^31, 2^31-1]); re-index ids/offsets below 2^31"
            % (name, amin, amax))


def _run_seed(program, scope):
    """Seed of this run's random ops: the program's random_seed and a
    per-scope run counter (the JAX package's ``_rng_counter``), which
    run() and run_prepared both advance."""
    counter = getattr(scope, "_rng_counter", 0)
    scope._rng_counter = counter + 1
    seed = getattr(program, "random_seed", 0) or 0
    return (int(seed) * 1000003 + counter) & 0x7FFFFFFFFFFFFFFF


def _free_plan(block, ops, keep):
    """{op index: names to drop after that op}: every non-persistable,
    non-fetched name is dropped after the last op that reads or writes
    it."""
    last = {}
    for i, op in enumerate(ops):
        for name in op.input_arg_names() + op.output_arg_names():
            if name:
                last[name] = i
    plan = {}
    for name, i in last.items():
        if name in keep:
            continue
        vd = block.find_var_recursive(name)
        if vd is not None and vd.persistable:
            continue
        plan.setdefault(i, []).append(name)
    return plan


class _ScopeEnv(dict):
    """The op-by-op path's env: a name it lacks is read from the scope
    (on the executor's device) when first asked for; ``written`` names
    every value set, for the write-back of persistables."""

    def __init__(self, scope, device):
        super().__init__()
        self.scope = scope
        self.device = device
        self.written = set()

    def __contains__(self, name):
        return super().__contains__(name) or self.scope.has_var(name)

    def __missing__(self, name):
        val = to_device(self.scope.find_var(name), self.device)
        super().__setitem__(name, val)
        return val

    def __setitem__(self, name, val):
        self.written.add(name)
        super().__setitem__(name, val)

    def get(self, name, default=None):
        try:
            return self[name]
        except KeyError:
            return default


def _run_host_op(executor, op, scope, feed, env=None):
    get_op_info(op.type).lower(executor, op, scope, feed, env)


def _segment(block):
    """Split ops into host prelude / device core / host postlude.

    Returns (prelude, core, postlude, mixed): ``mixed`` is True when host
    ops are interleaved with device ops."""
    ops = block.ops
    is_host = [get_op_info(op.type).host_op for op in ops]
    i = 0
    while i < len(ops) and is_host[i]:
        i += 1
    j = len(ops)
    while j > i and is_host[j - 1]:
        j -= 1
    mixed = any(is_host[i:j])
    return ops[:i], ops[i:j], ops[j:], mixed


def fetches_to_host(outs):
    """Fetch-list values -> host numpy (None passes through).  numpy has
    no bfloat16: a bf16 value (an AMP activation) comes back as float32,
    exactly; fetch with ``return_numpy=False`` to see its dtype.  A
    SelectedRows (a sparse gradient) comes back as one with numpy rows
    and values, a TensorArray as one with a numpy buffer and size."""
    from ..ops.control_flow import TensorArray

    return [_host(v) if isinstance(v, torch.Tensor)
            else SelectedRows(_host(v.rows), _host(v.values), v.height)
            if isinstance(v, SelectedRows)
            else v.map(_host) if isinstance(v, TensorArray)
            else (None if v is None else np.asarray(v)) for v in outs]


def _host(t):
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()
