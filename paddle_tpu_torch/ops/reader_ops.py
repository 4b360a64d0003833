"""Program-level reader-op chain (parity: paddle/fluid/operators/reader/
— create_recordio_file_reader_op, create_shuffle_reader_op,
create_batch_reader_op, create_double_buffer_reader_op, read_op, and
framework/reader.h's ReaderBase chain).

Counterpart of ``paddle_tpu/ops/reader_ops.py``: the 10 host op types
and their reader classes, the chain's host state kept in the scope as
the JAX package keeps it.  The readers draw from numpy ``RandomState``
with the reference's seeds, so the shuffled orders and the random
reader's samples are the JAX package's bit for bit.  The double-buffer
stage stages each upcoming batch on ``executor.device`` from a thread:
pinned host tensors copied with ``non_blocking=True`` on a dedicated
copy stream (``reader/device_loader.StagedCopy``), the consumer's
stream waiting on the copy's event, where the reference staged
pinned-memory copies (reader/create_double_buffer_reader_op.cc).
A ``read`` op is a prelude host op of the main block
(``core/executor_impl.py``): ``run()`` runs it before the device ops,
which find its outputs in the scope; ``prepare()`` refuses the block.
"""
from __future__ import annotations

import pickle
import queue
import threading

import numpy as np

from paddle_tpu_torch.core.registry import register_op
from paddle_tpu_torch.core.executor_impl import EOFException


def _host(name):
    def deco(impl):
        register_op(name, lower=impl, host_op=True, grad_maker=None)
        return impl

    return deco


class _ReaderBase:
    """next() -> tuple of per-slot numpy arrays for ONE sample/batch;
    raises EOFException when drained; reset() rewinds."""

    def next(self):
        raise NotImplementedError

    def reset(self):
        raise NotImplementedError


class _RecordIOReader(_ReaderBase):
    def __init__(self, filename, pass_num=1):
        self.filename = filename
        self.pass_num = max(1, int(pass_num))
        self._iter = None
        self._passes_left = self.pass_num

    def _scanner(self):
        from paddle_tpu_torch import recordio
        for rec in recordio.Scanner(self.filename):
            sample = pickle.loads(rec)
            if isinstance(sample, dict):  # feeder-serialized form
                sample = tuple(sample.values())
            yield tuple(np.asarray(x) for x in sample)

    def next(self):
        if self._iter is None:
            self._iter = self._scanner()
        try:
            return next(self._iter)
        except StopIteration:
            self._iter = None
            self._passes_left -= 1
            if self._passes_left > 0:  # pass_num epochs before EOF
                return self.next()
            self._passes_left = self.pass_num
            raise EOFException(self.filename)

    def reset(self):
        self._iter = None
        self._passes_left = self.pass_num


class _ShuffleReader(_ReaderBase):
    def __init__(self, parent, buffer_size, seed=0):
        self.parent = parent
        self.buffer_size = int(buffer_size)
        self.rng = np.random.RandomState(seed)
        self.buf = []
        self.drained = False

    def next(self):
        while not self.drained and len(self.buf) < self.buffer_size:
            try:
                self.buf.append(self.parent.next())
            except EOFException:
                self.drained = True
        if not self.buf:
            self.drained = False
            raise EOFException("shuffle")
        idx = self.rng.randint(len(self.buf))
        self.buf[idx], self.buf[-1] = self.buf[-1], self.buf[idx]
        return self.buf.pop()

    def reset(self):
        self.buf = []
        self.drained = False
        self.parent.reset()


class _BatchReader(_ReaderBase):
    """drop_last=True is the default here (NOT the reference's: its
    BatchReader emits the final partial batch,
    create_batch_reader_op.cc) — a ragged tail batch would change the
    step's shapes every epoch; pass drop_last=False through
    layers.io.batch to restore reference semantics."""

    def __init__(self, parent, batch_size, drop_last=True):
        self.parent = parent
        self.batch_size = int(batch_size)
        self.drop_last = drop_last

    def next(self):
        rows = []
        try:
            for _ in range(self.batch_size):
                rows.append(self.parent.next())
        except EOFException:
            if not rows or self.drop_last:
                raise EOFException("batch")
        return tuple(np.stack([r[i] for r in rows])
                     for i in range(len(rows[0])))

    def reset(self):
        self.parent.reset()


class _DoubleBufferReader(_ReaderBase):
    """Thread prefetches upcoming batches and stages them on the target
    device (a copy stream on a card), overlapping host decode + transfer
    with device compute."""

    def __init__(self, parent, capacity=2, place=None):
        self.parent = parent
        self.capacity = int(capacity)
        self.place = place
        self._copier = None
        self._q = None
        self._thread = None
        self._stop = None

    def _start(self):
        from paddle_tpu_torch.reader.device_loader import StagedCopy

        if self._copier is None and self.place is not None:
            self._copier = StagedCopy(self.place.torch_device())
        copier = self._copier
        q = queue.Queue(self.capacity)
        stop = threading.Event()
        self._q, self._stop = q, stop

        def work():
            # q/stop are captured locally: a superseded worker can never
            # touch the queue of the thread that replaced it
            try:
                while not stop.is_set():
                    batch = self.parent.next()
                    q.put(copier.stage(batch) if copier is not None
                          else (batch, None))
            except EOFException:
                q.put(EOFException("double_buffer"))
            except Exception as e:  # surface decode errors to the reader
                q.put(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next(self):
        if self._thread is None:
            self._start()
        item = self._q.get()
        if isinstance(item, Exception):
            self._thread = None
            raise item
        tensors, event = item
        if event is None:
            return tuple(tensors)
        # the consumer's (the executor's) stream waits for the copy
        return tuple(self._copier.ready(tensors, event))

    def reset(self):
        thread, q, stop = self._thread, self._q, self._stop
        self._thread = None
        if thread is not None and thread.is_alive():
            # mid-epoch reset: signal the worker, unblock any pending
            # put, and WAIT for it to die before rewinding the parent —
            # otherwise two threads race on the unsynchronized chain
            stop.set()
            while thread.is_alive():
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                thread.join(timeout=0.05)
        if q is not None:
            while True:  # drop the staged batches the worker left
                try:
                    q.get_nowait()
                except queue.Empty:
                    break
        if self._copier is not None:
            # no copy of a dropped batch is left in flight
            self._copier.synchronize()
        self.parent.reset()


class _MultiPassReader(_ReaderBase):
    """Replay the underlying chain pass_num times before raising EOF
    (reference create_multi_pass_reader_op.cc: the trainer loop sees N
    epochs as one stream); tracks the current pass for introspection."""

    def __init__(self, parent, pass_num):
        self.parent = parent
        self.pass_num = max(1, int(pass_num))
        self.current_pass = 0

    def next(self):
        # loop, don't recurse into parent.next() bare: an EOF right
        # after an intra-pass reset (empty parent) must keep counting
        # passes, or the NEXT epoch starts with a stale current_pass
        while True:
            try:
                return self.parent.next()
            except EOFException:
                self.current_pass += 1
                if self.current_pass >= self.pass_num:
                    self.current_pass = 0
                    raise
                self.parent.reset()

    def reset(self):
        self.current_pass = 0
        self.parent.reset()


class _ThreadedReader(_ReaderBase):
    """Thread-safe prefetching front (reference
    create_threaded_reader_op.cc: wraps a chain so concurrent ReadNext
    calls are safe).  A single worker drains the (unsynchronized)
    parent into a bounded queue; any number of consumer threads pop."""

    def __init__(self, parent, capacity=16):
        self.parent = parent
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._q = None
        self._thread = None
        self._stop = None

    def _start(self):
        q = queue.Queue(self.capacity)
        stop = threading.Event()
        self._q, self._stop = q, stop

        def work():
            try:
                while not stop.is_set():
                    q.put(self.parent.next())
            except EOFException:
                q.put(EOFException("threaded"))
            except Exception as e:
                q.put(e)

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def next(self):
        with self._lock:
            if self._thread is None:
                self._start()
            q = self._q
        item = q.get()
        if isinstance(item, Exception):
            with self._lock:
                self._thread = None
            # re-enqueue terminal items (EOF or an error) so EVERY
            # blocked consumer sees them, not just the first to pop —
            # the worker has exited and will produce nothing else
            q.put(item)
            raise item
        return item

    def reset(self):
        with self._lock:
            thread, q, stop = self._thread, self._q, self._stop
            self._thread = None
            if thread is not None and thread.is_alive():
                stop.set()
                while thread.is_alive():
                    try:
                        q.get_nowait()
                    except queue.Empty:
                        pass
                    thread.join(timeout=0.05)
            self.parent.reset()


class _CustomReader(_ReaderBase):
    """Per-batch preprocessing through a fluid sub-block (reference
    create_custom_reader_op.cc CustomReader::ReadNext): each batch's
    slots land in the source vars, the sub-block runs through a nested
    executor, and the sink vars come back as the decorated batch."""

    def __init__(self, parent, program, block_id, source_names,
                 sink_names, place, scope):
        from paddle_tpu_torch.core.executor_impl import ExecutorCore

        self.parent = parent
        self.program = program
        self.block_id = int(block_id)
        self.source_names = list(source_names)
        self.sink_names = list(sink_names)
        self._core = ExecutorCore(place)
        # kid scope of the RUN scope (reference CustomReader executes in
        # the run scope): a parameterized sub-block (fc etc.) must see
        # the weights the startup program initialized
        self._scope = scope.new_scope()

    def next(self):
        batch = self.parent.next()
        if len(batch) != len(self.source_names):
            raise ValueError(
                "custom reader: batch has %d slots but %d source vars"
                % (len(batch), len(self.source_names)))
        feed = dict(zip(self.source_names, batch))
        outs = self._core.run(self.program, self._scope, self.block_id,
                              feed=feed, fetch_list=self.sink_names)
        return tuple(np.asarray(o) for o in outs)

    def reset(self):
        self.parent.reset()


def _set_state(scope, name, state):
    (scope.find_scope_of(name) or scope).set(name, state)


def _get_state(scope, name):
    state = scope.find_var(name) if scope.has_var(name) else None
    if not isinstance(state, _ReaderBase):
        raise RuntimeError(
            "%r is not an initialized reader (run the startup program "
            "first)" % name)
    return state


@_host("create_recordio_file_reader")
def _create_recordio(executor, op, scope, feed, env=None):
    _set_state(scope, op.output("Out")[0],
               _RecordIOReader(op.attr("filename"),
                               pass_num=op.attr("pass_num") or 1))


class _MultiFileReader(_ReaderBase):
    """Concatenate several recordio files (reference
    open_files_op/multi_file_reader: N prefetch threads over a file
    list; here files stream sequentially — the double-buffer decorator
    supplies the prefetch thread)."""

    def __init__(self, filenames, pass_num=1):
        self.readers = [_RecordIOReader(f) for f in filenames]
        self.pass_num = max(1, int(pass_num))
        self._idx = 0
        self._passes_left = self.pass_num

    def next(self):
        while True:
            if self._idx >= len(self.readers):
                self._idx = 0
                self._passes_left -= 1
                if self._passes_left <= 0:
                    self._passes_left = self.pass_num
                    raise EOFException("open_files")
            try:
                return self.readers[self._idx].next()
            except EOFException:
                self._idx += 1

    def reset(self):
        self._idx = 0
        self._passes_left = self.pass_num
        for r in self.readers:
            r.reset()


class _ParallelFilesReader(_ReaderBase):
    """N worker threads each scan a round-robin subset of the files
    into one bounded queue (reference open_files_op's multi_file_reader
    thread pool); sample order across files is nondeterministic, EOF
    fires once every worker drained its subset."""

    def __init__(self, filenames, thread_num, capacity=64):
        self.filenames = list(filenames)
        self.thread_num = max(1, min(int(thread_num),
                                     len(self.filenames) or 1))
        self.capacity = int(capacity)
        self._q = None
        self._threads = None
        self._stop = None

    def _start(self):
        q = queue.Queue(self.capacity)
        stop = threading.Event()
        done = []

        def work(files):
            try:
                for f in files:
                    r = _RecordIOReader(f)
                    while not stop.is_set():
                        try:
                            q.put(r.next())
                        except EOFException:
                            break
            except Exception as e:
                q.put(e)
            finally:
                done.append(1)
                if len(done) == self.thread_num:
                    q.put(EOFException("open_files"))

        self._q, self._stop = q, stop
        self._threads = []
        for i in range(self.thread_num):
            t = threading.Thread(
                target=work, args=(self.filenames[i::self.thread_num],),
                daemon=True)
            t.start()
            self._threads.append(t)

    def next(self):
        if self._threads is None:
            self._start()
        item = self._q.get()
        if isinstance(item, Exception):
            # wind the POOL down before dropping it: surviving workers
            # are blocked putting into this bounded queue and would
            # leak (threads + open scanners) if just abandoned
            self._shutdown()
            raise item
        return item

    def _shutdown(self):
        threads, q, stop = self._threads, self._q, self._stop
        self._threads = None
        if threads:
            stop.set()
            while any(t.is_alive() for t in threads):
                try:
                    q.get_nowait()
                except queue.Empty:
                    pass
                for t in threads:
                    t.join(timeout=0.02)

    def reset(self):
        self._shutdown()


class _RandomDataReader(_ReaderBase):
    """Uniform random sample generator (reference
    create_random_data_generator_op) — a dummy reader to drive a
    network without any file."""

    def __init__(self, low, high, shapes, seed=0):
        # shapes are concrete per-sample dims (the layer strips the
        # batch dim before flattening into attrs)
        self.low, self.high = float(low), float(high)
        self.shapes = [tuple(int(x) for x in s) for s in shapes]
        self.seed = seed
        self.rng = np.random.RandomState(seed)

    def next(self):
        return tuple(
            self.rng.uniform(self.low, self.high, s).astype(np.float32)
            for s in self.shapes)

    def reset(self):
        self.rng = np.random.RandomState(self.seed)


@_host("open_files")
def _open_files(executor, op, scope, feed, env=None):
    files = list(op.attr("filenames") or [])
    threads = int(op.attr("thread_num") or 1)
    if threads > 1:
        # thread-pool scan (order nondeterministic across files);
        # pass_num epochs compose via the multi_pass decorator
        rd = _ParallelFilesReader(files, threads)
        if (op.attr("pass_num") or 1) > 1:
            rd = _MultiPassReader(rd, op.attr("pass_num"))
    else:
        rd = _MultiFileReader(files, pass_num=op.attr("pass_num") or 1)
    _set_state(scope, op.output("Out")[0], rd)


@_host("create_random_data_generator")
def _create_random(executor, op, scope, feed, env=None):
    # shapes travel flattened (attrs hold flat lists only):
    # shape_concat=[3,224,224,1], ranks=[3,1] -> [(3,224,224), (1,)]
    concat = list(op.attr("shape_concat") or [])
    shapes, i = [], 0
    for r in (op.attr("ranks") or []):
        shapes.append(tuple(concat[i:i + r]))
        i += r
    _set_state(scope, op.output("Out")[0],
               _RandomDataReader(op.attr("low"), op.attr("high"), shapes))


@_host("create_custom_reader")
def _create_custom(executor, op, scope, feed, env=None):
    out = op.output("Out")[0]
    if scope.has_var(out) and isinstance(scope.find_var(out),
                                         _CustomReader):
        return  # main-block op: idempotent across steps
    parent = _get_state(scope, op.input("UnderlyingReader")[0])
    block_id = op.attr("sub_block")
    if hasattr(block_id, "idx"):
        block_id = block_id.idx
    _set_state(scope, out, _CustomReader(
        parent, executor._current_program, block_id,
        op.attr("source_var_names") or [],
        op.attr("sink_var_names") or [], executor.place, scope))


@_host("create_multi_pass_reader")
def _create_multi_pass(executor, op, scope, feed, env=None):
    parent = _get_state(scope, op.input("UnderlyingReader")[0])
    _set_state(scope, op.output("Out")[0],
               _MultiPassReader(parent, op.attr("pass_num") or 1))


@_host("create_threaded_reader")
def _create_threaded(executor, op, scope, feed, env=None):
    parent = _get_state(scope, op.input("UnderlyingReader")[0])
    _set_state(scope, op.output("Out")[0],
               _ThreadedReader(parent, op.attr("capacity") or 16))


@_host("create_shuffle_reader")
def _create_shuffle(executor, op, scope, feed, env=None):
    parent = _get_state(scope, op.input("UnderlyingReader")[0])
    _set_state(scope, op.output("Out")[0],
               _ShuffleReader(parent, op.attr("buffer_size")))


@_host("create_batch_reader")
def _create_batch(executor, op, scope, feed, env=None):
    parent = _get_state(scope, op.input("UnderlyingReader")[0])
    _set_state(scope, op.output("Out")[0],
               _BatchReader(parent, op.attr("batch_size"),
                            drop_last=bool(op.attr("drop_last")
                                           if op.attr("drop_last")
                                           is not None else True)))


@_host("create_double_buffer_reader")
def _create_double_buffer(executor, op, scope, feed, env=None):
    parent = _get_state(scope, op.input("UnderlyingReader")[0])
    _set_state(scope, op.output("Out")[0],
               _DoubleBufferReader(parent, capacity=2,
                                   place=executor.place))


@_host("read")
def _read(executor, op, scope, feed, env=None):
    state = _get_state(scope, op.input("Reader")[0])
    batch = state.next()  # EOFException propagates to the caller
    outs = op.output("Out")
    if len(batch) != len(outs):
        raise ValueError(
            "reader yields %d slots but read op has %d outputs"
            % (len(batch), len(outs)))
    for name, val in zip(outs, batch):
        if env is not None:
            env[name] = val
        # data vars go in the scope so the compiled core block (which
        # runs after this prelude host op) picks them up as inputs;
        # they are tagged as LOCAL-row data — on a multi-host mesh a
        # reader batch is this process's shard, not a replicated global
        # value (executor_impl._put local_rows semantics)
        (scope.find_scope_of(name) or scope).set(name, val)
        if not hasattr(scope, "_reader_batch_vars"):
            scope._reader_batch_vars = set()
        scope._reader_batch_vars.add(name)
