"""Data-input layers (counterpart of paddle_tpu/fluid/layers/io.py).

Parity: reference python/paddle/fluid/layers/io.py (`data` plus the
reader-op chain: open_recordio_file -> shuffle -> batch ->
double_buffer -> read_file, over operators/reader/*).

Readers are program state: the create ops run in the STARTUP program
and leave a host-side reader chain in the scope (ops/reader_ops.py);
the `read` op is a prelude host op of the main block that pops one
batch into the data vars each executor.run (double_buffer's batch
already on the executor's device).  End of data raises
fluid.core.EOFException — catch it and call reader.reset().  Programs
built here serialize to the JAX package's bytes.
"""
from __future__ import annotations

from ..framework import (Variable, default_main_program,
                         default_startup_program)
from ..layer_helper import LayerHelper
from .. import unique_name
from paddle_tpu_torch.core.types import VarKind

__all__ = ["data", "open_recordio_file", "open_files",
           "random_data_generator", "shuffle", "batch", "double_buffer",
           "multi_pass", "threaded", "Preprocessor", "read_file"]


def data(name, shape, append_batch_size=True, dtype="float32", lod_level=0,
         type=None, stop_gradient=True):
    helper = LayerHelper("data", name=name)
    shape = list(shape)
    if append_batch_size:
        # a ragged (LoD) feed would be padded [N, T, ...]: a time dim is
        # inserted after batch, as in the JAX package
        shape = [-1] * (1 + (1 if lod_level > 0 else 0)) + shape
    return helper.create_global_variable(
        name=name, shape=shape, dtype=dtype, lod_level=lod_level,
        stop_gradient=stop_gradient)


class _ReaderVariable(Variable):
    """A reader handle: a Variable plus shape/dtype metadata for
    read_file and a reset() that rewinds the scope-resident chain."""

    def reset(self, scope=None):
        """Rewind the chain.  ``scope``: the scope the executor actually
        ran with — callers using ``exe.run(..., scope=s)`` without a
        scope_guard must pass it, or the chain in the guard-stack top
        would be (wrongly) the one rewound."""
        if scope is None:
            from ..executor import _scope_stack
            scope = _scope_stack[-1]
        try:
            state = scope.find_var(self.name)
        except KeyError:
            raise RuntimeError(
                "reader %r is not initialized in the given scope (run "
                "the startup program first)" % self.name)
        state.reset()


def _reader_var(block, name, shapes, dtypes, lod_levels):
    var = _ReaderVariable(block, name=name, shape=[0], dtype="float32",
                          persistable=True, kind=VarKind.READER)
    block.vars[name] = var
    var._reader_shapes = [list(s) for s in shapes]
    var._reader_dtypes = list(dtypes)
    var._reader_lod_levels = list(lod_levels)
    return var


def _create_reader(op_type, attrs, shapes, dtypes, lod_levels):
    """Shared creator wiring: declare the reader var in the STARTUP
    program (where the create op runs and leaves the scope state) and
    mirror it in the main program for read_file/decorators."""
    startup = default_startup_program()
    main = default_main_program()
    name = unique_name.generate(op_type)
    _reader_var(startup.global_block(), name, shapes, dtypes, lod_levels)
    startup.global_block().append_op(
        type=op_type, inputs={}, outputs={"Out": [name]}, attrs=attrs,
        infer_shape=False)
    return _reader_var(main.global_block(), name, shapes, dtypes,
                       lod_levels)


def open_recordio_file(filename, shapes, lod_levels, dtypes,
                       pass_num=1, for_parallel=False):
    """Reader over a recordio file written by
    fluid.recordio_writer.convert_reader_to_recordio_file (reference
    io.py open_recordio_file / create_recordio_file_reader op).
    ``shapes`` include the batch dim as -1."""
    return _create_reader(
        "create_recordio_file_reader",
        {"filename": filename, "pass_num": int(pass_num)},
        shapes, dtypes, lod_levels)


def open_files(filenames, shapes, lod_levels, dtypes, thread_num=1,
               buffer_size=None, pass_num=1, for_parallel=False):
    """Reader over a LIST of recordio files (reference io.py open_files
    / open_files_op).  thread_num > 1 scans files with a worker pool
    into a bounded queue (sample order across files nondeterministic,
    like the reference's multi_file_reader); thread_num == 1 streams
    them concatenated in order."""
    return _create_reader(
        "open_files",
        {"filenames": list(filenames), "pass_num": int(pass_num),
         "thread_num": int(thread_num)},
        shapes, dtypes, lod_levels)


def random_data_generator(low, high, shapes, lod_levels,
                          for_parallel=False):
    """Uniform-random dummy reader (reference io.py
    random_data_generator) — drive a net without any file; all slots
    are float32.  The LEADING batch (-1) dim is stripped: the
    generator yields per-sample arrays and the batch decorator stacks
    them; interior dims must be concrete (random data has no ragged
    axis)."""
    dtypes = ["float32"] * len(shapes)
    shape_concat, ranks = [], []
    for s in shapes:
        dims = [int(x) for x in s]
        if dims and dims[0] == -1:
            dims = dims[1:]
        if any(d <= 0 for d in dims):
            raise ValueError(
                "random_data_generator shapes must be concrete after "
                "the leading batch dim, got %r" % (list(s),))
        shape_concat.extend(dims)
        ranks.append(len(dims))
    return _create_reader(
        "create_random_data_generator",
        {"low": float(low), "high": float(high),
         "shape_concat": shape_concat, "ranks": ranks},
        shapes, dtypes, lod_levels)


def _decorate(op_type, reader, attrs):
    startup = default_startup_program()
    main = default_main_program()
    name = unique_name.generate(op_type)
    _reader_var(startup.global_block(), name, reader._reader_shapes,
                reader._reader_dtypes, reader._reader_lod_levels)
    startup.global_block().append_op(
        type=op_type,
        inputs={"UnderlyingReader": [reader.name]},
        outputs={"Out": [name]}, attrs=attrs, infer_shape=False)
    return _reader_var(main.global_block(), name, reader._reader_shapes,
                       reader._reader_dtypes, reader._reader_lod_levels)


def shuffle(reader, buffer_size):
    """Shuffling decorator (reference create_shuffle_reader op)."""
    return _decorate("create_shuffle_reader", reader,
                     {"buffer_size": int(buffer_size)})


def batch(reader, batch_size, drop_last=True):
    """Sample->minibatch decorator (reference create_batch_reader op).
    drop_last=True diverges from the reference default deliberately, as
    the JAX package's does: a ragged tail batch would change the step's
    shape every epoch; pass False to emit it anyway (reference
    BatchReader::ReadNext)."""
    return _decorate("create_batch_reader", reader,
                     {"batch_size": int(batch_size),
                      "drop_last": bool(drop_last)})


def multi_pass(reader, pass_num):
    """Replay the chain ``pass_num`` epochs before EOF (reference
    io.py multi_pass / create_multi_pass_reader_op)."""
    return _decorate("create_multi_pass_reader", reader,
                     {"pass_num": int(pass_num)})


def threaded(reader, capacity=16):
    """Thread-safe prefetching front (reference
    create_threaded_reader_op): a worker drains the chain into a
    bounded queue so concurrent consumers can pop safely."""
    return _decorate("create_threaded_reader", reader,
                     {"capacity": int(capacity)})


def double_buffer(reader, place=None, name=None):
    """Device-staging prefetch decorator (reference
    create_double_buffer_reader op)."""
    return _decorate("create_double_buffer_reader", reader, {})


def read_file(reader):
    """Pop one batch into fresh data vars (reference read_op).  Raises
    fluid.core.EOFException when the chain is drained."""
    helper = LayerHelper("read_file")
    main = default_main_program()
    outs = []
    for shape, dtype, lod in zip(reader._reader_shapes,
                                 reader._reader_dtypes,
                                 reader._reader_lod_levels):
        var = main.current_block().create_var(
            name=unique_name.generate("read_file"), shape=list(shape),
            dtype=dtype, lod_level=lod)
        outs.append(var)
    helper.append_op(type="read", inputs={"Reader": [reader.name]},
                     outputs={"Out": [v.name for v in outs]},
                     infer_shape=False)
    if len(outs) == 1:
        return outs[0]
    return outs


class Preprocessor:
    """Per-batch preprocessing sub-block over a decorated reader
    (reference layers/io.py Preprocessor:587 + create_custom_reader_op):

        p = Preprocessor(reader)
        with p.block():
            img, lbl = p.inputs()
            p.outputs(some_layers(img), lbl)
        reader = p()
    """

    def __init__(self, reader, name=None):
        self.underlying = reader
        self.main_prog = default_main_program()
        self.sub_block = None
        self.source_var_names = None
        self.sink_var_names = None
        self._sink_shapes = None
        self._in_block = False

    def block(self):
        import contextlib

        @contextlib.contextmanager
        def guard():
            self._in_block = True
            self.sub_block = self.main_prog.create_block()
            try:
                yield
            finally:
                # rollback even when the body raises: leaving the
                # program pointed at the orphaned sub-block would eat
                # every op built afterwards
                self.main_prog.rollback()
                self._in_block = False
            if not (self.sub_block is not None and self.source_var_names
                    and self.sink_var_names):
                raise RuntimeError(
                    "incomplete Preprocessor: call inputs() and "
                    "outputs() inside the block")

        return guard()

    def inputs(self):
        if not self._in_block:
            raise RuntimeError("Preprocessor.inputs() belongs inside "
                               "the block()")
        blk = self.main_prog.current_block()
        self.source_var_names = []
        vars_ = []
        for shape, dtype in zip(self.underlying._reader_shapes,
                                self.underlying._reader_dtypes):
            name = unique_name.generate("preprocessor_source")
            self.source_var_names.append(name)
            vars_.append(blk.create_var(name=name, shape=shape,
                                        dtype=dtype))
        return vars_

    def outputs(self, *outs):
        if not self._in_block:
            raise RuntimeError("Preprocessor.outputs() belongs inside "
                               "the block()")
        self.sink_var_names = [v.name for v in outs]
        self._sink_shapes = [list(getattr(v, "shape", [0]) or [0])
                             for v in outs]
        self._sink_dtypes = [str(getattr(v, "dtype", "float32"))
                             for v in outs]

    def __call__(self):
        name = unique_name.generate("create_custom_reader")
        main = self.main_prog
        out = _reader_var(main.current_block(), name,
                          self._sink_shapes, self._sink_dtypes,
                          [0] * len(self._sink_shapes))
        main.current_block().append_op(
            type="create_custom_reader",
            inputs={"UnderlyingReader": [self.underlying.name]},
            outputs={"Out": [name]},
            attrs={"sub_block": self.sub_block.idx,
                   "source_var_names": list(self.source_var_names),
                   "sink_var_names": list(self.sink_var_names)},
            infer_shape=False)
        return out
