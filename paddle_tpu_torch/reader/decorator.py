"""Reader decorators.

A copy of ``paddle_tpu/reader/decorator.py`` (the port imports nothing
of the JAX package).  Parity: reference python/paddle/reader/decorator.py:29-330 (map_readers,
shuffle, chain, compose, buffered, firstn, xmap_readers).  Fresh
implementations on queues/threads; same composition semantics.
"""
from __future__ import annotations

import itertools
import queue
import random
import threading

__all__ = ["map_readers", "shuffle", "chain", "compose", "buffered",
           "firstn", "xmap_readers", "cache", "ComposeNotAligned"]


def map_readers(func, *readers):
    """Zip several readers and map ``func`` over the sample tuples
    (reference decorator.py:29)."""

    def reader():
        rs = [r() for r in readers]
        for items in zip(*rs):
            yield func(*items)

    return reader


def shuffle(reader, buf_size):
    """Pool ``buf_size`` samples, yield them in random order
    (reference decorator.py:51)."""

    def shuffled():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                random.shuffle(buf)
                for b in buf:
                    yield b
                buf = []
        if buf:
            random.shuffle(buf)
            for b in buf:
                yield b

    return shuffled


def chain(*readers):
    """Concatenate readers back to back (reference decorator.py:86)."""

    def reader():
        return itertools.chain(*[r() for r in readers])

    return reader


class ComposeNotAligned(ValueError):
    pass


def compose(*readers, **kwargs):
    """Zip readers into flat tuples: (a, (b, c)) -> (a, b, c)
    (reference decorator.py:118).  check_alignment=True raises
    ComposeNotAligned when one reader is exhausted early."""
    check_alignment = kwargs.pop("check_alignment", True)
    if kwargs:
        raise TypeError("unexpected kwargs %r" % list(kwargs))

    def make_tuple(x):
        return x if isinstance(x, tuple) else (x,)

    def reader():
        rs = [r() for r in readers]
        if not check_alignment:
            for outputs in zip(*rs):
                yield sum((make_tuple(o) for o in outputs), ())
            return
        sentinel = object()
        for outputs in itertools.zip_longest(*rs, fillvalue=sentinel):
            if sentinel in outputs:
                raise ComposeNotAligned(
                    "outputs of readers are not aligned")
            yield sum((make_tuple(o) for o in outputs), ())

    return reader


def buffered(reader, size):
    """Background thread keeps up to ``size`` samples ready (reference
    decorator.py:165) — decouples producer and consumer speed."""

    end = object()

    def readers():
        q = queue.Queue(maxsize=size)

        def produce():
            try:
                for s in reader():
                    q.put(s)
            finally:
                q.put(end)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is end:
                return
            yield s

    return readers


def firstn(reader, n):
    """Limit to the first ``n`` samples (reference decorator.py:208)."""

    def firstn_reader():
        return itertools.islice(reader(), n)

    return firstn_reader


def cache(reader):
    """Materialize once, replay from memory on later epochs."""
    all_data = []
    filled = []

    def cached():
        if not filled:
            for s in reader():
                all_data.append(s)
                yield s
            filled.append(True)
        else:
            for s in all_data:
                yield s

    return cached


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Map ``mapper`` over samples with ``process_num`` worker threads
    (reference decorator.py:236).  order=True preserves input order."""

    end = object()

    def xreader():
        in_q = queue.Queue(buffer_size)
        out_q = queue.Queue(buffer_size)

        def feed():
            for i, s in enumerate(reader()):
                in_q.put((i, s))
            for _ in range(process_num):
                in_q.put(end)

        def work():
            while True:
                item = in_q.get()
                if item is end:
                    out_q.put(end)
                    return
                i, s = item
                out_q.put((i, mapper(s)))

        threading.Thread(target=feed, daemon=True).start()
        for _ in range(process_num):
            threading.Thread(target=work, daemon=True).start()

        finished = 0
        if not order:
            while finished < process_num:
                item = out_q.get()
                if item is end:
                    finished += 1
                    continue
                yield item[1]
            return
        pending = {}
        next_i = 0
        while finished < process_num or pending:
            if next_i in pending:
                yield pending.pop(next_i)
                next_i += 1
                continue
            if finished == process_num:
                # producers done and the next index never arrived
                break
            item = out_q.get()
            if item is end:
                finished += 1
                continue
            i, mapped = item
            pending[i] = mapped

    return xreader


class PipeReader:
    """Stream records from a shell command's stdout (reference
    reader/decorator.py:337 — the HDFS/S3/curl ingestion path).  Plain
    or gzip streams; ``get_line`` yields decoded lines."""

    def __init__(self, command, bufsize=8192, file_type="plain"):
        import subprocess
        import zlib

        if not isinstance(command, str):
            raise TypeError("command must be a string")
        if file_type not in ("plain", "gzip"):
            raise TypeError("file_type %s is not allowed" % file_type)
        if file_type == "gzip":
            self.dec = zlib.decompressobj(32 + zlib.MAX_WBITS)
        self.file_type = file_type
        self.bufsize = bufsize
        self.process = subprocess.Popen(
            command.split(" "), bufsize=bufsize, stdout=subprocess.PIPE)

    def get_line(self, cut_lines=True, line_break="\n"):
        import codecs

        # incremental decode: a multi-byte utf-8 char may straddle a
        # read-chunk boundary (the reference decodes per chunk and
        # crashes on that)
        decoder = codecs.getincrementaldecoder("utf-8")()
        remained = ""
        while True:
            buff = self.process.stdout.read(self.bufsize)
            if not buff:
                tail = b""
                if self.file_type == "gzip":
                    # drain the decompressor: bytes still buffered in
                    # zlib (or a trailing partial member) would be
                    # silently dropped otherwise
                    tail = self.dec.flush()
                decomp_buff = decoder.decode(tail, final=True)
            elif self.file_type == "gzip":
                decomp_buff = decoder.decode(self.dec.decompress(buff))
            else:
                decomp_buff = decoder.decode(buff)
            if decomp_buff:
                if not cut_lines:
                    yield decomp_buff
                else:
                    lines = (remained + decomp_buff).split(line_break)
                    remained = lines.pop(-1)
                    for line in lines:
                        yield line
            if not buff:
                break
        if remained:
            yield remained
        # reap the child and surface failures: a dead `hadoop fs -cat`
        # must not masquerade as an empty dataset
        rc = self.process.wait()
        if rc != 0:
            raise RuntimeError(
                "PipeReader command exited with status %d" % rc)
