"""RecordIO: chunked record container (writer + fault-tolerant scanner).

The port's copy of ``paddle_tpu/recordio`` (the port imports nothing of
that package), on the same on-disk format, so a file written by either
package (and either codec) is read by both.  The hot path is the C++
codec (``recordio.cc``, the reference's source unchanged), built with
``g++`` at first use into ``paddle_tpu_torch/kernels/_build/`` (listed
in ``.gitignore``; never beside the source), keyed by a hash of the
source and the flags, and loaded over ctypes; a pure-Python codec of the
SAME format is the fallback and the cross-check.  ``native_available()``
says whether the C++ codec built and loaded (then a ``Writer`` or
``Scanner`` runs it unless ``use_native=False``), ``native_error()`` why
not.

Format (little-endian; see recordio.cc's header comment):
  chunk  := magic:u32 compressor:u32 num_records:u32
            uncompressed_len:u32 stored_len:u32 crc32:u32 payload
  payload (zlib per chunk by default) := { len:u32 bytes } * num_records
Corrupt or truncated chunks are skipped on read (the reference's
fault-tolerant scanner behavior, recordio/README.md).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import struct
import subprocess
import threading
import zlib

__all__ = ["Writer", "Scanner", "write_records", "read_records",
           "native_available", "native_error", "library_path"]

MAGIC = 0x54505231
NO_COMPRESS = 0
ZLIB = 2

_HEADER = struct.Struct("<6I")

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "recordio.cc")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "kernels", "_build")
_GXX_FLAGS = ("-O2", "-shared", "-fPIC")

_lock = threading.Lock()
_lib = None
_lib_tried = False
_error = None


def library_path():
    """Where the C++ codec is built: ``kernels/_build/``, keyed by a hash
    of the source and the flags."""
    h = hashlib.sha1()
    with open(_SRC, "rb") as f:
        h.update(f.read())
    h.update(" ".join(_GXX_FLAGS).encode())
    return os.path.join(_BUILD_DIR, "librecordio-%s.so" % h.hexdigest()[:12])


def _load_native():
    """Build (once) and load the C++ codec; None if there is no
    toolchain (``native_error()`` says why)."""
    global _lib, _lib_tried, _error
    with _lock:
        if _lib_tried:
            return _lib
        _lib_tried = True
        so = library_path()
        try:
            if not os.path.exists(so):
                os.makedirs(_BUILD_DIR, exist_ok=True)
                tmp = "%s.%d.tmp" % (so, os.getpid())
                subprocess.run(["g++", *_GXX_FLAGS, "-o", tmp, _SRC, "-lz"],
                               check=True, capture_output=True)
                os.replace(tmp, so)
            lib = ctypes.CDLL(so)
            lib.rio_writer_open.restype = ctypes.c_void_p
            lib.rio_writer_open.argtypes = [ctypes.c_char_p,
                                            ctypes.c_uint32,
                                            ctypes.c_uint32]
            lib.rio_write.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                      ctypes.c_uint32]
            lib.rio_writer_close.argtypes = [ctypes.c_void_p]
            lib.rio_scanner_open.restype = ctypes.c_void_p
            lib.rio_scanner_open.argtypes = [ctypes.c_char_p]
            lib.rio_next.restype = ctypes.c_int64
            lib.rio_next.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_char_p)]
            lib.rio_scanner_close.argtypes = [ctypes.c_void_p]
            _lib = lib
        except (OSError, subprocess.CalledProcessError) as e:
            detail = getattr(e, "stderr", b"") or b""
            _error = "%s: %s %s" % (type(e).__name__, e,
                                    detail.decode(errors="replace")[-500:])
            _lib = None
        return _lib


def native_available():
    return _load_native() is not None


def native_error():
    """Why the C++ codec did not build or load (None when it did)."""
    _load_native()
    return _error


class Writer:
    """Append records to a recordio file; chunks flush every
    ``max_chunk_records`` records (or ~1MB) and on close."""

    def __init__(self, path, compressor=ZLIB, max_chunk_records=1000,
                 use_native=True):
        self._native = _load_native() if use_native else None
        self._path = path
        self._compressor = compressor
        self._max = max_chunk_records
        if self._native is not None:
            self._h = self._native.rio_writer_open(
                os.fsencode(path), compressor, max_chunk_records)
            if not self._h:
                raise IOError("cannot open %s for writing" % path)
        else:
            self._f = open(path, "wb")
            self._buf = []
            self._buf_bytes = 0

    def write(self, record):
        if not isinstance(record, (bytes, bytearray)):
            raise TypeError("record must be bytes, got %s" % type(record))
        if self._native is not None:
            self._native.rio_write(self._h, bytes(record), len(record))
            return
        self._buf.append(bytes(record))
        self._buf_bytes += len(record) + 4
        if len(self._buf) >= self._max or self._buf_bytes >= (1 << 20):
            self._flush()

    def _flush(self):
        if not self._buf:
            return
        raw = b"".join(struct.pack("<I", len(r)) + r for r in self._buf)
        stored = zlib.compress(raw) if self._compressor == ZLIB else raw
        crc = zlib.crc32(stored) & 0xFFFFFFFF
        self._f.write(_HEADER.pack(MAGIC, self._compressor, len(self._buf),
                                   len(raw), len(stored), crc))
        self._f.write(stored)
        self._buf = []
        self._buf_bytes = 0

    def close(self):
        if self._native is not None:
            if self._h:
                self._native.rio_writer_close(self._h)
                self._h = None
        else:
            self._flush()
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class Scanner:
    """Iterate records; corrupt/truncated chunks are skipped."""

    def __init__(self, path, use_native=True):
        self._native = _load_native() if use_native else None
        if self._native is not None:
            self._h = self._native.rio_scanner_open(os.fsencode(path))
            if not self._h:
                raise IOError("cannot open %s" % path)
        else:
            self._f = open(path, "rb")

    def __iter__(self):
        if self._native is not None:
            out = ctypes.c_char_p()
            while True:
                n = self._native.rio_next(self._h, ctypes.byref(out))
                if n < 0:
                    return
                yield ctypes.string_at(out, n)
        else:
            while True:
                head = self._f.read(_HEADER.size)
                if len(head) < _HEADER.size:
                    return
                magic, comp, nrec, raw_len, stored_len, crc = \
                    _HEADER.unpack(head)
                if magic != MAGIC:
                    return  # out of sync: stop
                stored = self._f.read(stored_len)
                if len(stored) < stored_len:
                    return  # truncated tail
                if (zlib.crc32(stored) & 0xFFFFFFFF) != crc:
                    continue  # corrupt chunk: skip
                raw = zlib.decompress(stored) if comp == ZLIB else stored
                pos = 0
                for _ in range(nrec):
                    if pos + 4 > len(raw):
                        break
                    (ln,) = struct.unpack_from("<I", raw, pos)
                    pos += 4
                    yield raw[pos:pos + ln]
                    pos += ln

    def close(self):
        if self._native is not None:
            if self._h:
                self._native.rio_scanner_close(self._h)
                self._h = None
        else:
            self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def write_records(path, records, **kwargs):
    with Writer(path, **kwargs) as w:
        for r in records:
            w.write(r)


def read_records(path, **kwargs):
    with Scanner(path, **kwargs) as s:
        for r in s:
            yield r
