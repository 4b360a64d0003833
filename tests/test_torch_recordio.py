"""The port's recordio container (``paddle_tpu_torch/recordio``: the C++
codec built with g++ into ``kernels/_build/``, and the Python codec)
against the JAX package's, on the CPU.

- A file written by any of the four codecs (reference native, reference
  Python, port native, port Python) reads back, record for record, in
  each of the four; the uncompressed form too.
- The packages write byte-identical files from the same records, with
  the same codec and with the other.
- A chunk with a bad CRC is skipped by both of the port's codecs.
- ``reader.creator.recordio`` and ``fluid.recordio_writer`` round-trip,
  and write the reference's bytes from the same samples.
"""
import os
import pickle
import struct
import zlib

import numpy as np
import pytest

import paddle_tpu.fluid as jfluid
import paddle_tpu_torch.fluid as tfluid
from paddle_tpu import recordio as jrio
from paddle_tpu_torch import recordio as trio
from paddle_tpu_torch import reader as treader

RECS = [b"a", b"", b"z" * 4096, bytes(range(256))] + \
    [bytes([i % 251]) * (i * 37 % 3000) for i in range(1500)]
CODECS = [("jax", True), ("jax", False), ("port", True), ("port", False)]
IDS = ["%s-%s" % (p, "native" if n else "python") for p, n in CODECS]


@pytest.fixture(scope="module", autouse=True)
def _native_built():
    # the driver's CPU has g++: both native codecs must build here
    assert jrio.native_available()
    assert trio.native_available(), trio.native_error()


def _mod(pkg):
    return jrio if pkg == "jax" else trio


@pytest.mark.parametrize("compressor", ["zlib", "none"])
@pytest.mark.parametrize("reader", CODECS, ids=IDS)
@pytest.mark.parametrize("writer", CODECS, ids=IDS)
def test_files_cross_between_packages_and_codecs(tmp_path, writer, reader,
                                                 compressor):
    comp = trio.ZLIB if compressor == "zlib" else trio.NO_COMPRESS
    p = str(tmp_path / "r.rio")
    _mod(writer[0]).write_records(p, RECS, use_native=writer[1],
                                  compressor=comp, max_chunk_records=100)
    assert list(_mod(reader[0]).read_records(p, use_native=reader[1])) \
        == RECS


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
def test_packages_write_identical_bytes(tmp_path, native):
    files = {}
    for pkg in ("jax", "port"):
        p = str(tmp_path / ("%s.rio" % pkg))
        _mod(pkg).write_records(p, RECS, use_native=native,
                                max_chunk_records=100)
        with open(p, "rb") as f:
            files[pkg] = f.read()
    assert files["port"] == files["jax"]
    # and the port's other codec writes the same bytes
    p = str(tmp_path / "other.rio")
    trio.write_records(p, RECS, use_native=not native, max_chunk_records=100)
    with open(p, "rb") as f:
        assert f.read() == files["jax"]


def test_which_codec_ran_is_visible(tmp_path):
    assert trio.native_available()
    assert trio.library_path().startswith(os.path.join(
        os.path.dirname(os.path.dirname(trio.__file__)), "kernels",
        "_build"))
    assert os.path.exists(trio.library_path())
    assert trio.native_error() is None


def test_corrupt_chunk_is_skipped(tmp_path):
    p = str(tmp_path / "c.rio")
    trio.write_records(p, RECS[:4], use_native=False)
    raw = struct.pack("<I", 2) + b"ok"
    stored = zlib.compress(raw)
    hdr = struct.Struct("<6I")
    with open(p, "ab") as f:
        f.write(hdr.pack(trio.MAGIC, trio.ZLIB, 1, len(raw),
                         len(stored), 0xBAD))   # wrong crc -> skipped
        f.write(stored)
        f.write(hdr.pack(trio.MAGIC, trio.ZLIB, 1, len(raw),
                         len(stored), zlib.crc32(stored)))
        f.write(stored)
        f.write(hdr.pack(trio.MAGIC, trio.ZLIB, 1, 99, 99, 0)[:10])  # torn
    for pkg, native in CODECS:
        assert list(_mod(pkg).read_records(p, use_native=native)) == \
            RECS[:4] + [b"ok"], (pkg, native)


def test_creator_recordio_round_trip(tmp_path):
    p = str(tmp_path / "n.rio")
    arrs = [np.arange(4, dtype=np.float32) * i for i in range(5)]
    trio.write_records(p, [a.tobytes() for a in arrs])
    got = list(treader.creator.recordio(
        p, deserializer=lambda b: np.frombuffer(b, np.float32))())
    assert len(got) == 5
    for g, a in zip(got, arrs):
        np.testing.assert_array_equal(g, a)
    # a comma-separated list reads both files, raw bytes by default
    assert list(treader.creator.recordio(p + "," + p)()) == \
        [a.tobytes() for a in arrs] * 2


def _samples():
    rng = np.random.RandomState(3)
    return [(rng.rand(6).astype(np.float32),
             np.asarray([i], np.int64)) for i in range(7)]


def test_recordio_writer_round_trip_and_bytes(tmp_path):
    data = _samples()
    out = {}
    for pkg, fluid in (("jax", jfluid), ("port", tfluid)):
        d = tmp_path / pkg
        d.mkdir()
        n = fluid.recordio_writer.convert_reader_to_recordio_file(
            str(d / "one.recordio"), lambda: iter(data))
        counts = fluid.recordio_writer.convert_reader_to_recordio_files(
            str(d / "part.recordio"), 3, lambda: iter(data))
        assert n == 7 and counts == [3, 3, 1]
        names = ["one.recordio"] + ["part-%05d.recordio" % i
                                    for i in range(3)]
        out[pkg] = [(d / name).read_bytes() for name in names]
    assert out["port"] == out["jax"]
    back = [pickle.loads(r) for r in
            treader.creator.recordio(str(tmp_path / "port" /
                                         "one.recordio"))()]
    for (gi, gl), (wi, wl) in zip(back, data):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    with tfluid.recordio_writer.create_recordio_writer(
            str(tmp_path / "w.recordio"), compressor=trio.NO_COMPRESS) as w:
        w.write(b"raw")
    assert list(trio.read_records(str(tmp_path / "w.recordio"))) == [b"raw"]
