"""Dataset plumbing (parity: python/paddle/dataset/common.py — DATA_HOME,
download-with-md5 cache, cluster file splitting).

The port's own copy of ``paddle_tpu/dataset/common.py`` (the port
imports nothing of that package).  ``download`` never fetches: it
resolves a file already cached under DATA_HOME and otherwise raises
FileNotFoundError, and each dataset module falls back to a
DETERMINISTIC synthetic generator with the real shapes/dtypes (clearly
flagged via ``is_synthetic``), keeping pipelines and tests runnable
offline.  Drop the real files into DATA_HOME to use them.  Unlike the
reference's, a lookup creates no directory.
"""
from __future__ import annotations

import hashlib
import os

__all__ = ["DATA_HOME", "download", "md5file", "split", "cluster_files_reader"]

DATA_HOME = os.path.expanduser(
    os.environ.get("PADDLE_TPU_DATA_HOME", "~/.cache/paddle_tpu/dataset"))


def md5file(fname):
    h = hashlib.md5()
    with open(fname, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def download(url, module_name, md5sum=None):
    """Return the cached path for ``url`` (reference common.py:56).
    Never fetches: raises FileNotFoundError when the file is not already
    cached (callers catch it and synthesize)."""
    dirname = os.path.join(DATA_HOME, module_name)
    filename = os.path.join(dirname, url.split("/")[-1])
    if os.path.exists(filename):
        if md5sum and md5file(filename) != md5sum:
            raise IOError("md5 mismatch for cached %s" % filename)
        return filename
    raise FileNotFoundError(
        "%s is not cached under %s and nothing is downloaded; the "
        "dataset module will fall back to synthetic data" %
        (url, dirname))


def split(reader, line_count, suffix="%05d.pickle", dumper=None):
    """Split a reader's samples into pickled part-files of ``line_count``
    samples (reference common.py:118)."""
    import pickle

    dumper = dumper or pickle.dump
    lines = []
    idx = 0
    for sample in reader():
        lines.append(sample)
        if len(lines) >= line_count:
            with open(suffix % idx, "wb") as f:
                dumper(lines, f)
            lines = []
            idx += 1
    if lines:
        with open(suffix % idx, "wb") as f:
            dumper(lines, f)
        idx += 1
    return idx


def cluster_files_reader(files_pattern, trainer_count, trainer_id,
                         loader=None):
    """Reader over this trainer's shard of part-files (reference
    common.py:149): file i belongs to trainer ``i % trainer_count``."""
    import glob
    import pickle

    loader = loader or pickle.load

    def reader():
        flist = sorted(glob.glob(files_pattern))
        for i, fn in enumerate(flist):
            if i % trainer_count == trainer_id:
                with open(fn, "rb") as f:
                    for sample in loader(f):
                        yield sample

    return reader
