"""Crash-safe filesystem commits.

A copy of ``paddle_tpu/core/fsutil.py`` (the port imports nothing of
the JAX package).  One implementation of the write-tmp -> fsync ->
rename idiom for every durable writer (the checkpoint _SUCCESS marker
so far), so the subtle parts — fsync before rename, the
directory fsync that actually makes the rename survive power loss on
ext4/xfs, optional backup rotation — are fixed in exactly one place.
"""
from __future__ import annotations

import os

__all__ = ["atomic_write"]


def _fsync_dir(dirname):
    """Persist a rename: fsync the containing directory (best-effort —
    not every platform/filesystem allows opening a directory)."""
    try:
        fd = os.open(dirname or ".", os.O_RDONLY)
    except OSError:
        return
    try:
        os.fsync(fd)
    except OSError:
        pass
    finally:
        os.close(fd)


def atomic_write(path, data, backup_suffix=None):
    """Write ``data`` (str or bytes) to ``path`` atomically.

    tmp file -> flush + fsync -> (optionally rotate the existing file to
    ``path + backup_suffix``) -> rename -> fsync(dir).  A crash at any
    point leaves either the previous complete file (or its backup) or
    the new complete file — never a truncated one.
    """
    tmp = path + ".tmp"
    with open(tmp, "wb" if isinstance(data, bytes) else "w") as f:
        f.write(data)
        f.flush()
        os.fsync(f.fileno())
    if backup_suffix and os.path.exists(path):
        os.replace(path, path + backup_suffix)
    os.replace(tmp, path)
    _fsync_dir(os.path.dirname(path))
