"""Build, load and launch the hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on
first use by ``nvcc`` into its own shared library under ``_build/``
(listed in ``.gitignore``), keyed by a hash of the source, the shared
headers and the flags, then loaded with ``ctypes``.  No PyTorch headers are included, so
a build takes seconds, not minutes.  ``build_all`` starts one ``nvcc``
per source, all at once, and waits for them together.

Wrappers pass device pointers and ``torch.cuda.current_stream()`` as
``c_void_p``; every C entry returns ``cudaGetLastError()`` after its
launch, and ``check`` raises on a non-zero code.
"""
from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time

__all__ = ["SOURCES", "build_all", "load", "function", "check",
           "nvcc_path", "route", "require", "ptr", "stream", "count",
           "recording", "COUNT_LOCK"]

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
SOURCES = ("flash_fwd", "flash_bwd", "flash_chunk", "paged_attention",
           "matmul_int8", "matmul_fused", "conv_fused", "fused_ce")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_LOCK = threading.Lock()
_LIBS = {}
_FUNCS = {}
# guards every wrapper's ``launches``: the serving tenants launch and
# replay from their own threads
COUNT_LOCK = threading.Lock()
_RECORDING = threading.local()


def nvcc_path():
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and os.path.exists(os.path.join(root, "bin", "nvcc")):
            return os.path.join(root, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA kernels "
                       "of paddle_tpu_torch are built from source at "
                       "first use")


def _lib_path(name):
    """The library's path, keyed by its source, the shared headers
    (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha1()
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for src in [name + ".cu"] + headers:
        with open(os.path.join(CSRC, src), "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, "%s-%s.so" % (name, h.hexdigest()[:12]))


def _ptxas_summary(log):
    """{kernel symbol: 'registers, shared memory; stack and spills'}
    from the -Xptxas=-v log."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            out[cur] = []
        elif cur and ("registers" in line or "spill" in line):
            out[cur].append(line.split(":", 1)[-1].strip())
    return {k: "; ".join(v) for k, v in out.items()}


def build_all(names=SOURCES):
    """Compile every source in ``names`` that has no up-to-date library,
    one ``nvcc`` each, all started together.  Returns
    ``{name: {"seconds": s, "cached": bool, "ptxas": {...}}}``."""
    with _LOCK:
        os.makedirs(BUILD_DIR, exist_ok=True)
        nvcc = None
        procs, report = {}, {}
        t0 = time.perf_counter()
        for name in names:
            path = _lib_path(name)
            if os.path.exists(path):
                report[name] = {"seconds": 0.0, "cached": True,
                                "ptxas": {}}
                continue
            nvcc = nvcc or nvcc_path()
            tmp = "%s.%d.tmp" % (path, os.getpid())
            cmd = [nvcc, *NVCC_FLAGS, "-o", tmp,
                   os.path.join(CSRC, name + ".cu")]
            procs[name] = (subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True), tmp, path)
        failed = []
        for name, (proc, tmp, path) in procs.items():
            log, _ = proc.communicate()
            secs = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append("%s (rc %d):\n%s" % (name, proc.returncode,
                                                   log[-4000:]))
                continue
            os.replace(tmp, path)
            report[name] = {"seconds": round(secs, 3), "cached": False,
                            "ptxas": _ptxas_summary(log)}
        if failed:
            raise RuntimeError("nvcc failed for " + "\n".join(failed))
        return report


def load(name):
    """The ctypes library of ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    path = _lib_path(name)
    if not os.path.exists(path):
        build_all([name])
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            lib = ctypes.CDLL(path)
            _LIBS[name] = lib
    return lib


def function(name, symbol, argtypes):
    """C entry ``symbol`` of ``csrc/<name>.cu`` with its argument types
    set (returns int), loaded once."""
    key = (name, symbol)
    fn = _FUNCS.get(key)
    if fn is None:
        fn = getattr(load(name), symbol)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
        _FUNCS[key] = fn
    return fn


def check(rc, what):
    """Raise when a C entry reported a CUDA error for its launch."""
    if rc != 0:
        raise RuntimeError("%s: CUDA kernel launch failed (cudaError %d)"
                           % (what, rc))


# -- wrapper helpers ------------------------------------------------------

def route(*tensors):
    """'cpu' or 'cuda' for tensors that all lie on one device."""
    dev = tensors[0].device
    for t in tensors[1:]:
        if t.device != dev:
            raise ValueError("tensors on different devices: %s vs %s"
                             % (dev, t.device))
    if dev.type not in ("cpu", "cuda"):
        raise ValueError("unsupported device %s" % dev)
    return dev.type


def require(cond, msg):
    if not cond:
        raise ValueError(msg)


def ptr(t):
    return ctypes.c_void_p(t.data_ptr())


def stream():
    """PyTorch's current CUDA stream, for the kernel launch."""
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)


def count(fn):
    """One launch by wrapper ``fn``: add it to ``fn.launches`` and, while
    this thread captures a CUDA graph (``recording``), to the capture's
    own counts."""
    with COUNT_LOCK:
        fn.launches += 1
    rec = getattr(_RECORDING, "counts", None)
    if rec is not None:
        rec[fn] = rec.get(fn, 0) + 1


@contextlib.contextmanager
def recording():
    """Yield {wrapper: launches} counting the launches this thread makes
    inside the block, whatever other threads launch meanwhile."""
    prev = getattr(_RECORDING, "counts", None)
    _RECORDING.counts = {}
    try:
        yield _RECORDING.counts
    finally:
        _RECORDING.counts = prev
