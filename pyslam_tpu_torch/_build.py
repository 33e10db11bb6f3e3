"""Build and load the hand-written CUDA kernels of ``csrc/``.

Each ``.cu`` source is compiled at first use with its own ``nvcc`` process,
all started together, and the objects are linked into one shared library
with a plain C interface (no PyTorch headers, so the build takes seconds).
The library is cached under ``pyslam_tpu_torch/_build/`` by a hash of the
sources and the compiler commands, and loaded with ``ctypes``.  Nothing here
runs at import time: the first CUDA call of a kernel wrapper triggers the
build.  What ``ptxas`` reports for each kernel (registers, shared memory,
spills) is kept in ``ptxas_log``.

A failed build raises; there is no fallback to the plain versions.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading

_PKG_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC_DIR = os.path.join(_PKG_DIR, "csrc")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
COMPILE_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-c")
LINK_FLAGS = (*ARCH, "-shared")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C entry points and their argument types (pointers and the stream as void*)
_ENTRY_POINTS = {
    "pyslam_fast_nms_pyramid": [_P, _P, _P, _P, _I, _I, _F, _I, _P],
    "pyslam_fast_nms_per_level": [_P, _P, _I, _I, _I, _F, _I, _P],
}

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build
ptxas_log: str = ""                  # ptxas -v report of this process's build


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None:
        cand = "/usr/local/cuda/bin/nvcc"
        if os.path.exists(cand):
            path = cand
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _sources() -> list[str]:
    srcs = sorted(glob.glob(os.path.join(_SRC_DIR, "*.cu")))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {_SRC_DIR}")
    return srcs


def library_path() -> str:
    """Path of the shared library for the current sources (built or not)."""
    h = hashlib.sha256(" ".join(COMPILE_FLAGS + LINK_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpyslam_kernels_{h.hexdigest()[:16]}.so")


def _run(cmd: list[str]) -> subprocess.CompletedProcess:
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            "nvcc failed (exit %d):\n%s\n%s" % (res.returncode, " ".join(cmd), res.stderr))
    return res


def build() -> str:
    """Compile the sources unless the cached library matches them."""
    global build_seconds, ptxas_log
    import time

    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    srcs = _sources()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(s)}.{tag}.o") for s in srcs]
    t0 = time.perf_counter()
    procs = [subprocess.Popen([_nvcc(), *COMPILE_FLAGS, "-o", o, s], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for s, o in zip(srcs, objs)]
    logs, failed = [], []
    for s, p in zip(srcs, procs):
        _, err = p.communicate()
        logs.append(f"== {os.path.basename(s)}\n{err}")
        if p.returncode != 0:
            failed.append(f"{s} (exit {p.returncode}):\n{err}")
    try:
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
        tmp = f"{out}.{tag}"
        _run([_nvcc(), *LINK_FLAGS, "-o", tmp, *objs])
        os.replace(tmp, out)
    finally:
        for o in objs:
            if os.path.exists(o):
                os.remove(o)
    build_seconds = time.perf_counter() - t0
    ptxas_log = "\n".join(logs)
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, argtypes in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
