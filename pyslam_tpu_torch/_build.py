"""Build and load the hand-written CUDA kernels of ``csrc/``.

The ``.cu`` sources are compiled at first use with ``nvcc`` into one shared
library with a plain C interface (no PyTorch headers, so the build takes
seconds), cached under ``pyslam_tpu_torch/_build/`` by a hash of the sources
and the compiler command, and loaded with ``ctypes``.  Nothing here runs at
import time: the first CUDA call of a kernel wrapper triggers the build.

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
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # wall time of this process's build


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
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in _sources():
        with open(src, "rb") as f:
            h.update(os.path.basename(src).encode())
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libpyslam_kernels_{h.hexdigest()[:16]}.so")


def build() -> str:
    """Compile the sources unless the cached library matches them."""
    global build_seconds
    import time

    out = library_path()
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(
            "nvcc failed (exit %d):\n%s\n%s" % (res.returncode, " ".join(cmd),
                                                 res.stderr))
    os.replace(tmp, out)
    build_seconds = time.perf_counter() - t0
    return out


def load() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            fn = lib.pyslam_fast_nms
            fn.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_void_p,
            ]
            fn.restype = ctypes.c_int
            _lib = lib
        return _lib
