"""Native (C++) observation graph and Hamming distance (port of
``pyslam_tpu/native/__init__.py``).

``obs_graph.cpp`` is the port's own copy of the reference's source, with
the same containers and C ABI: the map mirrors its observation dicts into
it, and the BA edge lists and the covisibility counter come from it, so
their order is libstdc++'s ``unordered_map`` order, as in the reference.

The shared library is compiled with g++ at the first ``get_lib()`` (the
first ``Map``), never at import, into ``pyslam_tpu_torch/_build/`` under a
hash of the source and the flags.  Threads or processes (test workers)
that build at once serialise on a file lock, and the library appears
through an atomic ``os.replace``.  A failed build raises: there is no
pure-Python fallback.

The reference's wrapper cuts its results at fixed capacities
(``point_obs`` at 1024 keyframes, ``covisibility_counts`` at 4096,
``collect_observations`` at 32 observations a point, ``points_seen_by`` at
65536 points).  Here every buffer is sized from a count or grown until the
C call returns less than its capacity, so no result is cut.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

import numpy as np

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "obs_graph.cpp")
BUILD_DIR = os.path.join(_PKG_DIR, "_build")
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None
build_seconds: float | None = None   # g++ wall time of this process's build

_P = ctypes.c_void_p
_I32, _I64 = ctypes.c_int32, ctypes.c_int64
_PI32, _PI64 = ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int64)
_PU8 = ctypes.POINTER(ctypes.c_uint8)
# C entry points: (argument types, result type)
_ENTRY_POINTS = {
    "og_create": ([], _P),
    "og_destroy": ([_P], None),
    "og_add_observation": ([_P, _I64, _I32, _I32], _I32),
    "og_remove_observation": ([_P, _I64, _I32], _I32),
    "og_remove_point": ([_P, _I64], None),
    "og_num_obs": ([_P, _I64], _I32),
    "og_point_obs": ([_P, _I64, _PI32, _PI32, _I32], _I32),
    "og_covisibility_counts": ([_P, _PI64, _I32, _I32, _PI32, _PI32, _I32], _I32),
    "og_points_seen_by": ([_P, _I32, _PI64, _I32], _I32),
    "og_total_observations": ([_P], _I64),
    "og_collect_observations": ([_P, _PI64, _I32, _PI64, _PI32, _PI32, _I64], _I64),
    "hamming_distance_matrix_u8": ([_PU8, _PU8, _PI32, _I32, _I32, _I32], None),
}


def library_path(build_dir: str | None = None) -> str:
    """Path of the shared library for the current source and flags."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(build_dir or BUILD_DIR, f"libpyslam_native_{h.hexdigest()[:16]}.so")


def build(build_dir: str | None = None) -> str:
    """Compile the source unless the library for it exists; returns its path."""
    global build_seconds
    out = library_path(build_dir)
    if os.path.exists(out):
        return out
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native observation graph cannot be built")
    os.makedirs(os.path.dirname(out), exist_ok=True)
    with open(os.path.join(os.path.dirname(out), "native.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)   # released when the file closes
        if os.path.exists(out):            # built meanwhile by another process
            return out
        tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
        t0 = time.perf_counter()
        res = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE], capture_output=True,
                             text=True)
        if res.returncode != 0:
            if os.path.exists(tmp):
                os.remove(tmp)
            raise RuntimeError(f"g++ failed (exit {res.returncode}):\n{res.stderr}")
        os.replace(tmp, out)
        build_seconds = time.perf_counter() - t0
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            for name, (argtypes, restype) in _ENTRY_POINTS.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = restype
            _lib = lib
        return _lib


def _ptr(a: np.ndarray, kind):
    return a.ctypes.data_as(kind)


class NativeObsGraph:
    """ctypes wrapper over the C++ observation graph: pid -> {kid: kp_idx}
    and kid -> {pid}."""

    def __init__(self):
        self._lib = get_lib()
        self._h = self._lib.og_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.og_destroy(self._h)
            self._h = None

    def add_observation(self, pid: int, kid: int, kp_idx: int) -> bool:
        return bool(self._lib.og_add_observation(self._h, pid, kid, kp_idx))

    def remove_observation(self, pid: int, kid: int) -> int:
        return int(self._lib.og_remove_observation(self._h, pid, kid))

    def remove_point(self, pid: int):
        self._lib.og_remove_point(self._h, pid)

    def num_obs(self, pid: int) -> int:
        return int(self._lib.og_num_obs(self._h, pid))

    def point_obs(self, pid: int) -> dict:
        cap = max(self.num_obs(pid), 1)
        kids = np.zeros(cap, np.int32)
        idxs = np.zeros(cap, np.int32)
        n = self._lib.og_point_obs(self._h, pid, _ptr(kids, _PI32), _ptr(idxs, _PI32), cap)
        return {int(k): int(i) for k, i in zip(kids[:n], idxs[:n])}

    def covisibility_counts(self, pids, exclude_kid: int) -> dict:
        """{kid: points shared} over ``pids``, ``exclude_kid`` left out, in
        the C++ counter's order."""
        pids = np.ascontiguousarray(pids, np.int64)
        cap = 256
        while True:
            kids = np.zeros(cap, np.int32)
            counts = np.zeros(cap, np.int32)
            m = self._lib.og_covisibility_counts(self._h, _ptr(pids, _PI64), len(pids),
                                                 exclude_kid, _ptr(kids, _PI32),
                                                 _ptr(counts, _PI32), cap)
            if m < cap:
                return {int(k): int(c) for k, c in zip(kids[:m], counts[:m])}
            cap *= 4

    def collect_observations(self, pids) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """The edge list (row of ``pids``, kid, kp_idx) of every observation
        of the given points, in one C pass: the BA assembly primitive."""
        pids = np.ascontiguousarray(pids, np.int64)
        cap = max(64, len(pids) * 32)
        while True:
            pr = np.zeros(cap, np.int64)
            kd = np.zeros(cap, np.int32)
            kp = np.zeros(cap, np.int32)
            m = self._lib.og_collect_observations(self._h, _ptr(pids, _PI64), len(pids),
                                                  _ptr(pr, _PI64), _ptr(kd, _PI32),
                                                  _ptr(kp, _PI32), cap)
            if m < cap:
                return pr[:m].copy(), kd[:m].copy(), kp[:m].copy()
            cap *= 2

    def points_seen_by(self, kid: int) -> np.ndarray:
        cap = 4096
        while True:
            out = np.zeros(cap, np.int64)
            n = self._lib.og_points_seen_by(self._h, kid, _ptr(out, _PI64), cap)
            if n < cap:
                return out[:n]
            cap *= 4

    def total_observations(self) -> int:
        return int(self._lib.og_total_observations(self._h))


def hamming_distance_matrix_cpu(a_packed: np.ndarray, b_packed: np.ndarray) -> np.ndarray:
    """Popcount Hamming distances between packed uint8 descriptors:
    (N, B) x (M, B) -> (N, M) int32 (the host twin of
    ``ops.hamming.hamming_distance_matrix_packed``)."""
    lib = get_lib()
    a = np.ascontiguousarray(a_packed, np.uint8)
    b = np.ascontiguousarray(b_packed, np.uint8)
    if a.ndim != 2 or b.ndim != 2 or a.shape[1] != b.shape[1]:
        raise ValueError(f"descriptor blocks of shapes {a.shape} and {b.shape}")
    n, nb = a.shape
    m = b.shape[0]
    out = np.zeros((n, m), np.int32)
    lib.hamming_distance_matrix_u8(_ptr(a, _PU8), _ptr(b, _PU8), _ptr(out, _PI32), n, m, nb)
    return out
