"""ctypes bindings for the native ingest runtime (``src/ingest.cpp``).

The port's own copy of the C++ source: IMU and wheel ring buffers, padded
interval drains between two timestamps, and greedy timestamp pairing
(``sync_process`` ±3 ms). :func:`lib` builds ``libgfingest`` with ``g++``
at first use into the package's ``_build/`` directory (ignored by git),
keyed by a hash of the source and the flags, and loads it; nothing is built
at import. There is no fallback: without ``g++``, or when the build fails,
:func:`lib` raises. ``python -m ground_fusion_tpu_torch.scripts.build_native``
builds it ahead of time. Neither pipeline calls this module; it is a host
runtime, with no tensor and no device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import numpy as np

SRC_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "src")
SOURCE = os.path.join(SRC_DIR, "ingest.cpp")
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "_build")
CXX_FLAGS = ["-O2", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_LIB = None


def _gxx() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the native ingest runtime is built with g++ "
                           f"from {SOURCE}")
    return cxx


def library_path() -> str:
    """Where the library of the current source and flags is (or will be)."""
    with open(SOURCE, "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libgfingest-{digest}.so")


def build() -> str:
    """Build the library unless it is built already; returns its path.
    Raises when ``g++`` is missing or the compile fails."""
    out = library_path()
    if os.path.exists(out):
        return out
    cxx = _gxx()
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", tmp, SOURCE],
                          stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"g++ failed for {SOURCE} (exit {proc.returncode}):\n{proc.stdout}")
    os.replace(tmp, out)
    return out


def lib() -> ctypes.CDLL:
    """The loaded library, built at first use."""
    global _LIB
    if _LIB is not None:
        return _LIB
    L = ctypes.CDLL(build())
    L.gf_ingest_create.restype = ctypes.c_void_p
    L.gf_ingest_destroy.argtypes = [ctypes.c_void_p]
    dp = ctypes.POINTER(ctypes.c_double)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    ip = ctypes.POINTER(ctypes.c_int)
    L.gf_push_imu.argtypes = [ctypes.c_void_p, ctypes.c_double, dp, dp]
    L.gf_push_wheel.argtypes = [ctypes.c_void_p, ctypes.c_double, dp, dp]
    for f in (L.gf_drain_imu, L.gf_drain_wheel):
        f.restype = ctypes.c_int
        f.argtypes = [ctypes.c_void_p, ctypes.c_double, ctypes.c_double,
                      ctypes.c_int, dp, dp, dp, u8p, dp, dp]
    L.gf_sync_pairs.restype = ctypes.c_int
    L.gf_sync_pairs.argtypes = [dp, ctypes.c_int, dp, ctypes.c_int,
                                ctypes.c_double, ip, ip, ctypes.c_int]
    _LIB = L
    return L


def _dptr(a):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


class NativeIngest:
    """Ring-buffered sensor ingest backed by the C++ runtime (2¹⁶ IMU and
    2¹⁵ wheel samples; the oldest are overwritten)."""

    def __init__(self):
        self._L = lib()
        self._h = self._L.gf_ingest_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._L.gf_ingest_destroy(self._h)
            self._h = None

    def push_imu(self, t, acc, gyr):
        acc = np.ascontiguousarray(acc, np.float64)
        gyr = np.ascontiguousarray(gyr, np.float64)
        self._L.gf_push_imu(self._h, float(t), _dptr(acc), _dptr(gyr))

    def push_wheel(self, t, vel, gyr):
        vel = np.ascontiguousarray(vel, np.float64)
        gyr = np.ascontiguousarray(gyr, np.float64)
        self._L.gf_push_wheel(self._h, float(t), _dptr(vel), _dptr(gyr))

    def _drain(self, fn, t0, t1, cap):
        dts = np.zeros(cap)
        a = np.zeros((cap, 3))
        b = np.zeros((cap, 3))
        valid = np.zeros(cap, np.uint8)
        a0 = np.zeros(3)
        b0 = np.zeros(3)
        fn(self._h, float(t0), float(t1), cap, _dptr(dts), _dptr(a), _dptr(b),
           valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), _dptr(a0), _dptr(b0))
        return dts, a, b, valid.astype(bool), a0, b0

    def drain_imu(self, t0, t1, cap):
        """Samples with t in (t0, t1], padded to ``cap``: (dts, acc, gyr,
        valid, acc0, gyr0), acc0/gyr0 the newest sample at or before t0."""
        return self._drain(self._L.gf_drain_imu, t0, t1, cap)

    def drain_wheel(self, t0, t1, cap):
        """As :meth:`drain_imu` for the wheel: (dts, vel, gyr, valid, vel0, gyr0)."""
        return self._drain(self._L.gf_drain_wheel, t0, t1, cap)


def sync_pairs(ts_a, ts_b, tol=0.003, cap=4096):
    """Greedy timestamp pairing (sync_process ±3 ms): index arrays into
    ``ts_a`` and ``ts_b``."""
    L = lib()
    ts_a = np.ascontiguousarray(ts_a, np.float64)
    ts_b = np.ascontiguousarray(ts_b, np.float64)
    oi = np.zeros(cap, np.int32)
    oj = np.zeros(cap, np.int32)
    n = L.gf_sync_pairs(_dptr(ts_a), len(ts_a), _dptr(ts_b), len(ts_b),
                        float(tol),
                        oi.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
                        oj.ctypes.data_as(ctypes.POINTER(ctypes.c_int)), cap)
    return oi[:n], oj[:n]
