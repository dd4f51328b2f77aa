"""Build the CUDA sources under ``csrc/`` with ``nvcc`` and load them with ctypes.

Each ``<name>.cu`` exports a plain C interface and becomes one shared library
``_build/lib<name>-<hash>.so`` inside the package (the directory is ignored
by git), keyed by a hash of the source text and the compiler flags, so an
edited source is rebuilt and an unchanged one is reused. Nothing is built at
import time: :func:`library` builds at first use, :func:`build_all` starts one
``nvcc`` per source at once and waits for all of them. A failed build raises.
:func:`current_stream` is the stream handle the wrappers launch on.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC_DIR = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_libs: dict[str, ctypes.CDLL] = {}
build_logs: dict[str, str] = {}     # name -> what nvcc/ptxas printed


def source_path(name: str) -> str:
    return os.path.join(CSRC_DIR, f"{name}.cu")


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels can only be built where the "
                       "CUDA toolkit is installed")


def _target(name: str) -> str:
    with open(source_path(name), "rb") as fp:
        digest = hashlib.sha256(fp.read() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"lib{name}-{digest}.so")


def _start(name: str):
    """Start nvcc for one source; returns (process, temporary path, final path)
    or None when the library is already built."""
    out = _target(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-o", tmp, source_path(name)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, out = started
    log, _ = proc.communicate()
    build_logs[name] = log
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise RuntimeError(f"nvcc failed for {source_path(name)} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names) -> None:
    """Build several sources in parallel: one nvcc each, all started together."""
    started = [(n, _start(n)) for n in names]
    for n, s in started:
        _finish(n, s)


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of ``csrc/<name>.cu``, built at first use."""
    if name not in _libs:
        _finish(name, _start(name))
        _libs[name] = ctypes.CDLL(_target(name))
    return _libs[name]


def current_stream(dev) -> int:
    """The raw handle of ``dev``'s current stream, from PyTorch's raw query:
    ``torch.cuda.current_stream(dev).cuda_stream`` builds a Stream object
    first and costs some 20 times as much host time a call
    (``tools/wrapper_host_cost.py``)."""
    return torch._C._cuda_getCurrentRawStream(dev.index)
