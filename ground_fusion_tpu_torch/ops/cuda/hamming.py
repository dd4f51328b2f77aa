"""Pairwise Hamming distance of packed 256-bit BRIEF descriptors: the CUDA
kernel's wrapper and its plain PyTorch versions.

:func:`hamming_matrix` is what ``global_layers/brief.py::match_brief`` calls.
For CUDA tensors it launches the hand-written kernel of ``csrc/hamming.cu``
(which replaces the TPU kernel ``hamming_matrix_pallas`` of
``ground_fusion_tpu/ops/pallas/hamming.py``); it never falls back: a kernel
that does not build or launch raises. For CPU tensors — and only because the
tensors lie on the CPU — it runs :func:`hamming_matrix_reference`, the SWAR
popcount of ``global_layers/brief.py::hamming_matrix``, which is what the
kernel is held against. :func:`hamming_matrix_mxu` is the bit-plane form
(``d = |a| + |b| − 2·a·b``) of the JAX package's ``hamming_matrix_mxu``; it
is exact too, and nothing on the card's path calls it.

Descriptors are ``torch.int32 [K, 8]`` tensors holding the uint32 bit
pattern of each word (numpy ``uint32.view(np.int32)``); the kernel reads them
as uint32. PyTorch has little uint32 arithmetic and ``>>`` on int32 is an
arithmetic shift, so the plain versions widen each word to int64 and mask it
to its 32 bits before any shift.

``LAUNCHES`` counts kernel launches and ``REFERENCE_CALLS`` counts runs of
the plain version through the wrapper; both are plain integers.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import build

LAUNCHES = 0          # +1 wherever the wrapper launches the CUDA kernel
REFERENCE_CALLS = 0   # +1 wherever the wrapper takes the plain version (CPU tensors)

KERNEL_NAME = "hamming"
WORDS = 8             # 256-bit descriptors
_MAX_ROWS = 65535 * 32   # the kernel's grid covers this many rows of `a`


def words_u32(desc: Tensor) -> Tensor:
    """int32 bit patterns → their uint32 values as int64 (same shape)."""
    return desc.to(torch.int64) & 0xFFFFFFFF


def popcount32(x: Tensor) -> Tensor:
    """SWAR popcount of uint32 values held in an int64 tensor
    (``_popcount32`` of the TPU kernel; ``brief.py:122-128``)."""
    c = x - ((x >> 1) & 0x55555555)
    c = (c & 0x33333333) + ((c >> 2) & 0x33333333)
    c = (c + (c >> 4)) & 0x0F0F0F0F
    c = c + (c >> 8)
    return (c + (c >> 16)) & 0x3F


def hamming_matrix_reference(da: Tensor, db: Tensor) -> Tensor:
    """Plain version: ``[Ka,8] × [Kb,8]`` int32 words → ``[Ka,Kb]`` int32,
    XOR and SWAR popcount summed over the words."""
    x = words_u32(da)[:, None, :] ^ words_u32(db)[None, :, :]
    return popcount32(x).sum(dim=-1).to(torch.int32)


def unpack_bits(desc: Tensor, dtype=torch.float32) -> Tensor:
    """``[K,8]`` int32 words → ``[K,256]`` bit planes (bit j of word w at
    column 32·w + j), as 0/1 values of ``dtype``."""
    shifts = torch.arange(32, device=desc.device)
    bits = (words_u32(desc)[:, :, None] >> shifts) & 1
    return bits.reshape(desc.shape[0], WORDS * 32).to(dtype)


def hamming_matrix_mxu(da: Tensor, db: Tensor) -> Tensor:
    """Bit-plane version: ``d = |a| + |b| − 2·a·bᵀ`` over unpacked bits.
    Exact: float32 holds every integer up to 256 and TF32 is off."""
    a = unpack_bits(da)
    b = unpack_bits(db)
    na = a.sum(dim=1).to(torch.int32)
    nb = b.sum(dim=1).to(torch.int32)
    ab = (a @ b.T).to(torch.int32)
    return na[:, None] + nb[None, :] - 2 * ab


def _c_function():
    fn = build.library(KERNEL_NAME).hamming_matrix_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, ctypes.c_int, ctypes.c_int, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"hamming_matrix: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"hamming_matrix: {name} has dtype {t.dtype}, the kernel takes int32 words")
    if t.dim() != 2 or t.shape[1] != WORDS:
        raise ValueError(f"hamming_matrix: {name} has shape {tuple(t.shape)}, expected [K, {WORDS}]")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"hamming_matrix: {name} must be contiguous and 16-byte aligned")


def hamming_matrix(da: Tensor, db: Tensor) -> Tensor:
    """``[Ka,8] × [Kb,8]`` int32 words → ``[Ka,Kb]`` int32 Hamming distances.

    CUDA tensors: contiguous int32 ``[K,8]`` on one device; launches the
    kernel on the current stream without synchronising, or raises. CPU
    tensors: the plain version."""
    global LAUNCHES, REFERENCE_CALLS
    if da.device.type == "cpu":
        REFERENCE_CALLS += 1
        return hamming_matrix_reference(da, db)
    if da.device.type != "cuda":
        raise ValueError(f"hamming_matrix: unsupported device {da.device}")

    dev = da.device
    _check("da", da, dev)
    _check("db", db, dev)
    ka, kb = da.shape[0], db.shape[0]
    if ka > _MAX_ROWS:
        raise ValueError(f"hamming_matrix: {ka} rows exceed the kernel's grid ({_MAX_ROWS})")
    out = torch.empty((ka, kb), dtype=torch.int32, device=dev)
    if ka == 0 or kb == 0:
        return out

    fn = _c_function()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(da.data_ptr(), db.data_ptr(), out.data_ptr(), ka, kb, stream)
    if err != 0:
        raise RuntimeError(f"hamming_matrix: kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out
