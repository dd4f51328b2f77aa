"""Hamming distance of packed 256-bit BRIEF descriptors: the CUDA kernels'
wrappers and their plain PyTorch versions.

Both entry points launch a kernel of ``csrc/hamming.cu``, which replaces the
TPU kernel ``hamming_matrix_pallas``
(``ground_fusion_tpu/ops/pallas/hamming.py:66``):

* :func:`hamming_match` — for each current descriptor, the first old
  descriptor at the least masked distance and whether it is a match: what
  ``global_layers/brief.py::match_brief`` returns, in one launch, with no
  ``[Kc,Kb]`` matrix in device memory. ``match_brief`` calls it.
* :func:`hamming_matrix` — the ``[Ka,Kb]`` distance matrix, the TPU
  kernel's one-to-one counterpart; nothing on a path of the port calls it.

For CUDA tensors each launches its kernel or raises; it never falls back.
For CPU tensors — and only because the tensors lie on the CPU — each runs
its plain version: :func:`match_brief_reference` (the SWAR matrix, the mask,
``argmin``, ``gather``) and :func:`hamming_matrix_reference` (the SWAR
popcount of ``global_layers/brief.py::hamming_matrix``), which are what the
kernels are held against. :func:`hamming_matrix_mxu` is the bit-plane form
(``d = |a| + |b| − 2·a·b``) of the JAX package's ``hamming_matrix_mxu``; it
is exact too, and nothing on the card's path calls it.

What bounded the previous design on an H100 was not the kernel (1.6 µs on
the device) but the host work of each call (20-27 µs: checks, an output
allocation, a device context, a stream lookup, ctypes) and the four device
passes ``match_brief`` made over the matrix afterwards. The match kernel
folds the mask, the first-minimum search and the gate into the distance
pass, and the wrappers do the least host work a call can: the C function is
looked up once, the stream is asked of its device directly, the outputs are
one allocation, and the C side makes the device current only when it is not.

Descriptors are ``torch.int32 [K, 8]`` tensors holding the uint32 bit
pattern of each word (numpy ``uint32.view(np.int32)``); the kernels read
them as uint32. PyTorch has little uint32 arithmetic and ``>>`` on int32 is
an arithmetic shift, so the plain versions widen each word to int64 and mask
it to its 32 bits before any shift.

Counters, plain integers: ``LAUNCHES`` / ``REFERENCE_CALLS`` for
:func:`hamming_matrix`, ``MATCH_LAUNCHES`` / ``MATCH_REFERENCE_CALLS`` for
:func:`hamming_match` (+1 where the wrapper launches the kernel / takes the
plain version).
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import build

LAUNCHES = 0                # hamming_matrix: +1 wherever the wrapper launches the CUDA kernel
REFERENCE_CALLS = 0         # hamming_matrix: +1 wherever the wrapper takes the plain version
MATCH_LAUNCHES = 0          # hamming_match: the same two counts
MATCH_REFERENCE_CALLS = 0

KERNEL_NAME = "hamming"     # csrc/hamming.cu
WORDS = 8                   # 256-bit descriptors
MASKED = 10_000             # the distance of a masked old descriptor
_MAX_ROWS = 65535 * 32      # the matrix kernel's grid covers this many rows of `a`
_MAX_MATCH_ROWS = 2**31 - 1     # rows and columns of the match are counted in a C int


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


def match_brief_reference(desc_cur: Tensor, ok_cur: Tensor, desc_old: Tensor, ok_old: Tensor,
                          thresh: int = 80):
    """Plain version of :func:`hamming_match`: the SWAR distance matrix,
    ``MASKED`` where ``ok_old`` is false, the first minimum of each row
    (``torch.argmin``, as ``jnp.argmin``), and the gate ``ok_cur & (best <
    thresh)``. Returns (idx [Kc] int64, matched [Kc] bool)."""
    d = hamming_matrix_reference(desc_cur, desc_old)
    d = torch.where(ok_old[None, :], d, torch.full_like(d, MASKED))
    idx = torch.argmin(d, dim=1)                      # documented: the first minimum
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    return idx, ok_cur & (best < thresh)


_fns = {}


def _kernel(name: str):
    """The C entry point ``<name>_launch``, built and typed at its first use,
    then kept."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(build.library(KERNEL_NAME), f"{name}_launch")
        p, i = ctypes.c_void_p, ctypes.c_int
        fn.argtypes = {"hamming_matrix": [p, p, p, i, i, i, p],
                       "hamming_match": [p, p, p, p, p, p, i, i, i, i, p]}[name]
        fn.restype = i
        _fns[name] = fn
    return fn


def _check(fn: str, name: str, t: Tensor, device) -> None:
    if t.device != device:
        raise ValueError(f"{fn}: {name} is on {t.device}, expected {device}")
    if t.dtype != torch.int32:
        raise TypeError(f"{fn}: {name} has dtype {t.dtype}, the kernel takes int32 words")
    if t.dim() != 2 or t.shape[1] != WORDS:
        raise ValueError(f"{fn}: {name} has shape {tuple(t.shape)}, expected [K, {WORDS}]")
    if not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"{fn}: {name} must be contiguous and 16-byte aligned")


def _check_mask(fn: str, name: str, t: Tensor, device, k: int) -> None:
    if t.device != device or t.dtype != torch.bool or tuple(t.shape) != (k,) \
            or not t.is_contiguous():
        raise ValueError(f"{fn}: {name} must be a contiguous bool [{k}] tensor on {device}, "
                         f"got {t.dtype} {tuple(t.shape)} on {t.device}")


def _check_match(desc_cur: Tensor, ok_cur: Tensor, desc_old: Tensor, ok_old: Tensor):
    """What the match kernel takes, checked on any device that is not the
    CPU; returns (kc, kb)."""
    dev = desc_cur.device
    _check("hamming_match", "desc_cur", desc_cur, dev)
    _check("hamming_match", "desc_old", desc_old, dev)
    kc, kb = desc_cur.shape[0], desc_old.shape[0]
    if kc > _MAX_MATCH_ROWS or kb > _MAX_MATCH_ROWS:
        raise ValueError(f"hamming_match: {kc} x {kb} descriptors exceed the kernel's "
                         f"{_MAX_MATCH_ROWS} rows")
    if kb == 0:
        raise ValueError("hamming_match: no old descriptor to match against")
    _check_mask("hamming_match", "ok_cur", ok_cur, dev, kc)
    _check_mask("hamming_match", "ok_old", ok_old, dev, kb)
    if dev.type != "cuda":
        raise ValueError(f"hamming_match: unsupported device {dev}")
    return kc, kb


def hamming_matrix(da: Tensor, db: Tensor) -> Tensor:
    """``[Ka,8] × [Kb,8]`` int32 words → ``[Ka,Kb]`` int32 Hamming distances.

    CUDA tensors: contiguous int32 ``[K,8]`` on one device; launches the
    kernel on the current stream without synchronising, or raises. CPU
    tensors: the plain version."""
    global LAUNCHES, REFERENCE_CALLS
    if da.device.type == "cpu":
        REFERENCE_CALLS += 1
        return hamming_matrix_reference(da, db)
    dev = da.device
    _check("hamming_matrix", "da", da, dev)
    _check("hamming_matrix", "db", db, dev)
    ka, kb = da.shape[0], db.shape[0]
    if ka > _MAX_ROWS:
        raise ValueError(f"hamming_matrix: {ka} rows exceed the kernel's grid ({_MAX_ROWS})")
    if dev.type != "cuda":
        raise ValueError(f"hamming_matrix: unsupported device {dev}")
    out = torch.empty((ka, kb), dtype=torch.int32, device=dev)
    if ka == 0 or kb == 0:
        return out
    err = _kernel("hamming_matrix")(da.data_ptr(), db.data_ptr(), out.data_ptr(), ka, kb,
                                    dev.index, build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"hamming_matrix: kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out


def hamming_match(desc_cur: Tensor, ok_cur: Tensor, desc_old: Tensor, ok_old: Tensor,
                  thresh: int = 80):
    """Best old match of every current descriptor: ``(idx [Kc] int64,
    matched [Kc] bool)``, ``idx`` the first old index at the least distance
    (``MASKED`` where ``ok_old`` is false), ``matched = ok_cur & (best <
    thresh)``.

    CUDA tensors: contiguous int32 ``[K,8]`` descriptors and bool masks on
    one device, at least one old descriptor; launches the fused kernel once on
    the current stream without synchronising, or raises. CPU tensors:
    :func:`match_brief_reference`."""
    global MATCH_LAUNCHES, MATCH_REFERENCE_CALLS
    if desc_cur.device.type == "cpu":
        MATCH_REFERENCE_CALLS += 1
        return match_brief_reference(desc_cur, ok_cur, desc_old, ok_old, thresh)
    kc, kb = _check_match(desc_cur, ok_cur, desc_old, ok_old)
    dev = desc_cur.device
    # two allocations: on the chip machine's host they cost less than one
    # buffer and the views that would split it (tools/wrapper_host_cost.py)
    idx = torch.empty(kc, dtype=torch.int64, device=dev)
    matched = torch.empty(kc, dtype=torch.bool, device=dev)
    if kc == 0:
        return idx, matched
    err = _kernel("hamming_match")(desc_cur.data_ptr(), ok_cur.data_ptr(), desc_old.data_ptr(),
                                   ok_old.data_ptr(), idx.data_ptr(), matched.data_ptr(), kc, kb,
                                   int(thresh), dev.index, build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"hamming_match: kernel launch failed with CUDA error {err}")
    MATCH_LAUNCHES += 1
    return idx, matched
