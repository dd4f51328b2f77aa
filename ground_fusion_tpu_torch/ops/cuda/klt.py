"""Lucas–Kanade tracking of a feature batch: the CUDA kernel's wrappers and
their plain PyTorch versions.

Both entry points launch the one kernel of ``csrc/lk_level.cu``, which
replaces the TPU kernel ``lk_level_pallas``
(``ground_fusion_tpu/ops/pallas/klt.py:177``):

* :func:`lk_track` — the whole bidirectional pyramidal track of
  ``frontend/klt.py::track_bidirectional`` (forward coarse to fine, backward,
  the ``inb`` masks, the round-trip gate) in one launch; what the front end
  calls, for the frame's features and for stereo depths;
* :func:`lk_level` — the same kernel with ``levels = 1``, forward only and no
  final masks: one pyramid level, the TPU kernel's own function.

For CUDA tensors each launches the kernel or raises; it never falls back.
For CPU tensors — and only because the tensors lie on the CPU — each runs its
plain version: :func:`lk_track_reference`, the chain of
:func:`lk_level_reference` over levels and both directions, and
:func:`lk_level_reference`, the same arithmetic as the kernel written with
batched indexing, which works for any dtype and any device and is what the
kernel is held against.

What bounded the previous design on an H100, and what this one does about it
(the CUDA source says more): the work is a few microseconds of bytes and
operations, but the front end made six launches a frame (one per level and
direction) with some sixty small tensor operations of host work between
them, and each launch was a chain of ten iterations whose taps were read at
L2 latency and reduced with block barriers. Now one launch runs the whole
track, a block of four warps owns a feature, its reductions are warp shuffles
and one barrier, and its taps read windows staged in shared memory.

Counters, plain integers: ``LAUNCHES`` / ``REFERENCE_CALLS`` for
:func:`lk_level`, ``TRACK_LAUNCHES`` / ``TRACK_REFERENCE_CALLS`` for
:func:`lk_track` (+1 where the wrapper launches the kernel / takes the plain
version). ``LAST_RESTAGES`` is the device tensor [N] int32 of the last
launch: how often each feature's search window was staged again because an
iterate left it.
"""

from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from . import build

LAUNCHES = 0                # lk_level: +1 wherever the wrapper launches the CUDA kernel
REFERENCE_CALLS = 0         # lk_level: +1 wherever the wrapper takes the plain version
TRACK_LAUNCHES = 0          # lk_track: the same two counts
TRACK_REFERENCE_CALLS = 0
LAST_RESTAGES = None

KERNEL_NAME = "lk_level"    # csrc/lk_level.cu
MAX_LEVELS = 8              # the kernel's kMaxLevels
MAX_HALF = 14               # the kernel is built for patch half-sizes 1..14 (kMaxHalf)
_MAX_ROWS = 2**31 - 1       # features are counted in a C int


# --------------------------------------------------------------------------- plain versions


def _bilinear_patches(img: Tensor, centers: Tensor, half: int) -> Tensor:
    """(2·half+1)² patches around ``centers`` [N,2] (x, y) with bilinear
    interpolation → [N, n, n]. Out-of-bounds clamps to the border: each tap
    clamps its integer corner to [0,w-2]×[0,h-2], its fraction stays as it is."""
    h, w = img.shape
    d = torch.arange(-half, half + 1, dtype=img.dtype, device=img.device)
    gx = centers[:, 0, None, None] + d[None, None, :]
    gy = centers[:, 1, None, None] + d[None, :, None]
    x0 = torch.floor(gx)
    y0 = torch.floor(gy)
    fx = gx - x0
    fy = gy - y0
    # float clamp first so that the integer conversion stays in range
    x0i = torch.clamp(torch.clamp(x0, -1, w).to(torch.int64), 0, w - 2)
    y0i = torch.clamp(torch.clamp(y0, -1, h).to(torch.int64), 0, h - 2)
    i00 = img[y0i, x0i]
    i01 = img[y0i, x0i + 1]
    i10 = img[y0i + 1, x0i]
    i11 = img[y0i + 1, x0i + 1]
    return (
        i00 * (1 - fx) * (1 - fy)
        + i01 * fx * (1 - fy)
        + i10 * (1 - fx) * fy
        + i11 * fx * fy
    )


def _template_terms(prev_img: Tensor, pts_prev: Tensor, half: int):
    """Template patch, its central-difference gradients and the 2x2 structure
    tensor at the previous points → (t, gx, gy, a11, a12, a22, det, eig_min / n)."""
    patch_t = _bilinear_patches(prev_img, pts_prev, half + 1)      # template + border
    gx = 0.5 * (patch_t[:, 1:-1, 2:] - patch_t[:, 1:-1, :-2])
    gy = 0.5 * (patch_t[:, 2:, 1:-1] - patch_t[:, :-2, 1:-1])
    t = patch_t[:, 1:-1, 1:-1]
    a11 = torch.sum(gx * gx, dim=(1, 2))
    a12 = torch.sum(gx * gy, dim=(1, 2))
    a22 = torch.sum(gy * gy, dim=(1, 2))
    det = a11 * a22 - a12 * a12
    tr = a11 + a22
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    return t, gx, gy, a11, a12, a22, det, eig_min / (2 * half + 1) ** 2


def lk_level_reference(prev_img: Tensor, cur_img: Tensor, pts_prev: Tensor,
                       pts_cur: Tensor, valid: Tensor, half: int = 10,
                       iters: int = 10, min_eig: float = 1e-4):
    """Plain PyTorch version of one level. pts are (x, y) at THIS level's
    scale. Returns the updated points and the mask of features that are valid
    and pass the structure-tensor conditioning gate (like the OpenCV
    minEigThreshold path); a feature that does not pass keeps its seed."""
    t, gx, gy, a11, a12, a22, det, eig_n = _template_terms(prev_img, pts_prev, half)
    good = valid.to(torch.bool) & (eig_n > min_eig)
    big = det > 1e-12
    inv = torch.where(big, 1.0 / torch.where(big, det, torch.ones_like(det)),
                      torch.zeros_like(det))

    p = pts_cur
    for _ in range(iters):
        e = _bilinear_patches(cur_img, p, half) - t
        b1 = torch.sum(e * gx, dim=(1, 2))
        b2 = torch.sum(e * gy, dim=(1, 2))
        dx = inv * (a22 * b1 - a12 * b2)
        dy = inv * (-a12 * b1 + a11 * b2)
        p = p - torch.stack([dx, dy], dim=-1)
    return torch.where(good[:, None], p, pts_cur), good


def lk_eig_min(prev_img: Tensor, pts_prev: Tensor, half: int = 10) -> Tensor:
    """The gate's quantity ``eig_min / n`` per feature (plain PyTorch), for
    telling a genuine mask disagreement from rounding right at the gate."""
    return _template_terms(prev_img, pts_prev, half)[-1]


def track_pyramidal_chain(level_fn, prev_pyr, cur_pyr, pts_prev, pts_seed, valid,
                          levels: int, half: int = 10, iters: int = 10, min_eig: float = 1e-4):
    """Coarse-to-fine LK through ``level_fn`` (:func:`lk_level_reference` or
    :func:`lk_level`), one call per level: the control flow of the JAX
    package's ``track_pyramidal``. ``*_pyr`` are per-level images (finest
    first); points are pixel coords at full resolution. Returns (pts, ok)."""
    pts = pts_seed / (2.0 ** (levels - 1))
    ok = valid
    for lvl in range(levels - 1, -1, -1):
        pp = pts_prev / (2.0 ** lvl)
        pts, ok_lvl = level_fn(prev_pyr[lvl], cur_pyr[lvl], pp.contiguous(), pts.contiguous(),
                               ok, half, iters, min_eig)
        ok = ok & ok_lvl
        if lvl > 0:
            pts = pts * 2.0
    h, w = cur_pyr[0].shape
    inb = (pts[:, 0] >= 1) & (pts[:, 0] < w - 2) & (pts[:, 1] >= 1) & (pts[:, 1] < h - 2)
    return pts, ok & inb


def track_bidirectional_chain(level_fn, prev_pyr, cur_pyr, pts_prev, pts_seed, valid,
                              levels: int, half: int = 10, iters: int = 10,
                              fb_thresh: float = 0.5, min_eig: float = 1e-4):
    """Forward + reverse flow with the round-trip gate through ``level_fn``,
    one call per level and direction (``feature_tracker.cpp:137-153``)."""
    fwd, ok_f = track_pyramidal_chain(level_fn, prev_pyr, cur_pyr, pts_prev, pts_seed, valid,
                                      levels, half, iters, min_eig)
    back, ok_b = track_pyramidal_chain(level_fn, cur_pyr, prev_pyr, fwd, pts_prev, ok_f,
                                       levels, half, iters, min_eig)
    dist = torch.linalg.norm(back - pts_prev, dim=-1)
    return fwd, ok_f & ok_b & (dist <= fb_thresh)


def lk_track_reference(prev_pyr, cur_pyr, pts_prev, pts_seed, valid, levels: int,
                       half: int = 10, iters: int = 10, fb_thresh: float = 0.5,
                       min_eig: float = 1e-4):
    """Plain PyTorch version of :func:`lk_track`: the chain of
    :func:`lk_level_reference`. Returns (fwd [N,2], ok [N])."""
    return track_bidirectional_chain(lk_level_reference, prev_pyr, cur_pyr, pts_prev, pts_seed,
                                     valid, levels, half, iters, fb_thresh, min_eig)


# --------------------------------------------------------------------------- the kernel


_fn = None


def _kernel():
    """The C entry point, built and typed at its first use, then kept."""
    global _fn
    if _fn is None:
        fn = build.library(KERNEL_NAME).lk_track_launch
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        ptrs, ints = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
        fn.argtypes = [ptrs, ptrs, ints, ints, i, p, i, p, i, p, p, p, p, i, i, i, f, i, f, i, p]
        fn.restype = i
        _fn = fn
    return _fn


def _check_image(name: str, t: Tensor, dev, shape=None) -> None:
    if t.device != dev:
        raise ValueError(f"lk: {name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"lk: {name} has dtype {t.dtype}, the kernel takes torch.float32")
    if t.dim() != 2 or t.shape[0] < 2 or t.shape[1] < 2:
        raise ValueError(f"lk: {name} has shape {tuple(t.shape)}, expected [H, W] of at least 2x2")
    if shape is not None and tuple(t.shape) != shape:
        raise ValueError(f"lk: {name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"lk: {name} must be contiguous")


def _check_points(name: str, t: Tensor, dev, n: int) -> None:
    if t.device != dev:
        raise ValueError(f"lk: {name} is on {t.device}, expected {dev}")
    if t.dtype != torch.float32:
        raise TypeError(f"lk: {name} has dtype {t.dtype}, the kernel takes torch.float32")
    if t.dim() != 2 or tuple(t.shape) != (n, 2) or (n > 1 and t.stride(1) != 1):
        raise ValueError(f"lk: {name} must be [{n}, 2] with (x, y) adjacent, "
                         f"got shape {tuple(t.shape)} strides {t.stride()}")


def _launch(prev_pyr, cur_pyr, pts_prev, pts_seed, valid, levels: int, half: int, iters: int,
            min_eig: float, track: bool, fb_thresh: float):
    """Check what the kernel takes, allocate the outputs once, launch once.
    Raises on any tensor that is not on the CUDA device of ``prev_pyr[0]``."""
    global LAST_RESTAGES
    if not 1 <= levels <= MAX_LEVELS or len(prev_pyr) < levels or len(cur_pyr) < levels:
        raise ValueError(f"lk: {levels} levels do not fit the kernel ({MAX_LEVELS} at most) "
                         f"or the pyramids ({len(prev_pyr)} and {len(cur_pyr)} levels)")
    if not 1 <= half <= MAX_HALF or iters < 0:
        raise ValueError(f"lk: patch half-size {half} or {iters} iterations do not fit the kernel "
                         f"(half-sizes 1..{MAX_HALF})")
    dev = prev_pyr[0].device
    for lvl in range(levels):
        _check_image(f"prev level {lvl}", prev_pyr[lvl], dev)
        _check_image(f"cur level {lvl}", cur_pyr[lvl], dev, tuple(prev_pyr[lvl].shape))
    n = pts_prev.shape[0] if pts_prev.dim() == 2 else -1
    if not 0 <= n <= _MAX_ROWS:
        raise ValueError(f"lk: {n} features do not fit the kernel ({_MAX_ROWS} at most)")
    _check_points("pts_prev", pts_prev, dev, n)
    _check_points("pts_seed", pts_seed, dev, n)
    if valid.device != dev or valid.dtype not in (torch.bool, torch.uint8) \
            or tuple(valid.shape) != (n,) or not valid.is_contiguous():
        raise ValueError(f"lk: valid must be a contiguous bool or uint8 [{n}] tensor on {dev}, got "
                         f"{valid.dtype} {tuple(valid.shape)} on {valid.device}")
    if dev.type != "cuda":
        raise ValueError(f"lk: unsupported device {dev}")

    # separate allocations: on the chip machine's host they cost less than one
    # buffer and the views that would split it (tools/wrapper_host_cost.py)
    out_pts = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_ok = torch.empty(n, dtype=torch.bool, device=dev)
    restages = torch.empty(n, dtype=torch.int32, device=dev)
    ptr_array = ctypes.c_void_p * levels
    int_array = ctypes.c_int * levels
    err = _kernel()(
        ptr_array(*[t.data_ptr() for t in prev_pyr[:levels]]),
        ptr_array(*[t.data_ptr() for t in cur_pyr[:levels]]),
        int_array(*[t.shape[0] for t in prev_pyr[:levels]]),
        int_array(*[t.shape[1] for t in prev_pyr[:levels]]), levels,
        pts_prev.data_ptr(), pts_prev.stride(0), pts_seed.data_ptr(), pts_seed.stride(0),
        valid.data_ptr(), out_pts.data_ptr(), out_ok.data_ptr(), restages.data_ptr(), n, half,
        iters, float(min_eig), int(track), float(fb_thresh), dev.index, build.current_stream(dev))
    if err != 0:
        raise RuntimeError(f"lk: kernel launch failed with CUDA error {err}")
    LAST_RESTAGES = restages
    return out_pts, out_ok


def lk_track(prev_pyr, cur_pyr, pts_prev: Tensor, pts_seed: Tensor, valid: Tensor, levels: int,
             half: int = 10, iters: int = 10, fb_thresh: float = 0.5, min_eig: float = 1e-4):
    """The bidirectional pyramidal track: ``(fwd [N,2], ok [N] bool)``.

    CUDA tensors: per-level f32 contiguous images (finest first, the two
    pyramids of one shape), f32 points ``[N,2]`` whose (x, y) are adjacent
    (rows may be strided), ``valid`` ``[N]`` bool or uint8; launches the
    kernel once on the current stream without synchronising, or raises. CPU
    tensors: :func:`lk_track_reference`."""
    global TRACK_LAUNCHES, TRACK_REFERENCE_CALLS
    if prev_pyr[0].device.type == "cpu":
        TRACK_REFERENCE_CALLS += 1
        return lk_track_reference(prev_pyr, cur_pyr, pts_prev, pts_seed, valid, levels, half,
                                  iters, fb_thresh, min_eig)
    out = _launch(prev_pyr, cur_pyr, pts_prev, pts_seed, valid, levels, half, iters, min_eig,
                  True, fb_thresh)
    TRACK_LAUNCHES += 1
    return out


def lk_level(prev_img: Tensor, cur_img: Tensor, pts_prev: Tensor, pts_cur: Tensor,
             valid: Tensor, half: int = 10, iters: int = 10, min_eig: float = 1e-4):
    """One LK level for N features: ``(pts [N,2], ok [N] bool)``.

    CUDA tensors: f32 contiguous images ``[H,W]`` of one shape, f32 points
    ``[N,2]``, ``valid`` ``[N]`` bool or uint8; launches the kernel with
    ``levels = 1``, forward only, no final masks, on the current stream
    without synchronising, or raises. CPU tensors: the plain version."""
    global LAUNCHES, REFERENCE_CALLS
    if prev_img.device.type == "cpu":
        REFERENCE_CALLS += 1
        return lk_level_reference(prev_img, cur_img, pts_prev, pts_cur, valid,
                                  half, iters, min_eig)
    out = _launch([prev_img], [cur_img], pts_prev, pts_cur, valid, 1, half, iters, min_eig,
                  False, 0.0)
    LAUNCHES += 1
    return out
