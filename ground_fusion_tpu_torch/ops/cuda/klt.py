"""One pyramid level of Lucas–Kanade for a feature batch: the CUDA kernel's
wrapper and its plain PyTorch version.

:func:`lk_level` is what the front end calls. For CUDA tensors it launches
the hand-written kernel of ``csrc/lk_level.cu`` (which replaces the TPU
kernel ``lk_level_pallas`` of ``ground_fusion_tpu/ops/pallas/klt.py``); it
never falls back: a kernel that does not build or launch raises. For CPU
tensors — and only because the tensors lie on the CPU — it runs
:func:`lk_level_reference`, the same arithmetic written with batched
indexing, which works for any dtype and any device and is what the kernel is
held against.

What bounds the kernel on an H100 and what its design does about it is
written at the top of the CUDA source: the work is a few microseconds of
bytes and operations, so the design spends one block per feature to cut the
latency of the ten dependent Gauss–Newton iterations.

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

KERNEL_NAME = "lk_level"
_MAX_SHARED_BYTES = 48 * 1024


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
    """Plain PyTorch version. pts are (x, y) at THIS level's scale. Returns
    the updated points and the mask of features that are valid and pass the
    structure-tensor conditioning gate (like the OpenCV minEigThreshold
    path); a feature that does not pass keeps its seed."""
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


def _c_function():
    fn = build.library(KERNEL_NAME).lk_level_launch
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p, p, p, p, p, p, p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _check(name: str, t: Tensor, device, dtype, shape) -> None:
    if t.device != device:
        raise ValueError(f"lk_level: {name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"lk_level: {name} has dtype {t.dtype}, the kernel takes {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"lk_level: {name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"lk_level: {name} must be contiguous")


def lk_level(prev_img: Tensor, cur_img: Tensor, pts_prev: Tensor, pts_cur: Tensor,
             valid: Tensor, half: int = 10, iters: int = 10, min_eig: float = 1e-4):
    """One LK level for N features: ``(pts [N,2], ok [N] bool)``.

    CUDA tensors: f32 contiguous images ``[H,W]`` of one shape, f32 points
    ``[N,2]``, ``valid`` ``[N]`` bool or uint8; launches the kernel on the
    current stream without synchronising, or raises. CPU tensors: the plain
    version."""
    global LAUNCHES, REFERENCE_CALLS
    if prev_img.device.type == "cpu":
        REFERENCE_CALLS += 1
        return lk_level_reference(prev_img, cur_img, pts_prev, pts_cur, valid,
                                  half, iters, min_eig)
    if prev_img.device.type != "cuda":
        raise ValueError(f"lk_level: unsupported device {prev_img.device}")

    dev = prev_img.device
    if prev_img.dim() != 2:
        raise ValueError("lk_level: images must be [H, W]")
    h, w = prev_img.shape
    n = pts_prev.shape[0]
    if h < 2 or w < 2:
        raise ValueError("lk_level: images must be at least 2x2")
    _check("prev_img", prev_img, dev, torch.float32, (h, w))
    _check("cur_img", cur_img, dev, torch.float32, (h, w))
    _check("pts_prev", pts_prev, dev, torch.float32, (n, 2))
    _check("pts_cur", pts_cur, dev, torch.float32, (n, 2))
    if valid.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"lk_level: valid has dtype {valid.dtype}, expected bool or uint8")
    _check("valid", valid, dev, valid.dtype, (n,))
    p = 2 * half + 1
    if half < 1 or ((p + 2) ** 2 + 2 * p * p + 24) * 4 > _MAX_SHARED_BYTES:
        raise ValueError(f"lk_level: patch half-size {half} does not fit the kernel's shared memory")

    fn = _c_function()
    out_pts = torch.empty((n, 2), dtype=torch.float32, device=dev)
    out_ok = torch.empty((n,), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = fn(prev_img.data_ptr(), cur_img.data_ptr(), pts_prev.data_ptr(),
                 pts_cur.data_ptr(), valid.data_ptr(), out_pts.data_ptr(), out_ok.data_ptr(),
                 n, h, w, half, iters, float(min_eig), stream)
    if err != 0:
        raise RuntimeError(f"lk_level: kernel launch failed with CUDA error {err}")
    LAUNCHES += 1
    return out_pts, out_ok
