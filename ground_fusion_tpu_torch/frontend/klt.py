"""Pyramidal Lucas–Kanade optical flow, batched over features on device.

Re-design of the reference's front-end hot loop
(``featureTracker/feature_tracker.cpp:103-372`` trackImage: prediction-seeded
``cv::calcOpticalFlowPyrLK`` :118-133, reverse-flow consistency check
:137-153, min-dist mask :60-83, ``goodFeaturesToTrack`` refill :198): the
whole feature batch advances together. :func:`track_bidirectional` is one
call of :func:`..ops.cuda.klt.lk_track` — on a GPU one launch of the
hand-written CUDA kernel for both directions and every level, for CPU
tensors the chain of the plain per-level version — and the corner refill is
elementwise passes plus two pooling passes.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import Tensor

from ..ops.cuda.klt import lk_level_reference, lk_track

# the plain per-level solve under the name the JAX package gives it
_lk_level = lk_level_reference


def build_pyramid(img: Tensor, levels: int) -> list[Tensor]:
    """[H, W] float image -> list of `levels` images, 2× downsampled each
    (cv::buildOpticalFlowPyramid analog, 2x2 average pooling)."""
    pyr = [img.contiguous()]
    for _ in range(levels - 1):
        a = pyr[-1]
        h2, w2 = (a.shape[0] // 2) * 2, (a.shape[1] // 2) * 2
        a = a[:h2, :w2]
        pyr.append(
            (0.25 * (a[0::2, 0::2] + a[1::2, 0::2] + a[0::2, 1::2] + a[1::2, 1::2])).contiguous())
    return pyr


def track_bidirectional(prev_pyr, cur_pyr, pts_prev, pts_seed, valid,
                        levels: int, half: int = 10, iters: int = 10,
                        fb_thresh: float = 0.5):
    """Forward + reverse flow with consistency gate
    (``feature_tracker.cpp:137-153``: reverse LK seeded at the forward result,
    keep if the round trip lands within 0.5 px), in one :func:`lk_track`
    call: one kernel launch for CUDA tensors, the plain chain for CPU ones."""
    return lk_track(prev_pyr, cur_pyr, pts_prev, pts_seed, valid, levels, half, iters, fb_thresh)


# ---------------------------------------------------------------------------
# Shi-Tomasi corner refill with min-dist suppression
# ---------------------------------------------------------------------------


def shi_tomasi_response(img: Tensor, window: int = 3) -> Tensor:
    """Min-eigenvalue corner response (cv::goodFeaturesToTrack's score).

    The ``window``² box filter is an average pool with zero padding, not a
    convolution: a float32 convolution on a GPU may run in TF32, which would
    rank the corners differently from the CPU."""
    gx = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy = torch.zeros_like(img)
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])

    def box(a):
        return F.avg_pool2d(a[None, None], window, stride=1, padding=window // 2,
                            count_include_pad=True)[0, 0]

    a11 = box(gx * gx)
    a12 = box(gx * gy)
    a22 = box(gy * gy)
    tr = a11 + a22
    det = a11 * a22 - a12 * a12
    return 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0)))


def _box_cover(coord: Tensor, size: int, d: int) -> Tensor:
    """[N, size] bool: which indices of an axis of length ``size`` the span
    ``coord-d .. coord+d`` touches once its ends are clipped into the axis."""
    idx = torch.arange(size, device=coord.device)[None, :]
    c = coord[:, None]
    return ((idx - c).abs() <= d) | ((idx == 0) & (c - d <= 0)) | ((idx == size - 1) & (c + d >= size - 1))


def refill_corners(img: Tensor, existing_pts: Tensor, existing_valid: Tensor,
                   max_new: int, min_dist: int = 30, border: int = 5,
                   quality: float = 0.01):
    """Top-``max_new`` Shi-Tomasi corners at least ``min_dist`` from every
    existing feature and from each other (the min-dist mask of
    ``feature_tracker.cpp:60-83`` + ``goodFeaturesToTrack`` :198).

    Suppression trick: dilate the response with a min_dist-sized max-pool; a
    pixel is a candidate iff it equals the dilated max (local peak in its
    neighborhood), which enforces pairwise min-dist among picks in one shot
    instead of the reference's sequential mask painting. Equal scores are
    returned lowest pixel index first (a stable sort; ``topk`` promises no
    order among ties)."""
    h, w = img.shape
    dev = img.device
    neg_inf = torch.full((), float("-inf"), dtype=img.dtype, device=dev)
    resp = shi_tomasi_response(img)

    # mask borders
    ys = torch.arange(h, device=dev)[:, None]
    xs = torch.arange(w, device=dev)[None, :]
    inb = (ys >= border) & (ys < h - border) & (xs >= border) & (xs < w - border)

    # mask around existing features: a min_dist box of -inf per valid feature,
    # all boxes in one batched mask (rows × cols outer product, summed)
    px = existing_pts[:, 0].to(torch.int64)      # truncation, as the reference
    py = existing_pts[:, 1].to(torch.int64)
    rows = (_box_cover(py, h, min_dist) & existing_valid[:, None]).to(torch.float32)
    cols = _box_cover(px, w, min_dist).to(torch.float32)
    covered = (rows.T @ cols) > 0.5
    resp = torch.where(inb & ~covered, resp, neg_inf)

    # non-max suppression over the min_dist neighborhood (max pooling pads
    # with -inf; the square window is two 1-D passes)
    k = 2 * min_dist + 1
    dil = F.max_pool2d(resp[None, None], (1, k), stride=1, padding=(0, min_dist))
    dil = F.max_pool2d(dil, (k, 1), stride=1, padding=(min_dist, 0))[0, 0]
    peak = (resp == dil) & torch.isfinite(resp) & (resp > quality * torch.max(resp))
    score = torch.where(peak, resp, neg_inf).reshape(-1)
    top, idx = torch.sort(score, descending=True, stable=True)
    top, idx = top[:max_new], idx[:max_new]
    pts = torch.stack([(idx % w).to(img.dtype), (idx // w).to(img.dtype)], dim=-1)
    return pts, torch.isfinite(top)


def sample_depth(depth_img: Tensor, pts: Tensor) -> Tensor:
    """Nearest-neighbor depth lookup at feature pixels
    (``feature_tracker.cpp:360-366``)."""
    h, w = depth_img.shape
    x = torch.clamp(torch.round(pts[:, 0]).to(torch.int64), 0, w - 1)
    y = torch.clamp(torch.round(pts[:, 1]).to(torch.int64), 0, h - 1)
    return depth_img[y, x]
