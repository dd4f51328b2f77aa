"""FAST corner detection + BRIEF binary descriptors, batched on device.

The keyframe descriptor path (``dense_map/src/keyframe.cpp:160-186``
computeBRIEFPoint: cv::FAST threshold 20 + DVision BRIEF;
``ThirdParty/DVision/BRIEF.cpp``): FAST's 16-point circle test is a stack of
rolled comparisons over the whole image, and the 256 BRIEF pairwise intensity
tests are one gather + compare per keypoint batch, packed into 8 words so
that Hamming distance is XOR + popcount.

Packed descriptors are ``torch.int32 [K, 8]`` tensors holding the uint32 bit
pattern of each word (numpy ``uint32.view(np.int32)``). :func:`match_brief`
is ``ops/cuda/hamming.py::hamming_match``: one launch of the fused masked
match kernel for CUDA tensors, and for CPU tensors the plain version beside
it, ``match_brief_reference`` (the SWAR distance matrix, mask, ``argmin``,
``gather``).

The test-pair pattern is generated from a fixed RNG seed (the reference ships
a learned .yml pattern; any fixed pattern works as long as both frames use the
same one — documented divergence)."""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F
from torch import Tensor

# the kernels' wrappers; the distance matrix under the JAX package's name
# ``brief.hamming_matrix``
from ..ops.cuda.hamming import hamming_match, hamming_matrix

# 16-point Bresenham circle of radius 3 (cv::FAST)
_CIRCLE = np.array(
    [(0, -3), (1, -3), (2, -2), (3, -1), (3, 0), (3, 1), (2, 2), (1, 3),
     (0, 3), (-1, 3), (-2, 2), (-3, 1), (-3, 0), (-3, -1), (-2, -2), (-1, -3)],
    np.int32,
)


def fast_score(img: Tensor, threshold: float = 20.0, arc: int = 9) -> Tensor:
    """FAST-N corner response: a pixel is a corner if ≥ ``arc`` contiguous
    circle pixels are all brighter (or all darker) than center ± threshold.
    Returns a response map (sum of absolute differences over the circle, 0
    where not a corner)."""
    h, w = img.shape
    rolled = torch.stack(
        [torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1)) for dx, dy in _CIRCLE]
    )                                                       # [16, H, W]
    brighter = rolled > img[None] + threshold
    darker = rolled < img[None] - threshold

    def arc_ok(mask):
        # contiguous run of length >= arc on the 16-cycle: AND of `arc`
        # consecutive rotations, OR over start offsets
        runs = mask
        for k in range(1, arc):
            runs = runs & torch.roll(mask, -k, dims=0)
        return runs.any(dim=0)

    is_corner = arc_ok(brighter) | arc_ok(darker)
    sad = torch.sum(torch.abs(rolled - img[None]), dim=0)
    resp = torch.where(is_corner, sad, torch.zeros_like(sad))
    # clear the 3px border (circle would wrap)
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    edge = (ys < 3) | (ys >= h - 3) | (xs < 3) | (xs >= w - 3)
    return torch.where(edge, torch.zeros_like(resp), resp)


def fast_detect(img: Tensor, threshold: float = 20.0, max_kp: int = 500, nms: int = 3):
    """FAST keypoints with local non-max suppression → top-``max_kp``.
    Returns (pts [K,2] xy, ok [K]). Among equal scores the lower pixel index
    comes first, as ``jax.lax.top_k`` orders them (a stable descending sort;
    ``torch.topk`` promises no order among ties)."""
    resp = fast_score(img, threshold)
    # max over a (2·nms+1)² window, -inf beyond the border ("SAME" reduce_window)
    dil = F.max_pool2d(resp[None, None], 2 * nms + 1, stride=1, padding=nms)[0, 0]
    peak = (resp == dil) & (resp > 0)
    h, w = img.shape
    score = torch.where(peak, resp, torch.full_like(resp, -torch.inf)).reshape(-1)
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:max_kp], idx[:max_kp]
    pts = torch.stack([(idx % w).to(img.dtype), (idx // w).to(img.dtype)], -1)
    return pts, torch.isfinite(vals) & (vals > 0)


def brief_pattern(n_bits: int = 256, patch: int = 24, seed: int = 7):
    """Fixed Gaussian test-pair pattern (DVision BRIEF uses a learned pattern
    loaded from brief_pattern.yml; a fixed random pattern is functionally
    equivalent for matching within this system)."""
    rng = np.random.default_rng(seed)
    sigma = patch / 5.0
    a = np.clip(rng.normal(0, sigma, (n_bits, 2)), -patch // 2, patch // 2)
    b = np.clip(rng.normal(0, sigma, (n_bits, 2)), -patch // 2, patch // 2)
    return a.astype(np.float32), b.astype(np.float32)


def brief_samples(img: Tensor, pts: Tensor, pat_a: Tensor, pat_b: Tensor):
    """The two smoothed intensities of every test pair: ``(I(p+a), I(p+b))``,
    each ``[K, 256]``, nearest-pixel on a 3x3 box-blurred image.

    The blur is ``avg_pool2d`` with zero padding counted, which equals the
    zero-padded "SAME" box convolution of the JAX package (a cuDNN
    convolution would run in TF32)."""
    sm = F.avg_pool2d(img[None, None], 3, stride=1, padding=1, count_include_pad=True)[0, 0]
    h, w = img.shape

    def sample(offs):
        x = torch.clamp(torch.round(pts[:, None, 0] + offs[None, :, 0]).to(torch.int64), 0, w - 1)
        y = torch.clamp(torch.round(pts[:, None, 1] + offs[None, :, 1]).to(torch.int64), 0, h - 1)
        return sm[y, x]                                     # [K, 256]

    return sample(pat_a), sample(pat_b)


def pack_bits(bits: Tensor) -> Tensor:
    """``[K, 256]`` bool → ``[K, 8]`` int32 words (bit j of word w is test
    32·w + j), each word the int32 bit pattern of its uint32 value."""
    words = bits.to(torch.int64).reshape(bits.shape[0], 8, 32)
    shifts = torch.arange(32, device=bits.device)
    u = torch.sum(words << shifts, dim=-1)                  # [K, 8] in [0, 2^32)
    # wrap to the int32 bit pattern explicitly (no reliance on cast overflow)
    return torch.where(u >= 2**31, u - 2**32, u).to(torch.int32)


def brief_describe(img: Tensor, pts: Tensor, pat_a: Tensor, pat_b: Tensor) -> Tensor:
    """256-bit BRIEF descriptors packed as ``[K, 8]`` int32 words.

    Smoothed intensity comparisons I(p+a) < I(p+b) per test pair (BRIEF.cpp
    operator())."""
    ia, ib = brief_samples(img, pts, pat_a, pat_b)
    return pack_bits(ia < ib)


def match_brief(desc_cur: Tensor, ok_cur: Tensor, desc_old: Tensor, ok_old: Tensor,
                thresh: int = 80):
    """Best-match search with Hamming gate (keyframe.cpp:194-244
    searchInAera/searchByBRIEFDes): for every current descriptor, the nearest
    old descriptor if dist < ``thresh``. Returns (idx [Kc], matched [Kc]);
    among equal distances the first old index wins, as ``jnp.argmin`` does.
    One kernel launch for CUDA tensors; ``match_brief_reference`` of
    ``ops/cuda/hamming.py`` for CPU tensors."""
    return hamming_match(desc_cur, ok_cur, desc_old, ok_old, thresh)
