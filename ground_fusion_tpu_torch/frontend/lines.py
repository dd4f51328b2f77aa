"""Line features: geometry (Plücker/orthonormal), projection factor, tracking.

The line stack of the reference (``utility/line_geometry.{h,cpp}`` Plücker ↔
orthonormal; ``factor/line_projection_factor.cpp:18-52`` point-to-line
residual of the projected line against the observed segment endpoints;
``linefeatureTracker/`` LSD + LBD):

- geometry and factor: batched tensor forms of the reference formulas, with
  Jacobians by forward-mode AD against the 4-dim orthonormal tangent (the
  reference's ``LineOrthParameterization``);
- detection: a tile-PCA segment detector in place of the custom LSD —
  structure-tensor anisotropy per 16×16 tile, the dominant eigenvector's
  normal as the line direction, the magnitude-weighted centroid of the
  strong pixels as its midpoint. Branch-free tensor math on the device;
- description and matching: a simplified LBD (gradient statistics in
  parallel bands along the segment), matched by descriptor distance with
  angle and midpoint gates (``linefeature_tracker.cpp:77-135``).

Nothing here launches a hand-written kernel: every function is plain tensor
math on the device its inputs live on. Ranking follows a stable descending
sort, so tied strengths go to the lowest tile index (as ``lax.top_k`` does),
and every ``argmin`` returns the first minimal index.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor
from torch.func import jacfwd

from .. import resolve_device
from ..geometry.se3 import pose_apply, pose_boxplus
from ..geometry.so3 import _cross, quat_to_mat


# ---------------------------------------------------------------------------
# Plücker / orthonormal conversions (line_geometry.cpp:56-110)
# ---------------------------------------------------------------------------


def plk_to_orth(plk: Tensor) -> Tensor:
    n, v = plk[..., 0:3], plk[..., 3:6]
    nn = torch.linalg.norm(n, dim=-1, keepdim=True)
    nv = torch.linalg.norm(v, dim=-1, keepdim=True)
    u1 = n / torch.clamp(nn, min=1e-12)
    u2 = v / torch.clamp(nv, min=1e-12)
    u3 = _cross(u1, u2)
    t0 = torch.atan2(u2[..., 2], u3[..., 2])
    t1 = torch.asin(torch.clamp(-u1[..., 2], -1.0, 1.0))
    t2 = torch.atan2(u1[..., 1], u1[..., 0])
    w = torch.cat([nn, nv], dim=-1)
    w = w / torch.linalg.norm(w, dim=-1, keepdim=True)
    phi = torch.asin(torch.clamp(w[..., 1], -1.0, 1.0))
    return torch.stack([t0, t1, t2, phi], dim=-1)


def orth_to_plk(orth: Tensor) -> Tensor:
    s1, c1 = torch.sin(orth[..., 0]), torch.cos(orth[..., 0])
    s2, c2 = torch.sin(orth[..., 1]), torch.cos(orth[..., 1])
    s3, c3 = torch.sin(orth[..., 2]), torch.cos(orth[..., 2])
    u1 = torch.stack([c2 * c3, c2 * s3, -s2], dim=-1)
    u2 = torch.stack([s1 * s2 * c3 - c1 * s3, s1 * s2 * s3 + c1 * c3, s1 * c2], dim=-1)
    w1 = torch.cos(orth[..., 3])[..., None]
    w2 = torch.sin(orth[..., 3])[..., None]
    return torch.cat([w1 * u1, w2 * u2], dim=-1)


def plk_transform(plk_w: Tensor, q_cw: Tensor, t_cw: Tensor) -> Tensor:
    """World Plücker → the frame of the pose (R, t) = (``q_cw``, ``t_cw``),
    world_T_frame (``plk_from_pose``): n = Rᵀ n_w − [Rᵀ t]ₓ Rᵀ v_w,
    v = Rᵀ v_w."""
    R = quat_to_mat(q_cw)
    n_w, v_w = plk_w[..., 0:3], plk_w[..., 3:6]
    Rt = R.transpose(-1, -2)
    n = torch.einsum("...ij,...j->...i", Rt, n_w)
    v = torch.einsum("...ij,...j->...i", Rt, v_w)
    t_in = torch.einsum("...ij,...j->...i", Rt, t_cw)
    n = n - _cross(t_in, v)
    return torch.cat([n, v], dim=-1)


def line_residual_raw(pose_i, ex, orth, obs4):
    """``lineProjectionFactor::Evaluate`` (:18-52): world orthonormal line →
    body → camera; the signed distances of both observed endpoints to the
    projected infinite line, normalized."""
    plk_w = orth_to_plk(orth)
    line_b = plk_transform(plk_w, pose_i[..., 3:7], pose_i[..., 0:3])
    line_c = plk_transform(line_b, ex[..., 3:7], ex[..., 0:3])
    nc = line_c[..., 0:3]
    l_norm = torch.sqrt(torch.clamp(nc[..., 0] ** 2 + nc[..., 1] ** 2, min=1e-12))
    e1 = obs4[..., 0] * nc[..., 0] + obs4[..., 1] * nc[..., 1] + nc[..., 2]
    e2 = obs4[..., 2] * nc[..., 0] + obs4[..., 3] * nc[..., 1] + nc[..., 2]
    return torch.stack([e1, e2], dim=-1) / l_norm[..., None]


def line_factor(pose_i, ex, orth, obs4, sqrt_info_scale):
    """Whitened residual and Jacobian against [δpose(6), δex(6), δorth(4)]
    → (r [2], J [2,16])."""

    def r_of(d):
        return sqrt_info_scale * line_residual_raw(
            pose_boxplus(pose_i, d[0:6]), pose_boxplus(ex, d[6:12]), orth + d[12:16], obs4)

    z = torch.zeros(16, dtype=pose_i.dtype, device=pose_i.device)
    return r_of(z), jacfwd(r_of)(z)


def _plane_through_camera(obs4: Tensor, cam: Tensor) -> Tensor:
    """Plane [n, d] through the camera centre and both endpoint rays of a
    normalized-plane observation, in the world frame."""
    one = torch.ones_like(obs4[..., 0:1])
    p1 = pose_apply(cam, torch.cat([obs4[..., 0:2], one], dim=-1))
    p2 = pose_apply(cam, torch.cat([obs4[..., 2:4], one], dim=-1))
    c = cam[..., 0:3]
    nrm = _cross(p1 - c, p2 - c)
    d = -torch.sum(nrm * c, dim=-1, keepdim=True)
    return torch.cat([nrm, d], dim=-1)


def planes_to_plk(pi1: Tensor, pi2: Tensor) -> Tensor:
    """Plücker line of two planes from the dual matrix L* = π1 π2ᵀ − π2 π1ᵀ:
    the moment n is its top-right column, the direction v its
    skew-symmetric 3×3 part (``pipi_plk``, line_geometry.cpp)."""
    M = pi1[..., :, None] * pi2[..., None, :] - pi2[..., :, None] * pi1[..., None, :]
    n = M[..., 0:3, 3]
    v = torch.stack([M[..., 2, 1], M[..., 0, 2], M[..., 1, 0]], dim=-1)
    return torch.cat([n, v], dim=-1)


def triangulate_line(obs_i4, obs_j4, cam_i_pose, cam_j_pose):
    """Two-view line triangulation: plane(cam_i, endpoints_i) ∩
    plane(cam_j, endpoints_j) → world Plücker (``pipi_plk``)."""
    return planes_to_plk(_plane_through_camera(obs_i4, cam_i_pose),
                         _plane_through_camera(obs_j4, cam_j_pose))


# ---------------------------------------------------------------------------
# Tile-PCA segment detection + banded descriptor
# ---------------------------------------------------------------------------


def _gradients(img: Tensor):
    """Central differences, zero on the border rows/columns."""
    gx = torch.zeros_like(img)
    gy = torch.zeros_like(img)
    gx[:, 1:-1] = 0.5 * (img[:, 2:] - img[:, :-2])
    gy[1:-1, :] = 0.5 * (img[2:, :] - img[:-2, :])
    return gx, gy


def detect_segments(img: Tensor, tile: int = 16, max_lines: int = 64,
                    aniso_thresh: float = 0.75, mag_thresh: float = 8.0):
    """Line segments from per-tile structure-tensor PCA. Returns endpoints
    [max_lines, 4] (x1, y1, x2, y2) in pixels, strengths [max_lines] and
    valid [max_lines], strongest first; equal strengths keep tile order."""
    h, w = img.shape
    gx, gy = _gradients(img)
    mag = torch.sqrt(gx * gx + gy * gy)
    strong = mag > mag_thresh

    th, tw = h // tile, w // tile

    def tile_stats(a):
        return a[: th * tile, : tw * tile].reshape(th, tile, tw, tile).permute(0, 2, 1, 3)

    GX, GY, M, S = map(tile_stats, (gx, gy, mag, strong.to(img.dtype)))
    # structure tensor per tile over the strong pixels
    w11 = torch.sum(GX * GX * S, dim=(2, 3))
    w12 = torch.sum(GX * GY * S, dim=(2, 3))
    w22 = torch.sum(GY * GY * S, dim=(2, 3))
    cnt = torch.sum(S, dim=(2, 3))
    tr = w11 + w22
    det = w11 * w22 - w12 * w12
    disc = torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0))
    lam1 = 0.5 * (tr + disc)
    lam2 = 0.5 * (tr - disc)
    aniso = (lam1 - lam2) / torch.clamp(lam1 + lam2, min=1e-9)
    good = (aniso > aniso_thresh) & (cnt > tile)

    # gradient direction = the dominant eigenvector; the LINE runs normal to
    # it. Two algebraically equivalent eigenvector forms, each degenerate for
    # a different edge orientation: take the better-conditioned one per tile
    exa, eya = w12, lam1 - w11
    exb, eyb = lam1 - w22, w12
    use_a = exa * exa + eya * eya >= exb * exb + eyb * eyb
    ex_ = torch.where(use_a, exa, exb)
    ey_ = torch.where(use_a, eya, eyb)
    nrm = torch.sqrt(torch.clamp(ex_ * ex_ + ey_ * ey_, min=1e-12))
    ldir_x, ldir_y = -ey_ / nrm, ex_ / nrm

    # magnitude-weighted centroid of the strong pixels per tile
    ys = torch.arange(tile, dtype=img.dtype, device=img.device)
    msum = torch.clamp(torch.sum(M * S, dim=(2, 3)), min=1e-9)
    cx_loc = torch.sum(M * S * ys[None, None, None, :], dim=(2, 3)) / msum
    cy_loc = torch.sum(M * S * ys[None, None, :, None], dim=(2, 3)) / msum
    cx = cx_loc + (torch.arange(tw, device=img.device) * tile)[None, :]
    cy = cy_loc + (torch.arange(th, device=img.device) * tile)[:, None]

    half = tile * 0.5
    seg = torch.stack([cx - ldir_x * half, cy - ldir_y * half,
                       cx + ldir_x * half, cy + ldir_y * half], dim=-1).reshape(-1, 4)
    strength = torch.where(good, lam1, torch.zeros_like(lam1)).reshape(-1)
    top, order = torch.sort(strength, descending=True, stable=True)
    top, order = top[:max_lines], order[:max_lines]
    return seg[order], top, top > 0


def lbd_describe(img: Tensor, segs: Tensor, n_samples: int = 16, n_bands: int = 5) -> Tensor:
    """Simplified LBD: means and population standard deviations of the
    gradient along and across each segment in ``n_bands`` parallel bands
    → [L, 4·n_bands], unit norm (``binary_descriptor_custom``'s statistics
    layer). Sample points round half to even and clamp to the image."""
    h, w = img.shape
    gx, gy = _gradients(img)
    p1, p2 = segs[:, 0:2], segs[:, 2:4]
    d = p2 - p1
    ln = torch.clamp(torch.linalg.norm(d, dim=-1, keepdim=True), min=1e-6)
    ud = d / ln
    un = torch.stack([-ud[:, 1], ud[:, 0]], dim=-1)
    ts = torch.linspace(0.0, 1.0, n_samples, dtype=img.dtype, device=img.device)
    offs = torch.arange(n_bands, dtype=img.dtype, device=img.device) - (n_bands - 1) / 2.0
    pts = (p1[:, None, None, :] + ts[None, :, None, None] * d[:, None, None, :]
           + offs[None, None, :, None] * 2.0 * un[:, None, None, :])     # [L, S, B, 2]
    xi = torch.clamp(torch.round(pts[..., 0]).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(pts[..., 1]).to(torch.int64), 0, h - 1)
    gxs, gys = gx[yi, xi], gy[yi, xi]
    gpar = gxs * ud[:, None, None, 0] + gys * ud[:, None, None, 1]      # [L, S, B]
    gperp = gxs * un[:, None, None, 0] + gys * un[:, None, None, 1]
    feats = torch.cat([gpar.mean(1), gpar.std(1, correction=0),
                       gperp.mean(1), gperp.std(1, correction=0)], dim=-1)
    return feats / torch.clamp(torch.linalg.norm(feats, dim=-1, keepdim=True), min=1e-9)


def match_lines(desc_a, segs_a, ok_a, desc_b, segs_b, ok_b, desc_thresh: float = 0.35,
                angle_thresh: float = 0.2, max_midpoint_dist: float = 60.0):
    """Nearest neighbour by descriptor with angle and midpoint-distance
    gates (``linefeature_tracker.cpp:77-135``). The midpoint distance joins
    the cost at 1e-3 so equal descriptors go to the nearest candidate; a
    remaining tie goes to the first index. Returns (idx [La], matched [La])."""
    d = torch.linalg.norm(desc_a[:, None, :] - desc_b[None, :, :], dim=-1)

    def ang(s):
        return torch.atan2(s[..., 3] - s[..., 1], s[..., 2] - s[..., 0])

    def mid(s):
        return 0.5 * torch.stack([s[..., 0] + s[..., 2], s[..., 1] + s[..., 3]], dim=-1)

    da = ang(segs_a)[:, None] - ang(segs_b)[None, :]
    da = torch.abs(torch.atan2(torch.sin(da), torch.cos(da)))
    da = torch.minimum(da, np.pi - da)                 # direction-agnostic
    dm = torch.linalg.norm(mid(segs_a)[:, None, :] - mid(segs_b)[None, :, :], dim=-1)
    cost = d + 1e-3 * dm
    gate = ok_b[None, :] & (da < angle_thresh) & (dm < max_midpoint_dist)
    cost = torch.where(gate, cost, torch.full_like(cost, 1e9))
    idx = torch.argmin(cost, dim=1)
    best_desc = torch.gather(d, 1, idx[:, None])[:, 0]
    picked = torch.gather(cost, 1, idx[:, None])[:, 0] < 1e8
    return idx, ok_a & picked & (best_desc < desc_thresh)


class LineTracker:
    """Frame-to-frame line tracking with persistent ids — the
    ``LineFeatureTracker::readImage`` role (linefeature_tracker.cpp:77-135):
    detect segments, describe, match against the previous frame; matched
    segments keep their id, new ones get fresh ids. Returns id →
    normalized-plane endpoints [x1, y1, x2, y2] (the ``lineobs`` payload).

    Detection, description and matching run on ``device`` (``None`` means
    the GPU) in ``dtype``; each frame uploads the image once and fetches one
    packed table (segments, validity, match index and flag)."""

    def __init__(self, fx: float, fy: float, cx: float, cy: float,
                 max_lines: int = 64, min_len_px: float = 60.0,
                 dtype=torch.float32, device=None):
        self.K = (fx, fy, cx, cy)
        self.max_lines = max_lines
        self.min_len_px = min_len_px
        self.dtype = dtype
        self.device = resolve_device(device)
        self.prev = None            # (segs, desc, ok) on the device, ids on the host
        self.prev_ids = None
        self._next_id = 0

    def _normalize(self, seg: np.ndarray) -> np.ndarray:
        fx, fy, cx, cy = self.K
        return np.array([(seg[0] - cx) / fx, (seg[1] - cy) / fy,
                         (seg[2] - cx) / fx, (seg[3] - cy) / fy], np.float64)

    def track(self, img: np.ndarray) -> dict:
        im = torch.as_tensor(np.asarray(img)).to(device=self.device, dtype=self.dtype)
        segs, _, ok = detect_segments(im, max_lines=self.max_lines)
        desc = lbd_describe(im, segs)
        seg_len = torch.hypot(segs[:, 2] - segs[:, 0], segs[:, 3] - segs[:, 1])
        ok = ok & (seg_len >= self.min_len_px * 0.25)     # tile-limited lengths
        cols = [segs, ok.to(self.dtype)[:, None]]
        if self.prev is not None:
            idx, matched = match_lines(desc, segs, ok, *self.prev)
            cols += [idx.to(self.dtype)[:, None], matched.to(self.dtype)[:, None]]
        host = torch.cat(cols, dim=1).cpu().numpy()         # one fetch
        segs_np = host[:, 0:4].astype(np.float64)
        ok_np = host[:, 4] > 0.5

        ids = np.full(len(segs_np), -1, np.int64)
        if self.prev is not None:
            idx = np.rint(host[:, 5]).astype(np.int64)
            matched = host[:, 6] > 0.5
            used = set()
            for i in np.nonzero(matched & ok_np)[0]:
                j = int(idx[i])
                if j in used:
                    continue
                used.add(j)
                ids[i] = self.prev_ids[j]
        for i in np.nonzero(ok_np & (ids < 0))[0]:
            ids[i] = self._next_id
            self._next_id += 1
        self.prev = (desc, segs, ok)
        self.prev_ids = ids
        return {int(ids[i]): self._normalize(segs_np[i]) for i in np.nonzero(ok_np)[0]}
