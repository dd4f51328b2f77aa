"""Host-side feature tracker: id management around the device KLT kernels.

The counterpart of ``FeatureTracker::trackImage``
(``feature_tracker.cpp:103-372``) — owns feature ids, per-feature track
length, prediction seeding, refill and undistortion, and returns the
``{id: [x, y, z, u, v, vx, vy, depth]}``-style map the estimator ingests
(``feature_tracker.h:47-48``). All pixel math runs on the device in
:mod:`.klt`; this class only shuffles ids. Per frame it uploads the image(s)
and one packed table of points, and fetches three packed results: the
tracked points, the refill corners, and the undistorted points with depths.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from .. import resolve_device
from ..cameras.models import (
    CameraModel,
    PinholeParams,
    pinhole_lift_projective,
    pinhole_space_to_plane,
)
from ..pipeline import FrameFeature
from .klt import (
    build_pyramid,
    refill_corners,
    sample_depth,
    track_bidirectional,
)


class FeatureTracker:
    def __init__(self, cam, max_cnt: int = 128, min_dist: int = 30,
                 levels: int = 3, half: int = 10, iters: int = 10,
                 fb_thresh: float = 0.5, border: int = 5, device=None):
        """``cam``: a :class:`~..cameras.models.CameraModel` or a bare
        ``PinholeParams``. ``device=None`` means the GPU (raises without
        one); the camera's parameters are moved there."""
        self.device = resolve_device(device)
        if isinstance(cam, PinholeParams):
            cam = CameraModel("pinhole", cam, pinhole_lift_projective,
                              pinhole_space_to_plane)
        cam = cam._replace(params=type(cam.params)(*[p.to(self.device) for p in cam.params]))
        self.cam = cam
        # stereo baseline (m) for the rectified right-image depth path; 0
        # disables stereo (config camera.baseline)
        self.baseline = 0.0
        self.max_cnt = max_cnt
        self.min_dist = min_dist
        self.levels = levels
        self.half = half
        self.iters = iters
        self.fb_thresh = fb_thresh
        self.border = border
        self.prev_pyr = None
        self.prev_pts = np.zeros((0, 2), np.float32)
        self.prev_norm = np.zeros((0, 2), np.float32)
        self.ids = np.zeros((0,), np.int64)
        self.track_len = np.zeros((0,), np.int64)
        self.next_id = 0
        self.prev_t: Optional[float] = None
        self.predict_pts: dict[int, tuple[float, float]] = {}
        # fisheye lens mask (FISHEYE_MASK, parameters.cpp:95-106): 0 =
        # outside the lens circle; None = disabled
        self.fisheye_mask: Optional[np.ndarray] = None

    def set_fisheye_mask(self, mask: np.ndarray) -> None:
        """Install a lens mask (uint8, 0 = cull zone) — the reference loads
        config/fisheye_mask_752x480.jpg and seeds every refill mask from it
        (``feature_tracker.cpp setMask``); here it gates both the tracked
        survivors and the refill candidates."""
        self.fisheye_mask = np.asarray(mask)

    def set_prediction(self, pts_px: dict[int, tuple[float, float]]) -> None:
        """Seed the next LK solve with estimator-predicted pixel positions
        (``FeatureTracker::setPrediction`` / ``hasPrediction`` path,
        ``feature_tracker.cpp:118-133``)."""
        self.predict_pts = dict(pts_px)

    def _image(self, img) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(img, np.float32)).to(self.device)

    def _track_packed(self, prev_pyr, cur_pyr, pp: np.ndarray, seed: np.ndarray, n: int):
        """Bidirectional LK of ``n`` live features padded to ``max_cnt``: one
        packed upload [max_cnt,5] (prev xy, seed xy, valid) and one packed
        fetch [n,3] (forward xy, ok)."""
        table = np.zeros((self.max_cnt, 5), np.float32)
        table[:n, 0:2] = pp[:n]
        table[:n, 2:4] = seed[:n]
        table[:n, 4] = 1.0
        tab = torch.as_tensor(table).to(self.device)
        fwd, ok = track_bidirectional(
            prev_pyr, cur_pyr, tab[:, 0:2], tab[:, 2:4], tab[:, 4] > 0.5,
            self.levels, self.half, self.iters, self.fb_thresh,
        )
        out = torch.cat([fwd, ok.to(fwd.dtype)[:, None]], dim=1)[:n].cpu().numpy()
        return out[:, 0:2], out[:, 2] > 0.5

    def _stereo_depths(self, cur_pyr, img_right: np.ndarray) -> np.ndarray:
        """LK left→right disparity → metric depth per tracked feature
        (rectified pair; forward-backward gated; positive-disparity gate)."""
        n = len(self.prev_pts)
        pyr_r = build_pyramid(self._image(img_right), self.levels)
        fwd, ok = self._track_packed(cur_pyr, pyr_r, self.prev_pts, self.prev_pts, n)
        disp = self.prev_pts[:, 0] - fwd[:, 0]
        # same-row gate for a rectified pair + positive disparity
        ok = ok & (np.abs(fwd[:, 1] - self.prev_pts[:, 1]) < 2.0) & (disp > 0.5)
        fx = float(self.cam.params.fx)
        with np.errstate(divide="ignore"):
            z = fx * self.baseline / np.maximum(disp, 1e-6)
        return np.where(ok, z, 0.0).astype(np.float32)

    def track(self, t: float, img: np.ndarray, depth: Optional[np.ndarray] = None,
              boxes: Optional[np.ndarray] = None,
              img_right: Optional[np.ndarray] = None) -> dict[int, FrameFeature]:
        """Track into the new frame, refill, and emit the feature map.

        ``boxes`` ([N,4] xyxy px) are dynamic-object detections; features
        inside any box are culled (``trackImagebox``,
        ``feature_tracker.cpp:564-606``).

        ``img_right``: rectified second-camera image (STEREO ingest). Each
        feature is LK-matched left→right with the forward-backward check and
        its disparity becomes a metric depth (fx·baseline/d) through the SAME
        depth channel RGBD uses.
        """
        img_np = np.asarray(img, np.float32)
        img_d = self._image(img_np)
        cur_pyr = build_pyramid(img_d, self.levels)
        dt = (t - self.prev_t) if self.prev_t is not None else 0.0
        h, w = img_np.shape[:2]

        if self.prev_pyr is not None and len(self.prev_pts) > 0:
            n = len(self.prev_pts)
            # prediction-seeded LK (feature_tracker.cpp:118-133)
            seed = self.prev_pts.copy()
            for i, fid in enumerate(self.ids):
                p = self.predict_pts.get(int(fid))
                if p is not None and 0 <= p[0] < w and 0 <= p[1] < h:
                    seed[i] = p
            fwd, ok = self._track_packed(self.prev_pyr, cur_pyr, self.prev_pts, seed, n)
            # overexposure cull: drop features landing on saturated pixels
            # (grey > 250; feature_tracker.cpp:155-168)
            xi = np.clip(fwd[:, 0].astype(np.int32), 0, w - 1)
            yi = np.clip(fwd[:, 1].astype(np.int32), 0, h - 1)
            ok = ok & (img_np[yi, xi] <= 250.0)
            # fisheye lens-circle cull (FISHEYE_MASK, parameters.cpp:95-106)
            if self.fisheye_mask is not None:
                ok = ok & (self.fisheye_mask[yi, xi] > 0)
            # dynamic-object cull (trackImagebox, feature_tracker.cpp:564-606)
            if boxes is not None and len(boxes) > 0:
                inside = (
                    (fwd[:, 0:1] >= boxes[None, :, 0]) & (fwd[:, 0:1] <= boxes[None, :, 2])
                    & (fwd[:, 1:2] >= boxes[None, :, 1]) & (fwd[:, 1:2] <= boxes[None, :, 3])
                ).any(axis=1)
                ok = ok & ~inside
            # keep survivors, longest tracks first (feature_tracker.cpp:60-83)
            self.prev_pts = fwd[ok]
            self.ids = self.ids[ok]
            prev_norm_old = self.prev_norm[ok]
            self.track_len = self.track_len[ok] + 1
            order = np.argsort(-self.track_len, kind="stable")
            self.prev_pts = self.prev_pts[order]
            self.ids = self.ids[order]
            self.track_len = self.track_len[order]
            prev_norm_old = prev_norm_old[order]
        else:
            prev_norm_old = np.zeros((0, 2), np.float32)

        # refill up to max_cnt
        need = self.max_cnt - len(self.prev_pts)
        if need > 0:
            n = len(self.prev_pts)
            table = np.zeros((self.max_cnt, 3), np.float32)
            table[:n, 0:2] = self.prev_pts
            table[:n, 2] = 1.0
            tab = torch.as_tensor(table).to(self.device)
            new_pts, new_ok = refill_corners(
                img_d, tab[:, 0:2], tab[:, 2] > 0.5,
                self.max_cnt, self.min_dist, self.border,
            )
            packed = torch.cat([new_pts, new_ok.to(new_pts.dtype)[:, None]], dim=1).cpu().numpy()
            new_pts = packed[packed[:, 2] > 0.5, 0:2]
            if self.fisheye_mask is not None and len(new_pts):
                mx = np.clip(new_pts[:, 0].astype(np.int32), 0, w - 1)
                my = np.clip(new_pts[:, 1].astype(np.int32), 0, h - 1)
                new_pts = new_pts[self.fisheye_mask[my, mx] > 0]
            new_pts = new_pts[:need]
            k = len(new_pts)
            self.prev_pts = np.concatenate([self.prev_pts, new_pts])
            self.ids = np.concatenate(
                [self.ids, np.arange(self.next_id, self.next_id + k)]
            )
            self.track_len = np.concatenate([self.track_len, np.ones(k, np.int64)])
            prev_norm_old = np.concatenate(
                [prev_norm_old, np.full((k, 2), np.nan, np.float32)]
            )
            self.next_id += k

        # undistorted normalized points and RGBD depths: one packed fetch
        m = len(self.prev_pts)
        norm = np.zeros((0, 2), np.float32)
        depths = np.zeros(m, np.float32)
        if m > 0:
            pts_d = torch.as_tensor(self.prev_pts).to(self.device)
            rays = self.cam.lift_projective(pts_d)
            rays = rays / torch.clamp(torch.abs(rays[:, 2:3]), min=1e-9)
            cols = [rays[:, 0:2]]
            if depth is not None:
                cols.append(sample_depth(self._image(depth), pts_d)[:, None])
            packed = torch.cat(cols, dim=1).cpu().numpy()
            norm = packed[:, 0:2]
            if depth is not None:
                depths = packed[:, 2]
            elif img_right is not None and self.baseline > 0:
                depths = self._stereo_depths(cur_pyr, img_right)
        vel = np.zeros_like(norm)
        if dt > 0:
            with np.errstate(invalid="ignore"):
                v = (norm - prev_norm_old) / dt
            vel = np.where(np.isnan(v), 0.0, v)

        feats = {
            int(fid): FrameFeature(
                x=float(norm[i, 0]), y=float(norm[i, 1]),
                vx=float(vel[i, 0]), vy=float(vel[i, 1]),
                depth=float(depths[i]),
            )
            for i, fid in enumerate(self.ids)
        }
        self.prev_pyr = cur_pyr
        self.prev_norm = norm
        self.prev_t = t
        self.predict_pts = {}
        return feats
