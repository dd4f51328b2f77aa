"""Camera projection models (camodocal-equivalent surface, batched tensors).

The reference's ``camera_models`` package (``include/camodocal/camera_models/
Camera.h:78-82``) exposes two primitives per model: ``liftProjective`` (pixel ->
normalized ray) and ``spaceToPlane`` (3-D point -> pixel). This port carries
the pinhole model with radial-tangential distortion; the other four families
of the JAX package (PinholeFull, Mei/Cata, Equidistant, Scaramuzza) are not
ported yet and :func:`make_camera` says so by name.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

_NOT_PORTED = {
    "pinhole_full": "pinhole_full", "pinholefull": "pinhole_full",
    "mei": "mei", "cata": "mei", "catadioptric": "mei",
    "equidistant": "equidistant", "kannala_brandt": "equidistant", "fisheye": "equidistant",
    "scaramuzza": "scaramuzza", "ocam": "scaramuzza",
}


class PinholeParams(NamedTuple):
    """fx, fy, cx, cy + radial-tangential distortion (k1, k2, p1, p2)."""

    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor
    k1: Tensor
    k2: Tensor
    p1: Tensor
    p2: Tensor

    @staticmethod
    def make(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, dtype=torch.float32,
             device=None):
        return PinholeParams(*[torch.tensor(float(v), dtype=dtype, device=device)
                               for v in (fx, fy, cx, cy, k1, k2, p1, p2)])


def _radtan_distort(cam: PinholeParams, xy: Tensor) -> Tensor:
    """Apply radial-tangential distortion delta to normalized coords
    (PinholeCamera::distortion, camera_models/src/PinholeCamera.cc)."""
    x, y = xy[..., 0], xy[..., 1]
    x2, y2, xy2 = x * x, y * y, x * y
    r2 = x2 + y2
    rad = cam.k1 * r2 + cam.k2 * r2 * r2
    dx = x * rad + 2.0 * cam.p1 * xy2 + cam.p2 * (r2 + 2.0 * x2)
    dy = y * rad + 2.0 * cam.p2 * xy2 + cam.p1 * (r2 + 2.0 * y2)
    return torch.stack([dx, dy], dim=-1)


def pinhole_space_to_plane(cam: PinholeParams, pts: Tensor) -> Tensor:
    """3-D point in camera frame -> pixel (spaceToPlane)."""
    xy = pts[..., 0:2] / pts[..., 2:3]
    xy_d = xy + _radtan_distort(cam, xy)
    u = cam.fx * xy_d[..., 0] + cam.cx
    v = cam.fy * xy_d[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def pinhole_lift_projective(cam: PinholeParams, uv: Tensor, iters: int = 8) -> Tensor:
    """Pixel -> normalized ray [x, y, 1] by fixed-point undistortion
    (PinholeCamera::liftProjective recursive-distortion path)."""
    mx_d = (uv[..., 0] - cam.cx) / cam.fx
    my_d = (uv[..., 1] - cam.cy) / cam.fy
    d = torch.stack([mx_d, my_d], dim=-1)
    u = d
    for _ in range(iters):
        u = d - _radtan_distort(cam, u)
    return torch.cat([u, torch.ones_like(u[..., 0:1])], dim=-1)


# ---------------------------------------------------------------------------
# Factory (CameraFactory.cc:32-93 analog)
# ---------------------------------------------------------------------------


class CameraModel(NamedTuple):
    """A dispatched camera: parameter tuple + the two camodocal primitives
    (``liftProjective`` / ``spaceToPlane``) bound for it. Built by
    :func:`make_camera` from the config's model string, the analog of
    ``camodocal::CameraFactory::generateCamera`` (CameraFactory.cc:32-93)."""

    name: str
    params: NamedTuple
    lift: object       # (params, uv [...,2]) -> ray [...,3]
    project: object    # (params, pts [...,3]) -> uv [...,2]

    def lift_projective(self, uv):
        return self.lift(self.params, uv)

    def space_to_plane(self, pts):
        return self.project(self.params, pts)


def make_camera(model: str, fx: float, fy: float, cx: float, cy: float,
                distortion=(), dtype=torch.float32, device=None) -> CameraModel:
    """Build the camera selected by ``cfg.camera.model``.

    Distortion-tuple layout: ``pinhole`` takes k1, k2, p1, p2. The parameter
    tensors are created on ``device`` (``None`` = PyTorch's default device;
    the system passes its own)."""
    m = model.lower().replace("-", "_")
    d = tuple(float(v) for v in distortion)

    if m in ("pinhole", "radtan"):
        k = (d + (0.0,) * 4)[:4]
        params = PinholeParams.make(fx, fy, cx, cy, *k, dtype=dtype, device=device)
        return CameraModel("pinhole", params, pinhole_lift_projective,
                           pinhole_space_to_plane)
    if m in _NOT_PORTED:
        raise NotImplementedError(
            f"camera model {_NOT_PORTED[m]!r} is not ported to ground_fusion_tpu_torch "
            "yet (ROADMAP.md, queue 1: other camera models)")
    raise ValueError(f"unknown camera model {model!r}")
