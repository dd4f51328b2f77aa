"""Camera projection models (camodocal-equivalent surface, batched tensors).

The reference's ``camera_models`` package (``include/camodocal/camera_models/
Camera.h:78-82``) exposes two primitives per model: ``liftProjective`` (pixel ->
normalized ray) and ``spaceToPlane`` (3-D point -> pixel). We reproduce that
surface for the model families Ground-Fusion ships (Pinhole w/ radial-tangential
distortion, PinholeFull, Mei/Cata, Equidistant/fisheye, Scaramuzza) as plain
functions over parameter tuples of tensors, batched over the leading axes of
the points. The fixed-point and Newton loops run a fixed number of iterations
with no host read, so they stay on the device and under ``torch.func``
transforms (calibration differentiates the projections).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor


def _scalars(values, dtype, device):
    return [torch.tensor(float(v), dtype=dtype, device=device) for v in values]


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
        return PinholeParams(*_scalars((fx, fy, cx, cy, k1, k2, p1, p2), dtype, device))


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


class EquidistantParams(NamedTuple):
    """Kannala-Brandt / equidistant fisheye: fx(mu), fy(mv), cx(u0), cy(v0), k2..k5."""

    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor
    k2: Tensor
    k3: Tensor
    k4: Tensor
    k5: Tensor

    @staticmethod
    def make(fx, fy, cx, cy, k2=0.0, k3=0.0, k4=0.0, k5=0.0, dtype=torch.float32,
             device=None):
        return EquidistantParams(*_scalars((fx, fy, cx, cy, k2, k3, k4, k5), dtype, device))


def _equi_theta_poly(cam: EquidistantParams, theta: Tensor) -> Tensor:
    t2 = theta * theta
    return theta * (1.0 + t2 * (cam.k2 + t2 * (cam.k3 + t2 * (cam.k4 + t2 * cam.k5))))


def equidistant_space_to_plane(cam: EquidistantParams, pts: Tensor) -> Tensor:
    """(EquidistantCamera::spaceToPlane, camera_models/src/EquidistantCamera.cc)."""
    r = torch.linalg.norm(pts[..., 0:2], dim=-1)
    theta = torch.atan2(r, pts[..., 2])
    d = _equi_theta_poly(cam, theta)
    scale = d / torch.clamp(r, min=1e-12)
    u = cam.fx * scale * pts[..., 0] + cam.cx
    v = cam.fy * scale * pts[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def equidistant_lift_projective(cam: EquidistantParams, uv: Tensor, iters: int = 10) -> Tensor:
    """Invert the theta-polynomial with Newton iterations (the reference uses a
    companion-matrix root solve; Newton from theta=d is equivalent here)."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    d = torch.sqrt(mx * mx + my * my)
    theta = d
    for _ in range(iters):
        f = _equi_theta_poly(cam, theta) - d
        t2 = theta * theta
        fp = 1.0 + t2 * (3.0 * cam.k2 + t2 * (5.0 * cam.k3 + t2 * (7.0 * cam.k4 + t2 * 9.0 * cam.k5)))
        theta = theta - f / torch.clamp(fp, min=1e-12)
    scale = torch.tan(theta) / torch.clamp(d, min=1e-12)
    return torch.stack([mx * scale, my * scale, torch.ones_like(mx)], dim=-1)


class MeiParams(NamedTuple):
    """Mei (catadioptric) model: xi + radtan + projective (CataCamera.cc)."""

    xi: Tensor
    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor
    k1: Tensor
    k2: Tensor
    p1: Tensor
    p2: Tensor

    @staticmethod
    def make(xi, fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, dtype=torch.float32,
             device=None):
        return MeiParams(*_scalars((xi, fx, fy, cx, cy, k1, k2, p1, p2), dtype, device))


def _mei_pinhole(cam: MeiParams) -> PinholeParams:
    return PinholeParams(cam.fx, cam.fy, cam.cx, cam.cy, cam.k1, cam.k2, cam.p1, cam.p2)


def mei_space_to_plane(cam: MeiParams, pts: Tensor) -> Tensor:
    z = pts[..., 2] + cam.xi * torch.linalg.norm(pts, dim=-1)
    xy = pts[..., 0:2] / z[..., None]
    xy_d = xy + _radtan_distort(_mei_pinhole(cam), xy)
    u = cam.fx * xy_d[..., 0] + cam.cx
    v = cam.fy * xy_d[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def mei_lift_projective(cam: MeiParams, uv: Tensor, iters: int = 8) -> Tensor:
    ph = _mei_pinhole(cam)
    mx_d = (uv[..., 0] - cam.cx) / cam.fx
    my_d = (uv[..., 1] - cam.cy) / cam.fy
    d = torch.stack([mx_d, my_d], dim=-1)
    m = d
    for _ in range(iters):
        m = d - _radtan_distort(ph, m)
    r2 = torch.sum(m * m, dim=-1)
    # unproject from the unit sphere (CataCamera::liftProjective)
    xi = cam.xi
    disc = torch.clamp(1.0 + (1.0 - xi * xi) * r2, min=0.0)
    zs = (xi + torch.sqrt(disc)) / (1.0 + r2)
    z = zs - xi
    xy = m * (zs / torch.clamp(z, min=1e-12))[..., None]
    return torch.cat([xy, torch.ones_like(xy[..., 0:1])], dim=-1)


class PinholeFullParams(NamedTuple):
    """PinholeFull: rational-polynomial distortion k1..k6 + tangential p1,p2
    (camera_models/src/PinholeFullCamera.cc)."""

    fx: Tensor
    fy: Tensor
    cx: Tensor
    cy: Tensor
    k1: Tensor
    k2: Tensor
    k3: Tensor
    k4: Tensor
    k5: Tensor
    k6: Tensor
    p1: Tensor
    p2: Tensor

    @staticmethod
    def make(fx, fy, cx, cy, k1=0.0, k2=0.0, k3=0.0, k4=0.0, k5=0.0, k6=0.0,
             p1=0.0, p2=0.0, dtype=torch.float32, device=None):
        return PinholeFullParams(*_scalars(
            (fx, fy, cx, cy, k1, k2, k3, k4, k5, k6, p1, p2), dtype, device))


def _rational_distort(cam: PinholeFullParams, xy: Tensor) -> Tensor:
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    num = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    den = 1.0 + r2 * (cam.k4 + r2 * (cam.k5 + r2 * cam.k6))
    s = num / torch.clamp(den, min=1e-12)
    xd = x * s + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * s + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def pinhole_full_space_to_plane(cam: PinholeFullParams, pts: Tensor) -> Tensor:
    xy = pts[..., 0:2] / pts[..., 2:3]
    d = _rational_distort(cam, xy)
    u = cam.fx * d[..., 0] + cam.cx
    v = cam.fy * d[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def pinhole_full_lift_projective(cam: PinholeFullParams, uv: Tensor,
                                 iters: int = 10) -> Tensor:
    """Fixed-point undistortion of the rational model."""
    mx = (uv[..., 0] - cam.cx) / cam.fx
    my = (uv[..., 1] - cam.cy) / cam.fy
    d = torch.stack([mx, my], dim=-1)
    u = d
    for _ in range(iters):
        u = u + (d - _rational_distort(cam, u))
    return torch.cat([u, torch.ones_like(u[..., 0:1])], dim=-1)


class ScaramuzzaParams(NamedTuple):
    """Scaramuzza omnidirectional model (OCamCalib): cam2world polynomial
    ``poly`` (deg 4), world2cam inverse polynomial ``inv_poly`` (deg N),
    affine c,d,e + center (camera_models OCAMCamera)."""

    poly: Tensor       # [5]  a0..a4 (a1 = 0 by convention)
    inv_poly: Tensor   # [K]
    c: Tensor
    d: Tensor
    e: Tensor
    cx: Tensor
    cy: Tensor

    @staticmethod
    def make(poly, inv_poly, c=1.0, d=0.0, e=0.0, cx=0.0, cy=0.0, dtype=torch.float32,
             device=None):
        return ScaramuzzaParams(
            torch.as_tensor([float(v) for v in poly], dtype=dtype, device=device),
            torch.as_tensor([float(v) for v in inv_poly], dtype=dtype, device=device),
            *_scalars((c, d, e, cx, cy), dtype, device),
        )


def scaramuzza_space_to_plane(cam: ScaramuzzaParams, pts: Tensor) -> Tensor:
    """world2cam: theta (from optical axis) -> rho via inverse polynomial."""
    norm = torch.linalg.norm(pts[..., 0:2], dim=-1)
    theta = torch.atan2(-pts[..., 2], torch.clamp(norm, min=1e-12))
    rho = torch.zeros_like(theta)
    for k in range(cam.inv_poly.shape[0] - 1, -1, -1):
        rho = rho * theta + cam.inv_poly[k]
    u = pts[..., 0] / torch.clamp(norm, min=1e-12) * rho
    v = pts[..., 1] / torch.clamp(norm, min=1e-12) * rho
    x = u * cam.c + v * cam.d + cam.cx
    y = u * cam.e + v + cam.cy
    return torch.stack([x, y], dim=-1)


_OCAM_FLIP = (1.0, -1.0, -1.0)   # 180° about x: pipeline z-forward ↔ OCam −z


def scaramuzza_space_to_plane_zfwd(cam: ScaramuzzaParams, pts: Tensor) -> Tensor:
    """Scaramuzza projection of z-FORWARD camera-frame points — the frame
    every other model (and the tracker/estimator pipeline) uses. The OCam
    math itself looks along −z (``theta = atan2(-z, norm)``,
    ScaramuzzaCamera.cc:632-653), so bridge with a 180° rotation about x."""
    return scaramuzza_space_to_plane(cam, pts * pts.new_tensor(_OCAM_FLIP))


def scaramuzza_lift_projective(cam: ScaramuzzaParams, uv: Tensor) -> Tensor:
    """cam2world: invert the affine, evaluate the forward polynomial → ray in
    the pipeline's z-forward frame. The OCam-frame ray is ``(u, v, −z(ρ))``
    (ScaramuzzaCamera.cc liftProjective); the 180°-about-x bridge of
    :func:`scaramuzza_space_to_plane_zfwd` turns it into ``(u, −v, z)``, so
    ``project_zfwd ∘ lift`` is the identity in one frame. The ray comes back
    scaled to ``z = ±1`` with the sign of ``z(ρ)`` folded in."""
    inv_det = 1.0 / torch.clamp(cam.c - cam.d * cam.e, min=1e-12)
    xp = uv[..., 0] - cam.cx
    yp = uv[..., 1] - cam.cy
    u = inv_det * (xp - cam.d * yp)
    v = inv_det * (-cam.e * xp + cam.c * yp)
    rho = torch.sqrt(u * u + v * v)
    z = torch.zeros_like(rho)
    for k in range(cam.poly.shape[0] - 1, -1, -1):
        z = z * rho + cam.poly[k]
    ray = torch.stack([u, -v, z], dim=-1)
    return ray / torch.clamp(torch.abs(ray[..., 2:3]), min=1e-12) * torch.sign(ray[..., 2:3])


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
    """Build the camera selected by ``cfg.camera.model``. The parameter
    tensors are created on ``device`` (``None`` = PyTorch's default device;
    the system passes its own).

    Distortion-tuple layout per model (mirrors the per-model YAML blocks the
    reference's CameraFactory parses):
      pinhole       k1, k2, p1, p2
      pinhole_full  k1..k6, p1, p2
      mei           xi, k1, k2, p1, p2
      equidistant   k2, k3, k4, k5        (Kannala-Brandt)
      scaramuzza    a0..a4 (cam2world poly), then the world2cam inv_poly
    """
    m = model.lower().replace("-", "_")
    d = tuple(float(v) for v in distortion)
    kw = dict(dtype=dtype, device=device)

    def pad(n):
        return (d + (0.0,) * n)[:n]

    if m in ("pinhole", "radtan"):
        params = PinholeParams.make(fx, fy, cx, cy, *pad(4), **kw)
        return CameraModel("pinhole", params, pinhole_lift_projective,
                           pinhole_space_to_plane)
    if m in ("pinhole_full", "pinholefull"):
        params = PinholeFullParams.make(fx, fy, cx, cy, *pad(8), **kw)
        return CameraModel("pinhole_full", params, pinhole_full_lift_projective,
                           pinhole_full_space_to_plane)
    if m in ("mei", "cata", "catadioptric"):
        xi, k1, k2, p1, p2 = pad(5)
        params = MeiParams.make(xi, fx, fy, cx, cy, k1, k2, p1, p2, **kw)
        return CameraModel("mei", params, mei_lift_projective, mei_space_to_plane)
    if m in ("equidistant", "kannala_brandt", "fisheye"):
        params = EquidistantParams.make(fx, fy, cx, cy, *pad(4), **kw)
        return CameraModel("equidistant", params, equidistant_lift_projective,
                           equidistant_space_to_plane)
    if m in ("scaramuzza", "ocam"):
        inv_poly = d[5:] if len(d) > 5 else (fx,)   # rho ≈ f·theta fallback
        params = ScaramuzzaParams.make(pad(5), inv_poly, cx=cx, cy=cy, **kw)
        # bind the z-forward pair so project ∘ lift = id in the same frame
        # convention as every other dispatched model
        return CameraModel("scaramuzza", params, scaramuzza_lift_projective,
                           scaramuzza_space_to_plane_zfwd)
    raise ValueError(f"unknown camera model {model!r}")
