"""Render a synthetic image sequence from the simulator into the dataset
directory layout of :mod:`..io.dataset` — gives the full system (KLT front
end included) an end-to-end driveable input without any external dataset.

Gaussian blobs at the projected landmark pixels over a dark noisy background
(and, if asked for, bright bars along projected 3-D line segments, for the
line detector), a depth image that carries each blob's range (and, if asked
for, the range of an untextured cylindrical wall around the path behind every
other pixel), and the IMU / wheel / ground truth files, all from a seed. The
intrinsics come from the caller's config (pinhole by default, or any
dispatched camera model of :mod:`..cameras.models`), and so may the sensor
mounts (:class:`Mounts`): the simulator's camera always looks along the
direction of travel, and the IMU (the body frame the
estimator solves for) and the wheel odometer are placed relative to that
camera as the config's ``body_T_cam`` and ``body_T_wheel`` say, so that a
config runs unchanged on the rendered sequence.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..geometry.se3 import pose_apply_inv, pose_compose
from ..utils import np_quat
from .synthetic import (
    F64,
    SimParams,
    _body_rates,
    body_T_cam,
    gt_pose7,
    imu_samples,
    make_landmarks,
    project_landmarks,
    wheel_samples,
)


class Mounts(NamedTuple):
    """Sensor mounts as a config states them (translations in metres,
    quaternions wxyz). The defaults are the simulator's own: the IMU at the
    vehicle frame (x forward, z up) with the forward-looking camera of
    :func:`..sim.synthetic.body_T_cam`, the wheel odometer at the IMU."""

    t_ic: tuple = (0.0, 0.0, 0.0)
    q_ic: tuple | None = None            # None: the simulator's camera rotation
    t_io: tuple = (0.0, 0.0, 0.0)
    q_io: tuple = (1.0, 0.0, 0.0, 0.0)

    @classmethod
    def from_config(cls, cfg) -> "Mounts":
        return cls(tuple(cfg.camera.t_ic), tuple(cfg.camera.q_ic),
                   tuple(cfg.wheel.t_io), tuple(cfg.wheel.q_io))


def _rot(q) -> np.ndarray:
    return np_quat.quat_to_mat(np_quat.quat_normalize(np.asarray(q, np.float64)))


def _mat_to_quat(R: np.ndarray) -> np.ndarray:
    """Rotation matrix → wxyz quaternion with w ≥ 0 (host-side, one matrix)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    x = np.sqrt(max(0.0, 1.0 + R[0, 0] - R[1, 1] - R[2, 2])) / 2.0
    y = np.sqrt(max(0.0, 1.0 - R[0, 0] + R[1, 1] - R[2, 2])) / 2.0
    z = np.sqrt(max(0.0, 1.0 - R[0, 0] - R[1, 1] + R[2, 2])) / 2.0
    q = np.array([w, np.copysign(x, R[2, 1] - R[1, 2]), np.copysign(y, R[0, 2] - R[2, 0]),
                  np.copysign(z, R[1, 0] - R[0, 1])])
    return q / np.linalg.norm(q)


def vehicle_T_imu(mounts: Mounts):
    """Where the IMU sits in the simulator's vehicle frame so that the
    forward-looking camera is at the config's ``body_T_cam`` from it:
    X = vehicle_T_cam ∘ (imu_T_cam)⁻¹ → (R_x [3,3], t_x [3])."""
    ex = body_T_cam().numpy()
    r_vc = np_quat.quat_to_mat(ex[3:7])
    if mounts.q_ic is None:
        return np.eye(3), ex[0:3] - np.asarray(mounts.t_ic, np.float64)
    r_x = r_vc @ _rot(mounts.q_ic).T
    return r_x, ex[0:3] - r_x @ np.asarray(mounts.t_ic, np.float64)


def imu_at_mount(ts, sp: SimParams, r_x, t_x):
    """IMU samples of an IMU rigidly mounted at ``(r_x, t_x)`` in the vehicle
    frame: the lever arm adds α×t + ω×(ω×t) to the specific force, both
    readings turn into the IMU's axes, and the biases are the IMU's own."""
    acc, gyr = (x.numpy() for x in imu_samples(ts, sp))
    acc, gyr = acc - np.asarray(sp.ba), gyr - np.asarray(sp.bg)
    alpha = vmap(lambda t: jacfwd(lambda s: _body_rates(s, sp)[3])(t))(
        torch.as_tensor(ts, dtype=F64)).numpy()
    acc = acc + np.cross(alpha, t_x) + np.cross(gyr, np.cross(gyr, t_x))
    return acc @ r_x + np.asarray(sp.ba), gyr @ r_x + np.asarray(sp.bg)


def wheel_at_mount(ts, sp: SimParams, r_x, t_x, t_io, q_io):
    """What a wheel odometer at ``body_T_wheel = (t_io, q_io)`` from that IMU
    reports: the velocity of its own origin and the angular rate, both in its
    own axes — v_o = R_ioᵀ (v_b + ω_b × t_io), ω_o = R_ioᵀ ω_b."""
    vel, gyr = (x.numpy() for x in wheel_samples(ts, sp))
    vel_b = (vel + np.cross(gyr, t_x)) @ r_x            # the IMU's velocity, its axes
    gyr_b = gyr @ r_x
    r_io = _rot(q_io)
    return (vel_b + np.cross(gyr_b, np.asarray(t_io, np.float64))) @ r_io, gyr_b @ r_io


SEGMENT_SIGMA_PX = 2.0
SEGMENT_INTENSITY = 150.0


def draw_segments(img: np.ndarray, segments_px) -> None:
    """Add a bright bar along each pixel segment [x1, y1, x2, y2] to ``img``
    in place: a Gaussian profile across it (``SEGMENT_SIGMA_PX``), so that
    its gradient changes smoothly as the bar moves by fractions of a pixel,
    and the same on both sides, so that a descriptor read across it does
    not depend on which way the segment points."""
    h, w = img.shape
    pad = 4.0 * SEGMENT_SIGMA_PX
    for x1, y1, x2, y2 in np.asarray(segments_px, np.float64).reshape(-1, 4):
        x0, x9 = int(max(np.floor(min(x1, x2) - pad), 0)), int(min(np.ceil(max(x1, x2) + pad), w - 1))
        y0, y9 = int(max(np.floor(min(y1, y2) - pad), 0)), int(min(np.ceil(max(y1, y2) + pad), h - 1))
        if x0 > x9 or y0 > y9:
            continue
        ys, xs = np.mgrid[y0 : y9 + 1, x0 : x9 + 1].astype(np.float64)
        dx, dy = x2 - x1, y2 - y1
        s = np.clip(((xs - x1) * dx + (ys - y1) * dy) / max(dx * dx + dy * dy, 1e-12), 0.0, 1.0)
        dist = np.hypot(xs - (x1 + s * dx), ys - (y1 + s * dy))
        bar = SEGMENT_INTENSITY * np.exp(-0.5 * (dist / SEGMENT_SIGMA_PX) ** 2)
        img[y0 : y9 + 1, x0 : x9 + 1] += bar.astype(img.dtype)


def render_frame(uv_px, z, vis, rng, width: int, height: int, background=None,
                 segments_px=None):
    """Gaussian blobs at projected landmark pixels over a dark background,
    and bright bars along ``segments_px`` [N,4] (pixel endpoints), if given.
    Returns (image [H,W] float32 in 0..255, depth [H,W] float32, 0 = none);
    ``background`` [H,W] is the depth behind the blobs (default none)."""
    img = rng.normal(8.0, 1.0, (height, width)).astype(np.float32)
    if segments_px is not None:
        draw_segments(img, segments_px)
    depth = (np.zeros((height, width), np.float32) if background is None
             else np.asarray(background, np.float32).copy())
    ys, xs = np.mgrid[0:7, 0:7] - 3
    blob = 200.0 * np.exp(-(xs**2 + ys**2) / 4.0)
    for (u, v), d, ok in zip(uv_px, z, vis):
        if not ok:
            continue
        ui, vi = int(round(u)), int(round(v))
        if 4 <= ui < width - 4 and 4 <= vi < height - 4:
            img[vi - 3 : vi + 4, ui - 3 : ui + 4] += blob
            depth[vi - 3 : vi + 4, ui - 3 : ui + 4] = d
    return np.clip(img, 0, 255), depth


def _project(camera, pts_c: np.ndarray) -> np.ndarray:
    """Camera-frame points [N,3] → pixels [N,2] through a dispatched camera."""
    dtype = camera.params[0].dtype
    return camera.space_to_plane(torch.as_tensor(pts_c, dtype=dtype)).double().numpy()


def segment_pixels(pose, ex_cam, segments, fx: float, fy: float, cx: float, cy: float,
                   camera=None):
    """Pixel endpoints [M,4] of the world ``segments`` [N,2,3] whose two
    endpoints lie at least 0.3 m in front of the camera at ``pose`` ∘
    ``ex_cam``; through ``camera`` (a dispatched model) if given, else the
    pinhole ``fx, fy, cx, cy``."""
    cam = pose_compose(torch.as_tensor(pose, dtype=F64), torch.as_tensor(ex_cam, dtype=F64))
    segs = torch.as_tensor(np.asarray(segments), dtype=F64)
    pa, pb = (pose_apply_inv(cam, segs[:, i]).numpy() for i in (0, 1))
    front = (pa[:, 2] > 0.3) & (pb[:, 2] > 0.3)
    if camera is not None:
        return np.concatenate([_project(camera, pa), _project(camera, pb)], axis=1)[front]
    k = np.array([fx, fy, fx, fy])
    c = np.array([cx, cy, cx, cy])
    uv = np.concatenate([pa[:, 0:2] / pa[:, 2:3], pb[:, 0:2] / pb[:, 2:3]], axis=1)
    return (uv * k + c)[front]


def wall_depth(cam_pose, fx: float, fy: float, cx: float, cy: float, width: int, height: int,
               radius: float, camera=None) -> np.ndarray:
    """Depth image [H,W] (z in the camera) of the vertical cylinder of
    ``radius`` about the world's z axis, seen from inside by the camera at
    ``cam_pose`` (world_T_cam [7]); 0 where a ray runs parallel to the axis.
    Each pixel's ray comes from ``camera.lift_projective`` if a dispatched
    model is given, else from the pinhole ``fx, fy, cx, cy``."""
    p = np.asarray(cam_pose, np.float64)
    u, v = np.meshgrid(np.arange(width), np.arange(height))
    if camera is None:
        rays = np.stack([(u - cx) / fx, (v - cy) / fy, np.ones_like(u, float)], -1)
    else:
        uv = torch.as_tensor(np.stack([u, v], -1), dtype=camera.params[0].dtype)
        r = camera.lift_projective(uv)
        rays = (r / torch.clamp(torch.abs(r[..., 2:3]), min=1e-9)).double().numpy()
    d = rays @ np_quat.quat_to_mat(p[3:7]).T                # world direction, z_cam = 1
    a = d[..., 0] ** 2 + d[..., 1] ** 2
    b = 2.0 * (p[0] * d[..., 0] + p[1] * d[..., 1])
    c = p[0] ** 2 + p[1] ** 2 - radius ** 2                 # < 0 inside the wall
    s = (-b + np.sqrt(np.maximum(b * b - 4.0 * a * c, 0.0))) / np.maximum(2.0 * a, 1e-12)
    return np.where(a > 1e-12, s, 0.0).astype(np.float32)


def render_sequence(out_dir: str, n_frames: int, fx: float, fy: float, cx: float,
                    cy: float, width: int, height: int, sp: SimParams | None = None,
                    n_landmarks: int = 600, seed: int = 0,
                    mounts: Mounts | None = None, wall_radius: float | None = None,
                    segments=None, camera=None) -> str:
    """Write ``n_frames`` rendered frames plus ``imu.csv``, ``wheel.csv``,
    ``frames.csv`` and ``gt.csv`` (the IMU's pose) into ``out_dir``; returns
    ``out_dir``. ``mounts=None`` keeps the simulator's own sensor frames.
    ``wall_radius`` puts an untextured wall of that radius about the path's
    centre into the depth images (dense depth for the dense map); by default
    only the blobs have a depth. ``segments`` [N,2,3] (world endpoints, e.g.
    from :func:`..sim.synthetic.make_segments`) are drawn as bright bars
    wherever both endpoints lie in front of the camera. ``camera`` (a model
    from :func:`..cameras.models.make_camera`, on the CPU) places the blobs,
    the segments and the wall's rays through that model; by default the
    pinhole ``fx, fy, cx, cy`` does."""
    sp = sp if sp is not None else SimParams(omega=0.25)
    mounts = mounts if mounts is not None else Mounts()
    os.makedirs(os.path.join(out_dir, "img"), exist_ok=True)
    ex = body_T_cam()
    r_x, t_x = vehicle_T_imu(mounts)
    pts_w = torch.as_tensor(make_landmarks(n_landmarks, sp, seed=seed + 1), dtype=torch.float64)
    rng = np.random.default_rng(seed)

    frame_dt = 1.0 / sp.frame_rate
    imu_rows, wheel_rows, frame_rows, gt_rows = [], [], [], []
    for k in range(n_frames):
        t = k * frame_dt
        tp = t - frame_dt if k else t
        ts = np.arange(tp, t + 1e-9, 1.0 / sp.imu_rate) if k else np.asarray([t])
        a, g = imu_at_mount(ts, sp, r_x, t_x)
        imu_rows.extend(np.concatenate([ts[:, None], a, g], axis=1))
        ts = np.arange(tp, t + 1e-9, 1.0 / sp.wheel_rate) if k else np.asarray([t])
        v, g = wheel_at_mount(ts, sp, r_x, t_x, mounts.t_io, mounts.q_io)
        wheel_rows.extend(np.concatenate([ts[:, None], v, g], axis=1))

        pose = gt_pose7(t, sp)
        uv, z, vis = project_landmarks(pose, ex, pts_w)
        if camera is None:
            uv_px = uv.numpy() * [fx, fy] + [cx, cy]
        else:
            uv_px = _project(camera, np.concatenate([uv.numpy(), np.ones((len(uv), 1))], 1))
        background = None
        if wall_radius is not None:
            cam = pose_compose(pose, ex).numpy()
            background = wall_depth(cam, fx, fy, cx, cy, width, height, wall_radius,
                                    camera=camera)
        seg_px = None
        if segments is not None:
            seg_px = segment_pixels(pose, ex, segments, fx, fy, cx, cy, camera=camera)
        img, depth = render_frame(uv_px, z.numpy(), vis.numpy(), rng, width, height, background,
                                  segments_px=seg_px)
        np.save(os.path.join(out_dir, "img", f"{k:05d}.npy"), img)
        np.save(os.path.join(out_dir, "img", f"{k:05d}_d.npy"), depth)
        frame_rows.append(f"{t:.6f},img/{k:05d}.npy,img/{k:05d}_d.npy")
        p = pose.numpy()
        r_wv = np_quat.quat_to_mat(p[3:7])
        p_imu = p[0:3] + r_wv @ t_x
        q = _mat_to_quat(r_wv @ r_x)
        gt_rows.append(f"{t:.6f} {p_imu[0]} {p_imu[1]} {p_imu[2]} {q[1]} {q[2]} {q[3]} {q[0]}")

    np.savetxt(os.path.join(out_dir, "imu.csv"), np.asarray(imu_rows), delimiter=",")
    np.savetxt(os.path.join(out_dir, "wheel.csv"), np.asarray(wheel_rows), delimiter=",")
    with open(os.path.join(out_dir, "frames.csv"), "w") as fp:
        fp.write("\n".join(frame_rows) + "\n")
    with open(os.path.join(out_dir, "gt.csv"), "w") as fp:
        fp.write("\n".join(gt_rows) + "\n")
    return out_dir
