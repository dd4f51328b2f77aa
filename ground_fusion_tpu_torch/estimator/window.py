"""Sliding-window state as fixed-shape NamedTuples of tensors.

The reference scatters its window state over ~20 C++ arrays + Ceres raw
pointers (``estimator.h:267-282``: Ps, Rs, Vs, Bas, Bgs, pre_integrations,
para_Pose...). Here the whole optimizable state is two NamedTuples of
fixed-shape tensors that live on one device:

- :class:`WindowState` — the "camera block": poses, speed-bias, extrinsics,
  time offsets, wheel intrinsics, plane. Flattened tangent layout defined by
  :class:`.layout.StateLayout`.
- :class:`Tracks` — the landmark block: padded feature-track tensor
  ``[ML, F, 5]`` with validity masks (the reference's ``FeaturePerId`` list,
  ``feature_manager.h:103-150``, as arrays).

Sliding the window (``Estimator::slideWindow``, ``estimator.cpp:3638-3795``)
becomes rolls + mask updates with the same shapes. All functions are pure:
they return new tensors and never write into their inputs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..geometry.se3 import pose_apply, pose_apply_inv, pose_boxplus, pose_compose, pose_identity
from ..geometry.so3 import quat_conj, quat_exp, quat_mul, quat_normalize
from .layout import PER_FRAME, StateLayout


class WindowState(NamedTuple):
    """Optimizable camera-block state over ``F = window_size + 1`` frames."""

    poses: Tensor     # [F, 7] body-in-world (p, q_wxyz)
    sbs: Tensor       # [F, 9] (v, ba, bg)
    ex_cam: Tensor    # [7] body_T_cam
    td: Tensor        # [] camera-IMU time offset
    ex_wheel: Tensor  # [7] body_T_wheel
    s_wheel: Tensor   # [3] (sx, sy, sw)
    td_wheel: Tensor  # []
    plane_q: Tensor   # [4] q_pw (plane-from-world)
    plane_z: Tensor   # [] z_pw
    rcv_dt: Tensor    # [F, 4] GNSS receiver clock bias per constellation (m)
    rcv_ddt: Tensor   # [F] receiver clock drift (m/s)
    yaw_enu: Tensor   # [] ENU-local yaw offset
    anc_ecef: Tensor  # [3] ECEF anchor

    @property
    def dtype(self):
        return self.poses.dtype

    @property
    def device(self):
        return self.poses.device


class Tracks(NamedTuple):
    """Padded landmark table (``ML`` slots over ``F`` frames).

    ``obs[l, f] = [x, y, vx, vy, depth_meas]`` — undistorted normalized-plane
    coordinates, image velocity (normalized units/s), and the RGBD depth
    sample (0 where absent), mirroring ``FeaturePerFrame``
    (``feature_manager.h:58-99``).
    """

    inv_depth: Tensor    # [ML] inverse depth in the anchor frame
    active: Tensor       # [ML] bool — slot in use
    solve_ok: Tensor     # [ML] bool — triangulated / depth good (flag != failed)
    depth_fixed: Tensor  # [ML] bool — depth measured by RGBD, held constant
    start_frame: Tensor  # [ML] int64 anchor frame index
    obs: Tensor          # [ML, F, 5]
    obs_valid: Tensor    # [ML, F] bool


def empty_state(num_frames: int, dtype=torch.float32, device=None) -> WindowState:
    kw = dict(dtype=dtype, device=device)
    eye = pose_identity(**kw)
    return WindowState(
        poses=eye.repeat(num_frames, 1),
        sbs=torch.zeros((num_frames, 9), **kw),
        ex_cam=eye.clone(),
        td=torch.zeros((), **kw),
        ex_wheel=eye.clone(),
        s_wheel=torch.ones((3,), **kw),
        td_wheel=torch.zeros((), **kw),
        plane_q=torch.tensor([1.0, 0, 0, 0], **kw),
        plane_z=torch.zeros((), **kw),
        rcv_dt=torch.zeros((num_frames, 4), **kw),
        rcv_ddt=torch.zeros((num_frames,), **kw),
        yaw_enu=torch.zeros((), **kw),
        anc_ecef=torch.zeros((3,), **kw),
    )


def empty_tracks(max_landmarks: int, num_frames: int, dtype=torch.float32,
                 device=None) -> Tracks:
    ml, f = max_landmarks, num_frames
    return Tracks(
        inv_depth=torch.full((ml,), 0.2, dtype=dtype, device=device),
        active=torch.zeros((ml,), dtype=torch.bool, device=device),
        solve_ok=torch.zeros((ml,), dtype=torch.bool, device=device),
        depth_fixed=torch.zeros((ml,), dtype=torch.bool, device=device),
        start_frame=torch.zeros((ml,), dtype=torch.int64, device=device),
        obs=torch.zeros((ml, f, 5), dtype=dtype, device=device),
        obs_valid=torch.zeros((ml, f), dtype=torch.bool, device=device),
    )


# ---------------------------------------------------------------------------
# Tangent-space flatten / retract against the StateLayout
# ---------------------------------------------------------------------------


def retract(state: WindowState, delta: Tensor, layout: StateLayout) -> WindowState:
    """Apply a flat tangent update (layout order) to the camera block.

    Pose blocks use the manifold ⊞ (p += δp, q ⊗ deltaQ(δθ)); everything else
    is additive — identical to the reference's local parameterizations.
    """
    f = state.poses.shape[0]
    d_frames = delta[: PER_FRAME * f].reshape(f, PER_FRAME)
    poses = pose_boxplus(state.poses, d_frames[:, 0:6])
    sbs = state.sbs + d_frames[:, 6:15]
    ex_cam = pose_boxplus(state.ex_cam, delta[layout.ex_cam : layout.ex_cam + 6])
    td = state.td + delta[layout.td]
    ex_wheel = pose_boxplus(state.ex_wheel, delta[layout.ex_wheel : layout.ex_wheel + 6])
    s_wheel = state.s_wheel + delta[layout.s_wheel : layout.s_wheel + 3]
    td_wheel = state.td_wheel + delta[layout.td_wheel]
    plane_q = quat_normalize(
        quat_mul(state.plane_q, quat_exp(delta[layout.plane : layout.plane + 3]))
    )
    plane_z = state.plane_z + delta[layout.plane + 3]
    rcv_dt = state.rcv_dt + delta[layout.gnss_dt : layout.gnss_dt + 4 * f].reshape(f, 4)
    rcv_ddt = state.rcv_ddt + delta[layout.gnss_ddt : layout.gnss_ddt + f]
    yaw_enu = state.yaw_enu + delta[layout.yaw_enu]
    anc_ecef = state.anc_ecef + delta[layout.anc_ecef : layout.anc_ecef + 3]
    return WindowState(poses, sbs, ex_cam, td, ex_wheel, s_wheel, td_wheel,
                       plane_q, plane_z, rcv_dt, rcv_ddt, yaw_enu, anc_ecef)


def _pose_minus(a: Tensor, ref: Tensor) -> Tensor:
    return torch.cat(
        [a[..., 0:3] - ref[..., 0:3],
         2.0 * quat_mul(quat_conj(ref[..., 3:7]), a[..., 3:7])[..., 1:4]], dim=-1)


def boxminus(state: WindowState, ref: WindowState, layout: StateLayout) -> Tensor:
    """Flat tangent difference ``state ⊟ ref`` in layout order — the Δx the
    marginalization prior evaluates (``marginalization_factor.cpp:356-375``)."""
    d_frames = torch.cat(
        [_pose_minus(state.poses, ref.poses), state.sbs - ref.sbs], dim=-1).reshape(-1)
    d_plane = torch.cat(
        [
            2.0 * quat_mul(quat_conj(ref.plane_q), state.plane_q)[1:4],
            (state.plane_z - ref.plane_z)[None],
        ]
    )
    return torch.cat(
        [
            d_frames,
            _pose_minus(state.ex_cam, ref.ex_cam),
            (state.td - ref.td)[None],
            _pose_minus(state.ex_wheel, ref.ex_wheel),
            state.s_wheel - ref.s_wheel,
            (state.td_wheel - ref.td_wheel)[None],
            d_plane,
            (state.rcv_dt - ref.rcv_dt).reshape(-1),
            state.rcv_ddt - ref.rcv_ddt,
            (state.yaw_enu - ref.yaw_enu)[None],
            state.anc_ecef - ref.anc_ecef,
        ]
    )


# ---------------------------------------------------------------------------
# Sliding (device-side part)
# ---------------------------------------------------------------------------


def roll_old(a: Tensor, dim: int = 0) -> Tensor:
    """Drop index 0 along ``dim`` and repeat the last entry in the freed slot."""
    last = a.narrow(dim, a.shape[dim] - 1, 1)
    return torch.cat([a.narrow(dim, 1, a.shape[dim] - 1), last], dim=dim)


def copy_last_to_second_last(a: Tensor) -> Tensor:
    """Entry F-2 along axis 0 overwritten by entry F-1."""
    return torch.cat([a[:-2], a[-1:], a[-1:]], dim=0)


def slide_old_state(state: WindowState) -> WindowState:
    """MARGIN_OLD: drop frame 0, duplicate the newest into the freed slot
    (``Estimator::slideWindow`` MARGIN_OLD branch, ``estimator.cpp:3648-3704``:
    after the swap loop, slot WINDOW_SIZE keeps a copy of the newest state as
    the prediction for the incoming frame)."""
    return state._replace(poses=roll_old(state.poses), sbs=roll_old(state.sbs),
                          rcv_dt=roll_old(state.rcv_dt), rcv_ddt=roll_old(state.rcv_ddt))


def slide_new_state(state: WindowState) -> WindowState:
    """MARGIN_SECOND_NEW: frame F-2 is overwritten by frame F-1
    (``estimator.cpp:3706-3760``)."""
    c = copy_last_to_second_last
    return state._replace(poses=c(state.poses), sbs=c(state.sbs),
                          rcv_dt=c(state.rcv_dt), rcv_ddt=c(state.rcv_ddt))


def slide_old_tracks(state: WindowState, tracks: Tracks) -> Tracks:
    """MARGIN_OLD landmark bookkeeping (``FeatureManager::removeBackShiftDepth``,
    ``feature_manager.cpp:818-857``): features anchored at frame 0 re-anchor to
    frame 1 with depth re-projected through the relative pose; features that
    lose all observations deactivate; all windows roll left.

    ``state`` must be the *pre-slide* state (frame 0 still present)."""
    anchored0 = tracks.active & (tracks.start_frame == 0)

    # world point from anchor 0, re-projected into frame 1's camera
    cam0 = pose_compose(state.poses[0], state.ex_cam)
    cam1 = pose_compose(state.poses[1], state.ex_cam)
    uv0 = tracks.obs[:, 0, 0:2]
    ray0 = torch.cat([uv0, torch.ones_like(uv0[:, 0:1])], dim=-1)
    depth0 = 1.0 / torch.clamp(tracks.inv_depth, min=1e-6)
    pts_w = pose_apply(cam0, ray0 * depth0[:, None])
    pts_c1 = pose_apply_inv(cam1, pts_w)
    new_depth = pts_c1[:, 2]
    # depth-fixed (RGBD-measured) landmarks re-anchor to the SENSOR depth at
    # the new anchor frame when one is available — the reference reprojects
    # through the pose chain (feature_manager.cpp:838-845), which freezes any
    # instantaneous pose error into the held-constant depth forever; the
    # measured depth has no such feedback loop
    meas1 = tracks.obs[:, 1, 4]
    use_meas = tracks.depth_fixed & (meas1 > 0.1)
    new_depth = torch.where(use_meas, meas1, new_depth)
    seen_at_1 = tracks.obs_valid[:, 1]
    shift_ok = anchored0 & seen_at_1 & (new_depth > 0.1)

    inv_depth = torch.where(shift_ok, 1.0 / torch.clamp(new_depth, min=1e-3), tracks.inv_depth)
    active = tracks.active & torch.where(anchored0, shift_ok, torch.ones_like(shift_ok))
    solve_ok = tracks.solve_ok & active
    start_frame = torch.clamp(tracks.start_frame - 1, min=0)

    obs = torch.cat([tracks.obs[:, 1:], torch.zeros_like(tracks.obs[:, :1])], dim=1)
    obs_valid = torch.cat(
        [tracks.obs_valid[:, 1:], torch.zeros_like(tracks.obs_valid[:, :1])], dim=1)
    # a slot with no remaining observations dies
    active = active & torch.any(obs_valid, dim=1)
    return Tracks(inv_depth, active, solve_ok, tracks.depth_fixed, start_frame, obs, obs_valid)


def slide_new_tracks(tracks: Tracks) -> Tracks:
    """MARGIN_SECOND_NEW landmark bookkeeping (``FeatureManager::removeFront``,
    ``feature_manager.cpp:859-884``): observations at frame F-2 are replaced by
    those at F-1; anchors at F-1 move to F-2."""
    ml, f = tracks.obs_valid.shape
    obs = torch.cat(
        [tracks.obs[:, : f - 2], tracks.obs[:, f - 1 :], torch.zeros_like(tracks.obs[:, :1])],
        dim=1)
    obs_valid = torch.cat(
        [tracks.obs_valid[:, : f - 2], tracks.obs_valid[:, f - 1 :],
         torch.zeros_like(tracks.obs_valid[:, :1])], dim=1)
    start_frame = torch.where(tracks.start_frame == f - 1,
                              torch.full_like(tracks.start_frame, f - 2), tracks.start_frame)
    active = tracks.active & torch.any(obs_valid, dim=1)
    return tracks._replace(
        obs=obs, obs_valid=obs_valid, start_frame=start_frame, active=active,
        solve_ok=tracks.solve_ok & active,
    )
