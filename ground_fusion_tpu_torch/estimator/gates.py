"""Runtime gates: outlier rejection, stationarity detectors, wheel anomaly,
failure detection — the reference's data-driven robustness layer as pure
functions producing masks (SURVEY §5: "keep the anomaly gates as data
inputs to the solver"). The device gates return 0-d boolean tensors and are
consumed with ``torch.where``: nothing here forces a device→host sync.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..geometry.se3 import pose_apply, pose_apply_inv, pose_compose
from ..geometry.so3 import quat_rotate, quat_rotate_inv
from .window import Tracks, WindowState


def moving_consistency_check(state: WindowState, tracks: Tracks,
                             focal: float = 460.0,
                             reproj_px: float = 10.0,
                             err3d_ratio: float = 2.0) -> Tensor:
    """Batched ``movingConsistencyCheckW`` (``estimator.cpp:3968-4012``):
    per landmark, mean reprojection error across its observations (anchored
    depth) and mean 3-D endpoint discrepancy relative to depth; returns a
    "remove" mask for landmarks exceeding 10 px or ratio 2.0 — the dynamic-
    object rejection of the wheel-consistency path."""
    ml, f = tracks.obs_valid.shape
    dev = tracks.obs.device
    cams = pose_compose(state.poses, state.ex_cam[None, :])       # [F,7]
    start = torch.clamp(tracks.start_frame, 0, f - 1)
    anchor = cams[start]                                          # [ML,7]
    uv = tracks.obs[:, :, 0:2]
    rays = torch.cat([uv, torch.ones_like(uv[..., 0:1])], dim=-1)
    depth = 1.0 / torch.clamp(tracks.inv_depth, min=1e-6)
    anchor_ray = rays[torch.arange(ml, device=dev), start]        # [ML,3]
    pts_w = pose_apply(anchor, anchor_ray * depth[:, None])       # [ML,3]

    pts_cj = pose_apply_inv(cams[None, :, :], pts_w[:, None, :])  # [ML,F,3]
    zj = pts_cj[..., 2]
    proj = pts_cj[..., 0:2] / torch.clamp(zj[..., None], min=1e-6)
    err2d = torch.linalg.norm(proj - uv, dim=-1)
    # 3-D endpoint discrepancy: measured ray at obs depth (when z known from
    # the model) vs model point, normalized by depth
    meas_pt = rays * zj[..., None]
    err3d = torch.linalg.norm(meas_pt - pts_cj, dim=-1) / torch.clamp(depth[:, None], min=1e-6)

    ok = tracks.obs_valid & (torch.arange(f, device=dev)[None, :] != tracks.start_frame[:, None])
    cnt = torch.clamp(torch.sum(ok, dim=1), min=1)
    zero = torch.zeros_like(err2d)
    mean2d = torch.sum(torch.where(ok, err2d, zero), dim=1) / cnt
    mean3d = torch.sum(torch.where(ok, err3d, zero), dim=1) / cnt
    eligible = tracks.active & tracks.solve_ok & (torch.sum(tracks.obs_valid, dim=1) >= 2)
    return eligible & ((focal * mean2d > reproj_px) | (mean3d > err3d_ratio))


def remove_outliers(tracks: Tracks, remove: Tensor) -> Tracks:
    """``FeatureManager::removeOutlier`` — deactivate flagged landmarks."""
    keep = ~remove
    return tracks._replace(
        active=tracks.active & keep,
        solve_ok=tracks.solve_ok & keep,
    )


def wheel_body_deltas(state: WindowState, wheel_pre) -> Tensor:
    """ΔP_wheel[k]: wheel-implied body translation over interval (k-1, k] —
    ``T_io ∘ ΔT_o ∘ T_io⁻¹`` translation part (estimator.cpp:629-636)."""
    q_io = state.ex_wheel[3:7]
    t_io = state.ex_wheel[0:3]
    t_o = quat_rotate_inv(q_io, t_io)
    dq_b = quat_rotate(q_io, quat_rotate(wheel_pre.delta_q, t_o))
    return t_io[None, :] + quat_rotate(q_io, wheel_pre.delta_p) - dq_b   # [F,3]


def newest_wheel_anomaly(state: WindowState, imu_pre, wheel_pre, g,
                         anomaly_thresh: float) -> Tensor:
    """Wheel slip/bump test over the NEWEST interval — the reference's
    wheel-vs-IMU dead-reckoning comparison at measurement time
    (``estimator.cpp:629-636``): ``‖ΔP_wheel − ΔP_imu‖ > thresh`` with
    ΔP_imu = v·dt − ½g·dt² rotated into body + the preintegrated Δp.
    Evaluated ONCE per interval (at its first solve, when the window is
    converged) and then PERSISTED in ``WheelWindowBuffer.bad`` — a
    state-derived per-slot recomputation is self-referential (a bad window
    would disable the wheel factors that fix it) and the stationary freeze
    legitimately zeroes window velocities, which would poison older slots'
    v·dt terms."""
    f = state.poses.shape[0]
    j = f - 1
    dt = imu_pre.sum_dt[j]
    q_i = state.poses[j - 1, 3:7]
    v_body = quat_rotate_inv(q_i, state.sbs[j - 1, 0:3] * dt - 0.5 * g * dt * dt)
    dp_imu = v_body + imu_pre.delta_p[j]
    dp_wheel = wheel_body_deltas(state, wheel_pre)[j]
    return torch.linalg.norm(dp_wheel - dp_imu) > anomaly_thresh


def device_frame_gates(state: WindowState, tracks: Tracks, imu_buf, imu_pre,
                       wheel_pre, g: Tensor, focal: float,
                       acc_var_thresh: float, parallax_px_thresh: float,
                       wheel_dp_thresh: float, anomaly_thresh: float, reduce=None):
    """Device twin of the per-frame anomaly/stationarity detection over the
    newest interval (``estimator.cpp:614-654, 870-896``), computed from the
    window buffers/preintegrations already on device.

    Returns (wheel_anomaly [], stationary []) as 0-d bool tensors:
      - anomaly: :func:`newest_wheel_anomaly` over the newest interval; the
        caller persists it per interval in ``WheelWindowBuffer.bad`` so a
        contaminated interval stays excluded for its whole window lifetime
        (the reference re-admits them once its flag clears,
        estimator.cpp:3132-3136 — documented divergence);
      - stationary: 2-of-3 vote over accel variance, tracked parallax
        between the two newest frames, and ‖ΔP_wheel‖ of the newest interval.

    With the landmark slots split over ranks (``reduce``, as in
    :func:`.solver.solve_window`) the parallax vote's count and sum run over
    every rank's landmarks (one reduction).
    """
    f = state.poses.shape[0]
    anomaly = newest_wheel_anomaly(state, imu_pre, wheel_pre, g, anomaly_thresh)
    j = f - 1
    dp_wheel = wheel_body_deltas(state, wheel_pre)[j]

    # stationary vote 1: accel variance over the newest interval's samples
    acc = imu_buf.acc[j]
    w = imu_buf.valid[j].to(acc.dtype)[:, None]
    nw = torch.sum(w)
    n = torch.clamp(nw, min=1.0)
    mean = torch.sum(acc * w, dim=0) / n
    acc_var = torch.sum(torch.sum((acc - mean) ** 2 * w, dim=0) / n)
    v_imu = (acc_var < acc_var_thresh) & (nw >= 3)

    # vote 2: mean tracked parallax between the two newest frames (px)
    both = tracks.active & tracks.obs_valid[:, f - 2] & tracks.obs_valid[:, f - 1]
    d = tracks.obs[:, f - 1, 0:2] - tracks.obs[:, f - 2, 0:2]
    n_both = torch.sum(both)
    par_sum = torch.sum(torch.linalg.norm(d, dim=-1) * both)
    if reduce is not None:
        n_both, par_sum = reduce(n_both.to(par_sum.dtype), par_sum)
    par = par_sum / torch.clamp(n_both, min=1)
    v_vis = (par * focal < parallax_px_thresh) & (n_both > 0)

    # vote 3: wheel dead-reckoned translation
    v_wheel = torch.linalg.norm(dp_wheel) < wheel_dp_thresh

    votes = v_imu.to(torch.int32) + v_vis.to(torch.int32) + v_wheel.to(torch.int32)
    return anomaly, votes >= 2


# ---------------------------------------------------------------------------
# Host-side detectors (numpy over raw sample queues)
# ---------------------------------------------------------------------------


def imu_stationary(acc_samples: np.ndarray, var_thresh: float = 0.1) -> bool:
    """checkimu (estimator.cpp:870): total accel variance below threshold."""
    if len(acc_samples) < 3:
        return False
    return float(np.var(acc_samples, axis=0).sum()) < var_thresh


def visual_stationary(parallaxes: np.ndarray, focal: float,
                      px_thresh: float = 0.5) -> bool:
    """checkvisual (estimator.cpp:884): mean tracked parallax, scaled to
    pixels, below threshold."""
    if len(parallaxes) == 0:
        return False
    return float(np.mean(parallaxes)) * focal < px_thresh


def wheel_stationary(dp_wheel: np.ndarray, thresh: float = 1e-3) -> bool:
    """preintegration-stationary (estimator.cpp:640-654)."""
    return float(np.linalg.norm(dp_wheel)) < thresh


def wheel_anomaly(dp_wheel: np.ndarray, dp_imu: np.ndarray,
                  thresh: float = 0.02) -> bool:
    """Wheel slip/bump detector (estimator.cpp:629-636):
    ‖ΔP_wheel − ΔP_imu‖ over one frame interval above threshold."""
    return float(np.linalg.norm(np.asarray(dp_wheel) - np.asarray(dp_imu))) > thresh


def failure_detection(sbs: np.ndarray, ba_thresh: float = 2.5,
                      bg_thresh: float = 1.0) -> bool:
    """``Estimator::failureDetection`` (estimator.cpp:2847-2888, active
    checks): accelerometer/gyro bias norms exploding ⇒ reboot."""
    ba = np.linalg.norm(sbs[-1, 3:6])
    bg = np.linalg.norm(sbs[-1, 6:9])
    return bool(ba > ba_thresh or bg > bg_thresh)
