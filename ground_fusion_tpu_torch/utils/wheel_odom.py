"""Raw wheel-odometry pose helpers (SURVEY §2 #24).

Equivalent of ``FeatureManager::{linear_insert, getPoseByWheelOdom,
initFramePoseByOdom}`` (feature_manager.cpp:407-545): interpolate a buffer of
stamped planar wheel-odometry poses at a frame time and use it to seed a new
frame's pose when vision fails. The reference keeps this on the CPU behind a
mutex-guarded queue; it is a low-rate fallback path, so it stays host-side
NumPy here too (the hot odometry path is the preintegrated wheel factor).

Conventions follow the reference: interpolation is planar — x, y linearly,
z forced to 0; the quaternion blends only the (z, w) components, i.e. yaw
(feature_manager.cpp:414-426).
"""

from __future__ import annotations

import bisect

import numpy as np

# base_link → camera axis permutation used by the reference
# (feature_manager.cpp:458: rows are cam axes in wheel coords)
WHEEL2CAM = np.array([[0.0, 0.0, 1.0],
                      [-1.0, 0.0, 0.0],
                      [0.0, -1.0, 0.0]])


def linear_insert(t: float, t0: float, p0: np.ndarray, qzw0: np.ndarray,
                  t1: float, p1: np.ndarray, qzw1: np.ndarray):
    """Planar interpolation between two stamped odometry samples
    (feature_manager.cpp:407-426). ``qzw = [qz, qw]``; returns (P[3], R[3,3])."""
    a = (t1 - t) / (t1 - t0)
    b = (t - t0) / (t1 - t0)
    P = np.array([p0[0] * a + p1[0] * b, p0[1] * a + p1[1] * b, 0.0])
    qz = qzw0[0] * a + qzw1[0] * b
    qw = qzw0[1] * a + qzw1[1] * b
    n = np.hypot(qz, qw)
    qz, qw = qz / n, qw / n
    # yaw-only rotation from (qw, 0, 0, qz)
    R = np.array([
        [1.0 - 2.0 * qz * qz, -2.0 * qw * qz, 0.0],
        [2.0 * qw * qz, 1.0 - 2.0 * qz * qz, 0.0],
        [0.0, 0.0, 1.0],
    ])
    return P, R


class WheelOdomPoseBuffer:
    """Time-ordered raw wheel-odometry pose buffer with frame-time lookup."""

    def __init__(self, tio: np.ndarray | None = None):
        self.ts: list[float] = []
        self.ps: list[np.ndarray] = []
        self.qzw: list[np.ndarray] = []
        self.tio = np.zeros(3) if tio is None else np.asarray(tio, np.float64)

    def push(self, t: float, p, qz: float, qw: float) -> None:
        self.ts.append(float(t))
        self.ps.append(np.asarray(p, np.float64))
        self.qzw.append(np.array([qz, qw], np.float64))

    def pose_by_wheel_odom(self, t: float):
        """Camera pose (P[3], R[3,3]) at time ``t`` via planar interpolation,
        shifted by the wheel→IMU lever arm and rotated into the camera frame
        (feature_manager.cpp:441-517). Returns None outside the buffer span."""
        if not self.ts or t < self.ts[0] or t > self.ts[-1]:
            return None
        i = bisect.bisect_left(self.ts, t)
        if self.ts[i] == t:
            qz, qw = self.qzw[i]
            n = np.hypot(qz, qw)
            qz, qw = qz / n, qw / n
            R = np.array([
                [1.0 - 2.0 * qz * qz, -2.0 * qw * qz, 0.0],
                [2.0 * qw * qz, 1.0 - 2.0 * qz * qz, 0.0],
                [0.0, 0.0, 1.0],
            ])
            P = self.ps[i].copy()
        else:
            P, R = linear_insert(
                t, self.ts[i - 1], self.ps[i - 1], self.qzw[i - 1],
                self.ts[i], self.ps[i], self.qzw[i],
            )
        P = P + R @ self.tio
        return P, R @ WHEEL2CAM

    def init_frame_pose(self, t: float, tic: np.ndarray, ric: np.ndarray):
        """Seed a frame's world-from-IMU pose from the wheel track
        (``initFramePoseByOdom``, feature_manager.cpp:521-545). Returns
        (P_wi[3], R_wi[3,3]) or None."""
        cam = self.pose_by_wheel_odom(t)
        if cam is None:
            return None
        P_cam, R_cam = cam
        R_wi = R_cam @ np.asarray(ric).T
        P_wi = -R_wi @ np.asarray(tic) + P_cam
        return P_wi, R_wi
