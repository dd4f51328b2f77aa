"""Trajectory evaluation: ATE/RPE with 4-DoF (yaw + translation) alignment.

The reference's evaluation protocol is TUM-file + evo-style ATE against
dataset ground truth (``README.md:146-186``, ``visualization.cpp:346-358``).
Gravity makes roll/pitch observable, so the admissible alignment between an
estimate and ground truth is yaw+translation — the same gauge the estimator's
``double2vector`` re-anchors (``estimator.cpp:2440-2569``).
"""

from __future__ import annotations

import numpy as np


def align_4dof(est_xyz: np.ndarray, gt_xyz: np.ndarray):
    """Closed-form yaw+translation minimizing ‖R_z(yaw)·est + t − gt‖²."""
    mu_e = est_xyz.mean(0)
    mu_g = gt_xyz.mean(0)
    e = est_xyz - mu_e
    g = gt_xyz - mu_g
    # yaw* = atan2(Σ(e_x g_y − e_y g_x), Σ(e_x g_x + e_y g_y))
    s = float(np.sum(e[:, 0] * g[:, 1] - e[:, 1] * g[:, 0]))
    c = float(np.sum(e[:, 0] * g[:, 0] + e[:, 1] * g[:, 1]))
    yaw = np.arctan2(s, c)
    cy, sy = np.cos(yaw), np.sin(yaw)
    R = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    t = mu_g - R @ mu_e
    return R, t


def ate_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, align: bool = True) -> float:
    """Absolute trajectory error RMSE after optional 4-DoF alignment."""
    est_xyz = np.asarray(est_xyz, np.float64)
    gt_xyz = np.asarray(gt_xyz, np.float64)
    if align:
        R, t = align_4dof(est_xyz, gt_xyz)
        est_xyz = est_xyz @ R.T + t
    err = est_xyz - gt_xyz
    return float(np.sqrt(np.mean(np.sum(err * err, axis=1))))


def rpe_rmse(est_xyz: np.ndarray, gt_xyz: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation) error RMSE over frame gaps of ``delta``."""
    de = est_xyz[delta:] - est_xyz[:-delta]
    dg = gt_xyz[delta:] - gt_xyz[:-delta]
    err = np.linalg.norm(de, axis=1) - np.linalg.norm(dg, axis=1)
    return float(np.sqrt(np.mean(err * err)))


def load_tum(path: str) -> np.ndarray:
    """Load a TUM trajectory file -> [N, 8] (t, x, y, z, qx, qy, qz, qw)."""
    return np.loadtxt(path)
