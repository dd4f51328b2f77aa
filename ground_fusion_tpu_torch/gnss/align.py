"""GNSS-VI initialization: coarse SPP fix, ENU-local yaw alignment, anchor
refinement.

Re-design of ``initial/gnss_vi_initializer.cpp`` (coarse_localization :16-41,
yaw_alignment :43-vis, anchor_refinement) driven by ``Estimator::GNSSVIAlign``
(``estimator.cpp:1928-2043``): the receiver's Doppler velocity per epoch is a
measurement of the VIO window velocity rotated by the unknown ENU-local yaw —
a 1-D Gauss-Newton; the anchor then refines by least squares over the SPP
fixes minus yaw-rotated local positions. Host numpy (runs once)."""

from __future__ import annotations

import numpy as np

from .coords import ecef2rotation
from .spp import dopp_vel_solve, spp_solve


def coarse_localization(epochs, iono_paras=None):
    """SPP over all observations of the collected epochs
    (gnss_vi_initializer.cpp:16-41). ``epochs``: list of obs-dict lists."""
    all_obs = [o for ep in epochs for o in ep]
    return spp_solve(all_obs, iono_paras=iono_paras)


def yaw_alignment(local_vels, epochs, anc_ecef, iters: int = 10):
    """1-D GN for the ENU-local yaw: match Doppler-derived ENU velocities
    against the window's local-frame velocities (gnss_vi_initializer.cpp
    yaw_alignment). local_vels [N,3] (local world), one epoch per entry."""
    R_ecef_enu = ecef2rotation(anc_ecef)
    v_enu = []
    keep = []
    for k, ep in enumerate(epochs):
        v, ddt, ok = dopp_vel_solve(ep, anc_ecef)
        if ok:
            v_enu.append(R_ecef_enu.T @ v)
            keep.append(k)
    if not v_enu:
        return 0.0, False
    v_enu = np.stack(v_enu)
    v_loc = np.asarray(local_vels)[keep]

    yaw = 0.0
    for _ in range(iters):
        cy, sy = np.cos(yaw), np.sin(yaw)
        # r = R_z(yaw) v_loc - v_enu (xy only; z decouples)
        rx = cy * v_loc[:, 0] - sy * v_loc[:, 1] - v_enu[:, 0]
        ry = sy * v_loc[:, 0] + cy * v_loc[:, 1] - v_enu[:, 1]
        jx = -sy * v_loc[:, 0] - cy * v_loc[:, 1]
        jy = cy * v_loc[:, 0] - sy * v_loc[:, 1]
        H = float(np.sum(jx * jx + jy * jy))
        g = float(np.sum(jx * rx + jy * ry))
        if H < 1e-9:
            return yaw, False
        yaw -= g / H
    return float(yaw), True


def anchor_refinement(local_pos, yaw, epochs, anc0, iono_paras=None, iters: int = 5):
    """Refine the ECEF anchor: each epoch's SPP fix should equal
    ``anc + R_ecef_enu(anc) R_z(yaw) p_local`` (gnss_vi_initializer.cpp
    anchor refinement)."""
    anc = np.asarray(anc0, float).copy()
    cy, sy = np.cos(yaw), np.sin(yaw)
    Rz = np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    fixes = []
    keep = []
    for k, ep in enumerate(epochs):
        p, dt, ok = spp_solve(ep, x0=anc, iono_paras=iono_paras)
        if ok:
            fixes.append(p)
            keep.append(k)
    if not fixes:
        return anc, False
    fixes = np.stack(fixes)
    p_loc = np.asarray(local_pos)[keep]
    for _ in range(iters):
        R = ecef2rotation(anc) @ Rz
        pred = anc[None, :] + p_loc @ R.T
        anc = anc + np.mean(fixes - pred, axis=0)
    return anc, True


def gnss_vi_align(local_pos, local_vels, epochs, iono_paras=None,
                  min_speed: float = 0.3):
    """Full GNSSVIAlign (estimator.cpp:1928-2043): coarse SPP → yaw GN →
    anchor refinement. Requires motion (velocity gate, :1953-1962). Returns
    (anc_ecef [3], yaw, rcv_dt0 [4], ok)."""
    speeds = np.linalg.norm(np.asarray(local_vels)[:, 0:2], axis=1)
    if speeds.max() < min_speed:
        return np.zeros(3), 0.0, np.zeros(4), False
    anc, rcv_dt, ok = coarse_localization(epochs, iono_paras)
    if not ok:
        return np.zeros(3), 0.0, np.zeros(4), False
    yaw, ok = yaw_alignment(local_vels, epochs, anc)
    if not ok:
        return anc, 0.0, rcv_dt, False
    anc, ok = anchor_refinement(local_pos, yaw, epochs, anc, iono_paras)
    return anc, yaw, rcv_dt, ok
