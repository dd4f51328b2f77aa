"""Synthetic ground-robot trajectory + sensor simulator (float64, CPU).

The reference's integration tests are rosbag replays (``README.md:146-186``);
no bags are redistributable here, so this module is the correctness oracle:
an analytic smooth trajectory differentiated with forward-mode autodiff
produces exact IMU (accel/gyro with gravity and biases), wheel velocity, and
feature-track measurements, and the estimator's output is compared against
the closed-form ground truth (ATE/RPE). Everything here is host-side set-up
data, computed in float64 on the CPU whatever device the estimator uses.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.func import jacfwd, vmap

from ..geometry.se3 import pose, pose_apply_inv, pose_compose
from ..geometry.so3 import mat_to_quat, ypr_to_mat

F64 = torch.float64


class SimParams(NamedTuple):
    radius: float = 3.0
    omega: float = 0.4          # rad/s around the circle
    z_amp: float = 0.0          # vertical bounce amplitude
    g_norm: float = 9.805
    imu_rate: float = 200.0
    wheel_rate: float = 100.0
    frame_rate: float = 10.0
    ba: tuple = (0.02, -0.01, 0.03)
    bg: tuple = (0.001, -0.002, 0.0015)
    acc_noise: float = 0.0
    gyr_noise: float = 0.0
    pix_noise: float = 0.0      # normalized-plane observation noise
    seed: int = 0
    # --- adversarial-scenario extensions (all default-off; defaults keep the
    # trajectory identical to the constant-speed circle) ---
    # smooth stop-and-go: angular speed ramps to 0 over [stop_t1, stop_t2]
    # with tanh ramps of width stop_tau (the phase integral is closed-form
    # via log-cosh, so IMU/wheel samples stay exact autodiff derivatives)
    stop_t1: float = 0.0
    stop_t2: float = 0.0        # disabled while stop_t2 <= stop_t1
    stop_tau: float = 0.2
    # speed modulation: phase += mod_amp * sin(mod_freq * t)
    omega_mod_amp: float = 0.0
    omega_mod_freq: float = 0.5
    # wheel slip: the wheel odometer REPORTS extra body-frame velocity
    # slip_v during [slip_t1, slip_t2] while the body does not move that way
    slip_t1: float = 0.0
    slip_t2: float = 0.0        # disabled while slip_t2 <= slip_t1
    slip_v: tuple = (0.0, 0.0, 0.0)
    slip_tau: float = 0.05


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=F64)


def body_T_cam(dtype=F64) -> torch.Tensor:
    """Forward-looking camera: cam z = body +x, cam x = body −y, cam y = −z."""
    R = torch.tensor([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]], dtype=dtype).T
    return pose(torch.zeros(3, dtype=dtype), mat_to_quat(R))


def _logcosh(x):
    """Overflow-safe log(cosh(x)) = |x| + softplus(-2|x|) - log 2."""
    a = torch.abs(x)
    return a + torch.log1p(torch.exp(-2.0 * a)) - math.log(2.0)


def _phase_of_t(t, sp: SimParams):
    """Angular phase φ(t) along the circle. Constant-speed by default;
    stop-and-go and speed modulation enter as closed-form phase terms so
    every sensor sample stays an exact autodiff derivative:

    φ̇ = ω·s(t) with s(t) = 1 − ½[tanh((t−t1)/τ) − tanh((t−t2)/τ)]
    ⇒ φ = ω·(t − ½τ[logcosh((t−t1)/τ) − logcosh((t−t2)/τ)])
    """
    phi = sp.omega * t
    if sp.stop_t2 > sp.stop_t1:                       # static Python gate
        tau = sp.stop_tau
        phi = sp.omega * (
            t - 0.5 * tau * (_logcosh((t - sp.stop_t1) / tau)
                             - _logcosh((t - sp.stop_t2) / tau))
        )
    if sp.omega_mod_amp != 0.0:
        phi = phi + sp.omega_mod_amp * torch.sin(sp.omega_mod_freq * t)
    return phi


def _p_of_t(t, sp: SimParams):
    phi = _phase_of_t(t, sp)
    return torch.stack(
        [
            sp.radius * torch.cos(phi),
            sp.radius * torch.sin(phi),
            sp.z_amp * torch.sin(0.5 * t),
        ]
    )


def _ypr_of_t(t, sp: SimParams):
    yaw = _phase_of_t(t, sp) + math.pi / 2.0
    return torch.stack([yaw, torch.zeros_like(t), torch.zeros_like(t)])


def gt_pose(t, sp: SimParams):
    """Ground-truth body pose at time t (body x = direction of travel)."""
    t = _t(t)
    p = _p_of_t(t, sp)
    R = ypr_to_mat(_ypr_of_t(t, sp))
    return p, R


def gt_pose7(t, sp: SimParams):
    p, R = gt_pose(t, sp)
    return pose(p, mat_to_quat(R))


def _body_rates(t, sp: SimParams):
    """(R, world velocity, world acceleration, body angular rate) at t."""
    v = jacfwd(lambda s: _p_of_t(s, sp))(t)
    a = jacfwd(lambda s: jacfwd(lambda u: _p_of_t(u, sp))(s))(t)
    R = ypr_to_mat(_ypr_of_t(t, sp))
    Rdot = jacfwd(lambda s: ypr_to_mat(_ypr_of_t(s, sp)))(t)
    omega_hat = R.T @ Rdot
    gyr = torch.stack([omega_hat[2, 1], omega_hat[0, 2], omega_hat[1, 0]])
    return R, v, a, gyr


def imu_sample(t, sp: SimParams):
    """Exact IMU measurement at time t via autodiff of the trajectory:
    acc = Rᵀ(p̈ + G e3), gyr = vee(Rᵀ Ṙ) + bg."""
    R, _, a, gyr = _body_rates(_t(t), sp)
    G = torch.tensor([0.0, 0.0, sp.g_norm], dtype=F64)
    acc = R.T @ (a + G)
    return acc + _t(sp.ba), gyr + _t(sp.bg)


def wheel_sample(t, sp: SimParams):
    """Body-frame velocity + gyro (the wheel odometer's measurement model,
    ``rosNodeTest.cpp:81-188``). A configured slip window adds phantom
    body-frame velocity the body never had — the wheels-spinning-in-place
    corner case the anomaly gate exists for (``estimator.cpp:629-654``)."""
    t = _t(t)
    R, v, _, gyr = _body_rates(t, sp)
    v_body = R.T @ v
    if sp.slip_t2 > sp.slip_t1:                       # static Python gate
        box = 0.5 * (torch.tanh((t - sp.slip_t1) / sp.slip_tau)
                     - torch.tanh((t - sp.slip_t2) / sp.slip_tau))
        v_body = v_body + box * _t(sp.slip_v)
    return v_body, gyr


def imu_samples(ts, sp: SimParams):
    """:func:`imu_sample` over a vector of times → (acc [N,3], gyr [N,3])."""
    return vmap(lambda t: imu_sample(t, sp))(_t(ts))


def wheel_samples(ts, sp: SimParams):
    """:func:`wheel_sample` over a vector of times → (vel [N,3], gyr [N,3])."""
    return vmap(lambda t: wheel_sample(t, sp))(_t(ts))


def gt_velocity(t, sp: SimParams):
    return jacfwd(lambda s: _p_of_t(s, sp))(_t(t))


def make_landmarks(n: int, sp: SimParams, seed: int = 1) -> np.ndarray:
    """Points on an outer cylinder around the circular path (always in front
    of the forward-looking camera)."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = sp.radius + rng.uniform(1.0, 3.0, n)
    z = rng.uniform(-1.0, 2.0, n)
    return np.stack([rad * np.cos(ang), rad * np.sin(ang), z], axis=-1)


def project_landmarks(pose7, ex_cam, pts_w):
    """Normalized-plane observations + depth for all landmarks from one pose.
    Returns (uv [N,2], depth [N], visible [N])."""
    cam = pose_compose(pose7, ex_cam)
    pc = pose_apply_inv(cam, pts_w)
    z = pc[..., 2]
    uv = pc[..., 0:2] / torch.clamp(z[..., None], min=1e-6)
    visible = (z > 0.3) & (torch.abs(uv[..., 0]) < 0.9) & (torch.abs(uv[..., 1]) < 0.7)
    return uv, z, visible


def make_segments(n: int, sp: SimParams, seed: int = 2) -> np.ndarray:
    """World 3-D line segments on the outer cylinder (mostly vertical poles
    plus slanted edges) — the structural lines a LSD detector would find.
    Returns endpoints [n, 2, 3]."""
    rng = np.random.default_rng(seed)
    ang = rng.uniform(0, 2 * np.pi, n)
    rad = sp.radius + rng.uniform(1.5, 3.0, n)
    base = np.stack([rad * np.cos(ang), rad * np.sin(ang), rng.uniform(-1.0, 0.5, n)], axis=-1)
    d = rng.normal(size=(n, 3))
    d[: n // 2] = np.array([0.0, 0.0, 1.0])     # poles
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return np.stack([base, base + 1.5 * d], axis=1)


def project_segments(pose7, ex_cam, segs_w):
    """Normalized-plane segment observations from one pose: obs4 [N,4]
    (x1, y1, x2, y2) and visibility (both endpoints in front and in the
    field of view)."""
    cam = pose_compose(pose7, ex_cam)
    pa = pose_apply_inv(cam, segs_w[:, 0])
    pb = pose_apply_inv(cam, segs_w[:, 1])
    za, zb = pa[..., 2], pb[..., 2]
    ua = pa[..., 0:2] / torch.clamp(za[..., None], min=1e-6)
    ub = pb[..., 0:2] / torch.clamp(zb[..., None], min=1e-6)
    vis = ((za > 0.3) & (zb > 0.3)
           & (torch.abs(ua[..., 0]) < 0.9) & (torch.abs(ua[..., 1]) < 0.7)
           & (torch.abs(ub[..., 0]) < 0.9) & (torch.abs(ub[..., 1]) < 0.7))
    return torch.cat([ua, ub], dim=-1), vis
