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


def _padded_interval(t0, t1, rate: float, cap: int, what: str, samples, sample):
    """``samples(ts)`` at ``rate`` over (t0, t1], padded to ``cap``, and
    ``sample(t0)``: (dts [cap], a [cap,3], b [cap,3], valid [cap], a0, b0),
    NumPy float64."""
    dt = 1.0 / rate
    ts = np.arange(t0 + dt, t1 + 0.5 * dt, dt)
    k = len(ts)
    assert k <= cap, f"{what} interval needs {k} > cap {cap}"
    a, b = (x.numpy() for x in samples(ts)) if k else (np.zeros((0, 3)), np.zeros((0, 3)))
    a0, b0 = (x.numpy() for x in sample(t0))
    dts = np.full(cap, 0.0)
    dts[:k] = np.diff(np.concatenate([[t0], ts]))
    out_a, out_b = np.zeros((cap, 3)), np.zeros((cap, 3))
    out_a[:k], out_b[:k] = a, b
    valid = np.zeros(cap, bool)
    valid[:k] = True
    return dts, out_a, out_b, valid, a0, b0


def imu_interval(t0, t1, sp: SimParams, cap: int, rng=None):
    """Padded IMU samples covering (t0, t1]: returns (dts[K], acc[K,3],
    gyr[K,3], valid[K], acc0, gyr0) — the shape the window buffers take —
    as NumPy float64; with ``acc_noise`` and an ``rng``, noise is added to
    the samples after t0, drawn as the JAX package draws it."""
    dts, acc, gyr, valid, acc0, gyr0 = _padded_interval(
        t0, t1, sp.imu_rate, cap, "IMU", lambda ts: imu_samples(ts, sp),
        lambda t: imu_sample(t, sp))
    k = int(valid.sum())
    if rng is not None and sp.acc_noise > 0:
        acc[:k] = acc[:k] + rng.normal(0, sp.acc_noise, (k, 3))
        gyr[:k] = gyr[:k] + rng.normal(0, sp.gyr_noise, (k, 3))
    return dts, acc, gyr, valid, acc0, gyr0


def wheel_interval(t0, t1, sp: SimParams, cap: int, rng=None):
    """Padded wheel samples covering (t0, t1]: (dts[K], vel[K,3], gyr[K,3],
    valid[K], vel0, gyr0), NumPy float64 (the wheel takes no noise)."""
    return _padded_interval(t0, t1, sp.wheel_rate, cap, "wheel",
                            lambda ts: wheel_samples(ts, sp), lambda t: wheel_sample(t, sp))


def build_window_problem(cfg, sp: SimParams, t_start: float = 0.0, dtype=F64, device=None):
    """A ground-truth window: exact poses, velocities and biases, feature
    tracks from projected landmarks, and padded IMU/wheel buffers — the
    standing fixture of the solver and marginalization tests, as the JAX
    package's ``build_window_problem`` builds it from the same ``cfg``,
    ``sp`` and seeds. Computed in float64 on the CPU, then moved to
    ``dtype`` on ``device`` (``None``: the GPU). Returns a dict of
    ``state``, ``tracks``, ``imu_buf``, ``wheel_buf``, ``interval_valid``,
    ``ts`` (NumPy), ``pts_w`` and ``ex_cam``."""
    from .. import resolve_device
    from ..estimator.buffers import ImuWindowBuffer, WheelWindowBuffer
    from ..estimator.window import Tracks, empty_state

    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    f = cfg.num_frames
    ml = cfg.solver.max_landmarks
    ts = t_start + np.arange(f) * (1.0 / sp.frame_rate)

    ex = body_T_cam(dtype)
    poses = vmap(lambda t: gt_pose7(t, sp))(_t(ts)).to(dtype)
    vels = vmap(lambda t: gt_velocity(t, sp))(_t(ts))
    sbs = torch.cat([vels, _t(sp.ba).expand(f, 3), _t(sp.bg).expand(f, 3)], dim=-1)
    state = empty_state(f, **kw)._replace(poses=poses.to(dev), sbs=sbs.to(**kw), ex_cam=ex.to(dev))

    # landmarks -> tracks, projected in ``dtype`` as in the JAX package
    pts_w = _t(make_landmarks(ml, sp, seed=sp.seed + 1)).to(dtype)
    uv, z, vis = vmap(lambda p7: project_landmarks(p7, ex, pts_w))(poses)
    uv, z, vis = uv.transpose(0, 1), z.transpose(0, 1), vis.transpose(0, 1).numpy()   # [ML, F, ·]
    rng = np.random.default_rng(sp.seed + 2)
    if sp.pix_noise > 0:
        uv = uv + torch.as_tensor(rng.normal(0, sp.pix_noise, tuple(uv.shape)), dtype=dtype)
    start_frame = np.argmax(vis, axis=1)
    active = torch.as_tensor(vis.sum(axis=1) >= 4)
    obs = torch.cat([uv, torch.zeros((ml, f, 2), dtype=dtype), z[..., None]], dim=-1)
    anchor_z = z[torch.arange(ml), torch.as_tensor(start_frame)]
    vis_t = torch.as_tensor(vis)
    tracks = Tracks(
        inv_depth=1.0 / torch.clamp(anchor_z, min=1e-3),
        active=active,
        solve_ok=active.clone(),
        depth_fixed=torch.zeros(ml, dtype=torch.bool),
        start_frame=torch.as_tensor(start_frame, dtype=torch.int64),
        obs=obs * vis_t.to(dtype)[..., None],
        obs_valid=vis_t,
    )
    tracks = Tracks(*[t.to(dev) for t in tracks])

    # sensor buffers
    ibuf, wbuf = [], []
    for k in range(f):
        t0 = ts[k - 1] if k > 0 else ts[0]
        t1 = ts[k] if k > 0 else ts[0]
        ibuf.append(imu_interval(t0, t1, sp, cfg.solver.max_imu_per_interval, rng))
        wbuf.append(wheel_interval(t0, t1, sp, cfg.solver.max_wheel_per_interval, rng))

    def stacked(rows, i):
        x = np.stack([r[i] for r in rows])
        return torch.as_tensor(x, device=dev) if x.dtype == bool else torch.as_tensor(x).to(**kw)

    imu_buf = ImuWindowBuffer(*[stacked(ibuf, i) for i in range(6)])
    wheel_buf = WheelWindowBuffer(*[stacked(wbuf, i) for i in range(6)],
                                  bad=torch.zeros(f, dtype=torch.bool, device=dev))
    return dict(state=state, tracks=tracks, imu_buf=imu_buf, wheel_buf=wheel_buf,
                interval_valid=torch.as_tensor(np.arange(f) >= 1, device=dev), ts=ts,
                pts_w=pts_w.to(dev), ex_cam=ex.to(dev))
