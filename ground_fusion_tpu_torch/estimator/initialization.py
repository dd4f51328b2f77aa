"""Initialization: gyro-bias solve, the four linear alignments (wheel,
mono, depth, wheel+depth), gravity refinement, stationary/dynamic bootstrap,
hand-eye extrinsic rotation calibration.

Re-design of ``initial/initial_aligment.cpp`` (solveGyroscopeBias
:14-47, TangentBasis :49-63, LinearAlignment :199-280,
LinearAlignmentWithWheel :353-424, RefineGravityWithWheel-family :426-497,
LinearAlignmentWithWD :499-572, LinearAlignmentWithDepth :574-638),
``initial/initial_ex_rotation.cpp`` and the stationary / wheel-activation
paths of ``Estimator::initialStructure`` (``estimator.cpp:1604-1682``): every
per-frame loop becomes a batched least-squares plus one dense solve — these
run once at bootstrap, so clarity > tuning.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..geometry.so3 import (
    _cross,
    g2r,
    left_quat_prod_mat,
    mat_to_quat,
    mat_to_ypr,
    quat_conj,
    quat_identity,
    quat_mul,
    quat_to_mat,
    right_quat_prod_mat,
    ypr_to_mat,
)
from ..preintegration.imu import ImuPreint
from ..preintegration.wheel import WheelPreint, identity_wheel_preint
from .window import WindowState


def solve_gyroscope_bias(quats: Tensor, pre: ImuPreint, valid: Tensor) -> Tensor:
    """Linear LS for the gyro-bias increment (initial_aligment.cpp:14-47):
    rows 2·vec(Δq⁻¹ ⊗ (qᵢ⁻¹ qⱼ)) = J_{q,bg} · δbg over adjacent frame pairs.

    quats: [N,4] body orientations; pre: axis-N preints (slot k = (k-1,k]);
    valid: [N] interval validity."""
    q_i, q_j = quats[:-1], quats[1:]
    q_ij = quat_mul(quat_conj(q_i), q_j)
    Jq = pre.jacobian[1:, 3:6, 12:15]                       # [N-1,3,3]
    rhs = 2.0 * quat_mul(quat_conj(pre.delta_q[1:]), q_ij)[:, 1:4]
    w = valid[1:].to(quats.dtype)[:, None]
    Jw = Jq * w[..., None]
    A = torch.einsum("kij,kil->jl", Jw, Jq)
    b = torch.einsum("kij,ki->j", Jw, rhs)
    eye = torch.eye(3, dtype=quats.dtype, device=quats.device)
    return torch.linalg.solve(A + 1e-10 * eye, b)


def tangent_basis(g0: Tensor) -> Tensor:
    """Two unit vectors spanning g0's orthogonal complement
    (initial_aligment.cpp:49-63), branch-free."""
    a = g0 / torch.linalg.norm(g0)
    kw = dict(dtype=g0.dtype, device=g0.device)
    tmp = torch.where(torch.abs(a[2]) > 0.9999,
                      torch.tensor([1.0, 0.0, 0.0], **kw),
                      torch.tensor([0.0, 0.0, 1.0], **kw))
    b = tmp - a * torch.dot(a, tmp)
    b = b / torch.linalg.norm(b)
    c = _cross(a, b)
    return torch.stack([b, c], dim=-1)                        # [3,2]


def _alignment_blocks(Rs, Ts, imu_pre, wheel_pre, tic, tio, rio_mat):
    """The shared 9-row measurement blocks of the wheel linear alignment
    (initial_aligment.cpp:370-391): rows 0-2 position, 3-5 velocity,
    6-8 wheel-position. Returns per-pair (A9 [N-1,9,10], b9 [N-1,9]) against
    unknowns [v_i(3), v_j(3), g(3), s(1)] (s scaled by 1/100)."""
    n = Rs.shape[0]
    kw = dict(dtype=Rs.dtype, device=Rs.device)
    R_i, R_j = Rs[:-1], Rs[1:]
    T_i, T_j = Ts[:-1], Ts[1:]
    dt = imu_pre.sum_dt[1:][:, None, None]
    RiT = R_i.mT
    I3 = torch.eye(3, **kw).expand(R_i.shape)

    dT = torch.einsum("kij,kj->ki", RiT, T_j - T_i)
    A = torch.zeros((n - 1, 9, 10), **kw)
    b = torch.zeros((n - 1, 9), **kw)
    A[:, 0:3, 0:3] = -dt * I3
    A[:, 0:3, 6:9] = RiT * 0.5 * dt * dt
    A[:, 0:3, 9] = dT / 100.0
    b[:, 0:3] = (
        imu_pre.delta_p[1:]
        + torch.einsum("kij,j->ki", RiT @ R_j, tic)
        - tic[None, :]
    )
    A[:, 3:6, 0:3] = -I3
    A[:, 3:6, 3:6] = RiT @ R_j
    A[:, 3:6, 6:9] = RiT * dt
    b[:, 3:6] = imu_pre.delta_v[1:]

    RioT = rio_mat.T
    RiwT = (R_i @ rio_mat).mT                                # (R_i RIO)^T
    A[:, 6:9, 9] = torch.einsum("kij,kj->ki", RiwT, T_j - T_i) / 100.0
    b[:, 6:9] = (
        wheel_pre.delta_p[1:]
        - torch.einsum("ij,kjl,l->ki", RioT, RiT @ R_j, tio)
        + torch.einsum("kij,kjl,l->ki", RiwT, R_j, tic)
        - (RioT @ (tic - tio))[None, :]
    )
    return A, b


def _solve_banded(A9, b9, n, tail_dim):
    """Scatter the per-pair blocks into the dense (3n + tail) normal system
    and solve (initial_aligment.cpp:398-414)."""
    kw = dict(dtype=A9.dtype, device=A9.device)
    ns = 3 * n + tail_dim
    H = torch.zeros((ns, ns), **kw)
    g = torch.zeros((ns,), **kw)
    rA = torch.einsum("kri,krj->kij", A9, A9)                # [N-1,10,10]
    rb = torch.einsum("kri,kr->ki", A9, b9)
    tail = 3 * n + torch.arange(tail_dim, device=A9.device)
    six = torch.arange(6, device=A9.device)
    for i in range(A9.shape[0]):
        idx = torch.cat([3 * i + six, tail])
        H.index_put_((idx[:, None], idx[None, :]), rA[i], accumulate=True)
        g.index_add_(0, idx, rb[i])
    return torch.linalg.solve(H * 1000.0 + 1e-8 * torch.eye(ns, **kw), g * 1000.0)


def _alignment_solve(A9, b9, n, g_norm, use_wheel: bool, use_scale: bool,
                     refine_iters: int = 4):
    """Shared solve + tangent-space gravity refinement for the
    ``LinearAlignment*`` variants (initial_aligment.cpp:199-653 dispatch:
    they differ only in which rows exist and whether scale is a variable)."""
    A9, b9 = A9.clone(), b9.clone()
    one = torch.ones((), dtype=A9.dtype, device=A9.device)
    if not use_wheel:
        A9[:, 6:9, :] = 0.0
        b9[:, 6:9] = 0.0
    if not use_scale:
        # scale known = 1: move the (column × 100·s) term to the rhs
        b9 = b9 - 100.0 * A9[:, :, 9]
        A9[:, :, 9] = 0.0

    x = _solve_banded(A9, b9, n, 4)
    g_est = x[3 * n : 3 * n + 3]
    s = x[3 * n + 3] / 100.0 if use_scale else one
    ok = torch.abs(torch.linalg.norm(g_est) - g_norm) < 0.5
    if use_scale:
        ok = ok & (s >= 0)

    g_ref, vels_flat, s_ref = g_est, x[: 3 * n], s
    for _ in range(refine_iters):
        g0 = g_ref / torch.linalg.norm(g_ref) * g_norm
        lxly = tangent_basis(g0)                              # [3,2]
        A8 = torch.cat(
            [A9[:, :, 0:6], torch.einsum("krj,jl->krl", A9[:, :, 6:9], lxly),
             A9[:, :, 9:10]],
            dim=-1,
        )                                                    # [N-1,9,9]
        b8 = b9 - torch.einsum("krj,j->kr", A9[:, :, 6:9], g0)
        x = _solve_banded(A8, b8, n, 3)
        dg = x[3 * n : 3 * n + 2]
        g1 = g0 + lxly @ dg
        g_ref = g1 / torch.linalg.norm(g1) * g_norm
        vels_flat = x[: 3 * n]
        s_ref = x[3 * n + 2] / 100.0 if use_scale else one
    vels = vels_flat.reshape(n, 3)
    if use_scale:
        ok = ok & (s_ref >= 0)
    return ok, g_ref, vels, s_ref


def linear_alignment_wheel(Rs, Ts, imu_pre: ImuPreint, wheel_pre: WheelPreint,
                           tic, tio, rio_mat, g_norm: float, refine_iters: int = 4):
    """Wheel-aided velocity/gravity/scale alignment (LinearAlignmentWithWheel
    + RefineGravityWithWheel, initial_aligment.cpp:353-497).

    Rs [N,3,3], Ts [N,3] — frame body rotations/positions (from wheel odometry
    or SfM). Returns (ok, g_world [3], velocities_body [N,3], scale)."""
    A9, b9 = _alignment_blocks(Rs, Ts, imu_pre, wheel_pre, tic, tio, rio_mat)
    return _alignment_solve(A9, b9, Rs.shape[0], g_norm,
                            use_wheel=True, use_scale=True,
                            refine_iters=refine_iters)


def _no_wheel_blocks(Rs, Ts, imu_pre, tic):
    """The alignment blocks of a rig without a wheel: identity wheel
    preintegrations, zero wheel mount (their rows are dropped by the solve)."""
    n = Rs.shape[0]
    wp = WheelPreint(*[torch.stack([a] * n)
                       for a in identity_wheel_preint(Rs.dtype, Rs.device)])
    zero = torch.zeros(3, dtype=Rs.dtype, device=Rs.device)
    eye = torch.eye(3, dtype=Rs.dtype, device=Rs.device)
    return _alignment_blocks(Rs, Ts, imu_pre, wp, tic, zero, eye)


def linear_alignment_mono(Rs, Ts, imu_pre: ImuPreint, tic, g_norm: float):
    """Monocular-visual alignment with unknown scale (LinearAlignment,
    initial_aligment.cpp:199-280)."""
    A9, b9 = _no_wheel_blocks(Rs, Ts, imu_pre, tic)
    return _alignment_solve(A9, b9, Rs.shape[0], g_norm, use_wheel=False, use_scale=True)


def linear_alignment_depth(Rs, Ts, imu_pre: ImuPreint, tic, g_norm: float):
    """RGBD alignment — metric scale known (LinearAlignmentWithDepth,
    initial_aligment.cpp:574-638)."""
    A9, b9 = _no_wheel_blocks(Rs, Ts, imu_pre, tic)
    return _alignment_solve(A9, b9, Rs.shape[0], g_norm, use_wheel=False, use_scale=False)


def linear_alignment_wd(Rs, Ts, imu_pre: ImuPreint, wheel_pre: WheelPreint,
                        tic, tio, rio_mat, g_norm: float):
    """Wheel + depth alignment — wheel rows, metric scale known
    (LinearAlignmentWithWD, initial_aligment.cpp:499-572)."""
    A9, b9 = _alignment_blocks(Rs, Ts, imu_pre, wheel_pre, tic, tio, rio_mat)
    return _alignment_solve(A9, b9, Rs.shape[0], g_norm, use_wheel=True, use_scale=False)


def stationary_bias_init(acc_mean: Tensor, gyr_mean: Tensor, g_norm: float):
    """Stationary bootstrap (``estimator.cpp:1604-1643``): accel bias from the
    gravity-aligned mean specific force, gyro bias = mean gyro rate."""
    G = torch.tensor([0.0, 0.0, g_norm], dtype=acc_mean.dtype, device=acc_mean.device)
    R0 = g2r(acc_mean)                                       # world_R_body, yaw-free
    ba = acc_mean - R0.T @ G
    return ba, gyr_mean, R0


def align_window_to_gravity(state: WindowState, g_est: Tensor, vels_body: Tensor,
                            g_norm: float) -> WindowState:
    """Rotate the whole window so gravity is +z with frame-0 yaw zeroed, and
    install the aligned velocities (``estimator.cpp:1657-1677`` and
    visualInitialAlign ``:1849-1926``)."""
    R0 = g2r(g_est)
    R_b0 = quat_to_mat(state.poses[0, 3:7])
    ypr = mat_to_ypr(R0 @ R_b0)
    zero = torch.zeros_like(ypr[0])
    un = ypr_to_mat(torch.stack([-ypr[0], zero, zero]))
    rot_diff = un @ R0

    Rs = quat_to_mat(state.poses[:, 3:7])
    new_R = rot_diff @ Rs
    new_p = state.poses[:, 0:3] @ rot_diff.T
    v_world = (new_R @ vels_body[..., None])[..., 0]
    poses = torch.cat([new_p, mat_to_quat(new_R)], dim=-1)
    sbs = torch.cat([v_world, state.sbs[:, 3:]], dim=-1)
    return state._replace(poses=poses, sbs=sbs)


def calibrate_extrinsic_rotation(q_cam: Tensor, q_imu: Tensor, valid: Tensor, iters: int = 5):
    """Online camera–IMU rotation hand-eye calibration
    (``InitialEXRotation::CalibrationExRotation``,
    ``initial/initial_ex_rotation.cpp:22-79``, the ESTIMATE_EXTRINSIC=2
    bootstrap): each frame pair contributes ``Qleft(q_cam) − Qright(q_imu)``
    (the constraint ``q_cam ⊗ x = x ⊗ q_imu``), Huber-downweighted by the
    angular disagreement (deg, knee at 5°) between the camera rotation and
    the IMU rotation conjugated into the camera frame by the current
    estimate. The whole batch is linearized at once and the reweight→solve
    cycle runs ``iters`` fixed Picard iterations; the 4x4 normal matrix is
    eigendecomposed in place of an SVD of the tall stack (same null space).

    q_cam, q_imu: [N,4] wxyz relative rotations of the same frame pairs
    (camera from ``sfm.relative_pose_ransac``, IMU preintegrated); valid [N].
    Returns (ric [3,3], ok) — ok is the reference's observability gate
    ``ric_cov(1) > 0.25`` (second-smallest singular value of the weighted
    stack) with at least 10 pairs."""
    dtype = q_cam.dtype
    w_valid = valid.to(dtype)
    q_ric = quat_identity(dtype, q_cam.device)
    sv2 = None
    for _ in range(iters):
        # IMU rotation seen from the camera frame under the current estimate
        q_cg = quat_mul(quat_mul(quat_conj(q_ric)[None, :], q_imu), q_ric[None, :])
        dot = torch.clamp(torch.abs(torch.sum(q_cam * q_cg, dim=-1)), 0.0, 1.0)
        ang_deg = torch.rad2deg(2.0 * torch.arccos(dot))
        huber = torch.where(ang_deg > 5.0, 5.0 / torch.clamp(ang_deg, min=1e-9),
                            torch.ones_like(ang_deg))
        w = (huber * w_valid)[:, None, None]
        A = w * (left_quat_prod_mat(q_cam) - right_quat_prod_mat(q_imu))     # [N,4,4]
        eigval, eigvec = torch.linalg.eigh(torch.einsum("nij,nik->jk", A, A))  # ascending
        x = eigvec[:, 0]
        x = x * torch.sign(torch.where(torch.abs(x[0]) > 1e-12, x[0], torch.ones_like(x[0])))
        # q_cam ⊗ x = x ⊗ q_imu  →  ric = R(x)⁻¹ (reference: estimated_R.inverse())
        q_ric = quat_conj(x / torch.linalg.norm(x))
        sv2 = torch.sqrt(torch.clamp(eigval[1], min=0.0))   # second-smallest singular value
    ok = (sv2 > 0.25) & (valid.sum() >= 10)
    return quat_to_mat(q_ric), ok
