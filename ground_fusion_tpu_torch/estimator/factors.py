"""Factor library: residuals + tangent-space Jacobians, batched.

Each factor is a pure residual function of the *parameter values*; Jacobians
are taken with ``torch.func.jacfwd`` against a tangent perturbation at zero,
which reproduces the reference's analytic manifold Jacobians exactly (same ⊞:
``p + δp, q ⊗ deltaQ(δθ)``) without hand-deriving them. The residual
functions broadcast over leading batch axes; the ``*_factor`` functions take
one factor's (unbatched) arguments and are batched by ``torch.func.vmap`` in
:mod:`.assembly`.

Reference cost functions reproduced here:
- IMU:     ``factor/imu_factor.h`` <15,7,9,7,9> (residual via
           ``integration_base.h:169-195``)
- Visual:  ``factor/projectionTwoFrameOneCamFactor.cpp:44-106`` (td-aware)
- Wheel:   ``factor/wheel_factor.h`` <6,7,7,7,1,1,1,1> (residual via
           ``wheel_integration_base.h:180-219``)
- Plane:   ``factor/plane_factor.h:26-56``
- Anchors: ``pose_anchor_factor.{h,cpp}``, ``initial_pose_factor.h``,
           ``initial_bias_factor.h``, ``pos_vel_factor.{hpp,cpp}``,
           ``motion_factor.h``

All residuals return *whitened* values (pre-multiplied by sqrt information),
matching how the reference feeds Ceres. The stereo projection forms
(``projectionTwoFrameTwoCamFactor``, ``projectionOneFrameTwoCamFactor``) are
here as in the JAX package; no step calls them in either package (the stereo
front end feeds depth through ``proj21``).
"""

from __future__ import annotations

import torch
from torch import Tensor
from torch.func import jacfwd

from ..geometry.se3 import pose_boxplus, rot, trans
from ..geometry.so3 import (
    quat_conj,
    quat_exp,
    quat_mul,
    quat_rotate,
    quat_rotate_inv,
)
from ..preintegration.imu import ImuPreint, bias_corrected_delta
from ..preintegration.wheel import WheelPreint, wheel_corrected_delta, wheel_residual_from_delta


# ---------------------------------------------------------------------------
# sqrt-information helpers
# ---------------------------------------------------------------------------


def sqrt_info_from_cov(P: Tensor, eps: float = 1e-8) -> Tensor:
    """S such that Sᵀ S = P⁻¹ (the reference uses LLT of P⁻¹,
    imu_factor.h Evaluate). Computed as L⁻¹ from P = L Lᵀ for stability.
    A covariance that is not positive definite gives NaN, not an exception."""
    n = P.shape[-1]
    eye = torch.eye(n, dtype=P.dtype, device=P.device)
    L, info = torch.linalg.cholesky_ex(P + eps * eye)
    S = torch.linalg.solve_triangular(L, eye.expand(P.shape), upper=False)
    return torch.where((info == 0)[..., None, None], S, torch.full_like(S, float("nan")))


def _jac_and_value(r_of, z):
    """(r(z), dr/dz at z) from one forward-mode pass."""
    J, r = jacfwd(lambda d: (lambda v: (v, v))(r_of(d)), has_aux=True)(z)
    return r, J


# ---------------------------------------------------------------------------
# IMU factor (15-dim)
# ---------------------------------------------------------------------------


def imu_residual_raw(pose_i, sb_i, pose_j, sb_j, pre: ImuPreint, g):
    """Unwhitened 15-dim residual (integration_base.h:169-195).

    sb = [v(3), ba(3), bg(3)]."""
    pi, qi = trans(pose_i), rot(pose_i)
    pj, qj = trans(pose_j), rot(pose_j)
    vi, bai, bgi = sb_i[..., 0:3], sb_i[..., 3:6], sb_i[..., 6:9]
    vj, baj, bgj = sb_j[..., 0:3], sb_j[..., 3:6], sb_j[..., 6:9]
    dt = pre.sum_dt[..., None]

    cp, cq, cv = bias_corrected_delta(pre, bai, bgi)
    r_p = quat_rotate_inv(qi, 0.5 * g * dt * dt + pj - pi - vi * dt) - cp
    r_q = 2.0 * quat_mul(quat_conj(cq), quat_mul(quat_conj(qi), qj))[..., 1:4]
    r_v = quat_rotate_inv(qi, g * dt + vj - vi) - cv
    return torch.cat([r_p, r_q, r_v, baj - bai, bgj - bgi], dim=-1)


def imu_factor(pose_i, sb_i, pose_j, sb_j, pre: ImuPreint, g):
    """Whitened residual + Jacobians wrt tangent [δpose_i(6), δsb_i(9),
    δpose_j(6), δsb_j(9)]. Returns (r[15], J[15, 30])."""
    S = sqrt_info_from_cov(pre.covariance)

    def r_of(delta):
        d_pi, d_si, d_pj, d_sj = delta[0:6], delta[6:15], delta[15:21], delta[21:30]
        return S @ imu_residual_raw(
            pose_boxplus(pose_i, d_pi), sb_i + d_si,
            pose_boxplus(pose_j, d_pj), sb_j + d_sj, pre, g,
        )

    return _jac_and_value(r_of, torch.zeros(30, dtype=pose_i.dtype, device=pose_i.device))


# ---------------------------------------------------------------------------
# Visual projection factor (2-dim, td-aware, one camera two frames)
# ---------------------------------------------------------------------------


def proj21_residual_raw(pose_i, pose_j, ex, inv_dep, td, pts_i, pts_j, vel_i, vel_j, td_i, td_j):
    """projectionTwoFrameOneCamFactor.cpp:59-77 — unwhitened 2-dim residual.

    pts are normalized-plane observations [x, y, 1]; vel are feature image
    velocities (z comp = 0); td the online time offset. ``inv_dep``, ``td``,
    ``td_i`` and ``td_j`` carry a trailing axis of length 1 when batched
    (``[..., 1]``) or are scalars for a single factor."""
    tic, qic = trans(ex), rot(ex)
    pts_i_td = pts_i - (td - td_i) * vel_i
    pts_j_td = pts_j - (td - td_j) * vel_j
    pts_cam_i = pts_i_td / inv_dep
    pts_imu_i = quat_rotate(qic, pts_cam_i) + tic
    pts_w = quat_rotate(rot(pose_i), pts_imu_i) + trans(pose_i)
    pts_imu_j = quat_rotate_inv(rot(pose_j), pts_w - trans(pose_j))
    pts_cam_j = quat_rotate_inv(qic, pts_imu_j - tic)
    dep_j = pts_cam_j[..., 2:3]
    return pts_cam_j[..., 0:2] / dep_j - pts_j_td[..., 0:2]


def proj21_factor(pose_i, pose_j, ex, inv_dep, td, obs, sqrt_info_scale):
    """Whitened residual + Jacobian wrt [δpose_i(6), δpose_j(6), δex(6),
    δλ(1), δtd(1)] → (r[2], J[2,20]).

    obs packs [pts_i(3), pts_j(3), vel_i(3), vel_j(3), td_i, td_j].
    sqrt_info = FOCAL/1.5 · I (estimator.cpp:193-198)."""
    pts_i, pts_j = obs[0:3], obs[3:6]
    vel_i, vel_j = obs[6:9], obs[9:12]
    td_i, td_j = obs[12], obs[13]

    def r_of(delta):
        d_pi, d_pj, d_ex = delta[0:6], delta[6:12], delta[12:18]
        d_l, d_td = delta[18], delta[19]
        return sqrt_info_scale * proj21_residual_raw(
            pose_boxplus(pose_i, d_pi), pose_boxplus(pose_j, d_pj),
            pose_boxplus(ex, d_ex), inv_dep + d_l, td + d_td,
            pts_i, pts_j, vel_i, vel_j, td_i, td_j,
        )

    return _jac_and_value(r_of, torch.zeros(20, dtype=pose_i.dtype, device=pose_i.device))


# ---------------------------------------------------------------------------
# Wheel odometer factor (6-dim)
# ---------------------------------------------------------------------------


def wheel_factor(pose_i, pose_j, ex_io, sx, sy, sw, td_w, pre: WheelPreint):
    """Whitened residual + Jacobian wrt [δpose_i(6), δpose_j(6), δex_io(6),
    δsx, δsy, δsw, δtd] → (r[6], J[6, 22]). (factor/wheel_factor.h)."""
    S = sqrt_info_from_cov(pre.covariance)

    def r_of(delta):
        d_pi, d_pj, d_ex = delta[0:6], delta[6:12], delta[12:18]
        dsx, dsy, dsw, dtd = delta[18], delta[19], delta[20], delta[21]
        dp, dq = wheel_corrected_delta(pre, sx + dsx, sy + dsy, sw + dsw, td_w + dtd)
        return S @ wheel_residual_from_delta(
            pose_boxplus(pose_i, d_pi), pose_boxplus(pose_j, d_pj),
            pose_boxplus(ex_io, d_ex), dp, dq,
        )

    return _jac_and_value(r_of, torch.zeros(22, dtype=pose_i.dtype, device=pose_i.device))


# ---------------------------------------------------------------------------
# Plane factor (3-dim): roll/pitch alignment + height-above-plane
# ---------------------------------------------------------------------------


def plane_residual_raw(pose_i, ex_io, q_pw, z_pw):
    """plane_factor.h:46-56: r = [ (qio^T Qi^T qpw^T e3)_{x,y} ;
    z_pw + (qpw (Pi + Qi tio))_z ]."""
    e3 = torch.tensor([0.0, 0.0, 1.0], dtype=pose_i.dtype, device=pose_i.device)
    qi = rot(pose_i)
    tio, qio = trans(ex_io), rot(ex_io)
    n_body = quat_rotate_inv(qio, quat_rotate_inv(qi, quat_rotate_inv(q_pw, e3)))
    height = z_pw + quat_rotate(q_pw, trans(pose_i) + quat_rotate(qi, tio))[..., 2]
    return torch.cat([n_body[..., 0:2], height[..., None]], dim=-1)


def plane_factor(pose_i, ex_io, q_pw, z_pw, sqrt_info_diag):
    """Whitened residual + Jacobian wrt [δpose_i(6), δex_io(6), δθ_pw(3),
    δz_pw(1)] → (r[3], J[3,16])."""

    def r_of(delta):
        d_pi, d_ex, d_qpw, d_z = delta[0:6], delta[6:12], delta[12:15], delta[15]
        q_pw2 = quat_mul(q_pw, quat_exp(d_qpw))
        return sqrt_info_diag * plane_residual_raw(
            pose_boxplus(pose_i, d_pi), pose_boxplus(ex_io, d_ex), q_pw2, z_pw + d_z
        )

    return _jac_and_value(r_of, torch.zeros(16, dtype=pose_i.dtype, device=pose_i.device))


# ---------------------------------------------------------------------------
# Anchor / prior factors
# (factor/pose_anchor_factor.{h,cpp}, initial_pose_factor.h,
#  initial_bias_factor.h, pos_vel_factor.{hpp,cpp}, motion_factor.h)
# ---------------------------------------------------------------------------

POSE_ANCHOR_SQRT_INFO = 120.0  # pose_anchor_factor.h:18


def pose_anchor_residual_raw(pose, anchor):
    """pose_anchor_factor.cpp:12-16: r = [p − p̂; 2·vec(q ⊗ q̂⁻¹)]."""
    r_p = trans(pose) - trans(anchor)
    r_q = 2.0 * quat_mul(rot(pose), quat_conj(rot(anchor)))[..., 1:4]
    return torch.cat([r_p, r_q], dim=-1)


def pose_anchor_factor(pose, anchor, sqrt_info=POSE_ANCHOR_SQRT_INFO):
    """Whitened (r[6], J[6,6]) against δpose. The reference adds this on
    pose0 at the first GNSS-enabled solve (estimator.cpp:2943-2951) and as
    the SEED of the very first marginalization prior, i.e. when no prior
    exists yet (estimator.cpp:3562-3570)."""

    def r_of(d):
        return sqrt_info * pose_anchor_residual_raw(pose_boxplus(pose, d), anchor)

    return _jac_and_value(r_of, torch.zeros(6, dtype=pose.dtype, device=pose.device))


def initial_pose_factor(pose, init_pose, sqrt_info=1000.0):
    """initial_pose_factor.h:22-54: r = 1000·[p − p̂; 2·vec(q̂⁻¹ ⊗ q)]
    → (r[6], J[6,6]). (Shipped but unreferenced in the estimator build.)"""

    def r_of(d):
        p = pose_boxplus(pose, d)
        r_p = trans(p) - trans(init_pose)
        r_q = 2.0 * quat_mul(quat_conj(rot(init_pose)), rot(p))[1:4]
        return sqrt_info * torch.cat([r_p, r_q])

    return _jac_and_value(r_of, torch.zeros(6, dtype=pose.dtype, device=pose.device))


def initial_bias_factor(sb, init_ba, init_bg, sqrt_info=1000.0):
    """initial_bias_factor.h:24-52: r = (1/0.001)·[ba − b̂a; bg − b̂g] against
    the 9-dim speed-bias tangent → (r[6], J[6,9])."""

    def r_of(d):
        s = sb + d
        return sqrt_info * torch.cat([s[3:6] - init_ba, s[6:9] - init_bg])

    return _jac_and_value(r_of, torch.zeros(9, dtype=sb.dtype, device=sb.device))


def pos_vel_factor(pose_i, pose_j, sb_i, sb_j, dt, info_coeff=50.0):
    """pos_vel_factor.cpp:5-46: r = 50·(p_j − p_i − ½(v_i + v_j)·Δt) against
    tangent [δpose_i(6), δpose_j(6), δsb_i(9), δsb_j(9)] → (r[3], J[3,30])."""

    def r_of(d):
        pi = pose_boxplus(pose_i, d[0:6])
        pj = pose_boxplus(pose_j, d[6:12])
        vi = (sb_i + d[12:21])[0:3]
        vj = (sb_j + d[21:30])[0:3]
        return info_coeff * (trans(pj) - trans(pi) - 0.5 * (vi + vj) * dt)

    return _jac_and_value(r_of, torch.zeros(30, dtype=pose_i.dtype, device=pose_i.device))


def motion_factor(pose_i, pose_j, sb_i):
    """motion_factor.h:21-56 parity stub. The reference's MotionFactor
    (<2,7,7,9,3>, added when use_motion, estimator.cpp:3173) never writes its
    residual and zeroes every Jacobian — a deliberate no-op in the released
    code, kept as an explicit zero factor."""
    kw = dict(dtype=pose_i.dtype, device=pose_i.device)
    return torch.zeros(2, **kw), torch.zeros((2, 21), **kw)


# ---------------------------------------------------------------------------
# Robust loss (Cauchy, as used via ceres::CauchyLoss on visual factors)
# ---------------------------------------------------------------------------


def cauchy_weight(sq_norm: Tensor, delta) -> Tensor:
    """Row-reweighting sqrt(ρ'(s)) for the Cauchy loss ρ(s)=δ²log(1+s/δ²).

    Equivalent to the triggs-correction-free rescale the reference applies
    when re-evaluating dropped factors (marginalization_factor.cpp:46-77)."""
    d2 = delta * delta
    return torch.sqrt(d2 / (d2 + sq_norm))


def huber_weight(sq_norm: Tensor, delta) -> Tensor:
    """Row-reweighting sqrt(ρ'(s)) for the Huber loss (the
    ``ceres::HuberLoss(1.0)`` on line factors, estimator.cpp:4465), in the
    form that takes effect in the JAX package (the second of its two
    definitions): weight 1 up to ‖r‖ = δ, δ/‖r‖ beyond."""
    n = torch.sqrt(torch.clamp(sq_norm, min=1e-20))
    return torch.sqrt(torch.where(n <= delta, torch.ones_like(n), delta / n))


# ---------------------------------------------------------------------------
# Stereo projection factors (two cameras)
# ---------------------------------------------------------------------------


def proj22_residual_raw(pose_i, pose_j, ex0, ex1, inv_dep, td,
                        pts_i, pts_j, vel_i, vel_j, td_i, td_j):
    """projectionTwoFrameTwoCamFactor <2,7,7,7,7,1,1>: anchor obs in cam0 of
    frame i, target obs in cam1 of frame j."""
    pts_i_td = pts_i - (td - td_i) * vel_i
    pts_j_td = pts_j - (td - td_j) * vel_j
    pts_cam_i = pts_i_td / inv_dep
    pts_imu_i = quat_rotate(rot(ex0), pts_cam_i) + trans(ex0)
    pts_w = quat_rotate(rot(pose_i), pts_imu_i) + trans(pose_i)
    pts_imu_j = quat_rotate_inv(rot(pose_j), pts_w - trans(pose_j))
    pts_cam_j = quat_rotate_inv(rot(ex1), pts_imu_j - trans(ex1))
    return pts_cam_j[..., 0:2] / pts_cam_j[..., 2:3] - pts_j_td[..., 0:2]


def proj22_factor(pose_i, pose_j, ex0, ex1, inv_dep, td, obs, sqrt_info_scale):
    """Whitened residual + Jacobian wrt [δpose_i(6), δpose_j(6), δex0(6),
    δex1(6), δλ, δtd] → (r[2], J[2,26])."""
    pts_i, pts_j = obs[0:3], obs[3:6]
    vel_i, vel_j = obs[6:9], obs[9:12]
    td_i, td_j = obs[12], obs[13]

    def r_of(d):
        return sqrt_info_scale * proj22_residual_raw(
            pose_boxplus(pose_i, d[0:6]), pose_boxplus(pose_j, d[6:12]),
            pose_boxplus(ex0, d[12:18]), pose_boxplus(ex1, d[18:24]),
            inv_dep + d[24], td + d[25],
            pts_i, pts_j, vel_i, vel_j, td_i, td_j,
        )

    return _jac_and_value(r_of, torch.zeros(26, dtype=pose_i.dtype, device=pose_i.device))


def proj12_residual_raw(ex0, ex1, inv_dep, td, pts_i, pts_j, vel_i, vel_j, td_i, td_j):
    """projectionOneFrameTwoCamFactor <2,7,7,1,1>: same frame, cam0 → cam1."""
    pts_i_td = pts_i - (td - td_i) * vel_i
    pts_j_td = pts_j - (td - td_j) * vel_j
    pts_cam_i = pts_i_td / inv_dep
    pts_imu = quat_rotate(rot(ex0), pts_cam_i) + trans(ex0)
    pts_cam_j = quat_rotate_inv(rot(ex1), pts_imu - trans(ex1))
    return pts_cam_j[..., 0:2] / pts_cam_j[..., 2:3] - pts_j_td[..., 0:2]


def proj12_factor(ex0, ex1, inv_dep, td, obs, sqrt_info_scale):
    """Whitened residual + Jacobian wrt [δex0(6), δex1(6), δλ, δtd] →
    (r[2], J[2,14])."""
    pts_i, pts_j = obs[0:3], obs[3:6]
    vel_i, vel_j = obs[6:9], obs[9:12]
    td_i, td_j = obs[12], obs[13]

    def r_of(d):
        return sqrt_info_scale * proj12_residual_raw(
            pose_boxplus(ex0, d[0:6]), pose_boxplus(ex1, d[6:12]),
            inv_dep + d[12], td + d[13],
            pts_i, pts_j, vel_i, vel_j, td_i, td_j,
        )

    return _jac_and_value(r_of, torch.zeros(14, dtype=ex0.dtype, device=ex0.device))
