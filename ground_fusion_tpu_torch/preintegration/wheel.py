"""Wheel-odometer preintegration (Δp, Δq from body-frame velocity + gyro).

Equivalent of ``vins_estimator/src/factor/wheel_integration_base.h``
(:67-146 midPointIntegration, :180-219 time-offset-corrected evaluate):
midpoint integration of planar wheel velocity scaled by the online intrinsics
(sx, sy, sw), a 6x3 Jacobian of the preintegrated delta w.r.t. those
intrinsics, and a 6x6 covariance with the 12-dim velocity/gyro noise model —
a masked Python loop over a fixed-capacity sample buffer, each step batched
over any leading axes (the window's F intervals).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..geometry.se3 import rot, trans
from ..geometry.so3 import (
    quat_conj,
    quat_exp,
    quat_log,
    quat_mul,
    quat_normalize,
    quat_rotate,
    quat_rotate_inv,
    quat_to_mat,
    right_jacobian_so3,
    skew,
)


class WheelPreint(NamedTuple):
    delta_p: Tensor         # [3]
    delta_q: Tensor         # [4]
    jacobian_ix: Tensor     # [6,3] d(delta)/d(sx, sy, sw)
    covariance: Tensor      # [6,6]
    sum_dt: Tensor          # []
    linearized_sx: Tensor   # []
    linearized_sy: Tensor   # []
    linearized_sw: Tensor   # []
    linearized_td: Tensor   # []
    linearized_vel: Tensor  # [3] first velocity sample of the interval
    linearized_gyr: Tensor  # [3]
    vel_1: Tensor           # [3] last velocity sample
    gyr_1: Tensor           # [3]


def identity_wheel_preint(dtype=torch.float32, device=None) -> WheelPreint:
    kw = dict(dtype=dtype, device=device)
    z3 = torch.zeros(3, **kw)
    return WheelPreint(
        delta_p=z3,
        delta_q=torch.tensor([1.0, 0, 0, 0], **kw),
        jacobian_ix=torch.zeros((6, 3), **kw),
        covariance=torch.zeros((6, 6), **kw),
        sum_dt=torch.zeros((), **kw),
        linearized_sx=torch.ones((), **kw),
        linearized_sy=torch.ones((), **kw),
        linearized_sw=torch.ones((), **kw),
        linearized_td=torch.zeros((), **kw),
        linearized_vel=z3,
        linearized_gyr=z3,
        vel_1=z3,
        gyr_1=z3,
    )


def wheel_noise_cov(vel_n, gyr_n, dtype=torch.float32, device=None) -> Tensor:
    """12x12 diagonal noise (wheel_integration_base.h:32-36)."""
    d = torch.tensor(
        [vel_n**2] * 3 + [gyr_n**2] * 3 + [vel_n**2] * 3 + [gyr_n**2] * 3,
        dtype=torch.float64,
    )
    return torch.diag(d).to(dtype=dtype, device=device)


def _sv_diag(sx: Tensor, sy: Tensor) -> Tensor:
    return torch.stack([sx, sy, torch.ones_like(sx)], dim=-1)


def _step(carry, sample, sx, sy, sw, noise12):
    p, q, P, sum_dt, vel_0, gyr_0 = carry
    dt, vel_1, gyr_1, valid = sample
    dt1 = dt[..., None]
    dt2 = dt[..., None, None]

    svd = _sv_diag(sx, sy)
    sv = torch.diag_embed(svd)
    R0 = quat_to_mat(q)
    sv0 = svd * vel_0
    sv1 = svd * vel_1
    un_vel_0 = (R0 @ sv0[..., None])[..., 0]
    un_gyr = 0.5 * sw[..., None] * (gyr_0 + gyr_1)
    half = un_gyr * dt1 * 0.5
    ddq = torch.cat([torch.ones_like(half[..., 0:1]), half], dim=-1)
    q_new = quat_normalize(quat_mul(q, ddq))
    R1 = quat_to_mat(q_new)
    Rdd = quat_to_mat(quat_normalize(ddq))
    un_vel_1 = (R1 @ sv1[..., None])[..., 0]
    p_new = p + 0.5 * (un_vel_0 + un_vel_1) * dt1

    # --- covariance propagation (wheel_integration_base.h:109-123) ---
    v0x = skew(sv0)
    v1x = skew(sv1)
    I3 = torch.eye(3, dtype=p.dtype, device=p.device).expand(R0.shape)
    Z3 = torch.zeros_like(R0)
    F = torch.cat([
        torch.cat([I3, -0.5 * dt2 * (R0 @ v0x + R1 @ v1x @ Rdd.mT)], dim=-1),
        torch.cat([Z3, Rdd.mT], dim=-1),
    ], dim=-2)
    Jr = right_jacobian_so3(un_gyr * dt1)

    v03 = -0.25 * dt2 * dt2 * R1 @ v1x @ Jr
    v33 = 0.5 * Jr * sw[..., None, None] * dt2
    V = torch.cat([
        torch.cat([0.5 * dt2 * R0 @ sv, v03, 0.5 * dt2 * R1 @ sv, v03], dim=-1),
        torch.cat([Z3, v33, Z3, v33], dim=-1),
    ], dim=-2)
    P_new = F @ P @ F.mT + V @ noise12 @ V.mT

    v1_, v2_ = valid[..., None], valid[..., None, None]
    return (
        torch.where(v1_, p_new, p), torch.where(v1_, q_new, q), torch.where(v2_, P_new, P),
        torch.where(valid, sum_dt + dt, sum_dt),
        torch.where(v1_, vel_1, vel_0), torch.where(v1_, gyr_1, gyr_0),
    )


def _delta_only(s3, dts, vels, gyrs, valid, vel_0, gyr_0):
    """(Δp, Δq) of ONE interval as a pure function of the intrinsics
    ``s3 = (sx, sy, sw)`` — differentiated with ``jacfwd`` to get the exact
    6x3 intrinsic Jacobian. The reference accumulates this Jacobian with a
    small-angle recursion (wheel_integration_base.h:127-139) that drops the
    adjoint transport of the previous derivative; forward-mode AD through the
    loop is exact and costs three extra tangents."""
    kw = dict(dtype=vels.dtype, device=vels.device)
    sv_diag = torch.stack([s3[0], s3[1], torch.ones((), **kw)])
    sw = s3[2]
    p = torch.zeros(3, **kw)
    q = torch.tensor([1.0, 0, 0, 0], **kw)
    v0, g0 = vel_0, gyr_0
    one = torch.ones(1, **kw)
    for k in range(dts.shape[0]):
        dt, v1, g1, ok = dts[k], vels[k], gyrs[k], valid[k]
        un_vel_0 = quat_to_mat(q) @ (sv_diag * v0)
        un_gyr = 0.5 * sw * (g0 + g1)
        half = un_gyr * dt * 0.5
        q_new = quat_normalize(quat_mul(q, torch.cat([one, half])))
        un_vel_1 = quat_to_mat(q_new) @ (sv_diag * v1)
        p_new = p + 0.5 * (un_vel_0 + un_vel_1) * dt
        p, q = torch.where(ok, p_new, p), torch.where(ok, q_new, q)
        v0, g0 = torch.where(ok, v1, v0), torch.where(ok, g1, g0)
    return p, q


def preintegrate_wheel(
    dts: Tensor,      # [..., K]
    vels: Tensor,     # [..., K,3]
    gyrs: Tensor,     # [..., K,3]
    valid: Tensor,    # [..., K] bool
    vel_0: Tensor,    # [..., 3]
    gyr_0: Tensor,    # [..., 3]
    sx: Tensor,       # [] (shared by the batch)
    sy: Tensor,
    sw: Tensor,
    td: Tensor,
    noise12: Tensor,
) -> WheelPreint:
    kw = dict(dtype=vels.dtype, device=vels.device)
    batch = dts.shape[:-1]
    K = dts.shape[-1]
    sxb, syb, swb = (s.expand(batch) for s in (sx, sy, sw))
    carry = (
        torch.zeros(batch + (3,), **kw),
        torch.tensor([1.0, 0, 0, 0], **kw).expand(batch + (4,)),
        torch.zeros(batch + (6, 6), **kw), torch.zeros(batch, **kw), vel_0, gyr_0,
    )
    for k in range(K):
        sample = (dts[..., k], vels[..., k, :], gyrs[..., k, :], valid[..., k])
        carry = _step(carry, sample, sxb, syb, swb, noise12)
    p, q, P, sum_dt, _, _ = carry

    # exact intrinsic Jacobian via forward-mode AD (see _delta_only docstring);
    # the batch goes through one vmap so the loop is traced once
    s3 = torch.stack([sx, sy, sw])
    jac = torch.func.jacfwd(_delta_only)
    flat = lambda x, tail: x.reshape((-1,) + x.shape[len(batch):]) if tail else x.reshape(-1)
    if batch:
        dp_ds, dq_ds = torch.func.vmap(jac, in_dims=(None, 0, 0, 0, 0, 0, 0))(
            s3, flat(dts, True), flat(vels, True), flat(gyrs, True), flat(valid, True),
            flat(vel_0, True), flat(gyr_0, True))
        dp_ds = dp_ds.reshape(batch + (3, 3))
        dq_ds = dq_ds.reshape(batch + (4, 3))
    else:
        dp_ds, dq_ds = jac(s3, dts, vels, gyrs, valid, vel_0, gyr_0)  # [3,3], [4,3]
    # quaternion derivative -> right-tangent: δθ_col = 2 (q^-1 ⊗ dq)_vec
    qc = quat_conj(q)[..., None, :]
    dtheta_ds = 2.0 * quat_mul(qc, dq_ds.mT)[..., 1:4].mT
    Jix = torch.cat([dp_ds, dtheta_ds], dim=-2)
    # last *valid* sample for the td correction in the residual
    n_valid = torch.sum(valid.to(torch.int64), dim=-1)
    last = torch.clamp(n_valid - 1, min=0)
    idx = last[..., None, None].expand(batch + (1, 3))
    any_valid = (n_valid > 0)[..., None]
    vel_1 = torch.where(any_valid, torch.gather(vels, -2, idx)[..., 0, :], vel_0)
    gyr_1 = torch.where(any_valid, torch.gather(gyrs, -2, idx)[..., 0, :], gyr_0)
    tdb = td.expand(batch)
    return WheelPreint(p, q, Jix, P, sum_dt, sxb, syb, swb, tdb, vel_0, gyr_0, vel_1, gyr_1)


def wheel_corrected_delta(pre: WheelPreint, sx, sy, sw, td):
    """Intrinsic- and time-offset-corrected (Δp, Δq)
    (wheel_integration_base.h:180-206)."""
    dsx = sx - pre.linearized_sx
    dsy = sy - pre.linearized_sy
    dsw = sw - pre.linearized_sw
    dtd = td - pre.linearized_td
    Jix = pre.jacobian_ix

    cp = (pre.delta_p + Jix[..., 0:3, 0] * dsx[..., None] + Jix[..., 0:3, 1] * dsy[..., None]
          + Jix[..., 0:3, 2] * dsw[..., None])
    cq = quat_normalize(quat_mul(pre.delta_q, quat_exp(Jix[..., 3:6, 2] * dsw[..., None])))

    svd = _sv_diag(sx, sy)
    swd = (sw * dtd)[..., None]
    q_head = quat_exp(swd * pre.linearized_gyr)
    q_tail = quat_exp(-swd * pre.gyr_1)
    dq_time = quat_normalize(quat_mul(quat_mul(q_head, cq), q_tail))
    dtd1 = dtd[..., None]
    dp_time = quat_rotate(
        q_head,
        svd * pre.linearized_vel * dtd1 + cp - quat_rotate(cq, svd * (pre.vel_1 * dtd1)),
    )
    return dp_time, dq_time


def wheel_residual_from_delta(pose_i, pose_j, ex_io, dp_time, dq_time):
    """6-dim wheel relative-motion residual (wheel_integration_base.h:211-212):
    [ (Ri rio)^T (Rj tio + Pj - Ri tio - Pi) - Δp ; Log(Δq^-1 (Qi qio)^-1 Qj qio) ]."""
    pi, qi = trans(pose_i), rot(pose_i)
    pj, qj = trans(pose_j), rot(pose_j)
    tio, qio = trans(ex_io), rot(ex_io)

    qi_io = quat_mul(qi, qio)
    rel_p = quat_rotate_inv(qi_io, quat_rotate(qj, tio) + pj - quat_rotate(qi, tio) - pi)
    r_p = rel_p - dp_time
    q_err = quat_mul(quat_conj(dq_time), quat_mul(quat_conj(qi_io), quat_mul(qj, qio)))
    r_q = quat_log(q_err)
    return torch.cat([r_p, r_q], dim=-1)
