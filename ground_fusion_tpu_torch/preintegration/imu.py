"""IMU preintegration as a Python loop over padded sample batches.

Same midpoint scheme as the reference's per-sample C++ accumulator
(``vins_estimator/src/factor/integration_base.h:63-137`` midPointIntegration,
``:139-167`` propagate): first-order bias Jacobian (15x15 state-transition
product) and covariance propagation with the 18-dim noise model, over a
fixed-capacity ``[K, 7]`` sample buffer with a validity mask. Every function
broadcasts over leading batch axes, so the window's F intervals advance
together: the loop runs over the K samples, each step is one batched update.
Re-propagation after a bias update (``integration_base.h:47-61``) is just
calling :func:`preintegrate` again on the stored buffer — it is pure.

State ordering matches the reference residual: [P(0:3), R(3:6), V(6:9),
Ba(9:12), Bg(12:15)].
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch import Tensor

from ..geometry.so3 import quat_mul, quat_normalize, quat_rotate, quat_to_mat, skew


class ImuPreint(NamedTuple):
    """Preintegrated IMU measurement between two frames."""

    delta_p: Tensor      # [3]
    delta_q: Tensor      # [4] wxyz
    delta_v: Tensor      # [3]
    jacobian: Tensor     # [15,15] d(delta)/d(state_0) — bias columns are used
    covariance: Tensor   # [15,15]
    sum_dt: Tensor       # []
    linearized_ba: Tensor  # [3]
    linearized_bg: Tensor  # [3]


def identity_preint(dtype=torch.float32, device=None) -> ImuPreint:
    kw = dict(dtype=dtype, device=device)
    return ImuPreint(
        delta_p=torch.zeros(3, **kw),
        delta_q=torch.tensor([1.0, 0, 0, 0], **kw),
        delta_v=torch.zeros(3, **kw),
        jacobian=torch.eye(15, **kw),
        covariance=torch.zeros((15, 15), **kw),
        sum_dt=torch.zeros((), **kw),
        linearized_ba=torch.zeros(3, **kw),
        linearized_bg=torch.zeros(3, **kw),
    )


def noise_cov(acc_n, gyr_n, acc_w, gyr_w, dtype=torch.float32, device=None) -> Tensor:
    """18x18 diagonal measurement-noise covariance (integration_base.h:30-37)."""
    d = torch.tensor(
        [acc_n**2] * 3 + [gyr_n**2] * 3 + [acc_n**2] * 3 + [gyr_n**2] * 3
        + [acc_w**2] * 3 + [gyr_w**2] * 3,
        dtype=torch.float64,
    )
    return torch.diag(d).to(dtype=dtype, device=device)


def _block_rows(rows):
    """Assemble a block matrix from a list of rows of equally-batched blocks."""
    return torch.cat([torch.cat(r, dim=-1) for r in rows], dim=-2)


def _midpoint_step(carry, sample, noise18):
    """One midpoint update. carry = (p, q, v, J, P, sum_dt, acc_0, gyr_0, ba, bg);
    sample = (dt, acc_1, gyr_1, valid), all with the same leading batch axes."""
    p, q, v, J, P, sum_dt, acc_0, gyr_0, ba, bg = carry
    dt, acc_1, gyr_1, valid = sample
    dt1 = dt[..., None]           # against vectors
    dt2 = dt[..., None, None]     # against matrices

    R0 = quat_to_mat(q)
    un_acc_0 = (R0 @ (acc_0 - ba)[..., None])[..., 0]
    un_gyr = 0.5 * (gyr_0 + gyr_1) - bg
    half = un_gyr * dt1 * 0.5
    dq = torch.cat([torch.ones_like(half[..., 0:1]), half], dim=-1)  # unnormalized deltaQ, as in reference
    q_new = quat_normalize(quat_mul(q, dq))
    R1 = quat_to_mat(q_new)
    un_acc_1 = (R1 @ (acc_1 - ba)[..., None])[..., 0]
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    p_new = p + v * dt1 + 0.5 * un_acc * dt1 * dt1
    v_new = v + un_acc * dt1

    # --- first-order state transition F (15x15) and noise map V (15x18) ---
    w_x = skew(un_gyr)
    a0_x = skew(acc_0 - ba)
    a1_x = skew(acc_1 - ba)
    I3 = torch.eye(3, dtype=p.dtype, device=p.device).expand(R0.shape)
    Z3 = torch.zeros_like(R0)
    R1a1 = R1 @ a1_x
    R0a0 = R0 @ a0_x
    ImWdt = I3 - w_x * dt2

    F = _block_rows([
        [I3, -0.25 * R0a0 * dt2 * dt2 - 0.25 * R1a1 @ ImWdt * dt2 * dt2, I3 * dt2,
         -0.25 * (R0 + R1) * dt2 * dt2, 0.25 * R1a1 * dt2 * dt2 * dt2],
        [Z3, ImWdt, Z3, Z3, -I3 * dt2],
        [Z3, -0.5 * R0a0 * dt2 - 0.5 * R1a1 @ ImWdt * dt2, I3,
         -0.5 * (R0 + R1) * dt2, 0.5 * R1a1 * dt2 * dt2],
        [Z3, Z3, Z3, I3, Z3],
        [Z3, Z3, Z3, Z3, I3],
    ])

    v03 = -0.125 * R1a1 * dt2 * dt2 * dt2
    v63 = -0.25 * R1a1 * dt2 * dt2
    V = _block_rows([
        [0.25 * R0 * dt2 * dt2, v03, 0.25 * R1 * dt2 * dt2, v03, Z3, Z3],
        [Z3, 0.5 * I3 * dt2, Z3, 0.5 * I3 * dt2, Z3, Z3],
        [0.5 * R0 * dt2, v63, 0.5 * R1 * dt2, v63, Z3, Z3],
        [Z3, Z3, Z3, Z3, I3 * dt2, Z3],
        [Z3, Z3, Z3, Z3, Z3, I3 * dt2],
    ])

    J_new = F @ J
    P_new = F @ P @ F.mT + V @ noise18 @ V.mT

    # masked update: padded samples are identity steps
    v0, v1, v2 = valid, valid[..., None], valid[..., None, None]
    return (
        torch.where(v1, p_new, p), torch.where(v1, q_new, q), torch.where(v1, v_new, v),
        torch.where(v2, J_new, J), torch.where(v2, P_new, P),
        torch.where(v0, sum_dt + dt, sum_dt),
        torch.where(v1, acc_1, acc_0), torch.where(v1, gyr_1, gyr_0), ba, bg,
    )


def preintegrate(
    dts: Tensor,       # [..., K]
    accs: Tensor,      # [..., K, 3] samples acc_1..acc_K (acc_0 passed separately)
    gyrs: Tensor,      # [..., K, 3]
    valid: Tensor,     # [..., K] bool
    acc_0: Tensor,     # [..., 3] sample at interval start
    gyr_0: Tensor,     # [..., 3]
    ba: Tensor,        # [..., 3] linearization-point accel bias
    bg: Tensor,        # [..., 3]
    noise18: Tensor,   # [18,18]
) -> ImuPreint:
    """Preintegrate a padded interval (or a batch of them: any leading axes).
    Equivalent of constructing ``IntegrationBase(acc_0, gyr_0, ba, bg)`` and
    ``push_back``-ing each sample (integration_base.h:22-45)."""
    kw = dict(dtype=accs.dtype, device=accs.device)
    batch = dts.shape[:-1]
    q0 = torch.tensor([1.0, 0, 0, 0], **kw).expand(batch + (4,))
    carry = (
        torch.zeros(batch + (3,), **kw), q0, torch.zeros(batch + (3,), **kw),
        torch.eye(15, **kw).expand(batch + (15, 15)),
        torch.zeros(batch + (15, 15), **kw), torch.zeros(batch, **kw),
        acc_0, gyr_0, ba, bg,
    )
    for k in range(dts.shape[-1]):
        sample = (dts[..., k], accs[..., k, :], gyrs[..., k, :], valid[..., k])
        carry = _midpoint_step(carry, sample, noise18)
    p, q, v, J, P, sum_dt, _, _, ba, bg = carry
    return ImuPreint(p, q, v, J, P, sum_dt, ba, bg)


def bias_corrected_delta(pre: ImuPreint, bai: Tensor, bgi: Tensor):
    """First-order bias correction of (delta_p, delta_q, delta_v)
    (integration_base.h:169-188)."""
    dba = (bai - pre.linearized_ba)[..., None]
    dbg = (bgi - pre.linearized_bg)[..., None]
    J = pre.jacobian
    dp = pre.delta_p + (J[..., 0:3, 9:12] @ dba + J[..., 0:3, 12:15] @ dbg)[..., 0]
    dv = pre.delta_v + (J[..., 6:9, 9:12] @ dba + J[..., 6:9, 12:15] @ dbg)[..., 0]
    half = 0.5 * (J[..., 3:6, 12:15] @ dbg)[..., 0]
    dq_inc = quat_normalize(torch.cat([torch.ones_like(half[..., 0:1]), half], dim=-1))
    dq = quat_normalize(quat_mul(pre.delta_q, dq_inc))
    return dp, dq, dv


def fast_predict(p, q, v, ba, bg, g, dt, acc_0, gyr_0, acc_1, gyr_1):
    """IMU-rate dead reckoning (Estimator::fastPredictIMU,
    estimator.cpp:4014-4030) — the ~200 Hz odometry path."""
    un_acc_0 = quat_rotate(q, acc_0 - ba) - g
    un_gyr = 0.5 * (gyr_0 + gyr_1) - bg
    half = un_gyr * dt * 0.5
    q_new = quat_normalize(quat_mul(q, torch.cat([torch.ones_like(half[..., 0:1]), half], dim=-1)))
    un_acc_1 = quat_rotate(q_new, acc_1 - ba) - g
    un_acc = 0.5 * (un_acc_0 + un_acc_1)
    p_new = p + dt * v + 0.5 * dt * dt * un_acc
    v_new = v + dt * un_acc
    return p_new, q_new, v_new
