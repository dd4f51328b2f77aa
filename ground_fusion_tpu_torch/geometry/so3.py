"""SO(3) / quaternion primitives of the PyTorch port.

Quaternions are stored as ``[w, x, y, z]`` tensors (Hamilton convention, same
algebra as Eigen's ``Quaterniond`` used throughout the reference; cf.
``vins_estimator/src/utility/utility.h`` — ``deltaQ``, ``skewSymmetric``,
``Qleft``/``Qright``, ``g2R``, ``ypr`` round-trips).

Every function operates on the trailing axis and broadcasts over leading
batch axes, and is written with out-of-place tensor ops only, so it works
under ``torch.func.vmap`` / ``torch.func.jacfwd``.
"""

from __future__ import annotations

import torch
from torch import Tensor

# ---------------------------------------------------------------------------
# Basic quaternion algebra
# ---------------------------------------------------------------------------


def quat_identity(dtype=torch.float32, device=None) -> Tensor:
    return torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def quat_normalize(q: Tensor) -> Tensor:
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)


def quat_conj(q: Tensor) -> Tensor:
    """Conjugate == inverse for unit quaternions."""
    return torch.cat([q[..., 0:1], -q[..., 1:4]], dim=-1)


def quat_mul(a: Tensor, b: Tensor) -> Tensor:
    """Hamilton product a ⊗ b, broadcasting over leading axes."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a: Tensor, b: Tensor) -> Tensor:
    a, b = torch.broadcast_tensors(a, b)
    ax, ay, az = a.unbind(-1)
    bx, by, bz = b.unbind(-1)
    return torch.stack([ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx], dim=-1)


def quat_rotate(q: Tensor, v: Tensor) -> Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (q * v * q^-1).

    Uses the expanded 15-mul form rather than building the rotation matrix.
    """
    w = q[..., 0:1]
    u = q[..., 1:4]
    # v' = v + 2 w (u × v) + 2 u × (u × v)
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def quat_rotate_inv(q: Tensor, v: Tensor) -> Tensor:
    return quat_rotate(quat_conj(q), v)


def quat_to_mat(q: Tensor) -> Tensor:
    """Unit quaternion -> 3x3 rotation matrix (batched on leading axes)."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
            2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
            2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(q.shape[:-1] + (3, 3))


def mat_to_quat(m: Tensor) -> Tensor:
    """3x3 rotation matrix -> unit quaternion [w,x,y,z], branch-free.

    Computes all four Shepperd candidates and selects the best-conditioned
    one by index, so it needs no host decision.
    """
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-24))

    # Candidate 0: trace-dominant
    s0 = safe_sqrt(1.0 + tr) * 2.0
    q0 = torch.stack([0.25 * s0, (m21 - m12) / s0, (m02 - m20) / s0, (m10 - m01) / s0], dim=-1)
    # Candidate 1: m00-dominant
    s1 = safe_sqrt(1.0 + m00 - m11 - m22) * 2.0
    q1 = torch.stack([(m21 - m12) / s1, 0.25 * s1, (m01 + m10) / s1, (m02 + m20) / s1], dim=-1)
    # Candidate 2: m11-dominant
    s2 = safe_sqrt(1.0 + m11 - m00 - m22) * 2.0
    q2 = torch.stack([(m02 - m20) / s2, (m01 + m10) / s2, 0.25 * s2, (m12 + m21) / s2], dim=-1)
    # Candidate 3: m22-dominant
    s3 = safe_sqrt(1.0 + m22 - m00 - m11) * 2.0
    q3 = torch.stack([(m10 - m01) / s3, (m02 + m20) / s3, (m12 + m21) / s3, 0.25 * s3], dim=-1)

    scores = torch.stack([tr, m00, m11, m22], dim=-1)
    idx = torch.argmax(scores, dim=-1)
    cands = torch.stack([q0, q1, q2, q3], dim=-2)
    sel = idx[..., None, None].expand(idx.shape + (1, 4))
    q = torch.gather(cands, -2, sel)[..., 0, :]
    return quat_normalize(q)


# ---------------------------------------------------------------------------
# so(3) exp / log and Jacobians
# ---------------------------------------------------------------------------


def skew(v: Tensor) -> Tensor:
    """Skew-symmetric matrix [v]x, batched."""
    x, y, z = v.unbind(-1)
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def quat_exp(phi: Tensor) -> Tensor:
    """so(3) vector -> unit quaternion exp([0, phi/2]). Taylor-safe at 0."""
    theta2 = torch.sum(phi * phi, dim=-1, keepdim=True)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    half = 0.5 * theta
    small = theta2 < 1e-12
    w = torch.where(small, 1.0 - theta2 / 8.0, torch.cos(half))
    k = torch.where(small, 0.5 - theta2 / 48.0, torch.sin(half) / theta)
    return torch.cat([w, k * phi], dim=-1)


def quat_log(q: Tensor) -> Tensor:
    """Unit quaternion -> so(3) vector (rotation-vector), Taylor-safe."""
    q = torch.where(q[..., 0:1] < 0, -q, q)  # take the short arc
    w = torch.clamp(q[..., 0:1], -1.0, 1.0)
    vn2 = torch.sum(q[..., 1:4] ** 2, dim=-1, keepdim=True)
    vn = torch.sqrt(torch.clamp(vn2, min=1e-24))
    angle = 2.0 * torch.atan2(vn, w)
    small = vn2 < 1e-14
    k = torch.where(small, 2.0 / torch.clamp(w, min=1e-12), angle / vn)
    return k * q[..., 1:4]


def delta_q(theta: Tensor) -> Tensor:
    """First-order quaternion increment [1, theta/2] (reference Utility::deltaQ,
    ``vins_estimator/src/utility/utility.h:22-32``), normalized."""
    half = 0.5 * theta
    one = torch.ones_like(theta[..., 0:1])
    return quat_normalize(torch.cat([one, half], dim=-1))


def so3_exp_mat(phi: Tensor) -> Tensor:
    """Rodrigues: so(3) vector -> rotation matrix."""
    return quat_to_mat(quat_exp(phi))


def so3_log_mat(m: Tensor) -> Tensor:
    return quat_log(mat_to_quat(m))


def right_jacobian_so3(phi: Tensor) -> Tensor:
    """Right Jacobian Jr(phi) of SO(3) (Sophus::rightJacobianSO3 analog; used by
    the wheel preintegration noise model, ``wheel_integration_base.h:114-123``).
    """
    theta2 = torch.sum(phi * phi, dim=-1)[..., None, None]
    theta = torch.sqrt(torch.clamp(theta2, min=1e-24))
    K = skew(phi)
    KK = K @ K
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(K.shape)
    small = theta2 < 1e-12
    a = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta)) / torch.clamp(theta2, min=1e-24))
    b = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=1e-24),
    )
    return eye - a * K + b * KK


def _quat_prod_mat(q: Tensor, sign: float) -> Tensor:
    w = q[..., 0]
    v = q[..., 1:4]
    top = torch.cat([w[..., None, None], -v[..., None, :]], dim=-1)
    bottom_left = v[..., :, None]
    eye = torch.eye(3, dtype=q.dtype, device=q.device)
    bottom_right = w[..., None, None] * eye + sign * skew(v)
    bottom = torch.cat([bottom_left, bottom_right], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def left_quat_prod_mat(q: Tensor) -> Tensor:
    """Qleft: 4x4 matrix s.t. Qleft(a) @ b == quat_mul(a, b) (utility.h:34-42)."""
    return _quat_prod_mat(q, 1.0)


def right_quat_prod_mat(q: Tensor) -> Tensor:
    """Qright: 4x4 matrix s.t. Qright(b) @ a == quat_mul(a, b) (utility.h:44-52)."""
    return _quat_prod_mat(q, -1.0)


# ---------------------------------------------------------------------------
# Euler (yaw-pitch-roll, Z-Y-X) and gravity alignment
# ---------------------------------------------------------------------------


def mat_to_ypr(m: Tensor) -> Tensor:
    """Rotation matrix -> [yaw, pitch, roll] in radians (utility.h:54-76 uses
    degrees; we keep radians and convert at the I/O edge)."""
    yaw = torch.atan2(m[..., 1, 0], m[..., 0, 0])
    pitch = torch.atan2(
        -m[..., 2, 0],
        m[..., 0, 0] * torch.cos(yaw) + m[..., 1, 0] * torch.sin(yaw),
    )
    roll = torch.atan2(
        m[..., 0, 2] * torch.sin(yaw) - m[..., 1, 2] * torch.cos(yaw),
        -m[..., 0, 1] * torch.sin(yaw) + m[..., 1, 1] * torch.cos(yaw),
    )
    return torch.stack([yaw, pitch, roll], dim=-1)


def ypr_to_mat(ypr: Tensor) -> Tensor:
    """[yaw, pitch, roll] (radians) -> rotation matrix Rz(y) Ry(p) Rx(r)."""
    y, p, r = ypr.unbind(-1)
    cy, sy = torch.cos(y), torch.sin(y)
    cp, sp = torch.cos(p), torch.sin(p)
    cr, sr = torch.cos(r), torch.sin(r)
    m = torch.stack(
        [
            cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr,
            sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr,
            -sp, cp * sr, cp * cr,
        ],
        dim=-1,
    )
    return m.reshape(ypr.shape[:-1] + (3, 3))


def g2r(g: Tensor) -> Tensor:
    """Rotation aligning measured gravity direction g with +z, yaw-free
    (Utility::g2R, utility.h:78-90): R0 such that R0 @ ĝ == e3 and R0 has zero
    yaw."""
    ng1 = g / torch.linalg.norm(g, dim=-1, keepdim=True)
    ng2 = torch.tensor([0.0, 0.0, 1.0], dtype=g.dtype, device=g.device)
    # rotation taking ng1 to ng2
    axis = _cross(ng1, ng2)
    s = torch.linalg.norm(axis, dim=-1, keepdim=True)
    c = torch.sum(ng1 * ng2, dim=-1, keepdim=True)
    angle = torch.atan2(s, c)
    axis_safe = axis / torch.clamp(s, min=1e-12)
    r0 = so3_exp_mat(axis_safe * angle)
    # remove yaw
    yaw = mat_to_ypr(r0)[..., 0]
    zero = torch.zeros_like(yaw)
    unyaw = ypr_to_mat(torch.stack([-yaw, zero, zero], dim=-1))
    return unyaw @ r0


def yaw_to_mat(yaw: Tensor) -> Tensor:
    z = torch.zeros_like(yaw)
    return ypr_to_mat(torch.stack([yaw, z, z], dim=-1))
