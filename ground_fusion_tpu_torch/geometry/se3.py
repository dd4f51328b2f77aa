"""SE(3) pose helpers over (position, quaternion) pairs.

A pose is a 7-vector ``[px, py, pz, qw, qx, qy, qz]`` — same information as
the reference's Ceres pose block (``pose_local_parameterization.cpp``), stored
w-first. The local perturbation (⊞) matches the reference's manifold update:
``p += δp; q = q ⊗ deltaQ(δθ)`` with δ ∈ R^6, which is what all analytic
Jacobians in the factor library are expressed against.
"""

from __future__ import annotations

import torch
from torch import Tensor

from .so3 import delta_q, quat_conj, quat_mul, quat_normalize, quat_rotate, quat_rotate_inv


def pose(p: Tensor, q: Tensor) -> Tensor:
    return torch.cat([p, q], dim=-1)


def pose_identity(dtype=torch.float32, device=None) -> Tensor:
    return torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype, device=device)


def trans(T: Tensor) -> Tensor:
    return T[..., 0:3]


def rot(T: Tensor) -> Tensor:
    return T[..., 3:7]


def pose_boxplus(T: Tensor, delta: Tensor) -> Tensor:
    """Manifold retraction: T ⊞ [δp, δθ] (reference PoseLocalParameterization::Plus)."""
    p = T[..., 0:3] + delta[..., 0:3]
    q = quat_normalize(quat_mul(T[..., 3:7], delta_q(delta[..., 3:6])))
    return torch.cat([p, q], dim=-1)


def pose_compose(Ta: Tensor, Tb: Tensor) -> Tensor:
    """Ta ∘ Tb (apply Tb first in Ta's frame)."""
    p = trans(Ta) + quat_rotate(rot(Ta), trans(Tb))
    q = quat_normalize(quat_mul(rot(Ta), rot(Tb)))
    return pose(p, q)


def pose_inverse(T: Tensor) -> Tensor:
    qi = quat_conj(rot(T))
    return pose(-quat_rotate(qi, trans(T)), qi)


def pose_apply(T: Tensor, x: Tensor) -> Tensor:
    """Transform point(s) x by pose T."""
    return quat_rotate(rot(T), x) + trans(T)


def pose_apply_inv(T: Tensor, x: Tensor) -> Tensor:
    return quat_rotate_inv(rot(T), x - trans(T))
