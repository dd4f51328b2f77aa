"""Log-depth preintegration: the same midpoint preintegration as :mod:`.imu`
and :mod:`.wheel`, in O(log K) dependent steps instead of K.

The reference (and the sequential modules) integrate sample by sample — a
K-step dependence chain (``integration_base.h:139-167`` propagate), each step
a handful of tiny tensor operations. Here the recursion is split into
associative pieces, each computed for all samples at once:

1. **Attitude chain**: each sample's increment ``dq_k = [1, ½·ω̄_k·dt]``
   depends only on measurements, and per-step normalization commutes with the
   product (norms multiply), so all prefix attitudes are one inclusive scan of
   quaternion products — written by hand (stable PyTorch has no associative
   scan) as Hillis-Steele: ⌈log₂K⌉ rounds of one batched product each, the
   earlier sample on the left (the product does not commute).
2. **Velocity/position**: given the prefix rotations, the midpoint
   accelerations are data-parallel; Δv is a cumsum and Δp a cumsum of the
   shifted-velocity series.
3. **Jacobian/covariance**: the pair recursion ``(J, P) ← (F·J, F·P·Fᵀ +
   V·Q·Vᵀ)`` composes affine maps, associative with the combine ``(A₂A₁,
   A₂B₁A₂ᵀ + B₂)`` (the later sample as A₂). Only the final pair is used, so
   it is a pairwise tree reduction over the samples padded to a power of two
   with the identity pair ``(I, 0)``.

Padded (invalid) samples contribute identity increments, so any mask works;
"previous sample" is a last-valid gather (``cummax``), as the sequential
carry only advances on valid samples. Every function broadcasts over leading
batch axes (the window's F intervals), so a window is preintegrated in one
pass. The JAX package's counterpart is its ``preintegration/parallel.py``.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..geometry.so3 import quat_conj, quat_mul, quat_normalize, quat_to_mat, right_jacobian_so3, skew
from .imu import ImuPreint, _block_rows
from .wheel import WheelPreint


def _last_valid_prev(x0: Tensor, xs: Tensor, valid: Tensor) -> Tensor:
    """prev[..., k, :] = the last valid sample before k (``x0`` if none).

    Mirrors the sequential carry that only advances ``acc_0``/``gyr_0`` on
    valid samples. ``xs`` [..., K, 3], ``valid`` [..., K], ``x0`` [..., 3]."""
    k = valid.shape[-1]
    ar = torch.arange(k, device=valid.device).expand(valid.shape)
    idx = torch.where(valid, ar, torch.full_like(ar, -1))
    run = torch.cummax(idx, dim=-1).values
    prev_idx = torch.cat([torch.full_like(run[..., :1], -1), run[..., :-1]], dim=-1)
    gathered = torch.gather(xs, -2, prev_idx.clamp(min=0)[..., None].expand(xs.shape))
    return torch.where((prev_idx >= 0)[..., None], gathered, x0[..., None, :])


def _prefix_quats(dqs: Tensor) -> Tensor:
    """All prefix products q_k = dq_1 ⊗ … ⊗ dq_k along axis -2, normalized
    (Hillis-Steele inclusive scan)."""
    x = dqs
    k = dqs.shape[-2]
    s = 1
    while s < k:
        x = torch.cat([x[..., :s, :], quat_mul(x[..., : k - s, :], x[..., s:, :])], dim=-2)
        s *= 2
    return quat_normalize(x)


def _affine_pair_reduce(F: Tensor, G: Tensor):
    """The composite (ΠF, accumulated covariance) of the recursion
    P ← F P Fᵀ + G over axis -3 (samples in order), by a pairwise tree."""
    k, n = F.shape[-3], F.shape[-1]
    size = 1
    while size < k:
        size *= 2
    if size > k:
        pad = size - k
        eye = torch.eye(n, dtype=F.dtype, device=F.device).expand(F.shape[:-3] + (pad, n, n))
        F = torch.cat([F, eye], dim=-3)
        G = torch.cat([G, torch.zeros_like(eye)], dim=-3)
    while F.shape[-3] > 1:
        A1, A2 = F[..., 0::2, :, :], F[..., 1::2, :, :]
        B1, B2 = G[..., 0::2, :, :], G[..., 1::2, :, :]
        F = A2 @ A1
        G = A2 @ B1 @ A2.mT + B2
    return F[..., 0, :, :], G[..., 0, :, :]


def _increments(w_mid: Tensor, dt: Tensor) -> Tensor:
    """Unnormalized attitude increments [1, ½·ω·dt] per sample."""
    half = 0.5 * w_mid * dt[..., None]
    return torch.cat([torch.ones_like(half[..., 0:1]), half], dim=-1)


def _shift_in(first: Tensor, xs: Tensor) -> Tensor:
    """[first, xs[0], …, xs[K-2]] along axis -2."""
    return torch.cat([first.expand(xs.shape[:-2] + (1, xs.shape[-1])), xs[..., :-1, :]], dim=-2)


def preintegrate_parallel(dts, accs, gyrs, valid, acc_0, gyr_0, ba, bg, noise18) -> ImuPreint:
    """Parallel equivalent of :func:`.imu.preintegrate` (same arguments,
    any leading batch axes)."""
    kw = dict(dtype=accs.dtype, device=accs.device)
    vm = valid.to(accs.dtype)
    dt = dts * vm
    dt2 = dt[..., None, None]

    acc_prev = _last_valid_prev(acc_0, accs, valid)
    gyr_prev = _last_valid_prev(gyr_0, gyrs, valid)

    # 1. attitude chain
    un_gyr = (0.5 * (gyr_prev + gyrs) - bg[..., None, :]) * vm[..., None]
    q_k = _prefix_quats(_increments(un_gyr, dt))              # [..., K, 4] after sample k
    q_prev = _shift_in(torch.tensor([1.0, 0.0, 0.0, 0.0], **kw), q_k)
    R0 = quat_to_mat(q_prev)
    R1 = quat_to_mat(q_k)

    # 2. velocity / position cumsums
    a0 = acc_prev - ba[..., None, :]
    a1 = accs - ba[..., None, :]
    un_acc = 0.5 * ((R0 @ a0[..., None])[..., 0] + (R1 @ a1[..., None])[..., 0]) * vm[..., None]
    v_pref = torch.cumsum(un_acc * dt[..., None], dim=-2)
    v_prev = _shift_in(torch.zeros(3, **kw), v_pref)
    dp = v_prev * dt[..., None] + 0.5 * un_acc * (dt * dt)[..., None]
    delta_p = dp.sum(dim=-2)
    delta_v = v_pref[..., -1, :]
    sum_dt = dt.sum(dim=-1)

    # 3. batched F, V·Q·Vᵀ and the affine pair reduction
    w_x, a0_x, a1_x = skew(un_gyr), skew(a0), skew(a1)
    I3 = torch.eye(3, **kw).expand(R0.shape)
    Z3 = torch.zeros_like(R0)
    R1a1 = R1 @ a1_x
    R0a0 = R0 @ a0_x
    ImWdt = I3 - w_x * dt2
    F = _block_rows([
        [I3, -0.25 * R0a0 * dt2 * dt2 - 0.25 * (R1a1 @ ImWdt) * dt2 * dt2, I3 * dt2,
         -0.25 * (R0 + R1) * dt2 * dt2, 0.25 * R1a1 * dt2 * dt2 * dt2],
        [Z3, ImWdt, Z3, Z3, -I3 * dt2],
        [Z3, -0.5 * R0a0 * dt2 - 0.5 * (R1a1 @ ImWdt) * dt2, I3,
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
    ok = valid[..., None, None]
    # invalid samples are identity steps
    F = torch.where(ok, F, torch.eye(15, **kw))
    G = torch.where(ok, V @ noise18 @ V.mT, 0.0)
    J, P = _affine_pair_reduce(F, G)
    return ImuPreint(delta_p, q_k[..., -1, :], delta_v, J, P, sum_dt, ba, bg)


# ---------------------------------------------------------------------------
# Wheel
# ---------------------------------------------------------------------------


def _wheel_chain(s3, dt, vels, vel_prev, gyr_prev, gyrs, vm):
    """(Δp, prefix attitudes, increments, midpoint yaw rates) of the wheel
    chain — differentiable in ``s3 = (sx, sy, sw)`` for the exact intrinsic
    Jacobian."""
    sv_diag = torch.stack([s3[0], s3[1], torch.ones_like(s3[0])])
    un_gyr = 0.5 * s3[2] * (gyr_prev + gyrs) * vm[..., None]
    dqs = _increments(un_gyr, dt)
    q_k = _prefix_quats(dqs)
    q_prev = _shift_in(torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=vels.dtype, device=vels.device),
                       q_k)
    R0 = quat_to_mat(q_prev)
    R1 = quat_to_mat(q_k)
    sv0 = sv_diag * vel_prev
    sv1 = sv_diag * vels
    un_vel = 0.5 * ((R0 @ sv0[..., None])[..., 0] + (R1 @ sv1[..., None])[..., 0]) * vm[..., None]
    delta_p = (un_vel * dt[..., None]).sum(dim=-2)
    return delta_p, q_k, R0, R1, sv0, sv1, un_gyr, dqs


def preintegrate_wheel_parallel(dts, vels, gyrs, valid, vel_0, gyr_0,
                                sx, sy, sw, td, noise12) -> WheelPreint:
    """Parallel equivalent of :func:`.wheel.preintegrate_wheel` (same
    arguments; the intrinsics are shared by the leading batch axes)."""
    kw = dict(dtype=vels.dtype, device=vels.device)
    batch = dts.shape[:-1]
    vm = valid.to(vels.dtype)
    dt = dts * vm
    dt2 = dt[..., None, None]
    vel_prev = _last_valid_prev(vel_0, vels, valid)
    gyr_prev = _last_valid_prev(gyr_0, gyrs, valid)
    s3 = torch.stack([sx, sy, sw])

    delta_p, q_k, R0, R1, sv0, sv1, un_gyr, dqs = _wheel_chain(
        s3, dt, vels, vel_prev, gyr_prev, gyrs, vm)
    delta_q = q_k[..., -1, :]
    sum_dt = dt.sum(dim=-1)

    # covariance: affine pair reduction over 6x6 blocks
    RddT = quat_to_mat(quat_normalize(dqs)).mT
    v1x = skew(sv1)
    Z3 = torch.zeros_like(R0)
    F = torch.cat([
        torch.cat([torch.eye(3, **kw).expand(R0.shape),
                   -0.5 * dt2 * (R0 @ skew(sv0) + R1 @ v1x @ RddT)], dim=-1),
        torch.cat([Z3, RddT], dim=-1),
    ], dim=-2)
    Jr = right_jacobian_so3(un_gyr * dt[..., None])
    sv_m = torch.diag_embed(torch.stack([sx, sy, torch.ones_like(sx)]))
    v03 = -0.25 * dt2 * dt2 * (R1 @ v1x @ Jr)
    v33 = 0.5 * Jr * sw * dt2
    V = torch.cat([
        torch.cat([0.5 * dt2 * (R0 @ sv_m), v03, 0.5 * dt2 * (R1 @ sv_m), v03], dim=-1),
        torch.cat([Z3, v33, Z3, v33], dim=-1),
    ], dim=-2)
    ok = valid[..., None, None]
    F = torch.where(ok, F, torch.eye(6, **kw))
    G = torch.where(ok, V @ noise12 @ V.mT, 0.0)
    _, P = _affine_pair_reduce(F, G)

    # exact intrinsic Jacobian: forward-mode AD through the parallel chain
    def deltas(s):
        p, qk, *_ = _wheel_chain(s, dt, vels, vel_prev, gyr_prev, gyrs, vm)
        return p, qk[..., -1, :]

    dp_ds, dq_ds = torch.func.jacfwd(deltas)(s3)           # [..., 3, 3], [..., 4, 3]
    # quaternion derivative -> right-tangent: δθ_col = 2 (q^-1 ⊗ dq)_vec
    dtheta_ds = 2.0 * quat_mul(quat_conj(delta_q)[..., None, :], dq_ds.mT)[..., 1:4].mT
    Jix = torch.cat([dp_ds, dtheta_ds], dim=-2)

    n_valid = valid.to(torch.int64).sum(dim=-1)
    idx = (n_valid - 1).clamp(min=0)[..., None, None].expand(batch + (1, 3))
    any_valid = (n_valid > 0)[..., None]
    vel_1 = torch.where(any_valid, torch.gather(vels, -2, idx)[..., 0, :], vel_0)
    gyr_1 = torch.where(any_valid, torch.gather(gyrs, -2, idx)[..., 0, :], gyr_0)
    sxb, syb, swb, tdb = (s.expand(batch) for s in (sx, sy, sw, td))
    return WheelPreint(delta_p, delta_q, Jix, P, sum_dt, sxb, syb, swb, tdb,
                       vel_0, gyr_0, vel_1, gyr_1)
