"""Intrinsic camera calibration: chessboard corners + Zhang init + LM refine.

The counterpart of the camodocal calibration tool
(``camera_models/src/intrinsic_calib.cc`` + chessboard detection under
``camera_models/src/chessboard/`` — SURVEY §2 #13): corner detection is a
ChESS-style ring response evaluated densely over the image (elementwise work
on the image's device), grid ordering is host-side PCA + row clustering, the
closed-form initialization is Zhang's homography method (NumPy), and the
final bundle refinement differentiates the *same* projection code the runtime
uses (:mod:`.models`) with ``torch.func.jacfwd`` — batched over all views ×
corners, normal equations and the step's acceptance on the device.

Calibration is a library call of its own: ``calibrate(model, world_xy,
img_pts)`` runs on ``device`` (``None`` = the GPU) in the dtype of the
numpy observations (float64 for float64 inputs).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import jacfwd

from .. import resolve_device
from ..geometry.so3 import quat_exp, quat_mul, quat_normalize, quat_rotate
from .models import (
    EquidistantParams,
    MeiParams,
    PinholeFullParams,
    PinholeParams,
    ScaramuzzaParams,
    equidistant_space_to_plane,
    mei_space_to_plane,
    pinhole_full_space_to_plane,
    pinhole_space_to_plane,
    scaramuzza_space_to_plane_zfwd,
)


# ---------------------------------------------------------------------------
# Chessboard corner detection
# ---------------------------------------------------------------------------


def chess_response(img: torch.Tensor, radius: int = 3) -> torch.Tensor:
    """ChESS-style x-corner response: on a ring of 16 samples, a chessboard
    saddle has opposite samples alike and quadrature samples unlike —
    response = Σ|I(θ) − I(θ+90°)| − Σ|I(θ) − I(θ+180°)|."""
    angles = np.linspace(0, 2 * np.pi, 16, endpoint=False)
    offs = np.stack([np.round(radius * np.cos(angles)),
                     np.round(radius * np.sin(angles))], -1).astype(int)
    ring = torch.stack([torch.roll(img, (-int(dy), -int(dx)), dims=(0, 1))
                        for dx, dy in offs])                     # [16,H,W]
    quad = torch.abs(ring - torch.roll(ring, 4, dims=0)).sum(0)
    anti = torch.abs(ring - torch.roll(ring, 8, dims=0)).sum(0)
    resp = quad - anti
    h, w = img.shape
    ys = torch.arange(h, device=img.device)[:, None]
    xs = torch.arange(w, device=img.device)[None, :]
    edge = (ys < radius) | (ys >= h - radius) | (xs < radius) | (xs >= w - radius)
    return torch.where(edge, torch.zeros_like(resp), torch.clamp(resp, min=0.0))


def detect_corners(img: torch.Tensor, max_corners: int, nms: int = 5):
    """Top-K x-corner peaks with NMS → (pts [K,2] xy, score [K]), on the
    image's device."""
    resp = chess_response(img)
    # deterministic sub-ulp ramp so flat response plateaus (piecewise-constant
    # synthetic images) resolve to a single NMS winner per neighborhood
    h, w = img.shape
    ramp = (torch.arange(h, device=img.device)[:, None] * w
            + torch.arange(w, device=img.device)[None, :]).to(resp.dtype)
    resp = torch.where(resp > 0, resp - 1e-6 * ramp, torch.zeros_like(resp))
    # a (2·nms+1)² max filter, "SAME" with -inf padding
    dil = F.max_pool2d(resp[None, None], 2 * nms + 1, stride=1, padding=nms)[0, 0]
    peak = (resp == dil) & (resp > 0)
    score = torch.where(peak, resp, torch.full_like(resp, -torch.inf)).reshape(-1)
    # top-k with ties to the lowest index, as lax.top_k
    vals, idx = torch.sort(score, descending=True, stable=True)
    vals, idx = vals[:max_corners], idx[:max_corners]
    pts = torch.stack([(idx % w).to(img.dtype), (idx // w).to(img.dtype)], -1)
    return pts, vals


def order_grid(pts: np.ndarray, rows: int, cols: int) -> np.ndarray | None:
    """Order detected corners into a row-major (rows × cols) grid via PCA
    axes + per-row sort. Host-side, mirrors the role of
    cv::findChessboardCorners' ordering; returns None if clustering fails."""
    if len(pts) < rows * cols:
        return None
    pts = np.asarray(pts[: rows * cols], float)
    c = pts - pts.mean(0)
    _, _, vt = np.linalg.svd(c, full_matrices=False)
    a, b = vt[0], vt[1]
    # long axis = columns direction if cols >= rows
    u = c @ a
    v = c @ b
    order = np.argsort(v, kind="stable")
    grid = []
    for r in range(rows):
        row_idx = order[r * cols: (r + 1) * cols]
        row_sorted = row_idx[np.argsort(u[row_idx], kind="stable")]
        grid.append(row_sorted)
    out = pts[np.concatenate(grid)]
    # sanity: rows should be monotone in v on average
    return out


# ---------------------------------------------------------------------------
# Zhang closed-form initialization (NumPy)
# ---------------------------------------------------------------------------


def homography_dlt(world_xy: np.ndarray, img_xy: np.ndarray) -> np.ndarray:
    """Normalized DLT homography world-plane → image (units: pixels)."""
    def norm(p):
        m = p.mean(0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(p - m, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * m[0]], [0, s, -s * m[1]], [0, 0, 1.0]])
        ph = np.concatenate([p, np.ones((len(p), 1))], 1)
        return (T @ ph.T).T, T

    wn, Tw = norm(world_xy)
    im, Ti = norm(img_xy)
    rows = []
    for (X, Y, _), (u, v, _) in zip(wn, im):
        rows.append([-X, -Y, -1, 0, 0, 0, u * X, u * Y, u])
        rows.append([0, 0, 0, -X, -Y, -1, v * X, v * Y, v])
    _, _, vt = np.linalg.svd(np.asarray(rows))
    H = vt[-1].reshape(3, 3)
    H = np.linalg.inv(Ti) @ H @ Tw
    return H / H[2, 2]


def zhang_intrinsics(Hs: list[np.ndarray]) -> tuple[float, float, float, float]:
    """Closed-form fx, fy, cx, cy from ≥3 homographies (zero skew)."""
    def vij(H, i, j):
        return np.array([
            H[0, i] * H[0, j],
            H[0, i] * H[1, j] + H[1, i] * H[0, j],
            H[1, i] * H[1, j],
            H[2, i] * H[0, j] + H[0, i] * H[2, j],
            H[2, i] * H[1, j] + H[1, i] * H[2, j],
            H[2, i] * H[2, j],
        ])

    V = []
    for H in Hs:
        V.append(vij(H, 0, 1))
        V.append(vij(H, 0, 0) - vij(H, 1, 1))
    _, _, vt = np.linalg.svd(np.asarray(V))
    b11, b12, b22, b13, b23, b33 = vt[-1]
    cy = (b12 * b13 - b11 * b23) / (b11 * b22 - b12 * b12)
    lam = b33 - (b13 * b13 + cy * (b12 * b13 - b11 * b23)) / b11
    fx = np.sqrt(abs(lam / b11))
    fy = np.sqrt(abs(lam * b11 / (b11 * b22 - b12 * b12)))
    cx = -b13 * fx * fx / lam
    return float(fx), float(fy), float(cx), float(cy)


def pose_from_homography(H: np.ndarray, K: np.ndarray) -> np.ndarray:
    """Extrinsic [t, q] (board → camera) from a homography and intrinsics."""
    A = np.linalg.inv(K) @ H
    s = 1.0 / np.mean([np.linalg.norm(A[:, 0]), np.linalg.norm(A[:, 1])])
    if A[2, 2] * s < 0:  # board must be in front
        s = -s
    r1 = A[:, 0] * s
    r2 = A[:, 1] * s
    t = A[:, 2] * s
    r3 = np.cross(r1, r2)
    R = np.stack([r1, r2, r3], axis=1)
    u, _, vt = np.linalg.svd(R)
    R = u @ vt
    if np.linalg.det(R) < 0:
        R = u @ np.diag([1, 1, -1]) @ vt
    tr = np.trace(R)
    qw = np.sqrt(max(tr + 1.0, 1e-12)) / 2
    qx = (R[2, 1] - R[1, 2]) / (4 * qw)
    qy = (R[0, 2] - R[2, 0]) / (4 * qw)
    qz = (R[1, 0] - R[0, 1]) / (4 * qw)
    q = np.array([qw, qx, qy, qz])
    return np.concatenate([t, q / np.linalg.norm(q)])


# ---------------------------------------------------------------------------
# Joint LM refinement (autodiff through the runtime projection)
# ---------------------------------------------------------------------------


class CalibResult(NamedTuple):
    params: object           # the calibrated model's params NamedTuple
    poses: np.ndarray        # [V, 7] board→camera
    rms_px: float


def scaramuzza_project_zfwd(cam, pts):
    """Scaramuzza projection of z-FORWARD camera-frame points (the board
    poses use the pinhole convention, board in front ⇒ z > 0) — the same
    bridge the dispatched runtime model uses."""
    return scaramuzza_space_to_plane_zfwd(cam, pts)


# exact change of polynomial basis ψ = π/2 − θ:
# Σ_k b_k ψ^k = Σ_j [Σ_k C(k,j)(π/2)^(k−j)(−1)^j b_k] θ^j
def _psi2theta(n: int = 6) -> np.ndarray:
    from math import comb

    M = np.zeros((n, n))
    for k in range(n):
        for j in range(k + 1):
            M[j, k] = comb(k, j) * (np.pi / 2) ** (k - j) * (-1.0) ** j
    return M


_PSI2THETA = _psi2theta(6)


def _scaramuzza_finalize(params, poses):
    """Canonicalize + complete the calibrated OCam model.

    1. Sign gauge: the reprojection cost is invariant under
       ``inv_poly → −inv_poly`` composed with a 180° rotation of every board
       pose about the optical axis (ρ and the image direction both negate).
       If LM landed in the mirror basin (mid-field ρ < 0), flip both back.
    2. Fit the cam2world polynomial (a0..a4) from the calibrated world2cam
       inverse so the returned model round-trips through the runtime's own
       lift/project pair. Self-consistency of the model equations: a pixel
       at radius ρ lifts to ray (u, v, −z(ρ)); projecting it back needs
       ``inv_poly(atan2(z, ρ)) = ρ``, i.e. ``z(ρ) = ρ·tan(θ)`` with θ the
       inverse of ρ(θ). Sampled over the calibrated field + linear LSQ."""
    inv = params.inv_poly.detach().cpu().numpy().astype(np.float64)
    poses = np.asarray(poses)
    c = float(params.c)
    d = float(params.d)
    e = float(params.e)
    if c < 0.0:
        # reflection gauge: A·diag(−1,1) with u → −u is cost-invariant for a
        # PLANAR target (the compensating board-pose reflection composes with
        # the free board-plane flip z_w → −z_w into a proper rotation).
        # Canonical form keeps c > 0 (physical OCam affine ≈ identity).
        c, e = -c, -e
        poses = poses.copy()
        # p_c' = M p_c with M = diag(−1,1,1) (wrapper frame); board flip
        # Dz = diag(1,1,−1) on the world side: R'' = M R Dz, t'' = M t
        for i in range(len(poses)):
            t = poses[i, 0:3].copy()
            qw, qx, qy, qz = poses[i, 3:7]
            R = np.array([
                [1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz), 2 * (qx * qz + qw * qy)],
                [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz), 2 * (qy * qz - qw * qx)],
                [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx), 1 - 2 * (qx * qx + qy * qy)],
            ])
            M = np.diag([-1.0, 1.0, 1.0])
            Dz = np.diag([1.0, 1.0, -1.0])
            R2 = M @ R @ Dz
            t2 = M @ t
            tr = np.trace(R2)
            qw2 = np.sqrt(max(tr + 1.0, 1e-12)) / 2
            q2 = np.array([
                qw2,
                (R2[2, 1] - R2[1, 2]) / (4 * qw2),
                (R2[0, 2] - R2[2, 0]) / (4 * qw2),
                (R2[1, 0] - R2[0, 1]) / (4 * qw2),
            ])
            poses[i, 0:3] = t2
            poses[i, 3:7] = q2 / np.linalg.norm(q2)
    like = params.inv_poly

    def tensor(v):
        return torch.as_tensor(v, dtype=like.dtype, device=like.device)

    params = params._replace(c=tensor(c), d=tensor(d), e=tensor(e))
    if np.polyval(inv[::-1], np.pi / 2 - 0.3) < 0.0:
        inv = -inv
        # rotate every board pose 180° about the (z-forward) optical axis:
        # t' = diag(−1,−1,1)·t, q' = q_z(π) ⊗ q
        poses = poses.copy()
        poses[:, 0] *= -1.0
        poses[:, 1] *= -1.0
        qz = np.array([0.0, 0.0, 0.0, 1.0])
        q = poses[:, 3:7]
        poses[:, 3:7] = np.stack([
            qz[0] * q[:, 0] - qz[3] * q[:, 3],
            qz[0] * q[:, 1] - qz[3] * q[:, 2],
            qz[0] * q[:, 2] + qz[3] * q[:, 1],
            qz[0] * q[:, 3] + qz[3] * q[:, 0],
        ], axis=1)

    # fit only over the physically calibrated field: the largest ψ-prefix on
    # which ρ(ψ) is positive and monotone (the fitted inverse polynomial is
    # meaningless extrapolated beyond the observed FOV)
    psi = np.linspace(0.01, 1.2, 2000)
    theta = np.pi / 2 - psi
    rho = np.polyval(inv[::-1], theta)
    good = (rho > 1e-6) & (rho < 4000.0)
    good[1:] &= np.diff(rho) > 0
    stop = int(np.argmin(good)) if not good.all() else len(good)
    theta, rho = theta[:stop][good[:stop]], rho[:stop][good[:stop]]
    z = rho * np.tan(theta)
    A = np.vander(rho, 5, increasing=True)
    a, *_ = np.linalg.lstsq(A, z, rcond=None)
    return ScaramuzzaParams(
        poly=tensor(a),
        inv_poly=tensor(inv),
        c=params.c, d=params.d, e=params.e,
        cx=params.cx, cy=params.cy,
    ), poses


def _scaramuzza_params(i: torch.Tensor) -> ScaramuzzaParams:
    # placeholder cam2world poly: the projection residual never reads it;
    # _scaramuzza_finalize fits the real one
    psi2theta = torch.as_tensor(_PSI2THETA, dtype=i.dtype, device=i.device)
    return ScaramuzzaParams(poly=torch.zeros(5, dtype=i.dtype, device=i.device),
                            inv_poly=psi2theta @ i[0:6], c=i[6], d=i[7], e=i[8],
                            cx=i[9], cy=i[10])


# intrinsic-vector ↔ model bindings: (n_intr, intr→params, project,
# zhang-init→intr0[, finalize]). The reference tool selects the model by flag
# (intrinsic_calib.cc --camera-model {pinhole|mei|kannala-brandt|scaramuzza});
# every refinement differentiates the SAME projection the runtime uses.
def _model_bindings():
    return {
        "pinhole": (
            8,
            lambda i: PinholeParams(*i.unbind(0)),
            pinhole_space_to_plane,
            lambda fx, fy, cx, cy: [fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0],
        ),
        # rational-polynomial distortion (PinholeFullCamera.cc): same Zhang
        # seed, 12-dim intrinsic vector
        "pinhole_full": (
            12,
            lambda i: PinholeFullParams(*i.unbind(0)),
            pinhole_full_space_to_plane,
            lambda fx, fy, cx, cy: [fx, fy, cx, cy] + [0.0] * 8,
        ),
        # Kannala-Brandt fisheye: Zhang's pinhole estimate seeds (mu, mv);
        # the theta-polynomial coefficients start at the ideal-equidistant 0
        "equidistant": (
            8,
            lambda i: EquidistantParams(*i.unbind(0)),
            equidistant_space_to_plane,
            lambda fx, fy, cx, cy: [fx, fy, cx, cy, 0.0, 0.0, 0.0, 0.0],
        ),
        # Mei catadioptric: camodocal's init convention fixes xi=1 and scales
        # the projective focal to gamma = f·(1+xi) (CataCamera::
        # estimateIntrinsics); LM then frees xi
        "mei": (
            9,
            lambda i: MeiParams(*i.unbind(0)),
            mei_space_to_plane,
            lambda fx, fy, cx, cy: [1.0, 2.0 * fx, 2.0 * fy, cx, cy,
                                    0.0, 0.0, 0.0, 0.0],
        ),
        # Scaramuzza/OCam (intrinsic_calib.cc:102,127 'scaramuzza'): the
        # reprojection residual exercises only the world2cam inverse
        # polynomial (+ affine C/D/E + center), so the intrinsic vector is
        # [ρ-poly(6) in ψ, c, d, e, cx, cy]; the cam2world polynomial is
        # fitted afterwards from the calibrated inverse
        # (``_scaramuzza_finalize``). The LM variable is the polynomial in
        # ψ = π/2 − θ (angle from the optical axis) — the model's raw
        # θ-basis is centered at π/2 and hopelessly ill-conditioned over a
        # camera FOV; the ψ→θ coefficient map is the exact constant binomial
        # matrix ``_PSI2THETA``. Seed: equidistant ρ(ψ) = f·ψ, Zhang focal.
        "scaramuzza": (
            11,
            _scaramuzza_params,
            scaramuzza_project_zfwd,
            # Zhang's closed form systematically underestimates a fisheye
            # focal (the homography sees the compressed periphery), so seed a
            # fan of focal scalings and let the short-LM pre-pass pick
            # (multi-start; the reference tool's per-model estimateIntrinsics
            # plays this role)
            lambda fx, fy, cx, cy: [
                [0.0, s * 0.5 * (fx + fy), 0.0, 0.0, 0.0, 0.0,
                 1.0, 0.0, 0.0, cx, cy]
                for s in (1.0, 1.3, 1.6, 2.0)
            ],
            _scaramuzza_finalize,
        ),
    }


def calibrate(model: str, world_xy: np.ndarray, img_pts: list[np.ndarray],
              iters: int = 30, device=None) -> CalibResult:
    """Full calibration of any supported model from V views of a planar grid.

    ``world_xy`` [N,2] board coords (z=0), ``img_pts`` list of [N,2] pixel
    observations. Zhang closed-form init (NumPy) → LM over the model's
    intrinsic vector + V·6 pose tangents on ``device`` (``None`` = the GPU),
    in the dtype of ``img_pts``; Jacobians by ``torch.func.jacfwd`` of the
    runtime projection model (the autodiff twin of camodocal's per-model
    analytic calibration, ``intrinsic_calib.cc``). Each LM step's acceptance
    is a ``torch.where`` on the device; the host reads only the multi-start
    pre-pass's costs and the final result."""
    bindings = _model_bindings()
    if model not in bindings:
        raise ValueError(f"unsupported calibration model {model!r} "
                         f"(have {sorted(bindings)})")
    device = resolve_device(device)
    n_intr, make_params, project, init, *rest = bindings[model]
    finalize = rest[0] if rest else None

    V = len(img_pts)
    Hs = [homography_dlt(world_xy, p) for p in img_pts]
    fx, fy, cx, cy = zhang_intrinsics(Hs)
    K = np.array([[fx, 0, cx], [0, fy, cy], [0, 0, 1.0]])
    poses0 = np.stack([pose_from_homography(H, K) for H in Hs])

    pts_px = torch.as_tensor(np.stack(img_pts), device=device)       # [V,N,2]
    dtype = pts_px.dtype
    dev = dict(dtype=dtype, device=device)
    pts_w = torch.as_tensor(np.concatenate([world_xy, np.zeros((len(world_xy), 1))], 1),
                            **dev)
    seeds = init(fx, fy, cx, cy)
    multi_start = bool(seeds) and isinstance(seeds[0], list)
    tang0 = torch.zeros((V, 6), **dev)

    def all_res(intr, tangents, poses):
        """Residuals of every view, [V·N·2]: each board pose moved by its
        tangent (translation, then a rotation on the right), the board
        projected through the model."""
        cam = make_params(intr)
        dq = quat_exp(tangents[:, 3:6])
        q = quat_normalize(quat_mul(poses[:, 3:7], dq))
        t = poses[:, 0:3] + tangents[:, 0:3]
        pc = quat_rotate(q[:, None, :], pts_w[None]) + t[:, None, :]
        return (project(cam, pc) - pts_px).reshape(-1)

    def lm_step(intr, poses, lam):
        def joint(x):
            r = all_res(x[:n_intr], x[n_intr:].reshape(V, 6), poses)
            return r, r

        # one forward-mode pass for the intrinsic and pose-tangent columns,
        # the residual riding along as the primal
        J, r = jacfwd(joint, has_aux=True)(torch.cat([intr, tang0.reshape(-1)]))
        H = J.T @ J
        g = J.T @ r
        damp = lam * torch.diagonal(H) + 1e-9
        delta = torch.linalg.solve(H + torch.diag(damp), -g)
        intr2 = intr + delta[:n_intr]
        tang = delta[n_intr:].reshape(V, 6)
        q2 = quat_normalize(quat_mul(poses[:, 3:7], quat_exp(tang[:, 3:6])))
        poses2 = torch.cat([poses[:, 0:3] + tang[:, 0:3], q2], dim=1)
        cost2 = torch.sum(all_res(intr2, tang0, poses2) ** 2)
        better = cost2 < torch.sum(r ** 2)
        intr = torch.where(better, intr2, intr)
        poses = torch.where(better, poses2, poses)
        lam = torch.where(better, lam * 0.5, lam * 4.0)     # LM trust control
        return intr, poses, torch.clamp(lam, 1e-9, 1e3)

    intr = torch.as_tensor(seeds[0] if multi_start else seeds, **dev)
    poses = torch.as_tensor(poses0, **dev)
    if multi_start:
        # short-LM pre-pass per seed; keep the lowest-cost basin
        best = None
        for s in seeds:
            i_s, p_s, l_s = torch.as_tensor(s, **dev), torch.as_tensor(poses0, **dev), \
                torch.as_tensor(1e-4, **dev)
            for _ in range(max(iters // 4, 5)):
                i_s, p_s, l_s = lm_step(i_s, p_s, l_s)
            c = float(torch.sum(all_res(i_s, tang0, p_s) ** 2))
            if best is None or c < best[0]:
                best = (c, i_s, p_s)
        _, intr, poses = best

    lam = torch.as_tensor(1e-4, **dev)
    for _ in range(iters):
        intr, poses, lam = lm_step(intr, poses, lam)

    r = all_res(intr, tang0, poses)
    rms = float(torch.sqrt(torch.mean(torch.sum(r.reshape(-1, 2) ** 2, dim=-1))))
    params = make_params(intr)
    poses = poses.cpu().numpy()
    if finalize is not None:
        params, poses = finalize(params, poses)
    return CalibResult(params=params, poses=poses, rms_px=rms)


def calibrate_pinhole(world_xy: np.ndarray, img_pts: list[np.ndarray],
                      iters: int = 20, device=None) -> CalibResult:
    """Pinhole-model calibration (see :func:`calibrate`)."""
    return calibrate("pinhole", world_xy, img_pts, iters=iters, device=device)
