"""Visual initialization: relative pose, global SfM, frame PnP.

Re-design of ``initial/solve_5pts.cpp`` (essential-matrix relative pose
:207-243), ``initial/initial_sfm.cpp`` (GlobalSFM::construct /
constructWithDepth) and the pivot-frame search of ``Estimator::relativePose``
(``estimator.cpp:2057-2127``): the data-dependent RANSAC loop becomes a fixed
bank of hypotheses solved side by side (one batch axis), and the SfM's
incremental triangulate-PnP chain becomes fixed passes of per-frame PnP and a
batched multi-view triangulation of every track.

The random draw is the caller's: :func:`relative_pose_ransac` takes the
Gumbel noise ``[n_hyp, N]`` that picks each hypothesis' 8-point set
(``global_layers.pnp.gumbel_noise`` draws it, ``N_HYPOTHESES`` rows, from a
``torch.Generator``), so a test can hand it the JAX package's own draw.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import Tensor

from ..geometry.se3 import pose as make_pose
from ..geometry.so3 import mat_to_quat, quat_to_mat
from ..global_layers.pnp import pnp_gn
from .window import Tracks

N_HYPOTHESES = 32


def _essential_8pt(xi: Tensor, xj: Tensor, w: Tensor) -> Tensor:
    """Weighted 8-point essential matrices from normalized correspondences
    ``xi``, ``xj`` [N,2] and weights ``w`` [..., N] (one fit per row of
    ``w``). Returns E [..., 3, 3], projected onto singular values (1, 1, 0)."""
    ones = torch.ones_like(xi[:, 0])
    A = torch.stack([
        xj[:, 0] * xi[:, 0], xj[:, 0] * xi[:, 1], xj[:, 0],
        xj[:, 1] * xi[:, 0], xj[:, 1] * xi[:, 1], xj[:, 1],
        xi[:, 0], xi[:, 1], ones,
    ], dim=-1)                                               # [N,9]
    Aw = A * w[..., :, None]
    _, V = torch.linalg.eigh(Aw.mT @ Aw)
    E = V[..., :, 0].reshape(w.shape[:-1] + (3, 3))
    U, _, Vt = torch.linalg.svd(E)
    s = torch.tensor([1.0, 1.0, 0.0], dtype=E.dtype, device=E.device)
    return (U * s) @ Vt


def _decompose_essential(E: Tensor):
    """Four (R, t) candidates from E, stacked: R [4,3,3], t [4,3]."""
    U, _, Vt = torch.linalg.svd(E)
    # enforce proper rotations
    U = U * torch.sign(torch.linalg.det(U))
    Vt = Vt * torch.sign(torch.linalg.det(Vt))
    W = torch.tensor([[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
                     dtype=E.dtype, device=E.device)
    R1 = U @ W @ Vt
    R2 = U @ W.T @ Vt
    t = U[:, 2]
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def _triangulate_pair(R: Tensor, t: Tensor, xi: Tensor, xj: Tensor):
    """Linear triangulation of points in frame i; camera j is (R, t):
    x_j = R x_i + t. Returns (depths in frame i, depths in frame j)."""
    ones = torch.ones_like(xi[:, 0:1])
    ri = torch.cat([xi, ones], dim=-1)                       # ray in frame i
    Rri = ri @ R.T                                           # [N,3]
    xjh = torch.cat([xj, ones], dim=-1)
    # cross(xjh, z*Rri + t) = 0 → z * cross(xjh, Rri) = -cross(xjh, t)
    a = torch.linalg.cross(xjh, Rri, dim=-1)
    b = -torch.linalg.cross(xjh, t.expand_as(Rri), dim=-1)
    z = torch.sum(a * b, dim=-1) / torch.clamp(torch.sum(a * a, dim=-1), min=1e-12)
    p_j = (ri * z[:, None]) @ R.T + t
    return z, p_j[:, 2]


def _sampson(E: Tensor, a: Tensor, b: Tensor) -> Tensor:
    """Sampson distances of the pairs (a, b) [N,2] under E [..., 3, 3]."""
    ones = torch.ones_like(a[:, 0:1])
    ah = torch.cat([a, ones], dim=-1)
    bh = torch.cat([b, ones], dim=-1)
    Ea = ah @ E.mT                                           # [..., N, 3]
    Etb = bh @ E
    num = torch.sum(bh * Ea, dim=-1) ** 2
    den = Ea[..., 0] ** 2 + Ea[..., 1] ** 2 + Etb[..., 0] ** 2 + Etb[..., 1] ** 2
    return num / torch.clamp(den, min=1e-12)


def minimal_sets(noise: Tensor, valid: Tensor, k: int) -> Tensor:
    """Indices [n_hyp, k] of each hypothesis' minimal set: the ``k`` largest
    draws among the valid rows; with fewer than ``k`` valid rows the invalid
    ones fill up in index order (as ``jax.lax.top_k`` breaks ties)."""
    scores = torch.where(valid[None, :], noise, torch.full_like(noise, -torch.inf))
    return torch.sort(scores, dim=1, descending=True, stable=True).indices[:, :k]


def relative_pose_ransac(xi: Tensor, xj: Tensor, valid: Tensor, noise: Tensor,
                         thresh: float = 0.3 / 460.0):
    """Fixed-round RANSAC over 8-point minimal sets + cheirality selection
    (MotionEstimator::solveRelativeRT, solve_5pts.cpp:207-243).

    xi, xj [N,2] normalized; valid [N]; noise [n_hyp, N] Gumbel draws that
    pick each hypothesis' 8 points among the valid entries (fewer than 8
    valid: the invalid rows fill up in index order). Returns (pose_j_in_i
    [7] with unit translation, inliers [N], ok) as tensors; nothing is
    fetched to the host."""
    dtype = xi.dtype
    t2 = thresh * thresh
    idx = minimal_sets(noise, valid, 8)
    sel = torch.zeros_like(noise).scatter(1, idx, torch.ones_like(idx, dtype=dtype))
    Es = _essential_8pt(xi, xj, sel)                         # [H,3,3]
    counts = (valid[None, :] & (_sampson(Es, xi, xj) < t2)).sum(dim=1)
    E = Es[torch.argmax(counts)]
    # refit on inliers
    inl = valid & (_sampson(E, xi, xj) < t2)
    E = _essential_8pt(xi, xj, inl.to(dtype))
    inl = valid & (_sampson(E, xi, xj) < t2)

    # cheirality: the candidate with most positive depths (first on ties)
    Rs, ts = _decompose_essential(E)
    cheir = []
    for c in range(4):
        zi, zj = _triangulate_pair(Rs[c], ts[c], xi, xj)
        cheir.append(torch.sum(inl & (zi > 0) & (zj > 0)))
    cheir = torch.stack(cheir)
    bi = torch.argmax(cheir)
    R, t = Rs[bi], ts[bi]
    # camera j pose in frame i: x_j = R x_i + t ⇒ T_i_j = (Rᵀ, −Rᵀ t)
    pose_ij = make_pose(-R.T @ t, mat_to_quat(R.T))
    n_inl = inl.sum()
    ok = (n_inl >= 15) & (cheir[bi] > 0.7 * n_inl)
    return pose_ij, inl, ok


def find_pivot_frame(tracks: Tracks, min_parallax: float = 30.0 / 460.0,
                     min_corr: int = 20) -> int:
    """The reference's pivot search (``Estimator::relativePose``,
    estimator.cpp:2057-2127): earliest frame l with enough correspondences to
    the newest frame and mean parallax above 30/460. Host-side (tiny)."""
    ov = tracks.obs_valid.cpu().numpy()
    obs = tracks.obs[..., 0:2].cpu().numpy()
    newest = ov.shape[1] - 1
    for l in range(newest):
        both = ov[:, l] & ov[:, newest]
        if both.sum() < min_corr:
            continue
        par = np.linalg.norm(obs[both, l] - obs[both, newest], axis=1)
        if par.mean() > min_parallax:
            return l
    return -1


def sfm_construct(tracks: Tracks, noise: Tensor, dtype=torch.float64, use_depth: bool = False):
    """Global SfM over the window (initial_sfm.cpp construct): pivot two-view
    relative pose → triangulate → PnP every other frame → triangulate all,
    on the tracks' device in ``dtype``. ``noise`` [n_hyp, ML] is the pivot
    RANSAC's Gumbel draw. With ``use_depth`` the monocular-scale cloud is
    rescaled to metric by the median ratio of measured RGBD depths to
    triangulated depths at the pivot frame — the role of
    ``GlobalSFM::constructWithDepth`` (one robust global scale instead of
    per-point depth substitution).
    Returns (poses [F,7] — cam frames, world = pivot cam; ok), or (None,
    False) when no pivot frame or relative pose is found."""
    ml, f = tracks.obs_valid.shape
    l = find_pivot_frame(tracks)
    if l < 0:
        return None, False
    newest = f - 1
    dev = tracks.obs.device
    ov = tracks.obs_valid
    obs = tracks.obs.to(dtype)

    both = ov[:, l] & ov[:, newest]
    pose_rel, inl, ok = relative_pose_ransac(obs[:, l, 0:2], obs[:, newest, 0:2], both,
                                             noise.to(dtype))
    if not bool(ok):
        return None, False

    # triangulate pivot-pair points (world = pivot camera frame)
    R = quat_to_mat(pose_rel[3:7]).T            # x_new = R x_l + t
    t = -R @ pose_rel[0:3]
    zi, _ = _triangulate_pair(R, t, obs[:, l, 0:2], obs[:, newest, 0:2])
    pts_ok = both & inl & (zi > 0.1)

    if use_depth:
        meas_d = obs[:, l, 4]
        host = torch.stack([(pts_ok & (meas_d > 0.1) & (meas_d < 20.0)).to(dtype), meas_d, zi])
        d_ok, meas_np, zi_np = host.cpu().numpy()
        d_ok = d_ok > 0.5
        if d_ok.sum() >= 8:
            s_med = float(np.median(meas_np[d_ok] / zi_np[d_ok]))
            if s_med > 1e-3:
                zi = zi * s_med
                pose_rel = torch.cat([pose_rel[0:3] * s_med, pose_rel[3:7]])

    ident = torch.tensor([0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0], dtype=dtype, device=dev)
    poses = ident.repeat(f, 1)
    poses[newest] = pose_rel
    rays = torch.cat([obs[:, l, 0:2], torch.ones((ml, 1), dtype=dtype, device=dev)], dim=-1)
    pts_w = rays * zi[:, None]

    # Incremental resection ↔ intersection, the reference's construct order
    # (initial_sfm.cpp: PnP frame i from known points, triangulate (i,
    # newest), then frames before l backwards, then triangulate all) recast
    # as fixed passes of {PnP every resectable frame; batched multi-view
    # re-triangulation of every track over the known poses}.
    known = np.zeros(f, bool)
    known[l] = known[newest] = True
    for _ in range(3):
        n_vis = (pts_ok[:, None] & ov).sum(dim=0).cpu().numpy()      # [F], one fetch
        for k in range(f):
            if known[k] or n_vis[k] < 6:
                continue
            vis = pts_ok & ov[:, k]
            near = min((kk for kk in range(f) if known[kk]), key=lambda kk: abs(kk - k))
            poses[k] = pnp_gn(poses[near], pts_w, obs[:, k, 0:2], vis.to(dtype), iters=10)
            known[k] = True
        known_t = torch.as_tensor(known, device=dev)
        pts_w, pts_ok = _sfm_triangulate_all(poses, known_t, obs, ov)
        if known.all():
            # one more intersection so the final cloud uses every pose
            pts_w, pts_ok = _sfm_triangulate_all(poses, known_t, obs, ov)
            break
    return poses, bool(known.all())


def _sfm_triangulate_all(poses: Tensor, known: Tensor, obs: Tensor, ov: Tensor,
                         reproj_thresh: float = 10.0 / 460.0):
    """Batched multi-view DLT of every track over the frames whose SfM pose
    is known (the intersection half of initial_sfm.cpp's construct loop):
    two rows per observation, smallest eigenvector of the 4×4 normal matrix,
    validity by observation count, cheirality and reprojection error."""
    ml, f = ov.shape
    R = quat_to_mat(poses[:, 3:7])                        # [F,3,3] world_R_cam
    Rt = R.mT
    Pt = -(Rt @ poses[:, 0:3, None])[..., 0]
    P = torch.cat([Rt, Pt[..., None]], dim=-1)            # [F,3,4]

    ray = torch.cat([obs[..., 0:2], torch.ones_like(obs[..., 0:1])], dim=-1)
    fdir = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    row0 = fdir[..., 0:1] * P[None, :, 2, :] - fdir[..., 2:3] * P[None, :, 0, :]
    row1 = fdir[..., 1:2] * P[None, :, 2, :] - fdir[..., 2:3] * P[None, :, 1, :]
    use = ov & known[None, :]
    w = use[..., None].to(obs.dtype)
    A = torch.cat([row0 * w, row1 * w], dim=1)            # [ML,2F,4]
    _, V = torch.linalg.eigh(A.mT @ A)
    v = V[..., 0]
    v3 = v[:, 3:4]
    wpt = v[:, 0:3] / torch.where(torch.abs(v3) > 1e-9, v3, torch.full_like(v3, 1e-9))

    # cheirality + reprojection gate over the known observing frames
    pc = torch.einsum("fij,mfj->mfi", Rt, wpt[:, None, :] - poses[None, :, 0:3])
    proj = pc[..., 0:2] / torch.clamp(pc[..., 2:3], min=1e-6)
    resid = torch.linalg.norm(proj - obs[..., 0:2], dim=-1)
    obs_good = use & (pc[..., 2] > 0.05) & (resid < reproj_thresh)
    n_good = obs_good.sum(dim=1)
    ok = (n_good >= 2) & (n_good >= use.sum(dim=1) - 1)
    return wpt, ok

