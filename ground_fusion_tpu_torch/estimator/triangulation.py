"""Batched landmark triangulation (plain + RGBD depth-verified).

Re-designs ``FeatureManager::triangulate`` (``feature_manager.cpp:669-724``,
per-feature Jacobi SVD loops) and ``triangulateWithDepth`` (``:726-799``,
cross-frame depth-consistency voting) as fully batched tensor programs over
the padded ``Tracks`` table: the SVD null-vector becomes an ``eigh`` of the
4×4 normal matrix per landmark, and the depth-verification double loop over
observation pairs becomes one masked ``[ML, F, F]`` tensor reduce — no
per-feature host iteration anywhere.
"""

from __future__ import annotations

import torch
from torch import Tensor

from ..geometry.se3 import pose_compose, rot, trans
from ..geometry.so3 import quat_conj, quat_mul, quat_rotate, quat_rotate_inv, quat_to_mat
from .window import Tracks, WindowState

INIT_DEPTH = 5.0  # parameters.cpp INIT_DEPTH


def _cam_poses(state: WindowState) -> Tensor:
    """world_T_cam per frame [F, 7]."""
    return pose_compose(state.poses, state.ex_cam[None, :])


def _rays(tracks: Tracks) -> Tensor:
    uv = tracks.obs[..., 0:2]
    return torch.cat([uv, torch.ones_like(uv[..., 0:1])], dim=-1)


def triangulate_with_depth(
    state: WindowState,
    tracks: Tracks,
    depth_min: float = 0.1,
    depth_max: float = 3.0,
    reproj_thresh: float = 10.0 / 460.0,
) -> Tracks:
    """Depth-verified triangulation (``feature_manager.cpp:726-799``): for
    every observation pair (i, j) of a landmark where i carries a valid RGBD
    depth, back-project i's depth, reproject into j, and where the residual
    passes the gate, vote the implied anchor-frame depth; the landmark takes
    the mean of verified votes and is flagged depth-fixed (estimate_flag=1 →
    ``SetParameterBlockConstant``, ``estimator.cpp:3291``)."""
    ml, f = tracks.obs_valid.shape
    dev = tracks.obs.device
    cams = _cam_poses(state)                       # [F,7]
    need = tracks.active & ~tracks.solve_ok & (torch.sum(tracks.obs_valid, dim=1) >= 4)

    rays = _rays(tracks)
    depths = tracks.obs[..., 4]                    # [ML,F]
    depth_ok = tracks.obs_valid & (depths > depth_min) & (depths < depth_max)

    # 3-D point from obs i's depth, in world:  [ML, F, 3]
    pts_cam_i = rays * depths[..., None]
    pts_w = quat_rotate(rot(cams)[None, :, :], pts_cam_i) + trans(cams)[None, :, :]

    # reproject into every frame j:  [ML, F(i), F(j), 3]
    pts_cj = quat_rotate_inv(
        rot(cams)[None, None, :, :], pts_w[:, :, None, :] - trans(cams)[None, None, :, :]
    )
    proj = pts_cj[..., 0:2] / torch.clamp(pts_cj[..., 2:3], min=1e-6)
    resid = torch.linalg.norm(proj - tracks.obs[:, None, :, 0:2], dim=-1)   # [ML,F,F]

    ar = torch.arange(f, device=dev)
    ij_ok = (
        depth_ok[:, :, None]
        & tracks.obs_valid[:, None, :]
        & (ar[None, :, None] != ar[None, None, :])
        & (resid < reproj_thresh)
        & (pts_cj[..., 2] > 1e-3)
    )

    # anchor-frame depth implied by obs i (independent of j): [ML, F]
    anchor_cam = cams[torch.clamp(tracks.start_frame, 0, f - 1)]   # [ML,7]
    z_anchor = quat_rotate_inv(
        rot(anchor_cam)[:, None, :], pts_w - trans(anchor_cam)[:, None, :])[..., 2]
    votes = torch.sum(ij_ok, dim=2)                # [ML,F] — one vote per verified (i,j)
    n_votes = torch.sum(votes, dim=1)
    depth_ave = torch.sum(z_anchor * votes, dim=1) / torch.clamp(n_votes, min=1)

    good = need & (n_votes > 0) & (depth_ave > depth_min)
    inv_depth = torch.where(good, 1.0 / torch.clamp(depth_ave, min=1e-3), tracks.inv_depth)
    return tracks._replace(
        inv_depth=inv_depth,
        solve_ok=tracks.solve_ok | good,
        depth_fixed=tracks.depth_fixed | (need & good),
    )


def triangulate_svd(state: WindowState, tracks: Tracks) -> Tracks:
    """Multi-view linear triangulation for landmarks still lacking depth
    (``feature_manager.cpp:669-724``). Each observation contributes two DLT
    rows in the anchor-camera frame; the homogeneous solution is the smallest
    eigenvector of the batched 4×4 normal matrix AᵀA. Only the ratio
    ``v[2]/v[3]`` is used, so the eigenvector's sign does not matter; for
    landmarks outside ``need`` the vector is arbitrary and is not used."""
    ml, f = tracks.obs_valid.shape
    dtype = tracks.obs.dtype
    cams = _cam_poses(state)
    need = tracks.active & ~tracks.solve_ok & (torch.sum(tracks.obs_valid, dim=1) >= 4)

    anchor_cam = cams[torch.clamp(tracks.start_frame, 0, f - 1)]   # [ML,7]
    # relative projection anchor_cam_T_cam_j -> P = [R^T | -R^T t] of cam j in anchor
    q_rel = quat_mul(quat_conj(rot(anchor_cam))[:, None, :], rot(cams)[None, :, :])
    t_rel = quat_rotate_inv(
        rot(anchor_cam)[:, None, :], trans(cams)[None, :, :] - trans(anchor_cam)[:, None, :]
    )                                                            # [ML,F,3]
    # rows of P: x_cam_j = R_rel^T (X - t_rel)
    R_rel = quat_to_mat(q_rel)                                   # [ML,F,3,3]
    P_rot = R_rel.mT                                             # R_rel^T
    P_t = -(P_rot @ t_rel[..., None])                            # [ML,F,3,1]
    P = torch.cat([P_rot, P_t], dim=-1)                          # [ML,F,3,4]

    ray = _rays(tracks)
    fdir = ray / torch.linalg.norm(ray, dim=-1, keepdim=True)
    row0 = fdir[..., 0:1] * P[..., 2, :] - fdir[..., 2:3] * P[..., 0, :]
    row1 = fdir[..., 1:2] * P[..., 2, :] - fdir[..., 2:3] * P[..., 1, :]
    w = tracks.obs_valid[..., None].to(dtype)
    A = torch.cat([row0 * w, row1 * w], dim=1)                   # [ML, 2F, 4]

    AtA = A.mT @ A
    _, V = torch.linalg.eigh(AtA)                                # ascending
    v = V[..., 0]                                                # smallest eigvec [ML,4]
    v3 = v[:, 3]
    depth = v[:, 2] / torch.where(torch.abs(v3) > 1e-12, v3, torch.full_like(v3, 1e-12))

    good = need & (depth > 0.1)
    new_depth = torch.where(good, depth, torch.full_like(depth, INIT_DEPTH))
    inv_depth = torch.where(need, 1.0 / torch.clamp(new_depth, min=1e-3), tracks.inv_depth)
    return tracks._replace(inv_depth=inv_depth, solve_ok=tracks.solve_ok | need)


def triangulate_all(state: WindowState, tracks: Tracks, depth_max: float = 3.0) -> Tracks:
    """The reference's per-frame order: depth-verified first, SVD fallback
    (``estimator.cpp:1068-1075`` processImage NON_LINEAR branch)."""
    tracks = triangulate_with_depth(state, tracks, depth_max=depth_max)
    return triangulate_svd(state, tracks)
