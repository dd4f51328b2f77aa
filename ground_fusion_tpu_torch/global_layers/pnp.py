"""Batched PnP with fixed-round RANSAC for loop geometric verification.

Replaces ``cv::solvePnPRansac`` in ``KeyFrame::PnPRANSAC``
(``dense_map/src/keyframe.cpp:273-329``: reprojection gate 10/460, 0.99
confidence, iterative refinement seeded at the drift-corrected VIO pose).
RANSAC's data-dependent loop becomes a fixed bank of hypotheses scored in
parallel: every hypothesis Gauss-Newton-refines the seed pose on its own
4-point minimal set (one batch dimension over hypotheses), inliers are
counted with the same gate, and the winner is re-refined on all inliers.

The random draw is the caller's: :func:`pnp_ransac` takes the Gumbel noise
``[n_hyp, N]`` that picks each hypothesis' minimal set (:func:`gumbel_noise`
draws it from a ``torch.Generator``), so a test can hand it the JAX
package's own draw."""

from __future__ import annotations

import torch
from torch import Tensor
from torch.func import jacfwd, vmap

from ..geometry.se3 import pose_apply_inv, pose_boxplus


def _reproj_residuals(pose: Tensor, pts3d: Tensor, obs2d: Tensor) -> Tensor:
    """Normalized-plane reprojection residuals [N,2] of world points under a
    world_T_cam pose."""
    pc = pose_apply_inv(pose, pts3d)
    z = torch.clamp(pc[..., 2], min=1e-6)
    return pc[..., 0:2] / z[..., None] - obs2d


def _gn_step(pose: Tensor, pts3d: Tensor, obs2d: Tensor, weights: Tensor) -> Tensor:
    """One weighted GN step for a single pose [7] (weights [N])."""
    def r_of(delta):
        return (_reproj_residuals(pose_boxplus(pose, delta), pts3d, obs2d)
                * weights[:, None]).reshape(-1)

    z = torch.zeros(6, dtype=pose.dtype, device=pose.device)
    r = r_of(z)
    J = jacfwd(r_of)(z)
    H = J.T @ J + 1e-6 * torch.eye(6, dtype=pose.dtype, device=pose.device)
    delta = torch.linalg.solve(H, -(J.T @ r))
    return pose_boxplus(pose, delta)


_gn_step_batched = vmap(_gn_step, in_dims=(0, None, None, 0))


def pnp_gn(pose0: Tensor, pts3d: Tensor, obs2d: Tensor, weights: Tensor, iters: int = 8) -> Tensor:
    """Weighted GN refinement of camera pose(s) on 2D-3D correspondences.
    ``pose0`` [7] with ``weights`` [N], or a batch ``pose0`` [B,7] with
    ``weights`` [B,N] (one refinement per row, run side by side)."""
    step = _gn_step_batched if pose0.dim() == 2 else _gn_step
    pose = pose0
    for _ in range(iters):
        pose = step(pose, pts3d, obs2d, weights)
    return pose


def gumbel_noise(n_hyp: int, n: int, generator: torch.Generator, dtype=torch.float64,
                 device=None) -> Tensor:
    """Standard Gumbel draws ``[n_hyp, n]`` from ``generator`` (as
    ``jax.random.gumbel``: −log(−log U), U uniform on [tiny, 1))."""
    u = torch.rand((n_hyp, n), generator=generator, dtype=dtype, device=device)
    u = torch.clamp(u, min=torch.finfo(dtype).tiny)
    return -torch.log(-torch.log(u))


def pnp_ransac(pose0: Tensor, pts3d: Tensor, obs2d: Tensor, valid: Tensor, noise: Tensor,
               inlier_thresh: float = 10.0 / 460.0, iters: int = 6, min_inliers: int = 25):
    """Fixed-round parallel RANSAC PnP.

    pose0: seed world_T_cam [7]; pts3d [N,3]; obs2d [N,2] normalized; valid
    [N]; noise [n_hyp, N] Gumbel draws that pick each hypothesis' 4-point
    set among the valid entries. Returns (pose [7], inlier_mask [N], ok
    scalar tensor) — ok mirrors the reference's MIN_LOOP_NUM inlier gate
    (keyframe.cpp:341). Nothing is fetched to the host."""
    n_hyp, n = noise.shape
    dtype = pts3d.dtype
    w_all = valid.to(dtype)

    # random 4-point minimal sets (biased to valid entries by weighted gumbel)
    scores = torch.where(valid[None, :], noise, torch.full_like(noise, -torch.inf))
    idx = torch.topk(scores, 4, dim=1).indices                        # [H, 4]
    sel = torch.zeros((n_hyp, n), dtype=dtype, device=pts3d.device)
    sel = sel.scatter(1, idx, torch.ones_like(idx, dtype=dtype))
    poses = pnp_gn(pose0[None, :].expand(n_hyp, 7), pts3d, obs2d, sel * w_all[None, :], iters)
    r = vmap(_reproj_residuals, in_dims=(0, None, None))(poses, pts3d, obs2d)   # [H, N, 2]
    counts = (valid[None, :] & (torch.linalg.norm(r, dim=-1) < inlier_thresh)).sum(dim=1)
    pose_best = poses[torch.argmax(counts)]

    r = _reproj_residuals(pose_best, pts3d, obs2d)
    inliers = valid & (torch.linalg.norm(r, dim=-1) < inlier_thresh)
    pose_ref = pnp_gn(pose_best, pts3d, obs2d, inliers.to(dtype), iters)
    r2 = _reproj_residuals(pose_ref, pts3d, obs2d)
    inliers = valid & (torch.linalg.norm(r2, dim=-1) < inlier_thresh)
    ok = inliers.sum() >= min_inliers
    return pose_ref, inliers, ok
