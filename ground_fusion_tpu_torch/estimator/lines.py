"""Line landmarks in the sliding-window BA.

The reference's ``use_line`` path adds structural-line landmarks to the
estimator: triangulation (``feature_manager.cpp:1151-1315`` triangulateLine),
a line-only refinement with poses fixed (``estimator.cpp:4202-4270``
onlyLineOpt), joint optimization with 2-dim point-to-line residuals over every
observing frame (``estimator.cpp:4500-4537`` optimizationwithLine), outlier
culling (``feature_manager.cpp:1372-1442`` removeLineOutlier), and
marginalization of frame-0 lines (``estimator.cpp:4680-4712``).

Lines live in a padded ``LineTracks`` table of orthonormal 4-vectors
expressed in the ANCHOR-FRAME CAMERA — the reference's ``LINEINCAM`` variant
(``lineProjectionFactor_incamera`` / ``_instartframe``). Camera-anchored lines
are gauge-invariant like anchored point landmarks, so the yaw/position
re-anchor after each solve carries them along. Each (line, frame)
observation is one 2-row factor on (pose_i, pose_j, ex_cam, orth_l); the
anchor observation's pose and extrinsic Jacobians cancel analytically.
With poses fixed every line is an independent 4-dim problem, so
``onlyLineOpt`` is a batched Gauss-Newton over all lines at once, its 4×4
solves an unrolled Cholesky on tensors (:func:`_solve_spd4`).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor
from torch.func import vmap

from ..frontend.lines import orth_to_plk, planes_to_plk, plk_to_orth, plk_transform
from ..geometry.se3 import pose_boxplus, pose_compose
from ..geometry.so3 import _cross, quat_to_mat
from .factors import _jac_and_value, cauchy_weight, huber_weight
from .layout import PER_FRAME, StateLayout
from .window import WindowState


class LineTracks(NamedTuple):
    """Padded line-landmark table (``LL`` slots over ``F`` frames).

    ``obs[l, f] = [x1, y1, x2, y2]`` — segment endpoints on the undistorted
    normalized plane (``lineobs``, the per-frame observation the reference
    stores in ``lineFeaturePerFrame``).
    """

    orth: Tensor         # [LL, 4] orthonormal line in the anchor camera
    active: Tensor       # [LL] bool — slot in use
    solve_ok: Tensor     # [LL] bool — is_triangulation
    start_frame: Tensor  # [LL] int64
    obs: Tensor          # [LL, F, 4]
    obs_valid: Tensor    # [LL, F] bool


def empty_line_tracks(max_lines: int, num_frames: int, dtype=torch.float32,
                      device=None) -> LineTracks:
    ll, f = max_lines, num_frames
    kw = dict(device=device)
    return LineTracks(
        orth=torch.zeros((ll, 4), dtype=dtype, **kw),
        active=torch.zeros((ll,), dtype=torch.bool, **kw),
        solve_ok=torch.zeros((ll,), dtype=torch.bool, **kw),
        start_frame=torch.zeros((ll,), dtype=torch.int64, **kw),
        obs=torch.zeros((ll, f, 4), dtype=dtype, **kw),
        obs_valid=torch.zeros((ll, f), dtype=torch.bool, **kw),
    )


# ---------------------------------------------------------------------------
# Geometry helpers
# ---------------------------------------------------------------------------


def plk_cam_to_world(plk_c: Tensor, cam_pose: Tensor) -> Tensor:
    """Plücker coordinates camera → world given the camera pose (R_wc, t_wc):
    ``n_w = R n_c + [t]ₓ R v_c, v_w = R v_c`` (``plk_to_pose``)."""
    R = quat_to_mat(cam_pose[..., 3:7])
    t = cam_pose[..., 0:3]
    v_w = torch.einsum("...ij,...j->...i", R, plk_c[..., 3:6])
    n_w = torch.einsum("...ij,...j->...i", R, plk_c[..., 0:3]) + _cross(t, v_w)
    return torch.cat([n_w, v_w], dim=-1)


def line_residual_cam(pose_i, pose_j, ex, orth, obs4):
    """Point-to-line residual of an ANCHOR-CAMERA line observed in frame j
    (``lineProjectionFactor_incamera::Evaluate``): cam_i line → world →
    cam_j, then the signed endpoint distances to the projected infinite
    line. For j == i the pose/extrinsic dependence cancels analytically —
    the reference's ``_instartframe`` variant. Broadcasts over leading axes."""
    plk_ci = orth_to_plk(orth)
    cam_i = pose_compose(pose_i, ex)
    cam_j = pose_compose(pose_j, ex)
    plk_w = plk_cam_to_world(plk_ci, cam_i)
    plk_cj = plk_transform(plk_w, cam_j[..., 3:7], cam_j[..., 0:3])
    nc = plk_cj[..., 0:3]
    l_norm = torch.sqrt(torch.clamp(nc[..., 0] ** 2 + nc[..., 1] ** 2, min=1e-12))
    e1 = obs4[..., 0] * nc[..., 0] + obs4[..., 1] * nc[..., 1] + nc[..., 2]
    e2 = obs4[..., 2] * nc[..., 0] + obs4[..., 3] * nc[..., 1] + nc[..., 2]
    return torch.stack([e1, e2], dim=-1) / l_norm[..., None]


def _plane_of_obs(obs4: Tensor) -> Tensor:
    """Normal of the plane through the camera origin and the two endpoint
    rays (``pi_from_ppp(p1, p2, 0)``): p1 × p2, d = 0."""
    one = torch.ones_like(obs4[..., 0:1])
    return _cross(torch.cat([obs4[..., 0:2], one], dim=-1),
                  torch.cat([obs4[..., 2:4], one], dim=-1))


def _anchor_frames(lines: LineTracks) -> Tensor:
    """Each slot's anchor frame, clamped into the window (live slots are
    always in range; the clamp guards stale padding)."""
    f = lines.obs_valid.shape[1]
    return torch.clamp(lines.start_frame, 0, f - 1)


def triangulate_lines(state: WindowState, lines: LineTracks, min_obs: int = 5,
                      min_cos_theta: float = 0.998, enabled=True) -> LineTracks:
    """Two-view line triangulation for untriangulated slots
    (``feature_manager.cpp:1151-1315``): among all non-anchor observations,
    pick the one whose back-projected plane is most oblique to the anchor
    plane (smallest cos θ between normals, both in the anchor camera; the
    first such frame on a tie); gate at ``cos θ ≤ min_cos_theta``; intersect
    the two planes into an anchor-camera Plücker line (dual-matrix
    construction) and store its orthonormal coordinates. ``enabled`` (a
    bool tensor) gates the whole call."""
    ll, f = lines.obs_valid.shape
    dtype, dev = lines.obs.dtype, lines.obs.device
    cams = pose_compose(state.poses, state.ex_cam)           # [F,7] world_T_cam

    used_num = torch.sum(lines.obs_valid, dim=1)
    want = (lines.active & ~lines.solve_ok & (used_num >= min_obs)
            & (lines.start_frame < f - 3))
    want = want & torch.as_tensor(enabled, device=dev)

    si = _anchor_frames(lines)
    cam_i = cams[si]                                         # [LL,7]
    R_i = quat_to_mat(cam_i[:, 3:7])                         # [LL,3,3]
    t_i = cam_i[:, 0:3]
    obs_i = lines.obs[torch.arange(ll, device=dev), si]      # [LL,4]
    ni = _plane_of_obs(obs_i)
    ni = ni / torch.clamp(torch.linalg.norm(ni, dim=-1, keepdim=True), min=1e-12)

    # every frame's endpoints moved into anchor-camera coordinates
    R_j = quat_to_mat(cams[:, 3:7])                          # [F,3,3]
    t_j = cams[:, 0:3]
    R_ij = torch.einsum("lba,fbc->lfac", R_i, R_j)           # R_iᵀ R_j   [LL,F,3,3]
    t_ij = torch.einsum("lba,lfb->lfa", R_i, t_j[None] - t_i[:, None])   # [LL,F,3]
    one = torch.ones((ll, f, 1), dtype=dtype, device=dev)
    p3 = torch.einsum("lfab,lfb->lfa", R_ij, torch.cat([lines.obs[..., 0:2], one], -1)) + t_ij
    p4 = torch.einsum("lfab,lfb->lfa", R_ij, torch.cat([lines.obs[..., 2:4], one], -1)) + t_ij
    # plane through (p3, p4, t_ij): pi_from_ppp
    nj = _cross(p3 - t_ij, p4 - t_ij)
    dj = -torch.sum(nj * t_ij, dim=-1)
    nj_unit = nj / torch.clamp(torch.linalg.norm(nj, dim=-1, keepdim=True), min=1e-12)

    cos_t = torch.sum(nj_unit * ni[:, None, :], dim=-1)      # [LL,F]
    cand = lines.obs_valid & (torch.arange(f, device=dev)[None, :] != si[:, None])
    cos_t = torch.where(cand, cos_t, torch.ones_like(cos_t))
    jbest = torch.argmin(cos_t, dim=1)
    rows = torch.arange(ll, device=dev)
    tri_ok = cos_t[rows, jbest] <= min_cos_theta

    # dual-Plücker intersection of the anchor plane and the best plane; the
    # line stays in the anchor camera's frame (LINEINCAM)
    pii = torch.cat([ni, torch.zeros((ll, 1), dtype=dtype, device=dev)], dim=-1)
    pij = torch.cat([nj[rows, jbest], dj[rows, jbest][:, None]], dim=-1)
    orth_new = plk_to_orth(planes_to_plk(pii, pij))
    do = want & tri_ok
    return lines._replace(orth=torch.where(do[:, None], orth_new, lines.orth),
                          solve_ok=lines.solve_ok | do)


# ---------------------------------------------------------------------------
# Factor linearization into the dense row-block
# ---------------------------------------------------------------------------


def line_solve_mask(lines: LineTracks, num_frames: int, min_obs: int = 5) -> Tensor:
    """The reference's per-line gate: ``used_num ≥ LINE_MIN_OBS &&
    start_frame < WINDOW_SIZE-2 && is_triangulation`` (estimator.cpp:4511)."""
    used_num = torch.sum(lines.obs_valid, dim=1)
    return (lines.active & lines.solve_ok & (used_num >= min_obs)
            & (lines.start_frame < num_frames - 3))


def _line_factor22(pose_i, pose_j, ex, orth, obs4, sqrt_info_scale):
    """Whitened residual and Jacobian against [δpose_i(6), δpose_j(6),
    δex(6), δorth(4)]. For the anchor observation (i == j) the pose and
    extrinsic columns cancel to zero (instartframe)."""

    def r_of(d):
        return sqrt_info_scale * line_residual_cam(
            pose_boxplus(pose_i, d[0:6]), pose_boxplus(pose_j, d[6:12]),
            pose_boxplus(ex, d[12:18]), orth + d[18:22], obs4)

    return _jac_and_value(r_of, torch.zeros(22, dtype=pose_i.dtype, device=pose_i.device))


def _line_pairs(lines: LineTracks, line_ok: Tensor):
    """Every (line, frame) observation flattened to ``[LL·F]``: line index,
    anchor frame, observing frame and validity."""
    ll, f = lines.obs_valid.shape
    dev = lines.obs.device
    ls = torch.arange(ll, device=dev).repeat_interleave(f)
    js = torch.arange(f, device=dev).repeat(ll)
    si = _anchor_frames(lines)[ls]
    valid = line_ok[ls] & lines.obs_valid[ls, js]
    return ls, si, js, valid


def linearize_lines(state: WindowState, lines: LineTracks, layout: StateLayout,
                    sqrt_info_scale, loss_delta, min_obs: int = 5,
                    lm_filter: Optional[Tensor] = None,
                    frame_filter: Optional[Tensor] = None):
    """All (line, frame) observation factors flattened to ``[LL·F]`` row
    pairs; each touches pose_i (anchor), pose_j, ex_cam and its own 4 line
    columns (``lineProjectionFactor_incamera``; Huber(1.0) robust loss).
    The scatter is ADDITIVE, so the coinciding pose_i/pose_j columns of the
    anchor observation sum to the total derivative."""
    from .assembly import rows_to_dense_add

    ll, f = lines.obs_valid.shape
    dev = lines.obs.device
    line_ok = line_solve_mask(lines, f, min_obs)
    if lm_filter is not None:
        line_ok = line_ok & lm_filter
    ls, si, js, valid = _line_pairs(lines, line_ok)
    if frame_filter is not None:
        valid = valid & frame_filter[js]

    r, J = vmap(lambda pi, pj, o, ob: _line_factor22(pi, pj, state.ex_cam, o, ob,
                                                     sqrt_info_scale))(
        state.poses[si], state.poses[js], lines.orth[ls], lines.obs[ls, js])  # [B,2], [B,2,22]
    w = huber_weight(torch.sum(r * r, dim=-1), loss_delta)[:, None]
    r = r * w
    J = J * w[:, :, None]

    b = ll * f
    six = torch.arange(6, device=dev)
    col_idx = torch.cat(
        [
            (PER_FRAME * si)[:, None] + six[None, :],
            (PER_FRAME * js)[:, None] + six[None, :],
            (layout.ex_cam + six)[None, :].expand(b, 6),
            (layout.line0 + 4 * ls)[:, None] + torch.arange(4, device=dev)[None, :],
        ],
        dim=1,
    )  # [B, 22]
    return rows_to_dense_add(J, col_idx, r, valid, layout.total)


def line_residuals(state: WindowState, lines: LineTracks, sqrt_info_scale, loss_delta,
                   min_obs: int = 5) -> Tensor:
    """Residual-only evaluation matching :func:`linearize_lines`'s whitening
    and robust reweighting (the trust-region cost probe)."""
    f = lines.obs_valid.shape[1]
    ls, si, js, valid = _line_pairs(lines, line_solve_mask(lines, f, min_obs))
    r = sqrt_info_scale * line_residual_cam(
        state.poses[si], state.poses[js], state.ex_cam, lines.orth[ls], lines.obs[ls, js])
    w = huber_weight(torch.sum(r * r, dim=-1), loss_delta)[:, None]
    return torch.where(valid[:, None], r * w, torch.zeros_like(r)).reshape(-1)


# ---------------------------------------------------------------------------
# onlyLineOpt: batched per-line refinement with poses fixed
# ---------------------------------------------------------------------------


def _solve_spd4(H: Tensor, g: Tensor) -> Tensor:
    """x = H⁻¹ g by an unrolled 4×4 Cholesky, batched over the leading axes
    of ``H`` [..., 4, 4] and ``g`` [..., 4] (broadcast against each other).
    Every pivot is clamped at 1e-12 before its square root, so the solve
    never fails; the sums run in the same order as the JAX package's."""
    L = [[None] * 4 for _ in range(4)]
    for i in range(4):
        s = H[..., i, i] - sum(L[i][k] ** 2 for k in range(i))
        di = torch.sqrt(torch.clamp(s, min=1e-12))
        L[i][i] = di
        for j in range(i + 1, 4):
            s = H[..., j, i] - sum(L[j][k] * L[i][k] for k in range(i))
            L[j][i] = s / di
    y = [None] * 4
    for i in range(4):
        y[i] = (g[..., i] - sum(L[i][k] * y[k] for k in range(i))) / L[i][i]
    x = [None] * 4
    for i in reversed(range(4)):
        x[i] = (y[i] - sum(L[k][i] * x[k] for k in range(i + 1, 4))) / L[i][i]
    return torch.stack(torch.broadcast_tensors(*x), dim=-1)


def _per_line_residuals(state: WindowState, pose_i: Tensor, orth: Tensor, obs: Tensor) -> Tensor:
    """Residuals [..., F, 2] of each line against every window frame, the
    line in the camera of its anchor pose ``pose_i`` [..., 7]; ``orth``
    [..., 4], ``obs`` [..., F, 4] (batched over lines)."""
    return line_residual_cam(pose_i[..., None, :], state.poses, state.ex_cam,
                             orth[..., None, :], obs)


def only_line_opt(state: WindowState, lines: LineTracks, sqrt_info_scale, min_obs: int = 5,
                  iters: int = 4, loss_delta: float = 1.0) -> LineTracks:
    """Line-only refinement with all poses and extrinsics held constant
    (``estimator.cpp:4202-4270``). With poses fixed the problem decouples
    per line into independent 4-dim Gauss-Newton solves: every line takes
    ``iters`` steps at once, each kept only where it lowers that line's
    cost."""
    f = lines.obs_valid.shape[1]
    dtype, dev = lines.obs.dtype, lines.obs.device
    line_ok = line_solve_mask(lines, f, min_obs)
    pose_i = state.poses[_anchor_frames(lines)]
    eye = 1e-6 * torch.eye(4, dtype=dtype, device=dev)

    def r_one(orth, obs, obs_valid, p):
        r = _per_line_residuals(state, p, orth, obs)                  # [F,2]
        w = cauchy_weight(torch.sum(r * r, dim=-1), loss_delta)[:, None]
        return torch.where(obs_valid[:, None], sqrt_info_scale * r * w,
                           torch.zeros_like(r)).reshape(-1)

    lin = vmap(lambda o, ob, v, p: _jac_and_value(lambda x: r_one(x, ob, v, p), o))
    res = vmap(r_one)
    orth = lines.orth
    for _ in range(iters):
        r, J = lin(orth, lines.obs, lines.obs_valid, pose_i)              # [LL,2F], [LL,2F,4]
        H = J.transpose(1, 2) @ J + eye
        g = (J.transpose(1, 2) @ r[..., None])[..., 0]
        orth_new = orth - _solve_spd4(H, g)
        r_new = res(orth_new, lines.obs, lines.obs_valid, pose_i)
        better = torch.sum(r_new ** 2, dim=1) < torch.sum(r * r, dim=1)
        orth = torch.where(better[:, None], orth_new, orth)
    return lines._replace(orth=torch.where(line_ok[:, None], orth, lines.orth))


def remove_line_outliers(state: WindowState, lines: LineTracks, min_obs: int = 5,
                         max_reproj: float = 3.0 / 500.0, max_depth: float = 10.0) -> LineTracks:
    """Cull bad lines (``feature_manager.cpp:1372-1482``): a line dies when
    its WORST point-to-line error over its observations reaches
    ``max_reproj`` or its distance from the anchor camera reaches
    ``max_depth`` (the reference erases the feature, so a culled slot
    deactivates rather than waiting for re-triangulation)."""
    ll, f = lines.obs_valid.shape
    line_ok = line_solve_mask(lines, f, min_obs)
    r = _per_line_residuals(state, state.poses[_anchor_frames(lines)], lines.orth,
                            lines.obs)                               # [LL,F,2]
    err = torch.amax(torch.where(lines.obs_valid[..., None], torch.abs(r), torch.zeros_like(r)),
                     dim=(1, 2))
    # distance of the line to the anchor camera: |n| / |v|
    plk_c = orth_to_plk(lines.orth)
    d = torch.linalg.norm(plk_c[:, 0:3], dim=-1) / torch.clamp(
        torch.linalg.norm(plk_c[:, 3:6], dim=-1), min=1e-9)
    kill = line_ok & ~((err < max_reproj) & (d < max_depth))
    return lines._replace(solve_ok=lines.solve_ok & ~kill, active=lines.active & ~kill,
                          obs_valid=lines.obs_valid & ~kill[:, None])


# ---------------------------------------------------------------------------
# Sliding
# ---------------------------------------------------------------------------


def slide_old_lines(state: WindowState, lines: LineTracks) -> LineTracks:
    """MARGIN_OLD: the observation window rolls left; lines anchored at the
    dropped frame 0 re-express their Plücker coordinates in frame 1's camera
    (an exact frame change); slots with no remaining observation die
    (``removeLineBack`` + ``removeBackShiftDepthline``). ``state`` is the
    PRE-slide state."""
    anchored0 = lines.active & (lines.start_frame == 0)
    cam0 = pose_compose(state.poses[0], state.ex_cam)
    cam1 = pose_compose(state.poses[1], state.ex_cam)
    plk_w = plk_cam_to_world(orth_to_plk(lines.orth), cam0)
    plk_c1 = plk_transform(plk_w, cam1[3:7], cam1[0:3])
    orth = torch.where((anchored0 & lines.solve_ok)[:, None], plk_to_orth(plk_c1), lines.orth)

    obs = torch.cat([lines.obs[:, 1:], torch.zeros_like(lines.obs[:, :1])], dim=1)
    obs_valid = torch.cat([lines.obs_valid[:, 1:], torch.zeros_like(lines.obs_valid[:, :1])],
                          dim=1)
    start_frame = torch.clamp(lines.start_frame - 1, min=0)
    active = lines.active & torch.any(obs_valid, dim=1)
    return lines._replace(orth=orth, obs=obs, obs_valid=obs_valid, start_frame=start_frame,
                          active=active, solve_ok=lines.solve_ok & active)


def slide_new_lines(lines: LineTracks) -> LineTracks:
    """MARGIN_SECOND_NEW: frame F-2's observation is replaced by F-1's
    (``FeatureManager::removeLineFront``)."""
    f = lines.obs_valid.shape[1]
    obs = torch.cat([lines.obs[:, : f - 2], lines.obs[:, f - 1 :],
                     torch.zeros_like(lines.obs[:, :1])], dim=1)
    obs_valid = torch.cat([lines.obs_valid[:, : f - 2], lines.obs_valid[:, f - 1 :],
                           torch.zeros_like(lines.obs_valid[:, :1])], dim=1)
    start_frame = torch.where(lines.start_frame == f - 1,
                              torch.full_like(lines.start_frame, f - 2), lines.start_frame)
    active = lines.active & torch.any(obs_valid, dim=1)
    return lines._replace(obs=obs, obs_valid=obs_valid, start_frame=start_frame,
                          active=active, solve_ok=lines.solve_ok & active)
