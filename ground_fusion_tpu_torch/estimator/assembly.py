"""Batched factor linearization → dense Jacobian row-blocks → one matmul.

The reference walks a heterogeneous factor graph per solve, evaluating each
Ceres cost function's analytic Jacobian and scattering into Ceres' internal
sparse structures (``estimator.cpp:2890-3300``). Here every factor class is
batched with ``torch.func.vmap``, its small Jacobian is written into a dense
row-block ``[rows, TOTAL]`` of the flat tangent layout with an indexed write,
rows of invalid (masked) factors are zeroed, and the full normal equations
are one matmul ``H = JᵀJ`` — dense and static-shape, so a window step issues
the same sequence of device operations every frame and no host-side graph
walk sits in the hot loop.

The landmark (inverse-depth) columns live in the trailing ``ML`` columns, so
the same rows feed either a joint dense solve or the Schur-complement path
(:mod:`.solver`) — each visual factor touches exactly one landmark column.

The GNSS rows (pseudorange/Doppler and the receiver clock chain, built in
:mod:`..gnss.factors`), the first-solve pose anchor and the line rows
(:mod:`.lines`, 4 columns per line after the depths) join when the inputs
carry them.

The rows fall in two groups. The landmark rows (visual, lines) touch their
own landmark's or line's columns; every other row (IMU, wheel, plane, prior,
pose anchor, GNSS and the clock chain) touches the camera block alone. With
the landmark slots split over ranks (``parallel/sharded.py``) each rank
builds the rows of its own landmarks, and ``replicated=False`` leaves the
other group out on all ranks but one, so that it enters the summed normal
equations once.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor
from torch.func import vmap

from ..preintegration.imu import ImuPreint
from ..preintegration.wheel import WheelPreint, wheel_corrected_delta, wheel_residual_from_delta
from .factors import (
    cauchy_weight,
    imu_factor,
    imu_residual_raw,
    plane_factor,
    plane_residual_raw,
    POSE_ANCHOR_SQRT_INFO,
    pose_anchor_factor,
    pose_anchor_residual_raw,
    proj21_factor,
    proj21_residual_raw,
    sqrt_info_from_cov,
    wheel_factor,
)
from .layout import PER_FRAME, StateLayout
from .window import Tracks, WindowState, boxminus, empty_state


class MargPrior(NamedTuple):
    """Square-root marginalization prior over the camera block.

    ``r(x) = r0 + J0 · (x ⊟ lin)`` — the reference's linearized prior factor
    (``marginalization_factor.cpp:344-392``) with first-estimate Jacobians.
    Rows are padded to NX; absent blocks have zero columns.
    """

    J0: Tensor        # [NX, NX]
    r0: Tensor        # [NX]
    lin: WindowState
    valid: Tensor     # [] bool


def empty_prior(layout: StateLayout, num_frames: int, dtype=torch.float32,
                device=None) -> MargPrior:
    nx = layout.nx
    return MargPrior(
        J0=torch.zeros((nx, nx), dtype=dtype, device=device),
        r0=torch.zeros((nx,), dtype=dtype, device=device),
        lin=empty_state(num_frames, dtype, device),
        valid=torch.zeros((), dtype=torch.bool, device=device),
    )


def rows_to_dense(J_block: Tensor, col_idx: Tensor, r: Tensor,
                  row_valid: Tensor, total: int):
    """Scatter per-factor small Jacobians ``[B, r, n]`` with global column
    indices ``[B, n]`` into dense rows ``[B·r, total]``; invalid factors zero.
    """
    b, rr, n = J_block.shape
    # where-based masking, NOT multiply: a masked-out factor may carry NaN/inf
    # payloads (e.g. padded observations) and 0·NaN would poison the system
    Jm = torch.where(row_valid[:, None, None], J_block, torch.zeros_like(J_block))
    rm = torch.where(row_valid[:, None], r, torch.zeros_like(r))
    Jd = torch.zeros((b, rr, total), dtype=J_block.dtype, device=J_block.device).scatter(
        2, col_idx[:, None, :].expand(b, rr, n), Jm)
    return Jd.reshape(b * rr, total), rm.reshape(-1)


def rows_to_dense_add(J_block: Tensor, col_idx: Tensor, r: Tensor,
                      row_valid: Tensor, total: int):
    """Like :func:`rows_to_dense` but with an ADDITIVE scatter: a factor whose
    column indices coincide (the line anchor observation, where pose_i and
    pose_j are the same block) accumulates the total derivative instead of
    keeping one of the writes."""
    b, rr, n = J_block.shape
    Jm = torch.where(row_valid[:, None, None], J_block, torch.zeros_like(J_block))
    rm = torch.where(row_valid[:, None], r, torch.zeros_like(r))
    Jd = torch.zeros((b, rr, total), dtype=J_block.dtype, device=J_block.device).scatter_add(
        2, col_idx[:, None, :].expand(b, rr, n), Jm)
    return Jd.reshape(b * rr, total), rm.reshape(-1)


def _tail(pre, start: int = 1):
    """Drop the first ``start`` slots of a NamedTuple of per-interval tensors."""
    return type(pre)(*[a[start:] for a in pre])


# ---------------------------------------------------------------------------
# Per-class linearizers
# ---------------------------------------------------------------------------


def linearize_imu(state: WindowState, pre: ImuPreint, interval_valid: Tensor,
                  g: Tensor, layout: StateLayout):
    """IMU factors between adjacent frames. ``pre`` has leading axis F; slot k
    covers interval (k-1, k]; slot 0 is ignored. (imu_factor.h <15,7,9,7,9>)"""
    f = state.poses.shape[0]
    dev = state.poses.device
    r, J = vmap(lambda pi, si, pj, sj, p: imu_factor(pi, si, pj, sj, p, g))(
        state.poses[:-1], state.sbs[:-1], state.poses[1:], state.sbs[1:], _tail(pre)
    )                                           # [F-1,15], [F-1,15,30]
    base = PER_FRAME * torch.arange(f - 1, device=dev)
    col_idx = base[:, None] + torch.arange(30, device=dev)[None, :]
    return rows_to_dense(J, col_idx, r, interval_valid[1:], layout.total)


def linearize_wheel(state: WindowState, pre: WheelPreint, interval_valid: Tensor,
                    layout: StateLayout):
    """Wheel odometer factors (wheel_factor.h <6,7,7,7,1,1,1,1>); anomaly
    gating (estimator.cpp:3132-3136) arrives through ``interval_valid``."""
    f = state.poses.shape[0]
    dev = state.poses.device
    sx, sy, sw = state.s_wheel[0], state.s_wheel[1], state.s_wheel[2]
    r, J = vmap(
        lambda pi, pj, p: wheel_factor(pi, pj, state.ex_wheel, sx, sy, sw, state.td_wheel, p)
    )(state.poses[:-1], state.poses[1:], _tail(pre))   # [F-1,6], [F-1,6,22]
    ks = torch.arange(1, f, device=dev)
    six = torch.arange(6, device=dev)
    pose_cols = torch.cat(
        [(PER_FRAME * (ks - 1))[:, None] + six[None, :],
         (PER_FRAME * ks)[:, None] + six[None, :]], dim=1)  # [F-1, 12]
    fixed = torch.tensor(
        [layout.ex_wheel + i for i in range(6)]
        + [layout.s_wheel, layout.s_wheel + 1, layout.s_wheel + 2, layout.td_wheel],
        dtype=torch.int64, device=dev,
    )
    col_idx = torch.cat([pose_cols, fixed.repeat(f - 1, 1)], dim=1)  # [F-1, 22]
    return rows_to_dense(J, col_idx, r, interval_valid[1:], layout.total)


def _visual_pairs(tracks: Tracks, min_track: int, lm_filter: Optional[Tensor]):
    """Enumerate every (landmark, target-frame) pair flattened to ``[ML·F]``:
    landmark index, anchor frame, target frame and validity."""
    ml, f = tracks.obs_valid.shape
    dev = tracks.obs.device
    used_num = torch.sum(tracks.obs_valid, dim=1)
    lm_ok = tracks.active & tracks.solve_ok & (used_num >= min_track)
    if lm_filter is not None:
        lm_ok = lm_ok & lm_filter
    ls = torch.arange(ml, device=dev).repeat_interleave(f)
    js = torch.arange(f, device=dev).repeat(ml)
    # anchors are always in range for live slots; clamp guards stale padding
    si = torch.clamp(tracks.start_frame[ls], 0, f - 1)
    valid = (
        lm_ok[ls]
        & tracks.obs_valid[ls, js]
        & tracks.obs_valid[ls, si]
        & (js > si)
    )
    return ls, si, js, valid


def linearize_visual(state: WindowState, tracks: Tracks, td_obs: Tensor,
                     layout: StateLayout, sqrt_info_scale, cauchy_delta,
                     min_track: int = 4, lm_filter: Optional[Tensor] = None):
    """All (landmark, target-frame) reprojection factors, flattened to
    ``[ML·F]``; each row pair touches pose_i (gathered by anchor), pose_j,
    ex_cam, its own depth column, and td. Mirrors the factor enumeration of
    ``estimator.cpp:3265-3297`` with the ``used_num ≥ 4`` gate.
    """
    ml, f = tracks.obs_valid.shape
    dtype, dev = state.poses.dtype, state.poses.device
    ls, si, js, valid = _visual_pairs(tracks, min_track, lm_filter)

    ob_i = tracks.obs[ls, si]   # [B,5]
    ob_j = tracks.obs[ls, js]
    b = ml * f
    zeros = torch.zeros((b,), dtype=dtype, device=dev)
    ones = torch.ones((b,), dtype=dtype, device=dev)
    obs_pack = torch.stack(
        [
            ob_i[:, 0], ob_i[:, 1], ones,
            ob_j[:, 0], ob_j[:, 1], ones,
            ob_i[:, 2], ob_i[:, 3], zeros,
            ob_j[:, 2], ob_j[:, 3], zeros,
            td_obs[si], td_obs[js],
        ],
        dim=-1,
    )  # [B, 14]

    r, J = vmap(
        lambda pi, pj, lam, pack: proj21_factor(
            pi, pj, state.ex_cam, lam, state.td, pack, sqrt_info_scale)
    )(state.poses[si], state.poses[js], tracks.inv_depth[ls], obs_pack)  # [B,2], [B,2,20]

    # Cauchy robust reweighting (ceres::CauchyLoss on visual factors,
    # estimator.cpp:3280; rescale as marginalization_factor.cpp:46-77)
    w = cauchy_weight(torch.sum(r * r, dim=-1), cauchy_delta)[:, None]
    r = r * w
    J = J * w[:, :, None]

    # NaN-safe masking before placement (padded factors carry NaN/inf)
    J = torch.where(valid[:, None, None], J, torch.zeros_like(J))
    r = torch.where(valid[:, None], r, torch.zeros_like(r))

    # depth column masked out for RGBD-measured (held-constant) depths
    dep_free = torch.where(tracks.depth_fixed[ls], 0.0, 1.0).to(dtype)

    # dense placement by indexed writes: pose_i and pose_j never coincide on
    # a valid row (js > si); on a masked row both blocks are zero
    six = torch.arange(6, device=dev)
    col_idx = torch.cat(
        [
            (PER_FRAME * si)[:, None] + six[None, :],
            (PER_FRAME * js)[:, None] + six[None, :],
            (layout.ex_cam + six)[None, :].expand(b, 6),
            (layout.depth0 + ls)[:, None],
            torch.full((b, 1), layout.td, dtype=torch.int64, device=dev),
        ],
        dim=1,
    )  # [B, 20]
    J = torch.cat([J[:, :, 0:18], J[:, :, 18:19] * dep_free[:, None, None], J[:, :, 19:20]],
                  dim=-1)
    Jd = torch.zeros((b, 2, layout.total), dtype=dtype, device=dev).scatter_add(
        2, col_idx[:, None, :].expand(b, 2, 20), J)
    return Jd.reshape(b * 2, layout.total), r.reshape(-1)


def linearize_plane(state: WindowState, frame_valid: Tensor, sqrt_info_diag,
                    layout: StateLayout):
    """Per-frame ground-plane factors (plane_factor.h:26-56)."""
    f = state.poses.shape[0]
    dev = state.poses.device
    r, J = vmap(
        lambda p: plane_factor(p, state.ex_wheel, state.plane_q, state.plane_z, sqrt_info_diag)
    )(state.poses)   # [F,3], [F,3,16]
    ks = torch.arange(f, device=dev)
    col_idx = torch.cat(
        [
            (PER_FRAME * ks)[:, None] + torch.arange(6, device=dev)[None, :],
            torch.arange(layout.ex_wheel, layout.ex_wheel + 6, device=dev).repeat(f, 1),
            torch.arange(layout.plane, layout.plane + 4, device=dev).repeat(f, 1),
        ],
        dim=1,
    )
    return rows_to_dense(J, col_idx, r, frame_valid, layout.total)


def linearize_pose_anchor(state: WindowState, anchor_pose: Tensor,
                          active: Tensor, layout: StateLayout):
    """Pose0 anchor rows, gated by ``active`` (estimator.cpp:3562-3570 seeds
    the very first marginalization prior with it)."""
    r, J6 = pose_anchor_factor(state.poses[0], anchor_pose)
    w = active.to(state.poses.dtype)
    Jd = torch.cat(
        [J6 * w, torch.zeros((6, layout.total - 6), dtype=J6.dtype, device=J6.device)], dim=1)
    return Jd, r * w


def linearize_prior(state: WindowState, prior: MargPrior, layout: StateLayout):
    """Marginalization prior rows: r = r0 + J0 (x ⊟ lin), J = J0 — embedded
    in the first NX columns (marginalization_factor.cpp:344-392)."""
    dx = boxminus(state, prior.lin, layout)
    r = prior.r0 + prior.J0 @ dx
    w = prior.valid.to(state.poses.dtype)
    nx = layout.nx
    Jd = torch.cat(
        [prior.J0 * w,
         torch.zeros((nx, layout.total - nx), dtype=r.dtype, device=r.device)], dim=1)
    return Jd, r * w


# ---------------------------------------------------------------------------
# Full-system assembly
# ---------------------------------------------------------------------------


class SolveInputs(NamedTuple):
    """Everything the window solve consumes besides the state itself."""

    imu_pre: ImuPreint          # leading axis F (slot k = interval (k-1, k])
    imu_valid: Tensor           # [F] bool
    wheel_pre: WheelPreint
    wheel_valid: Tensor         # [F] bool (anomaly-gated)
    plane_valid: Tensor         # [F] bool
    td_obs: Tensor              # [F] td value at capture time per frame
    prior: MargPrior
    g: Tensor                   # [3] gravity in world
    free_mask: Tensor           # [TOTAL] 1.0 = optimizable, 0.0 = frozen
    # --- optional GNSS block (None ⇒ no GNSS rows) ---
    gnss_obs: object = None     # gnss.factors.GnssObsWindow | None
    gnss_ready: Optional[Tensor] = None   # [] bool — gnss_ready gate
    frame_dts: Optional[Tensor] = None    # [F] Δt between adjacent frames
    ddt_weight: Optional[Tensor] = None   # [] GNSS_DDT_WEIGHT
    # --- pose0 anchor (first GNSS-enabled solve, estimator.cpp:2943-2951) ---
    anchor_pose: Optional[Tensor] = None  # [7] anchor value for pose0
    anchor_active: Optional[Tensor] = None  # [] bool
    # --- optional line landmarks (None ⇒ no line rows) ---
    lines: object = None                  # estimator.lines.LineTracks | None
    line_min_obs: int = 5                 # LINE_MIN_OBS
    line_weight: float = 1.0              # lines.weight_scale


def assemble_rows(state: WindowState, tracks: Tracks, inp: SolveInputs,
                  layout: StateLayout, sqrt_info_scale, cauchy_delta,
                  plane_sqrt_info, replicated: bool = True):
    """Linearize every factor class at ``state`` → stacked dense rows;
    with ``replicated=False`` the landmark rows only (visual, lines). The
    rows keep one order either way."""
    rows = []
    if replicated:
        rows.append(linearize_imu(state, inp.imu_pre, inp.imu_valid, inp.g, layout))
        rows.append(linearize_wheel(state, inp.wheel_pre, inp.wheel_valid, layout))
    rows.append(linearize_visual(
        state, tracks, inp.td_obs, layout, sqrt_info_scale, cauchy_delta
    ))
    if replicated:
        rows.append(linearize_plane(state, inp.plane_valid, plane_sqrt_info, layout))
        rows.append(linearize_prior(state, inp.prior, layout))
    if replicated and inp.gnss_obs is not None:
        from ..gnss.factors import linearize_clock_chain, linearize_gnss_psr_dopp

        rows.append(linearize_gnss_psr_dopp(state, inp.gnss_obs, inp.gnss_ready, layout))
        rows.append(linearize_clock_chain(state, inp.frame_dts, inp.gnss_ready,
                                          inp.ddt_weight, layout))
    if replicated and inp.anchor_pose is not None:
        rows.append(linearize_pose_anchor(state, inp.anchor_pose, inp.anchor_active, layout))
    if inp.lines is not None:
        from .lines import linearize_lines

        rows.append(linearize_lines(
            state, inp.lines, layout, sqrt_info_scale * inp.line_weight,
            cauchy_delta, min_obs=inp.line_min_obs))
    J = torch.cat([a for a, _ in rows], dim=0)
    r = torch.cat([b for _, b in rows], dim=0)
    return J * inp.free_mask[None, :], r


def normal_equations(J: Tensor, r: Tensor):
    """H = JᵀJ, g = Jᵀr — one matmul pair."""
    return J.T @ J, J.T @ r


def assemble_residuals(state: WindowState, tracks: Tracks, inp: SolveInputs,
                       layout: StateLayout, sqrt_info_scale, cauchy_delta,
                       plane_sqrt_info, replicated: bool = True):
    """Residual-only evaluation (no Jacobians, no dense scatter) — the cheap
    cost probe for trust-region accept/reject; must match
    :func:`assemble_rows`'s whitening + robust reweighting exactly (and its
    ``replicated`` split). The residual functions broadcast over the factor
    axis, so no vmap is needed.
    """
    dtype, dev = state.poses.dtype, state.poses.device
    parts = []

    def masked(r, ok):
        return torch.where(ok[:, None], r, torch.zeros_like(r)).reshape(-1)

    if replicated:
        # IMU
        pre = _tail(inp.imu_pre)
        S = sqrt_info_from_cov(pre.covariance)
        ri = imu_residual_raw(state.poses[:-1], state.sbs[:-1], state.poses[1:],
                              state.sbs[1:], pre, inp.g)
        parts.append(masked((S @ ri[..., None])[..., 0], inp.imu_valid[1:]))

        # wheel
        wpre = _tail(inp.wheel_pre)
        sx, sy, sw = state.s_wheel[0], state.s_wheel[1], state.s_wheel[2]
        S = sqrt_info_from_cov(wpre.covariance)
        dp, dq = wheel_corrected_delta(wpre, sx, sy, sw, state.td_wheel)
        rw = wheel_residual_from_delta(state.poses[:-1], state.poses[1:], state.ex_wheel, dp, dq)
        parts.append(masked((S @ rw[..., None])[..., 0], inp.wheel_valid[1:]))

    # visual
    ls, si, js, valid = _visual_pairs(tracks, 4, None)
    ob_i = tracks.obs[ls, si]
    ob_j = tracks.obs[ls, js]
    one = torch.ones_like(ob_i[:, 0:1])
    zero = torch.zeros_like(one)
    rv = sqrt_info_scale * proj21_residual_raw(
        state.poses[si], state.poses[js], state.ex_cam,
        tracks.inv_depth[ls][:, None], state.td,
        torch.cat([ob_i[:, 0:2], one], dim=-1), torch.cat([ob_j[:, 0:2], one], dim=-1),
        torch.cat([ob_i[:, 2:4], zero], dim=-1), torch.cat([ob_j[:, 2:4], zero], dim=-1),
        inp.td_obs[si][:, None], inp.td_obs[js][:, None],
    )
    w = cauchy_weight(torch.sum(rv * rv, dim=-1), cauchy_delta)[:, None]
    parts.append(masked(rv * w, valid))

    if replicated:
        # plane
        rp = plane_sqrt_info * plane_residual_raw(
            state.poses, state.ex_wheel, state.plane_q, state.plane_z)
        parts.append(masked(rp, inp.plane_valid))

        # prior
        dx = boxminus(state, inp.prior.lin, layout)
        parts.append((inp.prior.r0 + inp.prior.J0 @ dx) * inp.prior.valid.to(dtype))

        # GNSS
        if inp.gnss_obs is not None:
            from ..gnss.factors import clock_chain_residuals, gnss_psr_dopp_residuals

            parts.append(gnss_psr_dopp_residuals(state, inp.gnss_obs, inp.gnss_ready))
            parts.append(clock_chain_residuals(state, inp.frame_dts, inp.gnss_ready,
                                               inp.ddt_weight))

        # pose0 anchor
        if inp.anchor_pose is not None:
            ra = POSE_ANCHOR_SQRT_INFO * pose_anchor_residual_raw(state.poses[0], inp.anchor_pose)
            parts.append(ra * inp.anchor_active.to(dtype))

    # lines
    if inp.lines is not None:
        from .lines import line_residuals

        parts.append(line_residuals(
            state, inp.lines, sqrt_info_scale * inp.line_weight,
            cauchy_delta, min_obs=inp.line_min_obs))
    return torch.cat(parts)
