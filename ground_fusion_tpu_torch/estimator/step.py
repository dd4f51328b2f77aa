"""The per-keyframe window step — one function on device tensors.

This is the ``processImage`` → ``optimization`` → marginalize →
``slideWindow`` path (``estimator.cpp:843-1163, 2890-3795``) as a single pure
function: preintegrate all intervals, triangulate, solve, re-anchor the
gauge, marginalize, slide. The keyframe decision is known on the host, so the
step branches on it in Python and computes one marginalization only; every
other gate stays a device tensor.

With ``use_line`` the step carries the line landmarks (:mod:`.lines`):
triangulation, the line-only refinement and the cull before the solve, the
line rows in it, the cull after it and both line slides. Only the per-frame
step is ported; the packed, burst, ingest and fleet step constructors of the
JAX package are not.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor

from .. import resolve_device
from ..config import Config
from ..geometry.so3 import quat_mul, quat_normalize, quat_rotate
from ..preintegration.imu import noise_cov
from ..preintegration.wheel import wheel_noise_cov
from .assembly import MargPrior, SolveInputs
from .buffers import (
    ImuWindowBuffer,
    WheelWindowBuffer,
    preintegrate_imu_window,
    preintegrate_wheel_window,
    slide_new_imu_buffer,
    slide_new_wheel_buffer,
    slide_old_imu_buffer,
    slide_old_wheel_buffer,
)
from .gates import device_frame_gates, moving_consistency_check, remove_outliers
from .layout import PER_FRAME, StateLayout
from .lines import (
    only_line_opt,
    remove_line_outliers,
    slide_new_lines,
    slide_old_lines,
    triangulate_lines,
)
from .marginalization import marginalize_old, marginalize_second_new
from .solver import SolverParams, reanchor_yaw, solve_window
from .triangulation import triangulate_all, triangulate_svd
from .window import (
    Tracks,
    WindowState,
    slide_new_state,
    slide_new_tracks,
    slide_old_state,
    slide_old_tracks,
)


class StepFlags(NamedTuple):
    """Per-frame dynamic gates (the reference's anomaly/stationary booleans,
    ``estimator.cpp:629-654, 890-896``)."""

    marg_old: bool          # host bool — keyframe ⇒ MARGIN_OLD else MARGIN_SECOND_NEW
    stationary: Tensor      # [] bool — freeze poses/speeds (estimator.cpp:3233-3263)
    wheel_valid: Tensor     # [F] per-interval wheel gate (anomaly ⇒ False)
    imu_valid: Tensor       # [F] per-interval IMU availability
    td_obs: Tensor          # [F] td at capture per frame
    propagate_newest: Tensor | None = None  # [] bool — IMU-propagate the
                                          # fresh slot F-1 from F-2 before the
                                          # solve (processIMU, estimator.cpp:
                                          # 743-783); the slide leaves only a
                                          # copy of the previous pose there
    gnss_ready: Tensor | None = None      # [] bool — GNSS-VI aligned
    frame_dts: Tensor | None = None       # [F] Δt between adjacent frames
    fix_yaw_enu: Tensor | None = None     # [] bool — low-speed yaw freeze
                                          # (estimator.cpp:2904-2930)
    first_gnss_opt: Tensor | None = None  # [] bool — first GNSS-enabled
                                          # solve anchors pose0 at its entry
                                          # value (estimator.cpp:2943-2951)


class EstimatorCore(NamedTuple):
    """Everything that persists across window steps."""

    state: WindowState
    tracks: Tracks
    imu_buf: ImuWindowBuffer
    wheel_buf: WheelWindowBuffer
    prior: MargPrior
    gnss_obs: object = None    # gnss.factors.GnssObsWindow when GNSS is enabled
    lines: object = None       # lines.LineTracks when use_line is on


def base_free_mask(cfg: Config, layout: StateLayout) -> np.ndarray:
    """Static optimizability mask from config toggles (the reference's
    ``SetParameterBlockConstant`` calls for extrinsics/td/intrinsics,
    ``estimator.cpp:2953-3100``)."""
    m = np.ones(layout.total, np.float64)
    if not cfg.solver.estimate_extrinsic:
        m[layout.ex_cam : layout.ex_cam + 6] = 0.0
    if not cfg.solver.estimate_td:
        m[layout.td] = 0.0
    if not cfg.wheel.estimate_extrinsic:
        m[layout.ex_wheel : layout.ex_wheel + 6] = 0.0
    if not cfg.wheel.estimate_intrinsic:
        m[layout.s_wheel : layout.s_wheel + 3] = 0.0
    if not cfg.wheel.estimate_td:
        m[layout.td_wheel] = 0.0
    if not cfg.plane.enabled:
        m[layout.plane : layout.plane + 4] = 0.0
    if not cfg.gnss.enabled:
        m[layout.gnss_dt : layout.nx] = 0.0
    return m


def check_supported(cfg: Config) -> None:
    """Raise for configuration switches whose modules are not ported yet."""
    pending = [
        (cfg.use_yolo, "use_yolo", "detector, calibration, other camera models"),
        (bool(cfg.burst_chunk), "burst_chunk", "execution modes (burst, live, fleet)"),
    ]
    for on, name, item in pending:
        if on:
            raise NotImplementedError(
                f"config switch {name!r} is not ported to ground_fusion_tpu_torch yet "
                f"(ROADMAP.md, queue 1: {item})")


def _slide_gnss_old(o):
    """Drop epoch slot 0: every slot moves down one, the last is cleared."""
    if o is None:
        return None
    return type(o)(*[torch.cat([a[1:], torch.zeros_like(a[:1])]) for a in o])


def _slide_gnss_new(o):
    """Second-new slide: slot F-1 moves into F-2, F-1 is cleared."""
    if o is None:
        return None
    return type(o)(*[torch.cat([a[:-2], a[-1:], torch.zeros_like(a[-1:])]) for a in o])


def make_window_step(cfg: Config, device=None):
    """Build the window step specialized on the static config. ``device=None``
    means the GPU (raises without one). The step runs eagerly; the returned
    function takes and returns tensors on ``device``."""
    device = resolve_device(device)
    step, layout = _build_step(cfg, device)
    return step, layout


def _build_step(cfg: Config, device):
    """The window step body."""
    check_supported(cfg)
    layout = StateLayout(cfg.num_frames, cfg.solver.max_landmarks,
                         cfg.lines.max_lines if cfg.use_line else 0)
    f = cfg.num_frames
    base_mask = torch.as_tensor(base_free_mask(cfg, layout))
    consts = {}

    def constants(dtype):
        """Per-dtype device constants, built once."""
        if dtype not in consts:
            kw = dict(dtype=dtype, device=device)
            consts[dtype] = dict(
                n18=noise_cov(cfg.imu.acc_n, cfg.imu.gyr_n, cfg.imu.acc_w, cfg.imu.gyr_w, **kw),
                n12=wheel_noise_cov(cfg.wheel.vel_n, cfg.wheel.gyr_n, **kw),
                g=torch.tensor([0.0, 0.0, cfg.imu.g_norm], **kw),
                base_mask=base_mask.to(**kw),
                ddt_weight=torch.tensor(cfg.gnss.ddt_weight, **kw),
                frame_cols=(torch.arange(layout.total, device=device) < PER_FRAME * f),
                params=SolverParams(
                    sqrt_info_scale=torch.tensor(cfg.solver.focal / 1.5, **kw),
                    cauchy_delta=torch.tensor(cfg.solver.huber_delta, **kw),
                    plane_sqrt_info=torch.tensor(
                        [cfg.plane.roll_n_inv, cfg.plane.pitch_n_inv, cfg.plane.zpw_n_inv], **kw),
                    lm_lambda0=torch.tensor(cfg.solver.lm_lambda0, **kw),
                    lm_up=torch.tensor(cfg.solver.lm_lambda_factor, **kw),
                    lm_down=torch.tensor(1.0 / cfg.solver.lm_lambda_factor, **kw),
                ),
            )
        return consts[dtype]

    def step(core: EstimatorCore, flags: StepFlags):
        dtype = core.state.poses.dtype
        c = constants(dtype)
        n18, n12, g, params = c["n18"], c["n12"], c["g"], c["params"]

        state, tracks = core.state, core.tracks
        imu_pre = preintegrate_imu_window(core.imu_buf, state.sbs, n18)
        wheel_pre = preintegrate_wheel_window(
            core.wheel_buf, state.s_wheel, state.td_wheel, n12
        )

        # device-side anomaly/stationarity gates (estimator.cpp:614-654,
        # 870-896) — OR-combined with any host overrides arriving through
        # the flags. The newest interval's wheel-vs-IMU anomaly test runs
        # ONCE here and is PERSISTED in wheel_buf.bad, which the slides
        # carry — a contaminated interval stays excluded for its whole
        # window lifetime (gates.newest_wheel_anomaly)
        stationary = flags.stationary
        wheel_buf = core.wheel_buf
        if cfg.wdetect or cfg.stationary_detect:
            anomaly_dev, stationary_dev = device_frame_gates(
                state, tracks, core.imu_buf, imu_pre, wheel_pre,
                g, cfg.solver.focal,
                cfg.init.stationary_acc_var, cfg.init.stationary_parallax,
                cfg.init.wheel_stationary_dp, cfg.wheel.anomaly_thresh,
            )
            if cfg.wdetect:
                wheel_buf = wheel_buf._replace(
                    bad=torch.cat([wheel_buf.bad[: f - 1], anomaly_dev[None]]))
                core = core._replace(wheel_buf=wheel_buf)
            if cfg.stationary_detect:
                stationary = stationary | stationary_dev

        # stationary: zero velocities, freeze all frame blocks
        moving = torch.where(stationary, 0.0, 1.0).to(dtype)
        state = state._replace(sbs=torch.cat([state.sbs[:, 0:3] * moving, state.sbs[:, 3:]], dim=1))
        free_mask = torch.where(c["frame_cols"], c["base_mask"] * moving, c["base_mask"])
        if cfg.gnss.enabled and flags.fix_yaw_enu is not None:
            yaw_free = torch.where(flags.fix_yaw_enu, 0.0, 1.0).to(dtype)
            free_mask = torch.cat([free_mask[: layout.yaw_enu],
                                   (free_mask[layout.yaw_enu] * yaw_free)[None],
                                   free_mask[layout.yaw_enu + 1 :]])

        if flags.propagate_newest is not None:
            # seed slot F-1 by propagating F-2 through the newest IMU interval
            # (the reference's processIMU runs before every processImage;
            # after slideWindow the new slot holds only a stale copy)
            i, j = f - 2, f - 1
            dt = imu_pre.sum_dt[j]
            q_i = state.poses[i, 3:7]
            p_pred = (
                state.poses[i, 0:3] + state.sbs[i, 0:3] * dt
                - 0.5 * g * dt * dt + quat_rotate(q_i, imu_pre.delta_p[j])
            )
            q_pred = quat_normalize(quat_mul(q_i, imu_pre.delta_q[j]))
            v_pred = state.sbs[i, 0:3] - g * dt + quat_rotate(q_i, imu_pre.delta_v[j])
            do_prop = flags.propagate_newest & flags.imu_valid[j] & ~stationary
            pose_j = torch.where(do_prop, torch.cat([p_pred, q_pred]), state.poses[j])
            sb_j = torch.cat([torch.where(do_prop, v_pred, state.sbs[j, 0:3]), state.sbs[j, 3:]])
            state = state._replace(
                poses=torch.cat([state.poses[:j], pose_j[None]]),
                sbs=torch.cat([state.sbs[:j], sb_j[None]]))
        wheel_valid = (flags.wheel_valid if cfg.wheel.enabled
                       else torch.zeros(f, dtype=torch.bool, device=device))
        if cfg.wheel.enabled and cfg.wdetect:
            # persistent per-interval anomaly flags: slot F-1 was just
            # evaluated; older slots keep the verdict from THEIR first solve
            # and slide/merge with the buffers (the reference skips all wheel
            # factors while its newest-interval flag is up,
            # estimator.cpp:3132-3136, then re-admits contaminated intervals
            # when it clears — here they stay out)
            wheel_valid = wheel_valid & ~wheel_buf.bad
        plane_valid = torch.full((f,), bool(cfg.plane.enabled), dtype=torch.bool, device=device)

        if cfg.use_depth:
            # depth-verified first, SVD fallback (estimator.cpp:1068-1075)
            tracks = triangulate_all(state, tracks, depth_max=cfg.tracker.depth_max)
        else:
            tracks = triangulate_svd(state, tracks)

        use_lines = cfg.use_line and core.lines is not None
        lines = core.lines if use_lines else None
        line_cull = dict(min_obs=cfg.lines.min_obs,
                         max_reproj=cfg.lines.outlier_reproj_px / 500.0)
        if use_lines:
            # triangulate fresh lines, refine them with the poses fixed, then
            # cull BEFORE the joint solve — the reference's onlyLineOpt ends
            # with removeLineOutlier (estimator.cpp:4269). Triangulation waits
            # for a valid prior: lines triangulated from the raw
            # initialization poses would lock the window to the init error
            lines = triangulate_lines(
                state, lines, min_obs=cfg.lines.min_obs,
                min_cos_theta=cfg.lines.min_cos_theta, enabled=core.prior.valid)
            lines = only_line_opt(state, lines, params.sqrt_info_scale,
                                  min_obs=cfg.lines.min_obs, iters=cfg.lines.only_opt_iters)
            lines = remove_line_outliers(state, lines, **line_cull)

        if cfg.use_mcc:
            bad = moving_consistency_check(state, tracks, focal=cfg.solver.focal)
            tracks = remove_outliers(tracks, bad)

        use_gnss = cfg.gnss.enabled and core.gnss_obs is not None
        inp = SolveInputs(
            imu_pre=imu_pre,
            imu_valid=flags.imu_valid,
            wheel_pre=wheel_pre,
            wheel_valid=wheel_valid,
            plane_valid=plane_valid,
            td_obs=flags.td_obs,
            prior=core.prior,
            g=g,
            free_mask=free_mask,
            line_min_obs=cfg.lines.min_obs,
            line_weight=cfg.lines.weight_scale,
        )
        if use_gnss:
            first = (flags.first_gnss_opt if flags.first_gnss_opt is not None
                     else torch.zeros((), dtype=torch.bool, device=device))
            inp = inp._replace(
                gnss_obs=core.gnss_obs, gnss_ready=flags.gnss_ready,
                frame_dts=flags.frame_dts, ddt_weight=c["ddt_weight"],
                anchor_pose=state.poses[0], anchor_active=first)

        state_before = state
        solved = solve_window(
            state, tracks, inp, layout, params,
            num_iters=cfg.solver.max_iters, lines=lines,
            method=cfg.solver.method, linear_solver=cfg.solver.linear_solver,
        )
        if use_lines:
            state, tracks, lines, cost = solved
        else:
            state, tracks, cost = solved
        # anchor-camera lines (LINEINCAM) are gauge-invariant: the re-anchor
        # below carries them along with their anchor pose
        anchored = reanchor_yaw(state_before, state)
        if use_gnss:
            # once GNSS-VI alignment has installed the ENU yaw and anchor,
            # the GNSS rows hold the gauge; re-anchoring the window alone
            # would undo at every step the yaw they solve for (the JAX
            # package re-anchors regardless; ROADMAP queue 3)
            keep = flags.gnss_ready
            anchored = anchored._replace(
                poses=torch.where(keep, state.poses, anchored.poses),
                sbs=torch.where(keep, state.sbs, anchored.sbs))
        state = anchored
        if use_lines:
            # post-solve cull (estimator.cpp:4580)
            lines = remove_line_outliers(state, lines, **line_cull)

        # the host knows the keyframe decision: compute one branch only
        if flags.marg_old:
            prior = marginalize_old(
                state, tracks, inp, layout, params.sqrt_info_scale,
                params.cauchy_delta, params.plane_sqrt_info, lines=lines,
            )
            core_new = EstimatorCore(
                state=slide_old_state(state),
                tracks=slide_old_tracks(state, tracks),
                imu_buf=slide_old_imu_buffer(core.imu_buf),
                wheel_buf=slide_old_wheel_buffer(core.wheel_buf),
                prior=prior,
                gnss_obs=_slide_gnss_old(core.gnss_obs),
                lines=slide_old_lines(state, lines) if use_lines else None,
            )
        else:
            prior = marginalize_second_new(state, core.prior, layout)
            core_new = EstimatorCore(
                state=slide_new_state(state),
                tracks=slide_new_tracks(tracks),
                imu_buf=slide_new_imu_buffer(core.imu_buf),
                wheel_buf=slide_new_wheel_buffer(core.wheel_buf),
                prior=prior,
                gnss_obs=_slide_gnss_new(core.gnss_obs),
                lines=slide_new_lines(lines) if use_lines else None,
            )
        # device-side failure flag (failureDetection's active bias checks,
        # estimator.cpp:2847-2888)
        failed = (torch.linalg.norm(state.sbs[f - 1, 3:6]) > cfg.solver.fail_ba_thresh) | \
                 (torch.linalg.norm(state.sbs[f - 1, 6:9]) > cfg.solver.fail_bg_thresh)
        # solved (pre-slide) newest pose is the odometry output of this step
        return core_new, {"pose": state.poses[f - 1], "sb": state.sbs[f - 1], "cost": cost,
                          "poses": state.poses, "failed": failed}

    return step, layout
