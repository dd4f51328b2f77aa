"""The per-keyframe window step — one function on device tensors.

This is the ``processImage`` → ``optimization`` → marginalize →
``slideWindow`` path (``estimator.cpp:843-1163, 2890-3795``) as a single pure
function: preintegrate all intervals, triangulate, solve, re-anchor the
gauge, marginalize, slide. The keyframe decision is known on the host, so the
step branches on it in Python and computes one marginalization only; every
other gate stays a device tensor.

With ``use_line`` the step carries the line landmarks (:mod:`.lines`):
triangulation, the line-only refinement and the cull before the solve, the
line rows in it, the cull after it and both line slides.

Beside the per-frame step, the execution modes of the JAX package are built
from the same step body: the packed codec and packed step, a burst of K
steps enqueued back to back (:func:`make_window_burst`), the burst with the
frames' ingest done on the device (:func:`make_window_burst_ingest`, which
``pipeline.Estimator.enable_burst`` and ``enable_live`` run) and the fleet of
B sequences in lockstep (:func:`make_window_burst_batched`, the step under
``torch.func.vmap``). None of them copies anything to the host between
steps: the keyframe decisions come from the host with the inputs. On CUDA
the host still waits inside every ``torch.linalg.eigh`` of a step
(triangulation, marginalization), whose error check synchronizes.

The landmark-sharded step of ``parallel/sharded.py`` is this step body
(:func:`_build_step`) with a ``reduce`` that sums over the ranks; it is a
per-frame step only: the bursts and the fleet take a whole core.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import Tensor
from torch.utils import _pytree as pytree

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


def _stack_outputs(outs: list) -> dict:
    return pytree.tree_map(lambda *ts: torch.stack(ts), *outs)


def make_packed_codec(template):
    """(pack, unpack) between a core (or any pytree of tensors) and THREE
    flat blobs (one per dtype family: bool, float, integer). The JAX package
    uses it to cut per-leaf dispatch cost; here it gives a pytree one flat
    buffer per family, so that it crosses a boundary (a copy, a fetch) in
    three transfers: ``Estimator._upload_staged`` uploads a flush's inputs
    through it. The packed step is bit-identical to the step. Every family
    must hold one dtype: a narrower blob would round wider leaves, so mixing
    is refused."""
    leaves, spec = pytree.tree_flatten(template)
    fam_of = {}
    for i, leaf in enumerate(leaves):
        if isinstance(leaf, Tensor):
            fam = ("f" if leaf.is_floating_point() else "b" if leaf.dtype == torch.bool else "i")
            fam_of.setdefault(fam, []).append(i)
    fams = sorted(fam_of)                       # deterministic blob order
    for fam in fams:
        mixed = {str(leaves[i].dtype) for i in fam_of[fam]}
        if len(mixed) > 1:
            raise TypeError(
                f"make_packed_codec: dtype family {fam!r} mixes {sorted(mixed)}; "
                "packing would round-trip through one of them")

    def pack(tree):
        ls = pytree.tree_leaves(tree)
        return tuple(torch.cat([ls[i].reshape(-1) for i in fam_of[fam]]) for fam in fams)

    def unpack(blobs):
        out = list(leaves)                      # non-tensor leaves from the template
        for fam, blob in zip(fams, blobs):
            parts = torch.split(blob, [leaves[i].numel() for i in fam_of[fam]])
            for i, part in zip(fam_of[fam], parts):
                out[i] = part.reshape(leaves[i].shape)
        return pytree.tree_unflatten(out, spec)

    return pack, unpack


def make_window_step_packed(cfg: Config, template_core: EstimatorCore, device=None):
    """The window step over packed blobs (:func:`make_packed_codec`):
    ``packed_step(blobs, flags) -> (blobs, out)``. Returns (packed step,
    pack, unpack, layout)."""
    step, layout = make_window_step(cfg, device)
    pack, unpack = make_packed_codec(template_core)

    def packed_step(blobs, flags: StepFlags):
        core, out = step(unpack(blobs), flags)
        return pack(core), out

    return packed_step, pack, unpack, layout


def make_window_burst(cfg: Config, device=None):
    """Burst/replay mode: a chunk of K window steps enqueued back to back —
    ``burst(core, flags_batch)``, where every tensor of ``flags_batch`` has a
    leading chunk axis K and ``marg_old`` is a host bool array [K] (the
    keyframe decisions, known on the host for every staged frame). No device
    read happens between the steps; the outputs are stacked on the device
    (``[K, ...]``). The JAX package scans the step in one program
    (``lax.scan``); here each step is eager, so a burst is the per-frame step
    K times without the per-frame fetches."""
    step, layout = make_window_step(cfg, device)

    def burst(core: EstimatorCore, flags_batch: StepFlags):
        margs = np.asarray(flags_batch.marg_old, bool)
        outs = []
        for k in range(len(margs)):
            fl = pytree.tree_map_only(Tensor, lambda t: t[k], flags_batch)
            core, out = step(core, fl._replace(marg_old=bool(margs[k])))
            outs.append(out)
        return core, _stack_outputs(outs)

    return burst, layout


def make_window_burst_batched(cfg: Config, device=None):
    """Fleet replay: B independent estimator cores advanced in lockstep —
    ``burst(cores, flags_batch)``, every tensor of ``cores`` with a leading
    axis B (``utils.convert.stack_cores``), every tensor of ``flags_batch``
    with leading axes [K, B], ``marg_old`` a host bool array [K, B]. Returns
    the final batched cores and the outputs stacked [K, B, ...].

    Each of the K steps runs the window step under ``torch.func.vmap``: the
    batch is split by its host-known keyframe decisions, the vmapped step
    runs once with ``marg_old=True`` on one part and once with
    ``marg_old=False`` on the other, and the two parts' cores and outputs
    are merged tensor by tensor with ``index_copy`` (both branches give
    cores of the same shapes). Nothing is computed for a branch a sequence
    does not take, and there is no loop over the sequences. Each core is a
    whole core: a landmark-sharded core (``parallel/sharded.py``) runs only
    through ``make_sharded_window_step``, one frame at a time."""
    step, layout = make_window_step(cfg, device)

    def vstep(cores, flags, marg_old: bool):
        args = (cores, flags._replace(marg_old=None))
        dims = pytree.tree_map(lambda x: 0 if isinstance(x, Tensor) else None, args)
        return torch.func.vmap(lambda c, fl: step(c, fl._replace(marg_old=marg_old)),
                               in_dims=dims, out_dims=(dims[0], 0))(*args)

    def burst(cores: EstimatorCore, flags_batch: StepFlags):
        margs = np.asarray(flags_batch.marg_old, bool)
        n_b = margs.shape[1]
        dev = cores.state.poses.device
        outs = []
        for k in range(margs.shape[0]):
            fl = pytree.tree_map_only(Tensor, lambda t: t[k], flags_batch)
            parts = []
            for branch in (True, False):
                sel = np.nonzero(margs[k] == branch)[0]
                if len(sel) == n_b:          # the whole batch takes this branch
                    parts = [(None, vstep(cores, fl, branch))]
                    break
                if len(sel):
                    idx = torch.as_tensor(sel, device=dev)
                    sub = lambda t: t.index_select(0, idx)
                    parts.append((idx, vstep(pytree.tree_map_only(Tensor, sub, cores),
                                             pytree.tree_map_only(Tensor, sub, fl), branch)))
            if len(parts) == 1:
                cores, out = parts[0][1]
            else:
                (ia, ra), (ib, rb) = parts

                def merge(a, b):
                    if not isinstance(a, Tensor):
                        return a
                    return (torch.zeros((n_b,) + a.shape[1:], dtype=a.dtype, device=dev)
                            .index_copy(0, ia, a).index_copy(0, ib, b))

                cores, out = pytree.tree_map(merge, ra, rb)
            outs.append(out)
        return cores, _stack_outputs(outs)

    return burst, layout


def make_window_burst_ingest(cfg: Config, device=None):
    """Burst replay WITH on-device measurement ingest: each of the K steps
    first writes frame k's sensor interval and feature observations into the
    core, then runs the window step — ingest → solve → marginalize → slide,
    K times, with no device→host copy in between (the host still waits
    inside each step's ``torch.linalg.eigh``). ``burst(core, xs)``:

    - ``i_*`` / ``w_*`` — padded IMU/wheel interval tensors for buffer slot
      F-1, each with a leading axis K
    - ``rows [K, ML]`` — a PERMUTATION of landmark-slot indices: the first
      entries are the slots written this frame, the rest are the unwritten
      slots. A permutation makes every write collision-free: the per-entry
      masks are moved to their slots with one ``index_copy`` each, and the
      table is then updated elementwise.
    - ``vals [K, ML, 5]`` — observation rows for ``rows``; ``wmask`` — which
      entries are real writes; ``nmask`` — which writes open a NEW slot
      (scrub stale columns, reset depth/flags, re-anchor at F-1)
    - ``marg_old`` — the keyframe decisions, a host bool array [K]
    - when ``cfg.use_line``: ``l_rows/l_vals/l_wmask/l_nmask`` — the same
      permutation-write scheme for the line-landmark table
    - with GNSS: ``gnss_ready [K]`` and ``frame_dts [K, F]``

    Returns the new core, the outputs stacked ``[K, ...]`` and the post-chunk
    mirror tables (landmark ``obs_valid``, ``active``, ``obs[..., 0:2]``;
    with lines the line ``obs_valid`` and ``active``) for the host's one
    fetch. Used by ``pipeline.Estimator.enable_burst``. The core is a whole
    core: a landmark-sharded core (``parallel/sharded.py``) runs only
    through ``make_sharded_window_step``, one frame at a time."""
    step, layout = make_window_step(cfg, device)
    f = cfg.num_frames

    def put_slot(buf, fields, xs, prefix):
        """Write slot F-1 of each field from ``xs[prefix + name]``."""
        upd = {}
        for name in fields:
            a = getattr(buf, name)
            upd[name] = torch.cat([a[: f - 1], xs[prefix + name].to(a.dtype)[None]])
        return buf._replace(**upd)

    def scatter_table(table, rows, vals, wmask, nmask, onehot):
        """The writes common to the landmark and line tables, one slot per
        entry of the permutation ``rows``; returns the per-slot masks too."""
        w_slot = torch.zeros_like(wmask).index_copy(0, rows, wmask)
        n_slot = torch.zeros_like(nmask).index_copy(0, rows, nmask)
        v_slot = torch.zeros(vals.shape, dtype=table.obs.dtype, device=vals.device).index_copy(
            0, rows, vals.to(table.obs.dtype))
        ov = torch.where(n_slot[:, None], onehot[None, :], table.obs_valid)
        ov = torch.cat([ov[:, : f - 1], (w_slot | ov[:, f - 1])[:, None]], dim=1)
        obs_new = torch.where(w_slot[:, None], v_slot, table.obs[:, f - 1])
        obs = torch.cat([table.obs[:, : f - 1], obs_new[:, None]], dim=1)
        return table._replace(obs=obs, obs_valid=ov, active=n_slot | table.active,
                              solve_ok=~n_slot & table.solve_ok,
                              start_frame=torch.where(n_slot, f - 1, table.start_frame)), n_slot

    def body(core: EstimatorCore, xs: dict, marg_old: bool, fixed: dict):
        dtype = core.state.poses.dtype
        ib = put_slot(core.imu_buf, ("dts", "acc", "gyr", "valid", "acc0", "gyr0"), xs, "i_")
        wb = put_slot(core.wheel_buf, ("dts", "vel", "gyr", "valid", "vel0", "gyr0"), xs, "w_")
        tr, n_slot = scatter_table(core.tracks, xs["rows"], xs["vals"], xs["wmask"],
                                   xs["nmask"], fixed["onehot"])
        tr = tr._replace(
            depth_fixed=~n_slot & tr.depth_fixed,
            inv_depth=torch.where(n_slot, torch.tensor(0.2, dtype=dtype, device=n_slot.device),
                                  tr.inv_depth))
        core = core._replace(imu_buf=ib, wheel_buf=wb, tracks=tr)
        if cfg.use_line and core.lines is not None:
            ln, ln_slot = scatter_table(core.lines, xs["l_rows"], xs["l_vals"], xs["l_wmask"],
                                        xs["l_nmask"], fixed["onehot"])
            ln = ln._replace(orth=torch.where(ln_slot[:, None], 0.0, ln.orth))
            core = core._replace(lines=ln)

        gnss_kw = {}
        if cfg.gnss.enabled:
            # low-speed yaw freeze from the CURRENT state speed (the host
            # flag of the per-frame path is the same quantity, fetched)
            speed = torch.linalg.norm(core.state.sbs[f - 1, 0:3])
            gnss_kw = dict(gnss_ready=xs["gnss_ready"], frame_dts=xs["frame_dts"].to(dtype),
                           fix_yaw_enu=speed < cfg.gnss.low_speed_yaw_fix,
                           first_gnss_opt=fixed["false"])
        flags = StepFlags(marg_old=marg_old, stationary=fixed["false"],
                          wheel_valid=fixed["interval"], imu_valid=fixed["interval"],
                          td_obs=fixed["td_obs"].to(dtype), propagate_newest=fixed["true"],
                          **gnss_kw)
        return step(core, flags)

    def burst(core: EstimatorCore, xs: dict):
        margs = np.asarray(xs["marg_old"], bool)
        dev = core.state.poses.device
        fixed = dict(
            onehot=torch.arange(f, device=dev) == f - 1,
            interval=torch.arange(f, device=dev) >= 1,
            false=torch.zeros((), dtype=torch.bool, device=dev),
            true=torch.ones((), dtype=torch.bool, device=dev),
            td_obs=torch.zeros(f, dtype=core.state.poses.dtype, device=dev),
        )
        outs = []
        for k in range(len(margs)):
            xk = {name: v[k] for name, v in xs.items() if name != "marg_old"}
            core, out = body(core, xk, bool(margs[k]), fixed)
            outs.append(out)
        # the post-chunk mirror tables ride out with the same fetch as the
        # outputs, so the host reconciles its mirrors without another trip
        mirrors = [core.tracks.obs_valid, core.tracks.active, core.tracks.obs[..., 0:2]]
        if cfg.use_line and core.lines is not None:
            mirrors += [core.lines.obs_valid, core.lines.active]
        return core, _stack_outputs(outs), tuple(mirrors)

    return burst, layout


def _build_step(cfg: Config, device, reduce=None):
    """The window step body. With ``reduce`` (``parallel/sharded.py``'s
    landmark-sharded step) the core's tracks and lines are this rank's
    ``1/reduce.world`` of the slots, the layout's landmark and line columns
    are the rank's own, and the sums that couple landmarks go through
    ``reduce`` (the stationary vote, the solve, the frame-0
    marginalization); everything else is the same step on every rank."""
    shards = 1 if reduce is None else reduce.world
    layout = StateLayout(cfg.num_frames, cfg.solver.max_landmarks // shards,
                         cfg.lines.max_lines // shards if cfg.use_line else 0)
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
                cfg.init.wheel_stationary_dp, cfg.wheel.anomaly_thresh, reduce=reduce,
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
            method=cfg.solver.method, linear_solver=cfg.solver.linear_solver, reduce=reduce,
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
                params.cauchy_delta, params.plane_sqrt_info, lines=lines, reduce=reduce,
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
