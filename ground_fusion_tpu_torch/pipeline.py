"""Host-side estimator pipeline: sensor ingest, window fill, initialization
dispatch, keyframe decision, and the per-frame window step.

This is the replacement for the reference's node main loop + estimator
measurement pump (``rosNodeTest.cpp:290-565`` sync_process,
``estimator.cpp:526-711`` processMeasurements, ``:843-1163`` processImage):
the host owns only queues, slot allocation and mode switches; all math runs
on the device in :func:`~.estimator.step.make_window_step`'s step.

Device↔host traffic per frame is two fetches — the landmark table's masks
(and, with lines, the line slots' activity) before the frame is written
(keyframe gate + slot recycling) and the step's packed outputs after it —
plus the uploads of the new interval and the new observations (with GNSS:
one GNSS epoch slot and one packed flag upload).
GNSS epochs are gated and reduced on the host in float64
(:mod:`.gnss.ingest`); only the reduced, small quantities reach the device.

Burst mode (:meth:`Estimator.enable_burst`, and live mode, a burst of one)
stages frames against NumPy mirrors of the landmark and line tables: a
staged frame makes no device read. A flush uploads the chunk's inputs (one
copy per dtype family), runs K ingest-and-step iterations on the device
(``estimator.step.make_window_burst_ingest``) and makes one packed fetch of
the poses, speed/bias vectors, failure flags and post-chunk mirror tables.

The estimator snapshots to and resumes from an npz archive in the JAX
package's format (:meth:`Estimator.save_state`, :meth:`Estimator.load_state`).
The sensor queues are plain Python lists (the C++ ring-buffer ingest is not
ported yet).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .config import Config
from .estimator.assembly import empty_prior
from .estimator.buffers import (
    empty_imu_buffer,
    empty_wheel_buffer,
    preintegrate_imu_window,
    preintegrate_wheel_window,
    slide_old_imu_buffer,
    slide_old_wheel_buffer,
)
from .estimator.gates import failure_detection
from .estimator.initialization import (
    align_window_to_gravity,
    calibrate_extrinsic_rotation,
    linear_alignment_depth,
    linear_alignment_mono,
    linear_alignment_wd,
    linear_alignment_wheel,
    solve_gyroscope_bias,
    stationary_bias_init,
)
from .estimator.lines import empty_line_tracks, slide_old_lines
from .estimator.sfm import N_HYPOTHESES, relative_pose_ransac, sfm_construct
from .estimator.step import EstimatorCore, StepFlags, make_packed_codec, make_window_step
from .estimator.window import empty_state, empty_tracks, slide_old_state, slide_old_tracks
from .geometry.se3 import pose as make_pose, pose_compose, pose_inverse
from .geometry.so3 import mat_to_quat, quat_to_mat
from .global_layers.pnp import gumbel_noise
from .gnss.factors import SLOT_SCALARS, SLOT_VECTORS, empty_gnss_obs
from .gnss.ingest import GnssIngest
from .preintegration.imu import noise_cov
from .preintegration.wheel import wheel_noise_cov
from .utils import np_quat


@dataclass
class FrameFeature:
    """One feature observation handed in by the front-end (the per-id entry of
    ``trackImage``'s output map, feature_tracker.h:47-48)."""

    x: float
    y: float
    vx: float = 0.0
    vy: float = 0.0
    depth: float = 0.0


class Estimator:
    """Sliding-window RGBD/VIO/wheel estimator (host orchestration)."""

    INITIAL = 0
    NON_LINEAR = 1

    def __init__(self, cfg: Config, dtype=torch.float32, device=None):
        """``device=None`` means the GPU and raises when there is none; pass
        ``device="cpu"`` to run on the CPU on purpose."""
        self.cfg = cfg
        self.dtype = dtype
        self.device = resolve_device(device)
        self.step_fn, self.layout = make_window_step(cfg, self.device)
        self.f = cfg.num_frames
        self.core = self._empty_core()
        self.gnss = GnssIngest(cfg) if cfg.gnss.enabled else None
        self.gnss_aligned = False
        self.gnss_aligned_at: Optional[float] = None   # newest frame time at alignment
        self._first_gnss_opt = True   # estimator.cpp:152 (reset by clearState)
        self._pending_gnss: Optional[tuple] = None   # (epoch time, obs list)
        # raw float64 epochs received pre-alignment, installed at alignment
        self._gnss_pre_epochs: list[tuple[float, list]] = []
        # host copy of the state's anchor column (the ENU delta from the
        # float64 expansion anchor), refreshed by every step's packed fetch
        self._anc_delta = np.zeros(3)
        self.solver_flag = self.INITIAL
        self.frame_count = 0              # frames currently occupied (fill phase)
        self.ts: list[float] = []
        self.slot_of: dict[int, int] = {}
        self.free_slots = list(range(cfg.solver.max_landmarks))
        self.line_slot_of: dict[int, int] = {}
        self.free_line_slots = list(range(cfg.lines.max_lines)) if cfg.use_line else []
        # raw queues since the previous frame
        self.imu_q: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.wheel_q: list[tuple[float, np.ndarray, np.ndarray]] = []
        self.last_imu: Optional[tuple] = None
        self.last_wheel: Optional[tuple] = None
        self.all_imu_window: list[list] = []      # per-interval copies for init stats
        self.trajectory: list[tuple[float, np.ndarray]] = []
        self.keyframe_flags: list[bool] = []
        # running parallax bookkeeping
        self._prev_feats: dict[int, FrameFeature] = {}
        self._fp: Optional[dict] = None
        self._fp_seed: Optional[tuple] = None
        self._last_sb: Optional[np.ndarray] = None
        self._last_out_failed: Optional[bool] = None
        self.reboots = 0
        # burst replay (enable_burst): 0 = per-frame dispatch
        self._burst_chunk = 0
        self._burst_xs: list[dict] = []
        self._burst_meta: list[tuple[float, bool]] = []
        self._burst_flushed_sizes: list[int] = []
        self._mirror_synced = False

    def _kw(self):
        return dict(dtype=self.dtype, device=self.device)

    def _empty_core(self) -> EstimatorCore:
        cfg, f = self.cfg, self.f
        return EstimatorCore(
            state=self._initial_state(),
            tracks=empty_tracks(cfg.solver.max_landmarks, f, **self._kw()),
            imu_buf=empty_imu_buffer(f, cfg.solver.max_imu_per_interval, **self._kw()),
            wheel_buf=empty_wheel_buffer(f, cfg.solver.max_wheel_per_interval, **self._kw()),
            prior=empty_prior(self.layout, f, **self._kw()),
            gnss_obs=(empty_gnss_obs(f, cfg.gnss.max_sats, **self._kw())
                      if cfg.gnss.enabled else None),
            lines=(empty_line_tracks(cfg.lines.max_lines, f, **self._kw())
                   if cfg.use_line else None),
        )

    def _initial_state(self):
        """Seed the window state from the config — the reference's
        ``setParameter`` copies TIC/RIC/TIO/RIO/sx,sy,sw/td/td_wheel into the
        estimator before anything runs (estimator.cpp:168-211)."""
        cfg = self.cfg
        kw = self._kw()
        st = empty_state(self.f, **kw)
        return st._replace(
            ex_cam=torch.tensor(list(cfg.camera.t_ic) + list(cfg.camera.q_ic), **kw),
            ex_wheel=torch.tensor(list(cfg.wheel.t_io) + list(cfg.wheel.q_io), **kw),
            s_wheel=torch.tensor([cfg.wheel.sx, cfg.wheel.sy, cfg.wheel.sw], **kw),
            td=torch.tensor(cfg.solver.td, **kw),
            td_wheel=torch.tensor(cfg.wheel.td, **kw),
        )

    def _upload(self, a, dtype=None):
        return torch.as_tensor(np.asarray(a)).to(device=self.device, dtype=dtype or self.dtype)

    # ------------------------------------------------------------------ ingest

    def input_imu(self, t: float, acc, gyr) -> None:
        acc = np.asarray(acc, np.float64)
        gyr = np.asarray(gyr, np.float64)
        self.imu_q.append((t, acc, gyr))
        self._fast_predict(t, acc, gyr)

    def _fast_predict(self, t, acc, gyr):
        """IMU-rate dead-reckoned odometry on top of the last optimized state
        (Estimator::fastPredictIMU, estimator.cpp:4014-4030; published as the
        ~200 Hz latest-odometry path). Read via :meth:`latest_odometry`."""
        if self.solver_flag != self.NON_LINEAR:
            self._fp = None
            return
        if self._fp is None:
            if self._fp_seed is not None:
                # seeded from the last step's fetched outputs — no extra
                # device→host round trip per seed
                pose, sb = self._fp_seed
            else:
                pose, sb = (x.cpu().numpy().astype(np.float64) for x in (
                    self.core.state.poses[self.f - 1], self.core.state.sbs[self.f - 1]))
            self._fp = {
                "t": t,
                "p": np.asarray(pose[0:3], np.float64),
                "q": np.asarray(pose[3:7], np.float64),
                "v": np.asarray(sb[0:3], np.float64),
                "ba": np.asarray(sb[3:6], np.float64),
                "bg": np.asarray(sb[6:9], np.float64),
                "acc": acc, "gyr": gyr,
            }
            return
        fp = self._fp
        dt = t - fp["t"]
        if dt <= 0 or dt > 1.0:
            fp.update(t=t, acc=acc, gyr=gyr)
            return
        g = np.array([0.0, 0.0, self.cfg.imu.g_norm])
        R0 = np_quat.quat_to_mat(fp["q"])
        un_acc0 = R0 @ (fp["acc"] - fp["ba"]) - g
        un_gyr = 0.5 * (fp["gyr"] + gyr) - fp["bg"]
        q = np_quat.quat_normalize(
            np_quat.quat_mul(fp["q"], np.concatenate([[1.0], 0.5 * un_gyr * dt])))
        R1 = np_quat.quat_to_mat(q)
        un_acc1 = R1 @ (acc - fp["ba"]) - g
        un_acc = 0.5 * (un_acc0 + un_acc1)
        fp["p"] = fp["p"] + fp["v"] * dt + 0.5 * un_acc * dt * dt
        fp["v"] = fp["v"] + un_acc * dt
        fp.update(t=t, q=q, acc=acc, gyr=gyr)

    def latest_odometry(self):
        """(t, pose7, v) of the IMU-rate propagated state, or None."""
        fp = self._fp
        if fp is None:
            return None
        return fp["t"], np.concatenate([fp["p"], fp["q"]]), fp["v"]

    def input_wheel(self, t: float, vel, gyr) -> None:
        gyr = np.asarray(gyr, np.float64).copy()
        if getattr(self.cfg.wheel, "w_replace", False) and self._fp is not None:
            # wheel yaw-rate replaced by the latest IMU gyro z (w_replace,
            # rosNodeTest.cpp:93-156 — wheel gyros are usually the worst axis)
            gyr[2] = self._fp["gyr"][2] - self._fp["bg"][2]
        self.wheel_q.append((t, np.asarray(vel, np.float64), gyr))

    def input_gnss(self, t: float, obs_list: list[dict]) -> None:
        """One GNSS epoch (list of per-satellite obs dicts, see
        gnss.ingest). Attached to the window at the bracketing-frame slot
        with its epoch time (the reference's time-pulse sync,
        rosNodeTest.cpp GNSS callbacks + estimator.cpp:3193-3207)."""
        if self.gnss is not None:
            self._pending_gnss = (t, obs_list)

    # ------------------------------------------------------- interval building

    def _drain_interval(self, t1: float):
        """Pop queued samples up to t1 into padded interval arrays."""
        cfg = self.cfg
        imu = [s for s in self.imu_q if s[0] <= t1 + 1e-9]
        self.imu_q = [s for s in self.imu_q if s[0] > t1 + 1e-9]
        wheel = [s for s in self.wheel_q if s[0] <= t1 + 1e-9]
        self.wheel_q = [s for s in self.wheel_q if s[0] > t1 + 1e-9]

        def pad(samples, last, cap, t_prev):
            k = min(len(samples), cap)
            dts = np.zeros(cap)
            a = np.zeros((cap, 3))
            g = np.zeros((cap, 3))
            v = np.zeros(cap, bool)
            tp = t_prev
            for i, (t, x, w) in enumerate(samples[:k]):
                dts[i] = t - tp
                a[i], g[i], v[i] = x, w, True
                tp = t
            x0 = last[1] if last is not None else (samples[0][1] if samples else np.zeros(3))
            g0 = last[2] if last is not None else (samples[0][2] if samples else np.zeros(3))
            return dts, a, g, v, x0, g0

        t_prev = self.ts[-1] if self.ts else (imu[0][0] if imu else t1)
        iv = pad(imu, self.last_imu, cfg.solver.max_imu_per_interval, t_prev)
        wv = pad(wheel, self.last_wheel, cfg.solver.max_wheel_per_interval, t_prev)
        if imu:
            self.last_imu = imu[-1]
        if wheel:
            self.last_wheel = wheel[-1]
        self.all_imu_window.append(imu)
        if len(self.all_imu_window) > self.f:
            self.all_imu_window.pop(0)
        return iv, wv

    def _write_interval(self, slot: int, iv, wv):
        """Upload one padded interval into slot ``slot`` of both buffers
        (new tensors; the previous core is left untouched)."""
        def put(buf, names, vals):
            upd = {}
            for name, val in zip(names, vals):
                t = getattr(buf, name).clone()
                t[slot] = self._upload(val, torch.bool if name == "valid" else None)
                upd[name] = t
            return buf._replace(**upd)

        ib = put(self.core.imu_buf, ("dts", "acc", "gyr", "valid", "acc0", "gyr0"), iv)
        wb = put(self.core.wheel_buf, ("dts", "vel", "gyr", "valid", "vel0", "gyr0"), wv)
        self.core = self.core._replace(imu_buf=ib, wheel_buf=wb)

    # --------------------------------------------------------- feature ingest

    def _fetch_track_masks(self):
        """ONE device→host fetch of what the host needs from the landmark
        and line tables this frame: (obs_valid [ML,F], active [ML], obs_xy
        [ML,F,2], line active [LL] or None)."""
        tr, ln = self.core.tracks, self.core.lines
        got = self._fetch([tr.obs_valid, tr.active, tr.obs[..., 0:2]]
                          + ([ln.active] if ln is not None else []))
        return (*got[0:3], got[3] if ln is not None else None)

    def _assign_slots(self, feats: dict[int, FrameFeature], slot_frame: int,
                      active_np: np.ndarray):
        """Allocate/recycle landmark slots and write observations into the
        padded Tracks table (FeatureManager::addFeature semantics)."""
        tr = self.core.tracks

        # recycle slots whose feature id vanished and track died
        for fid, slot in list(self.slot_of.items()):
            if not active_np[slot]:
                del self.slot_of[fid]
                self.free_slots.append(slot)

        rows, vals, new_active = [], [], []
        for fid, ft in feats.items():
            slot = self.slot_of.get(fid)
            if slot is None:
                if not self.free_slots:
                    continue  # table full — drop (reference caps at 1000 slots)
                slot = self.free_slots.pop()
                self.slot_of[fid] = slot
                new_active.append(slot)
            rows.append(slot)
            vals.append([ft.x, ft.y, ft.vx, ft.vy, ft.depth])

        obs, obs_valid = tr.obs.clone(), tr.obs_valid.clone()
        if rows:
            rows_t = self._upload(np.asarray(rows, np.int64), torch.int64)
            obs[rows_t, slot_frame] = self._upload(np.asarray(vals, np.float64).reshape(-1, 5))
            obs_valid[rows_t, slot_frame] = True
        if new_active:
            na = self._upload(np.asarray(new_active, np.int64), torch.int64)
            # scrub stale observations left by the slot's previous tenant:
            # only this frame's column may be valid for a fresh slot
            keep_col = torch.zeros(self.f, dtype=torch.bool, device=self.device)
            keep_col[slot_frame] = True
            obs_valid[na] = obs_valid[na] & keep_col[None, :]
            active, solve_ok, depth_fixed, start_frame, inv_depth = (
                t.clone() for t in (tr.active, tr.solve_ok, tr.depth_fixed,
                                    tr.start_frame, tr.inv_depth))
            active[na] = True
            solve_ok[na] = False
            depth_fixed[na] = False
            start_frame[na] = slot_frame
            inv_depth[na] = 0.2
            tr = tr._replace(active=active, solve_ok=solve_ok, depth_fixed=depth_fixed,
                             start_frame=start_frame, inv_depth=inv_depth)
        self.core = self.core._replace(tracks=tr._replace(obs=obs, obs_valid=obs_valid))

    def _assign_line_slots(self, line_obs: Optional[dict], slot_frame: int,
                           active_np: Optional[np.ndarray]):
        """Allocate/recycle line slots and write the frame's segment
        observations into the padded LineTracks table (the line twin of
        :meth:`_assign_slots`; the reference's ``lineFeaturePerId`` list,
        feature_manager.h). One indexed write per table field."""
        ln = self.core.lines
        if ln is None or not line_obs:
            return
        for lid, slot in list(self.line_slot_of.items()):
            if not active_np[slot]:
                del self.line_slot_of[lid]
                self.free_line_slots.append(slot)
        rows, vals, new_slots = [], [], []
        for lid, ob in line_obs.items():
            slot = self.line_slot_of.get(lid)
            if slot is None:
                if not self.free_line_slots:
                    continue
                slot = self.free_line_slots.pop()
                self.line_slot_of[lid] = slot
                new_slots.append(slot)
            rows.append(slot)
            vals.append(np.asarray(ob, np.float64)[:4])
        if not rows:
            return
        rows_t = self._upload(np.asarray(rows, np.int64), torch.int64)
        obs, obs_valid = ln.obs.clone(), ln.obs_valid.clone()
        obs[rows_t, slot_frame] = self._upload(np.stack(vals))
        obs_valid[rows_t, slot_frame] = True
        if new_slots:
            na = self._upload(np.asarray(new_slots, np.int64), torch.int64)
            # only this frame's column may be valid for a fresh slot
            keep_col = torch.zeros(self.f, dtype=torch.bool, device=self.device)
            keep_col[slot_frame] = True
            obs_valid[na] = obs_valid[na] & keep_col[None, :]
            active, solve_ok, start_frame, orth = (
                t.clone() for t in (ln.active, ln.solve_ok, ln.start_frame, ln.orth))
            active[na] = True
            solve_ok[na] = False
            start_frame[na] = slot_frame
            orth[na] = 0.0
            ln = ln._replace(active=active, solve_ok=solve_ok, start_frame=start_frame, orth=orth)
        self.core = self.core._replace(lines=ln._replace(obs=obs, obs_valid=obs_valid))

    def _keyframe_decision(self, feats: dict[int, FrameFeature], ov, active, obs_xy) -> bool:
        """Parallax / track-count keyframe gate
        (``FeatureManager::addFeatureCheckParallax``, feature_manager.cpp:57-116).

        Keyframe when track continuity is weak — fewer than 20 tracked
        features, fewer than 40 long (≥4-observation) tracks, or more than
        half the frame is new — or when the mean parallax between the
        SECOND- and THIRD-last frames (the incoming frame is frame_count;
        parallax is measured at frame_count−1 vs frame_count−2,
        ``compensatedParallax2``, feature_manager.cpp:978-1012) reaches
        MIN_PARALLAX. Note this fork ships compensatedParallax2 with the
        rotation compensation commented out (``p_i_comp = p_i``,
        feature_manager.cpp:998) — plain parallax is the faithful parity."""
        tracked = [fid for fid in feats if fid in self._prev_feats]
        last_track_num = len(tracked)
        new_feature_num = len(feats) - last_track_num
        if last_track_num < 20 or new_feature_num > 0.5 * last_track_num:
            return True

        obs_counts = ov.sum(axis=1)
        # long tracks: the incoming observation brings them to ≥4
        long_track_num = sum(
            1 for fid in tracked
            if (s := self.slot_of.get(fid)) is not None and obs_counts[s] >= 3
        )
        if long_track_num < 40:
            return True

        # mean parallax between the second- and third-last window frames
        i, j = self.f - 3, self.f - 2
        both = ov[:, i] & ov[:, j] & active
        if not both.any():
            return True
        d = obs_xy[both, i] - obs_xy[both, j]
        par = float(np.hypot(d[:, 0], d[:, 1]).mean())
        min_parallax = self.cfg.solver.keyframe_parallax_px / self.cfg.solver.focal
        return par >= min_parallax

    # ------------------------------------------------------------- frame push

    def input_frame(self, t: float, feats: dict[int, FrameFeature],
                    line_obs: Optional[dict[int, np.ndarray]] = None) -> Optional[np.ndarray]:
        """Process one synchronized camera frame's features. ``line_obs``
        maps line id → normalized-plane endpoints [x1, y1, x2, y2] (the
        ``trackImagewithline`` payload, estimator.cpp:275-322; ignored
        unless ``use_line``). Returns the newest optimized pose [7] once the
        estimator is running (in burst mode: when a flush ran, else None)."""
        if self._burst_chunk and self.solver_flag == self.NON_LINEAR:
            if not self._gnss_interactive():
                # staged: the keyframe gate and the slot allocation read the
                # host mirrors; no device read on this frame
                if not self._burst_xs and not self._mirror_synced:
                    self._sync_mirror()
                is_keyframe = self._keyframe_decision(
                    feats, self._mirror_obs_valid, self._mirror_active, self._mirror_obs_xy)
                self._prev_feats = feats
                return self._stage_burst_frame(t, feats, is_keyframe, line_obs)
            # host-interactive GNSS work this frame (epoch attachment / VI
            # alignment): flush the staged chunk and take the per-frame path;
            # staging resumes with the next frame
            self.flush_burst()
            self._mirror_synced = False
        ov, active, obs_xy, line_active = self._fetch_track_masks()
        is_keyframe = self._keyframe_decision(feats, ov, active, obs_xy)
        self._prev_feats = feats
        lines = (line_obs, line_active)

        if self.solver_flag == self.INITIAL:
            return self._fill_or_init(t, feats, active, lines)
        return self._nonlinear_frame(t, feats, is_keyframe, active, lines)

    def _gnss_interactive(self) -> bool:
        """True when this frame has GNSS work for the host: an epoch to
        attach or a VI alignment still to try."""
        return self.gnss is not None and (self._pending_gnss is not None
                                          or not self.gnss_aligned)

    # --------------------------------------------------------- burst replay

    def enable_burst(self, chunk: int = 16) -> None:
        """Replay mode: once NON_LINEAR, stage ``chunk`` frames and solve them
        in one flush (``make_window_burst_ingest``: the ingest and the window
        step K times on the device, with no read in between), one upload of
        the inputs and one packed fetch of the results.

        Host slot allocation (points and line landmarks) runs against NumPy
        mirrors of the padded tables (no per-frame device read); the mirrors
        are optimistic — device-side deactivations (depth-shift failures,
        MCC/line outliers) are reconciled at every flush, so a dead slot's
        recycling can lag by at most one chunk. With tight GNSS the chunk
        flushes whenever host-interactive work is pending (epoch attachment,
        VI alignment) and that frame runs per frame. Failure detection runs
        per frame inside the chunk (the step's failure flag, stacked): a
        failure mid-chunk truncates the chunk's outputs at the failing frame
        and reboots. Call :meth:`flush_burst` before reading ``core`` or
        ``trajectory``; ``GroundFusionSystem.finish`` does."""
        from .estimator.step import make_window_burst_ingest

        self._burst_chunk = int(chunk)
        self._burst_fn, _ = make_window_burst_ingest(self.cfg, self.device)
        self._burst_xs = []
        self._burst_meta = []
        self._burst_flushed_sizes = []
        self._mirror_synced = False

    def enable_live(self) -> None:
        """Live/latency mode: each frame is one ingest-and-step on the device
        (the burst with a chunk of 1) and one packed fetch (odometry, failure
        flag and the post-step mirror tables). The keyframe gate, the slot
        allocation, prediction seeding and the speed gate are served from the
        host mirrors, so no other device read exists on the frame path."""
        self.enable_burst(1)

    def _mirror_tensors(self, core) -> list:
        tr = core.tracks
        out = [tr.obs_valid, tr.active, tr.obs[..., 0:2]]
        if self.cfg.use_line and core.lines is not None:
            out += [core.lines.obs_valid, core.lines.active]
        return out

    def _fetch(self, parts: list) -> list:
        """ONE device→host copy of several tensors (packed in the state's
        dtype, which holds the masks and the observations exactly), split
        back into numpy arrays of their shapes; boolean tensors come back
        boolean."""
        flat = torch.cat([p.reshape(-1).to(self.dtype) for p in parts]).cpu().numpy()
        out, off = [], 0
        for p in parts:
            a = flat[off : off + p.numel()].reshape(tuple(p.shape))
            off += p.numel()
            out.append(a > 0.5 if p.dtype == torch.bool else a.astype(np.float64))
        return out

    def _set_mirrors(self, arrays: list) -> None:
        self._mirror_obs_valid, self._mirror_active, self._mirror_obs_xy = arrays[0:3]
        if self.cfg.use_line and self.core.lines is not None:
            self._mirror_line_obs_valid, self._mirror_line_active = arrays[3:5]
        self._mirror_synced = True

    def _sync_mirror(self) -> None:
        """Refresh the host mirrors from the device tables (one fetch)."""
        self._set_mirrors(self._fetch(self._mirror_tensors(self.core)))

    def _assign_mirror(self, items, slot_of: dict, free: list, active: np.ndarray,
                       obs_valid: np.ndarray, n_slots: int, width: int, obs_xy=None):
        """Mirror-side twin of :meth:`_assign_slots` for the landmark table
        and of :meth:`_assign_line_slots` for the line table: allocate and
        recycle slots against the table's NumPy mirrors (``active``,
        ``obs_valid`` and, for points, ``obs_xy``, updated in place) for the
        ``(id, row)`` pairs of ``items``, and return the padded write-set for
        the on-device ingest. ``rows`` is a permutation of all slot indices
        (written slots first), so every device write is collision-free."""
        sf = self.f - 1
        for key, slot in list(slot_of.items()):
            if not active[slot]:
                del slot_of[key]
                free.append(slot)

        written, vals, news = [], [], []
        for key, row in items:
            slot = slot_of.get(key)
            if slot is None:
                if not free:
                    continue  # table full — drop, as the per-frame path does
                slot = free.pop()
                slot_of[key] = slot
                active[slot] = True
                obs_valid[slot, :] = False
                news.append(True)
            else:
                news.append(False)
            written.append(slot)
            vals.append(row)
            obs_valid[slot, sf] = True
            if obs_xy is not None:
                obs_xy[slot, sf] = row[0:2]
        n = len(written)
        rows = np.empty(n_slots, np.int64)
        rows[:n] = written
        rows[n:] = sorted(set(range(n_slots)) - set(written))
        v = np.zeros((n_slots, width), np.float64)
        if n:
            v[:n] = np.asarray(vals, np.float64)
        wmask = np.zeros(n_slots, bool)
        wmask[:n] = True
        nmask = np.zeros(n_slots, bool)
        nmask[:n] = news
        return rows, v, wmask, nmask

    def _mirror_valids(self):
        out = [self._mirror_obs_valid]
        if self.cfg.use_line:
            out.append(self._mirror_line_obs_valid)
        return out

    def _stage_burst_frame(self, t, feats, is_keyframe, line_obs) -> Optional[np.ndarray]:
        f = self.f
        iv, wv = self._drain_interval(t)
        self.ts.append(t)
        if len(self.ts) > f:
            self.ts.pop(0)
        rows, vals, wmask, nmask = self._assign_mirror(
            ((fid, [ft.x, ft.y, ft.vx, ft.vy, ft.depth]) for fid, ft in feats.items()),
            self.slot_of, self.free_slots, self._mirror_active, self._mirror_obs_valid,
            self.cfg.solver.max_landmarks, 5, self._mirror_obs_xy)
        fr = dict(
            i_dts=iv[0], i_acc=iv[1], i_gyr=iv[2], i_valid=iv[3], i_acc0=iv[4], i_gyr0=iv[5],
            w_dts=wv[0], w_vel=wv[1], w_gyr=wv[2], w_valid=wv[3], w_vel0=wv[4], w_gyr0=wv[5],
            rows=rows, vals=vals, wmask=wmask, nmask=nmask,
        )
        if self.cfg.use_line:
            lr, lv, lw, ln = self._assign_mirror(
                ((lid, np.asarray(ob, np.float64)[:4]) for lid, ob in (line_obs or {}).items()),
                self.line_slot_of, self.free_line_slots, self._mirror_line_active,
                self._mirror_line_obs_valid, self.cfg.lines.max_lines, 4)
            fr.update(l_rows=lr, l_vals=lv, l_wmask=lw, l_nmask=ln)
        if self.gnss is not None:
            frame_dts = np.diff(np.asarray(self.ts, np.float64), prepend=self.ts[0])
            fr.update(gnss_ready=np.asarray(self.gnss_aligned), frame_dts=frame_dts[:f])
        self._burst_xs.append(fr)
        self._burst_meta.append((t, bool(is_keyframe)))
        # slide bookkeeping (mirror + timestamps), as _run_step's tail
        if not is_keyframe:
            self.ts = self.ts[: f - 2] + [self.ts[f - 1]]
            for ov in self._mirror_valids():
                ov[:, f - 2] = ov[:, f - 1]
                ov[:, f - 1] = False
            self._mirror_obs_xy[:, f - 2] = self._mirror_obs_xy[:, f - 1]
        else:
            self.ts = self.ts[1:]
            self._mirror_obs_valid = np.roll(self._mirror_obs_valid, -1, axis=1)
            self._mirror_obs_valid[:, -1] = False
            self._mirror_obs_xy = np.roll(self._mirror_obs_xy, -1, axis=1)
            if self.cfg.use_line:
                self._mirror_line_obs_valid = np.roll(self._mirror_line_obs_valid, -1, axis=1)
                self._mirror_line_obs_valid[:, -1] = False
        self._mirror_active &= self._mirror_obs_valid.any(axis=1)
        if self.cfg.use_line:
            self._mirror_line_active &= self._mirror_line_obs_valid.any(axis=1)
        if len(self._burst_xs) >= self._burst_chunk:
            return self.flush_burst()
        return None

    def _upload_staged(self) -> dict:
        """The staged frames' inputs, stacked on a leading axis K, in ONE
        host→device copy per dtype family (:func:`make_packed_codec`: floats
        in the state's dtype, masks, slot indices); the keyframe decisions
        stay on the host."""
        host = {}
        for name in self._burst_xs[0]:
            a = torch.from_numpy(np.stack([np.asarray(fr[name]) for fr in self._burst_xs]))
            host[name] = a.to(self.dtype) if a.is_floating_point() else a
        pack, unpack = make_packed_codec(host)
        out = unpack([self._upload(blob, blob.dtype) for blob in pack(host)])
        out["marg_old"] = np.asarray([kf for _, kf in self._burst_meta], bool)
        return out

    def flush_burst(self) -> Optional[np.ndarray]:
        """Run every staged frame on the device (one upload of the inputs, K
        ingest-and-step iterations), record their per-frame odometry from ONE
        packed fetch, reconcile the mirrors from the same fetch and run the
        per-frame failure check. Returns the newest optimized pose."""
        if not self._burst_xs:
            return None
        k_staged = len(self._burst_meta)
        core_new, outs, mirrors = self._burst_fn(self.core, self._upload_staged())
        self.core = core_new
        self._burst_flushed_sizes.append(k_staged)
        parts = [outs["pose"], outs["sb"], outs["failed"]]
        if self.gnss is not None:
            parts.append(core_new.state.anc_ecef)
        fetched = self._fetch(parts + list(mirrors))
        poses, sbs, failed = fetched[0:3]
        # failure detection per frame INSIDE the chunk: on a mid-chunk
        # explosion keep only the frames solved before it and reboot (the
        # reference checks every frame, estimator.cpp:1140-1148)
        k_fail = int(np.argmax(failed)) if failed.any() else k_staged
        for k, (t, kf) in enumerate(self._burst_meta[:k_fail]):
            self.trajectory.append((t, poses[k]))
            self.keyframe_flags.append(kf)
        self._burst_xs = []
        self._burst_meta = []
        self._fp = None
        if k_fail < k_staged:
            self.reboot()
            return None
        # seed fastPredict and the speed gate from the fetched outputs
        self._last_sb = sbs[-1]
        self._fp_seed = (poses[-1], self._last_sb)
        self._last_out_failed = False
        if self.gnss is not None:
            self._anc_delta = fetched[3]
        self._set_mirrors(fetched[len(parts):])
        return poses[-1]

    def _fill_or_init(self, t, feats, active_np, lines):
        f = self.f
        k = self.frame_count
        iv, wv = self._drain_interval(t)
        self.ts.append(t)
        self._write_interval(min(k, f - 1), iv, wv)
        self._assign_slots(feats, min(k, f - 1), active_np)
        self._assign_line_slots(lines[0], min(k, f - 1), lines[1])

        # wheel dead-reckoned pose prediction during fill (initFramePoseByOdom
        # analog, feature_manager.cpp:407-545)
        if k > 0 and self.cfg.wheel.enabled:
            self._predict_pose_from_wheel(min(k, f - 1))
        self.frame_count += 1
        if self.frame_count == f:
            ok = self._initialize()
            if ok:
                self.solver_flag = self.NON_LINEAR
                # init already placed every pose — don't re-propagate F-1
                return self._run_step(marg_old=True, propagate_newest=False)
            else:
                # drop the oldest frame and keep filling (reference slides the
                # init window, estimator.cpp:1092-1105)
                self._slide_fill_window()
        return None

    def _noise(self):
        cfg = self.cfg
        n18 = noise_cov(cfg.imu.acc_n, cfg.imu.gyr_n, cfg.imu.acc_w, cfg.imu.gyr_w, **self._kw())
        n12 = wheel_noise_cov(cfg.wheel.vel_n, cfg.wheel.gyr_n, **self._kw())
        return n18, n12

    def _predict_pose_from_wheel(self, slot: int):
        """Compose previous pose with the wheel preintegration delta
        (T^w_bj = T^w_bi · T_io · ΔT_o · T_io⁻¹)."""
        _, n12 = self._noise()
        st = self.core.state
        wb = self.core.wheel_buf
        one = type(wb)(*[a[slot : slot + 1] for a in wb])
        wpre = preintegrate_wheel_window(one, st.s_wheel, st.td_wheel, n12)
        ex = st.ex_wheel
        delta_o = make_pose(wpre.delta_p[0], wpre.delta_q[0])
        T_prev = st.poses[slot - 1]
        T_new = pose_compose(pose_compose(pose_compose(T_prev, ex), delta_o), pose_inverse(ex))
        poses = st.poses.clone()
        poses[slot] = T_new
        self.core = self.core._replace(state=st._replace(poses=poses))

    def _slide_fill_window(self):
        st = self.core.state
        self.core = self.core._replace(
            state=slide_old_state(st),
            tracks=slide_old_tracks(st, self.core.tracks),
            imu_buf=slide_old_imu_buffer(self.core.imu_buf),
            wheel_buf=slide_old_wheel_buffer(self.core.wheel_buf),
            lines=(slide_old_lines(st, self.core.lines)
                   if self.core.lines is not None else None),
        )
        self.ts.pop(0)
        self.frame_count -= 1

    # ---------------------------------------------------------------- init

    def _imu_stats(self):
        samples = [s for interval in self.all_imu_window for s in interval]
        if not samples:
            return None
        accs = np.stack([s[1] for s in samples])
        gyrs = np.stack([s[2] for s in samples])
        return accs.mean(0), gyrs.mean(0), accs.var(0).sum(), gyrs.mean(0)

    def _initialize(self) -> bool:
        """3-mode dispatch (``Estimator::initialStructure``,
        estimator.cpp:1557-1847): stationary → bias-only; excited + wheel →
        gyro-bias solve + wheel linear alignment + gravity alignment; else →
        visual SfM + PnP + VisualIMUAlignment (path C,
        estimator.cpp:1712-1847, dispatch initial_aligment.cpp:640-653)."""
        cfg = self.cfg
        stats = self._imu_stats()
        if stats is None:
            return False
        acc_mean, gyr_mean, acc_var, _ = stats
        st = self.core.state

        if acc_var < cfg.init.stationary_acc_var:
            ba, bg, R0 = stationary_bias_init(
                self._upload(acc_mean), self._upload(gyr_mean), cfg.imu.g_norm)
            # g2r(acc_mean) is the yaw-free world-from-body rotation
            pose0 = torch.cat([torch.zeros(3, **self._kw()), mat_to_quat(R0)])
            poses = pose0.repeat(self.f, 1)
            sbs = torch.cat([torch.zeros(self.f, 3, **self._kw()),
                             ba.repeat(self.f, 1), bg.repeat(self.f, 1)], dim=1)
            self.core = self.core._replace(state=st._replace(poses=poses, sbs=sbs))
            return True

        # dynamic / wheel-activation path (path B, estimator.cpp:1645-1682):
        # gyro bias from wheel-predicted rotations + wheel linear alignment.
        # On failure (or without a wheel) the reference falls through to the
        # visual path, its general initializer.
        n18, _ = self._noise()
        imu_pre = preintegrate_imu_window(self.core.imu_buf, st.sbs, n18)
        if cfg.wheel.enabled and self._wheel_excitation_init(st, imu_pre):
            return True
        return self._visual_initialize(imu_pre)

    def _wheel_excitation_init(self, st, imu_pre) -> bool:
        """Wheel-activation init (path B): gyro bias from the wheel-predicted
        window rotations, wheel-aided linear alignment, gravity alignment."""
        cfg = self.cfg
        n18, n12 = self._noise()
        valid = torch.arange(self.f, device=self.device) >= 1
        dbg = solve_gyroscope_bias(st.poses[:, 3:7], imu_pre, valid)
        st = st._replace(sbs=torch.cat([st.sbs[:, 0:6], st.sbs[:, 6:9] + dbg], dim=1))

        # re-preintegrate at corrected bias and run the wheel linear alignment
        imu_pre = preintegrate_imu_window(self.core.imu_buf, st.sbs, n18)
        wheel_pre = preintegrate_wheel_window(self.core.wheel_buf, st.s_wheel, st.td_wheel, n12)
        Rs = quat_to_mat(st.poses[:, 3:7])
        Ts = st.poses[:, 0:3]
        tic = st.ex_cam[0:3]
        tio = st.ex_wheel[0:3]
        rio = quat_to_mat(st.ex_wheel[3:7])
        ok, g_est, vels_body, s = linear_alignment_wheel(
            Rs, Ts, imu_pre, wheel_pre, tic, tio, rio, cfg.imu.g_norm
        )
        if not bool(ok):
            return False
        st = align_window_to_gravity(st, g_est, vels_body, cfg.imu.g_norm)

        if cfg.solver.calibrate_extrinsic:
            # ESTIMATE_EXTRINSIC=2: bootstrap ric by hand-eye calibration from
            # adjacent-pair essential rotations vs IMU delta rotations
            # (CalibrationExRotation call site estimator.cpp:905-925)
            ric, cal_ok = self._hand_eye_bootstrap(imu_pre)
            if bool(cal_ok):
                st = st._replace(ex_cam=torch.cat([st.ex_cam[0:3], mat_to_quat(ric)]))
        self.core = self.core._replace(state=st)
        return True

    def draw_ransac_noise(self, n: int, generator: torch.Generator) -> torch.Tensor:
        """The Gumbel draws that pick the relative-pose RANSAC's 8-point sets,
        [32, n] in the tracks' dtype, from ``generator`` (tests replace this
        method with the JAX package's draws)."""
        return gumbel_noise(N_HYPOTHESES, n, generator, self.dtype, self.device)

    def _generator(self, seed: int) -> torch.Generator:
        gen = torch.Generator(device=self.device)
        gen.manual_seed(seed)
        return gen

    def _visual_initialize(self, imu_pre) -> bool:
        """Visual-SfM initialization (path C — the reference's general mode,
        ``estimator.cpp:1712-1847``): global SfM over the window
        (relativePose → GlobalSFM.construct → PnP every frame), gyro bias
        from SfM rotations, then the VisualIMUAlignment linear system picked
        by sensor availability (initial_aligment.cpp:640-653: WD | Wheel |
        Depth | mono) and gravity alignment (visualInitialAlign,
        estimator.cpp:1849-1926). The RANSAC draw comes from a generator
        seeded with the number of window frames.

        Divergence (kept from the JAX package): the fork re-installs the
        stationary accel-bias formula after a successful visual init
        (estimator.cpp:1826-1837) — skipped, since ``aver_g`` mixes true
        acceleration into the bias when the platform is moving (upstream
        VINS-Mono does not do this either)."""
        cfg = self.cfg
        st = self.core.state
        tr = self.core.tracks
        use_depth = bool(cfg.use_depth) and bool((tr.obs[..., 4] > 0.1).any())
        noise = self.draw_ransac_noise(tr.obs.shape[0], self._generator(len(self.ts)))
        poses_cam, ok = sfm_construct(tr, noise, use_depth=use_depth)
        if not ok:
            return False
        poses_cam = poses_cam.to(self.dtype)
        ric = quat_to_mat(st.ex_cam[3:7])
        tic = st.ex_cam[0:3]
        # body rotation from SfM camera rotation: R_w_b = R_w_c · RICᵀ
        # (estimator.cpp:1758 frame.R = Q[i] · RIC[0].transpose())
        R_body = quat_to_mat(poses_cam[:, 3:7]) @ ric.T
        q_body = mat_to_quat(R_body)
        Ts = poses_cam[:, 0:3]                 # SfM camera centers

        # gyro bias from the SfM rotations, then re-preintegrate
        n18, n12 = self._noise()
        valid = torch.arange(self.f, device=self.device) >= 1
        dbg = solve_gyroscope_bias(q_body, imu_pre, valid)
        st = st._replace(sbs=torch.cat([st.sbs[:, 0:6], st.sbs[:, 6:9] + dbg], dim=1))
        imu_pre = preintegrate_imu_window(self.core.imu_buf, st.sbs, n18)

        if cfg.wheel.enabled:
            wheel_pre = preintegrate_wheel_window(
                self.core.wheel_buf, st.s_wheel, st.td_wheel, n12)
            tio = st.ex_wheel[0:3]
            rio = quat_to_mat(st.ex_wheel[3:7])
            align = linear_alignment_wd if use_depth else linear_alignment_wheel
            ok, g_est, vels_body, s = align(R_body, Ts, imu_pre, wheel_pre, tic, tio, rio,
                                            cfg.imu.g_norm)
        else:
            align = linear_alignment_depth if use_depth else linear_alignment_mono
            ok, g_est, vels_body, s = align(R_body, Ts, imu_pre, tic, cfg.imu.g_norm)
        if not bool(ok):
            return False

        # camera centers → body origins at the recovered scale, re-zeroed at
        # frame 0 (visualInitialAlign: Ps[i] = s·Pi − Ri·TIC − (s·P0 − R0·TIC))
        Ps = s * Ts - R_body @ tic
        Ps = Ps - Ps[0]
        st = st._replace(poses=torch.cat([Ps, q_body], dim=-1))
        st = align_window_to_gravity(st, g_est, vels_body, cfg.imu.g_norm)
        self.core = self.core._replace(state=st)
        return True

    def _hand_eye_bootstrap(self, imu_pre):
        """Relative camera rotations (essential-matrix RANSAC on each adjacent
        frame pair of the window's tracks, draws from a generator seeded 0)
        + IMU preintegrated delta rotations → ``calibrate_extrinsic_rotation``
        (initial_ex_rotation.cpp:22-79). Returns (ric, ok), or (None, False)
        with fewer than 3 usable pairs."""
        tr = self.core.tracks
        ml = tr.obs.shape[0]
        ov = tr.obs_valid & tr.active[:, None]
        n_both = (ov[:, :-1] & ov[:, 1:]).sum(dim=0).cpu().numpy()     # one fetch
        gen = self._generator(0)
        q_cam, q_imu = [], []
        for k in range(self.f - 1):
            if n_both[k] < 12:
                continue
            both = ov[:, k] & ov[:, k + 1]
            pose_rel, _, ok = relative_pose_ransac(tr.obs[:, k, 0:2], tr.obs[:, k + 1, 0:2], both,
                                                   self.draw_ransac_noise(ml, gen))
            if not bool(ok):
                continue
            q_cam.append(pose_rel[3:7])          # q_ci_cj, matches delta_q q_bi_bj
            q_imu.append(imu_pre.delta_q[k + 1])
        if len(q_cam) < 3:
            return None, False
        return calibrate_extrinsic_rotation(
            torch.stack(q_cam), torch.stack(q_imu),
            torch.ones(len(q_cam), dtype=torch.bool, device=self.device))

    # ------------------------------------------------------------- solve step

    def _nonlinear_frame(self, t, feats, is_keyframe, active_np, lines):
        f = self.f
        iv, wv = self._drain_interval(t)
        self.ts.append(t)
        if len(self.ts) > f:
            self.ts.pop(0)
        self._write_interval(f - 1, iv, wv)
        self._assign_slots(feats, f - 1, active_np)
        self._assign_line_slots(lines[0], f - 1, lines[1])
        out = self._run_step(marg_old=is_keyframe, propagate_newest=True)
        self._check_failure()
        return out

    def _check_failure(self):
        """failureDetection → clearState reboot (estimator.cpp:1140-1148,
        2847-2888): exploding bias norms restart the estimator from the
        initialization phase, keeping the sensor queues."""
        failed = self._last_out_failed
        if failed is None:
            failed = failure_detection(self.core.state.sbs.cpu().numpy(),
                                       ba_thresh=self.cfg.solver.fail_ba_thresh,
                                       bg_thresh=self.cfg.solver.fail_bg_thresh)
        if failed:
            self.reboot()

    def reboot(self):
        """clearState + setParameter equivalent: reset window state, tracks,
        prior and mode; sensor queues and tracker ids survive (the reference
        keeps subscriptions alive and re-enters INITIAL; the GNSS ingest
        keeps its anchor, track counts and epochs)."""
        self.core = self._empty_core()
        self.solver_flag = self.INITIAL
        self.frame_count = 0
        self.ts = []
        self.slot_of = {}
        self.free_slots = list(range(self.cfg.solver.max_landmarks))
        self.line_slot_of = {}
        self.free_line_slots = list(range(self.cfg.lines.max_lines)) if self.cfg.use_line else []
        self.all_imu_window = []
        self._fp_seed = None
        self._last_sb = None
        self._last_out_failed = None
        self.gnss_aligned = False
        self.gnss_aligned_at = None
        self._first_gnss_opt = True   # estimator.cpp:152
        self._gnss_pre_epochs = []
        self._anc_delta = np.zeros(3)
        self._burst_xs, self._burst_meta = [], []
        self._mirror_synced = False
        self.reboots += 1

    # -------------------------------------------------------- checkpointing

    def save_state(self, path: str) -> None:
        """Snapshot the estimator: the device core and the host bookkeeping
        (slot maps, window timestamps, mode, trajectory, GNSS anchor and
        track counts) in the JAX package's archive format, so that a later
        process resumes mid-sequence instead of re-initializing. In burst
        mode, :meth:`flush_burst` first (``GroundFusionSystem`` does)."""
        from .utils.checkpoint import core_to_arrays

        if self._burst_xs:
            raise RuntimeError(f"save_state: {len(self._burst_xs)} staged burst frames "
                               "are not flushed; call flush_burst() first")
        out = core_to_arrays(self.core, "core.")
        out.update(
            solver_flag=np.int64(self.solver_flag),
            frame_count=np.int64(self.frame_count),
            ts=np.asarray(self.ts, np.float64),
            slot_keys=np.asarray(list(self.slot_of.keys()), np.int64),
            slot_vals=np.asarray(list(self.slot_of.values()), np.int64),
            free_slots=np.asarray(self.free_slots, np.int64),
            line_slot_keys=np.asarray(list(self.line_slot_of.keys()), np.int64),
            line_slot_vals=np.asarray(list(self.line_slot_of.values()), np.int64),
            free_line_slots=np.asarray(self.free_line_slots, np.int64),
            gnss_aligned=np.bool_(self.gnss_aligned),
            traj_t=np.asarray([t for t, _ in self.trajectory], np.float64),
            traj_p=(np.stack([np.asarray(p, np.float64) for _, p in self.trajectory])
                    if self.trajectory else np.zeros((0, 7))),
            keyframe_flags=np.asarray(self.keyframe_flags, bool),
        )
        if self.gnss is not None:
            if self.gnss.anc0 is not None:
                out["gnss_anc0"] = np.asarray(self.gnss.anc0, np.float64)
            out["gnss_track_keys"] = np.asarray(list(self.gnss.track_count.keys()), np.int64)
            out["gnss_track_vals"] = np.asarray(list(self.gnss.track_count.values()), np.int64)
        np.savez_compressed(path, **out)

    def load_state(self, path: str) -> None:
        """Restore a :meth:`save_state` snapshot (of either package). The
        core takes this estimator's dtypes and device; the config must match
        the one that saved (same table shapes, same enabled blocks). The
        previous frame's features, the IMU-rate prediction, the staged burst
        and the host mirrors are not persisted and start empty, so the first
        frame after a resume is a keyframe."""
        from .utils.checkpoint import core_from_arrays

        with np.load(path, allow_pickle=False) as archive:
            data = {k: archive[k] for k in archive.files}
        self.core = core_from_arrays(data, self.core, "core.")
        self.solver_flag = int(data["solver_flag"])
        self.frame_count = int(data["frame_count"])
        self.ts = [float(t) for t in data["ts"]]
        self.slot_of = {int(k): int(v) for k, v in zip(data["slot_keys"], data["slot_vals"])}
        self.free_slots = [int(s) for s in data["free_slots"]]
        self.line_slot_of = {int(k): int(v) for k, v in
                             zip(data["line_slot_keys"], data["line_slot_vals"])}
        self.free_line_slots = [int(s) for s in data["free_line_slots"]]
        self.gnss_aligned = bool(data["gnss_aligned"])
        self.trajectory = [(float(t), np.array(p, np.float64))
                           for t, p in zip(data["traj_t"], data["traj_p"])]
        self.keyframe_flags = [bool(b) for b in data["keyframe_flags"]]
        if self.gnss is not None:
            if "gnss_anc0" in data:
                self.gnss.set_anchor(data["gnss_anc0"])
            if "gnss_track_keys" in data:
                self.gnss.track_count = {int(k): int(v) for k, v in
                                         zip(data["gnss_track_keys"], data["gnss_track_vals"])}
            self._anc_delta = self.core.state.anc_ecef.cpu().numpy().astype(np.float64)
        self._prev_feats = {}
        self._fp = None
        self._fp_seed = None
        self._last_sb = None
        self._last_out_failed = None
        self._burst_xs, self._burst_meta = [], []
        self._mirror_synced = False

    # ------------------------------------------------------------------ GNSS

    def anchor_ecef(self) -> Optional[np.ndarray]:
        """Absolute ECEF anchor (float64 expansion anchor + the state's
        ENU delta column), or None before GNSS-VI alignment."""
        if self.gnss is None or self.gnss.anc0 is None:
            return None
        return self.gnss.anchor_ecef(self.core.state.anc_ecef.cpu().numpy())

    def _attach_gnss_epoch(self):
        """Gate + store the pending epoch into the window table at its
        bracketing-frame slot. The reference interpolates the state between
        the two frames that straddle the epoch time (``estimator.cpp:
        3193-3207``: lower_idx from Headers vs obs time, ts_ratio =
        (upper−obs)/(upper−lower)); slot k of the table is defined as
        "bracketed by frames k and k+1", so the epoch lands at the lower
        frame with its true interpolation ratio."""
        if self.gnss is None or self._pending_gnss is None:
            return
        t_obs, obs_list = self._pending_gnss
        anc_abs = self.gnss.anchor_ecef(self._anc_delta) if self.gnss_aligned else None
        obs = self.gnss.process_epoch(obs_list, self.gnss_aligned, anc_abs)
        self._pending_gnss = None
        if not obs or self.core.gnss_obs is None or len(self.ts) < 2:
            return
        if not self.gnss_aligned:
            # no expansion anchor yet: keep the raw (float64) epoch on the
            # host and install it into the window table at alignment
            # (_install_window_epochs) — the factors are gnss_ready-gated
            # until then anyway
            self._gnss_pre_epochs.append((float(t_obs), obs))
            return
        self._write_gnss_slot(float(t_obs), obs, anc_abs)

    def _write_gnss_slot(self, t_obs: float, obs: list, anc_abs) -> None:
        """Reduce one epoch on the host and write it into window slot
        ``lower``: the slot's fields are packed side by side into one array,
        uploaded in one copy, and index-copied into each field."""
        ts = np.asarray(self.ts, np.float64)
        lower = int(np.searchsorted(ts, t_obs, side="right") - 1)
        lower = max(0, min(lower, len(ts) - 2, self.f - 2))
        denom = max(float(ts[lower + 1] - ts[lower]), 1e-9)
        ratio = float(np.clip((ts[lower + 1] - t_obs) / denom, 0.0, 1.0))
        for o in obs:
            o["ratio"] = ratio
        slot = self.gnss.build_slot(obs, anc_abs)
        s = len(slot["valid"])
        packed = np.concatenate(
            [np.asarray(slot[k], np.float64).reshape(s, 3) for k in SLOT_VECTORS]
            + [np.stack([slot[k] for k in SLOT_SCALARS + ("sys", "valid")], axis=1)
               .astype(np.float64)], axis=1)
        dev = self._upload(packed)                          # [S, 20], one copy
        idx = torch.tensor([lower], device=self.device)
        g = self.core.gnss_obs
        parts = dict(zip(SLOT_VECTORS, dev[:, 0:12].reshape(s, 4, 3).unbind(1)))
        parts.update(zip(SLOT_SCALARS + ("sys", "valid"), dev[:, 12:].unbind(1)))
        parts["valid"] = parts["valid"] > 0.5
        upd = {k: getattr(g, k).index_copy(0, idx, v.to(getattr(g, k).dtype)[None])
               for k, v in parts.items()}
        self.core = self.core._replace(gnss_obs=g._replace(**upd))

    def _try_gnss_align(self):
        """GNSSVIAlign trigger (estimator.cpp:1928-2043): once NON_LINEAR
        with enough filtered epochs, run coarse SPP + yaw GN + anchor
        refinement and install the result into the state."""
        if self.gnss is None or self.gnss_aligned:
            return
        epochs = [e for e in self.gnss.epochs if len(e) >= 4]
        if len(epochs) < 5:
            return
        from .gnss.align import gnss_vi_align

        st = self.core.state
        n = min(len(self.gnss.epochs), self.f)
        win = torch.cat([st.poses[-n:, 0:3], st.sbs[-n:, 0:3]], dim=1)
        win = win.cpu().numpy().astype(np.float64)           # one fetch
        eps = self.gnss.epochs[-n:]
        anc, yaw, rcv_dt, ok = gnss_vi_align(
            win[:, 0:3], win[:, 3:6], eps, min_speed=self.cfg.gnss.low_speed_yaw_fix)
        if not ok:
            return
        # install the float64 expansion anchor; the state's anchor column is
        # the ENU DELTA from it (zero at alignment) — absolute ECEF math in
        # float32 quantizes at metres, so it never reaches the device
        # (gnss/factors.GnssObsWindow)
        self.gnss.set_anchor(anc)
        # before alignment no factor has touched the GNSS columns (clocks,
        # yaw, anchor): the prior's only hold on them is its factorization's
        # ridge (64·eps·max diag, ~1e3 in float32), which would drag the
        # values installed here back to their pre-alignment zeros. The JAX
        # package keeps that hold (ROADMAP queue 3); the reference's prior
        # has no such columns at all, and neither has the port's after this.
        lay = self.layout
        prior = self.core.prior
        J0 = torch.cat([prior.J0[:, : lay.gnss_dt], torch.zeros_like(prior.J0[:, lay.gnss_dt :])],
                       dim=1)
        self.core = self.core._replace(
            state=st._replace(
                anc_ecef=torch.zeros(3, **self._kw()),
                yaw_enu=torch.tensor(yaw, **self._kw()),
                rcv_dt=self._upload(rcv_dt).repeat(self.f, 1),
            ),
            prior=prior._replace(J0=J0),
        )
        self._anc_delta = np.zeros(3)
        self.gnss_aligned = True
        self.gnss_aligned_at = self.ts[-1]
        self._install_window_epochs(anc)

    def _install_window_epochs(self, anc) -> None:
        """Install the raw epochs received BEFORE alignment into the window
        table, reduced against the freshly-installed float64 anchor — the
        role the reference's per-factor atmosphere/weight recomputation plays
        (gnss_psr_dopp_factor.cpp:78-89): pre-alignment slots must not keep
        placeholder values. Raw float64 observations were kept on the host
        precisely so no float32-truncated pseudorange ever feeds a reduction."""
        eps = [e for e in self._gnss_pre_epochs
               if self.ts and self.ts[0] <= e[0] <= self.ts[-1] + 1e-9]
        self._gnss_pre_epochs = []
        for t_obs, obs in eps:
            self._write_gnss_slot(t_obs, obs, np.asarray(anc, np.float64))

    def _gnss_flags(self) -> dict:
        """The step's GNSS flags, from one upload: the frame intervals in
        float64 on the host, the aligned gate, the low-speed yaw freeze (the
        newest speed is the previous step's fetched sb, which IS sbs[F-1]
        after either slide) and the first-GNSS-solve anchor."""
        f = self.f
        last_sb = self._last_sb
        if last_sb is None:
            last_sb = self.core.state.sbs[f - 1].cpu().numpy().astype(np.float64)
        speed = float(np.linalg.norm(last_sb[0:3]))
        frame_dts = np.diff(np.asarray(self.ts, np.float64), prepend=self.ts[0])
        host = np.concatenate([frame_dts[:f], [float(self.gnss_aligned),
                                               float(speed < self.cfg.gnss.low_speed_yaw_fix),
                                               float(self._first_gnss_opt)]])
        dev = self._upload(host)
        return dict(frame_dts=dev[:f], gnss_ready=dev[f] > 0.5, fix_yaw_enu=dev[f + 1] > 0.5,
                    first_gnss_opt=dev[f + 2] > 0.5)

    def _run_step(self, marg_old: bool, propagate_newest: bool = False):
        f = self.f
        dev = self.device
        # anomaly/stationarity gates are computed inside the step from the
        # window buffers (estimator/gates.device_frame_gates); the flags
        # below are host OVERRIDES only
        gnss_flags = {}
        if self.gnss is not None:
            self._attach_gnss_epoch()
            self._try_gnss_align()
            gnss_flags = self._gnss_flags()
        self._first_gnss_opt = False
        interval = torch.arange(f, device=dev) >= 1
        flags = StepFlags(
            marg_old=bool(marg_old),
            stationary=torch.zeros((), dtype=torch.bool, device=dev),
            wheel_valid=interval,
            imu_valid=interval,
            td_obs=torch.zeros(f, **self._kw()),
            propagate_newest=torch.full((), bool(propagate_newest), dtype=torch.bool, device=dev),
            **gnss_flags,
        )
        core_new, out = self.step_fn(self.core, flags)
        self.core = core_new
        # ONE packed device→host fetch for everything the host needs from
        # this step (pose, speed/bias vector, failure flag); it also ends the
        # step's device work, so a host clock around this call times the step
        parts = [out["pose"], out["sb"], out["failed"]]
        if self.gnss is not None:
            parts.append(core_new.state.anc_ecef)
        got = self._fetch(parts)
        pose, self._last_sb, self._last_out_failed = got[0], got[1], bool(got[2])
        if self.gnss is not None:
            self._anc_delta = got[3]
        self._fp = None   # fastPredict re-seeds from the fresh optimized state
        self._fp_seed = (pose, self._last_sb)
        self.trajectory.append((self.ts[-1], pose))
        self.keyframe_flags.append(bool(marg_old))
        if not marg_old:
            # second-new slide dropped frame F-2's timestamp
            self.ts = self.ts[: f - 2] + [self.ts[f - 1]]
        else:
            self.ts = self.ts[1:]
        return pose

    # ---------------------------------------------------------------- output

    def write_tum(self, path: str) -> None:
        """TUM-format trajectory dump (``visualization.cpp:346-358``)."""
        with open(path, "w") as fp:
            for t, p in self.trajectory:
                # TUM: t x y z qx qy qz qw
                fp.write(
                    f"{t:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f} "
                    f"{p[4]:.6f} {p[5]:.6f} {p[6]:.6f} {p[3]:.6f}\n"
                )
