"""Full-system orchestration: tracker + estimator + loop closure.

The one-object equivalent of the reference's ROS processes (``vins_node`` +
``dense_map_node`` — SURVEY §1 L0/L5): images go through the KLT front-end,
features into the sliding-window estimator, keyframes into the BoW/pose-graph
loop closure. Everything is in-process — module-to-module calls replace ROS
pub/sub (SURVEY §2 parallelism table). The dense map, GPS fusion, lines and
the detector of the JAX package are not ported yet; a config that turns one
of them on raises at construction.

Run from a dataset directory::

    python -m ground_fusion_tpu_torch <config.yaml> <sequence_dir> [out_dir]
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .cameras.models import make_camera
from .config import Config
from .estimator.step import check_supported
from .frontend.tracker import FeatureTracker
from .geometry.se3 import pose_apply, pose_compose
from .global_layers.pose_graph import Keyframe, PoseGraph
from .pipeline import Estimator
from .utils import np_quat
from .utils.outputs import CalibrationDump, DeadReckoningPaths
from .utils.profiling import StageStats


class GroundFusionSystem:
    def __init__(self, cfg: Config, out_dir: str = "output", device=None):
        """``device=None`` means the GPU and raises when there is none."""
        check_supported(cfg)
        self.cfg = cfg
        self.out_dir = out_dir
        self.device = resolve_device(device)
        os.makedirs(out_dir, exist_ok=True)
        self.estimator = Estimator(cfg, device=self.device)

        # model dispatch by cfg.camera.model (CameraFactory.cc:32-93)
        cam = make_camera(cfg.camera.model, cfg.camera.fx, cfg.camera.fy,
                          cfg.camera.cx, cfg.camera.cy, cfg.camera.distortion,
                          device=self.device)
        self.tracker = FeatureTracker(
            cam, max_cnt=cfg.tracker.max_features,
            min_dist=int(cfg.tracker.min_dist_px),
            levels=cfg.tracker.pyramid_levels, half=cfg.tracker.patch_half,
            iters=cfg.tracker.lk_iters, device=self.device,
        )
        self.tracker.baseline = cfg.camera.baseline
        if cfg.tracker.fisheye_mask_path:
            from .io.dataset import load_mask

            self.tracker.set_fisheye_mask(load_mask(cfg.tracker.fisheye_mask_path))
        self.cam = self.tracker.cam
        # the camera's parameters as host floats, for host-side projections
        self._cam_host = type(self.cam.params)(*[p.cpu() for p in self.cam.params])

        self.pose_graph = None
        if cfg.loop.enabled:
            self.pose_graph = PoseGraph(cfg, cam_focal=cfg.camera.fx, device=self.device)
            self._kf_index = 0
            self._opt_edges = 0

        self.stats = StageStats()
        self.calib_dump = CalibrationDump(out_dir)
        self.dead_reckoning = DeadReckoningPaths()
        self._dr_ba = self._dr_bg = None
        self._dr_sw = (cfg.wheel.sx, cfg.wheel.sy, cfg.wheel.sw)
        # live telemetry registry: the in-process analog of the reference's
        # live topics (visualization.cpp:53-81). Topics: imu_propagate
        # (IMU-rate predicted odometry, pubLatestOdometry), odometry (per
        # solved frame, pubOdometry), keyframe (pubKeyframe), loop_closure (new
        # verified loop edge), path_update (post-relaxation drift broadcast).
        # Publishing is zero-cost with no subscribers.
        self._subs: dict[str, list] = {}

    # ------------------------------------------------------------- telemetry

    def subscribe(self, topic: str, fn) -> None:
        """Register a live-telemetry callback ``fn(**payload)`` — the
        embeddable analog of subscribing to the reference's ROS topics
        (``registerPub``, visualization.cpp:53-81). See ``self._subs`` doc
        for the topic set; payloads are plain NumPy/py values."""
        self._subs.setdefault(topic, []).append(fn)

    def _publish(self, topic: str, **payload) -> None:
        for fn in self._subs.get(topic, ()):
            fn(**payload)

    # --------------------------------------------------------------- sensors

    def input_imu(self, t, acc, gyr):
        self.estimator.input_imu(t, acc, gyr)
        # pure-IMU dead-reckoning diagnostic at sensor rate
        # (fastPredictPureIMU → pure_imu_propagate, estimator.cpp:4032-4076);
        # biases refresh once per solved frame (_refresh_dr_bias)
        self.dead_reckoning.push_imu(
            t, acc, gyr, ba=self._dr_ba, bg=self._dr_bg, g_norm=self.cfg.imu.g_norm)
        if "imu_propagate" in self._subs:
            # IMU-rate predicted odometry (pubLatestOdometry,
            # estimator.cpp:324-352) from the host-side fastPredict state
            od = self.estimator.latest_odometry()
            if od is not None:
                self._publish("imu_propagate", t=od[0], pose=od[1], vel=od[2])

    def input_wheel(self, t, vel, gyr):
        self.estimator.input_wheel(t, vel, gyr)
        self.dead_reckoning.push_wheel(t, vel, gyr, scales=self._dr_sw)

    def _refresh_dr_bias(self, s_wheel: np.ndarray):
        """Latest solved biases + wheel intrinsics for the dead-reckoning
        paths, from values the step's fetches already brought to the host
        (after a reboot there are none, and the fresh state is read)."""
        est = self.estimator
        sb = est._last_sb
        if sb is None:
            sb = est.core.state.sbs[est.f - 1].cpu().numpy().astype(np.float64)
        self._dr_ba, self._dr_bg = sb[3:6], sb[6:9]
        self._dr_sw = (float(s_wheel[0]), float(s_wheel[1]), float(s_wheel[2]))

    def input_image(self, t, img: np.ndarray, depth: Optional[np.ndarray] = None,
                    img_right: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
        """One synchronized camera frame end-to-end. ``img_right``: rectified
        stereo pair image (used when ``camera.baseline`` > 0 and no RGBD
        depth is supplied). The two timed stages each end in a device→host
        fetch, so their wall-clock times include their device work."""
        self._seed_tracker_predictions()
        # KLT consumes luminance
        img = np.asarray(img)
        img_gray = img.mean(axis=-1) if img.ndim == 3 else img
        with self.stats.time("track"):
            feats = self.tracker.track(t, img_gray, depth, img_right=img_right)

        with self.stats.time("solve"):
            pose = self.estimator.input_frame(t, feats)

        if pose is not None:
            s_wheel = self.calib_dump.append(t, self.estimator.core.state)
            self._refresh_dr_bias(s_wheel)
            is_kf = bool(self.estimator.keyframe_flags
                         and self.estimator.keyframe_flags[-1])
            self._publish("odometry", t=t, pose=np.asarray(pose),
                          is_keyframe=is_kf)
            if is_kf:
                self._publish("keyframe", t=t, pose=np.asarray(pose))
            if self.pose_graph is not None and is_kf:
                # loop-closure registration (the loop half of the JAX
                # package's _loop_and_map; the dense-map half waits for the
                # map's port, and cfg.map raises at construction)
                self._add_loop_keyframe(t, img, pose)
        return pose

    def _seed_tracker_predictions(self):
        """Project solved landmarks through the IMU-rate propagated pose into
        pixel predictions for the next LK solve (the reference's
        ``predictPtsInNextFrame`` → ``FeatureTracker::setPrediction`` chain,
        feature_tracker.cpp:118-133) — prediction-seeded flow survives fast
        motion where the previous-position seed diverges."""
        est = self.estimator
        od = est.latest_odometry()
        if od is None or not est.slot_of:
            return
        _, pose7, _ = od
        tr = est.core.tracks
        st = est.core.state
        ml, f = tr.obs_valid.shape
        # ONE packed device→host fetch per frame, then pure-numpy geometry
        dt = tr.obs.dtype
        packed = torch.cat([
            (tr.active & tr.solve_ok).to(dt)[:, None], tr.start_frame.to(dt)[:, None],
            tr.inv_depth[:, None], tr.obs[..., 0:2].reshape(ml, 2 * f),
        ], dim=1)
        tail = torch.cat([st.poses.reshape(-1), st.ex_cam])
        flat = torch.cat([packed.reshape(-1), tail]).cpu().numpy().astype(np.float64)
        packed = flat[: packed.numel()].reshape(ml, 3 + 2 * f)
        poses = flat[packed.size : packed.size + 7 * f].reshape(f, 7)
        ex_cam = flat[packed.size + 7 * f :]
        ok = packed[:, 0] > 0.5
        sf = np.clip(np.rint(packed[:, 1]).astype(np.int64), 0, f - 1)
        inv_d = packed[:, 2]
        obs_xy = packed[:, 3:].reshape(ml, f, 2)
        if not ok.any():
            return
        depth = 1.0 / np.maximum(inv_d, 1e-6)
        # per-frame camera poses: T_i ∘ ex_cam (host quaternions)
        t_ex, q_ex = ex_cam[0:3], ex_cam[3:7]
        cam_R = np.zeros((len(poses), 3, 3))
        cam_t = np.zeros((len(poses), 3))
        for i in range(len(poses)):
            Ri = np_quat.quat_to_mat(poses[i, 3:7])
            cam_t[i] = poses[i, 0:3] + Ri @ t_ex
            cam_R[i] = np_quat.quat_to_mat(
                np_quat.quat_normalize(np_quat.quat_mul(poses[i, 3:7], q_ex)))
        rays = np.concatenate(
            [obs_xy[np.arange(len(sf)), sf], np.ones((len(sf), 1))], axis=1)
        pts_c = rays * depth[:, None]
        pts_w = np.einsum("nij,nj->ni", cam_R[sf], pts_c) + cam_t[sf]
        R_pred = np_quat.quat_to_mat(np.asarray(pose7[3:7], float))
        Rc = R_pred @ np_quat.quat_to_mat(q_ex)
        tc = np.asarray(pose7[0:3], float) + R_pred @ t_ex
        pc = (pts_w - tc) @ Rc
        vis = ok & (pc[:, 2] > 0.1)
        if not vis.any():
            return
        # project on the host: the camera's parameters as plain floats
        px = self.cam.project(self._cam_host, torch.as_tensor(pc, dtype=torch.float32)).numpy()
        slot_to_id = {s: fid for fid, s in est.slot_of.items()}
        preds = {}
        for s in np.nonzero(vis)[0]:
            fid = slot_to_id.get(int(s))
            if fid is not None:
                preds[fid] = (float(px[s, 0]), float(px[s, 1]))
        self.tracker.set_prediction(preds)

    # ------------------------------------------------------------ keyframes

    def _add_loop_keyframe(self, t, img, pose):
        """Register the newest window frame as a pose-graph keyframe: its
        solved landmarks in the world (one batched transform on the device,
        one fetch), FAST + BRIEF of the image and of the landmarks' pixels,
        then loop detection, verification and — on a new loop edge — the
        relaxation. A keyframe that sees fewer than 8 landmarks is skipped."""
        est = self.estimator
        tr = est.core.tracks
        st = est.core.state
        # the step has already slid the window: the frame it just solved is
        # slot F-2 after either slide, and slot F-1 waits, empty, for the
        # next frame (the JAX package reads slot F-1 here, where no landmark
        # is ever observed, so its live hook registers no keyframe; ROADMAP
        # queue 3)
        newest = est.f - 2
        ml = tr.active.shape[0]
        # window landmarks in world (from anchor obs + depth), in float64
        cams = pose_compose(st.poses.double(), st.ex_cam.double()[None, :])
        anchor = tr.obs[torch.arange(ml, device=tr.obs.device), tr.start_frame, 0:2].double()
        rays = torch.cat([anchor, torch.ones_like(anchor[:, 0:1])], dim=1)
        rays = rays / torch.clamp(tr.inv_depth.double(), min=1e-6)[:, None]
        pts_w = pose_apply(cams[tr.start_frame], rays)
        seen = tr.active & tr.solve_ok & tr.obs_valid[:, newest]
        packed = torch.cat([seen.double()[:, None], pts_w, tr.obs[:, newest, 0:2].double()],
                           dim=1).cpu().numpy()
        packed = packed[packed[:, 0] > 0.5]
        if len(packed) < 8:
            return
        pts3d, norm2d = packed[:, 1:4], packed[:, 4:6]
        # normalized-plane ↔ pixel through the dispatched camera model
        # (keyframe.cpp uses the camodocal camera for both directions), on
        # the host copy of its parameters
        rays2 = np.concatenate([norm2d, np.ones((len(norm2d), 1))], -1)
        win_px = self.cam.project(self._cam_host, torch.as_tensor(rays2, dtype=torch.float32)).numpy()

        pts, okf, desc, win_desc = self.pose_graph.describe(img, win_px)
        kp_rays = self.cam.lift(self._cam_host, torch.as_tensor(pts)).numpy()
        kp_norm = kp_rays[:, 0:2] / np.maximum(np.abs(kp_rays[:, 2:3]), 1e-9)
        kf = Keyframe(
            index=self._kf_index, t=t, pose=np.asarray(pose),
            kp=np.concatenate([pts, win_px]),
            kp_norm=np.concatenate([kp_norm, norm2d]),
            desc=np.concatenate([desc, win_desc]),
            kp_ok=np.concatenate([okf, np.ones(len(win_desc), bool)]),
            win_pts3d=pts3d, win_norm=norm2d, win_desc=win_desc,
            win_ok=np.ones(len(pts3d), bool),
        )
        with self.stats.time("loop"):
            self.pose_graph.add_keyframe(kf)
            if len(self.pose_graph.loop_edges) > self._opt_edges:
                # a new verified loop edge (findConnection success)
                self._publish("loop_closure", edge=self.pose_graph.loop_edges[-1],
                              n_keyframes=len(self.pose_graph.kfs))
                self.pose_graph.optimize()
                self._opt_edges = len(self.pose_graph.loop_edges)
                # post-relaxation drift broadcast (updatePath's corrected
                # path, pose_graph.cpp:674-696)
                self._publish("path_update", r_drift=np.asarray(self.pose_graph.r_drift),
                              t_drift=np.asarray(self.pose_graph.t_drift))
        self._kf_index += 1

    # --------------------------------------------------------------- output

    def finish(self):
        est = self.estimator
        est.write_tum(os.path.join(self.out_dir, "vio.txt"))
        if self.pose_graph is not None:
            self.pose_graph.write_tum(os.path.join(self.out_dir, "loop.txt"))
        self.dead_reckoning.write_tum(
            os.path.join(self.out_dir, "pure_imu.txt"),
            os.path.join(self.out_dir, "pure_wheel.txt"),
        )
        with open(os.path.join(self.out_dir, "timing.txt"), "w") as fp:
            fp.write(self.stats.report() + "\n")
        return os.path.join(self.out_dir, "vio.txt")
