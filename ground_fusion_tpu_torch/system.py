"""Full-system orchestration: tracker + estimator + loop closure + mapping.

The one-object equivalent of the reference's ROS processes (``vins_node`` +
``dense_map_node`` + ``global_fusion_node`` + ``darknet_ros`` — SURVEY §1
L0/L5): images go through the KLT front-end, features into the
sliding-window estimator, keyframes into the BoW/pose-graph loop closure and
the dense voxel map (with its TSDF mesh), solved poses and NavSatFix fixes
into the GPS/VIO global fusion. Everything is in-process — module-to-module calls replace ROS
pub/sub (SURVEY §2 parallelism table). With ``use_line`` a line tracker
feeds segment observations to the estimator beside the point features. With
``burst_chunk`` K the estimator stages K frames per flush and the post-solve
hooks (calibration dump, loop keyframes, the map, GPS fusion, telemetry)
drain from the trajectory at each flush. ``save_checkpoint`` writes the
estimator's snapshot and the pose graph; ``load_checkpoint`` resumes from
them and from a prior occupancy grid. With ``use_yolo`` the dynamic-object
detector (:mod:`.detector.model`) runs on every frame after the tracker and
culls the features that fall inside a dynamic-class box.

Run from a dataset directory::

    python -m ground_fusion_tpu_torch <config.yaml> <sequence_dir> [out_dir] [--burst K]
        [--save-state] [--resume P] [--load-graph P] [--load-grid P]
"""

from __future__ import annotations

import os
import warnings
from typing import Optional

import numpy as np
import torch

from . import resolve_device
from .cameras.models import make_camera
from .config import Config
from .detector.model import cull_features_in_boxes, detect, init_params, load_npz
from .frontend.lines import LineTracker
from .frontend.tracker import FeatureTracker
from .geometry.se3 import pose_apply, pose_compose
from .geometry.so3 import mat_to_quat
from .global_layers.dense_map import VoxelColorMap, sample_rgbd, write_cloud_ply
from .global_layers.meshing import TsdfVolume, radius_outlier_filter
from .global_layers.pose_graph import Keyframe, PoseGraph
from .pipeline import Estimator
from .utils import np_quat
from .utils.outputs import CalibrationDump, DeadReckoningPaths
from .utils.profiling import StageStats


class GroundFusionSystem:
    def __init__(self, cfg: Config, out_dir: str = "output", device=None):
        """``device=None`` means the GPU and raises when there is none."""
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

        self.line_tracker = None
        if cfg.use_line:
            self.line_tracker = LineTracker(
                cfg.camera.fx, cfg.camera.fy, cfg.camera.cx, cfg.camera.cy,
                max_lines=cfg.lines.max_lines, min_len_px=cfg.lines.min_seg_len_px,
                device=self.device)
        self.detector_params = None
        if cfg.use_yolo:
            self.detector_params = self._load_detector(out_dir)
        # the camera's parameters as host floats, for host-side projections
        self._cam_host = type(self.cam.params)(*[p.cpu() for p in self.cam.params])

        self.pose_graph = None
        if cfg.loop.enabled:
            self.pose_graph = PoseGraph(cfg, cam_focal=cfg.camera.fx, device=self.device)
            self._kf_index = 0
            self._opt_edges = 0
            # per-keyframe CAMERA-frame clouds (and RGB-D copies for the
            # TSDF) for post-loop re-anchoring, kept on the device (the
            # reference keeps point_rgbd on each KeyFrame and rebuilds the
            # octree from them in updatePath, pose_graph.cpp:875-930)
            self._kf_clouds: dict[int, tuple] = {}
            self._kf_rgbd: dict[int, tuple] = {}

        self.voxel_map = None
        self.tsdf = None
        if cfg.map.enabled:
            self.voxel_map = VoxelColorMap(voxel_size=cfg.map.voxel_size, device=self.device)
            if cfg.map.mesh:
                self.tsdf = TsdfVolume(
                    origin=cfg.map.mesh_origin, size_m=cfg.map.mesh_size_m,
                    resolution=cfg.map.mesh_resolution,
                    depth_max=cfg.tracker.depth_max, device=self.device,
                )
        self.global_fusion = None     # built by the first GPS fix
        self.prior_grid = None        # a loaded prior occupancy grid (load_checkpoint)

        self.stats = StageStats()
        self.calib_dump = CalibrationDump(out_dir)
        self.dead_reckoning = DeadReckoningPaths()
        self._dr_ba = self._dr_bg = None
        self._dr_sw = (cfg.wheel.sx, cfg.wheel.sy, cfg.wheel.sw)
        # live telemetry registry: the in-process analog of the reference's
        # live topics (visualization.cpp:53-81). Topics: imu_propagate
        # (IMU-rate predicted odometry, pubLatestOdometry), odometry (per
        # solved frame, pubOdometry), keyframe (pubKeyframe), loop_closure (new
        # verified loop edge), path_update (post-relaxation drift broadcast),
        # map_delta (newly inserted keyframe cloud). Publishing is zero-cost
        # with no subscribers.
        self._subs: dict[str, list] = {}

        # burst replay (cfg.burst_chunk): the estimator solves K staged
        # frames per flush; the post-solve hooks drain from the trajectory
        # at each flush, with the frames' images kept until then
        self._burst = bool(cfg.burst_chunk)
        self._burst_frames: dict[float, tuple] = {}   # t -> (img, depth)
        self._consumed = 0
        if self._burst:
            self.estimator.enable_burst(cfg.burst_chunk)

    def _load_detector(self, out_dir: str):
        """Detector weights: the per-run override ``<out_dir>/detector.npz``,
        then the shipped trained file (the reference loads pretrained darknet
        weights the same way, YoloObjectDetector.cpp + yolo_network_config/);
        with neither, a warning and a random init."""
        run_w = os.path.join(out_dir, "detector.npz")
        shipped = os.path.join(os.path.dirname(__file__), "detector", "weights.npz")
        for path in (run_w, shipped):
            if os.path.exists(path):
                return load_npz(path, device=self.device)
        warnings.warn("use_yolo set but no detector weights found; random init will "
                      "cull features with noise")
        return init_params(device=self.device)

    def _cull_dynamic(self, img: np.ndarray, feats: dict) -> dict:
        """Drop the features inside a dynamic-class detection (trackImagebox,
        feature_tracker.cpp:564-606). The image goes up to the device once,
        the detector and the cull run there, and the keep mask comes back in
        one fetch. The tracker's points and ``feats`` are in the same order
        (the tracker builds ``feats`` from its ids, which ``prev_pts``
        follows), so they pair by position. In burst mode this fetch happens
        while the frame is staged, as in the JAX package."""
        img_rgb = img if img.ndim == 3 else np.repeat(img[..., None], 3, -1)
        img_d = torch.as_tensor(np.ascontiguousarray(img_rgb, np.float32)).to(self.device)
        boxes, _, classes, valid = detect(self.detector_params, img_d)
        pts = torch.as_tensor(self.tracker.prev_pts).to(self.device)
        keep = cull_features_in_boxes(pts, boxes, classes, valid).cpu().numpy()
        return {fid: f for (fid, f), k in zip(feats.items(), keep) if k}

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

    def input_gnss(self, t, obs):
        self.estimator.input_gnss(t, obs)

    def input_gps_fix(self, t, lat, lon, alt, acc):
        """NavSatFix path → global fusion layer (globalOptNode.cpp)."""
        if self.global_fusion is None:
            from .global_layers.global_fusion import GlobalFusion

            self.global_fusion = GlobalFusion(device=self.device)
        self.global_fusion.input_gps(t, lat, lon, alt, acc)

    def input_image(self, t, img: np.ndarray, depth: Optional[np.ndarray] = None,
                    img_right: Optional[np.ndarray] = None
                    ) -> Optional[np.ndarray]:
        """One synchronized camera frame end-to-end. ``img_right``: rectified
        stereo pair image (used when ``camera.baseline`` > 0 and no RGBD
        depth is supplied). The timed stages each end in a device→host
        fetch, so their wall-clock times include their device work (in
        burst mode ``solve`` waits on the device only at a flush)."""
        if not self._burst:
            # prediction seeding reads the freshly solved core; mid-chunk the
            # core is stale in burst mode, so it seeds nothing there
            self._seed_tracker_predictions()
        # KLT and the line tracker consume luminance; the detector consumes
        # 3 channels (the reference's img_callback hands BGR8 to darknet and
        # MONO8 to the tracker, rosNodeTest.cpp / YoloObjectDetector.cpp)
        img = np.asarray(img)
        img_gray = img.mean(axis=-1) if img.ndim == 3 else img
        with self.stats.time("track"):
            feats = self.tracker.track(t, img_gray, depth, img_right=img_right)

        if self.detector_params is not None and len(self.tracker.prev_pts):
            with self.stats.time("detect"):
                feats = self._cull_dynamic(img, feats)

        line_obs = None
        if self.line_tracker is not None:
            with self.stats.time("lines"):
                line_obs = self.line_tracker.track(img_gray)

        with self.stats.time("solve"):
            pose = self.estimator.input_frame(t, feats, line_obs=line_obs)

        if self._burst:
            if self.pose_graph is not None or self.voxel_map is not None:
                self._burst_frames[float(t)] = (img, depth)
                # bound the backlog to one chunk and some slack
                while len(self._burst_frames) > self.cfg.burst_chunk + 2:
                    self._burst_frames.pop(next(iter(self._burst_frames)))
            if pose is not None:
                self._drain_burst_hooks()
            return pose

        if pose is not None:
            s_wheel = self.calib_dump.append(t, self.estimator.core.state)
            self._refresh_dr_bias(s_wheel)
            if self.global_fusion is not None:
                self.global_fusion.input_odom(t, pose)
            is_kf = bool(self.estimator.keyframe_flags
                         and self.estimator.keyframe_flags[-1])
            self._publish("odometry", t=t, pose=np.asarray(pose),
                          is_keyframe=is_kf)
            if is_kf:
                self._publish("keyframe", t=t, pose=np.asarray(pose))
            self._loop_and_map(t, img, depth, pose, is_kf)
        return pose

    def _loop_and_map(self, t, img, depth, pose, is_keyframe):
        """Loop-closure registration + dense-map insertion for one solved
        frame. With the pose graph active, clouds are inserted at the
        DRIFT-CORRECTED keyframe pose and registered for re-anchoring after
        each graph relaxation — the reference inserts at ``updatePose``'s
        corrected pose and rebuilds the octree in ``updatePath``
        (pose_graph.cpp:170-244, 875-930). Without a pose graph there is no
        drift estimate and every frame maps at its VIO pose."""
        corrected = None
        if self.pose_graph is not None and is_keyframe:
            corrected = self._add_loop_keyframe(t, img, pose)
        if self.voxel_map is None or depth is None:
            return
        if self.pose_graph is not None:
            # reference parity: only pose-graph keyframes carry dense clouds
            if not is_keyframe:
                return
            if corrected is not None:
                self._map_keyframe(corrected, img, depth, register=len(self.pose_graph.kfs) - 1)
            else:
                # keyframe payload too thin for the graph — still map it at
                # the current drift-corrected pose (un-re-anchorable)
                self._map_keyframe(self._drift_corrected(pose), img, depth)
        else:
            self._map_keyframe(pose, img, depth)

    def _drift_corrected(self, pose) -> np.ndarray:
        """``pose`` [7] under the pose graph's current drift (host, float64)."""
        pg = self.pose_graph
        p = np.asarray(pose, float).copy()
        p[0:3] = pg.r_drift @ p[0:3] + pg.t_drift
        q_d = mat_to_quat(torch.as_tensor(np.asarray(pg.r_drift, np.float64))).numpy()
        p[3:7] = np_quat.quat_normalize(np_quat.quat_mul(q_d, p[3:7]))
        return p

    def _drain_burst_hooks(self):
        """Run the post-solve hooks for every trajectory entry that the last
        flushes produced. Keyframe payloads (window landmark clouds) and the
        calibration rows come from the post-chunk core — the same data, read
        once per flush instead of once per frame."""
        est = self.estimator
        new = est.trajectory[self._consumed :]
        if not new:
            return
        flags = est.keyframe_flags[self._consumed :]
        self._consumed = len(est.trajectory)
        s_wheel = self.calib_dump.append_rows([t for t, _ in new], est.core.state)
        self._refresh_dr_bias(s_wheel)
        for (t_k, pose_k), kf in zip(new, flags):
            if self.global_fusion is not None:
                self.global_fusion.input_odom(t_k, pose_k)
            self._publish("odometry", t=t_k, pose=np.asarray(pose_k), is_keyframe=bool(kf))
            if kf:
                self._publish("keyframe", t=t_k, pose=np.asarray(pose_k))
            frame = self._burst_frames.get(float(t_k))
            if frame is not None:
                self._loop_and_map(t_k, frame[0], frame[1], pose_k, kf)

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
            return None
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
                self._rebuild_map()
                # post-relaxation drift broadcast (updatePath's corrected
                # path, pose_graph.cpp:674-696)
                self._publish("path_update", r_drift=np.asarray(self.pose_graph.r_drift),
                              t_drift=np.asarray(self.pose_graph.t_drift))
        self._kf_index += 1
        # the drift-corrected pose the graph stored (updatePose) — dense
        # clouds are inserted at THIS pose, not the raw VIO one
        return self.pose_graph.kfs[-1].pose

    def _cam_pose(self, pose) -> torch.Tensor:
        """world_T_cam on the device: the float32 body pose ∘ the camera
        mount (as the JAX package composes them)."""
        body = torch.as_tensor(np.asarray(pose, np.float32), device=self.device)
        return pose_compose(body, self.estimator.core.state.ex_cam)

    def _z_gate(self, pts_w: torch.Tensor, ok: torch.Tensor) -> torch.Tensor:
        """World-z insertion gate (pointWorld.z() > 2 || < -0.5 skip,
        pose_graph.cpp:201-202)."""
        return ok & (pts_w[:, 2] <= self.cfg.map.z_max) & (pts_w[:, 2] >= self.cfg.map.z_min)

    def _integrate_tsdf(self, depth, color, cam_pose) -> None:
        # the TSDF raster assumes a pinhole-style intrinsic grid (as does the
        # reference's RGBD mapping node); a Scaramuzza model has no focal of
        # its own, so the config's nominal one stands in (the JAX package
        # raises there)
        p, c = self._cam_host, self.cfg.camera
        fx, fy, cx, cy = (float(getattr(p, k, getattr(c, k))) for k in ("fx", "fy", "cx", "cy"))
        self.tsdf.integrate(depth, color, cam_pose, fx, fy, cx, cy)

    def _map_keyframe(self, pose, img, depth, register: Optional[int] = None):
        """Insert one RGBD frame into the voxel map at ``pose`` (already
        drift-corrected when the pose graph is active), sampled, lifted and
        gated on the device. Applies the world-z insertion gate
        (pose_graph.cpp:201-202). ``register`` ties the camera-frame cloud to
        pose-graph keyframe ``kfs[register]`` so :meth:`_rebuild_map` can
        re-anchor it after loop relaxations."""
        cfg = self.cfg.map
        img = np.asarray(img)
        color = np.stack([img] * 3, -1) if img.ndim == 2 else img
        with self.stats.time("map"):
            depth_t = torch.as_tensor(np.asarray(depth, np.float32), device=self.device)
            color_t = torch.as_tensor(np.asarray(color, np.float32), device=self.device)
            gx, gy, d, rgb, ok = sample_rgbd(depth_t, color_t, stride=cfg.depth_stride,
                                             boundary=cfg.depth_boundary)
            uv = torch.stack([gx, gy], -1).to(torch.float32)
            rays = self.cam.lift_projective(uv)
            rays = rays / torch.clamp(torch.abs(rays[:, 2:3]), min=1e-9)  # z=1 for depth scaling
            pts_cam = rays * d[:, None]
            cam_pose = self._cam_pose(pose)
            pts_w = pose_apply(cam_pose, pts_cam)
            # the gate depends on the WORLD pose, so only the pre-gate
            # validity mask is stored per keyframe and the gate is
            # re-evaluated at rebuild time
            ok_z = self._z_gate(pts_w, ok)
            if "map_delta" in self._subs:
                m = ok_z.cpu().numpy()
                self._publish("map_delta", t=None, points=pts_w.cpu().numpy()[m],
                              colors=rgb.cpu().numpy()[m])
            self.voxel_map.insert(pts_w, rgb, ok_z)
            if register is not None:
                # fixed-shape cloud + pre-z-gate mask (the reference resizes
                # point_rgbd to the inserted points, pose_graph.cpp:219-222)
                self._kf_clouds[register] = (pts_cam, rgb, ok)
                if self.tsdf is not None:
                    # compact per-KF RGB-D copy (float16 depth, uint8 colour,
                    # as the JAX package keeps it) so the TSDF can be
                    # re-rastered at the relaxed poses after a loop closure
                    self._kf_rgbd[register] = (depth_t.to(torch.float16),
                                               color_t.to(torch.uint8))
            if self.tsdf is not None:
                self._integrate_tsdf(depth_t, color_t, cam_pose)

    def _rebuild_map(self):
        """Re-anchor the dense map after a pose-graph relaxation: clear the
        voxel accumulator (and the TSDF) and re-insert every registered
        keyframe cloud at its (now loop-corrected) graph pose —
        ``updatePath``'s octree rebuild (pose_graph.cpp:875-930)."""
        if self.voxel_map is None or not self._kf_clouds:
            return
        with self.stats.time("map"):
            self.voxel_map.clear()
            if self.tsdf is not None:
                self.tsdf.clear()
            for kf_pos, (pts_cam, rgb, ok) in self._kf_clouds.items():
                cam_pose = self._cam_pose(self.pose_graph.kfs[kf_pos].pose)
                pts_w = pose_apply(cam_pose, pts_cam)
                # re-evaluate the world-z insertion gate at the relaxed pose
                self.voxel_map.insert(pts_w, rgb, self._z_gate(pts_w, ok))
                if self.tsdf is not None and kf_pos in self._kf_rgbd:
                    depth, color = self._kf_rgbd[kf_pos]
                    self._integrate_tsdf(depth.to(torch.float32), color.to(torch.float32),
                                         cam_pose)

    # --------------------------------------------------------- checkpointing

    def save_checkpoint(self, dir_: Optional[str] = None) -> None:
        """Write the estimator snapshot and the pose graph (the 's'-key save
        of pose_graph.cpp:1062-1126, plus the VIO window state the reference
        cannot persist): ``vio_state.npz`` and, with loop closure,
        ``pose_graph.npz``. In burst mode the staged frames are flushed and
        their post-solve hooks run first."""
        from .utils.checkpoint import save_pose_graph

        d = dir_ or self.out_dir
        os.makedirs(d, exist_ok=True)
        if self._burst:
            self.estimator.flush_burst()
            self._drain_burst_hooks()
        self.estimator.save_state(os.path.join(d, "vio_state.npz"))
        if self.pose_graph is not None:
            save_pose_graph(os.path.join(d, "pose_graph.npz"), self.pose_graph)

    def load_checkpoint(self, graph_path: Optional[str] = None,
                        state_path: Optional[str] = None,
                        grid_path: Optional[str] = None) -> None:
        """Resume from saved artifacts: a prior pose graph (relocalization
        against loaded keyframes — ``load_previous_pose_graph``,
        pose_graph.cpp:1127-1267; new keyframes continue its indices), a VIO
        state snapshot, and/or a prior occupancy grid
        (pose_graph_node.cpp:861-901), each on this system's device.

        After a state load the trackers hand out ids above every restored
        one: the snapshot's slot maps key landmarks by feature and line id,
        and a fresh tracker counting from 0 would write its new features
        into the slots of other landmarks."""
        if graph_path is not None:
            from .utils.checkpoint import load_pose_graph

            if self.pose_graph is None:
                raise ValueError("loop closure disabled: enable cfg.loop "
                                 "to load a prior pose graph")
            load_pose_graph(graph_path, self.pose_graph)
            self._kf_index = max((k.index for k in self.pose_graph.kfs), default=-1) + 1
        if state_path is not None:
            est = self.estimator
            est.load_state(state_path)
            self.tracker.next_id = max([self.tracker.next_id, *(k + 1 for k in est.slot_of)])
            if self.line_tracker is not None:
                self.line_tracker._next_id = max(
                    [self.line_tracker._next_id, *(k + 1 for k in est.line_slot_of)])
        if grid_path is not None:
            from .global_layers.dense_map import OccupancyGrid2D

            self.prior_grid = OccupancyGrid2D.load_pgm(grid_path, device=self.device)

    # --------------------------------------------------------------- output

    def finish(self, save_state: bool = False):
        """Flush, then write the run's outputs into ``out_dir``; with
        ``save_state`` also the checkpoint (:meth:`save_checkpoint`)."""
        est = self.estimator
        if self._burst:
            est.flush_burst()
            self._drain_burst_hooks()
        if save_state:
            self.save_checkpoint()
        est.write_tum(os.path.join(self.out_dir, "vio.txt"))
        if self.pose_graph is not None:
            self.pose_graph.write_tum(os.path.join(self.out_dir, "loop.txt"))
        if self.global_fusion is not None:
            # one relaxation before the write: the JAX package's system never
            # calls optimize, so its global.txt is the odometry under an
            # identity alignment; the reference optimizes on every fix
            # (globalOpt.cpp) — ROADMAP queue 3
            self.global_fusion.optimize()
            self.global_fusion.write_tum(os.path.join(self.out_dir, "global.txt"))
        if self.voxel_map is not None:
            pts, cols = self.voxel_map.export(self.cfg.map.density_gate)
            if self.cfg.map.outlier_min_neighbors > 0:
                # offline cloud conditioning before export — the PCL
                # RadiusOutlierRemoval stage of the reference's mesh command
                # (pose_graph_node.cpp:133-318)
                keep = radius_outlier_filter(
                    pts, radius=2.0 * self.cfg.map.voxel_size,
                    min_neighbors=self.cfg.map.outlier_min_neighbors)
                pts, cols = pts[keep], cols[keep]
            write_cloud_ply(os.path.join(self.out_dir, "map.ply"), pts, cols)
        if self.tsdf is not None:
            self.tsdf.save_mesh_ply(os.path.join(self.out_dir, "mesh.ply"),
                                    smooth_radius=self.cfg.map.mls_radius_m)
        if self.prior_grid is not None:
            # republish the loaded prior occupancy map into this run's output
            # set (the latched prior-map republish, pose_graph_node.cpp:861-901)
            self.prior_grid.save_pgm(os.path.join(self.out_dir, "prior_grid.pgm"))
        self.dead_reckoning.write_tum(
            os.path.join(self.out_dir, "pure_imu.txt"),
            os.path.join(self.out_dir, "pure_wheel.txt"),
        )
        with open(os.path.join(self.out_dir, "timing.txt"), "w") as fp:
            fp.write(self.stats.report() + "\n")
        return os.path.join(self.out_dir, "vio.txt")
