"""The port's ``GroundFusionSystem`` on rendered images, KLT front end
included.

Every run: the port alone on a rendered 320x240 sequence, slow enough at 30
frames a second for the blobs to be tracked from frame to frame — features
are followed, landmarks get solved, the trajectory stays on the ground truth.

Under the ``slow`` marker (the JAX package compiles a tracker and a window
program for this configuration, two minutes of CPU): the same sequence
through both packages' systems — the same feature ids in every frame, every
solved pose within 1e-3 m — and the full-width smoke sequence of
``chip_smoke.py`` through both command lines.

The trackers run in float32 as always. The two estimators are float64 ones
here: once the window is solved its landmarks seed the next frame's LK
search, and in float32 the two packages' poses differ by rounding alone
(~1e-3), which moves a seed by a few hundredths of a pixel and in time flips
a feature at the forward-backward gate. The float32 system as a whole is held
by ``chip_smoke.py`` on the GPU.
"""

import dataclasses
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.cameras.models import make_camera as j_make_camera
from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.geometry.se3 import pose_apply as j_pose_apply
from ground_fusion_tpu.geometry.se3 import pose_compose as j_pose_compose
from ground_fusion_tpu.pipeline import Estimator as JEstimator
from ground_fusion_tpu.system import GroundFusionSystem as JSystem
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.io.dataset import Sequence, load_image
from ground_fusion_tpu_torch.ops.cuda import klt as cuda_klt
from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
from ground_fusion_tpu_torch.sim import synthetic as tsim
from ground_fusion_tpu_torch.sim.render import render_sequence
from ground_fusion_tpu_torch.system import GroundFusionSystem as TSystem
from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

W, H, FX, FY, CX, CY = 320, 240, 300.0, 300.0, 160.0, 120.0
N_RENDERED = 8


def _system_cfg(config_cls):
    cfg = config_cls()
    return dataclasses.replace(
        cfg,
        camera=dataclasses.replace(cfg.camera, width=W, height=H, fx=FX, fy=FY, cx=CX, cy=CY),
        tracker=dataclasses.replace(cfg.tracker, max_features=64, min_dist_px=20.0,
                                    depth_max=7.0),
        solver=dataclasses.replace(cfg.solver, window_size=4, max_landmarks=64),
        use_depth=True)


def _render(root):
    return render_sequence(str(root / "seq"), N_RENDERED, FX, FY, CX, CY, W, H,
                           sp=tsim.SimParams(omega=0.08, frame_rate=30.0),
                           n_landmarks=1500, seed=0)


def _feed(seq, systems):
    """Replay the sequence into every system; yields after each image."""
    ii = wi = 0
    for t, img_path, dep_path in (fr[:3] for fr in seq.frames):
        while ii < len(seq.imu) and seq.imu[ii, 0] <= t:
            r = seq.imu[ii]
            for s in systems:
                s.input_imu(r[0], r[1:4], r[4:7])
            ii += 1
        while wi < len(seq.wheel) and seq.wheel[wi, 0] <= t:
            r = seq.wheel[wi]
            for s in systems:
                s.input_wheel(r[0], r[1:4], r[4:7])
            wi += 1
        img, depth = load_image(img_path), load_image(dep_path)
        for s in systems:
            s.input_image(t, img, depth)
        yield t


def test_port_system_on_rendered_sequence(tmp_path):
    """The port alone, float32 on the CPU: tracks survive, landmarks are
    solved, poses come out from the frame that fills the window and stay
    within 5 mm (ATE) of the ground truth over this short drive."""
    seq = Sequence.load(_render(tmp_path))
    ts = TSystem(_system_cfg(TConfig), str(tmp_path / "out"), device="cpu")
    launches = cuda_klt.LAUNCHES
    for _ in _feed(seq, [ts]):
        pass
    assert cuda_klt.LAUNCHES == launches                     # CPU tensors launch no kernel
    assert int((ts.tracker.track_len >= 5).sum()) >= 20
    tr = ts.estimator.core.tracks
    assert int((tr.active & tr.solve_ok).sum()) >= 20
    traj = ts.estimator.trajectory
    assert len(traj) == N_RENDERED - 4 and ts.estimator.reboots == 0
    est = np.stack([p[0:3] for _, p in traj])
    gt_i = np.stack([np.interp([t for t, _ in traj], seq.gt[:, 0], seq.gt[:, i])
                     for i in (1, 2, 3)], -1)
    assert np.isfinite(est).all()
    assert ate_rmse(est, gt_i) < 0.005
    assert os.path.exists(ts.finish())


def _reference_window_keyframe(window, cam):
    """The JAX package's keyframe payload for one recorded window: its
    ``pose_compose``/``pose_apply`` for the world landmarks, one landmark at
    a time as its hook does, and its camera's ``space_to_plane`` for the
    window pixels, read at slot F-2 (the frame the step has just solved)."""
    tr, poses, ex_cam, f = window
    newest = f - 2
    cams = j_pose_compose(jnp.asarray(poses, jnp.float64), jnp.asarray(ex_cam, jnp.float64)[None, :])
    sf, obs, inv_d = tr["start_frame"], tr["obs"], tr["inv_depth"]
    sel = np.nonzero(tr["active"] & tr["solve_ok"] & tr["obs_valid"][:, newest])[0]
    pts3d = np.stack([np.asarray(j_pose_apply(
        cams[sf[l]], jnp.asarray(np.array([obs[l, sf[l], 0], obs[l, sf[l], 1], 1.0])
                                 / max(inv_d[l], 1e-6)))) for l in sel])
    norm2d = obs[sel, newest, 0:2]
    rays = np.concatenate([norm2d, np.ones((len(sel), 1))], -1)
    win_px = np.asarray(cam.space_to_plane(jnp.asarray(rays, jnp.float32)))
    return pts3d, norm2d, win_px


def test_port_system_with_loop_closure_writes_loop_txt(tmp_path):
    """``loop.enabled`` on the CPU: the system builds a pose graph, every
    solved keyframe with enough landmarks is described and registered in
    it, ``loop.txt`` holds one line per registered keyframe, and the drift
    correction is the identity while no loop has closed. ``map`` still
    raises. Each keyframe's window payload — world landmarks, normalized
    observations, window pixels, and the FAST points' normalized
    coordinates — is held against the JAX package's geometry and camera on
    the same window: 1e-9 m and 1e-12 in float64, 1e-4 px and 1e-6 through
    the float32 camera."""
    seq = Sequence.load(_render(tmp_path))
    cfg = _system_cfg(TConfig)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=True))
    with pytest.raises(NotImplementedError, match="'map'"):
        TSystem(dataclasses.replace(cfg, map=dataclasses.replace(cfg.map, enabled=True)),
                str(tmp_path / "no"), device="cpu")
    ts = TSystem(cfg, str(tmp_path / "out"), device="cpu")
    pg = ts.pose_graph
    assert pg is not None and pg.device.type == "cpu" and pg.db.hists.device.type == "cpu"
    windows = []
    add_keyframe = pg.add_keyframe

    def recording_add_keyframe(kf, *args, **kw):
        core = ts.estimator.core
        tr = {k: v.numpy().copy() for k, v in core.tracks._asdict().items()}
        windows.append((tr, core.state.poses.double().numpy(), core.state.ex_cam.double().numpy(),
                        ts.estimator.f))
        return add_keyframe(kf, *args, **kw)

    pg.add_keyframe = recording_add_keyframe
    for _ in _feed(seq, [ts]):
        pass
    n_kf = sum(ts.estimator.keyframe_flags)
    assert 1 <= len(pg.kfs) <= n_kf and pg.describes == {"cpu": len(pg.kfs)}
    assert len(windows) == len(pg.kfs)
    jcam = j_make_camera(cfg.camera.model, cfg.camera.fx, cfg.camera.fy, cfg.camera.cx,
                         cfg.camera.cy, cfg.camera.distortion)
    for kf, window in zip(pg.kfs, windows):
        pts3d, norm2d, win_px = _reference_window_keyframe(window, jcam)
        m = len(pts3d)
        assert m >= 8 and len(kf.win_pts3d) == len(kf.win_norm) == m
        np.testing.assert_allclose(kf.win_pts3d, pts3d, atol=1e-9, rtol=0)
        np.testing.assert_allclose(kf.win_norm, norm2d, atol=1e-12, rtol=0)
        np.testing.assert_allclose(kf.kp[-m:], win_px, atol=1e-4, rtol=0)
        kp_rays = np.asarray(jcam.lift_projective(jnp.asarray(kf.kp[:-m], jnp.float32)))
        np.testing.assert_allclose(kf.kp_norm[:-m], kp_rays[:, 0:2] / kp_rays[:, 2:3],
                                   atol=1e-6, rtol=0)
    kf = pg.kfs[-1]
    assert kf.desc.dtype == np.uint32 and len(kf.desc) == len(kf.kp_ok) == len(kf.kp)
    assert np.isfinite(kf.win_pts3d).all()
    # the landmarks lie in front of the keyframe's camera, near the rendered depths
    assert np.linalg.norm(kf.win_pts3d - kf.pose[0:3], axis=1).max() < 10.0
    assert not pg.loop_edges and ts._kf_index == len(pg.kfs)
    assert np.array_equal(pg.r_drift, np.eye(3)) and not pg.t_drift.any()
    ts.finish()
    loop = np.loadtxt(tmp_path / "out" / "loop.txt", ndmin=2)
    assert loop.shape == (len(pg.kfs), 8) and np.isfinite(loop).all()
    np.testing.assert_allclose(loop[:, 1:4], [k.pose[0:3] for k in pg.kfs], atol=1e-6)


@pytest.fixture(scope="module")
def rendered(tmp_path_factory):
    root = tmp_path_factory.mktemp("rendered")
    seq = Sequence.load(_render(root))
    js = JSystem(_system_cfg(JConfig), str(root / "out_jax"))
    js.estimator = JEstimator(js.cfg, dtype=jnp.float64)
    js.estimator.native = None            # Python queues in both, as the port has them
    ts = TSystem(_system_cfg(TConfig), str(root / "out_torch"), device="cpu")
    ts.estimator = TEstimator(ts.cfg, dtype=torch.float64, device="cpu")
    launches = cuda_klt.LAUNCHES
    ids, n_tracked = [], []
    for _ in _feed(seq, [js, ts]):
        ids.append((np.array(js.tracker.ids), np.array(ts.tracker.ids)))
        n_tracked.append(int((np.asarray(ts.tracker.track_len) >= 2).sum()))
    return js, ts, ids, n_tracked, cuda_klt.LAUNCHES - launches


@pytest.mark.slow
def test_rendered_sequence_same_feature_ids_every_frame(rendered):
    _, _, ids, n_tracked, launches = rendered
    for k, (a, b) in enumerate(ids):
        assert np.array_equal(a, b), f"frame {k}"
    assert max(n_tracked) >= 20           # features really were tracked across frames
    assert launches == 0                  # CPU tensors launch no kernel


@pytest.mark.slow
def test_rendered_sequence_trajectory_matches_jax(rendered):
    """Every solved pose within 1e-3 m."""
    js, ts, _, _, _ = rendered
    tj, tt = js.estimator.trajectory, ts.estimator.trajectory
    assert len(tj) == len(tt) == N_RENDERED - 4
    for (t_a, pa), (t_b, pb) in zip(tj, tt):
        assert t_a == t_b
        assert np.abs(np.asarray(pa)[0:3] - np.asarray(pb)[0:3]).max() <= 1e-3
    assert ts.estimator.reboots == 0


@pytest.mark.slow
def test_smoke_sequence_cli_port_against_jax_package(tmp_path, capsys):
    """The full-width smoke sequence of ``chip_smoke.py`` (640x480, 40 frames,
    ``configs/groundchallenge.yaml`` unchanged) through both packages' CLIs on
    the CPU in float32: both under the 0.1 m ATE bound, the port within 1.5x
    the JAX package's ATE plus 5 mm, and the two trajectories within 2 cm of
    each other. Prints both ATEs (run with ``-m slow -s`` to read them)."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sys.path.insert(0, root)
    import chip_smoke

    seq = chip_smoke.render_smoke_sequence(str(tmp_path / "seq"))
    cfg = chip_smoke.CONFIG_PATH
    env = dict(os.environ, PYTHONPATH=root, JAX_PLATFORMS="cpu")
    subprocess.run([sys.executable, "-m", "ground_fusion_tpu", cfg, seq, str(tmp_path / "jax")],
                   check=True, env=env, timeout=1500, cwd=root)
    subprocess.run([sys.executable, "-m", "ground_fusion_tpu_torch", cfg, seq,
                    str(tmp_path / "torch"), "--device", "cpu"],
                   check=True, env=env, timeout=1500, cwd=root)
    gt = os.path.join(seq, "gt.csv")
    n_j, ate_j, path = chip_smoke.trajectory_ate(str(tmp_path / "jax" / "vio.txt"), gt)
    n_t, ate_t, _ = chip_smoke.trajectory_ate(str(tmp_path / "torch" / "vio.txt"), gt)
    tj = np.loadtxt(str(tmp_path / "jax" / "vio.txt"), ndmin=2)
    tt = np.loadtxt(str(tmp_path / "torch" / "vio.txt"), ndmin=2)
    with capsys.disabled():
        print(f"\nsmoke sequence on the CPU, float32: JAX package {n_j} poses ATE {ate_j:.5f} m, "
              f"port {n_t} poses ATE {ate_t:.5f} m, path {path:.4f} m, "
              f"max position difference {np.abs(tj[:, 1:4] - tt[:, 1:4]).max():.5f} m")
    assert n_j == n_t >= 20
    assert ate_j < 0.1 and ate_t < 0.1
    assert ate_t <= 1.5 * ate_j + 0.005
    assert np.abs(tj[:, 1:4] - tt[:, 1:4]).max() <= 0.02
