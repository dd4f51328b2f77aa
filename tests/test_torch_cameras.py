"""The port's camera models against the JAX package's: lift and project of
every dispatched model on the same seeded pixels in float64, the factory's
aliases and distortion layouts, the renderer through a dispatched camera, and
the equidistant drive of ``tests/test_cameras.py`` on the port."""

import dataclasses
import os
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from ground_fusion_tpu.cameras import models as jm  # noqa: E402
from ground_fusion_tpu_torch.cameras import models as tm  # noqa: E402

F64_TOL = 1e-9            # the same float64 formulas, evaluated in another order
ROUND_TRIP_PX = 1e-3      # tests/test_cameras.py:129
ALIASES = ["pinhole", "radtan", "pinhole_full", "pinholefull", "PinholeFull", "mei", "cata",
           "catadioptric", "equidistant", "kannala_brandt", "kannala-brandt", "fisheye",
           "scaramuzza", "ocam"]


def _both(name, dist):
    jc = jm.make_camera(name, 460.0, 459.0, 320.0, 240.0, dist, dtype=jnp.float64)
    tc = tm.make_camera(name, 460.0, 459.0, 320.0, 240.0, dist, dtype=torch.float64, device="cpu")
    return jc, tc


@pytest.mark.parametrize("name", [n for n, _ in chip_smoke.camera_cases(np)])
def test_model_matches_jax_and_round_trips(name):
    """Each model at the oracle's distortion (Scaramuzza: a self-consistent
    pair of polynomials) on 1000 seeded pixels: lift and project within 1e-9
    of the JAX package in float64, and project ∘ lift within 1e-3 px."""
    dist = dict(chip_smoke.camera_cases(np))[name]
    jc, tc = _both(name, dist)
    uv = np.random.default_rng(0).uniform([100, 80], [540, 400], (chip_smoke.CAM_PIXELS, 2))
    rj = np.asarray(jc.lift_projective(jnp.asarray(uv)))
    rt = tc.lift_projective(torch.as_tensor(uv)).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=F64_TOL)
    pts = rt / rt[:, 2:3] * np.random.default_rng(1).uniform(0.5, 5.0, (len(rt), 1))
    pj = np.asarray(jc.space_to_plane(jnp.asarray(pts)))
    pt = tc.space_to_plane(torch.as_tensor(pts)).numpy()
    np.testing.assert_allclose(pt, pj, rtol=0, atol=F64_TOL * 1e3)
    assert np.abs(pt - uv).max() < ROUND_TRIP_PX
    # the tracker's lift: rays scaled to z = 1 (Mei and Scaramuzza return
    # other z before this)
    norm = tc.lift_projective(torch.as_tensor(uv))
    norm = norm / torch.clamp(torch.abs(norm[:, 2:3]), min=1e-9)
    assert bool(torch.isfinite(norm).all()) and bool((norm[:, 2] == 1.0).all())


def test_make_camera_every_alias_matches_jax():
    """Every alias and distortion-tuple layout (short tuples pad with zeros,
    Scaramuzza's ``inv_poly`` falls back to ρ ≈ f·θ) builds the model the
    JAX factory builds, with the same parameters; float32 by default."""
    for name in ALIASES:
        for dist in [(), (0.1, -0.02), (0.3, -0.1, 0.01, 2e-4, -1e-4, 0.02, 1e-3, 5e-4, 7.0, 9.0)]:
            jc = jm.make_camera(name, 460.0, 459.0, 320.0, 240.0, dist)
            tc = tm.make_camera(name, 460.0, 459.0, 320.0, 240.0, dist, device="cpu")
            assert tc.name == jc.name and type(tc.params).__name__ == type(jc.params).__name__
            assert tc.params._fields == jc.params._fields
            for a, b in zip(tc.params, jc.params):
                assert a.dtype == torch.float32
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    with pytest.raises(ValueError):
        tm.make_camera("no_such_model", 300.0, 300.0, 160.0, 120.0)


def test_render_through_a_dispatched_camera(tmp_path):
    """The renderer with a pinhole camera gives the default pinhole images
    bit for bit; through the equidistant model the blobs sit where that
    model projects the landmarks, and the wall's depth follows its rays."""
    from ground_fusion_tpu_torch.sim.render import render_sequence, wall_depth
    from ground_fusion_tpu_torch.sim.synthetic import SimParams

    sp = SimParams(omega=0.15, frame_rate=30.0)
    kw = dict(n_frames=2, fx=110.0, fy=110.0, cx=48.0, cy=40.0, width=96, height=80, sp=sp,
              n_landmarks=400, seed=3, wall_radius=6.0)
    a = render_sequence(str(tmp_path / "a"), **kw)
    pin = tm.make_camera("pinhole", 110.0, 110.0, 48.0, 40.0, dtype=torch.float64, device="cpu")
    b = render_sequence(str(tmp_path / "b"), **kw, camera=pin)
    for name in ("00000.npy", "00001.npy", "00001_d.npy"):
        assert np.array_equal(np.load(os.path.join(a, "img", name)),
                              np.load(os.path.join(b, "img", name)))
    equi = tm.make_camera("equidistant", 110.0, 110.0, 48.0, 40.0, chip_smoke.EQUI_DISTORTION,
                          dtype=torch.float64, device="cpu")
    pose = np.array([0.5, -0.2, 0.1, 0.9, 0.1, -0.3, 0.2])
    pose[3:] /= np.linalg.norm(pose[3:])
    d_equi = wall_depth(pose, 110.0, 110.0, 48.0, 40.0, 96, 80, 6.0, camera=equi)
    d_pin = wall_depth(pose, 110.0, 110.0, 48.0, 40.0, 96, 80, 6.0)
    d_pin_cam = wall_depth(pose, 110.0, 110.0, 48.0, 40.0, 96, 80, 6.0, camera=pin)
    np.testing.assert_allclose(d_pin_cam, d_pin, rtol=1e-6)
    # the same pixel looks along another ray through the fisheye: the depth
    # at the centre agrees, away from it it does not
    assert abs(float(d_equi[40, 48]) - float(d_pin[40, 48])) < 1e-4
    assert np.abs(d_equi - d_pin).max() > 1e-3


def _equidistant_drive(est, cam, n_frames):
    """tests/test_cameras.py:133's drive: feature pixels distorted through
    the equidistant model, undistorted through the dispatched camera."""
    from ground_fusion_tpu_torch.pipeline import FrameFeature
    from ground_fusion_tpu_torch.sim.synthetic import (
        SimParams, body_T_cam, gt_pose7, imu_sample, make_landmarks, project_landmarks,
        wheel_sample,
    )
    from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

    sp = SimParams()
    ex = body_T_cam(torch.float64)
    pts_w = torch.as_tensor(make_landmarks(200, sp, seed=1), dtype=torch.float64)
    frame_dt, imu_dt, wheel_dt = 1.0 / sp.frame_rate, 1.0 / sp.imu_rate, 1.0 / sp.wheel_rate
    a, g = (np.asarray(x, np.float64) for x in imu_sample(0.0, sp))
    est.input_imu(0.0, a, g)
    v, wg = (np.asarray(x, np.float64) for x in wheel_sample(0.0, sp))
    est.input_wheel(0.0, v, wg)
    gt = {}
    for k in range(n_frames):
        t = k * frame_dt
        if k > 0:
            for ti in np.arange(t - frame_dt + imu_dt, t + 0.5 * imu_dt, imu_dt):
                a, g = (np.asarray(x, np.float64) for x in imu_sample(ti, sp))
                est.input_imu(float(ti), a, g)
            for ti in np.arange(t - frame_dt + wheel_dt, t + 0.5 * wheel_dt, wheel_dt):
                v, wg = (np.asarray(x, np.float64) for x in wheel_sample(ti, sp))
                est.input_wheel(float(ti), v, wg)
        uv, z, vis = project_landmarks(gt_pose7(t, sp), ex, pts_w)
        rays = torch.cat([uv, torch.ones((uv.shape[0], 1), dtype=torch.float64)], -1)
        norm = cam.lift_projective(cam.space_to_plane(rays))
        norm = (norm[:, 0:2] / norm[:, 2:3]).numpy()
        z, vis = z.numpy(), vis.numpy()
        feats = {int(i): FrameFeature(x=float(norm[i, 0]), y=float(norm[i, 1]), depth=float(z[i]))
                 for i in np.nonzero(vis)[0]}
        est.input_frame(t, feats)
        gt[t] = gt_pose7(t, sp).numpy()
    est_xyz = np.stack([p[0:3] for _, p in est.trajectory])
    gt_xyz = np.stack([gt[t][0:3] for t, _ in est.trajectory])
    return float(ate_rmse(est_xyz, gt_xyz)), est_xyz


def _equidistant_config(config_cls):
    cfg = config_cls()
    return dataclasses.replace(cfg, camera=dataclasses.replace(
        cfg.camera, model="equidistant", fx=460.0, fy=460.0, cx=320.0, cy=240.0,
        distortion=chip_smoke.EQUI_DISTORTION))


def test_equidistant_drive_on_the_port():
    """The drive of tests/test_cameras.py:133 (float64, 16 frames) through
    the port's estimator and dispatched camera: ATE < 0.05 m."""
    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.pipeline import Estimator

    cfg = _equidistant_config(Config)
    c = cfg.camera
    cam = tm.make_camera(c.model, c.fx, c.fy, c.cx, c.cy, c.distortion, dtype=torch.float64,
                         device="cpu")
    est = Estimator(cfg, dtype=torch.float64, device="cpu")
    ate, xyz = _equidistant_drive(est, cam, 16)
    assert len(xyz) >= 4
    assert ate < 0.05, f"ATE {ate:.4f} m through the equidistant dispatch"


@pytest.mark.slow
def test_equidistant_drive_through_both_packages():
    """The same drive through both estimators, each with its own camera:
    the trajectories agree (float64)."""
    from ground_fusion_tpu.config import Config as JConfig
    from ground_fusion_tpu.pipeline import Estimator as JEstimator
    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.pipeline import Estimator

    cfg = _equidistant_config(Config)
    c = cfg.camera
    cam = tm.make_camera(c.model, c.fx, c.fy, c.cx, c.cy, c.distortion, dtype=torch.float64,
                         device="cpu")
    ate_t, xyz_t = _equidistant_drive(Estimator(cfg, dtype=torch.float64, device="cpu"), cam, 16)
    jcfg = _equidistant_config(JConfig)
    jest = JEstimator(jcfg, dtype=jnp.float64)
    ate_j, xyz_j = _equidistant_drive(jest, cam, 16)
    assert ate_t < 0.05 and ate_j < 0.05
    assert xyz_t.shape == xyz_j.shape
    np.testing.assert_allclose(xyz_t, xyz_j, atol=1e-6)
