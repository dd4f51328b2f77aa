"""PyTorch port vs JAX package: the stereo projection factors
(``estimator/factors.py``: ``proj22_*``, ``proj12_*``) and the simulator's
window problem (``sim/synthetic.py``: ``imu_interval``, ``wheel_interval``,
``build_window_problem``), on the same numpy-seeded inputs.

The factors' residuals and their Jacobians over the 26 (or 14) tangent
columns agree within 1e-10 in float64 and vanish at ground truth
(``tests/test_solver.py::test_stereo_factors_zero_at_gt`` is the oracle).
The window problem's arrays agree within 1e-12 in float64 (the JAX side's
sample functions jitted, ``test_torch_assembly.jitted_jax_simulator``) and
within float32 rounding of the same projections in float32."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.estimator import factors as jf
from ground_fusion_tpu.geometry.se3 import pose_apply_inv as jpose_apply_inv
from ground_fusion_tpu.geometry.se3 import pose_compose as jpose_compose
from ground_fusion_tpu.sim import synthetic as jsim
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.estimator import factors as tf
from ground_fusion_tpu_torch.sim import synthetic as tsim
from test_torch_assembly import jitted_jax_simulator

TOL = 1e-10
SCALE = 460.0 / 1.5


def _rand_pose(rng, pos=1.0, ang=0.3):
    q = np.concatenate([[1.0], rng.normal(0, ang, 3)])
    q /= np.linalg.norm(q)
    return np.concatenate([rng.normal(0, pos, 3), q[1:], q[:1]])      # [x y z qx qy qz qw]


def _cases(n=6, seed=0):
    """Seeded poses, extrinsics, depths, time offsets and observations (with
    feature velocities and capture-time offsets, so the td terms count)."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        obs = np.concatenate([rng.normal(0, 0.3, 2), [1.0], rng.normal(0, 0.3, 2), [1.0],
                              rng.normal(0, 0.5, 2), [0.0], rng.normal(0, 0.5, 2), [0.0],
                              rng.normal(0, 0.01, 2)])
        yield dict(pose_i=_rand_pose(rng), pose_j=_rand_pose(rng), ex0=_rand_pose(rng, 0.1, 0.05),
                   ex1=_rand_pose(rng, 0.1, 0.05), inv_dep=rng.uniform(0.1, 0.6),
                   td=rng.normal(0, 0.01), obs=obs)


def _close(got, want, tol=TOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=tol)


def test_proj22_residual_and_jacobian_match_jax():
    """``proj22_factor`` (cam0 of frame i → cam1 of frame j): residual and
    its Jacobian [2, 26], column for column; the raw residual alike."""
    for c in _cases():
        j = {k: jnp.asarray(v) for k, v in c.items()}
        t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in c.items()}
        r, J = tf.proj22_factor(t["pose_i"], t["pose_j"], t["ex0"], t["ex1"], t["inv_dep"],
                                t["td"], t["obs"], torch.tensor(SCALE, dtype=torch.float64))
        wr, wJ = jf.proj22_factor(j["pose_i"], j["pose_j"], j["ex0"], j["ex1"], j["inv_dep"],
                                  j["td"], j["obs"], jnp.asarray(SCALE))
        assert J.shape == (2, 26)
        _close(r, wr, TOL * SCALE)
        _close(J, wJ, TOL * SCALE * max(1.0, float(np.abs(np.asarray(wJ)).max())))
        o = c["obs"]
        raw = tf.proj22_residual_raw(t["pose_i"], t["pose_j"], t["ex0"], t["ex1"], t["inv_dep"],
                                     t["td"], *(t["obs"][s] for s in (slice(0, 3), slice(3, 6),
                                                                     slice(6, 9), slice(9, 12))),
                                     t["obs"][12], t["obs"][13])
        _close(raw, jf.proj22_residual_raw(j["pose_i"], j["pose_j"], j["ex0"], j["ex1"],
                                           j["inv_dep"], j["td"], o[0:3], o[3:6], o[6:9],
                                           o[9:12], o[12], o[13]))


def test_proj12_residual_and_jacobian_match_jax():
    """``proj12_factor`` (one frame, cam0 → cam1): residual and Jacobian
    [2, 14], and the raw residual."""
    for c in _cases(seed=1):
        j = {k: jnp.asarray(v) for k, v in c.items()}
        t = {k: torch.as_tensor(v, dtype=torch.float64) for k, v in c.items()}
        r, J = tf.proj12_factor(t["ex0"], t["ex1"], t["inv_dep"], t["td"], t["obs"],
                                torch.tensor(SCALE, dtype=torch.float64))
        wr, wJ = jf.proj12_factor(j["ex0"], j["ex1"], j["inv_dep"], j["td"], j["obs"],
                                  jnp.asarray(SCALE))
        assert J.shape == (2, 14)
        _close(r, wr, TOL * SCALE)
        _close(J, wJ, TOL * SCALE * max(1.0, float(np.abs(np.asarray(wJ)).max())))
        o = c["obs"]
        raw = tf.proj12_residual_raw(t["ex0"], t["ex1"], t["inv_dep"], t["td"],
                                     *(t["obs"][s] for s in (slice(0, 3), slice(3, 6),
                                                            slice(6, 9), slice(9, 12))),
                                     t["obs"][12], t["obs"][13])
        _close(raw, jf.proj12_residual_raw(j["ex0"], j["ex1"], j["inv_dep"], j["td"], o[0:3],
                                           o[3:6], o[6:9], o[9:12], o[12], o[13]))


def test_stereo_factors_vanish_at_ground_truth():
    """The oracle's consistent geometry (a point seen by cam0 of frame i and
    cam1 of frame j, 10 cm baseline): both residuals below 1e-9, in float64
    and float32 (there below 1e-3 of a whitened pixel)."""
    R = np.asarray([[np.cos(0.1), -np.sin(0.1), 0], [np.sin(0.1), np.cos(0.1), 0], [0, 0, 1.0]])
    qw = np.sqrt(1 + np.trace(R)) / 2
    q = np.array([(R[2, 1] - R[1, 2]) / (4 * qw), (R[0, 2] - R[2, 0]) / (4 * qw),
                  (R[1, 0] - R[0, 1]) / (4 * qw), qw])
    pose_i = np.array([0.0, 0, 0, 0, 0, 0, 1])
    pose_j = np.concatenate([[0.5, 0.1, 0.0], q])
    ex0 = np.array([0.0, 0, 0, 0, 0, 0, 1])
    ex1 = np.array([0.1, 0.0, 0.0, 0, 0, 0, 1])
    pt_w = jnp.asarray([0.3, -0.2, 4.0])
    pc_i = np.asarray(jpose_apply_inv(jpose_compose(jnp.asarray(pose_i), jnp.asarray(ex0)), pt_w))
    pc_j = np.asarray(jpose_apply_inv(jpose_compose(jnp.asarray(pose_j), jnp.asarray(ex1)), pt_w))
    pc_1 = np.asarray(jpose_apply_inv(jpose_compose(jnp.asarray(pose_i), jnp.asarray(ex1)), pt_w))
    obs22 = np.concatenate([pc_i / pc_i[2], pc_j / pc_j[2], np.zeros(8)])
    obs12 = np.concatenate([pc_i / pc_i[2], pc_1 / pc_1[2], np.zeros(8)])
    for dtype, tol in ((torch.float64, 1e-9), (torch.float32, 1e-3)):
        a = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype)
        r22, J22 = tf.proj22_factor(a(pose_i), a(pose_j), a(ex0), a(ex1), a(1.0 / pc_i[2]),
                                    a(0.0), a(obs22), a(SCALE))
        r12, J12 = tf.proj12_factor(a(ex0), a(ex1), a(1.0 / pc_i[2]), a(0.0), a(obs12), a(SCALE))
        assert float(r22.abs().max()) < tol and float(r12.abs().max()) < tol
        assert J22.shape == (2, 26) and J12.shape == (2, 14) and J22.dtype == dtype


def _small(cls):
    cfg = cls()
    return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, window_size=6,
                                                              max_landmarks=40))


@pytest.mark.parametrize("sp_kw", [{}, dict(acc_noise=0.02, gyr_noise=0.002, pix_noise=1e-3,
                                            seed=3, omega=0.3)], ids=["exact", "noisy"])
def test_build_window_problem_matches_jax(sp_kw):
    """Cores, buffers, tracks, ground truth and landmarks of the same
    ``Config``, ``SimParams`` and seeds, from ``t_start = 0.3``: float64
    within 1e-12 (1e-12 relative on the inverse depths), booleans and
    indices equal."""
    with jitted_jax_simulator():
        want = jsim.build_window_problem(_small(JConfig), jsim.SimParams(**sp_kw), 0.3,
                                         dtype=jnp.float64)
    got = tsim.build_window_problem(_small(TConfig), tsim.SimParams(**sp_kw), 0.3,
                                    dtype=torch.float64, device="cpu")
    for name in ("state", "tracks", "imu_buf", "wheel_buf"):
        for field in want[name]._fields:
            w = np.asarray(getattr(want[name], field))
            g = getattr(got[name], field).numpy()
            assert g.shape == w.shape, (name, field)
            if w.dtype == bool or w.dtype.kind == "i":
                assert np.array_equal(g, w), (name, field)
            else:
                assert g.dtype == np.float64, (name, field)
                _close(g, w, 1e-12 * max(1.0, float(np.abs(w).max())))
    for name in ("interval_valid", "ts", "pts_w", "ex_cam"):
        _close(np.asarray(got[name]).astype(float), np.asarray(want[name]).astype(float), 1e-12)


def test_build_window_problem_float32():
    """In float32 the same problem, cast where the JAX package casts: the
    trajectory, buffers and landmarks equal to the float64 ones rounded,
    the projections within 1e-6 of JAX's (a few float32 ulps of a
    unit-scale coordinate: the chain compose → apply_inv → divide rounds
    in another order), the inverse depths within 2e-6 relative."""
    with jitted_jax_simulator():
        want = jsim.build_window_problem(_small(JConfig), jsim.SimParams(), dtype=jnp.float32)
    got = tsim.build_window_problem(_small(TConfig), tsim.SimParams(), dtype=torch.float32,
                                    device="cpu")
    for name in ("state", "tracks", "imu_buf", "wheel_buf"):
        for field in want[name]._fields:
            w = np.asarray(getattr(want[name], field))
            g = getattr(got[name], field).numpy()
            if w.dtype == bool or w.dtype.kind == "i":
                assert np.array_equal(g, w), (name, field)
            else:
                assert g.dtype == np.float32, (name, field)
                np.testing.assert_allclose(g, w, rtol=2e-6, atol=1e-6, err_msg=f"{name}.{field}")


def test_sensor_intervals_match_jax():
    """``imu_interval`` and ``wheel_interval`` padded to the cap (an empty
    interval, a whole one, one with IMU noise from the rng) against the JAX
    package's, and the cap's assertion."""
    sp = dict(acc_noise=0.02, gyr_noise=0.002, omega=0.3)
    with jitted_jax_simulator():
        for t0, t1 in ((0.4, 0.4), (0.4, 0.5), (1.0, 1.1)):
            w = jsim.imu_interval(t0, t1, jsim.SimParams(**sp), 32, np.random.default_rng(5))
            g = tsim.imu_interval(t0, t1, tsim.SimParams(**sp), 32, np.random.default_rng(5))
            for a, b in zip(g, w):
                _close(np.asarray(a).astype(float), np.asarray(b).astype(float), 1e-12)
            w = jsim.wheel_interval(t0, t1, jsim.SimParams(**sp), 16)
            g = tsim.wheel_interval(t0, t1, tsim.SimParams(**sp), 16)
            for a, b in zip(g, w):
                _close(np.asarray(a).astype(float), np.asarray(b).astype(float), 1e-12)
    with pytest.raises(AssertionError, match="IMU interval needs 20 > cap 8"):
        tsim.imu_interval(0.0, 0.1, tsim.SimParams(), 8)
