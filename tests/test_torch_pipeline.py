"""PyTorch port vs JAX package, the slice as a whole at a small size (the
rendered-image counterpart is ``test_torch_system.py``).

The feature-stream replay of ``tests/test_pipeline.py`` (exact projected
landmarks, IMU and wheel samples from the simulator) fed frame by frame to
both ``Estimator``s in float64 at ``window_size=4``, ``max_landmarks=32``:
per-frame poses within 1e-6 m, ATE below 0.05 m, once for each of the two
initialization paths the slice ports (the constant-speed circle reads as
stationary to the accelerometer-variance test; one whose speed swings at
4 rad/s takes the wheel-excitation path).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu import pipeline as jpipeline
from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.pipeline import Estimator as JEstimator
from ground_fusion_tpu.pipeline import FrameFeature as JFeature
from ground_fusion_tpu.sim import synthetic as jsim
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
from ground_fusion_tpu_torch.pipeline import FrameFeature as TFeature
from ground_fusion_tpu_torch.sim import synthetic as tsim
from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

N_FRAMES = 10


def _small(config_cls):
    cfg = config_cls()
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, window_size=4, max_landmarks=32))


def _count_calls(obj, name):
    """Count calls of a bound method without changing what it does."""
    calls = []
    inner = getattr(obj, name)

    def wrapped(*a, **k):
        calls.append(1)
        return inner(*a, **k)

    setattr(obj, name, wrapped)
    return calls


_JAX_STEP = {}


def _replay(omega_mod_amp):
    """Both estimators on the identical sensor and feature stream. Both
    replays share one JAX window program (the same config), compiled once."""
    jsp = jsim.SimParams(omega_mod_amp=omega_mod_amp, omega_mod_freq=4.0)
    tsp = tsim.SimParams(omega_mod_amp=omega_mod_amp, omega_mod_freq=4.0)
    je = JEstimator(_small(JConfig), dtype=jnp.float64)
    je.step_fn = _JAX_STEP.setdefault("small", je.step_fn)
    je.native = None                      # Python queues in both, as the port has them
    te = TEstimator(_small(TConfig), dtype=torch.float64, device="cpu")
    wheel_init_calls = {"jax": _count_calls(je, "_wheel_excitation_init"),
                        "torch": _count_calls(te, "_wheel_excitation_init")}
    ex = jsim.body_T_cam(jnp.float64)
    pts_w = jnp.asarray(jsim.make_landmarks(60, jsp, seed=1), jnp.float64)
    frame_dt, imu_dt, wheel_dt = 1.0 / jsp.frame_rate, 1.0 / jsp.imu_rate, 1.0 / jsp.wheel_rate

    def sensors(ts):
        """Simulator samples at ``ts`` (the port's, vectorised; held against
        the JAX package's at the first time: 1e-12) into both estimators."""
        acc, gyr = (x.numpy() for x in tsim.imu_samples(ts["imu"], tsp))
        vel, wgyr = (x.numpy() for x in tsim.wheel_samples(ts["wheel"], tsp))
        t0 = float(ts["imu"][0])
        for got, want in zip((acc[0], gyr[0]), jsim.imu_sample(t0, jsp)):
            assert np.abs(got - np.asarray(want)).max() <= 1e-12
        t0 = float(ts["wheel"][0])
        for got, want in zip((vel[0], wgyr[0]), jsim.wheel_sample(t0, jsp)):
            assert np.abs(got - np.asarray(want)).max() <= 1e-12
        for e in (je, te):
            for ti, a, g in zip(ts["imu"], acc, gyr):
                e.input_imu(float(ti), a, g)
            for ti, v, w in zip(ts["wheel"], vel, wgyr):
                e.input_wheel(float(ti), v, w)

    sensors({"imu": np.asarray([0.0]), "wheel": np.asarray([0.0])})
    poses, gt = [], []
    for k in range(N_FRAMES):
        t = k * frame_dt
        if k > 0:
            sensors({"imu": np.arange(t - frame_dt + imu_dt, t + 0.5 * imu_dt, imu_dt),
                     "wheel": np.arange(t - frame_dt + wheel_dt, t + 0.5 * wheel_dt, wheel_dt)})
        pose_gt = jsim.gt_pose7(t, jsp)
        uv, z, vis = (np.asarray(x) for x in jsim.project_landmarks(pose_gt, ex, pts_w))
        ids = np.nonzero(vis)[0]
        pj = je.input_frame(t, {int(i): JFeature(x=float(uv[i, 0]), y=float(uv[i, 1]),
                                                 depth=float(z[i])) for i in ids})
        pt = te.input_frame(t, {int(i): TFeature(x=float(uv[i, 0]), y=float(uv[i, 1]),
                                                 depth=float(z[i])) for i in ids})
        assert (pj is None) == (pt is None), f"frame {k}: only one estimator gave a pose"
        if pj is not None:
            poses.append((np.asarray(pj), np.asarray(pt)))
            gt.append(np.asarray(pose_gt))
    return je, te, poses, gt, wheel_init_calls


@pytest.fixture(scope="module")
def jitted_jax_preintegration():
    """The JAX estimator's window preintegration, jitted while this file
    runs (eager, the wheel's associative scan dispatches for ~40 s a
    replay); the same function, compiled."""
    mp = pytest.MonkeyPatch()
    mp.setattr(jpipeline, "preintegrate_imu_window", jax.jit(jpipeline.preintegrate_imu_window))
    mp.setattr(jpipeline, "preintegrate_wheel_window", jax.jit(jpipeline.preintegrate_wheel_window))
    yield
    mp.undo()


@pytest.fixture(scope="module", params=[0.0, 0.1], ids=["stationary_init", "wheel_init"])
def replay(request, jitted_jax_preintegration):
    return (request.param, *_replay(request.param))


def test_replay_takes_the_named_init_path(replay):
    """Constant-speed circle: stationary bias init (no wheel alignment call);
    speed-modulated circle: the wheel-excitation init. Same path in both."""
    amp, je, te, poses, _, calls = replay
    want = 0 if amp == 0.0 else 1
    assert len(calls["jax"]) == len(calls["torch"]) == want
    assert je.solver_flag == te.solver_flag == TEstimator.NON_LINEAR
    assert te.reboots == 0


def test_replay_poses_match_jax_per_frame(replay):
    """Every solved frame's pose within 1e-6 (m and quaternion), f64."""
    _, je, te, poses, _, _ = replay
    assert len(poses) == N_FRAMES - 4
    for k, (pj, pt) in enumerate(poses):
        assert np.abs(pj - pt).max() <= 1e-6, f"solved frame {k}"
    assert je.keyframe_flags == te.keyframe_flags


def test_replay_ate_below_bound(replay):
    """ATE of the port against the simulator's ground truth < 0.05 m."""
    _, _, _, poses, gt, _ = replay
    est = np.stack([pt[0:3] for _, pt in poses])
    ate = ate_rmse(est, np.stack([g[0:3] for g in gt]))
    assert ate < 0.05, f"ATE {ate:.4f} m on exact measurements"
