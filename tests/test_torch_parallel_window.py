"""The window preintegration in the log-depth form: the port's window
functions at the config's capacities (F = 11 intervals, 48 IMU and 24 wheel
samples) with mixed masks against the JAX package's (jitted from the test)
and against the port's sequential loop, at ``tests/test_parallel_preint.py``'s
tolerances in float64; and the window step calls the log-depth form."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

import chip_smoke
from ground_fusion_tpu.estimator import buffers as jbuffers
from ground_fusion_tpu.preintegration.imu import noise_cov as j_noise_cov
from ground_fusion_tpu.preintegration.wheel import wheel_noise_cov as j_wheel_noise_cov
from ground_fusion_tpu_torch.config import Config
from ground_fusion_tpu_torch.estimator import buffers
from ground_fusion_tpu_torch.estimator.step import make_window_step
from ground_fusion_tpu_torch.preintegration.imu import noise_cov
from ground_fusion_tpu_torch.preintegration.wheel import wheel_noise_cov
from tests.test_torch_parallel_preint import DT, IMU_NOISE, IMU_TOL, WHEEL_TOL, _check, _t


def _window_buffers(cfg, seed=11):
    """IMU and wheel window buffers at the config's capacities, every
    interval with its own mask (full, empty, prefix, interleaved), as numpy
    field dicts."""
    rng = np.random.default_rng(seed)
    f, ki, kw = cfg.num_frames, cfg.solver.max_imu_per_interval, cfg.solver.max_wheel_per_interval

    def masks(k):
        m = rng.uniform(size=(f, k)) < 0.6
        m[0], m[1], m[2] = True, False, np.arange(k) < k // 3
        return m

    imu = dict(dts=rng.uniform(0.004, 0.006, (f, ki)),
               acc=rng.normal(0, 1.0, (f, ki, 3)) + np.array([0, 0, 9.8]),
               gyr=rng.normal(0, 0.5, (f, ki, 3)), valid=masks(ki),
               acc0=rng.normal(0, 1.0, (f, 3)) + np.array([0, 0, 9.8]),
               gyr0=rng.normal(0, 0.5, (f, 3)))
    wheel = dict(dts=rng.uniform(0.008, 0.012, (f, kw)),
                 vel=rng.normal(0.5, 0.1, (f, kw, 3)) * np.array([1, 0.05, 0.0]),
                 gyr=rng.normal(0, 0.3, (f, kw, 3)), valid=masks(kw),
                 vel0=rng.normal(0.5, 0.1, (f, 3)) * np.array([1, 0.05, 0.0]),
                 gyr0=rng.normal(0, 0.3, (f, 3)), bad=np.zeros(f, bool))
    sbs = np.concatenate([rng.normal(0, 0.1, (f, 3)), rng.normal(0, 0.05, (f, 3)),
                          rng.normal(0, 0.01, (f, 3))], axis=1)
    return imu, wheel, sbs


def test_window_functions_match_jax_at_the_config_capacities():
    """F = 11, 48 IMU and 24 wheel samples per interval, mixed masks: the
    port's window preintegration (log-depth, the default) against the JAX
    package's (jitted) at the single-interval tolerances, and against the
    port's sequential loop (``parallel=False``)."""
    cfg = Config()
    assert (cfg.num_frames, cfg.solver.max_imu_per_interval,
            cfg.solver.max_wheel_per_interval) == (11, 48, 24)
    imu, wheel, sbs = _window_buffers(cfg)
    s_wheel, td = np.array([1.01, 0.99, 1.002]), np.float64(0.003)
    t_ib = buffers.ImuWindowBuffer(**{k: _t(v) for k, v in imu.items()})
    t_wb = buffers.WheelWindowBuffer(**{k: _t(v) for k, v in wheel.items()})
    j_ib = jbuffers.ImuWindowBuffer(**{k: jnp.asarray(v) for k, v in imu.items()})
    j_wb = jbuffers.WheelWindowBuffer(**{k: jnp.asarray(v) for k, v in wheel.items()})

    n18, n12 = noise_cov(*IMU_NOISE, DT), wheel_noise_cov(0.1, 0.02, DT)
    got = buffers.preintegrate_imu_window(t_ib, _t(sbs), n18)
    seq = buffers.preintegrate_imu_window(t_ib, _t(sbs), n18, parallel=False)
    want = jax.jit(jbuffers.preintegrate_imu_window)(j_ib, jnp.asarray(sbs),
                                                     j_noise_cov(*IMU_NOISE, jnp.float64))
    _check(got, want, IMU_TOL)
    _check(got, seq, IMU_TOL)

    got = buffers.preintegrate_wheel_window(t_wb, _t(s_wheel), _t(td), n12)
    seq = buffers.preintegrate_wheel_window(t_wb, _t(s_wheel), _t(td), n12, parallel=False)
    want = jax.jit(jbuffers.preintegrate_wheel_window)(
        j_wb, jnp.asarray(s_wheel), jnp.asarray(td), j_wheel_noise_cov(0.1, 0.02, jnp.float64))
    _check(got, want, WHEEL_TOL)
    _check(got, seq, WHEEL_TOL)


def test_window_step_preintegrates_in_the_log_depth_form(monkeypatch):
    """One window step calls the parallel IMU and wheel forms once each over
    the whole window and the sequential loops never."""
    calls = {"imu": 0, "wheel": 0, "sequential": 0}

    def counting(name, fn):
        def wrapped(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(buffers, "preintegrate_parallel",
                        counting("imu", buffers.preintegrate_parallel))
    monkeypatch.setattr(buffers, "preintegrate_wheel_parallel",
                        counting("wheel", buffers.preintegrate_wheel_parallel))
    monkeypatch.setattr(buffers, "preintegrate", counting("sequential", buffers.preintegrate))
    monkeypatch.setattr(buffers, "preintegrate_wheel",
                        counting("sequential", buffers.preintegrate_wheel))
    cfg = Config()
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, window_size=4, max_landmarks=32, max_iters=1))
    step, _ = make_window_step(cfg, "cpu")
    core, flags = chip_smoke.filled_core(cfg, DT, "cpu")
    _, out = step(core, flags)
    assert bool(torch.isfinite(out["pose"]).all())
    assert calls == {"imu": 1, "wheel": 1, "sequential": 0}
