"""The port's log-depth preintegration (``preintegration/parallel.py``)
against the JAX package's ``preintegrate_parallel`` and
``preintegrate_wheel_parallel`` (jitted from the test) and against the
port's own sequential form, on the cases of ``tests/test_parallel_preint.py``
at its tolerances, in float64. The window functions and the window step are
in ``test_torch_parallel_window.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.preintegration import parallel as jparallel
from ground_fusion_tpu.preintegration.imu import noise_cov as j_noise_cov
from ground_fusion_tpu.preintegration.wheel import wheel_noise_cov as j_wheel_noise_cov
from ground_fusion_tpu_torch.preintegration.imu import noise_cov, preintegrate
from ground_fusion_tpu_torch.preintegration.parallel import (
    preintegrate_parallel,
    preintegrate_wheel_parallel,
)
from ground_fusion_tpu_torch.preintegration.wheel import preintegrate_wheel, wheel_noise_cov
from tests.test_parallel_preint import _imu_inputs

DT = torch.float64
J_IMU = jax.jit(jparallel.preintegrate_parallel)
J_WHEEL = jax.jit(jparallel.preintegrate_wheel_parallel)
IMU_NOISE = (0.1, 0.01, 0.001, 0.0001)

# the tolerances of tests/test_parallel_preint.py
IMU_TOL = dict(delta_p=1e-12, delta_q=1e-12, delta_v=1e-12, sum_dt=1e-15, jacobian=1e-11,
               covariance=1e-11)
WHEEL_TOL = dict(delta_p=1e-12, delta_q=1e-12, covariance=1e-12, jacobian_ix=1e-10, vel_1=0.0,
                 gyr_1=0.0)


def _t(x):
    return torch.as_tensor(np.array(x))


def _check(got, want, tol):
    for name, atol in tol.items():
        a, b = np.asarray(getattr(want, name)), getattr(got, name).numpy()
        assert a.shape == b.shape and np.abs(a - b).max(initial=0.0) <= atol, name


def _imu_both(inp):
    """The port's parallel and sequential forms and the JAX package's."""
    t_inp = [_t(x) for x in inp]
    par = preintegrate_parallel(*t_inp, noise_cov(*IMU_NOISE, DT))
    seq = preintegrate(*t_inp, noise_cov(*IMU_NOISE, DT))
    jax_out = J_IMU(*inp, j_noise_cov(*IMU_NOISE, jnp.float64))
    return par, seq, jax_out


@pytest.mark.parametrize("n_valid", [32, 17, 1, 0])
def test_imu_parallel_matches_jax_and_the_sequential_form(n_valid):
    par, seq, want = _imu_both(_imu_inputs(32, n_valid))
    _check(par, want, IMU_TOL)
    _check(par, seq, IMU_TOL)


def test_imu_parallel_interleaved_mask():
    """Non-prefix masks (the last-valid gather)."""
    dts, accs, gyrs, _, acc0, gyr0, ba, bg = _imu_inputs(16, seed=3)
    valid = jnp.asarray(np.array([1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 1, 0, 0, 0, 1, 0], bool))
    par, seq, want = _imu_both((dts, accs, gyrs, valid, acc0, gyr0, ba, bg))
    tol = {k: IMU_TOL[k] for k in ("delta_p", "delta_q", "covariance")}
    _check(par, want, tol)
    _check(par, seq, tol)


def _wheel_inputs(n_valid, k=24, seed=7):
    rng = np.random.default_rng(seed)
    dts = rng.uniform(0.008, 0.012, k)
    vels = rng.normal(0.5, 0.1, (k, 3)) * np.array([1, 0.05, 0.0])
    gyrs = rng.normal(0, 0.3, (k, 3))
    valid = np.arange(k) < n_valid
    vel0 = rng.normal(0.5, 0.1, 3) * np.array([1, 0.05, 0.0])
    gyr0 = rng.normal(0, 0.3, 3)
    return [dts, vels, gyrs, valid, vel0, gyr0] + [np.float64(v) for v in (1.01, 0.99, 1.002, 0.0)]


@pytest.mark.parametrize("n_valid", [24, 9, 0])
def test_wheel_parallel_matches_jax_and_the_sequential_form(n_valid):
    inp = _wheel_inputs(n_valid)
    t_inp = [_t(x) for x in inp]
    par = preintegrate_wheel_parallel(*t_inp, wheel_noise_cov(0.1, 0.02, DT))
    seq = preintegrate_wheel(*t_inp, wheel_noise_cov(0.1, 0.02, DT))
    want = J_WHEEL(*[jnp.asarray(x) for x in inp], j_wheel_noise_cov(0.1, 0.02, jnp.float64))
    _check(par, want, WHEEL_TOL)
    _check(par, seq, WHEEL_TOL)
