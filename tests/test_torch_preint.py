"""PyTorch port vs JAX package: IMU and wheel preintegration on the same
numpy-seeded intervals, float64. The port's sequential batched form against
the JAX sequential form (1e-10) and the JAX associative-scan form (1e-8)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.estimator import buffers as jbuf
from ground_fusion_tpu.preintegration import imu as jimu
from ground_fusion_tpu.preintegration import wheel as jwheel
from ground_fusion_tpu_torch.estimator import buffers as tbuf
from ground_fusion_tpu_torch.preintegration import imu as timu
from ground_fusion_tpu_torch.preintegration import wheel as twheel

F, K = 4, 12
RNG = np.random.default_rng(3)
DTS = np.full((F, K), 0.005)
ACC = RNG.normal(0, 1.0, (F, K, 3)) + np.array([0, 0, 9.8])
GYR = RNG.normal(0, 0.3, (F, K, 3))
VEL = RNG.normal(0, 0.5, (F, K, 3)) + np.array([1.0, 0, 0])
VALID = np.ones((F, K), bool)
VALID[1, 9:] = False
VALID[2, :] = False          # an empty interval stays the identity
SBS = np.concatenate([RNG.normal(0, 1, (F, 3)), RNG.normal(0, 0.05, (F, 6))], axis=1)
S_WHEEL = np.array([1.02, 0.97, 1.01])
TD_WHEEL = np.float64(0.003)   # numpy scalars: a Python float would enter JAX weakly typed


def _t(a):
    return torch.as_tensor(a)


# The JAX package's window preintegration, jitted here: eager, its
# associative-scan form dispatches for ~25 s a call; the same function,
# compiled.
_jax_imu_window = jax.jit(jbuf.preintegrate_imu_window, static_argnames="parallel")
_jax_wheel_window = jax.jit(jbuf.preintegrate_wheel_window, static_argnames="parallel")


def _max_err(jtuple, ttuple):
    worst = {}
    for name in jtuple._fields:
        a = np.asarray(getattr(jtuple, name))
        b = getattr(ttuple, name).numpy()
        assert a.shape == b.shape, name
        worst[name] = float(np.abs(a - b).max()) if a.size else 0.0
    return worst


@pytest.fixture(scope="module")
def torch_imu():
    n18 = timu.noise_cov(0.08, 0.004, 4e-5, 2e-6, torch.float64)
    buf = tbuf.ImuWindowBuffer(_t(DTS), _t(ACC), _t(GYR), _t(VALID), _t(ACC[:, 0]), _t(GYR[:, 0]))
    return tbuf.preintegrate_imu_window(buf, _t(SBS), n18)


@pytest.fixture(scope="module")
def torch_wheel():
    n12 = twheel.wheel_noise_cov(0.01, 0.004, torch.float64)
    buf = tbuf.WheelWindowBuffer(_t(DTS), _t(VEL), _t(GYR), _t(VALID), _t(VEL[:, 0]),
                                 _t(GYR[:, 0]), torch.zeros(F, dtype=torch.bool))
    return tbuf.preintegrate_wheel_window(buf, _t(S_WHEEL), _t(TD_WHEEL), n12)


@pytest.mark.parametrize("parallel,tol", [(False, 1e-10), (True, 1e-8)],
                         ids=["sequential", "parallel"])
def test_imu_window_matches_jax(torch_imu, parallel, tol):
    n18 = jimu.noise_cov(0.08, 0.004, 4e-5, 2e-6, jnp.float64)
    buf = jbuf.ImuWindowBuffer(*[jnp.asarray(a) for a in
                                 (DTS, ACC, GYR, VALID, ACC[:, 0], GYR[:, 0])])
    want = _jax_imu_window(buf, jnp.asarray(SBS), n18, parallel=parallel)
    worst = _max_err(want, torch_imu)
    assert max(worst.values()) <= tol, worst


@pytest.mark.parametrize("parallel,tol", [(False, 1e-10), (True, 1e-8)],
                         ids=["sequential", "parallel"])
def test_wheel_window_matches_jax(torch_wheel, parallel, tol):
    n12 = jwheel.wheel_noise_cov(0.01, 0.004, jnp.float64)
    buf = jbuf.WheelWindowBuffer(*[jnp.asarray(a) for a in
                                   (DTS, VEL, GYR, VALID, VEL[:, 0], GYR[:, 0])],
                                 bad=jnp.zeros(F, bool))
    want = _jax_wheel_window(buf, jnp.asarray(S_WHEEL), jnp.asarray(TD_WHEEL), n12,
                             parallel=parallel)
    worst = _max_err(want, torch_wheel)
    assert max(worst.values()) <= tol, worst


def test_single_interval_equals_batch_row(torch_imu, torch_wheel):
    """The unbatched call (no leading axis) gives the batch's row: 1e-14."""
    n18 = timu.noise_cov(0.08, 0.004, 4e-5, 2e-6, torch.float64)
    sb_prev = np.roll(SBS, 1, axis=0)
    one = timu.preintegrate(_t(DTS[1]), _t(ACC[1]), _t(GYR[1]), _t(VALID[1]), _t(ACC[1, 0]),
                            _t(GYR[1, 0]), _t(sb_prev[1, 3:6]), _t(sb_prev[1, 6:9]), n18)
    for name in one._fields:
        assert (getattr(one, name) - getattr(torch_imu, name)[1]).abs().max() <= 1e-14, name
    n12 = twheel.wheel_noise_cov(0.01, 0.004, torch.float64)
    s = _t(S_WHEEL)
    onew = twheel.preintegrate_wheel(_t(DTS[1]), _t(VEL[1]), _t(GYR[1]), _t(VALID[1]),
                                     _t(VEL[1, 0]), _t(GYR[1, 0]), s[0], s[1], s[2],
                                     _t(TD_WHEEL), n12)
    for name in onew._fields:
        assert (getattr(onew, name) - getattr(torch_wheel, name)[1]).abs().max() <= 1e-14, name


def test_bias_and_intrinsic_corrections_match_jax(torch_imu, torch_wheel):
    """First-order corrected deltas at perturbed biases / intrinsics: 1e-12."""
    n18 = jimu.noise_cov(0.08, 0.004, 4e-5, 2e-6, jnp.float64)
    sb_prev = np.roll(SBS, 1, axis=0)
    jpre = jimu.preintegrate(*[jnp.asarray(a) for a in (
        DTS[1], ACC[1], GYR[1], VALID[1], ACC[1, 0], GYR[1, 0], sb_prev[1, 3:6],
        sb_prev[1, 6:9])], n18)
    ba, bg = sb_prev[1, 3:6] + 0.01, sb_prev[1, 6:9] - 0.002
    want = jimu.bias_corrected_delta(jpre, jnp.asarray(ba), jnp.asarray(bg))
    tpre = timu.ImuPreint(*[a[1] for a in torch_imu])
    got = timu.bias_corrected_delta(tpre, _t(ba), _t(bg))
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w) - g.numpy()).max() <= 1e-12

    n12 = jwheel.wheel_noise_cov(0.01, 0.004, jnp.float64)
    jw = jwheel.preintegrate_wheel(*[jnp.asarray(a) for a in (
        DTS[1], VEL[1], GYR[1], VALID[1], VEL[1, 0], GYR[1, 0], S_WHEEL[0], S_WHEEL[1],
        S_WHEEL[2], TD_WHEEL)], n12)
    args = tuple(np.float64(v) for v in (1.03, 0.98, 1.0, 0.004))
    want = jwheel.wheel_corrected_delta(jw, *[jnp.asarray(a) for a in args])
    tw = twheel.WheelPreint(*[a[1] for a in torch_wheel])
    got = twheel.wheel_corrected_delta(tw, *[_t(a) for a in args])
    for w, g in zip(want, got):
        assert np.abs(np.asarray(w) - g.numpy()).max() <= 1e-12
