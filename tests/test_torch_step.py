"""PyTorch port vs JAX package: one whole window step from the identical
core, carried across with ``utils/convert.py``, for both marginalization
branches, float64, ``window_size=4``, ``max_landmarks=96``. (With fewer
landmarks the prior's block of pose F-2 is rank-deficient, its ridge-sized
eigenvalues sit at the pseudo-inverse's clipping threshold, and the
second-new prior amplifies rounding by 1e7 in both packages alike.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.estimator.assembly import empty_prior as jempty_prior
from ground_fusion_tpu.estimator.step import EstimatorCore as JCore
from ground_fusion_tpu.estimator.step import StepFlags as JFlags
from ground_fusion_tpu.estimator.step import make_window_step as jmake
from ground_fusion_tpu_torch.estimator.step import make_window_step as tmake
from ground_fusion_tpu_torch.utils import convert
from test_torch_assembly import JD, TD, Problem

TOL = 1e-8


@pytest.fixture(scope="module")
def built():
    """The problem and both packages' window steps, built (and, for the JAX
    package, compiled) once for the whole file."""
    p = Problem(max_landmarks=96, pix_noise=1e-3, perturb_seed=2)
    jstep, jlayout = jmake(p.jcfg)
    tstep, tlayout = tmake(p.tcfg, device="cpu")
    assert jlayout.total == tlayout.total and jlayout.nx == tlayout.nx
    return p, jstep, jlayout, tstep


@pytest.fixture(scope="module")
def steps(built):
    """Three chained steps (old, second-new, old) in both packages; every
    step starts both from the JAX package's core so errors do not add up."""
    p, jstep, jlayout, tstep = built
    core = JCore(state=p.jstate, tracks=p.jtracks, imu_buf=p.jimu_buf, wheel_buf=p.jwheel_buf,
                 prior=jempty_prior(jlayout, p.f, JD))
    f = p.f
    out = []
    for marg_old, propagate in ((True, False), (False, True), (True, True)):
        flags = JFlags(marg_old=jnp.asarray(marg_old), stationary=jnp.asarray(False),
                       wheel_valid=jnp.asarray(np.arange(f) >= 1),
                       imu_valid=jnp.asarray(np.arange(f) >= 1), td_obs=jnp.zeros(f, JD),
                       propagate_newest=jnp.asarray(propagate))
        tcore = convert.core_from_numpy(jax.device_get(core), "cpu", TD)
        tflags = convert.flags_from_numpy(jax.device_get(flags), "cpu", TD)
        jcore2, jout = jstep(core, flags)
        tcore2, tout = tstep(tcore, tflags)
        out.append((marg_old, jax.device_get(jcore2), jax.device_get(jout),
                    convert.core_to_numpy(tcore2), convert.to_numpy(tout)))
        core = jcore2
    return out


@pytest.mark.parametrize("k", [0, 1, 2], ids=["marg_old_first", "marg_second_new", "marg_old_prior"])
def test_step_outputs_match_jax(steps, k):
    """Newest pose, speed-bias, the whole window and the cost: 1e-8."""
    _, _, jout, _, tout = steps[k]
    for key in ("pose", "sb", "poses"):
        assert np.abs(np.asarray(jout[key]) - tout[key]).max() <= TOL, key
    assert abs(float(jout["cost"]) - float(tout["cost"])) <= TOL * max(1.0, float(jout["cost"]))
    assert bool(jout["failed"]) == bool(tout["failed"]) is False


@pytest.mark.parametrize("k", [0, 1, 2], ids=["marg_old_first", "marg_second_new", "marg_old_prior"])
def test_step_core_matches_jax(steps, k):
    """Every field of the slid core: state, tracks and both sample buffers
    within 1e-8 (masks and indices equal); the prior through its quadratic
    form within 1e-8 of its scale."""
    _, jcore, _, tcore, _ = steps[k]
    for grp in ("state", "tracks", "imu_buf", "wheel_buf"):
        jg = getattr(jcore, grp)
        for name in jg._fields:
            a, b = np.asarray(getattr(jg, name)), tcore[grp][name]
            assert a.shape == b.shape, (grp, name)
            if a.dtype == bool or np.issubdtype(a.dtype, np.integer):
                assert np.array_equal(a, b), (grp, name)
            else:
                assert np.abs(a - b).max() <= TOL, (grp, name)
    J0, r0 = np.asarray(jcore.prior.J0), np.asarray(jcore.prior.r0)
    T0, t0 = tcore["prior"]["J0"], tcore["prior"]["r0"]
    Hj, Ht = J0.T @ J0, T0.T @ T0
    assert np.abs(Hj).max() > 1.0
    assert np.abs(Hj - Ht).max() <= TOL * np.abs(Hj).max()
    assert np.abs(J0.T @ r0 - T0.T @ t0).max() <= TOL * max(1.0, np.abs(J0.T @ r0).max())
    assert bool(jcore.prior.valid) == bool(tcore["prior"]["valid"]) is True
    assert np.abs(np.asarray(jcore.prior.lin.poses) - tcore["prior"]["lin"]["poses"]).max() <= TOL


def test_stationary_flag_freezes_the_window(built):
    """The stationary gate stays a tensor: with the host override set the
    frame blocks are frozen and velocities zeroed, as in the JAX package."""
    p, jstep, jlayout, tstep = built
    core = JCore(state=p.jstate, tracks=p.jtracks, imu_buf=p.jimu_buf, wheel_buf=p.jwheel_buf,
                 prior=jempty_prior(jlayout, p.f, JD))
    f = p.f
    flags = JFlags(marg_old=jnp.asarray(True), stationary=jnp.asarray(True),
                   wheel_valid=jnp.asarray(np.arange(f) >= 1),
                   imu_valid=jnp.asarray(np.arange(f) >= 1), td_obs=jnp.zeros(f, JD),
                   propagate_newest=jnp.asarray(True))
    _, jout = jstep(core, flags)
    tcore = convert.core_from_numpy(jax.device_get(core), "cpu", TD)
    _, tout = tstep(tcore, convert.flags_from_numpy(jax.device_get(flags), "cpu", TD))
    assert np.abs(np.asarray(jout["poses"]) - tout["poses"].numpy()).max() <= TOL
    assert torch.equal(tout["poses"], tcore.state.poses)          # frozen
    assert float(tout["sb"][0:3].abs().max()) == 0.0               # velocities zeroed
