"""PyTorch port vs JAX package: factor linearization. ``assemble_rows`` is
compared entry for entry (J and r) on the synthetic window problem at
``window_size=4`` in float64 (``max_landmarks=48`` for the comparison, 16 for
the ground-truth case), and the rows vanish at ground truth. Also holds the helpers the other ``test_torch_*`` files share.
"""

import contextlib
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.estimator import assembly as jasm
from ground_fusion_tpu.estimator.layout import StateLayout as JLayout
from ground_fusion_tpu.estimator.step import base_free_mask as jbase_free_mask
from ground_fusion_tpu.preintegration.imu import ImuPreint as JImuPreint
from ground_fusion_tpu.preintegration.wheel import WheelPreint as JWheelPreint
from ground_fusion_tpu.sim import synthetic as jsim
from ground_fusion_tpu.sim.synthetic import SimParams, build_window_problem
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.estimator import assembly as tasm
from ground_fusion_tpu_torch.estimator import buffers as tbuf
from ground_fusion_tpu_torch.estimator.layout import StateLayout as TLayout
from ground_fusion_tpu_torch.preintegration.imu import noise_cov as tnoise_cov
from ground_fusion_tpu_torch.preintegration.wheel import wheel_noise_cov as twheel_noise_cov
from ground_fusion_tpu_torch.utils import convert

JD, TD = jnp.float64, torch.float64
FOCAL = 460.0


_JITTED_SIM = {}


@contextlib.contextmanager
def jitted_jax_simulator():
    """The JAX package's simulator sample functions swapped for jitted ones
    (built once per process) while the block runs, and put back after it:
    eager, one ``build_window_problem`` dispatches for 5-25 s. The same
    functions, compiled: values may differ from eager dispatch in the last
    bits. (Jitting ``project_landmarks`` as well moved the landmarks by such
    bits and flipped ``test_torch_solver.py::test_marginalize_second_new_matches_jax``,
    whose rank-deficient prior amplifies rounding; it stays eager.)"""
    names = ("imu_sample", "wheel_sample", "gt_pose7", "gt_velocity")
    if not _JITTED_SIM:
        _JITTED_SIM.update({n: jax.jit(getattr(jsim, n), static_argnums=1) for n in names})
    mp = pytest.MonkeyPatch()
    try:
        for n in _JITTED_SIM:
            mp.setattr(jsim, n, _JITTED_SIM[n])
        yield
    finally:
        mp.undo()


def small_cfg(cls, window_size=4, max_landmarks=16, **top):
    cfg = cls()
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, window_size=window_size,
                                        max_landmarks=max_landmarks), **top)


def perturbed(state, seed=0, pos=0.02, ang=0.01, vel=0.02):
    """The JAX window state with seeded noise on poses and velocities."""
    from ground_fusion_tpu.estimator.window import retract

    f = state.poses.shape[0]
    layout = JLayout(f, 0)
    rng = np.random.default_rng(seed)
    d = np.zeros(layout.total)
    per = d[: 15 * f].reshape(f, 15)
    per[:, 0:3] = rng.normal(0, pos, (f, 3))
    per[:, 3:6] = rng.normal(0, ang, (f, 3))
    per[:, 6:9] = rng.normal(0, vel, (f, 3))
    return retract(state, jnp.asarray(d), layout)


class Problem:
    """One synthetic window in both packages: JAX values and, through
    ``utils/convert.py``, the identical values as the port's tensors."""

    def __init__(self, window_size=4, max_landmarks=16, pix_noise=0.0, perturb_seed=None,
                 with_prior=False):
        self.jcfg = small_cfg(JConfig, window_size, max_landmarks)
        self.tcfg = small_cfg(TConfig, window_size, max_landmarks)
        sp = SimParams(pix_noise=pix_noise)
        with jitted_jax_simulator():
            prob = build_window_problem(self.jcfg, sp, t_start=0.0, dtype=JD)
        f = self.jcfg.num_frames
        self.f = f
        self.jlayout = JLayout(f, max_landmarks)
        self.tlayout = TLayout(f, max_landmarks)
        state = prob["state"]
        if perturb_seed is not None:
            state = perturbed(state, perturb_seed)
        self.jstate, self.jtracks = state, prob["tracks"]
        self.jimu_buf, self.jwheel_buf = prob["imu_buf"], prob["wheel_buf"]
        # The preintegrated deltas are inputs here, not what these files
        # test (test_torch_preint.py holds them against the JAX package), so
        # they are computed once, by the port, and handed to both sides: the
        # JAX package's eager preintegration costs most of a minute a process.
        get = jax.device_get
        c = self.tcfg
        self.tstate = convert.state_from_numpy(get(self.jstate), "cpu", TD)
        timu_pre = tbuf.preintegrate_imu_window(
            convert.imu_buffer_from_numpy(get(self.jimu_buf), "cpu", TD), self.tstate.sbs,
            tnoise_cov(c.imu.acc_n, c.imu.gyr_n, c.imu.acc_w, c.imu.gyr_w, dtype=TD))
        twheel_pre = tbuf.preintegrate_wheel_window(
            convert.wheel_buffer_from_numpy(get(self.jwheel_buf), "cpu", TD),
            self.tstate.s_wheel, self.tstate.td_wheel,
            twheel_noise_cov(c.wheel.vel_n, c.wheel.gyr_n, dtype=TD))
        self.jimu_pre = JImuPreint(**{k: jnp.asarray(v) for k, v in convert.to_numpy(timu_pre).items()})
        self.jwheel_pre = JWheelPreint(
            **{k: jnp.asarray(v) for k, v in convert.to_numpy(twheel_pre).items()})
        valid = jnp.asarray(np.arange(f) >= 1)
        jprior = jasm.empty_prior(self.jlayout, f, JD)
        if with_prior:
            rng = np.random.default_rng(11)
            nx = self.jlayout.nx
            A = rng.normal(0, 1.0, (nx, nx)) * 3.0
            jprior = jasm.MargPrior(
                J0=jnp.asarray(np.triu(A)), r0=jnp.asarray(rng.normal(0, 0.1, nx)),
                lin=perturbed(prob["state"], 5, pos=0.005, ang=0.002, vel=0.005),
                valid=jnp.asarray(True))
        self.jinp = jasm.SolveInputs(
            imu_pre=self.jimu_pre, imu_valid=valid, wheel_pre=self.jwheel_pre,
            wheel_valid=valid, plane_valid=jnp.ones(f, bool), td_obs=jnp.zeros(f, JD),
            prior=jprior, g=jnp.array([0.0, 0.0, sp.g_norm], JD),
            free_mask=jnp.asarray(jbase_free_mask(self.jcfg, self.jlayout), JD),
        )
        self.scale = FOCAL / 1.5
        self.plane_info = np.array([100.0, 100.0, 20.0])

        self.ttracks = convert.tracks_from_numpy(get(self.jtracks), "cpu", TD)
        self.tinp = tasm.SolveInputs(
            imu_pre=timu_pre,
            imu_valid=torch.as_tensor(np.array(valid)),
            wheel_pre=twheel_pre,
            wheel_valid=torch.as_tensor(np.array(valid)),
            plane_valid=torch.ones(f, dtype=torch.bool),
            td_obs=torch.zeros(f, dtype=TD),
            prior=convert.prior_from_numpy(get(jprior), "cpu", TD),
            g=torch.tensor([0.0, 0.0, sp.g_norm], dtype=TD),
            free_mask=torch.as_tensor(np.array(self.jinp.free_mask)),
        )

    def jax_args(self):
        return (self.jlayout, jnp.asarray(self.scale, JD), jnp.asarray(1.0, JD),
                jnp.asarray(self.plane_info, JD))

    def torch_args(self):
        return (self.tlayout, torch.tensor(self.scale, dtype=TD), torch.tensor(1.0, dtype=TD),
                torch.as_tensor(self.plane_info))


@pytest.fixture(scope="module")
def noisy():
    # 48 slots give about ten live landmarks; 16 would leave one
    return Problem(max_landmarks=48, pix_noise=1e-3, perturb_seed=0, with_prior=True)


@pytest.fixture(scope="module")
def exact():
    return Problem()


def test_assemble_rows_entry_for_entry(noisy):
    """J and r of every factor class, entry for entry: 1e-9 relative to the
    largest entry (whitened rows reach ~1e5)."""
    layout, *scalars = noisy.jax_args()
    Jj, rj = jax.jit(lambda s, t, i, *a: jasm.assemble_rows(s, t, i, layout, *a))(
        noisy.jstate, noisy.jtracks, noisy.jinp, *scalars)
    Jt, rt = tasm.assemble_rows(noisy.tstate, noisy.ttracks, noisy.tinp, *noisy.torch_args())
    Jj, rj = np.asarray(Jj), np.asarray(rj)
    assert Jj.shape == tuple(Jt.shape) and rj.shape == tuple(rt.shape)
    assert np.abs(Jj).max() > 1.0 and np.count_nonzero(Jj) > 500
    assert np.abs(Jj - Jt.numpy()).max() <= 1e-9 * np.abs(Jj).max()
    assert np.abs(rj - rt.numpy()).max() <= 1e-9 * max(1.0, np.abs(rj).max())


def test_residual_probe_matches_rows_and_jax(noisy):
    """The residual-only probe equals the rows' residual (1e-10) and the JAX
    package's probe (1e-9 relative)."""
    _, r_rows = tasm.assemble_rows(noisy.tstate, noisy.ttracks, noisy.tinp, *noisy.torch_args())
    r_probe = tasm.assemble_residuals(noisy.tstate, noisy.ttracks, noisy.tinp, *noisy.torch_args())
    assert (r_rows - r_probe).abs().max() <= 1e-10 * max(1.0, float(r_rows.abs().max()))
    want = np.asarray(jasm.assemble_residuals(noisy.jstate, noisy.jtracks, noisy.jinp,
                                              *noisy.jax_args()))
    assert np.abs(want - r_probe.numpy()).max() <= 1e-9 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("which", ["imu", "wheel", "visual"])
def test_rows_vanish_at_ground_truth(exact, which):
    """Whitened residuals of the exact trajectory (bounds of tests/test_solver.py)."""
    p = exact
    if which == "imu":
        _, r = tasm.linearize_imu(p.tstate, p.tinp.imu_pre, p.tinp.imu_valid, p.tinp.g, p.tlayout)
        bound = 1e-3
    elif which == "wheel":
        _, r = tasm.linearize_wheel(p.tstate, p.tinp.wheel_pre, p.tinp.wheel_valid, p.tlayout)
        bound = 1e-3
    else:
        _, r = tasm.linearize_visual(p.tstate, p.ttracks, p.tinp.td_obs, p.tlayout,
                                     torch.tensor(p.scale, dtype=TD), torch.tensor(1.0, dtype=TD))
        bound = 1e-6
    assert float(r.abs().max()) < bound


def test_masked_factors_with_nan_payload_stay_out(noisy):
    """A padded landmark carrying NaN must not poison J or r (where-masking)."""
    tr = noisy.ttracks
    dead = int((~tr.active).nonzero()[0]) if bool((~tr.active).any()) else None
    if dead is None:
        tr = tr._replace(active=torch.cat([tr.active[:-1], torch.zeros(1, dtype=torch.bool)]))
        dead = tr.active.shape[0] - 1
    obs = tr.obs.clone()
    obs[dead] = float("nan")
    inv = tr.inv_depth.clone()
    inv[dead] = 0.0
    J, r = tasm.linearize_visual(noisy.tstate, tr._replace(obs=obs, inv_depth=inv),
                                 noisy.tinp.td_obs, noisy.tlayout,
                                 torch.tensor(noisy.scale, dtype=TD), torch.tensor(1.0, dtype=TD))
    assert bool(torch.isfinite(J).all()) and bool(torch.isfinite(r).all())
