"""PyTorch port vs JAX package: one whole window step from the identical
core, carried across with ``utils/convert.py``, for both marginalization
branches, float64, ``window_size=4``, ``max_landmarks=96``. (With fewer
landmarks the prior's block of pose F-2 is rank-deficient, its ridge-sized
eigenvalues sit at the pseudo-inverse's clipping threshold, and the
second-new prior amplifies rounding by 1e7 in both packages alike.)

The same problem with line landmarks (``use_line``): 6 line slots at
``min_obs`` 3, three lines already triangulated and three waiting for
triangulation, observed with noise (:func:`_line_table`); three chained
steps — marginalize old with no prior (the solved lines in the solve, then
culled; triangulation gated off), second-new with the prior (triangulation
fires), marginalize old with the prior (frame-0 lines marginalized) — on one
more JAX window program, built once."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.estimator.assembly import empty_prior as jempty_prior
from ground_fusion_tpu.estimator.lines import LineTracks as JLineTracks
from ground_fusion_tpu.estimator.step import EstimatorCore as JCore
from ground_fusion_tpu.estimator.step import StepFlags as JFlags
from ground_fusion_tpu.estimator.step import make_window_step as jmake
from ground_fusion_tpu_torch.estimator.step import make_window_step as tmake
from ground_fusion_tpu_torch.frontend.lines import plk_to_orth, plk_transform
from ground_fusion_tpu_torch.geometry.se3 import pose_apply, pose_compose
from ground_fusion_tpu_torch.sim import synthetic as tsim
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


# ---------------------------------------------------------------------------
# the step with line landmarks
# ---------------------------------------------------------------------------

LL = 6
SOLVED = 3          # slots 0..2 start triangulated, 3..5 wait for it


def _with_lines(cfg):
    return dataclasses.replace(cfg, use_line=True, lines=dataclasses.replace(
        cfg.lines, max_lines=LL, min_obs=3))


def _line_table(p):
    """Line tracks for the problem's window: 0.8 m segments 3-5 m ahead of
    the middle frame's camera (every slot seen in at least 4 frames), noise
    5e-4 on the normalized plane. The last three slots are seen from the
    true poses and wait for triangulation. The first SOLVED slots are seen
    from the window's perturbed poses and hold that line in their anchor
    camera, perturbed by 1e-3: they agree with the window as it enters the
    first step, so its pre-solve cull keeps them and their rows join the
    solve."""
    sp = tsim.SimParams()
    ts = np.arange(p.f) / sp.frame_rate
    ex = tsim.body_T_cam(TD)
    truth = torch.stack([tsim.gt_pose7(float(t), sp) for t in ts])
    window = torch.as_tensor(np.asarray(p.jstate.poses))
    rng = np.random.default_rng(4)
    mid = pose_compose(truth[p.f // 2], ex)
    centre = np.stack([rng.uniform(-1.0, 1.0, 20), rng.uniform(-0.6, 0.6, 20),
                       rng.uniform(3.0, 5.0, 20)], -1)
    d = rng.normal(size=(20, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ends = torch.as_tensor(np.stack([centre - 0.4 * d, centre + 0.4 * d], 1))
    segs = pose_apply(mid, ends)                                           # [N,2,3] world

    def seen_from(poses):
        obs4, vis = zip(*(tsim.project_segments(poses[k], ex, segs) for k in range(p.f)))
        return torch.stack(obs4, 1).numpy(), torch.stack(vis, 1).numpy()  # [N,F,4], [N,F]

    obs_true, vis = seen_from(truth)
    obs_win, vis_win = seen_from(window)
    pick = np.nonzero((vis.sum(1) >= 4) & (vis == vis_win).all(1))[0][:LL]
    assert len(pick) == LL, "too few segments in view"
    obs = np.concatenate([obs_win[pick[:SOLVED]], obs_true[pick[SOLVED:]]])
    obs = obs + 5e-4 * rng.normal(size=(LL, p.f, 4))
    ov = vis[pick]
    start = np.argmax(ov, axis=1)
    orth = np.zeros((LL, 4))
    for l in range(SOLVED):
        cam = pose_compose(window[start[l]], ex)
        a, b = segs[pick[l], 0], segs[pick[l], 1]
        plk_w = torch.cat([torch.linalg.cross(a, b), b - a])
        orth[l] = plk_to_orth(plk_transform(plk_w, cam[3:7], cam[0:3])).numpy()
    orth[:SOLVED] += 1e-3 * rng.normal(size=(SOLVED, 4))
    return JLineTracks(
        orth=jnp.asarray(orth), active=jnp.ones(LL, bool),
        solve_ok=jnp.asarray(np.arange(LL) < SOLVED), start_frame=jnp.asarray(start, jnp.int32),
        obs=jnp.asarray(obs * ov[..., None]), obs_valid=jnp.asarray(ov))


@pytest.fixture(scope="module")
def line_built(built):
    """The file's problem with lines and both packages' window steps with
    ``use_line``, built (and, for the JAX package, compiled) once."""
    p = built[0]
    jcfg, tcfg = _with_lines(p.jcfg), _with_lines(p.tcfg)
    jstep, jlayout = jmake(jcfg)
    tstep, tlayout = tmake(tcfg, device="cpu")
    assert jlayout.total == tlayout.total and tlayout.max_lines == LL
    return p, _line_table(p), jstep, jlayout, tstep


@pytest.fixture(scope="module")
def line_steps(line_built):
    p, lines, jstep, jlayout, tstep = line_built
    core = JCore(state=p.jstate, tracks=p.jtracks, imu_buf=p.jimu_buf, wheel_buf=p.jwheel_buf,
                 prior=jempty_prior(jlayout, p.f, JD), lines=lines)
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
        out.append((jax.device_get(core), jax.device_get(jcore2), jax.device_get(jout),
                    convert.core_to_numpy(tcore2), convert.to_numpy(tout)))
        core = jcore2
    return out


@pytest.mark.parametrize("k", [0, 1, 2], ids=["marg_old_first", "marg_second_new", "marg_old_prior"])
def test_step_with_lines_outputs_match_jax(line_steps, k):
    """Newest pose, speed-bias, the whole window and the cost: 1e-8."""
    _, _, jout, _, tout = line_steps[k]
    for key in ("pose", "sb", "poses"):
        assert np.abs(np.asarray(jout[key]) - tout[key]).max() <= TOL, key
    assert abs(float(jout["cost"]) - float(tout["cost"])) <= TOL * max(1.0, float(jout["cost"]))
    assert bool(jout["failed"]) == bool(tout["failed"]) is False


@pytest.mark.parametrize("k", [0, 1, 2], ids=["marg_old_first", "marg_second_new", "marg_old_prior"])
def test_step_with_lines_core_matches_jax(line_steps, k):
    """Every field of the slid core — state, tracks, lines (``orth``,
    ``solve_ok``, ``active``, slides) — within 1e-8, masks and indices
    equal; the prior through its quadratic form within 1e-8 of its scale."""
    _, jcore, _, tcore, _ = line_steps[k]
    for grp in ("state", "tracks", "lines"):
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
    assert np.abs(Hj - Ht).max() <= TOL * np.abs(Hj).max()
    assert np.abs(J0.T @ r0 - T0.T @ t0).max() <= TOL * max(1.0, np.abs(J0.T @ r0).max())
    assert bool(jcore.prior.valid) == bool(tcore["prior"]["valid"]) is True


def test_line_paths_fire(line_steps):
    """What each step exercises, as both packages run it. First step (no
    prior): the three solved lines pass the pre-solve cull, are refined and
    solved with the window (their ``orth`` moves), then the post-solve cull
    removes them — the solve moves the window toward the truth, ~1e-2 rad
    from the poses they were seen from — and the other three stay
    untriangulated. Second step, with the prior: they triangulate. Third:
    lines anchored at frame 0 are marginalized."""
    before, after, _, tcore, _ = line_steps[0]
    assert np.abs(tcore["lines"]["orth"][:SOLVED] - np.asarray(before.lines.orth)[:SOLVED]).min() > 0
    assert not tcore["lines"]["active"][:SOLVED].any()
    assert not np.asarray(after.lines.solve_ok)[SOLVED:].any()
    before, _, _, tcore, _ = line_steps[1]
    assert not np.asarray(before.lines.solve_ok)[SOLVED:].any()
    assert tcore["lines"]["solve_ok"][SOLVED:].any()
    before = line_steps[2][0].lines
    assert (np.asarray(before.solve_ok) & (np.asarray(before.start_frame) == 0)).any()
