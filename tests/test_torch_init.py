"""PyTorch port vs JAX package: the general initializer (visual SfM, path C)
and the hand-eye extrinsic bootstrap, float64 on the CPU.

The windows are the ``prob`` (alignments) and ``prob_slow`` (SfM and the
estimator; ω = 0.12, 512 landmark slots) problems of ``tests/test_init.py``,
built once each by the JAX package's simulator and carried into the port
with ``utils/convert.py``. The RANSAC draws of both packages are the JAX
package's own Gumbel draws, so hypothesis counts, inlier sets and the picked
candidates can be compared exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.estimator import initialization as jinit
from ground_fusion_tpu.estimator import sfm as jsfm
from ground_fusion_tpu.estimator.buffers import preintegrate_imu_window as jpre_imu
from ground_fusion_tpu.estimator.buffers import preintegrate_wheel_window as jpre_wheel
from ground_fusion_tpu import pipeline as jpipeline
from ground_fusion_tpu.geometry import so3 as jso3
from ground_fusion_tpu.pipeline import Estimator as JEstimator
from ground_fusion_tpu.preintegration.imu import noise_cov as jnoise_cov
from ground_fusion_tpu.preintegration.wheel import wheel_noise_cov as jwheel_noise_cov
from ground_fusion_tpu.sim import synthetic as jsim
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.estimator import initialization as tinit
from ground_fusion_tpu_torch.estimator import sfm as tsfm
from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
from ground_fusion_tpu_torch.utils import convert
from test_torch_assembly import jitted_jax_simulator

JD, TD = jnp.float64, torch.float64


def _t(x):
    return torch.as_tensor(np.array(x), dtype=TD) if np.asarray(x).dtype.kind == "f" \
        else torch.as_tensor(np.array(x))


def jax_draws(key, n):
    """The Gumbel draws the JAX package's ``relative_pose_ransac`` makes from
    ``key``: one row per hypothesis key, [32, n] float64."""
    keys = jax.random.split(key, tsfm.N_HYPOTHESES)
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (n,), JD))(keys))


def _with_slots(cfg, wheel=True):
    cfg = dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver, max_landmarks=512))
    if not wheel:
        cfg = dataclasses.replace(cfg, wheel=dataclasses.replace(cfg.wheel, enabled=False))
    return cfg


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


@pytest.fixture(scope="module")
def jitted_sim(monkeypatch_module):
    """The JAX package's simulator, preintegration and SfM helpers, jitted
    for this file (eager, one window build dispatches for ~25 s and one
    visual initialization for ~60 s); the same functions, compiled."""
    mp = monkeypatch_module
    pre_imu, pre_wheel = jax.jit(jpre_imu), jax.jit(jpre_wheel)
    mp.setattr(jpipeline, "preintegrate_imu_window", pre_imu)
    mp.setattr(jpipeline, "preintegrate_wheel_window", pre_wheel)
    mp.setattr(jsfm, "pnp_gn", jax.jit(jsfm.pnp_gn, static_argnames="iters"))
    mp.setattr(jsfm, "_sfm_triangulate_all", jax.jit(jsfm._sfm_triangulate_all))
    return pre_imu, pre_wheel


def _build(jitted_sim, cfg, sp, for_alignment):
    pre_imu, pre_wheel = jitted_sim
    with jitted_jax_simulator():
        p = jsim.build_window_problem(cfg, sp, dtype=JD)
    n18 = jnoise_cov(cfg.imu.acc_n, cfg.imu.gyr_n, cfg.imu.acc_w, cfg.imu.gyr_w, JD)
    if for_alignment:
        # the alignment oracle's preints: at the true gyro bias, zero accel bias
        sbs = jnp.zeros_like(p["state"].sbs).at[:, 6:9].set(jnp.asarray(sp.bg, JD))
        n12 = jwheel_noise_cov(cfg.wheel.vel_n, cfg.wheel.gyr_n, JD)
        p["imu_pre"] = pre_imu(p["imu_buf"], sbs, n18)
        p["wheel_pre"] = pre_wheel(p["wheel_buf"], p["state"].s_wheel, p["state"].td_wheel, n12)
    else:
        # at zero bias: the pre-init state
        p["imu_pre0"] = pre_imu(p["imu_buf"], jnp.zeros_like(p["state"].sbs), n18)
    p["cfg"], p["sp"] = cfg, sp
    return p


@pytest.fixture(scope="module")
def prob(jitted_sim):
    """``tests/test_init.py``'s ``prob`` window (the alignment oracle's)."""
    return _build(jitted_sim, JConfig(), jsim.SimParams(), for_alignment=True)


@pytest.fixture(scope="module")
def prob_slow(jitted_sim):
    """``tests/test_init.py``'s ``prob_slow`` window (the SfM oracle's)."""
    p = _build(jitted_sim, _with_slots(JConfig()), jsim.SimParams(omega=0.12), for_alignment=False)
    p["ttracks"] = convert.tracks_from_numpy(jax.device_get(p["tracks"]), "cpu", TD)
    return p


# ------------------------------------------------------------ alignments


@pytest.mark.parametrize("variant", ["wheel", "mono", "depth", "wd"])
def test_linear_alignment_variants_match_jax(prob, variant):
    """The four VisualIMUAlignment systems of ``test_linear_alignment_variants``
    (tests/test_init.py:75) on the same inputs: ok, gravity, velocities and
    scale within 1e-10 — mono within 1e-9: its normal matrix has a
    condition number of ~8e9 here (scale is weakly observable on a circle
    at constant speed), and the two LU solves' rounding shows at 1.5e-10."""
    st = prob["state"]
    jargs = dict(Rs=jso3.quat_to_mat(st.poses[:, 3:7]), Ts=st.poses[:, 0:3], tic=st.ex_cam[0:3])
    targs = {k: _t(v) for k, v in jargs.items()}
    tpre = convert.imu_preint_from_numpy(jax.device_get(prob["imu_pre"]), "cpu", TD)
    twheel = convert.wheel_preint_from_numpy(jax.device_get(prob["wheel_pre"]), "cpu", TD)
    tio, rio = st.ex_wheel[0:3], jso3.quat_to_mat(st.ex_wheel[3:7])
    g = prob["sp"].g_norm
    if variant in ("wheel", "wd"):
        jfn = getattr(jinit, f"linear_alignment_{variant}")
        tfn = getattr(tinit, f"linear_alignment_{variant}")
        want = jfn(jargs["Rs"], jargs["Ts"], prob["imu_pre"], prob["wheel_pre"], jargs["tic"],
                   tio, rio, g)
        got = tfn(targs["Rs"], targs["Ts"], tpre, twheel, targs["tic"], _t(tio), _t(rio), g)
    else:
        jfn = getattr(jinit, f"linear_alignment_{variant}")
        tfn = getattr(tinit, f"linear_alignment_{variant}")
        want = jfn(jargs["Rs"], jargs["Ts"], prob["imu_pre"], jargs["tic"], g)
        got = tfn(targs["Rs"], targs["Ts"], tpre, targs["tic"], g)
    assert bool(want[0]) == bool(got[0]) is True
    tol = 1e-9 if variant == "mono" else 1e-10
    for name, w, t in zip(("g", "vels", "s"), want[1:], got[1:]):
        assert np.abs(np.asarray(w) - t.numpy()).max() <= tol, name


def _hand_eye_pairs(seed, degenerate=False, n=24):
    """The relative-rotation pairs of
    ``test_calibrate_extrinsic_rotation_recovers_ric`` (tests/test_init.py:172)."""
    rng = np.random.default_rng(seed)
    axis = rng.standard_normal(3)
    axis /= np.linalg.norm(axis)
    q_ric = jnp.asarray([np.cos(0.45), *(np.sin(0.45) * axis)], JD)
    qs = []
    for _ in range(n):
        a = rng.standard_normal(3)
        a /= np.linalg.norm(a)
        if degenerate:
            a = np.array([1.0, 0.0, 0.0])
        t = rng.uniform(0.05, 0.5)
        qs.append([np.cos(t / 2), *(np.sin(t / 2) * a)])
    q_imu = jnp.asarray(np.array(qs), JD)
    q_cam = jso3.quat_mul(jso3.quat_mul(jso3.quat_conj(q_ric)[None], q_imu), q_ric[None])
    q_cam = jso3.quat_normalize(q_cam + jnp.asarray(0.002 * rng.standard_normal((n, 4))))
    valid = np.ones(n, bool)
    valid[::7] = degenerate      # a few masked pairs in the well-posed case
    return q_cam, q_imu, jnp.asarray(valid)


@pytest.mark.parametrize("degenerate", [False, True], ids=["observable", "one_axis"])
def test_calibrate_extrinsic_rotation_matches_jax(degenerate):
    """Hand-eye calibration on the oracle's pairs: ric within 1e-10, the
    observability gate equal. Rotations about one axis leave a plane of
    solutions, from which the two eigensolvers may pick different ones: the
    gate trips in both, and ric is not compared."""
    q_cam, q_imu, valid = _hand_eye_pairs(7, degenerate)
    ric_j, ok_j = jinit.calibrate_extrinsic_rotation(q_cam, q_imu, valid)
    ric_t, ok_t = tinit.calibrate_extrinsic_rotation(_t(q_cam), _t(q_imu), _t(valid))
    assert bool(ok_j) == bool(ok_t) == (not degenerate)
    if not degenerate:
        assert np.abs(np.asarray(ric_j) - ric_t.numpy()).max() <= 1e-10


# ------------------------------------------------------------------ SfM


def test_relative_pose_ransac_matches_jax(prob_slow):
    """Pivot pair (0, F-1) of the oracle window, the JAX package's draws:
    inlier mask and ``ok`` equal, pose within 1e-8."""
    tr, ttr = prob_slow["tracks"], prob_slow["ttracks"]
    f = prob_slow["cfg"].num_frames
    both = tr.obs_valid[:, 0] & tr.obs_valid[:, f - 1]
    key = jax.random.PRNGKey(0)
    pose_j, inl_j, ok_j = jsfm.relative_pose_ransac(tr.obs[:, 0, 0:2], tr.obs[:, f - 1, 0:2],
                                                    both, key)
    noise = torch.as_tensor(jax_draws(key, tr.obs.shape[0]))
    pose_t, inl_t, ok_t = tsfm.relative_pose_ransac(ttr.obs[:, 0, 0:2], ttr.obs[:, f - 1, 0:2],
                                                    _t(both), noise)
    assert bool(ok_j) == bool(ok_t) is True
    assert np.array_equal(np.asarray(inl_j), inl_t.numpy())
    assert np.abs(np.asarray(pose_j) - pose_t.numpy()).max() <= 1e-8


def test_minimal_sets_with_few_valid_rows_fill_in_index_order():
    """``jax.lax.top_k`` over ``where(valid, noise, -inf)`` with fewer than 8
    valid rows takes the -inf rows lowest index first; so does the port."""
    rng = np.random.default_rng(3)
    noise = rng.gumbel(size=(4, 20))
    valid = np.zeros(20, bool)
    valid[[3, 11, 17]] = True
    want = jax.lax.top_k(jnp.where(jnp.asarray(valid), noise, -jnp.inf), 8)[1]
    got = tsfm.minimal_sets(_t(noise), _t(valid), 8)
    assert np.array_equal(np.sort(np.asarray(want), 1), np.sort(got.numpy(), 1))


def test_find_pivot_frame_matches_jax(prob_slow):
    assert jsfm.find_pivot_frame(prob_slow["tracks"]) == tsfm.find_pivot_frame(prob_slow["ttracks"]) == 0
    # a window whose frames all lack correspondences to the newest: no pivot
    lost = prob_slow["ttracks"]._replace(obs_valid=torch.zeros_like(prob_slow["ttracks"].obs_valid))
    jlost = prob_slow["tracks"]._replace(obs_valid=jnp.zeros_like(prob_slow["tracks"].obs_valid))
    assert jsfm.find_pivot_frame(jlost) == tsfm.find_pivot_frame(lost) == -1


@pytest.mark.parametrize("use_depth", [False, True], ids=["mono", "depth"])
def test_sfm_construct_matches_jax(prob_slow, use_depth):
    """Global SfM over the oracle window (``test_sfm_construct``,
    tests/test_init.py:140) with the JAX package's draws: every frame's
    camera pose within 1e-6, both ok."""
    key = jax.random.PRNGKey(1)
    poses_j, ok_j = jsfm.sfm_construct(prob_slow["tracks"], key, use_depth=use_depth)
    noise = torch.as_tensor(jax_draws(key, prob_slow["ttracks"].obs.shape[0]))
    poses_t, ok_t = tsfm.sfm_construct(prob_slow["ttracks"], noise, use_depth=use_depth)
    assert ok_j and ok_t
    assert np.abs(np.asarray(poses_j) - poses_t.numpy()).max() <= 1e-6


# -------------------------------------------------------- the estimator


class JaxDraws:
    """Stands in for ``Estimator.draw_ransac_noise``: the draws the JAX
    package's estimator makes, in the same order. ``split`` is how each
    call's key is made: the visual initializer hands its key to
    ``sfm_construct`` as it is, the hand-eye bootstrap splits a subkey off
    ``PRNGKey(0)`` for every frame pair."""

    def __init__(self, key, split):
        self.key, self.split = key, split

    def __call__(self, n, generator):
        key = self.key
        if self.split:
            self.key, key = jax.random.split(self.key)
        return torch.as_tensor(jax_draws(key, n))


def _estimators(prob_slow, cfg_j, cfg_t):
    """Both estimators holding the oracle window before initialization:
    ground-truth poses and sample buffers, zero biases."""
    je = JEstimator(cfg_j, dtype=JD)
    st = prob_slow["state"]._replace(sbs=jnp.zeros_like(prob_slow["state"].sbs))
    je.core = je.core._replace(state=st, tracks=prob_slow["tracks"], imu_buf=prob_slow["imu_buf"],
                               wheel_buf=prob_slow["wheel_buf"])
    je.ts = [float(t) for t in prob_slow["ts"]]
    te = TEstimator(cfg_t, dtype=TD, device="cpu")
    te.core = convert.core_from_numpy(jax.device_get(je.core), "cpu", TD)
    te.ts = list(je.ts)
    return je, te


def _state_close(je, te, tol):
    jst = jax.device_get(je.core.state)
    for name in jst._fields:
        want = np.asarray(getattr(jst, name), np.float64)
        got = getattr(te.core.state, name).numpy().astype(np.float64)
        assert np.abs(want - got).max() <= tol, name


@pytest.mark.parametrize("wheel", [True, False], ids=["wheel_depth", "depth"])
def test_visual_initialize_matches_jax(prob_slow, wheel):
    """Path C on the same window in both estimators (the pivot RANSAC fed
    the JAX package's draws from ``PRNGKey(len(ts))``): SfM, gyro bias,
    the wheel+depth or depth alignment, gravity alignment — the resulting
    state within 1e-8."""
    je, te = _estimators(prob_slow, _with_slots(JConfig(), wheel), _with_slots(TConfig(), wheel))
    te.draw_ransac_noise = JaxDraws(jax.random.PRNGKey(len(je.ts)), split=False)
    tpre = convert.imu_preint_from_numpy(jax.device_get(prob_slow["imu_pre0"]), "cpu", TD)
    assert je._visual_initialize(prob_slow["imu_pre0"]) is True
    assert te._visual_initialize(tpre) is True
    _state_close(je, te, 1e-8)


def test_wheel_init_with_hand_eye_bootstrap_matches_jax(prob_slow, monkeypatch):
    """``solver.calibrate_extrinsic``: the wheel-excitation initializer runs
    the hand-eye bootstrap, one RANSAC per adjacent frame pair fed the JAX
    package's draws. The relative rotations and IMU rotations handed to the
    calibration within 1e-8 of the JAX package's, the gate equal, and the
    resulting state within 1e-8. (This window turns about the vertical only,
    so the gate trips in both and the camera mount stays as configured.)"""
    import ground_fusion_tpu_torch.pipeline as tpipeline

    def cal(cfg):
        return dataclasses.replace(cfg, solver=dataclasses.replace(cfg.solver,
                                                                   calibrate_extrinsic=True))

    seen = {}

    def spy(name, fn):
        def wrapped(q_cam, q_imu, valid):
            seen[name] = [np.asarray(x) if name == "jax" else x.numpy() for x in (q_cam, q_imu)]
            out = fn(q_cam, q_imu, valid)
            seen[name + "_ok"] = bool(out[1])
            return out
        return wrapped

    monkeypatch.setattr(jinit, "calibrate_extrinsic_rotation",
                        spy("jax", jinit.calibrate_extrinsic_rotation))
    monkeypatch.setattr(tpipeline, "calibrate_extrinsic_rotation",
                        spy("torch", tinit.calibrate_extrinsic_rotation))
    je, te = _estimators(prob_slow, cal(_with_slots(JConfig())), cal(_with_slots(TConfig())))
    te.draw_ransac_noise = JaxDraws(jax.random.PRNGKey(0), split=True)
    tpre = convert.imu_preint_from_numpy(jax.device_get(prob_slow["imu_pre0"]), "cpu", TD)
    assert je._wheel_excitation_init(je.core.state, prob_slow["imu_pre0"]) is True
    assert te._wheel_excitation_init(te.core.state, tpre) is True
    assert len(seen["jax"][0]) == len(seen["torch"][0]) >= 3
    for want, got in zip(seen["jax"], seen["torch"]):
        assert np.abs(want - got).max() <= 1e-8
    assert seen["jax_ok"] == seen["torch_ok"] is False
    _state_close(je, te, 1e-8)


def _no_wheel_cfg():
    """``tests/test_pipeline.py::_no_wheel_cfg(use_depth=True)``: no wheel,
    the stationary gate closed (only path C can initialize), the camera
    mount of the simulator, 256 landmark slots."""
    from ground_fusion_tpu_torch.sim.synthetic import body_T_cam

    cfg = TConfig()
    q_ic = tuple(float(v) for v in body_T_cam(torch.float64)[3:7])
    return dataclasses.replace(
        cfg, use_depth=True,
        wheel=dataclasses.replace(cfg.wheel, enabled=False),
        init=dataclasses.replace(cfg.init, stationary_acc_var=0.0),
        camera=dataclasses.replace(cfg.camera, q_ic=q_ic),
        solver=dataclasses.replace(cfg.solver, max_landmarks=256))


N_REPLAY = 16


@pytest.mark.slow
def test_path_c_replay_through_the_port_estimator():
    """``tests/test_pipeline.py::test_e2e_visual_init_rgbd_short`` through
    the port's own ``Estimator`` (float64, CPU): exact RGB-D features and
    IMU samples of a drive that moves from the first frame, no wheel; the
    visual initializer starts it, and the ATE stays below 0.08 m. ~26 s in
    one process, more than this file and ``test_torch_map.py`` may add to
    the fast selection together, so it is ``slow``; ``chip_smoke.py`` phase
    8 drives path C through the port at full width on the card."""
    from ground_fusion_tpu_torch.pipeline import FrameFeature
    from ground_fusion_tpu_torch.sim import synthetic as tsim
    from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

    sp = tsim.SimParams()
    est = TEstimator(_no_wheel_cfg(), dtype=TD, device="cpu")
    calls = []
    inner = est._visual_initialize
    est._visual_initialize = lambda *a: calls.append(inner(*a)) or calls[-1]
    ex = tsim.body_T_cam(TD)
    pts_w = torch.as_tensor(tsim.make_landmarks(600, sp, seed=1), dtype=TD)
    frame_dt, imu_dt = 1.0 / sp.frame_rate, 1.0 / sp.imu_rate
    acc, gyr = (x.numpy() for x in tsim.imu_samples(np.asarray([0.0]), sp))
    est.input_imu(0.0, acc[0], gyr[0])
    gt = {}
    for k in range(N_REPLAY):
        t = k * frame_dt
        if k:
            ts = np.arange(t - frame_dt + imu_dt, t + 0.5 * imu_dt, imu_dt)
            acc, gyr = (x.numpy() for x in tsim.imu_samples(ts, sp))
            for ti, a, g in zip(ts, acc, gyr):
                est.input_imu(float(ti), a, g)
        pose = tsim.gt_pose7(t, sp)
        uv, z, vis = (x.numpy() for x in tsim.project_landmarks(pose, ex, pts_w))
        est.input_frame(t, {int(i): FrameFeature(x=float(uv[i, 0]), y=float(uv[i, 1]),
                                                 depth=float(z[i])) for i in np.nonzero(vis)[0]})
        gt[t] = pose.numpy()
    assert calls and calls[-1] is True and calls.count(True) == 1
    assert len(est.trajectory) >= 4 and est.reboots == 0
    est_xyz = np.stack([p[0:3] for _, p in est.trajectory])
    gt_xyz = np.stack([gt[t][0:3] for t, _ in est.trajectory])
    ate = ate_rmse(est_xyz, gt_xyz)
    assert ate < 0.08, f"ATE {ate:.4f} m (visual init, RGBD, exact measurements)"
