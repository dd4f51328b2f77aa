"""PyTorch port vs JAX package, the slice as a whole at a small size (the
rendered-image counterpart is ``test_torch_system.py``).

The feature-stream replay of ``tests/test_pipeline.py`` (exact projected
landmarks, IMU and wheel samples from the simulator) fed frame by frame to
both ``Estimator``s in float64 at ``window_size=4``, ``max_landmarks=32``:
per-frame poses within 1e-6 m, ATE below 0.05 m, once for each of the two
initialization paths the slice ports (the constant-speed circle reads as
stationary to the accelerometer-variance test; one whose speed swings at
4 rad/s takes the wheel-excitation path).

Then the scenarios of ``tests/test_adversarial.py``, where the gates fire, on
the same JAX window program: one drive that stops and goes (the stationary
flag detected from the data) and then crosses a feature-starved stretch,
per frame through both estimators — the same poses, stationary flags,
wheel-anomaly verdicts and failure/reboot decisions; a gyro bias that makes
failure detection reboot both estimators, wheel slip and the varying-speed
drive run under ``-m slow``.
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
from ground_fusion_tpu_torch.estimator import step as tstep_module
from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
from ground_fusion_tpu_torch.pipeline import FrameFeature as TFeature
from ground_fusion_tpu_torch.scripts.parity import feed_sensors, simulator_drive
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


class GateLog:
    """Per-step record of what the window step decided, read from what each
    step returns (no new JAX program): the stationary flag (a stationary
    step zeroes every velocity and freezes the frame blocks, so the solved
    newest velocity is exactly 0) and the wheel-anomaly verdicts the step
    persists in ``wheel_buf.bad``. For the port, the gate's own outputs are
    recorded too (``device_frame_gates``, wrapped while the replay runs)."""

    def __init__(self, est, to_np):
        self.steps = []            # (stationary from the output, bad [F])
        inner = est.step_fn

        def step(core, flags):
            core_new, out = inner(core, flags)
            sb = to_np(out["sb"])
            self.steps.append((bool(np.all(sb[0:3] == 0.0)), to_np(core_new.wheel_buf.bad)))
            return core_new, out

        est.step_fn = step


def _replay(sim_kw, n_frames=N_FRAMES, drop_feats=None, gates=None):
    """Both estimators on the identical sensor and feature stream (the
    port's ``simulator_drive``). Both replays share one JAX window program
    (the same config), compiled once. ``drop_feats(k)`` keeps that fraction
    of frame k's visible features (in id order, as
    ``tests/test_pipeline.py::run_pipeline`` does). With ``gates`` (a list)
    each frame appends both estimators' decisions."""
    jsp = jsim.SimParams(**sim_kw)
    tsp = tsim.SimParams(**sim_kw)
    je = JEstimator(_small(JConfig), dtype=jnp.float64)
    je.step_fn = _JAX_STEP.setdefault("small", je.step_fn)
    je.native = None                      # Python queues in both, as the port has them
    te = TEstimator(_small(TConfig), dtype=torch.float64, device="cpu")
    wheel_init_calls = {"jax": _count_calls(je, "_wheel_excitation_init"),
                        "torch": _count_calls(te, "_wheel_excitation_init")}
    if gates is not None:
        jlog = GateLog(je, lambda a: np.asarray(jax.device_get(a)))
        tlog = GateLog(te, lambda a: a.numpy())
    ex = jsim.body_T_cam(jnp.float64)
    pts_w = jnp.asarray(jsim.make_landmarks(60, jsp, seed=1), jnp.float64)
    drive = simulator_drive(n_frames, n_landmarks=60, sp=tsp)

    poses, gt = [], []
    for k, fr in enumerate(drive):
        # the port's simulator held against the JAX package's: the interval's
        # first samples and the frame's visible features, at 1e-12
        t = fr["t"]
        for (ti, *got), want in ((fr["imu"][0], jsim.imu_sample), (fr["wheel"][0], jsim.wheel_sample)):
            for a, b in zip(got, want(ti, jsp)):
                assert np.abs(a - np.asarray(b)).max() <= 1e-12
        pose_gt = jsim.gt_pose7(t, jsp)
        uv, z, vis = (np.asarray(x) for x in jsim.project_landmarks(pose_gt, ex, pts_w))
        assert list(fr["feats"]) == np.nonzero(vis)[0].tolist()
        assert all(np.abs(np.array(f) - [uv[i, 0], uv[i, 1], z[i]]).max() <= 1e-12
                   for i, f in fr["feats"].items())
        for e in (je, te):
            feed_sensors(e, fr)
        feats = list(fr["feats"].items())
        if drop_feats is not None:
            feats = feats[: max(0, int(round(drop_feats(k) * len(feats))))]
        n_steps = (len(jlog.steps), len(tlog.steps)) if gates is not None else None
        pj = je.input_frame(t, {i: JFeature(x=x, y=y, depth=d) for i, (x, y, d) in feats})
        pt = te.input_frame(t, {i: TFeature(x=x, y=y, depth=d) for i, (x, y, d) in feats})
        assert (pj is None) == (pt is None), f"frame {k}: only one estimator gave a pose"
        if pj is not None:
            poses.append((np.asarray(pj), np.asarray(pt)))
            gt.append(fr["gt"])
        if gates is not None:
            gates.append({
                name: dict(pose=None if p is None else np.asarray(p),
                           step=log.steps[n:] if len(log.steps) > n else None,
                           failed=getattr(e, "_last_out_failed", None),
                           reboots=getattr(e, "reboots", 0),
                           solver_flag=e.solver_flag, keyframes=list(e.keyframe_flags))
                for name, e, p, log, n in (("jax", je, pj, jlog, n_steps[0]),
                                           ("torch", te, pt, tlog, n_steps[1]))})
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
    return (request.param, *_replay(dict(omega_mod_amp=request.param, omega_mod_freq=4.0)))


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


# ---------------------------------------------------------------------------
# where the gates fire (the scenarios of tests/test_adversarial.py)
# ---------------------------------------------------------------------------

# the oracle's stretches, moved up to just after the first solved frame (4)
# of the window of 4 and joined into one drive to share its fill and
# initialization: a full stop over frames 6-10, then 95 % of the features
# gone over frames 12-13; a gyro bias of 1.06 rad/s (above
# fail_bg_thresh) that the first solve recovers, so failure detection
# reboots the estimator once per initialization; wheel slip over frames
# 8-12. ``ate``: the oracle's bound (None: no bound, the bias makes every
# solve fail)
STOP = (6, 10)
STARVED = (12, 14)
SCENARIOS = {
    "stop_and_go_starved": dict(sim=dict(stop_t1=0.5, stop_t2=1.1, stop_tau=0.08),
                                n_frames=16, ate=0.08,
                                drop_feats=lambda k: 0.05 if STARVED[0] <= k < STARVED[1] else 1.0),
    "gyro_bias_reboot": dict(sim=dict(bg=(0.8, 0.7, 0.0)), n_frames=12, ate=None),
    "wheel_slip": dict(sim=dict(slip_t1=0.75, slip_t2=1.25, slip_v=(0.0, 0.35, 0.0)),
                       n_frames=16, ate=0.05),
    "varying_speed": dict(sim=dict(omega_mod_amp=0.25, omega_mod_freq=0.9), n_frames=16,
                          ate=0.05),
}
SLOW = pytest.mark.slow


@pytest.fixture(scope="module", params=[
    "stop_and_go_starved", pytest.param("gyro_bias_reboot", marks=SLOW),
    pytest.param("wheel_slip", marks=SLOW), pytest.param("varying_speed", marks=SLOW)])
def scenario(request, jitted_jax_preintegration):
    """One scenario through both estimators, with each frame's decisions."""
    sc = SCENARIOS[request.param]
    gates = []
    stationary = []
    mp = pytest.MonkeyPatch()
    inner = tstep_module.device_frame_gates

    def recording_gates(*a, **k):
        anomaly, stat = inner(*a, **k)
        stationary.append(bool(stat))
        return anomaly, stat

    mp.setattr(tstep_module, "device_frame_gates", recording_gates)
    try:
        je, te, poses, gt, _ = _replay(sc["sim"], sc["n_frames"], sc.get("drop_feats"), gates)
    finally:
        mp.undo()
    return request.param, je, te, poses, gt, gates, stationary


def test_scenario_poses_match_jax_per_frame(scenario):
    """Every frame: a pose from both or neither, within 1e-6; the same
    keyframe decisions; ATE below the oracle's bound (0.05 m; 0.08 m with
    the feature-starved stretch)."""
    name, je, te, poses, gt, gates, _ = scenario
    assert len(poses) >= 4
    for k, g in enumerate(gates):
        pj, pt = g["jax"]["pose"], g["torch"]["pose"]
        assert (pj is None) == (pt is None), f"frame {k}"
        if pj is not None:
            assert np.abs(pj - pt).max() <= 1e-6, f"frame {k}"
        assert g["jax"]["keyframes"] == g["torch"]["keyframes"], f"frame {k}"
    bound = SCENARIOS[name]["ate"]
    if bound is not None:
        ate = ate_rmse(np.stack([pt[0:3] for _, pt in poses]), np.stack([p[0:3] for p in gt]))
        assert ate < bound, f"ATE {ate:.4f} m"


def test_scenario_gates_match_jax_per_frame(scenario):
    """Every frame: the same stationary flag (the port's gate output, and
    both packages' frozen velocities), the same wheel-anomaly verdicts of the
    whole window (``wheel_buf.bad``), the same failure flag, reboot count
    and solver mode. Where the scenario makes a gate fire, it fires: the
    stop is detected on some frames but not all, the starved stretch turns
    every frame into a keyframe, the gyro bias raises the failure flag and
    reboots both estimators (twice, on the same frames), the slip raises
    the anomaly verdict."""
    name, je, te, poses, gt, gates, stationary = scenario
    n_steps = 0
    for k, g in enumerate(gates):
        j, t = g["jax"], g["torch"]
        assert (j["step"] is None) == (t["step"] is None), f"frame {k}"
        if j["step"] is not None:
            assert len(j["step"]) == len(t["step"]) == 1, f"frame {k}"
            (js, jbad), (ts, tbad) = j["step"][0], t["step"][0]
            assert js == ts == stationary[n_steps], f"frame {k}: stationary"
            assert np.array_equal(jbad, tbad), f"frame {k}: wheel anomaly"
            n_steps += 1
        assert j["failed"] == t["failed"], f"frame {k}: failure flag"
        assert j["reboots"] == t["reboots"] and j["solver_flag"] == t["solver_flag"], f"frame {k}"
    assert n_steps == len(stationary) == len(poses)
    if name == "stop_and_go_starved":
        assert 2 <= sum(stationary) < len(stationary)
        # the estimate holds still while fully stopped (tests/test_adversarial.py)
        stop = [g["torch"]["pose"][0:3] for k, g in enumerate(gates)
                if STOP[0] + 1 <= k <= STOP[1] - 1 and g["torch"]["pose"] is not None]
        assert len(stop) >= 2 and np.linalg.norm(np.ptp(np.stack(stop), axis=0)) < 0.02
        # every starved frame is a keyframe (fewer than 20 tracked features)
        assert all(gates[k]["torch"]["keyframes"][-1] for k in range(*STARVED))
    if name == "wheel_slip":
        assert any(t["step"] and t["step"][0][1].any() for t in (g["torch"] for g in gates))
    if name == "gyro_bias_reboot":
        assert any(g["torch"]["failed"] for g in gates) and gates[-1]["torch"]["reboots"] >= 2
    else:
        assert gates[-1]["torch"]["reboots"] == 0
