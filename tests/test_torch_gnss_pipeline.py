"""PyTorch port vs JAX package: tight GNSS through the whole estimator pump.

The GNSS stream of ``tests/test_pipeline.py::_run_gnss_pipeline`` (exact
projected landmarks, IMU and wheel samples, 10 satellites with tropospheric
delay, receiver clocks and drift) is fed frame by frame to both
``Estimator``s in float64 at ``window_size=4``, ``max_landmarks=32``,
``track_num_thresh=1``, with a short outage after alignment: per-frame poses
within 1e-6, GNSS-VI alignment at the same frame, the same yaw, anchor,
valid slots and receiver clocks; and one window step of the JAX package's
core, carried into the port by ``utils/convert.py``, agrees within 1e-8.

Once GNSS-VI alignment has happened the port's window step no longer
re-anchors the window's yaw and position (``estimator/step.py``, ROADMAP
queue 3), where the JAX package's always does; for these comparisons the JAX
package's window step runs with the same rule (:func:`_jax_reanchor_until_aligned`).
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu.config import Config as JConfig
from ground_fusion_tpu.pipeline import Estimator as JEstimator
from ground_fusion_tpu.pipeline import FrameFeature as JFeature
from ground_fusion_tpu_torch.config import Config as TConfig
from ground_fusion_tpu_torch.gnss.coords import ecef2rotation
from ground_fusion_tpu_torch.pipeline import Estimator as TEstimator
from ground_fusion_tpu_torch.pipeline import FrameFeature as TFeature
from ground_fusion_tpu_torch.scripts.parity import GnssTruth, feed_sensors, simulator_drive
from ground_fusion_tpu_torch.sim import synthetic as tsim
from ground_fusion_tpu_torch.utils import convert
from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

N_FRAMES = 14
OUTAGE = (10, 12)          # frames without an epoch, after alignment


def _small(config_cls):
    cfg = config_cls()
    return dataclasses.replace(
        cfg, solver=dataclasses.replace(cfg.solver, window_size=4, max_landmarks=32),
        gnss=dataclasses.replace(cfg.gnss, enabled=True, track_num_thresh=1))


def _jax_reanchor_until_aligned(state_before, state_after):
    """The JAX package's re-anchor, skipped once GNSS-VI alignment has
    installed an ENU yaw (which stays exactly 0 until then: no factor
    touches it) — the port's rule, keyed there on its ``gnss_ready`` flag."""
    from ground_fusion_tpu.estimator import solver as jsolver

    out = jsolver.reanchor_yaw(state_before, state_after)
    aligned = state_before.yaw_enu != 0.0
    return out._replace(poses=jnp.where(aligned, state_after.poses, out.poses),
                        sbs=jnp.where(aligned, state_after.sbs, out.sbs))


def _record_last_gnss_step(est):
    """Keep the inputs and outputs of the estimator's last window step that
    ran with the GNSS gate open."""
    box = {}
    inner = est.step_fn

    def wrapped(core, flags):
        out = inner(core, flags)
        if bool(np.asarray(flags.gnss_ready)):
            box.update(core=core, flags=flags, out=out)
        return out

    est.step_fn = wrapped
    return box


@pytest.fixture(scope="module")
def replay():
    from ground_fusion_tpu.estimator import step as jstep

    from ground_fusion_tpu import pipeline as jpipeline

    mp = pytest.MonkeyPatch()
    mp.setattr(jstep, "reanchor_yaw", _jax_reanchor_until_aligned)   # read when the step is traced
    # the JAX estimator's window preintegration, jitted for the replay (eager,
    # the wheel's associative scan dispatches for ~40 s); the same function,
    # compiled
    mp.setattr(jpipeline, "preintegrate_imu_window", jax.jit(jpipeline.preintegrate_imu_window))
    mp.setattr(jpipeline, "preintegrate_wheel_window", jax.jit(jpipeline.preintegrate_wheel_window))
    try:
        return _replay()
    finally:
        mp.undo()


def _replay():
    je = JEstimator(_small(JConfig), dtype=jnp.float64)
    je.native = None                      # Python queues in both, as the port has them
    te = TEstimator(_small(TConfig), dtype=torch.float64, device="cpu")
    last = _record_last_gnss_step(je)
    truth = GnssTruth(tsim.SimParams())
    poses, gt, aligned_at = [], [], {"jax": None, "torch": None}
    for k, fr in enumerate(simulator_drive(N_FRAMES)):
        t = fr["t"]
        for e in (je, te):
            feed_sensors(e, fr)
        if not OUTAGE[0] <= k < OUTAGE[1]:
            ep = truth.epoch(t)
            je.input_gnss(t, copy.deepcopy(ep))
            te.input_gnss(t, copy.deepcopy(ep))
        feats = fr["feats"].items()
        pj = je.input_frame(t, {i: JFeature(x=x, y=y, depth=d) for i, (x, y, d) in feats})
        pt = te.input_frame(t, {i: TFeature(x=x, y=y, depth=d) for i, (x, y, d) in feats})
        assert (pj is None) == (pt is None), f"frame {k}: only one estimator gave a pose"
        for name, e in (("jax", je), ("torch", te)):
            if e.gnss_aligned and aligned_at[name] is None:
                aligned_at[name] = k
        if pj is not None:
            poses.append((np.asarray(pj), np.asarray(pt)))
            gt.append((t, fr["gt"]))
    return je, te, poses, gt, aligned_at, truth, last


def test_gnss_replay_poses_match_jax_per_frame(replay):
    """Every solved frame's pose within 1e-6, f64; both align at the same
    frame, before the outage; no reboot; ATE below the repo's 0.1 m."""
    je, te, poses, gt, aligned_at, _, _ = replay
    assert aligned_at["torch"] is not None and aligned_at["torch"] < OUTAGE[0]
    assert aligned_at["jax"] == aligned_at["torch"]
    assert len(poses) == N_FRAMES - 4 and te.reboots == 0
    for k, (pj, pt) in enumerate(poses):
        assert np.abs(pj - pt).max() <= 1e-6, f"solved frame {k}"
    assert je.keyframe_flags == te.keyframe_flags
    ate = ate_rmse(np.stack([pt[0:3] for _, pt in poses]), np.stack([g[0:3] for _, g in gt]))
    assert ate < 0.1


def test_gnss_replay_global_state_matches_jax(replay):
    """Yaw within 1e-9 rad, absolute anchor within 1e-6 m, the same valid
    GNSS slots, receiver clocks within 1e-6; and the newest pose maps to its
    true ECEF position within the repo's 1.0 m."""
    je, te, poses, gt, _, truth, _ = replay
    yaw_j, yaw_t = float(np.asarray(je.core.state.yaw_enu)), float(te.core.state.yaw_enu)
    assert abs(yaw_j - yaw_t) <= 1e-9
    anc_j, anc_t = np.asarray(je.anchor_ecef()), te.anchor_ecef()
    assert np.abs(anc_j - anc_t).max() <= 1e-6
    assert np.array_equal(np.asarray(je.core.gnss_obs.valid), te.core.gnss_obs.valid.numpy())
    assert te.core.gnss_obs.valid.any()
    ddt_j, ddt_t = np.asarray(je.core.state.rcv_ddt), te.core.state.rcv_ddt.numpy()
    assert np.abs(ddt_j - ddt_t).max() <= 1e-6
    # the stream observes constellations 0 and 3; the other two are seen only
    # by the clock chain, which fixes their frame-to-frame changes but not
    # their level — a null direction of the window's normal equations, where
    # each package's rounding lands differently — so those two are compared
    # up to one common offset per constellation
    dt_j, dt_t = np.asarray(je.core.state.rcv_dt), te.core.state.rcv_dt.numpy()
    seen = [0, 3]
    assert np.abs(dt_j[:, seen] - dt_t[:, seen]).max() <= 1e-6
    d = dt_j[:, [1, 2]] - dt_t[:, [1, 2]]
    assert np.abs(d - d.mean(axis=0)).max() <= 1e-6
    cy, sy = np.cos(yaw_t), np.sin(yaw_t)
    R_est = ecef2rotation(anc_t) @ np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    t_last, p_last = te.trajectory[-1]
    assert np.linalg.norm(anc_t + R_est @ p_last[0:3] - truth.p_ecef(t_last)) < 1.0
    # the host's copy of the anchor column is the state's
    assert np.array_equal(te._anc_delta, te.core.state.anc_ecef.numpy())


def test_one_step_from_the_converted_jax_core_matches(replay):
    """The last GNSS-gated window step of the JAX package, re-run by the port
    on the same core and flags carried over by ``utils/convert.py``: outputs
    and the new core within 1e-8."""
    je, te, _, _, _, _, last = replay
    assert last, "no window step ran with the GNSS gate open"
    core = convert.core_from_numpy(jax.device_get(last["core"]), "cpu", torch.float64)
    flags = convert.flags_from_numpy(jax.device_get(last["flags"]), "cpu", torch.float64)
    assert core.gnss_obs is not None and bool(flags.gnss_ready)
    core_new, out = te.step_fn(core, flags)
    j_core, j_out = jax.device_get(last["out"])
    for name in ("pose", "sb", "poses"):
        assert np.abs(np.asarray(j_out[name]) - out[name].numpy()).max() <= 1e-8, name
    got = convert.core_to_numpy(core_new)
    for part in ("state", "gnss_obs"):
        want = getattr(j_core, part)
        for name in type(want)._fields:
            a, b = np.asarray(getattr(want, name)), np.asarray(got[part][name])
            assert a.shape == b.shape and np.abs(a.astype(np.float64) - b).max() <= 1e-8, \
                f"{part}.{name}"


def test_gnss_host_state_carries_over(replay):
    """``utils/convert.gnss_host_state_from`` gives a fresh port estimator the
    JAX estimator's anchor, track counts, epochs and gates."""
    je, _, _, _, _, _, _ = replay
    fresh = TEstimator(_small(TConfig), dtype=torch.float64, device="cpu")
    convert.gnss_host_state_from(je, fresh)
    assert fresh.gnss_aligned and not fresh._first_gnss_opt
    assert np.array_equal(fresh.gnss.anc0, je.gnss.anc0)
    assert np.array_equal(fresh.gnss.R0, je.gnss.R0)
    assert fresh.gnss.track_count == je.gnss.track_count
    assert [len(e) for e in fresh.gnss.epochs] == [len(e) for e in je.gnss.epochs]
    assert np.array_equal(fresh._anc_delta, np.asarray(je.core.state.anc_ecef))
    assert np.abs(fresh.gnss.anchor_ecef(fresh._anc_delta) - je.anchor_ecef()).max() <= 1e-9


def _newest_ecef_error(est, world, gt_path):
    """ECEF error of an estimator's newest pose (either package's)."""
    yaw = float(np.asarray(est.core.state.yaw_enu))
    cy, sy = np.cos(yaw), np.sin(yaw)
    anc = np.asarray(est.anchor_ecef())
    R = ecef2rotation(anc) @ np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
    t_last, p_last = est.trajectory[-1]
    gt = np.loadtxt(gt_path, ndmin=2)
    p_true = gt[np.argmin(np.abs(gt[:, 0] - t_last)), 1:4]
    return float(np.linalg.norm(anc + R @ np.asarray(p_last)[0:3] - world.ecef(p_true)))


@pytest.mark.slow
def test_gnss_smoke_sequence_through_both_clis(tmp_path):
    """The GNSS drive of ``chip_smoke.py`` (phase 7; 30 frames here) through
    both CLIs on the CPU with ``configs/m2dgrp.yaml`` unchanged, float32:
    both align, on the same number of poses, with an ATE below 0.1 m. The
    port also keeps it below 5 % of the path and puts the newest pose within
    1 m of its true ECEF position. The JAX package misses both there (its
    float32 prior holds the GNSS columns through alignment and its re-anchor
    undoes the GNSS yaw, ROADMAP queue 3); its numbers are printed beside the
    port's."""
    import os

    import chip_smoke
    from ground_fusion_tpu.__main__ import run as jrun
    from ground_fusion_tpu_torch.__main__ import run as trun

    seq = str(tmp_path / "seq")
    world = chip_smoke.render_gnss_sequence(seq, n_frames=30)
    results = {}
    for name, run, kw in (("jax", jrun, {}), ("torch", trun, {"device": "cpu"})):
        out = str(tmp_path / name)
        system = run(chip_smoke.GNSS_CONFIG_PATH, seq, out, **kw)
        n, ate, path = chip_smoke.trajectory_ate(os.path.join(out, "vio.txt"),
                                                 os.path.join(seq, "gt.csv"))
        est = system.estimator
        assert est.gnss_aligned, name
        err = _newest_ecef_error(est, world, os.path.join(seq, "gt.csv"))
        results[name] = (n, ate, path, err)
        print(f"{name}: {n} poses over {path:.4f} m, ATE {ate:.5f} m, newest pose {err:.4f} m "
              f"from its true ECEF position")
        assert ate < 0.1, name
    assert results["jax"][0] == results["torch"][0]
    _, ate, path, err = results["torch"]
    assert ate < 0.05 * path and err < 1.0
