"""The port's execution modes at the pipeline level: ``Estimator`` replays of
the simulator drive (``scripts/parity.py::simulator_drive``, the feature
stream of ``tests/test_pipeline.py::run_pipeline``) per frame, in live mode
and in burst mode, against the port's own per-frame path (which
``test_torch_pipeline.py`` holds to the JAX package), on the cases of
``tests/test_burst.py``, in float64 on the CPU at ``window_size=4``,
``max_landmarks=32`` and 2 dogleg iterations:

- burst 5 and live mode match the per-frame replay within 1e-3 m (one
  estimator replayed to NON_LINEAR, then copied into the three modes);
- a staged frame makes no device read, a flush one upload per dtype family
  and one fetch;
- a failure inside a chunk truncates its odometry and reboots;
- with lines, the burst's line-slot writes and mirrors give the per-frame
  line table.

Under ``-m slow``: the GNSS drive of ``test_torch_gnss_pipeline.py`` in
burst mode (the auto-flush on pending epochs and before alignment) against
per frame; and the port's burst replay against the JAX package's
``run_pipeline(burst=5)`` on the same inputs (the only test that compiles a
JAX burst program).
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

torch.set_num_threads(1)      # small tensors; leave the cores to the other test workers

from ground_fusion_tpu_torch.config import Config
from ground_fusion_tpu_torch.estimator.step import make_window_burst_ingest
from ground_fusion_tpu_torch.pipeline import Estimator
from ground_fusion_tpu_torch.scripts.parity import GnssTruth, feed_drive, simulator_drive
from ground_fusion_tpu_torch.sim import synthetic as tsim
from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

DT = torch.float64
N_FRAMES = 11          # the drive: a window of 4 fills by frame 4, then 6 solved frames
AFTER = N_FRAMES - 5   # frames after the first solve


def _small(**kw):
    cfg = Config(**kw)
    return dataclasses.replace(cfg, solver=dataclasses.replace(
        cfg.solver, window_size=4, max_landmarks=32, max_iters=2))


# ------------------------------------------------------------ pipeline level


class _Traffic:
    """Counts an estimator's device reads and uploads, by kind."""

    def __init__(self, est):
        self.masks, self.fetches, self.uploads = [], [], []
        for name, log in (("_fetch_track_masks", self.masks), ("_fetch", self.fetches),
                          ("_upload", self.uploads)):
            inner = getattr(est, name)

            def wrapped(*a, _inner=inner, _log=log, **k):
                _log.append(1)
                return _inner(*a, **k)

            setattr(est, name, wrapped)


@pytest.fixture(scope="module")
def drive():
    return simulator_drive(N_FRAMES, n_landmarks=60)


@pytest.fixture(scope="module")
def started(drive):
    """One estimator replayed until its first solve (NON_LINEAR)."""
    cfg = _small()
    est = Estimator(cfg, dtype=DT, device="cpu")
    feed_drive(est, drive, range(cfg.num_frames))
    assert est.solver_flag == Estimator.NON_LINEAR and len(est.trajectory) == 1
    return est


@pytest.fixture(scope="module")
def modes(started, drive):
    """The rest of the drive per frame, in live mode and in burst 5."""
    out = {}
    for mode in ("frame", "live", "burst5"):
        est = copy.deepcopy(started)
        if mode == "live":
            est.enable_live()
        elif mode == "burst5":
            est.enable_burst(5)
        traffic = _Traffic(est)
        returned = feed_drive(est, drive, range(started.cfg.num_frames, N_FRAMES))
        out[mode] = (est, traffic, returned)
    return out


def test_live_and_burst_match_per_frame(modes, drive):
    """The same number of poses, each within 1e-3 m of the per-frame pose,
    the same keyframe decisions, ATE < 0.05 m (``tests/test_burst.py:56,
    75``)."""
    ref = modes["frame"][0]
    xyz = np.stack([p[0:3] for _, p in ref.trajectory])
    for mode in ("live", "burst5"):
        est = modes[mode][0]
        est.flush_burst()
        assert len(est.trajectory) == len(ref.trajectory) == AFTER + 1
        got = np.stack([p[0:3] for _, p in est.trajectory])
        assert np.abs(got - xyz).max() <= 1e-3, mode
        assert est.keyframe_flags == ref.keyframe_flags, mode
        gt = {fr["t"]: fr["gt"] for fr in drive}
        assert ate_rmse(got, np.stack([gt[t][0:3] for t, _ in est.trajectory])) < 0.05
        assert est.reboots == 0


def test_staged_frames_make_no_device_read(modes):
    """Per frame: one mask fetch a frame. Live: every frame flushed at once
    (chunks of 1), nothing left staged. Burst 5 over 6 frames: chunks of 5
    and (at the end) 1; no frame fetched the masks; each flush made one
    upload per dtype family (floats, masks, slot indices) and one fetch,
    and the mirrors were read once, at the first staged frame."""
    est, traffic, returned = modes["frame"]
    assert len(traffic.masks) == AFTER
    est, traffic, returned = modes["live"]
    assert est._burst_xs == [] and est._burst_flushed_sizes == [1] * AFTER
    assert all(p is not None for p in returned)
    assert traffic.masks == [] and len(traffic.uploads) == 3 * AFTER
    assert len(traffic.fetches) == 1 + AFTER
    est, traffic, returned = modes["burst5"]
    assert est._burst_flushed_sizes[0] == 5 and len(est._burst_xs) in (0, AFTER - 5)
    assert [p is not None for p in returned] == [False] * 4 + [True] + [False] * (AFTER - 5)
    assert traffic.masks == []
    assert len(traffic.uploads) == 3 * len(est._burst_flushed_sizes)
    assert len(traffic.fetches) == 1 + len(est._burst_flushed_sizes)
    assert sum(est._burst_flushed_sizes) + len(est._burst_xs) == AFTER


def test_burst_per_frame_failure_truncates_and_reboots(started, drive):
    """Three frames staged (chunk 50), then flushed through a burst whose
    gyro-bias failure threshold sits below estimation noise: every step
    reports failed, so the flush emits no odometry and reboots
    (``tests/test_burst.py:287``)."""
    est = copy.deepcopy(started)
    est.enable_burst(50)
    feed_drive(est, drive, range(est.cfg.num_frames, est.cfg.num_frames + 3))
    assert len(est._burst_xs) == 3, "frames did not stage"
    n_before = len(est.trajectory)
    tight = dataclasses.replace(est.cfg, solver=dataclasses.replace(est.cfg.solver,
                                                                    fail_bg_thresh=1e-7))
    est._burst_fn, _ = make_window_burst_ingest(tight, "cpu")
    assert est.flush_burst() is None
    assert len(est.trajectory) == n_before, "failed frames leaked odometry"
    assert est.solver_flag == est.INITIAL and est.reboots == 1
    assert est._burst_xs == [] and not est._mirror_synced


def test_burst_with_lines_matches_per_frame():
    """``use_line`` with 8 line slots, ``min_obs`` 4 and six segments: a line
    enters at frame 8 and triangulates by frame 11. One estimator per frame
    up to frame 7, then frames 8-11 per frame and as one burst of 4: poses
    within 1e-3 m, the same line slots active, their lines within 2e-3
    (``tests/test_burst.py:96``)."""
    exn = tsim.body_T_cam(DT).numpy()
    cfg = _small(use_line=True)
    cfg = dataclasses.replace(
        cfg, lines=dataclasses.replace(cfg.lines, max_lines=8, min_obs=4),
        camera=dataclasses.replace(cfg.camera, t_ic=tuple(exn[0:3]), q_ic=tuple(exn[3:7])))
    drive = simulator_drive(12, n_landmarks=100, segments=6)
    assert [k for k, fr in enumerate(drive) if fr["lines"]] == [8, 9, 10, 11]
    est = Estimator(cfg, dtype=DT, device="cpu")
    feed_drive(est, drive, range(8))
    runs = {}
    for chunk in (0, 4):
        e = copy.deepcopy(est)
        if chunk:
            e.enable_burst(chunk)
        feed_drive(e, drive, range(8, 12))
        e.flush_burst()
        runs[chunk] = e
    a, b = runs[0], runs[4]
    assert b._burst_flushed_sizes == [4]
    assert len(a.trajectory) == len(b.trajectory)
    pa = np.stack([p[0:3] for _, p in a.trajectory])
    pb = np.stack([p[0:3] for _, p in b.trajectory])
    assert np.abs(pa - pb).max() <= 1e-3
    assert torch.equal(a.core.lines.active, b.core.lines.active)
    act = a.core.lines.active
    assert int((act & a.core.lines.solve_ok).sum()) >= 1
    assert torch.allclose(a.core.lines.orth[act], b.core.lines.orth[act], atol=2e-3)
    assert a.line_slot_of == b.line_slot_of


# ------------------------------------------------------------------- slow


@pytest.mark.slow
def test_gnss_burst_replay_matches_per_frame():
    """The GNSS drive of ``test_torch_gnss_pipeline.py`` (an epoch every frame
    but an outage after alignment) per frame and in burst 4: a frame with a
    pending epoch, or before GNSS-VI alignment, flushes the chunk and runs
    per frame; chunks form only in the outage. Poses within 1e-3 m, the
    same alignment frame, yaw and anchor."""
    from tests.test_torch_gnss_pipeline import N_FRAMES as G_FRAMES, OUTAGE, _small as g_small
    from ground_fusion_tpu_torch.config import Config as TConfig

    tsp = tsim.SimParams()
    truth = GnssTruth(tsp)
    drive = simulator_drive(G_FRAMES + 4, n_landmarks=200)
    runs = {}
    for chunk in (0, 4):
        est = Estimator(g_small(TConfig), dtype=DT, device="cpu")
        if chunk:
            est.enable_burst(chunk)
        aligned_at = None
        for k, fr in enumerate(drive):
            if not OUTAGE[0] <= k < OUTAGE[1] + 4:
                est.input_gnss(fr["t"], copy.deepcopy(truth.epoch(fr["t"])))
            feed_drive(est, drive, [k])
            if est.gnss_aligned and aligned_at is None:
                aligned_at = k
        est.flush_burst()
        runs[chunk] = (est, aligned_at)
    (a, al_a), (b, al_b) = runs[0], runs[4]
    assert al_a == al_b is not None and al_a < OUTAGE[0]
    assert any(s > 1 for s in b._burst_flushed_sizes)
    assert len(a.trajectory) == len(b.trajectory)
    pa = np.stack([p[0:3] for _, p in a.trajectory])
    pb = np.stack([p[0:3] for _, p in b.trajectory])
    assert np.abs(pa - pb).max() <= 1e-3
    assert abs(float(a.core.state.yaw_enu) - float(b.core.state.yaw_enu)) <= 1e-6
    assert np.abs(a.anchor_ecef() - b.anchor_ecef()).max() <= 1e-3


@pytest.mark.slow
def test_burst_replay_matches_the_jax_package():
    """The port's burst 5 against the JAX package's ``run_pipeline(n_frames=24,
    burst=5)`` (default config, 200 landmarks, float64) on the same inputs:
    every pose within 1e-3 m, the same number of poses."""
    from tests.test_pipeline import run_pipeline

    est_j, _ = run_pipeline(n_frames=24, burst=5)
    drive = simulator_drive(24, n_landmarks=200)
    est = Estimator(Config(), dtype=DT, device="cpu")
    est.enable_burst(5)
    feed_drive(est, drive, range(24))
    est.flush_burst()
    assert len(est.trajectory) == len(est_j.trajectory)
    pj = np.stack([np.asarray(p)[0:3] for _, p in est_j.trajectory])
    pt = np.stack([p[0:3] for _, p in est.trajectory])
    assert np.abs(pj - pt).max() <= 1e-3
