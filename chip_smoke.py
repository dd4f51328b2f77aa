#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA device
    python3 chip_smoke.py --kernels  # phases 1-3 only (a quick kernel check; prints no result line)

Phases (any failure ends the run with a non-zero exit code):

1. device   — require CUDA; print the card's name and power limit.
2. build    — build every CUDA source of the port (``lk_level``, ``hamming``)
              with nvcc (one process per source, started together) and print
              the seconds it took.
3. kernels  — call each kernel entry point's wrapper on GPU tensors at the
              shapes the main path gives it and hold the result against its
              plain PyTorch version on the same inputs: ``lk_level`` (the LK
              kernel with ``levels = 1``) to 1e-3 px at the three level
              shapes; ``lk_track`` (the whole bidirectional 3-level track in
              one launch) against the plain chain to 1e-3 px, its ``ok``
              mask equal away from the gates, timed in turns against the
              six-launch control flow of the previous design and the plain
              chain; ``hamming_matrix`` exactly, identity 0 and complement
              256; ``hamming_match`` (the fused masked match) exactly, also
              with ties and masks. Times per call with CUDA events, device
              time per launch under ``torch.profiler``, each bound, and for
              Hamming ``torch.cdist`` on bit planes.
4. main     — render a 40-frame 640x480 sequence with the port's simulator at
              the intrinsics and sensor mounts of ``configs/groundchallenge.yaml``
              (a vehicle that stands, then drives off along a circle, seen at
              30 frames a second) and run it through
              ``ground_fusion_tpu_torch.__main__.run`` on the GPU with that
              config plus ``loop: {enabled: true}``; check the trajectory, the
              device of the state, the launch counters (one ``lk_track``
              launch per tracked frame), the keyframes of the pose graph and
              ``loop.txt``; print per-stage times.
5. revisit  — drive ``PoseGraph`` (``describe``, ``add_keyframe``,
              ``optimize``; 4-DoF and 6-DoF) through 65 keyframes of 640x480
              images around a drifting loop that revisits five places, and
              the same keyframes through ``GroundFusionSystem``'s keyframe
              hook (each seated in the estimator's window as its step leaves
              it): loop edges form, in the system too, which publishes them;
              the hook's world landmarks are the drive's; every descriptor
              match launched the fused match kernel once; the end error
              falls; print ms per call.
6. solvers  — on a 300-keyframe graph (past ``DENSE_NODE_LIMIT``, so
              ``optimize`` takes the matrix-free PCG solvers) hold the card's
              PCG result against the card's dense solve and the CPU's PCG
              (4-DoF and 6-DoF); quantize descriptors through a synthetic
              DBoW2 vocabulary written with ``save_binary`` and query its
              database on the card and on the CPU: the same words, weights
              and answers.
7. gnss     — render a 32-frame sequence at the intrinsics and wheel mount
              of ``configs/m2dgrp.yaml`` with a GNSS receiver at the IMU
              (10 satellites above the config's elevation mask, drifting GPS
              and BeiDou clocks, troposphere; one epoch per frame in
              ``gnss.csv``, a fix every third frame in ``gps.csv``) and run
              it through ``__main__.run`` on the GPU with that config
              unchanged: GNSS-VI alignment happens, GNSS slots are live,
              the trajectory and the newest pose's ECEF position are right,
              one ``lk_track`` launch per tracked frame, ``global.txt`` has
              a finite pose per solved frame; and the float32
              pseudorange/Doppler rows at ground truth stay below 5 mm on
              the card. Prints per-stage times beside phase 4's.
8. path C   — render a 32-frame sequence at the camera and mounts of
              ``configs/groundchallenge.yaml`` in which the vehicle is
              moving from the first frame, and run it through
              ``__main__.run`` on the GPU with a copy of that config with the
              wheel off, the stationary gate closed, loop closure and the
              dense map with its TSDF mesh on: the visual initializer (SfM,
              path C) starts the estimator and no other initializer runs;
              ATE, no reboot, every map and TSDF tensor on the GPU,
              ``map.ply`` and ``mesh.ply`` written, one ``lk_track`` launch
              per tracked frame; prints the first pose's frame,
              ``sfm_construct`` ms, the ``map`` stage per keyframe.
9. map      — the rebuild scenario of ``tests/test_mapping.py`` at 480x640
              (four keyframes mapped at drifting poses, then re-anchored
              at the true ones; 2^20 voxel slots, a 128^3 TSDF) on the GPU
              and on the CPU: counts and the exported voxel set equal, sums
              and TSDF within their bounds, the rebuild's error under the
              test's bounds; prints ms per insert, integrate, rebuild and
              mesh extraction and the peak device memory.
10. lines   — render a 40-frame drive with the smoke sequence's motion at
              the camera and mounts of ``configs/groundchallenge.yaml``,
              with the simulator's segments (``make_segments``: poles and
              slanted edges) drawn as bright bars, and run it through
              ``__main__.run`` on the GPU with a copy of that config in which
              only ``use_line`` is switched on: ATE, no reboot, the line
              table on the GPU, line slots active and solved at the end,
              line rows live in at least one solve, one ``lk_track`` launch
              per tracked frame and no plain version; the port's
              ``LineTracker`` over the drive's images in float64 on the card
              and on the CPU gives the same ids and endpoints within 1e-6 px.
              Prints the ``track``, ``lines`` and ``solve`` stages beside
              phase 4's and the frame of the first triangulated line (the
              operations of one frame with lines are a CPU count:
              ``tools/count_step_ops.py --use-line``).
11. modes   — the execution modes: (a) phase 4's rendered sequence and
              config through ``__main__.main([..., "--burst", "8"])`` on the
              GPU: as many poses as phase 4, ATE, no reboot, the state on the
              GPU, one ``lk_track`` launch per tracked frame and no plain
              version, every flushed chunk at most 8 frames (one of exactly
              8), no ``_fetch_track_masks`` call on a staged frame (the
              method wrapped here), ``loop.txt`` written; prints ``solve``
              beside phase 4's, frames/s and the largest position
              difference from phase 4's ``vio.txt``; on phase 4's first 24
              frames. (b) Two ``Estimator``s in float64 on the GPU at the
              default config's widths on the simulator drive of
              ``tests/test_pipeline.py`` (no images), 15 frames deep: per
              frame and live, every live pose within 1e-3 m of the
              per-frame pose, live flushing chunks of 1 (the same drive in
              bursts of 8 runs in phase 14f, in float32). (c) The fleet: 4
              filled cores over 2 steps through
              ``make_window_burst_batched`` against four
              ``make_window_burst`` runs at ``tests/test_burst.py``'s
              tolerances; ms per step of both. (d) The log-depth window
              preintegration against the sequential loop at 11 intervals of
              48 IMU and 24 wheel samples, mixed masks, float64, to 1e-10;
              ms per call of both.
12. checkpoint — (a) phase 4's config with the dense map on (no mesh)
              through ``__main__.main`` on the first 15 frames of phase 4's
              sequence with ``--save-state``; ``build_grid`` of the run's
              ``pose_graph.npz`` and ``map.ply``; its first 26 frames with
              ``--resume``, ``--load-graph`` and ``--load-grid``: no frame or
              sensor row at or before the snapshot fed again, post-snapshot
              ATE < 0.05 m and < 5 % of the path, no reboot, the state on the
              GPU, one ``lk_track`` launch per tracked frame and no plain
              version, new tracker ids above the restored ones, the loaded
              keyframes then the new ones in ``loop.txt`` with indices
              continuing, ``prior_grid.pgm`` within 0.02 of ``grid.pgm``;
              prints the largest position difference from phase 4's
              ``vio.txt``. (b) Ten textured keyframes saved, loaded into a
              fresh ``PoseGraph`` on the GPU, a drifted revisit of place 0:
              a loop edge against a loaded keyframe, ``hamming_match``
              launches = matches. (c) Two processes (this script with
              ``--shard-worker``) on the one GPU in a Gloo group: the
              edge-sharded 4-DoF graph against ``optimize_4dof`` to 1e-8 in
              float64, and the sharded fleet of 11c (2 cores a rank) against
              the unsharded fleet at ``tests/test_burst.py``'s tolerances;
              ms per solve and per fleet step. NCCL across cards is not run.
              (d) Two ranks again: the landmark-sharded window step
              (``make_sharded_window_step``, half the landmark and line
              slots a rank) in float64 at full width,
              ``configs/groundchallenge.yaml`` on the filled core of 11c and
              ``configs/m2dgrp.yaml`` with ``use_line`` and the plane on a
              core filled as the JAX driver's dryrun fills its core: both
              branches from the core and the keyframe branch from the
              keyframe step's core, against the unsharded step: poses,
              depths and line coordinates to 1e-8, the prior's J0ᵀJ0 and
              J0ᵀr0 to 1e-5 (or 1e-8 of their scale), slot masks equal,
              both ranks' outputs and replicated state bitwise equal; ms
              per step of both (CUDA events), reductions per step; both
              branches again in float32: finite, the difference printed,
              not gated.
13. dynamic objects and cameras — (b) phase 4's drive cut to 24 frames with
              the checker object of ``tests/test_detector_e2e.py`` (32 px,
              a false depth of 1.2 m, ~1 px a frame, on a mid-grey
              backdrop) walking in at frame 4, through ``__main__.run`` with
              ``use_yolo: true``: the object's features reach the tracker
              (≥ 5 on some frame) and at most 0.2 of them the estimator,
              ATE, no reboot, the detector's weights on the GPU, one
              ``lk_track`` launch per tracked frame; ``detect`` ms beside
              ``track`` and ``solve``. (a) The shipped detector weights on
              the card against the CPU on 10 scenes of the training
              renderer and two frames of (b): features within 2e-2 of their
              scale, detections equal away from the thresholds, recall
              ≥ 0.7 at IoU 0.3; ms per ``detect`` (CUDA events), device ms
              under ``torch.profiler``, peak memory. (c) The five camera
              models' lift and project of 1000 pixels in float64 on the card
              against the CPU (1e-9) and round trips within 1e-3 px; the
              five calibrations of ``tests/test_calibration.py`` on the card
              in float64 within the oracles' bounds, ms each; phase 4's
              scene rendered through the equidistant model (20 frames) and
              run with ``camera.model: equidistant``: ATE, one ``lk_track``
              launch per tracked frame.
14. last modules — (a) the stereo factors ``proj22``/``proj12`` on the card
              in float64 and float32 at the oracle's ground truth
              (``tests/test_solver.py``): residuals below 1e-9 / 1e-3, the
              Jacobians within 1e-9 / 1e-3 of the CPU's. (b) The native ingest
              runtime built with ``g++`` on the machine; seeded IMU and wheel
              pushes (some out of order) drained over ten intervals at three
              caps and paired with ``sync_pairs``, equal to a NumPy drain and
              pairing of the same rows. (c) ``detector.train.train`` on the
              card with the JAX package's schedule (400 steps of 16 scenes,
              seed 0, from ``init_params``): the loss falls, recall ≥ 0.7 at
              IoU 0.3 on phase 13a's 10 scenes; ms a step, peak memory. (d)
              ``scripts.make_synth_seq`` writes 12 frames and
              ``__main__.run`` runs them on the card with
              ``tests/test_full_system.py``'s config: poses, no reboot, one
              ``lk_track`` launch per tracked frame. (e)
              ``scripts.profile_step``'s stage table on a seeded window at
              the widths of ``configs/groundchallenge.yaml`` in float32: host
              and device ms and operations of each stage; the stages that
              the step runs one after another take no more device time
              than the step. (f) ``scripts.parity``'s ``vio_wheel_exact``
              in bursts of 8, float32 on the card, its first 20 frames (a
              full chunk of 8 flushed): ATE
              below 0.05 m. Prints the seconds the phase took.
Each phase prints the seconds it took. Then the card's line, the
``{"kernels": [...]}`` line (one entry per kernel entry point: ``lk_level``,
``lk_track``, ``hamming_matrix``, ``hamming_match``; launches counted on the
paths of phases 4, 5, 7, 8, 10, 11, 12, 13 and 14), and the last line
``{"ok": true, "device": {...}}``.

The script imports only the port (never JAX or the JAX package), needs no
network, and starts no process that outlives it (phase 12c-d's two ranks
are joined with a timeout and killed past it).
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)

# Published peaks of one H100 SXM (NVIDIA data sheet): the roofline's two rates
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12
# __popc throughput of compute capability 9.0 (NVIDIA's CUDA C++ documentation,
# table of arithmetic instruction throughput) and the H100 SXM's SM count
POPC_PER_CLOCK_PER_SM = 16
N_SM = 132

N_FEATURES = 150
LEVEL_SHAPES = [(480, 640), (240, 320), (120, 160)]   # (h, w) of the 3 pyramid levels
HALF, ITERS, MIN_EIG = 10, 10, 1e-4
TRACK_LEVELS, FB_THRESH = 3, 0.5     # the main path's pyramid and round-trip gate
PTS_TOL_PX = 1e-3        # 441-term f32 sums taken in another order than the plain version
GATE_REL = 1e-3          # |eig_min/n - min_eig| / min_eig below which a mask flip is rounding
EDGE_TOL_PX = 1e-4       # a round trip or a point this close to its threshold may flip by rounding
RECORDED_ATE_M = 0.00337     # phase 4's ATE recorded in PERF.md, printed beside this run's
N_FRAMES = 40
# The smoke sequence: the vehicle stands for half a second (so the stationary
# initializer is right to take it for standing), then speeds up to 0.45 m/s on
# a 3 m circle; at 30 frames a second the blobs move about 3 px a frame, which
# the pyramidal tracker follows. 5000 landmarks put ~100 blobs in view.
SMOKE_SIM = dict(omega=0.15, frame_rate=30.0, stop_t1=-5.0, stop_t2=0.5, stop_tau=0.15)
SMOKE_LANDMARKS = 5000
SMOKE_SEED = 0
# ATE bounds of the main path on the smoke sequence: the repo's 0.1 m
# (tests/test_full_system.py) and, because this sequence is short, 5 % of the
# distance travelled over the solved poses as well.
ATE_BOUND_M = 0.1
ATE_BOUND_OF_PATH = 0.05
MIN_TRACKED = 40         # features of the last frame followed over 5 frames or more
MIN_SOLVED_LANDMARKS = 40    # landmarks of the last window with a solved depth
MATCH_THRESH = 80        # the default LoopConfig's Hamming gate
# (Ka, Kb) of hamming_matrix and hamming_match: loop closure's shapes (~100 window descriptors of
# the current keyframe against the old one's 500 FAST + window descriptors, and
# the largest, 128 against 628), a square one, and ragged edges
HAMMING_SHAPES = [(100, 600), (128, 628), (500, 500), (1, 1), (37, 211), (129, 257)]
MIN_LOOP_KEYFRAMES = 5   # keyframes the smoke sequence registers in the pose graph
# The revisit drive: 60 places around a 10 m circle, one keyframe each, then
# 5 keyframes back at places 0-4 (past the default min_loop_gap of 50); the
# VIO yaw drifts 0.002 rad per keyframe. The end error after optimize must
# fall below this share of the error before it.
REVISIT_PLACES, REVISIT_AGAIN, REVISIT_RADIUS = 60, 5, 10.0
REVISIT_YAW_DRIFT = 0.002
REVISIT_LANDMARKS = 100
REVISIT_ERROR_RATIO = 0.6
# The keyframe hook's landmarks against the drive's, through a float32 window
# on the card: positions of ~10 m carry float32 rounding of ~1e-6 m.
HOOK_PTS_TOL_M = 1e-4
HOOK_NORM_TOL = 1e-6
HOOK_PX_TOL = 1e-3
# Where each landmark is anchored in the seated window: a frame 0.3 m behind
# the keyframe's camera, turned 0.05 rad (a different slot than the keyframe's,
# so the hook must take the anchor's pose for the landmark and the keyframe's
# slot for its observation).
ANCHOR_OFFSET_M, ANCHOR_YAW = (0.05, 0.0, -0.3), 0.05
# The solvers phase: 300 keyframes, 5 laps of a 60-keyframe circle, a loop
# edge from every 5th keyframe to the one a lap before; the card's PCG
# against its dense solve and against the CPU's PCG (float64 throughout).
LARGE_KEYFRAMES, LARGE_LAP, LARGE_LOOP_STEP = 300, 60, 5
SOLVER_TOL = 1e-9
VOCAB_K, VOCAB_L = 10, 3       # the synthetic vocabulary: 10-way tree, 3 levels (1000 words)
SCORE_TOL = 1e-6
# The GNSS drive: the smoke sequence's motion, seen by configs/m2dgrp.yaml's
# camera and wheel mount, with a receiver at the IMU. The GNSS world of
# tests/test_pipeline.py: anchor 31.0 N 121.4 E 12 m, ENU-local yaw 0.25,
# 10 satellites at 35-80 degrees of elevation (above the config's 30 degree
# mask) from seed 3, receiver clocks 15 m (GPS) and 22 m (BeiDou) at t = 0
# drifting 4 m/s (the clock integrates its drift; the generator of
# tests/test_pipeline.py holds it constant, ROADMAP queue 3), Saastamoinen
# troposphere; one epoch at every frame (the JAX package pairs the last
# epochs with the last window frames at alignment, ROADMAP queue 3) and a
# 0.5 m GPS fix at every third frame.
GNSS_FRAMES = 32            # alignment comes near frame 21
GNSS_ANCHOR_LLA_DEG = (31.0, 121.4, 12.0)
GNSS_YAW = 0.25
GNSS_SATS, GNSS_SAT_SEED, GNSS_ELEVATION_DEG = 10, 3, (35.0, 80.0)
GNSS_RCV_DT, GNSS_RCV_DDT = (15.0, 0.0, 0.0, 22.0), 4.0
GPS_EVERY, GPS_ACCURACY_M = 3, 0.5
GNSS_ECEF_BOUND_M = 1.0      # the newest pose in ECEF (tests/test_pipeline.py)
# The execution modes (phase 11): phase 4's drive through the CLI with a
# chunk of 8; the simulator drive of tests/test_pipeline.py (200 landmarks,
# no images) per frame, live and in bursts of 8, at the default config's
# widths in float64, poses within 1e-3 m of each other (tests/test_burst.py),
# 15 frames deep (4 after the first solve) to keep the script inside its time
# budget on a slow host; a fleet of 4 filled cores over 2 steps (both
# branches in every step) at the oracle's tolerances, in
# float64 (the filled core's window is so ill-conditioned that a float32
# burst ends up to 0.34 m from the same burst in float64, on the CPU: in
# float32 any two orders of summation differ by more than the tolerances); the
# log-depth preintegration against the sequential loop at the config's
# capacities with mixed masks in float64.
BURST_CHUNK = 8
MODES_CLI_FRAMES = 24        # 11a: phase 4's first 24 frames (three chunks of 8 staged after the fill)
MODES_FRAMES, MODES_LANDMARKS, MODES_POSE_TOL_M = 15, 200, 1e-3
FLEET_B, FLEET_K = 4, 2
FLEET_TOL = dict(step_pose=1e-2, end_pose=1e-3, inv_depth=2e-3)
PREINT_TOL = 1e-10
PSR_F32_BOUND_M = 5e-3       # float32 rows at ground truth (tests/test_gnss.py)


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", flush=True)
    sys.exit(1)


def check(cond, msg: str) -> None:
    if not cond:
        fail(msg)


# --------------------------------------------------------------------------- 1


def phase_device():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        sys.exit(2)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    print(f"torch {torch.__version__}, cuda {torch.version.cuda}, python {sys.version.split()[0]}")
    return torch, card


# --------------------------------------------------------------------------- 2


def phase_build():
    from ground_fusion_tpu_torch.ops.cuda import build, hamming, klt

    t0 = time.perf_counter()
    names = [klt.KERNEL_NAME, hamming.KERNEL_NAME]
    build.build_all(names)
    for name in names:
        build.library(name)
    dt = time.perf_counter() - t0
    for name, log in build.build_logs.items():
        for line in log.strip().splitlines():
            print(f"  nvcc[{name}]: {line}")
    print(f"build: {len(build.build_logs)} source(s) in {dt:.2f} s", flush=True)


# --------------------------------------------------------------------------- 3


def _texture(np, h, w, seed):
    """Band-limited random texture: white noise through a 5-tap box blur on
    each axis, scaled to a grey-level range."""
    rng = np.random.default_rng(seed)
    base = rng.normal(0, 1, (h + 4, w + 4))
    c = np.cumsum(np.pad(base, ((1, 0), (0, 0))), axis=0)
    base = (c[5:] - c[:-5]) / 5.0
    c = np.cumsum(np.pad(base, ((0, 0), (1, 0))), axis=1)
    base = (c[:, 5:] - c[:, :-5]) / 5.0
    return (base * 400 + 128).astype(np.float32)


def _level_inputs(np, h, w, seed):
    """A texture, its copy shifted by (+3 rows, -2 columns), and N points:
    interior ones, ones within 12 px of each border, and invalid ones."""
    tex = _texture(np, h, w, seed)
    cur = np.roll(tex, (3, -2), (0, 1))
    rng = np.random.default_rng(seed + 100)
    n = N_FEATURES
    pts = np.stack([rng.uniform(30, w - 30, n), rng.uniform(30, h - 30, n)], -1)
    k = 12
    pts[0:k, 0] = rng.uniform(0, 12, k)                    # left border
    pts[k:2 * k, 0] = rng.uniform(w - 13, w - 1, k)        # right border
    pts[2 * k:3 * k, 1] = rng.uniform(0, 12, k)            # top border
    pts[3 * k:4 * k, 1] = rng.uniform(h - 13, h - 1, k)    # bottom border
    seeds = pts + rng.normal(0, 0.5, pts.shape)
    valid = np.ones(n, bool)
    valid[4 * k:4 * k + 10] = False
    interior = np.zeros(n, bool)
    interior[4 * k + 10:] = True
    return tex, cur, pts.astype(np.float32), seeds.astype(np.float32), valid, interior


def _time_ms(torch, fn, reps, warmup=5):
    """Median over ``reps`` calls, each timed with its own pair of CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def _fmt_ms(ms) -> str:
    return "not measured" if ms is None else f"{ms:.5f} ms"


def _bound_ms(bytes_moved, ops, ops_per_s):
    """Least time the card could take: the larger of the bytes moved once over
    the memory rate and the operations over their peak rate, and which one."""
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def _lk_flops(n_valid, n_good):
    """Operations of one LK level. The work depends on the data: an invalid
    feature costs nothing, a valid one the template and the structure
    tensor, a good one the iterations too."""
    p, pb = 2 * HALF + 1, 2 * HALF + 3
    tap = 14                                  # one bilinear tap: weights + 4 multiply-adds
    flop_template = pb * pb * tap + p * p * 10
    flop_iter = p * p * (tap + 5) + 12
    return n_valid * flop_template + n_good * ITERS * flop_iter


def _lk_bound_ms(h, w, n, n_valid, n_good):
    """Bound of one ``lk_level`` call: both images and the points read once,
    points, ok and re-staging counts written once; the level's operations."""
    bytes_moved = 2 * h * w * 4 + 2 * n * 8 + n + n * 8 + n + n * 4
    return _bound_ms(bytes_moved, _lk_flops(n_valid, n_good), F32_FLOP_PER_S)


def phase_kernels(torch):
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import build, klt

    dev = torch.device("cuda")
    per_shape = []
    worst_err = 0.0
    for li, (h, w) in enumerate(LEVEL_SHAPES):
        tex, cur, pts, seeds, valid, interior = _level_inputs(np, h, w, seed=li)
        t_prev, t_cur = torch.as_tensor(tex).to(dev), torch.as_tensor(cur).to(dev)
        t_pts, t_seed = torch.as_tensor(pts).to(dev), torch.as_tensor(seeds).to(dev)
        t_valid = torch.as_tensor(valid).to(dev)

        def run_kernel():
            return klt.lk_level(t_prev, t_cur, t_pts, t_seed, t_valid, HALF, ITERS, MIN_EIG)

        def run_plain():
            return klt.lk_level_reference(t_prev, t_cur, t_pts, t_seed, t_valid,
                                          HALF, ITERS, MIN_EIG)

        k_pts, k_ok = run_kernel()
        torch.cuda.synchronize()
        r_pts, r_ok = run_plain()
        torch.cuda.synchronize()
        check(k_pts.is_cuda and k_ok.dtype == torch.bool and tuple(k_pts.shape) == (N_FEATURES, 2),
              "lk_level: wrong output type or shape")
        check(bool(torch.isfinite(k_pts).all()), f"lk_level {h}x{w}: non-finite points")

        # masks: equal except where eig_min/n sits within rounding of the gate
        eig = klt.lk_eig_min(t_prev, t_pts, HALF)
        differ = k_ok != r_ok
        at_gate = (eig - MIN_EIG).abs() <= GATE_REL * MIN_EIG
        check(not bool((differ & ~at_gate).any()),
              f"lk_level {h}x{w}: ok masks differ away from the gate")
        n_flip = int(differ.sum())
        check(n_flip <= N_FEATURES // 100, f"lk_level {h}x{w}: {n_flip} mask flips at the gate")
        check(not bool(k_ok[~t_valid].any()), "lk_level: an invalid feature came out ok")

        both = k_ok & r_ok
        check(int(both.sum()) >= N_FEATURES // 2, f"lk_level {h}x{w}: too few features ok")
        err = float((k_pts - r_pts).abs()[both].max())
        check(err <= PTS_TOL_PX, f"lk_level {h}x{w}: max |kernel - plain| = {err} px > {PTS_TOL_PX}")
        check(bool(torch.equal(k_pts[~k_ok], t_seed[~k_ok])),
              f"lk_level {h}x{w}: a feature that is not ok did not keep its seed bit for bit")
        worst_err = max(worst_err, err)

        # the known integer shift is recovered on interior features
        sel = both & torch.as_tensor(interior).to(dev)
        want = t_pts[sel] + torch.tensor([-2.0, 3.0], device=dev)
        shift_err = float(torch.linalg.norm(k_pts[sel] - want, dim=1).median())
        check(shift_err < 0.1, f"lk_level {h}x{w}: median shift error {shift_err} px")

        ms = _time_ms(torch, run_kernel, reps=60)
        device_ms = _device_ms(torch, run_kernel, "lk_track_kernel")
        plain_ms = _time_ms(torch, run_plain, reps=10, warmup=2)
        n_valid, n_good = int(valid.sum()), int(k_ok.sum())
        bound_ms, bound_by = _lk_bound_ms(h, w, N_FEATURES, n_valid, n_good)
        per_shape.append({"shape": [h, w], "n": N_FEATURES, "n_ok": n_good, "mask_flips": n_flip,
                          "max_abs_err": err, "shift_err_px": shift_err, "ms": ms,
                          "device_ms": device_ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
        print(f"lk_level {h}x{w}: ok {n_good}/{N_FEATURES}, flips {n_flip}, max err {err:.2e} px, "
              f"kernel {ms:.4f} ms (device alone {_fmt_ms(device_ms)}), plain {plain_ms:.3f} ms, "
              f"bound {bound_ms:.5f} ms ({bound_by})", flush=True)

    # a flat image has no texture: every feature is rejected and keeps its seed
    flat = torch.full(LEVEL_SHAPES[0], 100.0, device=dev)
    f_pts, f_ok = klt.lk_level(flat, flat, t_seed * 2.0, t_seed * 2.0,
                               torch.ones(N_FEATURES, dtype=torch.bool, device=dev))
    torch.cuda.synchronize()
    check(not bool(f_ok.any()), "lk_level: a flat image was not rejected")
    check(bool(torch.equal(f_pts, t_seed * 2.0)), "lk_level: flat image moved a seed")

    top = per_shape[0]
    return {
        "name": "lk_level", "route": "cuda",
        "source": os.path.relpath(build.source_path(klt.KERNEL_NAME), ROOT),
        "replaces": "ground_fusion_tpu/ops/pallas/klt.py:177",
        "launches": 0, "max_abs_err": worst_err,
        "ms": top["ms"], "device_ms": top["device_ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": None,
        "mode": "the LK kernel with levels = 1, forward only, no final masks",
        "tolerance_px": PTS_TOL_PX, "shapes": per_shape,
    }


def _track_inputs(np, torch, dev):
    """The main path's track at 480x640: the texture and its shifted copy as
    3-level pyramids, and the packed [N,5] table the tracker uploads (previous
    xy, seed xy, valid), handed over as the tracker hands it: strided views."""
    from ground_fusion_tpu_torch.frontend.klt import build_pyramid

    h, w = LEVEL_SHAPES[0]
    tex, cur, pts, seeds, valid, interior = _level_inputs(np, h, w, seed=7)
    table = np.concatenate([pts, seeds, valid[:, None].astype(np.float32)], axis=1)
    tab = torch.as_tensor(table).to(dev)
    prev_pyr = build_pyramid(torch.as_tensor(tex).to(dev), TRACK_LEVELS)
    cur_pyr = build_pyramid(torch.as_tensor(cur).to(dev), TRACK_LEVELS)
    args = (prev_pyr, cur_pyr, tab[:, 0:2], tab[:, 2:4], tab[:, 4] > 0.5, TRACK_LEVELS, HALF,
            ITERS, FB_THRESH)
    return args, torch.as_tensor(interior).to(dev)


def _plain_track_traced(torch, klt, args):
    """The plain chain behind ``lk_track``, level by level through
    ``lk_level_reference``, recording per level call the features that enter
    and pass, and which features sit within rounding of an eigenvalue gate.
    Returns (fwd, ok, back, near_gate, per-level (h, w, n_valid, n_good))."""
    prev_pyr, cur_pyr, pts_prev, pts_seed, valid, levels, half, iters, fb = args
    near_gate = torch.zeros(valid.shape, dtype=torch.bool, device=valid.device)
    levels_seen = []

    def recording(prev, cur, pp, pts, ok, half, iters, min_eig):
        nonlocal near_gate
        out = klt.lk_level_reference(prev, cur, pp, pts, ok, half, iters, min_eig)
        eig = klt.lk_eig_min(prev, pp, half)
        near_gate = near_gate | (ok & ((eig - min_eig).abs() <= GATE_REL * min_eig))
        levels_seen.append((*prev.shape, int(ok.sum()), int(out[1].sum())))
        return out

    fwd, ok_f = klt.track_pyramidal_chain(recording, prev_pyr, cur_pyr, pts_prev, pts_seed, valid,
                                          levels, half, iters, MIN_EIG)
    back, ok_b = klt.track_pyramidal_chain(recording, cur_pyr, prev_pyr, fwd, pts_prev, ok_f,
                                           levels, half, iters, MIN_EIG)
    ok = ok_f & ok_b & (torch.linalg.norm(back - pts_prev, dim=-1) <= fb)
    return fwd, ok, back, near_gate, levels_seen


def _near_edges(torch, args, fwd, back):
    """Features whose round trip lies within EDGE_TOL_PX of the gate, or whose
    forward or backward point lies within it of the ``inb`` border."""
    prev_pyr, pts_prev, fb = args[0], args[2], args[8]
    h, w = prev_pyr[0].shape
    near = ((torch.linalg.norm(back - pts_prev, dim=-1) - fb).abs() <= EDGE_TOL_PX)
    for p in (fwd, back):
        for c, lo, hi in ((0, 1.0, w - 2.0), (1, 1.0, h - 2.0)):
            near |= ((p[:, c] - lo).abs() <= EDGE_TOL_PX) | ((p[:, c] - hi).abs() <= EDGE_TOL_PX)
    return near


def phase_track(torch):
    """``lk_track`` at the main path's shape against the plain chain, and in
    turns against the previous design's control flow (one ``lk_level``
    launch per level and direction, the tensor operations between them)."""
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import build, klt

    dev = torch.device("cuda")
    args, interior = _track_inputs(np, torch, dev)
    n = args[2].shape[0]
    k_fwd, k_ok = klt.lk_track(*args)
    torch.cuda.synchronize()
    restages = int(klt.LAST_RESTAGES.sum())
    r_fwd, r_ok, r_back, near_gate, levels_seen = _plain_track_traced(torch, klt, args)
    torch.cuda.synchronize()
    p_fwd, p_ok = klt.lk_track_reference(*args)
    check(torch.equal(p_fwd, r_fwd) and torch.equal(p_ok, r_ok),
          "lk_track: the traced plain chain is not lk_track_reference")
    check(k_fwd.is_cuda and k_ok.dtype == torch.bool and tuple(k_fwd.shape) == (n, 2),
          "lk_track: wrong output type or shape")
    check(bool(torch.isfinite(k_fwd).all()), "lk_track: non-finite points")

    excused = near_gate | _near_edges(torch, args, r_fwd, r_back)
    differ = k_ok != r_ok
    check(not bool((differ & ~excused).any()),
          f"lk_track: ok masks differ away from the gates at {torch.nonzero(differ & ~excused).tolist()}")
    n_flip = int(differ.sum())
    check(n_flip <= n // 100, f"lk_track: {n_flip} mask flips")
    both = k_ok & r_ok
    check(int(both.sum()) >= n // 3, f"lk_track: only {int(both.sum())} features ok")
    err = float((k_fwd - r_fwd).abs()[both].max())
    check(err <= PTS_TOL_PX, f"lk_track: max |kernel - plain| = {err} px > {PTS_TOL_PX}")
    sel = both & interior
    shift_err = float(torch.linalg.norm(k_fwd[sel] - (args[2][sel] + torch.tensor([-2.0, 3.0], device=dev)),
                                        dim=1).median())
    check(shift_err < 0.1, f"lk_track: median shift error {shift_err} px")

    def run_track():
        return klt.lk_track(*args)

    def run_levelwise():
        return klt.track_bidirectional_chain(klt.lk_level, *args, MIN_EIG)

    def run_plain():
        return klt.lk_track_reference(*args)

    lw_fwd, lw_ok = run_levelwise()
    check(torch.equal(lw_ok, k_ok) or int((lw_ok != k_ok).sum()) <= n // 100,
          "lk_track: the six-launch control flow disagrees with the one launch")
    times = {"track": [], "levelwise": [], "plain": []}
    for _ in range(3):                        # in turns, in one call, on one card
        times["track"].append(_time_ms_run(torch, run_track, 50))
        times["levelwise"].append(_time_ms_run(torch, run_levelwise, 20))
        times["plain"].append(_time_ms_run(torch, run_plain, 2, repeats=3, warmup=1))
    ms, lw_ms, plain_ms = (sorted(times[k])[1] for k in ("track", "levelwise", "plain"))
    device_ms = _device_ms(torch, run_track, "lk_track_kernel")
    lw_device_ms = _device_ms(torch, run_levelwise, "lk_track_kernel")   # per level launch
    # the same launch with no iteration: window staging, templates, gates and the launch
    no_iter_ms = _device_ms(torch, lambda: klt.lk_track(*args[:7], 0, args[8]), "lk_track_kernel")
    iter_us = None if None in (device_ms, no_iter_ms) else \
        (device_ms - no_iter_ms) / (2 * TRACK_LEVELS * ITERS) * 1e3

    prev_pyr = args[0]
    bytes_moved = 2 * sum(t.numel() * 4 for t in prev_pyr) + n * (2 * 8 + 1) + n * (8 + 1 + 4)
    flops = sum(_lk_flops(nv, ng) for _, _, nv, ng in levels_seen)
    bound_ms, bound_by = _bound_ms(bytes_moved, flops, F32_FLOP_PER_S)
    print(f"lk_track {args[0][0].shape[0]}x{args[0][0].shape[1]}, {TRACK_LEVELS} levels, both directions, {n} features: ok {int(k_ok.sum())}"
          f"/{n} (plain {int(r_ok.sum())}), flips {n_flip}, max err {err:.2e} px, shift err "
          f"{shift_err:.2e} px, window re-stagings {restages}; one launch {ms:.5f} ms per call "
          f"(device alone {_fmt_ms(device_ms)}; with 0 iterations {_fmt_ms(no_iter_ms)}, so "
          f"{iter_us if iter_us is None else round(iter_us, 4)} us an iteration), six-launch "
          f"control flow {lw_ms:.5f} ms per call "
          f"(device {_fmt_ms(lw_device_ms)} per level launch), plain chain {plain_ms:.3f} ms; "
          f"bound {bound_ms:.6f} ms ({bound_by}); rounds {times}", flush=True)
    return {
        "name": "lk_track", "route": "cuda",
        "source": os.path.relpath(build.source_path(klt.KERNEL_NAME), ROOT),
        "replaces": "ground_fusion_tpu/ops/pallas/klt.py:177",
        "launches": 0, "max_abs_err": err,
        "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "levelwise_ms": lw_ms, "levelwise_device_ms_per_launch": lw_device_ms,
        "device_ms_no_iterations": no_iter_ms, "us_per_iteration": iter_us,
        "mask_flips": n_flip, "restages": restages, "shift_err_px": shift_err,
        "tolerance_px": PTS_TOL_PX, "shape": [*LEVEL_SHAPES[0]], "levels": TRACK_LEVELS, "n": n,
    }


def _time_ms_run(torch, fn, n, repeats=5, warmup=5):
    """Per-call time of ``n`` back-to-back calls between one pair of CUDA
    events (for calls of a few microseconds, where a pair of events around
    each call measures the events); the median of ``repeats`` such runs."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    times.sort()
    return times[len(times) // 2]


def _device_ms(torch, fn, kernel: str, n: int = 50):
    """Mean device time of one launch of the kernel whose name contains
    ``kernel``, over ``n`` calls of ``fn`` under ``torch.profiler`` (the
    kernel alone, without the host's work around the launch); None when the
    profiler saw no such kernel."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    for row in prof.key_averages():
        if kernel in row.key and row.count:
            total_us = getattr(row, "device_time_total", None)
            if total_us is None:
                total_us = row.cuda_time_total
            return total_us / row.count / 1e3
    return None


def _sm_clock_mhz() -> float:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60)
    check(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    return float(smi.stdout.strip().splitlines()[0])


def _hamming_bound_ms(ka, kb, popc_per_s):
    """Least time for one ``hamming_matrix`` call: the larger of its bytes
    (each descriptor read once, each distance written once) over the memory
    rate and its Ka·Kb·8 popcounts over the card's popcount rate."""
    return _bound_ms((ka + kb) * 32 + ka * kb * 4, ka * kb * 8, popc_per_s)


def _match_bound_ms(ka, kb, popc_per_s):
    """Least time for one ``hamming_match`` call: descriptors and masks read
    once, an int64 index and a flag written per row; Ka·Kb·8 popcounts."""
    return _bound_ms((ka + kb) * 33 + ka * 9, ka * kb * 8, popc_per_s)


def _match_inputs(np, ka, kb, seed, case="random"):
    """Current descriptors that are old ones with 0-120 of their 256 bits
    flipped (so some pass the gate of 80, some do not), some current ones
    masked. ``ties``: the old set repeats Kb/5 descriptors five times each;
    ``mask``: every third old descriptor and those of the first quarter of
    the current rows are masked; ``all_masked``: every old one is."""
    rng = np.random.default_rng(seed)
    old = rng.integers(0, 2**32, (kb, 8), dtype=np.uint32)
    if case == "ties":
        old = np.repeat(old[: max(kb // 5, 1)], 5, axis=0)[:kb][rng.permutation(kb)]
    src = rng.integers(0, kb, ka)
    bits = np.unpackbits(old[src].view(np.uint8), axis=1)
    for r, k in enumerate(rng.integers(0, 121, ka)):
        bits[r, rng.choice(256, k, replace=False)] ^= 1
    cur = np.packbits(bits, axis=1).view(np.uint32)
    ok_cur = rng.random(ka) > 0.1
    ok_old = np.ones(kb, bool)
    if case == "mask":
        ok_old[::3] = False
        ok_old[src[: max(ka // 4, 1)]] = False
    elif case == "all_masked":
        ok_old[:] = False
    return cur.view(np.int32), ok_cur, old.view(np.int32), ok_old


def phase_hamming(torch):
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import build, hamming

    dev = torch.device("cuda")
    clock = _sm_clock_mhz()
    popc_per_s = POPC_PER_CLOCK_PER_SM * N_SM * clock * 1e6
    print(f"hamming_matrix bound rates: {popc_per_s:.4e} popcounts/s "
          f"({POPC_PER_CLOCK_PER_SM} per clock per SM x {N_SM} SMs x {clock:.0f} MHz max SM clock), "
          f"{HBM_BYTES_PER_S:.3e} B/s", flush=True)
    per_shape = []
    for si, (ka, kb) in enumerate(HAMMING_SHAPES):
        rng = np.random.default_rng(200 + si)
        da = torch.as_tensor(rng.integers(0, 2**32, (ka, 8), dtype=np.uint32).view(np.int32)).to(dev)
        db = torch.as_tensor(rng.integers(0, 2**32, (kb, 8), dtype=np.uint32).view(np.int32)).to(dev)
        got = hamming.hamming_matrix(da, db)
        torch.cuda.synchronize()
        want = hamming.hamming_matrix_reference(da, db)
        check(got.is_cuda and got.dtype == torch.int32 and tuple(got.shape) == (ka, kb),
              "hamming_matrix: wrong output type or shape")
        n_diff = int((got != want).sum())
        check(n_diff == 0, f"hamming_matrix {ka}x{kb}: {n_diff} distances differ from the plain version")
        check(torch.equal(hamming.hamming_matrix_mxu(da, db), want),
              f"hamming_matrix {ka}x{kb}: the bit-plane version disagrees")
        same = hamming.hamming_matrix(da, da)
        flip = hamming.hamming_matrix(da, torch.bitwise_not(da))
        torch.cuda.synchronize()
        check(bool((same.diagonal() == 0).all()), f"hamming_matrix {ka}x{kb}: d(a, a) is not 0")
        check(bool((flip.diagonal() == 256).all()), f"hamming_matrix {ka}x{kb}: d(a, ~a) is not 256")

        # the yardstick: one PyTorch call on bit planes unpacked beforehand
        ua, ub = hamming.unpack_bits(da), hamming.unpack_bits(db)
        check(torch.equal(torch.cdist(ua, ub, p=0).to(torch.int32), want),
              f"hamming_matrix {ka}x{kb}: cdist(p=0) on bit planes disagrees")
        ms = _time_ms_run(torch, lambda: hamming.hamming_matrix(da, db), 200)
        device_ms = _device_ms(torch, lambda: hamming.hamming_matrix(da, db), "hamming_matrix_kernel")
        plain_ms = _time_ms_run(torch, lambda: hamming.hamming_matrix_reference(da, db), 10)
        library_ms = _time_ms_run(torch, lambda: torch.cdist(ua, ub, p=0), 50)
        bound_ms, bound_by = _hamming_bound_ms(ka, kb, popc_per_s)
        per_shape.append({"shape": [ka, kb], "max_abs_err": 0, "ms": ms, "device_ms": device_ms,
                          "plain_ms": plain_ms, "library_ms": library_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
        print(f"hamming_matrix {ka}x{kb}: equal to the plain version, identity 0, complement 256; "
              f"kernel {ms:.5f} ms per call (device alone {_fmt_ms(device_ms)}), plain {plain_ms:.4f} ms, "
              f"library (cdist p=0 on f32 bit planes unpacked outside the timing) {library_ms:.4f} ms, "
              f"bound {bound_ms:.6f} ms ({bound_by})", flush=True)

    top = per_shape[0]
    matrix = {
        "name": "hamming_matrix", "route": "cuda",
        "source": os.path.relpath(build.source_path(hamming.KERNEL_NAME), ROOT),
        "replaces": "ground_fusion_tpu/ops/pallas/hamming.py:66",
        "launches": 0, "max_abs_err": 0,
        "ms": top["ms"], "device_ms": top["device_ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        "library": "torch.cdist(p=0) on float32 bit planes unpacked beforehand",
        "tolerance": "exact", "popcounts_per_s": popc_per_s, "shapes": per_shape,
    }
    return matrix, phase_match(torch, popc_per_s)


def five_pass_match_brief(torch, hamming, desc_cur, ok_cur, desc_old, ok_old, thresh):
    """``match_brief`` before the fused kernel: the distance-matrix kernel,
    then four tensor passes over the [Kc,Kb] matrix (mask, argmin, gather,
    gate). Timed beside the fused kernel that replaced it."""
    d = hamming.hamming_matrix(desc_cur, desc_old)
    d = torch.where(ok_old[None, :], d, torch.full_like(d, hamming.MASKED))
    idx = torch.argmin(d, dim=1)
    best = torch.gather(d, 1, idx[:, None])[:, 0]
    return idx, ok_cur & (best < thresh)


def phase_match(torch, popc_per_s):
    """``hamming_match`` exactly against ``match_brief_reference`` at the six
    shapes and, at 100x600, with ties, masks and an all-masked old set; timed
    per call in turns with ``torch.cdist(p=0)`` on bit planes (the distance
    half alone) and with the five-pass flow it replaced (matrix kernel + four
    passes)."""
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import build, hamming

    dev = torch.device("cuda")
    cases = [(ka, kb, "random") for ka, kb in HAMMING_SHAPES]
    cases += [(100, 600, "ties"), (100, 600, "mask"), (100, 600, "all_masked")]
    per_shape = []
    for si, (ka, kb, case) in enumerate(cases):
        cur, ok_cur, old, ok_old = (torch.as_tensor(x).to(dev)
                                    for x in _match_inputs(np, ka, kb, 300 + si, case))
        args = (cur, ok_cur, old, ok_old, MATCH_THRESH)
        idx, matched = hamming.hamming_match(*args)
        torch.cuda.synchronize()
        want_idx, want_m = hamming.match_brief_reference(*args)
        check(idx.is_cuda and idx.dtype == torch.int64 and matched.dtype == torch.bool
              and tuple(idx.shape) == (ka,) and tuple(matched.shape) == (ka,),
              "hamming_match: wrong output type or shape")
        n_idx, n_m = int((idx != want_idx).sum()), int((matched != want_m).sum())
        check(n_idx == 0 and n_m == 0,
              f"hamming_match {ka}x{kb} {case}: {n_idx} indices and {n_m} flags differ from the plain version")
        if case == "all_masked":
            check(not bool(matched.any()) and not bool(idx.any()),
                  "hamming_match: an all-masked old set did not give index 0 and no match")
        if case != "random":
            print(f"hamming_match {ka}x{kb} {case}: equal to the plain version "
                  f"({int(matched.sum())} matches)", flush=True)
            continue

        check(all(torch.equal(a, b) for a, b in zip(five_pass_match_brief(torch, hamming, *args),
                                                      (want_idx, want_m))),
              f"hamming_match {ka}x{kb}: the five-pass flow disagrees")
        ua, ub = hamming.unpack_bits(cur), hamming.unpack_bits(old)
        times = {"kernel": [], "library": [], "five_pass": []}
        for _ in range(3):                    # in turns, in one call, on one card
            times["kernel"].append(_time_ms_run(torch, lambda: hamming.hamming_match(*args), 200))
            times["library"].append(_time_ms_run(torch, lambda: torch.cdist(ua, ub, p=0), 50))
            times["five_pass"].append(
                _time_ms_run(torch, lambda: five_pass_match_brief(torch, hamming, *args), 50))
        ms, library_ms, five_pass_ms = (sorted(times[k])[1] for k in ("kernel", "library", "five_pass"))
        device_ms = _device_ms(torch, lambda: hamming.hamming_match(*args), "hamming_match_kernel")
        plain_ms = _time_ms_run(torch, lambda: hamming.match_brief_reference(*args), 10)
        bound_ms, bound_by = _match_bound_ms(ka, kb, popc_per_s)
        per_shape.append({"shape": [ka, kb], "matches": int(matched.sum()), "max_abs_err": 0,
                          "ms": ms, "device_ms": device_ms, "plain_ms": plain_ms,
                          "library_ms": library_ms, "five_pass_ms": five_pass_ms, "bound_ms": bound_ms,
                          "bound_by": bound_by})
        print(f"hamming_match {ka}x{kb}: equal to the plain version ({int(matched.sum())} matches); "
              f"kernel {ms:.5f} ms per call (device alone {_fmt_ms(device_ms)}), five-pass flow "
              f"{five_pass_ms:.5f} ms, plain {plain_ms:.4f} ms, library (cdist p=0 on bit planes, distances "
              f"only) {library_ms:.4f} ms, bound {bound_ms:.6f} ms ({bound_by}); rounds {times}",
              flush=True)

    top = per_shape[0]
    return {
        "name": "hamming_match", "route": "cuda",
        "source": os.path.relpath(build.source_path(hamming.KERNEL_NAME), ROOT),
        "replaces": "ground_fusion_tpu/ops/pallas/hamming.py:66",
        "launches": 0, "max_abs_err": 0,
        "ms": top["ms"], "device_ms": top["device_ms"], "plain_ms": top["plain_ms"],
        "bound_ms": top["bound_ms"], "bound_by": top["bound_by"], "library_ms": top["library_ms"],
        "five_pass_ms": top["five_pass_ms"],
        "library": "torch.cdist(p=0) on float32 bit planes unpacked beforehand (distances only)",
        "tolerance": "exact", "shapes": per_shape,
    }


# --------------------------------------------------------------------------- 4


CONFIG_PATH = os.path.join(ROOT, "configs", "groundchallenge.yaml")


def render_smoke_sequence(seq_dir: str) -> str:
    """The smoke sequence, from its seed: 40 frames at the camera, IMU mount
    and wheel mount of ``configs/groundchallenge.yaml`` (CPU, float64)."""
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.sim.render import Mounts, render_sequence
    from ground_fusion_tpu_torch.sim.synthetic import SimParams

    cfg = load_yaml(CONFIG_PATH)
    cam = cfg.camera
    return render_sequence(seq_dir, N_FRAMES, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                           cam.height, sp=SimParams(**SMOKE_SIM), n_landmarks=SMOKE_LANDMARKS,
                           seed=SMOKE_SEED, mounts=Mounts.from_config(cfg))


def trajectory_ate(vio_path: str, gt_path: str):
    """(number of poses, ATE in m, distance travelled over those poses in m)."""
    import numpy as np

    from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

    est = np.loadtxt(vio_path, ndmin=2)
    gt = np.loadtxt(gt_path, ndmin=2)
    check(bool(np.isfinite(est).all()), "main path: non-finite pose in vio.txt")
    gt_i = np.stack([np.interp(est[:, 0], gt[:, 0], gt[:, i]) for i in (1, 2, 3)], -1)
    path = float(np.linalg.norm(np.diff(gt_i, axis=0), axis=1).sum())
    return len(est), float(ate_rmse(est[:, 1:4], gt_i)), path


def _loop_config(work_dir: str) -> str:
    """``configs/groundchallenge.yaml`` with loop closure switched on, as a
    copy in the work directory."""
    path = os.path.join(work_dir, "groundchallenge_loop.yaml")
    with open(CONFIG_PATH) as src, open(path, "w") as dst:
        dst.write(src.read().rstrip("\n") + "\nloop:\n  enabled: true\n")
    return path


def _zero_counters(klt, hamming):
    klt.LAUNCHES = klt.REFERENCE_CALLS = klt.TRACK_LAUNCHES = klt.TRACK_REFERENCE_CALLS = 0
    hamming.LAUNCHES = hamming.REFERENCE_CALLS = 0
    hamming.MATCH_LAUNCHES = hamming.MATCH_REFERENCE_CALLS = 0


def _read_counters(klt, hamming):
    """Launches of each kernel entry point, and runs of any plain version
    through a wrapper, since the counters were last set to 0."""
    return {"lk_track": klt.TRACK_LAUNCHES, "lk_level": klt.LAUNCHES,
            "hamming_match": hamming.MATCH_LAUNCHES, "hamming_matrix": hamming.LAUNCHES,
            "plain": klt.REFERENCE_CALLS + klt.TRACK_REFERENCE_CALLS + hamming.REFERENCE_CALLS
            + hamming.MATCH_REFERENCE_CALLS}


def stage_times(stats) -> dict:
    """(median, mean) ms of ``track`` and ``solve``; under ``sums`` the
    seconds each stage took in all."""
    out = {name: (stats.median(name), stats.mean(name)) for name in ("track", "solve")}
    out["sums"] = {name: round(v / 1e3, 2) for name, v in sorted(stats.sums.items())}
    return out


def phase_main(torch, work_dir):
    import numpy as np

    from ground_fusion_tpu_torch.__main__ import run
    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    cfg_path = _loop_config(work_dir)
    seq = os.path.join(work_dir, "seq")
    out = os.path.join(work_dir, "out")
    t_start = t0 = time.perf_counter()
    render_smoke_sequence(seq)
    print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s", flush=True)

    _zero_counters(klt, hamming)
    t0 = time.perf_counter()
    system = run(cfg_path, seq, out)          # device=None: the GPU
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters(klt, hamming)

    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    check(n_poses >= 20, f"main path: only {n_poses} poses in vio.txt")
    print(f"main path: {n_poses} poses over {path:.4f} m, ATE {ate:.5f} m (recorded: {RECORDED_ATE_M} m; "
          f"bounds {ATE_BOUND_M} m and {ATE_BOUND_OF_PATH:.0%} of the path)")
    check(ate < ATE_BOUND_M, f"main path: ATE {ate:.4f} m is not below {ATE_BOUND_M} m")
    check(ate < ATE_BOUND_OF_PATH * path,
          f"main path: ATE {ate:.4f} m is not below {ATE_BOUND_OF_PATH:.0%} of {path:.3f} m")

    core = system.estimator.core
    tensors = list(core.state) + list(core.tracks) + list(core.imu_buf) + list(core.wheel_buf) \
        + [core.prior.J0, core.prior.r0, core.prior.valid] + list(core.prior.lin)
    check(all(t.is_cuda for t in tensors), "main path: a state tensor is not on the GPU")
    check(core.state.poses.dtype == torch.float32, "main path: the state is not float32")
    check(system.estimator.reboots == 0, "main path: the estimator rebooted")

    # one lk_track launch (3 levels x forward and backward) for every frame
    # that had features to track: every frame after the first
    tracked_frames = system.stats.counts["track"] - 1
    check(tracked_frames == N_FRAMES - 1, f"main path: {tracked_frames} tracked frames")
    check(counts["lk_track"] == tracked_frames,
          f"main path: {counts['lk_track']} lk_track launches, expected {tracked_frames}")
    check(counts["lk_level"] == 0, f"main path: {counts['lk_level']} lk_level launches, expected 0")
    check(counts["plain"] == 0, f"main path: plain versions ran {counts['plain']} times")

    # the front end really fed the estimator: tracks survive, landmarks are solved
    n_tracked = int((system.tracker.track_len >= 5).sum())
    n_solved = int((core.tracks.active & core.tracks.solve_ok).sum())
    print(f"main path: {n_tracked} features tracked over 5+ frames, {n_solved} landmarks solved")
    check(n_tracked >= MIN_TRACKED, f"main path: only {n_tracked} features tracked over 5+ frames")
    check(n_solved >= MIN_SOLVED_LANDMARKS, f"main path: only {n_solved} landmarks solved")

    # loop closure on: every keyframe described on the GPU and registered
    pg = system.pose_graph
    n_kf = len(pg.kfs)
    loop_lines = np.loadtxt(os.path.join(out, "loop.txt"), ndmin=2)
    print(f"main path: {n_kf} keyframes in the pose graph of {sum(system.estimator.keyframe_flags)} "
          f"solved keyframes, {len(loop_lines)} lines in loop.txt, {len(pg.loop_edges)} loop edges, "
          f"hamming_match launches {counts['hamming_match']}")
    check(len(loop_lines) == n_kf >= MIN_LOOP_KEYFRAMES,
          f"main path: {len(loop_lines)} lines in loop.txt for {n_kf} keyframes "
          f"(at least {MIN_LOOP_KEYFRAMES} expected)")
    check(bool(np.isfinite(loop_lines).all()), "main path: non-finite pose in loop.txt")
    check(pg.describes == {"cuda": n_kf}, f"main path: descriptors computed on {dict(pg.describes)}")
    check(pg.db.hists.is_cuda and pg.db.valid.is_cuda, "main path: the BoW tables are not on the GPU")
    check(counts["hamming_match"] == pg.match_calls and counts["hamming_matrix"] == 0,
          f"main path: {counts['hamming_match']} hamming_match and {counts['hamming_matrix']} "
          f"hamming_matrix launches for {pg.match_calls} matches")

    stats = system.stats
    print(f"main path: track median {stats.median('track'):.2f} ms/frame "
          f"(mean {stats.mean('track'):.2f}), solve median {stats.median('solve'):.2f} ms/frame "
          f"(mean {stats.mean('solve'):.2f}) over {stats.counts['solve']} frames, "
          f"loop median {stats.median('loop'):.2f} ms/keyframe (mean {stats.mean('loop'):.2f}) "
          f"over {stats.counts['loop']} keyframes")
    print(f"main path: {N_FRAMES / wall:.3f} frames/s ({wall:.1f} s wall for {N_FRAMES} frames, "
          f"image loading and keyframe description included), launches {counts}", flush=True)
    times = stage_times(stats)
    times["phase_s"] = time.perf_counter() - t_start     # rendering included, as phase 13's
    return counts, times


# --------------------------------------------------------------------------- 5


def _place_image(np, place: int):
    """The revisit drive's image of one place, built as
    tests/test_pose_graph_e2e.py builds its place textures (white noise in
    square blocks, a box blur, stretched to 0-255) but at 640x480 from
    2-px blocks and a 3x3 blur, grey levels rounded to integers. (With the
    test's coarser 4-px blocks and 5x5 blur at this size, unrelated places
    score above the BoW gate and the earliest-candidate rule sends every
    revisit to place 0.)"""
    r = np.random.default_rng(100 + place)
    img = np.kron(r.normal(0, 1, (240, 320)), np.ones((2, 2)))
    pad = np.pad(img, 1, mode="edge")
    c = np.cumsum(np.cumsum(np.pad(pad, ((1, 0), (1, 0))), axis=0), axis=1)
    img = (c[3:, 3:] - c[:-3, 3:] - c[3:, :-3] + c[:-3, :-3]) / 9.0
    return np.round((img - img.min()) / (img.max() - img.min()) * 255.0).astype(np.float32)


def _yaw_pose(np, yaw, p):
    return np.concatenate([p, [np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)]])


def revisit_keyframes(np, cam):
    """The revisit drive, from its seeds: REVISIT_PLACES keyframes around a
    circle of REVISIT_RADIUS m, each at its own place (image and
    REVISIT_LANDMARKS landmarks), then REVISIT_AGAIN keyframes back at
    places 0, 1, .... The VIO poses integrate the true keyframe-to-keyframe
    motion with a yaw error of REVISIT_YAW_DRIFT rad per keyframe (the drift
    of tests/test_pose_graph_scale.py). Yields (index, place, true position,
    drifted pose, landmarks in the keyframe's camera and in the drifted world
    frame, normalized observations, pixels)."""
    n = REVISIT_PLACES + REVISIT_AGAIN
    th = 2 * np.pi * np.arange(n) / REVISIT_PLACES
    gt_p = REVISIT_RADIUS * np.stack([np.cos(th), np.sin(th), np.zeros(n)], -1)
    gt_yaw = th + np.pi / 2

    def rotz(y):
        c, s = np.cos(y), np.sin(y)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    landmarks = {}
    vio_p, vio_yaw = gt_p[0].copy(), gt_yaw[0]
    for k in range(n):
        if k:
            vio_p = vio_p + rotz(vio_yaw) @ rotz(gt_yaw[k - 1]).T @ (gt_p[k] - gt_p[k - 1])
            vio_yaw = vio_yaw + (gt_yaw[k] - gt_yaw[k - 1]) + REVISIT_YAW_DRIFT
        place = k % REVISIT_PLACES
        if place not in landmarks:
            r = np.random.default_rng(500 + place)
            m = REVISIT_LANDMARKS
            landmarks[place] = np.stack([r.uniform(-1.2, 1.2, m), r.uniform(-0.9, 0.9, m),
                                         r.uniform(2.5, 5.0, m)], -1)
        pc = landmarks[place]                  # in the keyframe's body (= camera) frame
        norm = pc[:, 0:2] / pc[:, 2:3]
        px = norm * [cam.fx, cam.fy] + [cam.cx, cam.cy]
        yield (k, place, gt_p[k], _yaw_pose(np, vio_yaw, vio_p), pc, pc @ rotz(vio_yaw).T + vio_p,
               norm, px)


def _quat_conj(q):
    return q * [1.0, -1.0, -1.0, -1.0]


def seat_keyframe(np, torch, system, cam_pose, pc):
    """Put one keyframe into the system's window as its window step leaves
    it, and return its body pose: the frame just solved in slot F-2, where
    the configured camera mount puts the camera at ``cam_pose``
    (world_T_cam [7]); one solved landmark per row of ``pc`` (points in that
    camera), observed in slot F-2 and anchored in slot 0, whose camera sits
    ANCHOR_OFFSET_M behind, turned by ANCHOR_YAW. Plain numpy geometry,
    independent of the port's SE(3) code."""
    from ground_fusion_tpu_torch.utils import np_quat

    est = system.estimator
    st, tr = est.core.state, est.core.tracks
    ex = st.ex_cam.double().cpu().numpy()

    def body_of(cam):                       # world_T_body = world_T_cam ∘ (body_T_cam)⁻¹
        q = np_quat.quat_normalize(np_quat.quat_mul(cam[3:7], _quat_conj(ex[3:7])))
        return np.concatenate([cam[0:3] - np_quat.quat_to_mat(q) @ ex[0:3], q])

    R_k = np_quat.quat_to_mat(cam_pose[3:7])
    q_off = np.array([np.cos(ANCHOR_YAW / 2), 0.0, np.sin(ANCHOR_YAW / 2), 0.0])
    anchor = np.concatenate([cam_pose[0:3] + R_k @ np.asarray(ANCHOR_OFFSET_M),
                             np_quat.quat_normalize(np_quat.quat_mul(cam_pose[3:7], q_off))])
    pts_w = pc @ R_k.T + cam_pose[0:3]
    pc_a = (pts_w - anchor[0:3]) @ np_quat.quat_to_mat(anchor[3:7])
    f, slot = est.f, est.f - 2
    ml, m = tr.active.shape[0], len(pc)
    check(m <= ml and bool((pc_a[:, 2] > 0.1).all()), "seat_keyframe: landmarks do not fit the window")
    kw = dict(dtype=st.poses.dtype, device=st.poses.device)
    seen = torch.arange(ml, device=kw["device"]) < m
    obs = torch.zeros_like(tr.obs)
    obs[:m, slot, 0:2] = torch.as_tensor(pc[:, 0:2] / pc[:, 2:3], **kw)
    obs[:m, 0, 0:2] = torch.as_tensor(pc_a[:, 0:2] / pc_a[:, 2:3], **kw)
    inv_depth = torch.ones_like(tr.inv_depth)
    inv_depth[:m] = torch.as_tensor(1.0 / pc_a[:, 2], **kw)
    body = body_of(np.asarray(cam_pose, np.float64))
    poses = st.poses.clone()
    poses[slot] = torch.as_tensor(body, **kw)
    poses[0] = torch.as_tensor(body_of(anchor), **kw)
    frames = torch.arange(f, device=kw["device"])
    est.core = est.core._replace(
        state=st._replace(poses=poses),
        tracks=tr._replace(inv_depth=inv_depth, active=seen, solve_ok=seen,
                           start_frame=torch.zeros_like(tr.start_frame), obs=obs,
                           obs_valid=seen[:, None] & ((frames == 0) | (frames == slot))[None, :]))
    return body


def camera_position(np, body_pose, ex_cam):
    """The camera centre of a body pose under the mount ``ex_cam`` [7]."""
    from ground_fusion_tpu_torch.utils import np_quat

    return body_pose[0:3] + np_quat.quat_to_mat(body_pose[3:7]) @ ex_cam[0:3]


def run_revisit(device, work_dir):
    """Drive two ``PoseGraph``s (4-DoF and 6-DoF) on ``device`` through the
    revisit keyframes: ``describe`` once per keyframe, ``add_keyframe`` to
    both, then ``optimize`` each; and a ``GroundFusionSystem`` with loop
    closure on, through its keyframe hook, each keyframe seated in its
    window first (the hook describes, registers, and relaxes the graph on
    every new loop edge; the system writes its files under ``work_dir``).
    Returns the graphs, the system, what it published,
    the host times (ms) of every call, each graph's end error before and
    after, and the hook's largest deviations from the drive's keyframes."""
    import collections
    import dataclasses

    import numpy as np
    import torch

    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.global_layers.pose_graph import Keyframe, PoseGraph
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    cfg = load_yaml(CONFIG_PATH)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=True))
    cam = cfg.camera
    graphs = {"4dof": PoseGraph(cfg, device=device),
              "6dof": PoseGraph(dataclasses.replace(
                  cfg, loop=dataclasses.replace(cfg.loop, graph_6dof=True)), device=device)}
    system = GroundFusionSystem(cfg, os.path.join(work_dir, "revisit"), device=device)
    ex_cam = system.estimator.core.state.ex_cam.double().cpu().numpy()
    published = collections.Counter()
    for topic in ("loop_closure", "path_update"):
        system.subscribe(topic, lambda topic=topic, **_: published.update([topic]))
    images = {}
    ms = {"describe": [], "add_keyframe": [], "hook": [], "optimize_4dof": [], "optimize_6dof": []}
    hook_err = {"pts3d_m": 0.0, "norm": 0.0, "px": 0.0}

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        sync()
        ms[name].append((time.perf_counter() - t0) * 1e3)
        return out

    true_end = None
    for k, place, p_true, pose, pc, pts_w, norm, px in revisit_keyframes(np, cam):
        if place not in images:
            images[place] = _place_image(np, place)
        pts, ok, desc, win_desc = timed("describe", graphs["4dof"].describe, images[place], px)
        kp_norm = (pts - [cam.cx, cam.cy]) / [cam.fx, cam.fy]
        kf = Keyframe(index=k, t=float(k), pose=pose, kp=np.concatenate([pts, px]),
                      kp_norm=np.concatenate([kp_norm, norm]), desc=np.concatenate([desc, win_desc]),
                      kp_ok=np.concatenate([ok, np.ones(len(px), bool)]), win_pts3d=pts_w,
                      win_norm=norm, win_desc=win_desc, win_ok=np.ones(len(px), bool))
        timed("add_keyframe", graphs["4dof"].add_keyframe, kf)
        graphs["6dof"].add_keyframe(kf)
        # the same keyframe through the system's hook
        body = seat_keyframe(np, torch, system, pose, pc)
        sync()
        timed("hook", system._add_loop_keyframe, float(k), images[place], body)
        hk = system.pose_graph.kfs[-1]
        check(hk.index == k, f"revisit: the hook did not register keyframe {k}")
        hook_err["pts3d_m"] = max(hook_err["pts3d_m"], float(np.abs(hk.win_pts3d - pts_w).max()))
        hook_err["norm"] = max(hook_err["norm"], float(np.abs(hk.win_norm - norm).max()))
        hook_err["px"] = max(hook_err["px"], float(np.abs(hk.kp[len(pts):] - px).max()))
        true_end = p_true
    errors = {}
    for name, pg in graphs.items():
        before = float(np.linalg.norm(pg.kfs[-1].pose[0:3] - true_end))
        timed(f"optimize_{name}", pg.optimize)
        errors[name] = (before, float(np.linalg.norm(pg.kfs[-1].pose[0:3] - true_end)))
    hook_end = camera_position(np, system.pose_graph.kfs[-1].pose, ex_cam)
    errors["hook"] = (errors["4dof"][0], float(np.linalg.norm(hook_end - true_end)))
    return graphs, system, published, ms, errors, hook_err


def phase_revisit(torch, work_dir):
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    _zero_counters(klt, hamming)
    t0 = time.perf_counter()
    graphs, system, published, ms, errors, hook_err = run_revisit("cuda", work_dir)
    wall = time.perf_counter() - t0
    counts = _read_counters(klt, hamming)
    launches = counts["hamming_match"]
    n_kf = REVISIT_PLACES + REVISIT_AGAIN
    hook_pg = system.pose_graph
    matches = sum(pg.match_calls for pg in graphs.values()) + hook_pg.match_calls
    for name, pg in list(graphs.items()) + [("hook", hook_pg)]:
        before, after = errors[name]
        print(f"revisit {name}: {len(pg.kfs)} keyframes, {len(pg.loop_edges)} loop edges "
              f"{[e[0:2] for e in pg.loop_edges]}, {pg.match_calls} descriptor matches, "
              f"end error {before:.4f} m before optimize, {after:.4f} m after", flush=True)
        check(len(pg.kfs) == n_kf, f"revisit {name}: {len(pg.kfs)} keyframes")
        check(len(pg.loop_edges) >= 1, f"revisit {name}: no loop edge formed")
        check(after < REVISIT_ERROR_RATIO * before,
              f"revisit {name}: end error {after:.4f} m is not below "
              f"{REVISIT_ERROR_RATIO} x {before:.4f} m")
        check(bool(np.isfinite(np.stack([k.pose for k in pg.kfs])).all()),
              f"revisit {name}: non-finite keyframe pose")
        check(pg.db.hists.is_cuda and pg.db.valid.is_cuda,
              f"revisit {name}: the BoW tables are not on the GPU")
    for name, pg in (("4dof", graphs["4dof"]), ("hook", hook_pg)):
        check(pg.describes == {"cuda": n_kf}, f"revisit {name}: descriptors computed on {dict(pg.describes)}")
    n_edges = len(hook_pg.loop_edges)
    print(f"revisit hook: published loop_closure {published['loop_closure']}, path_update "
          f"{published['path_update']}; largest deviation from the drive's keyframes: world landmarks "
          f"{hook_err['pts3d_m']:.3e} m, normalized observations {hook_err['norm']:.3e}, window pixels "
          f"{hook_err['px']:.3e} px (float32 window on the card)", flush=True)
    check(published == {"loop_closure": n_edges, "path_update": n_edges},
          f"revisit hook: published {published} for {n_edges} loop edges")
    check(hook_err["pts3d_m"] <= HOOK_PTS_TOL_M,
          f"revisit hook: world landmarks {hook_err['pts3d_m']} m from the drive's > {HOOK_PTS_TOL_M}")
    check(hook_err["norm"] <= HOOK_NORM_TOL,
          f"revisit hook: observations {hook_err['norm']} from the drive's > {HOOK_NORM_TOL}")
    check(hook_err["px"] <= HOOK_PX_TOL,
          f"revisit hook: window pixels {hook_err['px']} px from the drive's > {HOOK_PX_TOL}")
    check(launches >= 1 and launches == matches and counts["hamming_matrix"] == 0,
          f"revisit: {launches} hamming_match and {counts['hamming_matrix']} hamming_matrix "
          f"launches for {matches} descriptor matches")
    check(counts["plain"] == 0, f"revisit: plain versions ran {counts['plain']} times")

    def med(v):
        return sorted(v)[len(v) // 2]

    revisits = ", ".join(f"{t:.2f}" for t in ms["add_keyframe"][REVISIT_PLACES:])
    print(f"revisit: describe median {med(ms['describe']):.2f} ms (640x480, 500 FAST + "
          f"{REVISIT_LANDMARKS} window points), add_keyframe median {med(ms['add_keyframe']):.2f} ms "
          f"over all {n_kf}, {revisits} ms for the {REVISIT_AGAIN} revisits (match, PnP; the first "
          f"PnP of the process included), optimize {ms['optimize_4dof'][0]:.2f} ms (4-DoF), "
          f"{ms['optimize_6dof'][0]:.2f} ms (6-DoF) over {n_kf} keyframes; system keyframe hook "
          f"median {med(ms['hook']):.2f} ms (transform, describe, add_keyframe; optimize on a new "
          f"edge), max {max(ms['hook']):.2f} ms; {wall:.1f} s wall, launches {counts}", flush=True)
    return counts


# --------------------------------------------------------------------------- 6


def _yaw_quat(np, yaw):
    return np.array([np.cos(yaw / 2), 0.0, 0.0, np.sin(yaw / 2)])


def large_graph(device, graph_6dof: bool, dense: bool = False):
    """A ``PoseGraph`` of LARGE_KEYFRAMES keyframes (VIO poses drifting
    REVISIT_YAW_DRIFT rad of yaw per keyframe around laps of LARGE_LAP
    keyframes on a REVISIT_RADIUS m circle) and loop edges with the true
    relative poses; ``dense`` lifts the graph's dense-solver limit so that
    ``optimize`` solves it densely. Returns the graph and the true end."""
    import dataclasses

    import numpy as np

    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.global_layers.pose_graph import Keyframe, PoseGraph

    cfg = load_yaml(CONFIG_PATH)
    cfg = dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, enabled=True,
                                                            graph_6dof=graph_6dof))
    pg = PoseGraph(cfg, device=device)
    if dense:
        pg.DENSE_NODE_LIMIT = 2 * LARGE_KEYFRAMES
    n = LARGE_KEYFRAMES
    th = 2 * np.pi * np.arange(n) / LARGE_LAP
    gt_p = REVISIT_RADIUS * np.stack([np.cos(th), np.sin(th), np.zeros(n)], -1)
    gt_yaw = th + np.pi / 2

    def rotz(y):
        c, s = np.cos(y), np.sin(y)
        return np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])

    none2, none8, none = np.zeros((0, 2)), np.zeros((0, 8), np.uint32), np.zeros(0, bool)
    vio_p, vio_yaw = gt_p[0].copy(), gt_yaw[0]
    for k in range(n):
        if k:
            vio_p = vio_p + rotz(vio_yaw) @ rotz(gt_yaw[k - 1]).T @ (gt_p[k] - gt_p[k - 1])
            vio_yaw = vio_yaw + (gt_yaw[k] - gt_yaw[k - 1]) + REVISIT_YAW_DRIFT
        pg.add_keyframe(Keyframe(index=k, t=float(k), pose=np.concatenate([vio_p, _yaw_quat(np, vio_yaw)]),
                                 kp=none2, kp_norm=none2, desc=none8, kp_ok=none,
                                 win_pts3d=np.zeros((0, 3)), win_norm=none2, win_desc=none8,
                                 win_ok=none), detect_loop=False)
    for j in range(LARGE_LAP, n, LARGE_LOOP_STEP):
        i = j - LARGE_LAP
        dy = float(gt_yaw[j] - gt_yaw[i])
        pg.loop_edges.append((i, j, rotz(gt_yaw[i]).T @ (gt_p[j] - gt_p[i]), dy, _yaw_quat(np, dy)))
    pg.earliest_loop = 0
    return pg, gt_p[-1]


def run_large_graph(torch, device, graph_6dof: bool, dense: bool = False):
    """``optimize`` on :func:`large_graph`: (poses [n,7] and drift as one
    flat array, end error before, after, ms)."""
    import numpy as np

    pg, true_end = large_graph(device, graph_6dof, dense)
    before = float(np.linalg.norm(pg.kfs[-1].pose[0:3] - true_end))
    t0 = time.perf_counter()
    pg.optimize()
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    flat = np.concatenate([np.stack([k.pose for k in pg.kfs]).ravel(), pg.r_drift.ravel(), pg.t_drift])
    return flat, before, float(np.linalg.norm(pg.kfs[-1].pose[0:3] - true_end)), ms


def synthetic_vocab(np, k: int, L: int, seed: int):
    """A balanced k-way vocabulary tree of L levels in the binary layout's
    arrays (root 0, children table, node descriptors, leaf words, weights)."""
    rng = np.random.default_rng(seed)
    n = sum(k ** d for d in range(L + 1))
    children = np.full((n, k), -1, np.int32)
    first_leaf = n - k ** L
    for pid in range(first_leaf):
        children[pid] = np.arange(pid * k + 1, pid * k + k + 1)
    node_desc = rng.integers(0, 2**32, (n, 8), dtype=np.uint32)
    node_word = np.full(n, -1, np.int32)
    node_word[first_leaf:] = np.arange(k ** L)
    node_weight = np.zeros(n)
    node_weight[first_leaf:] = rng.uniform(0.5, 2.0, k ** L)
    return children, node_desc, node_word, node_weight


def phase_solvers(torch, work_dir, device="cuda"):
    """Phase 6 on ``device`` (the card; ``"cpu"`` rehearses it on the CPU),
    each result held against the CPU's."""
    import numpy as np

    from ground_fusion_tpu_torch.global_layers import pose_graph
    from ground_fusion_tpu_torch.global_layers.dbow_vocab import (DBoW2Vocabulary, SparseBowDatabase,
                                                                  sparse_l1_scores)

    n_pad = pose_graph._pad_pow2(LARGE_KEYFRAMES, 16)
    check(n_pad > pose_graph.PoseGraph.DENSE_NODE_LIMIT,
          f"solvers: {n_pad} padded nodes do not pass the dense limit")
    for name, six in (("4dof", False), ("6dof", True)):
        cg, before, after, cg_ms = run_large_graph(torch, device, six)
        dense, _, _, dense_ms = run_large_graph(torch, device, six, dense=True)
        cpu, _, _, cpu_ms = run_large_graph(torch, "cpu", six)
        d_dense, d_cpu = float(np.abs(cg - dense).max()), float(np.abs(cg - cpu).max())
        print(f"solvers {name}: {LARGE_KEYFRAMES} keyframes ({n_pad} padded nodes), "
              f"{len(range(LARGE_LAP, LARGE_KEYFRAMES, LARGE_LOOP_STEP))} loop edges: PCG on the card "
              f"{cg_ms:.1f} ms, dense on the card {dense_ms:.1f} ms, PCG on the CPU {cpu_ms:.1f} ms; "
              f"card PCG vs card dense {d_dense:.3e}, vs CPU PCG {d_cpu:.3e} (tolerance {SOLVER_TOL}); "
              f"end error {before:.4f} m -> {after:.4f} m", flush=True)
        check(bool(np.isfinite(cg).all()), f"solvers {name}: non-finite result")
        check(d_dense <= SOLVER_TOL, f"solvers {name}: PCG {d_dense} from the dense solve")
        check(d_cpu <= SOLVER_TOL, f"solvers {name}: the card's PCG {d_cpu} from the CPU's")
        check(after < REVISIT_ERROR_RATIO * before, f"solvers {name}: end error {after} from {before}")

    tree = synthetic_vocab(np, VOCAB_K, VOCAB_L, seed=3)
    path = os.path.join(work_dir, "vocab.bin")
    DBoW2Vocabulary.save_binary(path, VOCAB_K, VOCAB_L, *tree)
    vocabs = {dev: DBoW2Vocabulary.load_binary(path, device=dev) for dev in (device, "cpu")}
    check(vocabs[device].children.device.type == torch.device(device).type,
          "solvers: the vocabulary is not on the card")
    rng = np.random.default_rng(4)
    leaves = np.nonzero(tree[2] >= 0)[0]
    sets = [np.concatenate([tree[1][rng.choice(leaves, 20)],
                            rng.integers(0, 2**32, (608, 8), dtype=np.uint32)]) for _ in range(8)]
    ok = np.ones(628, bool)
    ok[::50] = False
    words = {}
    for dev, voc in vocabs.items():
        desc = torch.as_tensor(sets[0].view(np.int32), device=dev)
        w, wt = voc.quantize(desc, torch.as_tensor(ok, device=dev))
        words[dev] = (w.cpu().numpy(), wt.cpu().numpy())
    check(np.array_equal(words[device][0], words["cpu"][0])
          and np.array_equal(words[device][1], words["cpu"][1]),
          "solvers: the vocabulary quantizes differently on the card")
    dbs = {dev: SparseBowDatabase(voc, capacity=4, min_gap=2) for dev, voc in vocabs.items()}
    answers = {dev: [] for dev in dbs}
    scores = {}
    for i, s in enumerate(sets):
        for dev, db in dbs.items():
            vec = db.bow_vector(s, ok)
            answers[dev].append(db.query(vec, i))
            db.add(vec, kf_index=i)
    for dev, db in dbs.items():
        q = db.bow_vector(sets[1], ok)
        scores[dev] = sparse_l1_scores(db.db_words, db.db_w, db.valid,
                                       torch.as_tensor(q[0], device=db.device),
                                       torch.as_tensor(q[1], device=db.device)).cpu().numpy()
    d_score = float(np.abs(scores[device] - scores["cpu"]).max())
    print(f"solvers dbow2: {len(tree[0])}-node vocabulary on the card, 628 descriptors quantized equal "
          f"to the CPU's, database grown to {dbs[device].capacity} slots, answers {answers[device]}, "
          f"scores within {d_score:.2e} of the CPU's", flush=True)
    check(answers[device] == answers["cpu"], f"solvers: database answers {answers}")
    check(d_score <= SCORE_TOL, f"solvers: scores {d_score} from the CPU's")
    check(abs(scores[device][1] - 1.0) <= SCORE_TOL, "solvers: a stored set does not score 1 against itself")


# --------------------------------------------------------------------------- 7


GNSS_CONFIG_PATH = os.path.join(ROOT, "configs", "m2dgrp.yaml")


class GnssWorld:
    """The truth of the GNSS drive: the simulator's world (z up) placed at
    the anchor, turned by the ENU-local yaw, with the receiver at the IMU of
    ``mounts`` (its position at t = 0 sits on the anchor)."""

    def __init__(self, np, sp, mounts):
        from ground_fusion_tpu_torch.gnss.coords import ecef2rotation, geo2ecef
        from ground_fusion_tpu_torch.sim.gnss import sky
        from ground_fusion_tpu_torch.sim.render import vehicle_T_imu

        self.np, self.sp = np, sp
        lat, lon, h = GNSS_ANCHOR_LLA_DEG
        self.anc = geo2ecef(np.array([np.deg2rad(lat), np.deg2rad(lon), h]))
        cy, sy = np.cos(GNSS_YAW), np.sin(GNSS_YAW)
        self.R = ecef2rotation(self.anc) @ np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
        self.r_x, self.t_x = vehicle_T_imu(mounts)
        self.p0 = self.p_imu(0.0)
        rng = np.random.default_rng(GNSS_SAT_SEED)
        self.sats = sky(self.anc, GNSS_SATS, rng, el_deg=GNSS_ELEVATION_DEG)
        self.sat_vel = rng.normal(0, 2500, (GNSS_SATS, 3))

    def p_imu(self, t):
        from ground_fusion_tpu_torch.sim.synthetic import gt_pose7
        from ground_fusion_tpu_torch.utils import np_quat

        p = gt_pose7(t, self.sp).numpy()
        return p[0:3] + np_quat.quat_to_mat(p[3:7]) @ self.t_x

    def ecef(self, p_sim):
        """ECEF of a point of the simulator's world."""
        return self.anc + self.R @ (self.np.asarray(p_sim) - self.p0)

    def epoch(self, t):
        from ground_fusion_tpu_torch.sim.gnss import observe

        h = 1e-3
        v = (self.p_imu(t + h) - self.p_imu(t - h)) / (2 * h)
        return observe(self.ecef(self.p_imu(t)), self.R @ v, self.sats, self.sat_vel,
                       self.np.asarray(GNSS_RCV_DT) + GNSS_RCV_DDT * t, GNSS_RCV_DDT)


def render_gnss_sequence(seq_dir: str, n_frames: int = GNSS_FRAMES):
    """The GNSS drive, from its seeds: the rendered frames, IMU, wheel and
    ground truth at ``configs/m2dgrp.yaml``'s intrinsics and mounts, plus
    ``gnss.csv`` (one epoch per frame) and ``gps.csv`` (a fix every
    GPS_EVERY frames). Returns the truth (:class:`GnssWorld`)."""
    import numpy as np

    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.gnss.coords import ecef2geo
    from ground_fusion_tpu_torch.sim.gnss import csv_rows
    from ground_fusion_tpu_torch.sim.render import Mounts, render_sequence
    from ground_fusion_tpu_torch.sim.synthetic import SimParams

    cfg = load_yaml(GNSS_CONFIG_PATH)
    cam, sp, mounts = cfg.camera, SimParams(**SMOKE_SIM), Mounts.from_config(cfg)
    render_sequence(seq_dir, n_frames, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                    sp=sp, n_landmarks=SMOKE_LANDMARKS, seed=SMOKE_SEED, mounts=mounts)
    world = GnssWorld(np, sp, mounts)
    ts = np.arange(n_frames) / sp.frame_rate
    np.savetxt(os.path.join(seq_dir, "gnss.csv"),
               np.concatenate([csv_rows(t, world.epoch(t)) for t in ts]), delimiter=",")
    fixes = []
    for t in ts[::GPS_EVERY]:
        lat, lon, h = ecef2geo(world.ecef(world.p_imu(t)))
        fixes.append([t, np.rad2deg(lat), np.rad2deg(lon), h, GPS_ACCURACY_M])
    np.savetxt(os.path.join(seq_dir, "gps.csv"), np.asarray(fixes), delimiter=",")
    return world


def gnss_errors(np, est, world, gt_path):
    """The estimator's global frame against the truth: (ECEF error of the
    newest pose, ECEF RMS over the poses solved since alignment, recovered
    and expected ENU-local yaw, error of the anchor). The local frame's yaw
    and origin in the simulator's world come from the newest pose against
    ``gt.csv``."""
    from ground_fusion_tpu_torch.gnss.coords import ecef2rotation
    from ground_fusion_tpu_torch.utils import np_quat

    yaw = float(est.core.state.yaw_enu)
    anc = est.anchor_ecef()
    cy, sy = np.cos(yaw), np.sin(yaw)
    R_est = ecef2rotation(anc) @ np.array([[cy, -sy, 0.0], [sy, cy, 0.0], [0.0, 0.0, 1.0]])
    gt = np.loadtxt(gt_path, ndmin=2)

    def truth(t):
        row = gt[np.argmin(np.abs(gt[:, 0] - t))]
        return row[1:4], np_quat.quat_to_mat(np.array([row[7], row[4], row[5], row[6]]))

    errs = []
    for t, p in est.trajectory:
        if t >= est.gnss_aligned_at:
            errs.append(np.linalg.norm(anc + R_est @ p[0:3] - world.ecef(truth(t)[0])))
    t_last, p_last = est.trajectory[-1]
    p_true, R_true = truth(t_last)
    R_sl = R_true @ np_quat.quat_to_mat(p_last[3:7]).T          # simulator ← local
    yaw_expected = GNSS_YAW + np.arctan2(R_sl[1, 0], R_sl[0, 0])
    anc_expected = world.ecef(p_true - R_sl @ p_last[0:3])
    return (errs[-1], float(np.sqrt(np.mean(np.square(errs)))), yaw,
            float(np.arctan2(np.sin(yaw_expected), np.cos(yaw_expected))),
            float(np.linalg.norm(anc - anc_expected)))


def psr_dopp_f32_at_truth(torch, device):
    """Largest float32 psr/Doppler row at ground truth on ``device``: the
    window of tests/test_gnss.py's float32 case (the default window,
    8 satellites, unit weights)."""
    import numpy as np

    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.estimator.layout import StateLayout
    from ground_fusion_tpu_torch.estimator.window import empty_state
    from ground_fusion_tpu_torch.gnss.coords import geo2ecef
    from ground_fusion_tpu_torch.gnss.factors import linearize_gnss_psr_dopp
    from ground_fusion_tpu_torch.sim.gnss import window_obs_at_truth

    cfg = Config()
    f = cfg.num_frames
    anc = geo2ecef(np.array([np.deg2rad(31.0), np.deg2rad(121.4), 15.0]))
    rng = np.random.default_rng(5)
    pos, vel = rng.normal(0, 2.0, (f, 3)), rng.normal(0, 0.5, (f, 3))
    dt_vals = np.tile([20.0, 0.0, 0.0, 35.0], (f, 1)) + np.arange(f)[:, None] * 0.5
    ddt_vals = np.full(f, 5.0)
    kw = dict(dtype=torch.float32, device=device)
    st = empty_state(f, **kw)
    st = st._replace(poses=torch.cat([torch.as_tensor(pos, **kw), st.poses[:, 3:]], 1),
                     sbs=torch.cat([torch.as_tensor(vel, **kw), st.sbs[:, 3:]], 1),
                     rcv_dt=torch.as_tensor(dt_vals, **kw), rcv_ddt=torch.as_tensor(ddt_vals, **kw),
                     yaw_enu=torch.tensor(0.3, **kw))
    obs = window_obs_at_truth(anc, 0.3, pos, vel, dt_vals, ddt_vals, **kw)
    ready = torch.ones((), dtype=torch.bool, device=device)
    _, r = linearize_gnss_psr_dopp(st, obs, ready, StateLayout(f, cfg.solver.max_landmarks))
    check(r.device.type == torch.device(device).type and r.dtype == torch.float32,
          f"gnss: rows on {r.device} in {r.dtype}")
    return float(r.abs().max())


def phase_gnss(torch, work_dir, main_times):
    import numpy as np

    from ground_fusion_tpu_torch.__main__ import run
    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    err_f32 = psr_dopp_f32_at_truth(torch, "cuda")
    print(f"gnss: float32 psr/Doppler rows at ground truth on the card: max {err_f32 * 1e3:.4f} mm "
          f"(bound {PSR_F32_BOUND_M * 1e3:.0f} mm)", flush=True)
    check(err_f32 < PSR_F32_BOUND_M, f"gnss: float32 rows {err_f32} m at ground truth")

    seq = os.path.join(work_dir, "gnss_seq")
    out = os.path.join(work_dir, "gnss_out")
    t0 = time.perf_counter()
    world = render_gnss_sequence(seq)
    print(f"gnss: rendered {GNSS_FRAMES} frames with GNSS and GPS files in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    _zero_counters(klt, hamming)
    t0 = time.perf_counter()
    system = run(GNSS_CONFIG_PATH, seq, out)          # device=None: the GPU
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = _read_counters(klt, hamming)

    est = system.estimator
    check(est.gnss_aligned, "gnss: GNSS-VI alignment never happened")
    aligned_frame = int(round(est.gnss_aligned_at * SMOKE_SIM["frame_rate"]))
    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    n_slots = int(est.core.gnss_obs.valid.sum())
    print(f"gnss: aligned at frame {aligned_frame}; {n_slots} valid GNSS slots in the final window; "
          f"{n_poses} poses over {path:.4f} m, ATE {ate:.5f} m (bounds {ATE_BOUND_M} m and "
          f"{ATE_BOUND_OF_PATH:.0%} of the path)", flush=True)
    check(n_slots > 0, "gnss: no valid GNSS slot in the final window")
    check(ate < ATE_BOUND_M, f"gnss: ATE {ate:.4f} m is not below {ATE_BOUND_M} m")
    check(ate < ATE_BOUND_OF_PATH * path,
          f"gnss: ATE {ate:.4f} m is not below {ATE_BOUND_OF_PATH:.0%} of {path:.3f} m")
    check(est.reboots == 0, "gnss: the estimator rebooted")
    check(est.core.state.poses.is_cuda and est.core.gnss_obs.psr_red.is_cuda,
          "gnss: the state or the GNSS table is not on the GPU")
    check(est.core.state.poses.dtype == torch.float32, "gnss: the state is not float32")

    last_err, rms, yaw, yaw_expected, anc_err = gnss_errors(np, est, world, os.path.join(seq, "gt.csv"))
    print(f"gnss: newest pose {last_err:.4f} m from its true ECEF position (bound {GNSS_ECEF_BOUND_M} m), "
          f"ECEF RMS {rms:.4f} m over the poses since alignment; yaw_enu {yaw:.6f} rad recovered, "
          f"{yaw_expected:.6f} expected ({yaw - yaw_expected:+.2e}); anchor {anc_err:.4f} m off", flush=True)
    check(last_err < GNSS_ECEF_BOUND_M, f"gnss: newest pose {last_err:.3f} m off in ECEF")

    tracked_frames = system.stats.counts["track"] - 1
    check(tracked_frames == GNSS_FRAMES - 1, f"gnss: {tracked_frames} tracked frames")
    check(counts["lk_track"] == tracked_frames,
          f"gnss: {counts['lk_track']} lk_track launches, expected {tracked_frames}")
    check(counts["lk_level"] == 0 and counts["plain"] == 0,
          f"gnss: {counts['lk_level']} lk_level launches, plain versions ran {counts['plain']} times")

    glob = np.loadtxt(os.path.join(out, "global.txt"), ndmin=2)
    check(len(glob) == len(est.trajectory) and bool(np.isfinite(glob).all()),
          f"gnss: {len(glob)} lines in global.txt for {len(est.trajectory)} solved frames")
    gf = system.global_fusion
    print(f"gnss: global.txt {len(glob)} finite poses, {len(gf.gps)} GPS fixes attached", flush=True)

    stats = system.stats
    times = stage_times(stats)
    print(f"gnss: track median {times['track'][0]:.2f} ms/frame (mean {times['track'][1]:.2f}; phase 4: "
          f"{main_times['track'][0]:.2f}, {main_times['track'][1]:.2f}), solve median "
          f"{times['solve'][0]:.2f} ms/frame (mean {times['solve'][1]:.2f}; phase 4: "
          f"{main_times['solve'][0]:.2f}, {main_times['solve'][1]:.2f}) over {stats.counts['solve']} frames", flush=True)
    print(f"gnss: {GNSS_FRAMES / wall:.3f} frames/s ({wall:.1f} s wall for {GNSS_FRAMES} frames), "
          f"launches {counts}", flush=True)
    return counts


# --------------------------------------------------------------------------- 8


# The path-C drive: the smoke sequence's camera, mounts and speed (0.45 m/s
# on the 3 m circle), but the vehicle is already moving at t = 0 (no
# standing start). The visual initializer's pivot search needs 20
# correspondences and a mean parallax above 30/460 between a window frame and
# the newest; over the window's 10 intervals the tracked features move by
# ~0.12 in normalized coordinates, ~50 of them seen in both (port's tracker
# on the CPU).
# The blobs' depths are 7x7-pixel patches, far smaller than a 7.8 cm TSDF
# voxel, so the drive's depth images also carry an untextured wall behind the
# landmarks (radius 6 m about the circle's centre): the surface the TSDF
# meshes and most of the map's points.
PATH_C_FRAMES = 32          # 22 poses after the SfM start at frame 10
PATH_C_SIM = dict(omega=0.15, frame_rate=30.0)
PATH_C_WALL_M = 6.0
PATH_C_MIN_POSES = 20


def path_c_config(work_dir: str) -> str:
    """``configs/groundchallenge.yaml`` as a copy in the work directory, with
    the wheel off and the stationary gate closed (so that only the visual
    initializer, path C, can start the estimator), loop closure and the
    dense map with its TSDF mesh on."""
    with open(CONFIG_PATH) as src:
        text = src.read()
    check("wheel:\n  enabled: true" in text, "path C: the config's wheel block moved")
    text = text.replace("wheel:\n  enabled: true", "wheel:\n  enabled: false")
    text = text.rstrip("\n") + ("\ninit:\n  stationary_acc_var: 0.0\nloop:\n  enabled: true\n"
                               "map:\n  enabled: true\n  mesh: true\n")
    path = os.path.join(work_dir, "groundchallenge_path_c.yaml")
    with open(path, "w") as dst:
        dst.write(text)
    return path


def render_path_c_sequence(seq_dir: str, n_frames: int = PATH_C_FRAMES) -> str:
    """The path-C drive, from its seed: ``n_frames`` frames at the camera and
    mounts of ``configs/groundchallenge.yaml``, moving from the first frame."""
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.sim.render import Mounts, render_sequence
    from ground_fusion_tpu_torch.sim.synthetic import SimParams

    cfg = load_yaml(CONFIG_PATH)
    cam = cfg.camera
    return render_sequence(seq_dir, n_frames, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                           cam.height, sp=SimParams(**PATH_C_SIM), n_landmarks=SMOKE_LANDMARKS,
                           seed=SMOKE_SEED, mounts=Mounts.from_config(cfg),
                           wall_radius=PATH_C_WALL_M)


class InitProbe:
    """Counts the estimator's initializers while a drive runs and times the
    visual initializer's ``sfm_construct`` and each keyframe's map insert
    (synchronized, so the times hold their device work): wraps the functions
    of ``ground_fusion_tpu_torch.pipeline`` and ``.system`` and puts them
    back on ``close``."""

    def __init__(self, torch):
        from ground_fusion_tpu_torch import pipeline, system

        self.torch, self.pipeline = torch, pipeline
        self.calls = {"stationary": 0, "wheel": 0, "visual": 0, "visual_ok": 0}
        self.sfm_ms, self.map_ms = [], []
        est, gfs = pipeline.Estimator, system.GroundFusionSystem
        self._saved = [(pipeline, "stationary_bias_init", pipeline.stationary_bias_init),
                       (pipeline, "sfm_construct", pipeline.sfm_construct),
                       (est, "_wheel_excitation_init", est._wheel_excitation_init),
                       (est, "_visual_initialize", est._visual_initialize),
                       (gfs, "_map_keyframe", gfs._map_keyframe)]
        probe = self

        def stationary(*a, **k):
            probe.calls["stationary"] += 1
            return self._saved[0][2](*a, **k)

        def sfm(*a, **k):
            dev = a[0].obs.device
            t0 = time.perf_counter()
            out = self._saved[1][2](*a, **k)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            probe.sfm_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        def wheel(est_self, *a, **k):
            probe.calls["wheel"] += 1
            return self._saved[2][2](est_self, *a, **k)

        def visual(est_self, *a, **k):
            probe.calls["visual"] += 1
            ok = self._saved[3][2](est_self, *a, **k)
            probe.calls["visual_ok"] += int(bool(ok))
            return ok

        def map_keyframe(sys_self, *a, **k):
            t0 = time.perf_counter()
            out = self._saved[4][2](sys_self, *a, **k)
            if sys_self.device.type == "cuda":
                torch.cuda.synchronize(sys_self.device)
            probe.map_ms.append((time.perf_counter() - t0) * 1e3)
            return out

        pipeline.stationary_bias_init = stationary
        pipeline.sfm_construct = sfm
        est._wheel_excitation_init = wheel
        est._visual_initialize = visual
        gfs._map_keyframe = map_keyframe

    def close(self):
        for obj, name, fn in self._saved:
            setattr(obj, name, fn)


def run_path_c(torch, work_dir, device=None, n_frames: int = PATH_C_FRAMES):
    """Render the path-C drive and run it through ``__main__.run``; returns
    (system, sequence directory, output directory, probe, wall seconds).
    ``device=None`` is the GPU; the CPU rehearses it (slowly)."""
    from ground_fusion_tpu_torch.__main__ import run

    seq = os.path.join(work_dir, "path_c_seq")
    out = os.path.join(work_dir, "path_c_out")
    render_path_c_sequence(seq, n_frames)
    cfg_path = path_c_config(work_dir)
    probe = InitProbe(torch)
    try:
        t0 = time.perf_counter()
        system = run(cfg_path, seq, out, device=device)
        if system.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        probe.close()
    return system, seq, out, probe, wall


def phase_path_c(torch, work_dir, main_times):
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    _zero_counters(klt, hamming)
    system, seq, out, probe, wall = run_path_c(torch, work_dir)
    counts = _read_counters(klt, hamming)
    est = system.estimator
    init_frame = int(round(est.trajectory[0][0] * PATH_C_SIM["frame_rate"])) if est.trajectory else -1
    print(f"path C: initializers called {probe.calls}; first pose at frame {init_frame}; "
          f"sfm_construct {', '.join(f'{ms:.1f}' for ms in probe.sfm_ms)} ms", flush=True)
    check(probe.calls["visual_ok"] >= 1 and probe.calls["stationary"] == 0
          and probe.calls["wheel"] == 0,
          f"path C: the estimator was not started by the visual initializer ({probe.calls})")
    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    print(f"path C: {n_poses} poses over {path:.4f} m, ATE {ate:.5f} m (bounds {ATE_BOUND_M} m and "
          f"{ATE_BOUND_OF_PATH:.0%} of the path), reboots {est.reboots}", flush=True)
    check(n_poses >= PATH_C_MIN_POSES, f"path C: only {n_poses} poses in vio.txt")
    check(ate < ATE_BOUND_M, f"path C: ATE {ate:.4f} m is not below {ATE_BOUND_M} m")
    check(ate < ATE_BOUND_OF_PATH * path,
          f"path C: ATE {ate:.4f} m is not below {ATE_BOUND_OF_PATH:.0%} of {path:.3f} m")
    check(est.reboots == 0, "path C: the estimator rebooted")
    check(est.core.state.poses.is_cuda and est.core.state.poses.dtype == torch.float32,
          "path C: the state is not float32 on the GPU")

    vm, tsdf = system.voxel_map, system.tsdf
    map_tensors = [vm.counts, vm.color_sum, vm.pos_sum, tsdf.tsdf, tsdf.weight, tsdf.color]
    map_tensors += [t for cloud in system._kf_clouds.values() for t in cloud]
    map_tensors += [t for rgbd in system._kf_rgbd.values() for t in rgbd]
    check(all(t.is_cuda for t in map_tensors), "path C: a map or TSDF tensor is not on the GPU")
    sizes = {name: os.path.getsize(os.path.join(out, name)) for name in ("map.ply", "mesh.ply")}
    n_vox = len(vm.export(system.cfg.map.density_gate)[0])
    n_kf = sum(est.keyframe_flags)
    print(f"path C: map.ply {sizes['map.ply']} bytes ({n_vox} voxels past the density gate), "
          f"mesh.ply {sizes['mesh.ply']} bytes; {len(system._kf_clouds)} keyframe clouds registered "
          f"of {n_kf} solved keyframes, {len(system.pose_graph.kfs)} keyframes in the pose graph", flush=True)
    check(n_vox > 0 and all(s > 300 for s in sizes.values()), f"path C: empty map or mesh ({sizes})")

    tracked_frames = system.stats.counts["track"] - 1
    check(tracked_frames == PATH_C_FRAMES - 1, f"path C: {tracked_frames} tracked frames")
    check(counts["lk_track"] == tracked_frames,
          f"path C: {counts['lk_track']} lk_track launches, expected {tracked_frames}")
    check(counts["lk_level"] == 0 and counts["plain"] == 0,
          f"path C: {counts['lk_level']} lk_level launches, plain versions ran {counts['plain']} times")
    check(counts["hamming_match"] == system.pose_graph.match_calls,
          f"path C: {counts['hamming_match']} hamming_match launches for "
          f"{system.pose_graph.match_calls} matches")

    stats = system.stats
    times = stage_times(stats)
    print(f"path C: track median {times['track'][0]:.2f} ms/frame (mean {times['track'][1]:.2f}; phase 4: "
          f"{main_times['track'][0]:.2f}), solve median {times['solve'][0]:.2f} ms/frame (mean "
          f"{times['solve'][1]:.2f}; phase 4: {main_times['solve'][0]:.2f}) over "
          f"{stats.counts['solve']} frames, map median {float(np.median(probe.map_ms)):.2f} "
          f"ms/keyframe (mean {float(np.mean(probe.map_ms)):.2f}; synchronized) over "
          f"{len(probe.map_ms)} keyframes", flush=True)
    print(f"path C: {PATH_C_FRAMES / wall:.3f} frames/s ({wall:.1f} s wall), launches {counts}", flush=True)
    return counts


# --------------------------------------------------------------------------- 9


# The rebuild scenario of tests/test_mapping.py (test_map_reanchors_after_loop)
# at full width: four keyframes of a wavy 480x640 depth surface mapped at
# poses that drift by (0.3, -0.25, 0.1) m a keyframe, then re-anchored at the
# true poses; the default voxel capacity (2^20) and the default 128^3 TSDF.
MAP_KEYFRAMES = 4
MAP_SUM_REL_TOL = 1e-4       # float sums scattered in another order on the card
MAP_TSDF_TOL = 1e-5
MAP_REPS = 20


def map_config(config_cls):
    import dataclasses

    cfg = config_cls()
    return dataclasses.replace(
        cfg,
        map=dataclasses.replace(cfg.map, enabled=True, voxel_size=0.05, depth_stride=16, mesh=True),
        loop=dataclasses.replace(cfg.loop, enabled=True))


def _wavy_depth(np, h=480, w=640):
    u, v = np.meshgrid(np.arange(w), np.arange(h))
    return (0.9 + 0.25 * np.sin(u / 37.0) * np.cos(v / 23.0) + 0.4 * u / w).astype(np.float32)


def _empty_keyframe(np, idx, pose):
    from ground_fusion_tpu_torch.global_layers.pose_graph import Keyframe

    z8, z = np.zeros((4, 8), np.uint32), np.zeros((4, 2))
    return Keyframe(index=idx, t=float(idx), pose=np.asarray(pose, float), kp=z, kp_norm=z,
                    desc=z8, kp_ok=np.zeros(4, bool), win_pts3d=np.zeros((4, 3)), win_norm=z,
                    win_desc=z8, win_ok=np.zeros(4, bool), vio_pose=np.asarray(pose, float))


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_rebuild(torch, device, out_dir):
    """The rebuild scenario on ``device``: (system, map before the rebuild as
    (counts, centers), ground-truth cloud, rebuild ms)."""
    import numpy as np

    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.geometry.se3 import pose_apply
    from ground_fusion_tpu_torch.global_layers.dense_map import sample_rgbd
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    system = GroundFusionSystem(map_config(Config), out_dir, device=device)
    depth, img = _wavy_depth(np), np.full((480, 640), 128.0, np.float32)
    gt = [np.array([0.25 * k, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0]) for k in range(MAP_KEYFRAMES)]
    drift = [g + np.r_[np.array([0.3, -0.25, 0.1]) * k, np.zeros(4)] for k, g in enumerate(gt)]
    for k in range(MAP_KEYFRAMES):
        system.pose_graph.kfs.append(_empty_keyframe(np, k, drift[k]))
        system._map_keyframe(drift[k], img, depth, register=k)
    # a copy: on the CPU, .numpy() would share the storage the rebuild clears
    before = (system.voxel_map.counts.cpu().numpy().copy(), system.voxel_map.export(1)[0])
    for k in range(MAP_KEYFRAMES):
        system.pose_graph.kfs[k] = system.pose_graph.kfs[k]._replace(pose=gt[k])
    t0 = time.perf_counter()
    system._rebuild_map()
    _sync(torch, system.device)
    rebuild_ms = (time.perf_counter() - t0) * 1e3
    # the truth: the same sampling and lift at the true poses
    dt = torch.as_tensor(depth, device=system.device)
    ct = torch.as_tensor(np.full(depth.shape + (3,), 128.0, np.float32), device=system.device)
    gx, gy, d, _, ok = sample_rgbd(dt, ct, stride=16, boundary=system.cfg.map.depth_boundary)
    rays = system.cam.lift_projective(torch.stack([gx, gy], -1).to(torch.float32))
    pts_c = rays / torch.clamp(torch.abs(rays[:, 2:3]), min=1e-9) * d[:, None]
    gt_cloud = np.concatenate([pose_apply(system._cam_pose(g), pts_c)[ok].cpu().numpy() for g in gt])
    return system, before, gt_cloud, rebuild_ms


def _nn_err(np, a, b):
    """Mean distance from each point of ``a`` to its nearest in ``b``."""
    best = np.full(len(a), np.inf)
    for i in range(0, len(b), 2048):
        d = np.linalg.norm(a[:, None, :] - b[None, i:i + 2048, :], axis=-1)
        best = np.minimum(best, d.min(axis=1))
    return float(best.mean())


def phase_map(torch, work_dir):
    import numpy as np

    torch.cuda.reset_peak_memory_stats()
    gpu, before_g, gt_cloud, rebuild_ms = run_rebuild(torch, "cuda", os.path.join(work_dir, "map_gpu"))
    cpu, before_c, _, _ = run_rebuild(torch, "cpu", os.path.join(work_dir, "map_cpu"))
    vg, vc = gpu.voxel_map, cpu.voxel_map
    counts_g, counts_c = vg.counts.cpu().numpy(), vc.counts.cpu().numpy()
    check(np.array_equal(before_g[0], before_c[0]), "map: counts before the rebuild differ from the CPU's")
    check(np.array_equal(counts_g, counts_c), "map: counts after the rebuild differ from the CPU's")
    slots_g, slots_c = np.nonzero(counts_g >= 1)[0], np.nonzero(counts_c >= 1)[0]
    check(np.array_equal(slots_g, slots_c), "map: the exported voxel set differs from the CPU's")
    rel = {}
    for name in ("color_sum", "pos_sum"):
        a, b = getattr(vg, name).cpu().numpy(), getattr(vc, name).cpu().numpy()
        rel[name] = float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))
    d_tsdf = max(float((getattr(gpu.tsdf, n).cpu() - getattr(cpu.tsdf, n)).abs().max())
                 for n in ("tsdf", "weight"))
    err0, err1 = _nn_err(np, before_g[1], gt_cloud), _nn_err(np, vg.export(1)[0], gt_cloud)
    print(f"map: {len(slots_g)} voxels in {MAP_KEYFRAMES} keyframes, counts and voxel set equal to the "
          f"CPU's; sums within {rel['color_sum']:.2e} / {rel['pos_sum']:.2e} relative (bound "
          f"{MAP_SUM_REL_TOL}); TSDF and weight within {d_tsdf:.2e} (bound {MAP_TSDF_TOL}); error to "
          f"the truth {err0:.4f} m drifted, {err1:.4f} m after the rebuild", flush=True)
    check(max(rel.values()) <= MAP_SUM_REL_TOL, f"map: sums {rel} from the CPU's")
    check(d_tsdf <= MAP_TSDF_TOL, f"map: TSDF {d_tsdf} from the CPU's")
    check(err0 > 0.08 and err1 < 0.05 and err1 < 0.3 * err0,
          f"map: the rebuild did not re-anchor ({err0:.3f} -> {err1:.3f} m)")

    # times on the card: one keyframe's insert and integrate, the rebuild of
    # four keyframes (host clock, synchronized), the mesh extraction (host)
    pts_cam, rgb, ok = gpu._kf_clouds[0]
    cam_pose = gpu._cam_pose(gpu.pose_graph.kfs[0].pose)
    from ground_fusion_tpu_torch.geometry.se3 import pose_apply

    pts_w = pose_apply(cam_pose, pts_cam)
    depth_t, color_t = (x.to(torch.float32) for x in gpu._kf_rgbd[0])
    p = gpu._cam_host
    insert_ms = _time_ms(torch, lambda: vg.insert(pts_w, rgb, ok), MAP_REPS)
    integrate_ms = _time_ms(torch, lambda: gpu.tsdf.integrate(
        depth_t, color_t, cam_pose, float(p.fx), float(p.fy), float(p.cx), float(p.cy)), MAP_REPS)
    rebuilds = []
    for _ in range(3):
        t0 = time.perf_counter()
        gpu._rebuild_map()
        _sync(torch, gpu.device)
        rebuilds.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    verts, _, tris = gpu.tsdf.extract_mesh()
    extract_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated() / 2**20
    # bounds: each input read once, each output written once. insert reads
    # the points, colours and mask and updates one slot per point (count,
    # colour and position sums); integrate reads the voxel centres, the
    # volume and the RGB-D image and writes the volume, ~40 operations a voxel
    n_pts, n_vox = len(ok), gpu.tsdf.n ** 3
    insert_bound, insert_by = _bound_ms(n_pts * (12 + 12 + 1 + 2 * 28), n_pts * 8, F32_FLOP_PER_S)
    integrate_bound, integrate_by = _bound_ms(
        n_vox * (12 + 2 * 20) + depth_t.numel() * 16, n_vox * 40, F32_FLOP_PER_S)
    print(f"map: bounds insert {insert_bound:.6f} ms ({insert_by}), integrate "
          f"{integrate_bound:.6f} ms ({integrate_by})")
    print(f"map: insert {insert_ms:.4f} ms ({len(ok)} points), integrate {integrate_ms:.4f} ms "
          f"({gpu.tsdf.n}^3 voxels), _rebuild_map {rebuild_ms:.2f} ms first, "
          f"{', '.join(f'{r:.2f}' for r in rebuilds)} ms again ({MAP_KEYFRAMES} keyframes), "
          f"extract_mesh {extract_ms:.1f} ms ({len(verts)} vertices, {len(tris)} triangles); "
          f"peak device memory {peak:.1f} MiB", flush=True)
    check(len(verts) > 0 and len(tris) > 0, "map: the TSDF gave no mesh")


# -------------------------------------------------------------------------- 10


# The lines drive: the smoke sequence (its motion, landmarks and seed) with
# the simulator's segments drawn; configs/groundchallenge.yaml with only
# use_line switched on (32 line slots, min_obs 5, 4 onlyLineOpt iterations).
# 96 segments (48 poles, 48 slanted edges, 4 in the image at a time): the
# drive moves forward, which gives a line ahead little of the 3.6 degrees of
# plane parallax that triangulation's 0.998 gate asks for; with 24 or 48
# segments no line triangulated in 40 frames (CPU rehearsals), with 96 one
# does at frame 24.
LINE_FRAMES = 40
LINE_SEGMENTS, LINE_SEGMENT_SEED = 96, 2
LINE_MIN_ACTIVE, LINE_MIN_SOLVED = 2, 1
LINE_TRACKER_PX_TOL = 1e-6


def line_config(work_dir: str) -> str:
    """``configs/groundchallenge.yaml`` as a copy in the work directory with
    ``use_line`` switched on and nothing else changed."""
    with open(CONFIG_PATH) as src:
        text = src.read()
    check(text.count("use_line: false") == 1, "lines: the config's use_line line moved")
    path = os.path.join(work_dir, "groundchallenge_lines.yaml")
    with open(path, "w") as dst:
        dst.write(text.replace("use_line: false", "use_line: true"))
    return path


def render_line_sequence(seq_dir: str, n_frames: int = LINE_FRAMES) -> str:
    """The lines drive, from its seeds: the smoke sequence with the
    simulator's segments drawn (CPU, float64)."""
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.sim.render import Mounts, render_sequence
    from ground_fusion_tpu_torch.sim.synthetic import SimParams, make_segments

    cfg = load_yaml(CONFIG_PATH)
    cam = cfg.camera
    sp = SimParams(**SMOKE_SIM)
    return render_sequence(seq_dir, n_frames, cam.fx, cam.fy, cam.cx, cam.cy, cam.width,
                           cam.height, sp=sp, n_landmarks=SMOKE_LANDMARKS, seed=SMOKE_SEED,
                           mounts=Mounts.from_config(cfg),
                           segments=make_segments(LINE_SEGMENTS, sp, seed=LINE_SEGMENT_SEED))


class LineProbe:
    """Records, at each window solve of a drive, how many line slots have
    live rows (``line_solve_mask``) and how many are triangulated, as device
    tensors read after the drive (no synchronization inside it): wraps
    ``estimator.step.solve_window`` and puts it back on ``close``."""

    def __init__(self):
        import torch

        from ground_fusion_tpu_torch.estimator import step
        from ground_fusion_tpu_torch.estimator.lines import line_solve_mask

        self.step, self.live, self.solved = step, [], []
        self._inner = inner = step.solve_window

        def solve_window(state, tracks, inp, layout, params, *a, lines=None, **k):
            if lines is not None:
                f = lines.obs_valid.shape[1]
                self.live.append(torch.sum(line_solve_mask(lines, f, inp.line_min_obs)))
                self.solved.append(torch.sum(lines.active & lines.solve_ok))
            return inner(state, tracks, inp, layout, params, *a, lines=lines, **k)

        step.solve_window = solve_window

    def counts(self):
        """(live line slots, solved line slots) at each solve, on the host."""
        return [int(x) for x in self.live], [int(x) for x in self.solved]

    def close(self):
        self.step.solve_window = self._inner


def run_lines(torch, work_dir, device=None, n_frames: int = LINE_FRAMES):
    """Render the lines drive and run it through ``__main__.run``; returns
    (system, sequence directory, output directory, probe, wall seconds).
    ``device=None`` is the GPU; the CPU rehearses it (slowly)."""
    from ground_fusion_tpu_torch.__main__ import run

    seq = os.path.join(work_dir, "lines_seq")
    out = os.path.join(work_dir, "lines_out")
    render_line_sequence(seq, n_frames)
    cfg_path = line_config(work_dir)
    probe = LineProbe()
    try:
        t0 = time.perf_counter()
        system = run(cfg_path, seq, out, device=device)
        if system.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        probe.close()
    return system, seq, out, probe, wall


def line_trackers_agree(torch, seq_dir: str, n_frames: int, devices=("cuda", "cpu")):
    """The port's ``LineTracker`` over the drive's images in float64 on each
    of ``devices``: checks the same ids every frame and endpoints within
    ``LINE_TRACKER_PX_TOL`` px; returns (frames, ids seen, largest endpoint
    difference in px)."""
    import numpy as np

    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.frontend.lines import LineTracker

    cfg = load_yaml(CONFIG_PATH)
    cam = cfg.camera
    trackers = [LineTracker(cam.fx, cam.fy, cam.cx, cam.cy, max_lines=cfg.lines.max_lines,
                            min_len_px=cfg.lines.min_seg_len_px, dtype=torch.float64, device=d)
                for d in devices]
    ids, worst = set(), 0.0
    for k in range(n_frames):
        img = np.load(os.path.join(seq_dir, "img", f"{k:05d}.npy"))
        a, b = (t.track(img) for t in trackers)
        check(sorted(a) == sorted(b), f"lines: frame {k}: the line ids on {devices[0]} and "
              f"{devices[1]} differ ({sorted(a)} vs {sorted(b)})")
        for lid in a:
            d = np.abs((a[lid] - b[lid]) * np.array([cam.fx, cam.fy, cam.fx, cam.fy])).max()
            worst = max(worst, float(d))
        ids |= set(a)
    check(worst <= LINE_TRACKER_PX_TOL,
          f"lines: endpoints on {devices[0]} and {devices[1]} {worst:.3e} px apart")
    return n_frames, len(ids), worst


def phase_lines(torch, work_dir, main_times):
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    _zero_counters(klt, hamming)
    system, seq, out, probe, wall = run_lines(torch, work_dir)
    counts = _read_counters(klt, hamming)
    est = system.estimator
    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    print(f"lines: {n_poses} poses over {path:.4f} m, ATE {ate:.5f} m (bounds {ATE_BOUND_M} m and "
          f"{ATE_BOUND_OF_PATH:.0%} of the path), reboots {est.reboots}", flush=True)
    check(n_poses >= 20, f"lines: only {n_poses} poses in vio.txt")
    check(ate < ATE_BOUND_M, f"lines: ATE {ate:.4f} m is not below {ATE_BOUND_M} m")
    check(ate < ATE_BOUND_OF_PATH * path,
          f"lines: ATE {ate:.4f} m is not below {ATE_BOUND_OF_PATH:.0%} of {path:.3f} m")
    check(est.reboots == 0, "lines: the estimator rebooted")
    check(bool(torch.isfinite(est.core.state.poses).all()), "lines: non-finite poses in the window")
    ln = est.core.lines
    check(ln is not None and all(t.is_cuda for t in ln), "lines: the line table is not on the GPU")
    check(est.core.state.poses.is_cuda and est.core.state.poses.dtype == torch.float32,
          "lines: the state is not float32 on the GPU")
    n_active = int(ln.active.sum())
    n_solved = int((ln.active & ln.solve_ok).sum())
    live, solved = probe.counts()
    first = next((i for i, n in enumerate(solved) if n > 0), None)
    first_frame = (int(round(est.trajectory[first][0] * SMOKE_SIM["frame_rate"]))
                   if first is not None else None)
    print(f"lines: {n_active} active line slots, {n_solved} solved at the end; {len(live)} solves, "
          f"{sum(n > 0 for n in live)} with live line rows (at most {max(live, default=0)} lines); "
          f"first triangulated line in the solve of frame {first_frame}; "
          f"{len(est.line_slot_of)} line ids in slots", flush=True)
    check(n_active >= LINE_MIN_ACTIVE, f"lines: only {n_active} active line slots at the end")
    check(n_solved >= LINE_MIN_SOLVED, f"lines: only {n_solved} solved line slots at the end")
    check(any(n > 0 for n in live), "lines: no solve had a live line row")

    tracked_frames = system.stats.counts["track"] - 1
    check(tracked_frames == LINE_FRAMES - 1, f"lines: {tracked_frames} tracked frames")
    check(system.stats.counts["lines"] == LINE_FRAMES,
          f"lines: the line tracker ran on {system.stats.counts['lines']} frames")
    check(counts["lk_track"] == tracked_frames,
          f"lines: {counts['lk_track']} lk_track launches, expected {tracked_frames}")
    check(counts["lk_level"] == 0 and counts["plain"] == 0,
          f"lines: {counts['lk_level']} lk_level launches, plain versions ran {counts['plain']} times")

    stats = system.stats
    times = {name: (stats.median(name), stats.mean(name)) for name in ("track", "lines", "solve")}
    print(f"lines: track median {times['track'][0]:.2f} ms/frame (mean {times['track'][1]:.2f}; "
          f"phase 4: {main_times['track'][0]:.2f}), lines median {times['lines'][0]:.2f} ms/frame "
          f"(mean {times['lines'][1]:.2f}), solve median {times['solve'][0]:.2f} ms/frame (mean "
          f"{times['solve'][1]:.2f}; phase 4: {main_times['solve'][0]:.2f}, mean "
          f"{main_times['solve'][1]:.2f}) over {stats.counts['solve']} frames", flush=True)
    print(f"lines: {LINE_FRAMES / wall:.3f} frames/s ({wall:.1f} s wall), launches {counts}", flush=True)

    t0 = time.perf_counter()
    n, n_ids, worst = line_trackers_agree(torch, seq, LINE_FRAMES)
    print(f"lines: LineTracker in float64 on the card and the CPU over {n} frames: the same ids "
          f"({n_ids} in all), endpoints at most {worst:.3e} px apart (bound {LINE_TRACKER_PX_TOL}); "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    return counts


# -------------------------------------------------------------------------- 11


def filled_core(cfg, dtype, device, b: int = 0):
    """(core, flags) of ``tests/test_burst.py::_filled_core`` in the port: an
    empty window whose every landmark slot is active and observed in every
    frame (observations from seed 0, measured depth 2 m, inverse depth
    0.5·(1 + 0.1·b), so the B sequences of a fleet differ), full IMU and
    wheel buffers of a vehicle at rest with 0.5 m/s on its wheels; the flags
    of a keyframe step."""
    import numpy as np
    import torch

    from ground_fusion_tpu_torch.estimator.assembly import empty_prior
    from ground_fusion_tpu_torch.estimator.buffers import empty_imu_buffer, empty_wheel_buffer
    from ground_fusion_tpu_torch.estimator.layout import StateLayout
    from ground_fusion_tpu_torch.estimator.step import EstimatorCore, StepFlags
    from ground_fusion_tpu_torch.estimator.window import empty_state, empty_tracks

    f, ml = cfg.num_frames, cfg.solver.max_landmarks
    kw = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    obs = np.zeros((ml, f, 5), np.float32)
    obs[..., 0] = rng.normal(0.1, 0.02, (ml, f))
    obs[..., 1] = rng.normal(-0.05, 0.02, (ml, f))
    obs[..., 4] = 2.0
    ones = torch.ones(ml, dtype=torch.bool, device=device)
    tracks = empty_tracks(ml, f, **kw)._replace(
        active=ones, solve_ok=ones.clone(), obs=torch.as_tensor(obs).to(**kw),
        obs_valid=torch.ones((ml, f), dtype=torch.bool, device=device),
        inv_depth=torch.full((ml,), 0.5, **kw) * (1.0 + 0.1 * b))
    ib = empty_imu_buffer(f, cfg.solver.max_imu_per_interval, **kw)
    ib = ib._replace(dts=torch.full_like(ib.dts, 0.005), valid=torch.ones_like(ib.valid),
                     acc=torch.cat([ib.acc[..., :2], torch.full_like(ib.acc[..., 2:], 9.805)], -1))
    wb = empty_wheel_buffer(f, cfg.solver.max_wheel_per_interval, **kw)
    wb = wb._replace(dts=torch.full_like(wb.dts, 0.01), valid=torch.ones_like(wb.valid),
                     vel=torch.cat([torch.full_like(wb.vel[..., :1], 0.5), wb.vel[..., 1:]], -1))
    core = EstimatorCore(state=empty_state(f, **kw), tracks=tracks, imu_buf=ib, wheel_buf=wb,
                         prior=empty_prior(StateLayout(f, ml), f, **kw))
    interval = torch.arange(f, device=device) >= 1
    flags = StepFlags(marg_old=True, stationary=torch.zeros((), dtype=torch.bool, device=device),
                      wheel_valid=interval, imu_valid=interval.clone(),
                      td_obs=torch.zeros(f, **kw))
    return core, flags


def flags_batch(flags, margs):
    """``flags`` with every tensor repeated along leading axes of the shape
    of the host bool array ``margs`` ([K] or [K, B]), ``marg_old = margs``."""
    import numpy as np

    margs = np.asarray(margs, bool)
    rep = lambda t: t.expand(margs.shape + tuple(t.shape)).clone()
    return type(flags)(*[np.asarray(margs) if name == "marg_old" else
                         (None if v is None else rep(v))
                         for name, v in zip(flags._fields, flags)])


def _wall_ms(torch, device, fn, reps: int = 1) -> float:
    """ms per call of ``fn`` on the host clock, synchronized on both ends."""
    device = torch.device(device)
    _sync(torch, device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(torch, device)
    return 1e3 * (time.perf_counter() - t0) / reps


def phase_modes_cli(torch, work_dir, main_times, device="cuda"):
    """11a: phase 4's sequence and config through the CLI with ``--burst 8``
    (``device="cpu"`` rehearses it on the CPU)."""
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import hamming, klt
    from ground_fusion_tpu_torch.pipeline import Estimator

    seq = head_sequence(os.path.join(work_dir, "seq"), os.path.join(work_dir, "seq_burst"),
                        MODES_CLI_FRAMES)
    out4 = os.path.join(work_dir, "out")
    out = os.path.join(work_dir, "out_burst")
    staged_fetches, fill_fetches = [], []
    fetch = Estimator._fetch_track_masks

    def counted(self):
        (staged_fetches if self.solver_flag == Estimator.NON_LINEAR else fill_fetches).append(1)
        return fetch(self)

    _zero_counters(klt, hamming)
    Estimator._fetch_track_masks = counted
    try:
        t0 = time.perf_counter()
        rc, system = run_cli([_loop_config(work_dir), seq, out, "--burst", str(BURST_CHUNK)]
                             + ([] if device == "cuda" else ["--device", device]))
        _sync(torch, torch.device(device))
        wall = time.perf_counter() - t0
    finally:
        Estimator._fetch_track_masks = fetch
    counts = _read_counters(klt, hamming)
    check(rc == 0 and system is not None, f"modes: the CLI with --burst returned {rc}")
    est = system.estimator

    # phase 4's poses over the same frames
    t_last = float(np.loadtxt(os.path.join(seq, "frames.csv"), delimiter=",", usecols=0)[-1])
    a = np.loadtxt(os.path.join(out4, "vio.txt"), ndmin=2)
    a = a[a[:, 0] <= t_last + 1e-6]
    n4 = len(a)
    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    sizes = est._burst_flushed_sizes
    print(f"modes: --burst {BURST_CHUNK}: {n_poses} poses (phase 4: {n4}) over {path:.4f} m, ATE "
          f"{ate:.5f} m, reboots {est.reboots}, chunks {sizes}", flush=True)
    check(n_poses == n4, f"modes: {n_poses} poses with --burst, {n4} per frame")
    check(ate < ATE_BOUND_M, f"modes: ATE {ate:.4f} m is not below {ATE_BOUND_M} m")
    check(ate < ATE_BOUND_OF_PATH * path,
          f"modes: ATE {ate:.4f} m is not below {ATE_BOUND_OF_PATH:.0%} of {path:.3f} m")
    check(est.reboots == 0, "modes: the estimator rebooted")
    check(est._burst_chunk == BURST_CHUNK, f"modes: burst chunk {est._burst_chunk}")
    check(all(t.device.type == device for t in list(est.core.state) + list(est.core.tracks)),
          f"modes: a state tensor is not on {device}")
    check(sizes and max(sizes) == BURST_CHUNK and all(0 < n <= BURST_CHUNK for n in sizes),
          f"modes: flushed chunks {sizes}")
    check(sum(sizes) == n_poses - 1, f"modes: {sum(sizes)} staged frames for {n_poses} poses")
    check(staged_fetches == [], f"modes: {len(staged_fetches)} mask fetches on staged frames")
    tracked_frames = system.stats.counts["track"] - 1
    check(tracked_frames == MODES_CLI_FRAMES - 1, f"modes: {tracked_frames} tracked frames")
    check(counts["lk_track"] == tracked_frames,
          f"modes: {counts['lk_track']} lk_track launches, expected {tracked_frames}")
    check(counts["lk_level"] == 0 and counts["plain"] == 0,
          f"modes: {counts['lk_level']} lk_level launches, plain versions ran {counts['plain']} times")
    loop_lines = np.loadtxt(os.path.join(out, "loop.txt"), ndmin=2)
    check(len(loop_lines) == len(system.pose_graph.kfs) >= 1,
          f"modes: {len(loop_lines)} lines in loop.txt for {len(system.pose_graph.kfs)} keyframes")

    b = np.loadtxt(os.path.join(out, "vio.txt"), ndmin=2)
    diff = float(np.abs(a[:, 1:4] - b[:, 1:4]).max()) if a.shape == b.shape else float("nan")
    stats = system.stats
    print(f"modes: --burst {BURST_CHUNK}: solve median {stats.median('solve'):.2f} ms/frame (mean "
          f"{stats.mean('solve'):.2f}; phase 4: {main_times['solve'][0]:.2f}, mean "
          f"{main_times['solve'][1]:.2f}) over {stats.counts['solve']} frames, "
          f"{MODES_CLI_FRAMES / wall:.3f} frames/s ({wall:.1f} s wall), {len(fill_fetches)} mask fetches "
          f"in the fill, {len(loop_lines)} keyframes in loop.txt, largest position difference "
          f"from phase 4's vio.txt {diff:.5f} m (not bounded: without prediction seeding the "
          f"tracker's features differ), launches {counts}", flush=True)
    print(f"modes: --burst {BURST_CHUNK}: seconds by stage {stage_times(stats)['sums']} "
          f"(phase 4: {main_times['sums']}), track median {stats.median('track'):.2f} ms/frame "
          f"(phase 4: {main_times['track'][0]:.2f})", flush=True)
    return counts


def phase_modes_replay(torch, device="cuda", n_frames=MODES_FRAMES):
    """11b: per frame, live and bursts of 8 on the same features."""
    import copy

    import numpy as np

    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.pipeline import Estimator
    from ground_fusion_tpu_torch.scripts.parity import feed_drive, simulator_drive

    cfg = Config()
    drive = simulator_drive(n_frames, n_landmarks=MODES_LANDMARKS)
    est = Estimator(cfg, dtype=torch.float64, device=None if device == "cuda" else device)
    feed_drive(est, drive, range(cfg.num_frames))
    check(est.solver_flag == Estimator.NON_LINEAR, "modes: the replay did not initialize")
    runs = {}
    for mode in ("frame", "live", "burst"):
        e = copy.deepcopy(est)
        if mode == "live":
            e.enable_live()
        elif mode == "burst":
            e.enable_burst(BURST_CHUNK)
        t0 = time.perf_counter()
        feed_drive(e, drive, range(cfg.num_frames, n_frames))
        e.flush_burst()
        _sync(torch, e.device)
        runs[mode] = (e, time.perf_counter() - t0)
    ref = np.stack([p[0:3] for _, p in runs["frame"][0].trajectory])
    n = n_frames - cfg.num_frames
    line = [f"{n} frames after the first solve: per frame {runs['frame'][1]:.1f} s"]
    for mode in ("live", "burst"):
        e, wall = runs[mode]
        got = np.stack([p[0:3] for _, p in e.trajectory])
        check(got.shape == ref.shape, f"modes: {mode} gave {len(got)} poses, per frame {len(ref)}")
        worst = float(np.abs(got - ref).max())
        check(worst <= MODES_POSE_TOL_M, f"modes: {mode} poses {worst:.3e} m from per frame")
        check(e.core.state.poses.device.type == device and e.reboots == 0,
              f"modes: {mode} state or reboot")
        line.append(f"{mode} {wall:.1f} s (chunks {e._burst_flushed_sizes}, poses at most "
                    f"{worst:.3e} m from per frame)")
    check(set(runs["live"][0]._burst_flushed_sizes) == {1}, "modes: live flushed a chunk of more than 1")
    print(f"modes: float64 on {device}, {cfg.num_frames}-frame window, "
          f"{cfg.solver.max_landmarks} landmarks: " + "; ".join(line), flush=True)


def phase_modes_fleet(torch, device="cuda", cfg=None):
    """11c: the fleet against four single bursts (at the default config, or
    ``cfg`` to rehearse it small)."""
    import numpy as np

    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.estimator.step import make_window_burst, make_window_burst_batched
    from ground_fusion_tpu_torch.utils.convert import stack_cores, unstack_cores

    cfg = cfg or Config()
    fleet, _ = make_window_burst_batched(cfg, None if device == "cuda" else device)
    single, _ = make_window_burst(cfg, None if device == "cuda" else device)
    margs = np.array([[(k + b) % 2 == 0 for b in range(FLEET_B)] for k in range(FLEET_K)])
    cores = [filled_core(cfg, torch.float64, device, b)[0] for b in range(FLEET_B)]
    _, flags = filled_core(cfg, torch.float64, device)
    res = {}
    fleet_ms = _wall_ms(torch, device, lambda: res.update(fleet=fleet(stack_cores(cores),
                                                                      flags_batch(flags, margs))))
    singles_ms = _wall_ms(torch, device, lambda: res.update(singles=[
        single(cores[b], flags_batch(flags, margs[:, b])) for b in range(FLEET_B)]))
    cb, ob = res["fleet"]
    worst = dict(step_pose=0.0, end_pose=0.0, inv_depth=0.0)
    for b, (end, (cs, os_)) in enumerate(zip(unstack_cores(cb), res["singles"])):
        for name, x, y in (("step_pose", ob["pose"][:, b], os_["pose"]),
                           ("end_pose", end.state.poses, cs.state.poses),
                           ("inv_depth", end.tracks.inv_depth, cs.tracks.inv_depth)):
            tol = FLEET_TOL[name]
            rtol = 1e-2 if name == "step_pose" else 1e-3
            check(bool(torch.allclose(x, y, rtol=rtol, atol=tol)),
                  f"modes: fleet sequence {b}: {name} off by {float((x - y).abs().max()):.3e}")
            worst[name] = max(worst[name], float((x - y).abs().max()))
        check(torch.equal(end.wheel_buf.bad, cs.wheel_buf.bad), f"modes: fleet sequence {b}: wheel_buf.bad")
    print(f"modes: fleet of {FLEET_B} ({cfg.num_frames}-frame window, {cfg.solver.max_landmarks} "
          f"landmarks), float64 on {device}, {FLEET_K} steps (marg_old = "
          f"(k + b) % 2 == 0): {fleet_ms / FLEET_K:.1f} ms per step of the fleet, "
          f"{singles_ms / FLEET_K:.1f} ms per step of the {FLEET_B} single bursts together; "
          f"largest differences {worst}", flush=True)


def phase_modes_preint(torch, device="cuda"):
    """11d: the log-depth window preintegration against the sequential loop."""
    import numpy as np

    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.estimator import buffers
    from ground_fusion_tpu_torch.preintegration.imu import noise_cov
    from ground_fusion_tpu_torch.preintegration.wheel import wheel_noise_cov

    cfg = Config()
    f, ki, kw = cfg.num_frames, cfg.solver.max_imu_per_interval, cfg.solver.max_wheel_per_interval
    rng = np.random.default_rng(11)
    dev = dict(dtype=torch.float64, device=device)

    def masks(k):
        m = rng.uniform(size=(f, k)) < 0.6
        m[0], m[1], m[2] = True, False, np.arange(k) < k // 3
        return torch.as_tensor(m, device=device)

    t = lambda a: torch.as_tensor(a).to(**dev)
    ib = buffers.ImuWindowBuffer(
        dts=t(rng.uniform(0.004, 0.006, (f, ki))),
        acc=t(rng.normal(0, 1.0, (f, ki, 3)) + [0, 0, 9.8]), gyr=t(rng.normal(0, 0.5, (f, ki, 3))),
        valid=masks(ki), acc0=t(rng.normal(0, 1.0, (f, 3)) + [0, 0, 9.8]),
        gyr0=t(rng.normal(0, 0.5, (f, 3))))
    wb = buffers.WheelWindowBuffer(
        dts=t(rng.uniform(0.008, 0.012, (f, kw))),
        vel=t(rng.normal(0.5, 0.1, (f, kw, 3)) * [1, 0.05, 0.0]), gyr=t(rng.normal(0, 0.3, (f, kw, 3))),
        valid=masks(kw), vel0=t(rng.normal(0.5, 0.1, (f, 3)) * [1, 0.05, 0.0]),
        gyr0=t(rng.normal(0, 0.3, (f, 3))), bad=torch.zeros(f, dtype=torch.bool, device=device))
    sbs = t(rng.normal(0, 0.05, (f, 9)))
    s_wheel, td = t([1.01, 0.99, 1.002]), t(0.003)
    n18 = noise_cov(cfg.imu.acc_n, cfg.imu.gyr_n, cfg.imu.acc_w, cfg.imu.gyr_w, **dev)
    n12 = wheel_noise_cov(cfg.wheel.vel_n, cfg.wheel.gyr_n, **dev)
    calls = {
        "imu": lambda par: buffers.preintegrate_imu_window(ib, sbs, n18, parallel=par),
        "wheel": lambda par: buffers.preintegrate_wheel_window(wb, s_wheel, td, n12, parallel=par),
    }
    line = []
    for name, fn in calls.items():
        par, seq = fn(True), fn(False)
        worst = max(float((a - b).abs().max()) for a, b in zip(par, seq))
        check(worst <= PREINT_TOL, f"modes: {name} log-depth preintegration {worst:.3e} from sequential")
        ms_par = _wall_ms(torch, device, lambda: fn(True), reps=5)
        ms_seq = _wall_ms(torch, device, lambda: fn(False), reps=5)
        line.append(f"{name} log-depth {ms_par:.2f} ms, sequential {ms_seq:.2f} ms a call "
                    f"(largest difference {worst:.3e})")
    print(f"modes: window preintegration at {f} intervals of {ki} IMU and {kw} wheel samples, "
          f"float64 on {device}: " + "; ".join(line), flush=True)


def phase_modes(torch, work_dir, main_times):
    counts = phase_modes_cli(torch, work_dir, main_times)
    phase_modes_replay(torch)
    phase_modes_fleet(torch)
    phase_modes_preint(torch)
    return counts


# -------------------------------------------------------------------------- 12

# Checkpoint and sharding (phase 12): run 1 takes the first CKPT_FRAMES frames
# of phase 4's sequence with the dense map on and saves its state; run 2
# resumes it over the first CKPT_DRIVE frames (a cut of phase 4's 40, to keep
# the phase near phase 4's wall time). The resumed poses are held to the
# oracle's bound (tests/test_checkpoint.py:147) and the republished prior grid
# to the PGM round trip's (tests/test_checkpoint.py:161).
CKPT_FRAMES, CKPT_DRIVE = 15, 26
RESUME_ATE_BOUND_M = 0.05
GRID_PROB_TOL = 0.02
RELOC_KEYFRAMES = 10
SHARD_WORLD = 2
SHARD_TIMEOUT_S = 300
SHARD_GRAPH_TOL = 1e-8       # tests/test_parallel.py, float64
# The landmark-sharded window step (12d) against the unsharded step, float64:
# poses and slid inverse depths, and the prior's information J0ᵀJ0 and
# gradient J0ᵀr0 (tests/test_parallel.py:54-75)
SHARD_STEP_TOL, SHARD_PRIOR_TOL = 1e-8, 1e-5


def _ckpt_config(work_dir: str) -> str:
    """Phase 4's config (``groundchallenge.yaml`` with loop closure) with the
    dense map on, without its mesh."""
    path = os.path.join(work_dir, "groundchallenge_ckpt.yaml")
    with open(_loop_config(work_dir)) as src, open(path, "w") as dst:
        dst.write(src.read().rstrip("\n") + "\nmap:\n  enabled: true\n  mesh: false\n")
    return path


def head_sequence(seq_dir: str, out_dir: str, n_frames: int) -> str:
    """A copy of ``seq_dir`` whose ``frames.csv`` lists only its first
    ``n_frames`` frames (the images are referenced by absolute path)."""
    os.makedirs(out_dir, exist_ok=True)
    for name in os.listdir(seq_dir):
        if name.endswith(".csv") and name != "frames.csv":
            shutil.copy(os.path.join(seq_dir, name), out_dir)
    with open(os.path.join(seq_dir, "frames.csv")) as src:
        rows = [r.strip().split(",") for r in src if r.strip()][:n_frames]
    with open(os.path.join(out_dir, "frames.csv"), "w") as dst:
        for r in rows:
            dst.write(",".join([r[0]] + [os.path.join(seq_dir, p.strip()) if p.strip() else ""
                                         for p in r[1:]]) + "\n")
    return out_dir


class FeedLog:
    """Records the timestamp of every frame and sensor row that reaches a
    ``GroundFusionSystem`` (its ``input_*`` methods wrapped on the class)."""

    NAMES = ("input_image", "input_imu", "input_wheel", "input_gnss", "input_gps_fix")

    def __init__(self):
        self.times = {name: [] for name in self.NAMES}

    def __enter__(self):
        from ground_fusion_tpu_torch.system import GroundFusionSystem

        self._saved = {name: getattr(GroundFusionSystem, name) for name in self.NAMES}
        for name, inner in self._saved.items():
            def wrapped(system, t, *a, _inner=inner, _log=self.times[name], **k):
                _log.append(float(t))
                return _inner(system, t, *a, **k)

            setattr(GroundFusionSystem, name, wrapped)
        return self

    def __exit__(self, *exc):
        from ground_fusion_tpu_torch.system import GroundFusionSystem

        for name, inner in self._saved.items():
            setattr(GroundFusionSystem, name, inner)


def run_cli(argv: list):
    """``__main__.main(argv)``; returns (exit code, the finished system)."""
    from ground_fusion_tpu_torch import __main__ as cli

    systems, run = [], cli.run

    def capture(*a, **k):
        systems.append(run(*a, **k))
        return systems[-1]

    cli.run = capture
    try:
        rc = cli.main(argv)
    finally:
        cli.run = run
    return rc, (systems[0] if systems else None)


def phase_checkpoint_cli(torch, work_dir, device="cuda"):
    """12a: save after CKPT_FRAMES frames of phase 4's sequence, build the
    grid, resume over CKPT_DRIVE frames with the graph and the grid."""
    import numpy as np

    from ground_fusion_tpu_torch.global_layers.dense_map import OccupancyGrid2D
    from ground_fusion_tpu_torch.ops.cuda import hamming, klt
    from ground_fusion_tpu_torch.scripts import build_grid

    seq, out4 = os.path.join(work_dir, "seq"), os.path.join(work_dir, "out")
    cfg_path = _ckpt_config(work_dir)
    head = head_sequence(seq, os.path.join(work_dir, "seq_head"), CKPT_FRAMES)
    drive = head_sequence(seq, os.path.join(work_dir, "seq_drive"), CKPT_DRIVE)
    out1, out2 = os.path.join(work_dir, "out_save"), os.path.join(work_dir, "out_resume")
    dev_args = [] if device == "cuda" else ["--device", device]

    _zero_counters(klt, hamming)
    t0 = time.perf_counter()
    rc, sys1 = run_cli([cfg_path, head, out1, "--save-state"] + dev_args)
    _sync(torch, torch.device(device))
    wall1 = time.perf_counter() - t0
    counts1 = _read_counters(klt, hamming)
    check(rc == 0 and sys1 is not None, f"checkpoint: run 1 returned {rc}")
    est1 = sys1.estimator
    check(est1.solver_flag == est1.NON_LINEAR, "checkpoint: run 1 did not reach the non-linear mode")
    for name in ("vio_state.npz", "pose_graph.npz", "map.ply"):
        check(os.path.exists(os.path.join(out1, name)), f"checkpoint: run 1 wrote no {name}")
    t_snap = est1.ts[-1]
    restored_ids = set(est1.slot_of)
    kfs1 = [(k.index, k.t) for k in sys1.pose_graph.kfs]

    grid_path = os.path.join(work_dir, "grid.pgm")
    t0 = time.perf_counter()
    check(build_grid.main([out1, grid_path] + dev_args) == 0, "checkpoint: build_grid failed")
    grid_s = time.perf_counter() - t0

    _zero_counters(klt, hamming)
    t0 = time.perf_counter()
    with FeedLog() as log:
        rc, sys2 = run_cli([cfg_path, drive, out2, "--resume", os.path.join(out1, "vio_state.npz"),
                            "--load-graph", os.path.join(out1, "pose_graph.npz"),
                            "--load-grid", grid_path] + dev_args)
    _sync(torch, torch.device(device))
    wall2 = time.perf_counter() - t0
    counts2 = _read_counters(klt, hamming)
    check(rc == 0 and sys2 is not None, f"checkpoint: run 2 returned {rc}")
    est2 = sys2.estimator

    # nothing at or before the snapshot is fed again
    fed = {name: np.asarray(ts) for name, ts in log.times.items()}
    early = {name: int((ts <= t_snap).sum()) for name, ts in fed.items() if len(ts)}
    check(not any(early.values()), f"checkpoint: rows at or before the snapshot fed again: {early}")
    n_after = CKPT_DRIVE - CKPT_FRAMES
    check(len(fed["input_image"]) == n_after,
          f"checkpoint: {len(fed['input_image'])} frames fed after the snapshot, expected {n_after}")

    # the resumed poses against the truth
    est = np.loadtxt(os.path.join(out2, "vio.txt"), ndmin=2)
    gt = np.loadtxt(os.path.join(seq, "gt.csv"), ndmin=2)
    check(bool(np.isfinite(est).all()), "checkpoint: non-finite pose in the resumed vio.txt")
    gt_i = np.stack([np.interp(est[:, 0], gt[:, 0], gt[:, i]) for i in (1, 2, 3)], -1)
    post = est[:, 0] > t_snap
    path = float(np.linalg.norm(np.diff(gt_i, axis=0), axis=1).sum())
    from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

    check(post.sum() >= n_after - 2, f"checkpoint: {int(post.sum())} poses after the snapshot")
    ate = float(ate_rmse(est[post, 1:4], gt_i[post]))
    print(f"checkpoint: snapshot at t = {t_snap:.4f} s (frame {CKPT_FRAMES - 1}); run 2: "
          f"{len(est)} poses ({int(post.sum())} after the snapshot), post-snapshot ATE {ate:.5f} m "
          f"(bounds {RESUME_ATE_BOUND_M} m and {ATE_BOUND_OF_PATH:.0%} of the {path:.4f} m path), "
          f"reboots {est2.reboots}", flush=True)
    check(ate < RESUME_ATE_BOUND_M, f"checkpoint: post-snapshot ATE {ate:.4f} m")
    check(ate < ATE_BOUND_OF_PATH * path, f"checkpoint: post-snapshot ATE {ate:.4f} m over {path:.3f} m")
    check(est2.reboots == 0, "checkpoint: the resumed estimator rebooted")
    check(all(t.device.type == device for t in list(est2.core.state) + list(est2.core.tracks)),
          f"checkpoint: a state tensor is not on {device}")

    # one lk_track launch per tracked frame (the first frame after the
    # resume has no previous image), no plain version
    tracked = sys2.stats.counts["track"] - 1
    check(tracked == n_after - 1, f"checkpoint: {tracked} tracked frames after the resume")
    if device == "cuda":
        check(counts2["lk_track"] == tracked and counts1["lk_track"] == CKPT_FRAMES - 1,
              f"checkpoint: {counts1['lk_track']} / {counts2['lk_track']} lk_track launches")
        check(counts1["plain"] == 0 and counts2["plain"] == 0, "checkpoint: a plain version ran")

    # the tracker's ids continue above the restored ones
    new_ids = set(est2.slot_of) - restored_ids
    check(sys2.tracker.next_id > max(restored_ids) and new_ids
          and min(new_ids) > max(restored_ids),
          f"checkpoint: new ids from {min(new_ids, default=None)}, restored up to {max(restored_ids)}")

    # loop.txt: the loaded keyframes, then the new ones, indices continuing
    kfs2 = [(k.index, k.t) for k in sys2.pose_graph.kfs]
    loop_lines = np.loadtxt(os.path.join(out2, "loop.txt"), ndmin=2)
    check(kfs2[: len(kfs1)] == kfs1 and [i for i, _ in kfs2] == list(range(len(kfs2)))
          and len(kfs2) > len(kfs1) and len(loop_lines) == len(kfs2)
          and np.allclose(loop_lines[: len(kfs1), 0], [t for _, t in kfs1], atol=1e-6),
          f"checkpoint: keyframes {kfs1} then {kfs2[len(kfs1):]}, {len(loop_lines)} lines in loop.txt")

    # the republished prior grid
    g0 = OccupancyGrid2D.load_pgm(grid_path, device="cpu")
    g1 = OccupancyGrid2D.load_pgm(os.path.join(out2, "prior_grid.pgm"), device="cpu")
    grid_err = float(np.abs(g1.probability() - g0.probability()).max())
    check(g1.n == g0.n and g1.res == g0.res and np.allclose(g1.origin, g0.origin)
          and grid_err <= GRID_PROB_TOL, f"checkpoint: prior_grid.pgm differs from grid.pgm ({grid_err})")
    check(sys2.prior_grid.logodds.device.type == device, "checkpoint: the prior grid is not on the device")
    occupied = int((g0.probability() > 0.6).sum())

    a = np.loadtxt(os.path.join(out4, "vio.txt"), ndmin=2)
    shared, ia, ib = np.intersect1d(np.round(a[:, 0], 6), np.round(est[post, 0], 6),
                                    return_indices=True)
    diff = float(np.abs(a[ia, 1:4] - est[post][ib, 1:4]).max()) if len(shared) else float("nan")
    print(f"checkpoint: run 1 {wall1:.1f} s ({CKPT_FRAMES} frames), grid {grid_s:.2f} s "
          f"({g0.n}x{g0.n} @ {g0.res} m, {occupied} occupied cells), run 2 {wall2:.1f} s "
          f"({n_after} frames); {len(kfs1)} loaded + {len(kfs2) - len(kfs1)} new keyframes, new ids "
          f"from {min(new_ids)} (restored up to {max(restored_ids)}), prior grid within "
          f"{grid_err:.4f}; largest position difference from phase 4's vio.txt at {len(shared)} "
          f"shared timestamps {diff:.5f} m (not bounded: the tracker restarts at the resume); "
          f"launches run 1 {counts1}, run 2 {counts2}", flush=True)
    return {k: counts1[k] + counts2[k] for k in counts1}


def reloc_texture(np, place: int):
    """The place texture of tests/test_pose_graph_e2e.py (120x160)."""
    from numpy.lib.stride_tricks import sliding_window_view

    r = np.random.default_rng(100 + place)
    img = np.kron(r.normal(0, 1, (30, 40)), np.ones((4, 4)))
    pad = np.pad(img, 2, mode="edge")
    img = np.einsum("ijkl->ij", sliding_window_view(pad, (5, 5))) / 25.0
    return (img - img.min()) / (img.max() - img.min()) * 255.0


def reloc_keyframe(np, pg, k: int, place: int, pose):
    """tests/test_checkpoint.py::_textured_kf on the port: a keyframe with
    the place's texture and 40 landmarks of the place in front of it."""
    from ground_fusion_tpu_torch.global_layers.pose_graph import Keyframe
    from ground_fusion_tpu_torch.utils import np_quat

    img = reloc_texture(np, place)
    r2 = np.random.default_rng(500 + place)
    pc = np.stack([r2.uniform(-1, 1, 40), r2.uniform(-0.8, 0.8, 40), r2.uniform(2, 5, 40)], -1)
    pts_w = pc @ np_quat.quat_to_mat(np.asarray(pose[3:7], np.float64)).T + pose[0:3]
    win_norm = pc[:, 0:2] / pc[:, 2:3]
    win_px = win_norm * 100 + np.array([80, 60])
    pts, ok, desc, win_desc = pg.describe(img, win_px)
    kp_norm = (np.asarray(pts) - np.array([80, 60])) / 100.0
    return Keyframe(
        index=k, t=float(k), pose=pose, kp=np.concatenate([np.asarray(pts), win_px]),
        kp_norm=np.concatenate([kp_norm, win_norm]), desc=np.concatenate([desc, win_desc]),
        kp_ok=np.concatenate([ok, np.ones(len(win_desc), bool)]), win_pts3d=pts_w,
        win_norm=win_norm, win_desc=win_desc, win_ok=np.ones(len(pts_w), bool))


def reloc_config():
    """The default config with tests/test_checkpoint.py's loop gates."""
    import dataclasses

    from ground_fusion_tpu_torch.config import Config

    cfg = Config()
    return dataclasses.replace(cfg, loop=dataclasses.replace(cfg.loop, min_loop_gap=5,
                                                             min_matches=12))


def reloc_graph(np, device, path: str):
    """Save the ten keyframes of tests/test_checkpoint.py:51 (a 3 m circle
    of places) from one graph to ``path``; returns the saved graph."""
    from ground_fusion_tpu_torch.global_layers.pose_graph import PoseGraph
    from ground_fusion_tpu_torch.utils.checkpoint import save_pose_graph

    pg = PoseGraph(reloc_config(), device=device)
    yaws = np.linspace(0, 2 * np.pi, RELOC_KEYFRAMES + 1)[:RELOC_KEYFRAMES]
    for k in range(RELOC_KEYFRAMES):
        pose = _yaw_pose(np, yaws[k], np.array([3 * np.cos(yaws[k]), 3 * np.sin(yaws[k]), 0.0]))
        pg.add_keyframe(reloc_keyframe(np, pg, k, k, pose))
    save_pose_graph(path, pg)
    return pg


def relocalize(np, pg):
    """Add a drifted revisit of place 0 to ``pg``; returns the new loop
    edges (test_checkpoint.py:75-85)."""
    n_edges = len(pg.loop_edges)
    pose = _yaw_pose(np, 0.02, np.array([3.0 + 0.08, -0.05, 0.0]))
    pg.add_keyframe(reloc_keyframe(np, pg, RELOC_KEYFRAMES, 0, pose))
    return pg.loop_edges[n_edges:]


def phase_checkpoint_reloc(torch, work_dir, device="cuda"):
    """12b: relocalization against a loaded graph."""
    import numpy as np

    from ground_fusion_tpu_torch.global_layers.pose_graph import PoseGraph
    from ground_fusion_tpu_torch.ops.cuda import hamming, klt
    from ground_fusion_tpu_torch.utils.checkpoint import load_pose_graph

    path = os.path.join(work_dir, "reloc_graph.npz")
    _zero_counters(klt, hamming)
    saved = reloc_graph(np, device, path)
    pg = PoseGraph(reloc_config(), device=device)
    t0 = time.perf_counter()
    load_pose_graph(path, pg)
    _sync(torch, torch.device(device))
    load_ms = 1e3 * (time.perf_counter() - t0)
    check(len(pg.kfs) == RELOC_KEYFRAMES and pg.db.count == RELOC_KEYFRAMES
          and pg.db.hists.device.type == device, "reloc: the loaded graph")
    check(np.array_equal(pg.kfs[3].pose, saved.kfs[3].pose)
          and np.array_equal(pg.kfs[3].vio_pose, saved.kfs[3].vio_pose)
          and pg.kfs[3].desc.dtype == np.uint32 and pg.kfs[3].kp_ok.dtype == bool,
          "reloc: a loaded keyframe differs from the saved one")
    check(torch.equal(pg.db.hists, saved.db.hists), "reloc: the loaded BoW table differs")
    match_calls = saved.match_calls
    edges = relocalize(np, pg)
    counts = _read_counters(klt, hamming)
    check(edges and edges[-1][0] < RELOC_KEYFRAMES,
          f"reloc: no loop edge against a loaded keyframe ({edges})")
    matches = match_calls + pg.match_calls
    if device == "cuda":
        check(counts["hamming_match"] == matches and counts["plain"] == 0,
              f"reloc: {counts['hamming_match']} hamming_match launches for {matches} matches")
    print(f"reloc: {RELOC_KEYFRAMES} keyframes saved and loaded in {load_ms:.1f} ms, a revisit of "
          f"place 0 closed a loop against loaded keyframe {edges[-1][0]} "
          f"(yaw {edges[-1][3]:.4f}), launches {counts}", flush=True)
    return counts


def sharded_graph_problem(np):
    """The graph of tests/test_parallel.py::test_sharded_pose_graph_matches_single
    (24 nodes, sequential edges to 2 predecessors, noisy initial values,
    node 0 fixed), as numpy arrays; 6 iterations."""
    rng = np.random.default_rng(5)
    n = 24
    gt_yaw = np.cumsum(rng.normal(0, 0.1, n))
    gt_t = np.cumsum(rng.normal(0, 0.5, (n, 3)), axis=0)
    yaws0 = gt_yaw + rng.normal(0, 0.05, n)
    ts0 = gt_t + rng.normal(0, 0.1, (n, 3))
    yaws0[0], ts0[0] = gt_yaw[0], gt_t[0]

    def rotz(y):
        c, s = np.cos(y), np.sin(y)
        return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1.0]])

    ei, ej, tij, yij = [], [], [], []
    for j in range(1, n):
        for i in (j - 1, j - 2):
            if i >= 0:
                ei.append(i)
                ej.append(j)
                tij.append(rotz(gt_yaw[i]).T @ (gt_t[j] - gt_t[i]))
                yij.append(gt_yaw[j] - gt_yaw[i])
    e = len(ei)
    return dict(n=n, iters=6, gt_t=gt_t, yaws0=yaws0, ts0=ts0, i=np.asarray(ei),
                j=np.asarray(ej), t_ij=np.stack(tij), yaw_ij=np.asarray(yij),
                pitch_i=np.zeros(e), roll_i=np.zeros(e), w_t=np.ones(e), w_yaw=np.ones(e),
                valid=np.ones(e, bool))


def dryrun_core(cfg, dtype, device, seed: int = 0):
    """(core, flags) filled as the JAX driver's multichip dryrun fills its
    core (``__graft_entry__.py:105-148``), at ``cfg``'s widths: frames 0.1 m
    apart along x (1 m/s, the speed of the dryrun's wheel), every landmark
    and line slot active and seen in every frame, the IMU and wheel buffers
    full (gravity and the wheel's 1 m/s, a frame interval of 0.1 s), and
    with GNSS one satellite in epoch slot F-2 at the dryrun's ENU vector.
    Where the dryrun repeats one value, ``seed`` draws the scene: each
    landmark a point 2-6 m ahead, seen at its projections plus 1e-3 noise
    with its measured depth, its inverse depth the truth times 1 + 0.05 N;
    each line a 0.8 m segment 3-5 m ahead, seen at its projected endpoints
    plus 5e-4 noise, the first half of the slots triangulated (their true
    line plus 1e-3), the rest upright and waiting for triangulation. The flags are the
    dryrun's keyframe flags: ``marg_old`` and ``first_gnss_opt`` set
    (:func:`dryrun_flags` for the other branch)."""
    import numpy as np
    import torch

    from ground_fusion_tpu_torch.estimator.assembly import empty_prior
    from ground_fusion_tpu_torch.estimator.buffers import empty_imu_buffer, empty_wheel_buffer
    from ground_fusion_tpu_torch.estimator.layout import StateLayout
    from ground_fusion_tpu_torch.estimator.lines import empty_line_tracks
    from ground_fusion_tpu_torch.estimator.step import EstimatorCore
    from ground_fusion_tpu_torch.estimator.window import empty_state, empty_tracks
    from ground_fusion_tpu_torch.frontend.lines import plk_to_orth
    from ground_fusion_tpu_torch.gnss.factors import empty_gnss_obs

    f, ml = cfg.num_frames, cfg.solver.max_landmarks
    kw = dict(dtype=dtype, device=device)
    rng = np.random.default_rng(seed)
    cam_x = 0.1 * np.arange(f)                 # identity rotations and extrinsics
    mid = 0.5 * cam_x[-1]
    pts = np.stack([mid + rng.uniform(-1.5, 1.5, ml), rng.uniform(-0.8, 0.8, ml),
                    rng.uniform(2.0, 6.0, ml)], -1)
    rel = pts[:, None, :] - np.stack([cam_x, 0 * cam_x, 0 * cam_x], -1)[None]    # [ML,F,3]
    obs = np.zeros((ml, f, 5))
    obs[..., 0:2] = rel[..., 0:2] / rel[..., 2:3] + 1e-3 * rng.normal(size=(ml, f, 2))
    obs[..., 4] = rel[..., 2]
    ones = torch.ones(ml, dtype=torch.bool, device=device)
    tracks = empty_tracks(ml, f, **kw)._replace(
        active=ones, solve_ok=ones.clone(), obs=torch.as_tensor(obs).to(**kw),
        obs_valid=torch.ones((ml, f), dtype=torch.bool, device=device),
        inv_depth=torch.as_tensor((1.0 + 0.05 * rng.normal(size=ml)) / pts[:, 2]).to(**kw))
    state = empty_state(f, **kw)
    poses = state.poses.clone()
    poses[:, 0] = torch.as_tensor(cam_x).to(**kw)
    sbs = state.sbs.clone()
    sbs[:, 0] = 1.0
    state = state._replace(poses=poses, sbs=sbs,
                           anc_ecef=torch.tensor([1.5, -0.8, 0.2], **kw))
    ib = empty_imu_buffer(f, cfg.solver.max_imu_per_interval, **kw)
    ib = ib._replace(dts=torch.full_like(ib.dts, 0.1 / ib.dts.shape[1]),
                     valid=torch.ones_like(ib.valid),
                     acc=torch.cat([ib.acc[..., :2], torch.full_like(ib.acc[..., 2:], 9.805)], -1))
    wb = empty_wheel_buffer(f, cfg.solver.max_wheel_per_interval, **kw)
    wb = wb._replace(dts=torch.full_like(wb.dts, 0.1 / wb.dts.shape[1]),
                     valid=torch.ones_like(wb.valid),
                     vel=torch.cat([torch.full_like(wb.vel[..., :1], 1.0), wb.vel[..., 1:]], -1))
    ll = cfg.lines.max_lines if cfg.use_line else 0
    core = EstimatorCore(state=state, tracks=tracks, imu_buf=ib, wheel_buf=wb,
                         prior=empty_prior(StateLayout(f, ml, ll), f, **kw))
    if cfg.use_line:
        centre = np.stack([mid + rng.uniform(-1.0, 1.0, ll), rng.uniform(-0.5, 0.5, ll),
                           rng.uniform(3.0, 5.0, ll)], -1)
        solved = np.arange(ll) < (ll + 1) // 2
        d = rng.normal(size=(ll, 3))
        d[~solved] = [0.0, 1.0, 0.0] + 0.2 * d[~solved]      # upright: parallax across the motion
        d /= np.linalg.norm(d, axis=1, keepdims=True)
        a, b = centre - 0.4 * d, centre + 0.4 * d
        cams = np.stack([cam_x, 0 * cam_x, 0 * cam_x], -1)[None]                   # [1,F,3]
        ra, rb = a[:, None] - cams, b[:, None] - cams
        lobs = np.concatenate([ra[..., 0:2] / ra[..., 2:3], rb[..., 0:2] / rb[..., 2:3]], -1)
        lobs = lobs + 5e-4 * rng.normal(size=(ll, f, 4))
        plk = torch.as_tensor(np.concatenate([np.cross(a, b), b - a], -1))       # frame 0 = world
        orth = plk_to_orth(plk).numpy() + 1e-3 * rng.normal(size=(ll, 4))
        lines = empty_line_tracks(ll, f, **kw)._replace(
            orth=torch.as_tensor(np.where(solved[:, None], orth, 0.0)).to(**kw),
            active=torch.ones(ll, dtype=torch.bool, device=device),
            solve_ok=torch.as_tensor(solved, device=device),
            obs=torch.as_tensor(lobs).to(**kw),
            obs_valid=torch.ones((ll, f), dtype=torch.bool, device=device))
        core = core._replace(lines=lines)
    if cfg.gnss.enabled:
        g = empty_gnss_obs(f, cfg.gnss.max_sats, **kw)
        rvec = torch.tensor([-0.5e7, 2.0e7, 1.2e7], **kw)
        at = lambda t, v: torch.cat([t[: f - 2], torch.cat([v[None], t[f - 2, 1:]])[None],
                                     t[f - 1:]])
        g = g._replace(rvec0=at(g.rvec0, rvec), rng0=at(g.rng0, torch.linalg.norm(rvec)),
                       psr_red=at(g.psr_red, torch.tensor(5.0, **kw)),
                       pr_weight=at(g.pr_weight, torch.tensor(1.0, **kw)),
                       dp_weight=at(g.dp_weight, torch.tensor(1.0, **kw)),
                       valid=at(g.valid, torch.tensor(True, device=device)))
        core = core._replace(gnss_obs=g)
    return core, dryrun_flags(cfg, dtype, device, True)


def dryrun_flags(cfg, dtype, device, marg_old: bool):
    """The dryrun's step flags for one branch (``__graft_entry__.py:151-161``):
    IMU and wheel intervals live, IMU propagation of the newest slot, with
    GNSS ready, frame intervals of 0.1 s, the yaw free and the first-solve
    pose anchor set with ``marg_old``."""
    import torch

    from ground_fusion_tpu_torch.estimator.step import StepFlags

    f = cfg.num_frames
    interval = torch.arange(f, device=device) >= 1
    b = lambda v: torch.tensor(v, device=device)
    gnss = {}
    if cfg.gnss.enabled:
        gnss = dict(gnss_ready=b(True), frame_dts=torch.full((f,), 0.1, dtype=dtype, device=device),
                    fix_yaw_enu=b(False), first_gnss_opt=b(marg_old))
    return StepFlags(marg_old=marg_old, stationary=b(False), wheel_valid=interval,
                     imu_valid=interval.clone(), td_obs=torch.zeros(f, dtype=dtype, device=device),
                     propagate_newest=b(True), **gnss)


def shard_step_cases(width: str) -> dict:
    """The configurations of the landmark-sharded step's checks, by name.
    ``small`` (tests/test_torch_sharded_step.py): window 4, 16 landmarks,
    plane on, 8 IMU and wheel samples an interval, 2 dogleg iterations (each
    iteration costs the CPU ~0.6 s of dispatch); ``jax`` without lines or
    GNSS (the JAX package's program of that config compiles in ~35 s on a
    CPU), ``full`` with the dryrun's factor set (2 line slots at ``min_obs``
    3, so that a line still triangulates after a slide out of the 5-frame
    window; GNSS with 4 satellites), ``dense`` and ``lm`` the same with ``linear_solver:
    dense`` and ``method: lm``. ``full`` (phase 12d): ``groundchallenge``
    (``configs/groundchallenge.yaml`` unchanged, on :func:`filled_core`) and
    ``m2dgrp_lines`` (``configs/m2dgrp.yaml`` with ``use_line`` and
    ``plane.enabled``: 128 landmark and 32 line slots, 16 satellites, on
    :func:`dryrun_core`)."""
    import dataclasses

    from ground_fusion_tpu_torch.config import Config, load_yaml

    rep = dataclasses.replace
    if width == "full":
        m2 = load_yaml(os.path.join(ROOT, "configs", "m2dgrp.yaml"))
        return {"groundchallenge": load_yaml(os.path.join(ROOT, "configs", "groundchallenge.yaml")),
                "m2dgrp_lines": rep(m2, use_line=True, plane=rep(m2.plane, enabled=True))}
    cfg = Config()
    jax_cfg = rep(cfg, plane=rep(cfg.plane, enabled=True), solver=rep(
        cfg.solver, window_size=4, max_landmarks=16, max_imu_per_interval=8,
        max_wheel_per_interval=8, max_iters=2))
    full = rep(jax_cfg, use_line=True, lines=rep(cfg.lines, max_lines=2, min_obs=3),
               gnss=rep(cfg.gnss, enabled=True, max_sats=4))
    return {"jax": jax_cfg, "full": full,
            "dense": rep(full, solver=rep(full.solver, linear_solver="dense")),
            "lm": rep(full, solver=rep(full.solver, method="lm"))}


def shard_case(name: str, cfg, dtype, device):
    """The starting core of a case of :func:`shard_step_cases` and its
    flags for a branch: ``(core, flags_of(marg_old))``."""
    if name == "groundchallenge":
        core, flags = filled_core(cfg, dtype, device)
        return core, lambda marg_old: flags._replace(marg_old=marg_old)
    return (dryrun_core(cfg, dtype, device)[0],
            lambda marg_old: dryrun_flags(cfg, dtype, device, marg_old))


# the steps of a case: (branch, start) with start the index of the step whose
# result the step starts from (None: the case's core); the first two are the
# oracle's two branches from one core, the last two go on from the keyframe
# step's core, whose prior is valid (prior rows; line triangulation)
SHARD_CHAIN = ((True, None), (False, None), (True, 0), (False, 0))


def _flat_arrays(tree, prefix: str) -> dict:
    """A core or an output dict → ``{prefix + dotted path: numpy array}``."""
    from ground_fusion_tpu_torch.utils.checkpoint import core_to_arrays

    if isinstance(tree, dict):
        return {f"{prefix}{k}": v.detach().cpu().numpy() for k, v in tree.items()}
    return core_to_arrays(tree, prefix)


def run_step_cases(rank: int, width: str, dev, core_path: str = "") -> dict:
    """The window-step half of a shard rank: for each case of
    :func:`shard_step_cases` the steps of :data:`SHARD_CHAIN` through the
    landmark-sharded step (at full width its first three, to keep 12d near
    a minute; ``dense`` and ``lm`` the first two), in float64 and, at full
    width, both branches once more in float32; at small width ``lm`` runs
    its keyframe step in float32 too (``lm_f32``: the step whose prior
    square root met an ``eigh`` that did not converge, on a CPU, before
    ``marginalization._sqrt_factorize`` stopped handing a Cholesky-factored
    H to ``eigh``). Records each step's output and replicated core, the whole
    slid tables (:func:`gather_core`), the reductions and the ms (CUDA
    events on the card). Then the same steps through the unsharded
    step, with their ms, outputs and cores: at full width on rank 0 alone
    (so that nothing else runs on the card while they are timed), at small
    width each case's on one rank in turn. At small width it also checks
    ``gather_core(shard_core(core))`` and the divisibility errors. With
    ``core_path`` (an npz of ``core.*`` and ``flags.*`` arrays) the one case
    is the default config on that core, both branches from it
    (``tests/test_parallel.py``'s oracle)."""
    import numpy as np
    import torch

    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.estimator.step import make_window_step
    from ground_fusion_tpu_torch.parallel import sharded
    from ground_fusion_tpu_torch.utils.checkpoint import core_from_arrays

    def timed(fn, *args):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args)
            end.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(end)
        t0 = time.perf_counter()
        out = fn(*args)
        return out, 1e3 * (time.perf_counter() - t0)

    def run_chain(step, core0, flags_of, chain, key0, record):
        done = []
        for k, (marg_old, start) in enumerate(chain):
            (core, out), ms = timed(step, core0 if start is None else done[start],
                                    flags_of(marg_old))
            done.append(core)
            record(f"{key0}.{k}.", step, core, out, ms)

    f64 = torch.float64
    world = sharded._rank_world(None)[1]
    group = sharded.make_lm_mesh(world)
    if core_path:
        cfg = Config()
        with np.load(core_path, allow_pickle=False) as z:
            data = {k: z[k] for k in z.files}
        core0 = core_from_arrays(data, dryrun_core(cfg, f64, dev)[0], prefix="core.")
        flags = dryrun_flags(cfg, f64, dev, True)._replace(
            propagate_newest=torch.tensor(False, device=dev),
            **{n: torch.as_tensor(data["flags." + n], device=dev)
               for n in ("wheel_valid", "imu_valid")})
        runs = [("oracle", cfg, core0, lambda m: flags._replace(marg_old=m), SHARD_CHAIN[:2])]
    else:
        runs = []
        for name, cfg in shard_step_cases(width).items():
            for dtype in ((f64, torch.float32) if width == "full" or name == "lm" else (f64,)):
                chain = (SHARD_CHAIN[:1] if width == "small" and dtype != f64 else
                         SHARD_CHAIN[:2] if dtype != f64 or name in ("dense", "lm") else
                         SHARD_CHAIN[:3] if width == "full" else SHARD_CHAIN)
                runs.append((name if dtype == f64 else name + "_f32", cfg,
                             *shard_case(name, cfg, dtype, dev), chain))
    res = {}

    def record_sharded(key, step, local, out, ms):
        res[key + "ms"] = ms
        res[key + "reductions"] = step.reductions
        res.update(_flat_arrays(out, key + "out."))
        res.update(_flat_arrays(local._replace(tracks=None, lines=None), key + "rep."))
        whole = sharded.gather_core(local, group)
        res.update(_flat_arrays(whole.tracks, key + "whole.tracks."))
        if whole.lines is not None:
            res.update(_flat_arrays(whole.lines, key + "whole.lines."))

    def record_single(key, step, core, out, ms):
        res[key + "single_ms"] = ms
        res.update(_flat_arrays(out, key + "single.out."))
        res.update(_flat_arrays(core, key + "single.core."))

    for name, cfg, core0, flags_of, chain in runs:
        step, _ = sharded.make_sharded_window_step(cfg, dev, group)
        local0 = sharded.shard_core(core0, group)
        run_chain(step, local0, flags_of, chain, name, record_sharded)
        if width == "small" and name == "full":
            back = sharded.gather_core(local0, group)
            res["roundtrip_equal"] = all(
                torch.equal(a, b) for a, b in zip(torch.utils._pytree.tree_leaves(back),
                                                  torch.utils._pytree.tree_leaves(core0)))
            for what, odd in (("ml", core0._replace(tracks=_resized(core0.tracks, 3))),
                              ("ll", core0._replace(lines=_resized(core0.lines, 3)))):
                try:
                    sharded.shard_core(odd, group)
                    res[f"error_{what}"] = ""
                except ValueError as err:
                    res[f"error_{what}"] = str(err)
            try:
                sharded.make_lm_mesh(world + 1)
                res["error_mesh"] = ""
            except ValueError as err:
                res["error_mesh"] = str(err)
    singles = [run for run in runs if run[0] not in ("jax", "oracle")]
    for i, (name, cfg, core0, flags_of, chain) in enumerate(singles):
        if rank == (i % world if width == "small" else 0):
            run_chain(make_window_step(cfg, dev)[0], core0, flags_of, chain, name, record_single)
    return res


def prior_gap(J, r, J_ref, r_ref) -> float:
    """The prior's information J0ᵀJ0 and gradient J0ᵀr0 against a
    reference's: the larger of the two largest differences, each over its
    bound, :data:`SHARD_PRIOR_TOL` or :data:`SHARD_STEP_TOL` of the
    reference's scale where that is larger (summing the same rows in
    another order moves an information of scale 3e6 by ~2e-4 in float64);
    at most 1 passes."""
    import numpy as np

    gaps = []
    for a, b in ((J.T @ J, J_ref.T @ J_ref), (J.T @ r, J_ref.T @ r_ref)):
        bound = max(SHARD_PRIOR_TOL, SHARD_STEP_TOL * float(np.abs(b).max()))
        gaps.append(float(np.abs(a - b).max()) / bound)
    return max(gaps)


def shard_step_gaps(ranks, case: str) -> dict:
    """A case of :func:`run_step_cases` against the unsharded step: the
    largest differences of the solved poses, the slid inverse depths and
    line coordinates, the prior's :func:`prior_gap`, whether the slot masks
    are equal, and whether every rank's output and replicated core is
    bitwise rank 0's."""
    import numpy as np

    r0 = ranks[0]
    single = {}
    for res in ranks:
        single.update({k: v for k, v in res.items() if ".single." in k})
    steps = sorted({int(k.split(".")[1]) for k in r0 if k.startswith(case + ".")})
    gap = dict(poses=0.0, depth=0.0, orth=0.0, prior=0.0, masks=True, ranks=True)
    for k in steps:
        p = f"{case}.{k}."
        gap["poses"] = max(gap["poses"], float(np.abs(
            r0[p + "out.poses"] - single[p + "single.out.poses"]).max()))
        for table, field, name in (("tracks", "inv_depth", "depth"), ("lines", "orth", "orth")):
            if f"{p}whole.{table}.{field}" in r0:
                gap[name] = max(gap[name], float(np.abs(
                    r0[f"{p}whole.{table}.{field}"] - single[f"{p}single.core.{table}.{field}"]).max()))
                gap["masks"] &= all(np.array_equal(r0[f"{p}whole.{table}.{m}"],
                                                   single[f"{p}single.core.{table}.{m}"])
                                    for m in ("active", "solve_ok"))
        gap["prior"] = max(gap["prior"], prior_gap(
            r0[p + "rep.prior.J0"], r0[p + "rep.prior.r0"],
            single[p + "single.core.prior.J0"], single[p + "single.core.prior.r0"]))
        gap["ranks"] &= all(np.array_equal(r0[key], res[key]) for res in ranks[1:]
                            for key in r0 if key.startswith(p) and ".single." not in key
                            and (".out." in key or ".rep." in key))
    return gap


def phase_checkpoint_landmarks(torch, work_dir, device="cuda"):
    """12d: the landmark-sharded window step on two Gloo ranks on one
    device, full width, float64: ``groundchallenge.yaml`` on the filled core
    and ``m2dgrp.yaml`` with lines and the plane on the dryrun's core, each
    through :data:`SHARD_CHAIN` against the unsharded step (rank 0):
    poses, depths and line coordinates to 1e-8, the prior by
    :func:`prior_gap`, slot masks equal, the ranks bitwise equal; ms per
    step of both (CUDA events), reductions per step; float32 both branches
    from the core, finite, their differences printed, not gated."""
    import numpy as np

    t0 = time.perf_counter()
    try:
        ranks = run_shard_pair(work_dir, device, step="full")
    except (RuntimeError, subprocess.TimeoutExpired) as err:
        fail(f"shard step: {err}")
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        check(str(res["device"]).startswith(device), f"shard step: rank {r} ran on {res['device']}")
    parts = []
    for case in shard_step_cases("full"):
        gap = shard_step_gaps(ranks, case)
        for name in ("poses", "depth", "orth"):
            check(gap[name] <= SHARD_STEP_TOL, f"shard step: {case} {name} off by {gap[name]:.3e}")
        check(gap["prior"] <= 1.0, f"shard step: {case} prior {gap['prior']:.3e} of its bound")
        check(gap["masks"] and gap["ranks"], f"shard step: {case} masks {gap['masks']}, "
                                             f"ranks bitwise equal {gap['ranks']}")
        n = len({key.split(".")[1] for key in r0 if key.startswith(case + ".")})
        ms = [float(r0[f"{case}.{k}.ms"]) for k in range(n)]
        ms1 = [float(r0[f"{case}.{k}.single_ms"]) for k in range(n)]
        red = [int(r0[f"{case}.{k}.reductions"]) for k in range(n)]
        f32 = {(b, k): float(np.abs(r0[f"{case}_f32.{b}.out.{k}"]
                                    - r0[f"{case}_f32.{b}.single.out.{k}"]).max())
               for b in (0, 1) for k in ("poses", "cost")}
        for b, branch in enumerate(("keyframe", "second-new")):
            check(all(np.isfinite(r0[f"{case}_f32.{b}.{part}"]).all()
                      for part in ("out.poses", "rep.prior.J0", "single.out.poses")),
                  f"shard step: {case} float32 {branch} step not finite")
        parts.append(
            f"{case}: sharded {np.median(ms):.1f} ms a step (median of {n}; {', '.join(f'{m:.1f}' for m in ms)}) "
            f"against unsharded {np.median(ms1):.1f} ({', '.join(f'{m:.1f}' for m in ms1)}); "
            f"reductions per step {red}; largest differences poses {gap['poses']:.3e}, "
            f"depths {gap['depth']:.3e}, line coordinates {gap['orth']:.3e}, prior "
            f"{gap['prior']:.3e} of its bound; float32 (finite; differences not gated): "
            f"keyframe poses {f32[0, 'poses']:.3e}, cost {f32[0, 'cost']:.3e}, second-new poses "
            f"{f32[1, 'poses']:.3e}, cost {f32[1, 'cost']:.3e}")
    print(f"shard step: {SHARD_WORLD} Gloo ranks on {device}, float64 ({wall:.1f} s with "
          f"start-up): " + "; ".join(parts), flush=True)


def _resized(table, n: int):
    """A landmark or line table of ``n`` slots: its slots repeated, cut."""
    import torch

    return type(table)(*[torch.cat([t] * n)[:n] for t in table])


def shard_worker(rank: int, world: int, address: str, device: str, out_path: str,
                 fleet: str, step: str = "") -> None:
    """One rank of phase 12c-d (and of tests/test_torch_sharded.py and
    tests/test_torch_sharded_step.py). Without ``step``: the edge-sharded
    graph of :func:`sharded_graph_problem` and, against it, the
    single-device ``optimize_4dof`` on this rank's device; ``shard_edges``'s
    rows; the divisibility error; with ``fleet`` ("default" or "small") the
    sharded fleet of 4 filled cores over 2 steps against the unsharded fleet
    (on rank 0). With ``step`` ("small", "full", or the path of an oracle
    core): the landmark-sharded window step of :func:`run_step_cases`.
    Writes its results to ``out_path``."""
    from types import SimpleNamespace

    import numpy as np
    import torch

    from ground_fusion_tpu_torch.global_layers.pose_graph import GraphEdges, optimize_4dof
    from ground_fusion_tpu_torch.parallel import sharded

    torch.set_num_threads(1)
    dev = sharded.init_group(rank, world, address, backend="gloo",
                             device=None if device == "cuda" else device)
    res = {"device": np.asarray(str(dev))}
    if step:
        if step in ("small", "full"):
            res.update(run_step_cases(rank, step, dev))
        else:
            res.update(run_step_cases(rank, "", dev, core_path=step))
        sharded.close_group()
        np.savez(out_path, **res)
        return
    prob = sharded_graph_problem(np)
    f64 = dict(dtype=torch.float64, device=dev)
    edges = GraphEdges(*[torch.as_tensor(prob[name]).to(device=dev, dtype=torch.int64)
                         if name in ("i", "j") else
                         torch.as_tensor(prob[name], device=dev) if name == "valid" else
                         torch.as_tensor(prob[name]).to(**f64) for name in GraphEdges._fields])
    n = prob["n"]
    args = (torch.as_tensor(prob["yaws0"]).to(**f64), torch.as_tensor(prob["ts0"]).to(**f64),
            torch.ones(n, dtype=torch.bool, device=dev),
            torch.zeros(n, dtype=torch.bool, device=dev).index_fill(0, torch.tensor([0], device=dev), True))
    solve = sharded.make_sharded_pose_graph(n, prob["iters"])
    local = sharded.shard_edges(edges)
    got = {"warm-up": (solve(*args, local), optimize_4dof(*args, edges, iters=prob["iters"]))}
    res["graph_ms"] = _wall_ms(torch, dev, lambda: got.update(sharded=solve(*args, local)), reps=3)
    res["single_ms"] = _wall_ms(torch, dev, lambda: got.update(
        single=optimize_4dof(*args, edges, iters=prob["iters"])), reps=3)
    res["y_sharded"], res["t_sharded"] = (x.cpu().numpy() for x in got["sharded"])
    res["y_single"], res["t_single"] = (x.cpu().numpy() for x in got["single"])
    res["local_i"] = local.i.cpu().numpy()
    res["local_valid"] = local.valid.cpu().numpy()
    try:
        odd = SimpleNamespace(state=SimpleNamespace(poses=torch.zeros(world + 1, 1, 7)))
        sharded.shard_fleet(odd, None)
        res["divisible_error"] = np.asarray("")
    except ValueError as err:
        res["divisible_error"] = np.asarray(str(err))

    if fleet:
        from ground_fusion_tpu_torch.config import Config
        from ground_fusion_tpu_torch.estimator.step import make_window_burst_batched
        from ground_fusion_tpu_torch.utils.convert import stack_cores

        cfg = Config()
        if fleet == "small":
            import dataclasses

            cfg = dataclasses.replace(cfg, solver=dataclasses.replace(
                cfg.solver, max_landmarks=32, max_iters=4))
        margs = np.array([[(k + b) % 2 == 0 for b in range(FLEET_B)] for k in range(FLEET_K)])
        cores = stack_cores([filled_core(cfg, torch.float64, dev, b)[0] for b in range(FLEET_B)])
        flags = flags_batch(filled_core(cfg, torch.float64, dev)[1], margs)
        run = sharded.make_sharded_fleet(cfg, dev)
        out = {}
        res["fleet_ms"] = _wall_ms(torch, dev, lambda: out.update(sharded=run(cores, flags))) / FLEET_K
        (cs, os_) = out["sharded"]
        if rank == 0:
            whole, _ = make_window_burst_batched(cfg, dev)
            res["whole_ms"] = _wall_ms(torch, dev, lambda: out.update(whole=whole(cores, flags))) / FLEET_K
            cw, ow = out["whole"]
            for name, x, y in (("step_pose", os_["pose"], ow["pose"]),
                               ("end_pose", cs.state.poses, cw.state.poses),
                               ("inv_depth", cs.tracks.inv_depth, cw.tracks.inv_depth)):
                res[f"fleet_{name}"] = float((x - y).abs().max())
                res[f"fleet_{name}_ok"] = bool(torch.allclose(
                    x, y, rtol=1e-2 if name == "step_pose" else 1e-3, atol=FLEET_TOL[name]))
            res["fleet_bad_equal"] = bool(torch.equal(cs.wheel_buf.bad, cw.wheel_buf.bad))
    sharded.close_group()
    np.savez(out_path, **res)


def _free_port() -> int:
    import socket

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_shard_pair(work_dir: str, device: str = "cuda", fleet: str = "", step: str = "",
                   world: int = SHARD_WORLD, timeout_s: float = SHARD_TIMEOUT_S) -> list:
    """Start ``world`` (two) processes of :func:`shard_worker` on ``device``
    with Gloo (ranks share one card), wait for them with a timeout, and
    return each rank's results (dicts of numpy values). Raises when a rank
    fails or times out; no process outlives the call."""
    import numpy as np

    address = f"tcp://localhost:{_free_port()}"
    outs = [os.path.join(work_dir, f"shard_rank{r}.npz") for r in range(world)]
    env = dict(os.environ, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "chip_smoke.py"), "--shard-worker", str(r),
         str(world), address, device, outs[r], fleet, step],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env)
        for r in range(world)]
    logs, deadline = [], time.monotonic() + timeout_s
    try:
        for p in procs:
            logs.append(p.communicate(timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"shard rank {r} exited with {p.returncode}:\n{logs[r][-4000:]}")
    results = []
    for path in outs:
        with np.load(path, allow_pickle=False) as z:
            results.append({k: z[k] for k in z.files})
    return results


def phase_checkpoint_shard(torch, work_dir, device="cuda"):
    """12c: two Gloo ranks on one device: the edge-sharded graph and the
    sharded fleet."""
    import numpy as np

    t0 = time.perf_counter()
    try:
        ranks = run_shard_pair(work_dir, device, fleet="default")
    except (RuntimeError, subprocess.TimeoutExpired) as err:
        fail(f"shard: {err}")
    wall = time.perf_counter() - t0
    prob = sharded_graph_problem(np)
    r0 = ranks[0]
    for r, res in enumerate(ranks):
        check(str(res["device"]).startswith(device), f"shard: rank {r} ran on {res['device']}")
        worst = max(float(np.abs(res["y_sharded"] - res["y_single"]).max()),
                    float(np.abs(res["t_sharded"] - res["t_single"]).max()))
        check(worst <= SHARD_GRAPH_TOL, f"shard: rank {r}'s sharded graph {worst:.3e} from the single")
        check("not divisible" in str(res["divisible_error"]), "shard: no divisibility error")
    check(float(np.abs(r0["t_sharded"] - prob["gt_t"]).max()) < 1e-5, "shard: the graph missed the truth")
    check(all(bool(r0[f"fleet_{n}_ok"]) for n in FLEET_TOL) and bool(r0["fleet_bad_equal"]),
          f"shard: fleet off: " + ", ".join(f"{n} {float(r0['fleet_' + n]):.3e}" for n in FLEET_TOL))
    print(f"shard: {SHARD_WORLD} Gloo ranks on {device} ({wall:.1f} s with start-up): 4-DoF graph "
          f"of {prob['n']} nodes, {len(prob['i'])} edges, {prob['iters']} iterations: "
          f"{float(r0['graph_ms']):.2f} ms a solve sharded, {float(r0['single_ms']):.2f} ms single "
          f"(within {max(float(np.abs(r['t_sharded'] - r['t_single']).max()) for r in ranks):.2e}); "
          f"fleet of {FLEET_B} filled cores, {FLEET_B // SHARD_WORLD} a rank: "
          f"{float(r0['fleet_ms']):.1f} ms a step sharded (rank 0), {float(r0['whole_ms']):.1f} ms "
          f"unsharded; largest differences " + ", ".join(
              f"{n} {float(r0['fleet_' + n]):.3e}" for n in FLEET_TOL)
          + ". NCCL across cards is not run (one card).", flush=True)


def phase_checkpoint(torch, work_dir):
    counts = phase_checkpoint_cli(torch, work_dir)
    reloc = phase_checkpoint_reloc(torch, work_dir)
    phase_checkpoint_shard(torch, work_dir)
    phase_checkpoint_landmarks(torch, work_dir)
    return {k: counts[k] + reloc[k] for k in counts}


# -------------------------------------------------------------------------- 13
#
# Dynamic objects and the other cameras. 13b composites the checker object of
# tests/test_detector_e2e.py (32 px, the top of the detector's training size
# range, carrying a false depth) onto phase 4's drive. It walks into view at
# frame DYN_OBJ_FIRST, once the tracker holds its features on the scene: the
# refill ranks the checker's corners above every blob (and its equal-score
# plateaus pass the min-distance suppression), so an object there from the
# first frame would take every feature slot.

DET_SEED = 99
DET_SCENES = 10
DET_CONF = 0.3               # tests/test_detector.py's threshold for its recall
DET_RECALL = 0.7
DET_IOU = 0.3
# bfloat16 convolutions: features agree to 2e-2 of their largest magnitude.
# XLA's own jitted and eager backbones differ by 0.03125 at features of ~2.6
# (two roundings in bfloat16), ~1 % of that scale (CPU, tests/test_torch_detector.py)
DET_FEAT_TOL = 2e-2
DET_SCORE_MARGIN = 0.02      # a detection this close to a threshold may flip by rounding
DET_BOX_TOL_PX = 1.0
DET_REPS = 20
DYN_FRAMES = 24
DYN_OBJ = 32
DYN_OBJ_DEPTH = 1.2
DYN_OBJ_TONE = (0.9, 0.85, 0.8)
DYN_OBJECT = (276.0, 196.0)  # its top-left corner at frame 0
DYN_OBJ_STEP = (1.0, 0.5)    # px a frame
DYN_OBJ_FIRST = 4
DYN_HALO = (128.0, 16.0)     # mid-grey level and fall-off (px) of the backdrop around it
DYN_MIN_OBJ_FEATS = 5        # tests/test_detector_e2e.py:143-144
DYN_MAX_PASSED = 0.2
CAM_PIXELS = 1000
CAM_SEED = 0
CAM_ROUND_TRIP_PX = 1e-3     # tests/test_cameras.py:129
CAM_F64_TOL = 1e-9
EQUI_DISTORTION = (-0.01, 0.004, -0.002, 0.0005)    # tests/test_cameras.py:152-153
EQUI_FRAMES = 20


def camera_cases(np):
    """(model, distortion) of each dispatched model at the oracle's
    distortions (tests/test_cameras.py:117-122); Scaramuzza's pair of
    polynomials from :func:`scaramuzza_distortion`."""
    return [("pinhole", (-0.28, 0.07, 2e-4, -2e-5)),
            ("pinhole_full", (-0.3, 0.09, 1e-3, -2e-4, 0.0, 0.0, 2e-4, -1e-4)),
            ("mei", (0.9, -0.2, 0.05, 1e-4, -1e-4)),
            ("equidistant", EQUI_DISTORTION),
            ("scaramuzza", scaramuzza_distortion(np, 460.0))]


def scaramuzza_distortion(np, f: float, deg: int = 12):
    """A self-consistent OCam model for the dispatch layout (a0..a4, then the
    world2cam inverse polynomial): the cam2world polynomial
    z(ρ) = f − ρ²/(3f), and its inverse ρ(θ) fitted to degree ``deg`` by
    least squares in ψ = π/2 − θ over the field to ρ = 450 px, then carried
    to the θ basis exactly (binomial expansion)."""
    from math import comb

    poly = np.array([f, 0.0, -1.0 / (3.0 * f), 0.0, 0.0])
    rho = np.linspace(0.0, 450.0, 4000)
    psi = np.pi / 2 - np.arctan2(np.polyval(poly[::-1], rho), rho)
    b = np.linalg.lstsq(np.vander(psi, deg + 1, increasing=True), rho, rcond=None)[0]
    m = np.zeros((deg + 1, deg + 1))
    for k in range(deg + 1):
        for j in range(k + 1):
            m[j, k] = comb(k, j) * (np.pi / 2) ** (k - j) * (-1.0) ** j
    return tuple(poly) + tuple(m @ b)


def camera_round_trips(torch, device, dtype, n: int = CAM_PIXELS, seed: int = CAM_SEED):
    """Each model's lift and project at ``n`` seeded pixels (the oracle's
    range, tests/test_cameras.py:114) on ``device`` in ``dtype``:
    {model: (rays [n,3], pixels again [n,2])} on the host, and the pixels."""
    import numpy as np

    from ground_fusion_tpu_torch.cameras.models import make_camera

    uv = np.random.default_rng(seed).uniform([100, 80], [540, 400], (n, 2))
    out = {}
    for name, dist in camera_cases(np):
        cam = make_camera(name, 460.0, 459.0, 320.0, 240.0, dist, dtype=dtype, device=device)
        rays = cam.lift_projective(torch.as_tensor(uv, dtype=dtype, device=device))
        rays = rays / rays[..., 2:3]
        out[name] = (rays.cpu().numpy(), cam.space_to_plane(rays).cpu().numpy())
    return out, uv


def _calib_board():
    import numpy as np

    xs, ys = np.meshgrid(np.arange(8), np.arange(6))
    return np.stack([xs.reshape(-1), ys.reshape(-1)], -1).astype(float) * 0.04


def calibration_views(project, gt, n_views=10, seed=11, noise=0.1, z0=0.6):
    """tests/test_calibration.py's synthetic board views, through the port's
    own projection in float64 on the CPU: (board [N,2], [V × [N,2]])."""
    import numpy as np
    import torch

    from ground_fusion_tpu_torch.geometry.so3 import quat_exp, quat_rotate

    world = _calib_board()
    pts_w = torch.as_tensor(np.concatenate([world, np.zeros((len(world), 1))], 1))
    rng = np.random.default_rng(seed)
    img_pts = []
    for _ in range(n_views):
        q = quat_exp(torch.as_tensor(rng.normal(0, 0.25, 3)))
        t = np.array([-0.16, -0.12, z0]) + rng.normal(0, 0.05, 3)
        uv = project(gt, quat_rotate(q, pts_w) + torch.as_tensor(t)).numpy()
        img_pts.append(uv + rng.normal(0, noise, uv.shape))
    return world, img_pts


def calibration_cases():
    """(model, truth, projection, view keywords, LM iterations) of the five
    oracles of tests/test_calibration.py, in float64 on the CPU."""
    import numpy as np
    import torch

    from ground_fusion_tpu_torch.cameras import calibration as cal
    from ground_fusion_tpu_torch.cameras import models as m

    f64 = dict(dtype=torch.float64, device="cpu")
    return [
        ("pinhole", m.PinholeParams.make(455.0, 458.0, 322.0, 243.0, -0.28, 0.07, 0.0002, -0.0001,
                                         **f64), m.pinhole_space_to_plane, dict(n_views=8), 25),
        ("equidistant", m.EquidistantParams.make(310.0, 312.0, 318.0, 242.0, k2=-0.01, k3=0.004,
                                                 **f64), m.equidistant_space_to_plane, {}, 40),
        ("mei", m.MeiParams.make(0.9, 620.0, 624.0, 320.0, 240.0, k1=-0.2, k2=0.05, **f64),
         m.mei_space_to_plane, dict(n_views=12, z0=0.5), 60),
        ("pinhole_full", m.PinholeFullParams.make(455.0, 458.0, 322.0, 243.0, k1=-0.30, k2=0.09,
                                                  k4=-0.05, p1=0.0003, p2=-0.0002, **f64),
         m.pinhole_full_space_to_plane, {}, 40),
        ("scaramuzza", m.ScaramuzzaParams.make(
            [0.0] * 5, cal._PSI2THETA @ np.array([0.0, 300.0, -25.0, 10.0, 0.0, 0.0]),
            c=1.002, d=0.001, e=-0.002, cx=322.0, cy=238.0, **f64),
         cal.scaramuzza_project_zfwd, {}, 120),
    ]


def calibration_errors(name, gt, project, res) -> list:
    """The oracle's recovery checks for ``res`` (tests/test_calibration.py:
    38-43, 98-123, 140-153, 171-184, 213-249) as a list of messages, empty
    when all hold."""
    import numpy as np
    import torch

    from ground_fusion_tpu_torch.cameras.models import (
        scaramuzza_lift_projective,
        scaramuzza_space_to_plane_zfwd,
    )

    p = type(res.params)(*[v.detach().cpu().double() for v in res.params])
    bad = []
    if not res.rms_px < 0.3:
        bad.append(f"rms {res.rms_px:.3f} px")
    near = {"pinhole": (2.0, ("fx", "fy", "cx", "cy")), "equidistant": (3.0, ("fx", "fy", "cx", "cy")),
            "scaramuzza": (3.0, ("cx", "cy"))}
    if name in near:
        tol, fields = near[name]
        for k in fields:
            if not abs(float(getattr(p, k)) - float(getattr(gt, k))) < tol:
                bad.append(f"{k} {float(getattr(p, k)):.3f} against {float(getattr(gt, k)):.3f}")
    if name == "pinhole":
        if not abs(float(p.k1) + 0.28) < 0.02:
            bad.append(f"k1 {float(p.k1):.4f}")
        return bad
    rng = np.random.default_rng({"equidistant": 5, "mei": 3, "pinhole_full": 7, "scaramuzza": 6}[name])
    rays = torch.as_tensor(np.concatenate([rng.uniform(-0.3, 0.3, (200, 2)), np.ones((200, 1))], 1))
    uv_gt = project(gt, rays).numpy()
    uv_cal = project(p, rays).numpy()
    if name != "scaramuzza":
        gap = uv_cal - uv_gt
        err = np.linalg.norm(gap - gap.mean(0), axis=1)
        if not np.median(err) < 0.5:
            bad.append(f"median reprojection gap {np.median(err):.3f} px")
        if not np.linalg.norm(gap.mean(0)) < 2.0:
            bad.append(f"principal-point gauge {np.linalg.norm(gap.mean(0)):.3f} px")
        return bad
    if not float(p.c) > 0:
        bad.append("reflection gauge not canonicalized")
    a = uv_cal - uv_cal.mean(0)
    b = uv_gt - uv_gt.mean(0)
    u, _, vt = np.linalg.svd(a.T @ b)
    r2 = u @ np.diag([1.0, np.sign(np.linalg.det(u @ vt))]) @ vt
    s = float(np.sum(a * (b @ r2.T)) / np.sum(b * b))
    if not abs(s - 1.0) < 0.04:
        bad.append(f"radial scale gauge {s:.3f}")
    err = np.linalg.norm(a - s * (b @ r2.T), axis=1)
    if not np.median(err) < 0.5:
        bad.append(f"median reprojection gap {np.median(err):.3f} px")
    if not np.linalg.norm(uv_cal.mean(0) - uv_gt.mean(0)) < 3.0:
        bad.append("principal-point gauge")
    uv = scaramuzza_space_to_plane_zfwd(p, scaramuzza_lift_projective(p, torch.as_tensor(uv_cal)))
    rt = np.linalg.norm(uv.numpy() - uv_cal, axis=1)
    if not np.median(rt) < 0.5:
        bad.append(f"lift/project round trip {np.median(rt):.3f} px")
    return bad


def composite_object(np, img, depth, k: int):
    """Frame ``k`` of the drive: ``img`` [H,W] grey → [H,W,3], with the
    checker object pasted in from frame ``DYN_OBJ_FIRST`` on, its pixels
    carrying ``DYN_OBJ_DEPTH``. The object stands on a mid-grey backdrop that
    fades into the dark frame (a Gaussian fall-off of its distance to the
    object): the detector was trained on mid-grey scenes, as the oracle's
    frames are, and phase 4's near-black background lies outside them.
    Returns (image, depth)."""
    rgb = np.repeat(np.asarray(img, np.float32)[..., None], 3, -1)
    depth = np.asarray(depth, np.float32).copy()
    if k < DYN_OBJ_FIRST:
        return rgb, depth
    yy, xx = np.mgrid[0:DYN_OBJ, 0:DYN_OBJ]
    checker = (((yy // 4) + (xx // 4)) % 2).astype(np.float32)
    patch = (255.0 * checker)[..., None] * np.array(DYN_OBJ_TONE, np.float32)
    x0 = int(round(DYN_OBJECT[0] + DYN_OBJ_STEP[0] * k))
    y0 = int(round(DYN_OBJECT[1] + DYN_OBJ_STEP[1] * k))
    ys, xs = np.mgrid[0 : rgb.shape[0], 0 : rgb.shape[1]]
    dx = np.maximum(np.maximum(x0 - xs, xs - (x0 + DYN_OBJ - 1)), 0)
    dy = np.maximum(np.maximum(y0 - ys, ys - (y0 + DYN_OBJ - 1)), 0)
    level, fall = DYN_HALO
    halo = (level * np.exp(-(dx * dx + dy * dy) / (2.0 * fall * fall))).astype(np.float32)
    rgb = np.maximum(rgb, halo[..., None])
    rgb[y0 : y0 + DYN_OBJ, x0 : x0 + DYN_OBJ] = patch
    depth[y0 : y0 + DYN_OBJ, x0 : x0 + DYN_OBJ] = DYN_OBJ_DEPTH
    return rgb, depth


def render_dynamic_sequence(seq_dir: str, n_frames: int = DYN_FRAMES, source: str = None) -> str:
    """Phase 4's drive cut to ``n_frames``, with the moving checker object
    composited in (RGB images). ``source``: phase 4's rendered sequence, whose
    first frames and sensor files are taken instead of rendering them again
    (the same seed gives the same frames)."""
    import numpy as np

    if source is None:
        from ground_fusion_tpu_torch.config import load_yaml
        from ground_fusion_tpu_torch.sim.render import Mounts, render_sequence
        from ground_fusion_tpu_torch.sim.synthetic import SimParams

        cfg = load_yaml(CONFIG_PATH)
        cam = cfg.camera
        render_sequence(seq_dir, n_frames, cam.fx, cam.fy, cam.cx, cam.cy, cam.width, cam.height,
                        sp=SimParams(**SMOKE_SIM), n_landmarks=SMOKE_LANDMARKS, seed=SMOKE_SEED,
                        mounts=Mounts.from_config(cfg))
        source = seq_dir
    else:
        os.makedirs(os.path.join(seq_dir, "img"), exist_ok=True)
        for name in ("imu.csv", "wheel.csv", "gt.csv"):
            shutil.copy(os.path.join(source, name), seq_dir)
        with open(os.path.join(source, "frames.csv")) as src:
            rows = [r for r in src if r.strip()][:n_frames]
        with open(os.path.join(seq_dir, "frames.csv"), "w") as dst:
            dst.writelines(rows)
    for k in range(n_frames):
        ip, dp = (os.path.join("img", f"{k:05d}{x}.npy") for x in ("", "_d"))
        rgb, depth = composite_object(np, np.load(os.path.join(source, ip)),
                                      np.load(os.path.join(source, dp)), k)
        np.save(os.path.join(seq_dir, ip), rgb)
        np.save(os.path.join(seq_dir, dp), depth)
    return seq_dir


def _config_with(work_dir: str, name: str, replace=(), extra: str = "") -> str:
    """A copy of ``configs/groundchallenge.yaml`` with lines replaced and
    ``extra`` appended, in the work directory."""
    with open(CONFIG_PATH) as src:
        text = src.read()
    for old, new in replace:
        check(old in text, f"config: {old!r} not in {CONFIG_PATH}")
        text = text.replace(old, new)
    path = os.path.join(work_dir, name)
    with open(path, "w") as dst:
        dst.write(text.rstrip("\n") + "\n" + extra)
    return path


def yolo_config(work_dir: str) -> str:
    """``configs/groundchallenge.yaml`` with ``use_yolo: true``."""
    return _config_with(work_dir, "groundchallenge_yolo.yaml",
                        replace=(("use_yolo: false", "use_yolo: true"),))


def equidistant_config(work_dir: str) -> str:
    """``configs/groundchallenge.yaml`` with ``camera.model: equidistant`` and
    the oracle's distortion, at the config's intrinsics."""
    return _config_with(work_dir, "groundchallenge_equidistant.yaml", replace=(
        ("model: pinhole", "model: equidistant"),
        ("distortion: [0.0, 0.0, 0.0, 0.0]",
         "distortion: [" + ", ".join(repr(v) for v in EQUI_DISTORTION) + "]")))


class ObjectProbe:
    """Counts, per frame, the features on the object (its false depth)
    that the tracker returns and that reach ``Estimator.input_frame``: wraps
    both methods on their classes and puts them back on ``close``."""

    def __init__(self):
        from ground_fusion_tpu_torch.frontend.tracker import FeatureTracker
        from ground_fusion_tpu_torch.pipeline import Estimator

        self.classes = (FeatureTracker, Estimator)
        self.tracked, self.passed = [], []
        self._track, self._input = FeatureTracker.track, Estimator.input_frame
        probe = self

        def on_object(feats):
            return sum(1 for f in feats.values() if abs(f.depth - DYN_OBJ_DEPTH) < 1e-4)

        def track(tracker, *a, **k):
            feats = probe._track(tracker, *a, **k)
            probe.tracked.append(on_object(feats))
            return feats

        def input_frame(est, t, feats, *a, **k):
            probe.passed.append(on_object(feats))
            return probe._input(est, t, feats, *a, **k)

        FeatureTracker.track, Estimator.input_frame = track, input_frame

    def close(self):
        self.classes[0].track, self.classes[1].input_frame = self._track, self._input


def run_dynamic(torch, work_dir, device=None, n_frames: int = DYN_FRAMES, source=None):
    """Render the drive with the object (from phase 4's sequence ``source``
    if given) and run it through ``__main__.run`` with ``use_yolo``; returns
    (system, sequence, output, probe, wall s)."""
    from ground_fusion_tpu_torch.__main__ import run

    seq = render_dynamic_sequence(os.path.join(work_dir, "yolo_seq"), n_frames, source)
    out = os.path.join(work_dir, "yolo_out")
    probe = ObjectProbe()
    try:
        t0 = time.perf_counter()
        system = run(yolo_config(work_dir), seq, out, device=device)
        if system.device.type == "cuda":
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        probe.close()
    return system, seq, out, probe, wall


def run_equidistant(torch, work_dir, device=None, n_frames: int = EQUI_FRAMES):
    """Phase 4's scene rendered through the equidistant model at the
    config's intrinsics and run through ``__main__.run`` with
    ``camera.model: equidistant``; returns (system, sequence, output, wall s)."""
    from ground_fusion_tpu_torch.__main__ import run
    from ground_fusion_tpu_torch.cameras.models import make_camera
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.sim.render import Mounts, render_sequence
    from ground_fusion_tpu_torch.sim.synthetic import SimParams

    cfg_path = equidistant_config(work_dir)
    cfg = load_yaml(cfg_path)
    c = cfg.camera
    camera = make_camera(c.model, c.fx, c.fy, c.cx, c.cy, c.distortion, dtype=torch.float64,
                         device="cpu")
    seq = render_sequence(os.path.join(work_dir, "equi_seq"), n_frames, c.fx, c.fy, c.cx, c.cy,
                          c.width, c.height, sp=SimParams(**SMOKE_SIM),
                          n_landmarks=SMOKE_LANDMARKS, seed=SMOKE_SEED,
                          mounts=Mounts.from_config(cfg), camera=camera)
    out = os.path.join(work_dir, "equi_out")
    t0 = time.perf_counter()
    system = run(cfg_path, seq, out, device=device)
    if system.device.type == "cuda":
        torch.cuda.synchronize()
    return system, seq, out, time.perf_counter() - t0


def detections_agree(np, a, b, margin: float = DET_SCORE_MARGIN, conf: float = DET_CONF,
                     iou_thresh: float = 0.45):
    """Whether two ``detect`` results (host arrays: boxes, scores, classes,
    valid) agree away from the thresholds: every valid detection of either
    whose score is more than ``margin`` above ``conf`` has a valid partner in
    the other with the same class, its box within ``DET_BOX_TOL_PX`` and its
    score within ``margin``. Ranks may differ where scores nearly tie, and a
    box whose IoU with a kept box is within 0.02 of the NMS threshold may be
    kept by one and suppressed by the other, so such boxes are not asked for.
    Returns (ok, largest box difference in px, largest score difference)."""
    worst_box = worst_score = 0.0
    for x, y in ((a, b), (b, a)):
        bx, sx, cx, vx = x
        by, sy, cy, vy = y
        for i in np.nonzero(vx & (sx > conf + margin))[0]:
            partner = [j for j in np.nonzero(vy)[0] if cy[j] == cx[i]]
            d = [float(np.abs(by[j] - bx[i]).max()) for j in partner]
            if not d or min(d) > DET_BOX_TOL_PX:
                kept = bx[vx]
                inter = np.prod(np.clip(np.minimum(bx[i, 2:], kept[:, 2:])
                                        - np.maximum(bx[i, :2], kept[:, :2]), 0, None), axis=1)
                area_i = (bx[i, 2] - bx[i, 0]) * (bx[i, 3] - bx[i, 1])
                areas = (kept[:, 2] - kept[:, 0]) * (kept[:, 3] - kept[:, 1])
                iou = inter / np.maximum(area_i + areas - inter, 1e-6)
                if np.any(np.abs(iou - iou_thresh) < 0.02):
                    continue
                return False, float("inf"), float("inf")
            j = partner[int(np.argmin(d))]
            worst_box = max(worst_box, min(d))
            worst_score = max(worst_score, abs(float(sy[j]) - float(sx[i])))
            if abs(float(sy[j]) - float(sx[i])) > margin:
                return False, worst_box, worst_score
    return True, worst_box, worst_score


def detector_recall(np, results, gts, thresh=DET_IOU) -> tuple:
    """(hits, objects): objects with a valid detection at IoU > ``thresh``
    (tests/test_detector.py:78-95)."""
    hits = total = 0
    for (b, _, _, valid), (boxes, n) in zip(results, gts):
        for k in range(n):
            total += 1
            gt = boxes[k]
            for d in np.nonzero(valid)[0]:
                bb = b[d]
                x1, y1 = max(gt[0], bb[0]), max(gt[1], bb[1])
                x2, y2 = min(gt[2], bb[2]), min(gt[3], bb[3])
                inter = max(x2 - x1, 0) * max(y2 - y1, 0)
                u = ((gt[2] - gt[0]) * (gt[3] - gt[1])
                     + max((bb[2] - bb[0]) * (bb[3] - bb[1]), 0) - inter)
                if inter / max(u, 1e-6) > thresh:
                    hits += 1
                    break
    return hits, total


def phase_detector(torch, seq_dir: str):
    """13a: the shipped weights on the card against the CPU, on 10 scenes of
    the training renderer and two 480x640 frames of 13b's drive."""
    import numpy as np

    from ground_fusion_tpu_torch.detector.model import backbone, detect, load_npz
    from ground_fusion_tpu_torch.detector.train import render_scene

    weights = os.path.join(ROOT, "ground_fusion_tpu_torch", "detector", "weights.npz")
    p_gpu, p_cpu = load_npz(weights, device="cuda"), load_npz(weights, device="cpu")
    rng = np.random.default_rng(DET_SEED)
    scenes = [render_scene(rng) for _ in range(DET_SCENES)]
    frames = [np.load(os.path.join(seq_dir, "img", f"{k:05d}.npy"))
              for k in (DYN_OBJ_FIRST, DYN_FRAMES - 1)]
    # the scenes at the recall oracle's threshold, the drive's frames at the
    # system's (detect's default)
    inputs = [(s[0], DET_CONF) for s in scenes] + [(f, 0.5) for f in frames]
    results, worst_box, worst_score, worst_feat = [], 0.0, 0.0, 0.0
    for img, conf in inputs:
        g = [x.cpu().numpy() for x in detect(p_gpu, torch.as_tensor(img, device="cuda"),
                                             conf_thresh=conf)]
        c = [x.numpy() for x in detect(p_cpu, torch.as_tensor(img), conf_thresh=conf)]
        ok, db, ds = detections_agree(np, g, c, conf=conf)
        check(ok, f"detector: the card's detections differ from the CPU's (box {db:.3f} px, "
                  f"score {ds:.4f})")
        worst_box, worst_score = max(worst_box, db), max(worst_score, ds)
        x = torch.as_tensor(img[None] / 255.0, dtype=torch.float32)
        fg = backbone(p_gpu, x.to("cuda")).cpu().numpy()
        fc = backbone(p_cpu, x).numpy()
        gap = float(np.abs(fg - fc).max()) / float(np.abs(fc).max())
        check(gap <= DET_FEAT_TOL, f"detector: features off by {gap:.4f} of their scale from the CPU's")
        worst_feat = max(worst_feat, gap)
        results.append(g)
    hits, total = detector_recall(np, results[:DET_SCENES], [(s[1], s[2]) for s in scenes])
    print(f"detector: {DET_SCENES} training scenes (96x96, seed {DET_SEED}) and 2 frames of the "
          f"drive (480x640) on the card against the CPU: features within {worst_feat:.5f} of "
          f"their largest magnitude (bound {DET_FEAT_TOL}), detections away from the thresholds "
          f"equal, boxes within {worst_box:.4f} px, scores within {worst_score:.5f}; recall "
          f"{hits}/{total} at IoU {DET_IOU} (bound {DET_RECALL})", flush=True)
    check(hits >= DET_RECALL * total, f"detector: recall {hits}/{total}")
    n_obj = [int(r[3].sum()) for r in results[DET_SCENES:]]
    img = torch.as_tensor(frames[0], device="cuda")
    fn = lambda: detect(p_gpu, img)
    ms = _time_ms(torch, fn, DET_REPS)
    dev = _device_total_ms(torch, fn)
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fn()
    torch.cuda.synchronize()
    peak = (torch.cuda.max_memory_allocated() - base) / 2**20
    print(f"detector: detect at 480x640 {ms:.4f} ms a call (CUDA events, median of {DET_REPS}), "
          f"{_fmt_ms(dev)} of device time a call under torch.profiler, peak {peak:.1f} MiB above "
          f"the weights and the image; valid detections on the drive's frames {n_obj}", flush=True)
    return {"detect_ms": ms, "device_ms": dev}


def _device_total_ms(torch, fn, n: int = 20):
    """Mean device time of all the kernels one call of ``fn`` launches, over
    ``n`` calls under ``torch.profiler``; None when it saw no device time."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    total = 0.0
    for row in prof.key_averages():
        total += getattr(row, "self_device_time_total", None) or getattr(row, "self_cuda_time_total", 0.0)
    return total / n / 1e3 if total > 0 else None


def phase_dynamic(torch, work_dir, main_times):
    """13b: phase 4's drive cut to 24 frames with the object, through the
    CLI with ``use_yolo``."""
    import numpy as np

    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    _zero_counters(klt, hamming)
    phase4 = os.path.join(work_dir, "seq")
    system, seq, out, probe, wall = run_dynamic(
        torch, work_dir, source=phase4 if os.path.isdir(phase4) else None)
    counts = _read_counters(klt, hamming)
    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    tracked, passed = probe.tracked, probe.passed
    print(f"dynamic: {n_poses} poses over {path:.4f} m, ATE {ate:.5f} m (bounds {ATE_BOUND_M} m and "
          f"{ATE_BOUND_OF_PATH:.0%} of the path), reboots {system.estimator.reboots}; features on "
          f"the object from the tracker {tracked} (sum {sum(tracked)}), reaching input_frame "
          f"{passed} (sum {sum(passed)}, bound {DYN_MAX_PASSED} of the tracker's)", flush=True)
    check(n_poses >= 10, f"dynamic: only {n_poses} poses in vio.txt")
    check(ate < ATE_BOUND_M, f"dynamic: ATE {ate:.4f} m is not below {ATE_BOUND_M} m")
    check(ate < ATE_BOUND_OF_PATH * path,
          f"dynamic: ATE {ate:.4f} m is not below {ATE_BOUND_OF_PATH:.0%} of {path:.3f} m")
    check(system.estimator.reboots == 0, "dynamic: the estimator rebooted")
    check(max(tracked) >= DYN_MIN_OBJ_FEATS, f"dynamic: the object was never tracked: {tracked}")
    check(sum(passed) <= DYN_MAX_PASSED * sum(tracked),
          f"dynamic: {sum(passed)} object features reached the estimator of {sum(tracked)}")
    check(all(t.is_cuda for t in system.detector_params.convs[0]), "dynamic: the detector is not on the GPU")
    tracked_frames = system.stats.counts["track"] - 1
    check(tracked_frames == DYN_FRAMES - 1, f"dynamic: {tracked_frames} tracked frames")
    check(system.stats.counts["detect"] == tracked_frames + 1,
          f"dynamic: the detector ran on {system.stats.counts['detect']} frames")
    check(counts["lk_track"] == tracked_frames,
          f"dynamic: {counts['lk_track']} lk_track launches, expected {tracked_frames}")
    check(counts["lk_level"] == 0 and counts["plain"] == 0,
          f"dynamic: {counts['lk_level']} lk_level launches, plain versions ran {counts['plain']} times")
    stats = system.stats
    print(f"dynamic: detect median {stats.median('detect'):.2f} ms/frame (mean "
          f"{stats.mean('detect'):.2f}), track median {stats.median('track'):.2f} (phase 4: "
          f"{main_times['track'][0]:.2f}), solve median {stats.median('solve'):.2f} (mean "
          f"{stats.mean('solve'):.2f}; phase 4: {main_times['solve'][0]:.2f}) over "
          f"{stats.counts['solve']} frames; {DYN_FRAMES / wall:.3f} frames/s ({wall:.1f} s wall), "
          f"launches {counts}", flush=True)
    return counts, seq


def phase_cameras(torch, work_dir, main_times):
    """13c: the five models on the card against the CPU, the five
    calibrations on the card, and the equidistant drive."""
    import numpy as np

    from ground_fusion_tpu_torch.cameras.calibration import calibrate
    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    gpu, uv = camera_round_trips(torch, "cuda", torch.float64)
    cpu, _ = camera_round_trips(torch, "cpu", torch.float64)
    parts = []
    for name in gpu:
        d_ray = float(np.abs(gpu[name][0] - cpu[name][0]).max())
        d_px = float(np.abs(gpu[name][1] - cpu[name][1]).max())
        rt = float(np.abs(gpu[name][1] - uv).max())
        parts.append(f"{name} {d_ray:.1e}/{d_px:.1e}/{rt:.1e}")
        check(d_ray <= CAM_F64_TOL and d_px <= CAM_F64_TOL * 1e3,
              f"cameras: {name} on the card is {d_ray:.3e} (rays), {d_px:.3e} px from the CPU")
        check(rt <= CAM_ROUND_TRIP_PX, f"cameras: {name} round trip {rt:.3e} px")
    print(f"cameras: lift and project of {CAM_PIXELS} pixels in float64 on the card against the "
          f"CPU (rays / pixels) and the round trip in px: " + ", ".join(parts), flush=True)

    parts = []
    for name, gt, project, view_kw, iters in calibration_cases():
        world, img_pts = calibration_views(project, gt, **view_kw)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = calibrate(name, world, img_pts, iters=iters, device="cuda")
        ms = (time.perf_counter() - t0) * 1e3
        check(res.params[0].is_cuda, f"calibrate: {name} did not run on the GPU")
        bad = calibration_errors(name, gt, project, res)
        check(not bad, f"calibrate: {name}: " + "; ".join(bad))
        parts.append(f"{name} rms {res.rms_px:.4f} px in {ms:.0f} ms ({iters} LM steps)")
    print("calibrate: float64 on the card, within the oracles' bounds: " + ", ".join(parts), flush=True)

    _zero_counters(klt, hamming)
    system, seq, out, wall = run_equidistant(torch, work_dir)
    counts = _read_counters(klt, hamming)
    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    check(system.cam.name == "equidistant", f"equidistant: the system built {system.cam.name}")
    tracked_frames = system.stats.counts["track"] - 1
    print(f"equidistant: {n_poses} poses over {path:.4f} m, ATE {ate:.5f} m (bounds {ATE_BOUND_M} m "
          f"and {ATE_BOUND_OF_PATH:.0%} of the path), reboots {system.estimator.reboots}; track "
          f"median {system.stats.median('track'):.2f} ms/frame, solve median "
          f"{system.stats.median('solve'):.2f}; {EQUI_FRAMES / wall:.3f} frames/s, launches {counts}",
          flush=True)
    check(n_poses >= 10, f"equidistant: only {n_poses} poses in vio.txt")
    check(ate < ATE_BOUND_M, f"equidistant: ATE {ate:.4f} m is not below {ATE_BOUND_M} m")
    check(ate < ATE_BOUND_OF_PATH * path,
          f"equidistant: ATE {ate:.4f} m is not below {ATE_BOUND_OF_PATH:.0%} of {path:.3f} m")
    check(system.estimator.reboots == 0, "equidistant: the estimator rebooted")
    check(tracked_frames == EQUI_FRAMES - 1, f"equidistant: {tracked_frames} tracked frames")
    check(counts["lk_track"] == tracked_frames and counts["lk_level"] == 0 and counts["plain"] == 0,
          f"equidistant: launches {counts} for {tracked_frames} tracked frames")
    return counts


def phase_dynamic_cameras(torch, work_dir, main_times):
    """Phase 13; returns the launches of its two drives."""
    t0 = time.perf_counter()
    dyn, seq = phase_dynamic(torch, work_dir, main_times)
    phase_detector(torch, seq)
    cams = phase_cameras(torch, work_dir, main_times)
    print(f"dynamic and cameras: phase 13 took {time.perf_counter() - t0:.1f} s, phase 4 "
          f"{main_times['phase_s']:.1f} s (both with their rendering)", flush=True)
    return {k: dyn[k] + cams[k] for k in dyn}


# -------------------------------------------------------------------------- 14

# The last modules (phase 14): the stereo factors at the oracle's geometry
# (tests/test_solver.py::test_stereo_factors_zero_at_gt), the native ingest
# runtime against a NumPy drain, detector training with the JAX package's
# schedule (400 steps of 16 scenes, seed 0) held to phase 13a's recall bound,
# a short make_synth_seq sequence through the CLI, profile_step's stage table
# and the exact VIO-wheel parity scenario in float32 against its bound.
STEREO_TOL = {"float64": 1e-9, "float32": 1e-3}      # whitened px at ground truth
STEREO_JAC_REL = {"float64": 1e-9, "float32": 1e-3}   # the card's Jacobian against the CPU's
TRAIN_STEPS, TRAIN_BATCH = 400, 16
SYNTH_FRAMES = 12           # the window fills at frame 10: the first solves
SYNTH_CONFIG = ("camera:\n  fx: 460.0\n  fy: 460.0\n  cx: 320.0\n  cy: 240.0\n"
                "tracker:\n  max_features: 128\n  min_dist_px: 25.0\n  depth_max: 7.0\n"
                "use_depth: true\n")                   # tests/test_full_system.py's config
PROFILE_REPS = 1
PARITY_FRAMES = 20           # vio_wheel_exact's first 20 of 35 frames (a full chunk of 8 after
                             # the fill); all 35: scripts/parity.py
PARITY_BOUND_M = 0.05                                  # vio_wheel_exact (tests/test_pipeline.py)


def stereo_cases(torch, dtype, device):
    """The oracle's consistent two-camera geometry on ``device``: proj22's
    and proj12's (r, J) at ground truth."""
    import numpy as np

    from ground_fusion_tpu_torch.estimator.factors import proj12_factor, proj22_factor
    from ground_fusion_tpu_torch.geometry.se3 import pose_apply_inv, pose_compose
    from ground_fusion_tpu_torch.geometry.so3 import mat_to_quat, ypr_to_mat

    f64 = torch.float64
    R = ypr_to_mat(torch.tensor([0.1, -0.04, 0.02], dtype=f64))
    pose_i = torch.cat([torch.zeros(3, dtype=f64), mat_to_quat(torch.eye(3, dtype=f64))])
    pose_j = torch.cat([torch.tensor([0.5, 0.1, 0.0], dtype=f64), mat_to_quat(R)])
    ex0 = torch.tensor([0.0, 0, 0, 1, 0, 0, 0], dtype=f64)
    ex1 = torch.tensor([0.1, 0.0, 0.0, 1, 0, 0, 0], dtype=f64)       # 10 cm baseline
    pt_w = torch.tensor([0.3, -0.2, 4.0], dtype=f64)
    pc_i = pose_apply_inv(pose_compose(pose_i, ex0), pt_w)
    pc_j = pose_apply_inv(pose_compose(pose_j, ex1), pt_w)
    pc_1 = pose_apply_inv(pose_compose(pose_i, ex1), pt_w)
    z = torch.zeros(8, dtype=f64)
    obs22 = torch.cat([pc_i / pc_i[2], pc_j / pc_j[2], z])
    obs12 = torch.cat([pc_i / pc_i[2], pc_1 / pc_1[2], z])
    a = lambda t: t.to(dtype=dtype, device=device)
    scale, inv_dep, td = a(torch.tensor(460.0 / 1.5)), a(1.0 / pc_i[2]), a(torch.tensor(0.0))
    return {"proj22": proj22_factor(a(pose_i), a(pose_j), a(ex0), a(ex1), inv_dep, td,
                                    a(obs22), scale),
            "proj12": proj12_factor(a(ex0), a(ex1), inv_dep, td, a(obs12), scale)}


def phase_stereo_factors(torch, device="cuda"):
    """14a: proj22/proj12 on the card in float64 and float32 against the CPU."""
    cpu = stereo_cases(torch, torch.float64, torch.device("cpu"))
    line = []
    for name, dtype in (("float64", torch.float64), ("float32", torch.float32)):
        got = stereo_cases(torch, dtype, torch.device(device))
        for f in ("proj22", "proj12"):
            r, J = got[f]
            check(r.device.type == device and r.dtype == dtype, f"stereo: {f} {name} not on {device}")
            res = float(r.abs().max())
            J_ref = cpu[f][1]
            rel = float((J.double().cpu() - J_ref).abs().max() / J_ref.abs().max())
            check(res < STEREO_TOL[name], f"stereo: {f} {name} residual {res:.3e} at ground truth")
            check(rel < STEREO_JAC_REL[name], f"stereo: {f} {name} Jacobian {rel:.3e} from the CPU's")
            line.append(f"{f} {name} |r| {res:.3e}, J {rel:.3e} of the CPU's")
    print(f"stereo factors on {device} at ground truth: " + "; ".join(line), flush=True)


def numpy_drain(rows, t0, t1, cap):
    """The drain of ``native/src/ingest.cpp`` in NumPy: rows (t, a[3], b[3])
    with t in (t0, t1] (1e-9 slack) in time order, padded to ``cap``, seeded
    by the newest row at or before t0 (else the first in the interval)."""
    import numpy as np

    t = np.array([r[0] for r in rows])
    hit = np.nonzero((t > t0 + 1e-9) & (t <= t1 + 1e-9))[0]
    hit = hit[np.argsort(t[hit], kind="stable")][:cap]
    dts, a, b = np.zeros(cap), np.zeros((cap, 3)), np.zeros((cap, 3))
    valid = np.zeros(cap, bool)
    tp = t0
    for k, i in enumerate(hit):
        dts[k], tp = t[i] - tp, t[i]
        a[k], b[k], valid[k] = rows[i][1], rows[i][2], True
    before = np.nonzero(t <= t0 + 1e-9)[0]
    seed = (before[np.argmax(t[before])] if len(before) else hit[0] if len(hit) else None)
    a0, b0 = (rows[seed][1], rows[seed][2]) if seed is not None else (np.zeros(3), np.zeros(3))
    return dts, a, b, valid, np.asarray(a0, float), np.asarray(b0, float)


def numpy_sync_pairs(ts_a, ts_b, tol):
    """Greedy in-order timestamp pairing, as ``gf_sync_pairs``."""
    out, j = [], 0
    for i, ta in enumerate(ts_a):
        while j + 1 < len(ts_b) and abs(ts_b[j + 1] - ta) <= abs(ts_b[j] - ta):
            j += 1
        if len(ts_b) and abs(ts_b[j] - ta) <= tol:
            out.append((i, j))
    return out


def phase_native():
    """14b: ``libgfingest`` built by g++ here; seeded pushes drained and
    paired, against the NumPy drain of the same rows."""
    import numpy as np

    from ground_fusion_tpu_torch import native

    t0 = time.perf_counter()
    path = native.build()
    build_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    ing = native.NativeIngest()
    rows = {}
    for kind, n, rate in (("imu", 400, 200.0), ("wheel", 200, 100.0)):
        ts = np.cumsum(np.full(n, 1.0 / rate) + rng.uniform(-1e-4, 1e-4, n))
        order = np.arange(n)
        order[100:110] = order[100:110][::-1]                  # out of order
        rows[kind] = [(ts[k], rng.normal(size=3), rng.normal(size=3)) for k in order]
        push = ing.push_imu if kind == "imu" else ing.push_wheel
        for t, a, b in rows[kind]:
            push(t, a, b)
    cuts = [0.0, 0.1, 0.1, 0.2, 0.35, 0.5, 0.9, 1.2, 1.9, 2.5]
    n_drains = n_samples = 0
    for t_a, t_b in zip(cuts[:-1], cuts[1:]):
        for kind, cap in (("imu", 48), ("imu", 16), ("wheel", 24)):
            got = (ing.drain_imu if kind == "imu" else ing.drain_wheel)(t_a, t_b, cap)
            want = numpy_drain(rows[kind], t_a, t_b, cap)
            check(all(np.array_equal(x, y) for x, y in zip(got, want)),
                  f"native: {kind} drain ({t_a}, {t_b}] cap {cap} differs from NumPy's")
            n_drains += 1
            n_samples += int(got[3].sum())
    cam = np.arange(60) / 30.0 + rng.uniform(-0.002, 0.002, 60)
    depth = np.delete(np.arange(60) / 30.0 + rng.uniform(-0.005, 0.005, 60), [7, 8, 30])
    gi, gj = native.sync_pairs(cam, depth)
    want = numpy_sync_pairs(cam, depth, 0.003)
    check(list(zip(gi.tolist(), gj.tolist())) == want and len(want) > 0,
          "native: sync_pairs differs from NumPy's pairing")
    print(f"native: built {os.path.basename(path)} with g++ in {build_s:.1f} s; {n_drains} drains "
          f"({n_samples} samples) and {len(want)} sync pairs equal to NumPy's", flush=True)


def phase_train_detector(torch, device="cuda", steps=TRAIN_STEPS):
    """14c: ``train`` on the card (the JAX package's schedule) and the
    trained detector's recall on the 10 scenes of tests/test_detector.py."""
    import numpy as np

    from ground_fusion_tpu_torch.detector.model import detect
    from ground_fusion_tpu_torch.detector.train import render_scene, train

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    losses = []
    t0 = time.perf_counter()
    params = train(steps=steps, batch=TRAIN_BATCH, seed=0, log_every=0, losses=losses,
                   device=None if dev.type == "cuda" else dev)
    _sync(torch, dev)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**20 if dev.type == "cuda" else float("nan")
    check(all(t.device.type == dev.type for blk in params.convs for t in blk),
          f"train: weights not on {device}")
    first, last = losses[0], float(np.mean(losses[-20:]))
    check(np.isfinite(losses).all() and last < first,
          f"train: the loss did not fall ({first:.4f} to {last:.4f})")
    rng = np.random.default_rng(DET_SEED)
    results, gts = [], []
    for _ in range(DET_SCENES):
        img, boxes, n = render_scene(rng)
        results.append([x.cpu().numpy() for x in detect(params, torch.as_tensor(img, device=dev),
                                                        conf_thresh=DET_CONF)])
        gts.append((boxes, n))
    hits, total = detector_recall(np, results, gts)
    check(hits >= DET_RECALL * total, f"train: recall {hits}/{total} below {DET_RECALL}")
    print(f"train: {steps} steps of {TRAIN_BATCH} on {device}, loss {first:.4f} to {last:.4f} "
          f"(mean of the last 20), {1e3 * wall / steps:.2f} ms a step (scene rendering on the "
          f"host included), peak {peak:.1f} MiB; recall {hits}/{total} at IoU {DET_IOU} "
          f"(bound {DET_RECALL})", flush=True)


def phase_synth_cli(torch, work_dir, device="cuda"):
    """14d: make_synth_seq's sequence through ``__main__.run`` on the card;
    returns the launches."""
    import contextlib
    import io

    from ground_fusion_tpu_torch.__main__ import run
    from ground_fusion_tpu_torch.ops.cuda import hamming, klt
    from ground_fusion_tpu_torch.scripts import make_synth_seq

    seq = os.path.join(work_dir, "synth_seq")
    out = os.path.join(work_dir, "synth_out")
    cfg = os.path.join(work_dir, "synth.yaml")
    with open(cfg, "w") as fp:
        fp.write(SYNTH_CONFIG)
    with contextlib.redirect_stdout(io.StringIO()):
        make_synth_seq.main(seq, SYNTH_FRAMES)
    _zero_counters(klt, hamming)
    t0 = time.perf_counter()
    system = run(cfg, seq, out, device=None if device == "cuda" else device)
    _sync(torch, system.estimator.device)
    wall = time.perf_counter() - t0
    counts = _read_counters(klt, hamming)
    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    tracked = system.stats.counts["track"] - 1
    check(n_poses >= 1 and system.estimator.reboots == 0, "synth: no pose or a reboot")
    check(system.estimator.core.state.poses.device.type == device, f"synth: the state is not on {device}")
    # on the card one lk_track launch per tracked frame; the CPU runs the plain LK
    launched, plain = (tracked, 0) if device == "cuda" else (0, tracked)
    check(tracked == SYNTH_FRAMES - 1 and counts["lk_track"] == launched and counts["plain"] == plain,
          f"synth: {counts['lk_track']} lk_track launches for {tracked} tracked frames, "
          f"plain {counts['plain']}")
    print(f"synth: make_synth_seq wrote {SYNTH_FRAMES} frames; __main__.run gave {n_poses} poses, "
          f"ATE {ate:.5f} m over {path:.4f} m (mounts of the simulator, not asserted), "
          f"{SYNTH_FRAMES / wall:.3f} frames/s, launches {counts}", flush=True)
    return counts


def phase_profile_step(torch, device="cuda", cfg=None):
    """14e: profile_step's stage table on the card (the main path's config,
    float32; ``cfg`` to rehearse it small on the CPU, where the device
    checks are skipped)."""
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.scripts import profile_step

    rows = profile_step.profile(cfg or load_yaml(CONFIG_PATH), None if device == "cuda" else device,
                                torch.float32, reps=PROFILE_REPS,
                                out=lambda line: print("profile_step: " + line, flush=True))
    if device != "cuda":
        return
    rows = {r["stage"]: r for r in rows}
    # every stage takes time on the device's clock (CUDA events miss no
    # kernel); the profiler records kernels in the stages the step runs and
    # in the step, and their kernel time sums to no more than the step's
    check(all(r["device_ms"] > 0 for r in rows.values()),
          f"profile_step: a stage without device time: {rows}")
    check(all(rows[n]["kernels"] > 0 for n in profile_step.TOP_LEVEL + ("step",)),
          f"profile_step: the profiler recorded no kernel in a stage: {rows}")
    top = sum(rows[n]["kernel_ms"] for n in profile_step.TOP_LEVEL)
    step = rows["step"]
    check(top <= step["kernel_ms"], f"profile_step: the stages' kernel ms {top:.3f} exceed the "
                                    f"step's {step['kernel_ms']:.3f}")
    blind = [n for n, r in rows.items() if r["kernels"] == 0]
    print(f"profile_step: the step's stages {top:.3f} kernel ms of its {step['kernel_ms']:.3f}; "
          f"the step's kernels fill {step['kernel_ms'] / step['device_ms']:.4f} of its "
          f"{step['device_ms']:.3f} device ms; stages where the profiler recorded no kernel: "
          f"{blind}", flush=True)


def phase_parity(torch, device="cuda", n_frames=PARITY_FRAMES):
    """14f: the exact VIO-wheel parity scenario in bursts of 8, float32 on
    the card, against its bound (its first :data:`PARITY_FRAMES` frames:
    the whole scenario is ``scripts/parity.py``'s)."""
    import numpy as np

    from ground_fusion_tpu_torch.scripts.parity import run_pipeline
    from ground_fusion_tpu_torch.utils.evaluate import ate_rmse

    t0 = time.perf_counter()
    est, gt = run_pipeline(n_frames=n_frames, pix_noise=0.0, burst=8, dtype=torch.float32,
                           device=None if device == "cuda" else device)
    wall = time.perf_counter() - t0
    est_xyz = np.stack([p[0:3] for _, p in est.trajectory])
    ate = float(ate_rmse(est_xyz, np.stack([gt[t][0:3] for t, _ in est.trajectory])))
    check(est.core.state.poses.device.type == device and est.reboots == 0, "parity: state or reboot")
    check(BURST_CHUNK in est._burst_flushed_sizes, f"parity: chunks {est._burst_flushed_sizes}")
    check(ate < PARITY_BOUND_M, f"parity: vio_wheel_exact ATE {ate:.5f} m not below {PARITY_BOUND_M}")
    print(f"parity: vio_wheel_exact float32 on {device}, {n_frames} frames in bursts of 8, "
          f"{len(est.trajectory)} poses, chunks {est._burst_flushed_sizes}, ATE {ate!r} m "
          f"(bound {PARITY_BOUND_M} m), {wall:.1f} s", flush=True)


def phase_last_modules(torch, work_dir, main_times):
    """Phase 14; returns the launches of its CLI drive."""
    t0 = time.perf_counter()
    phase_stereo_factors(torch)
    phase_native()
    phase_train_detector(torch)
    counts = phase_synth_cli(torch, work_dir)
    phase_profile_step(torch)
    phase_parity(torch)
    print(f"last modules: phase 14 took {time.perf_counter() - t0:.1f} s, phase 4 "
          f"{main_times['phase_s']:.1f} s", flush=True)
    return counts


# ------------------------------------------------------------------------ main


def main() -> int:
    torch, card = phase_device()
    phase_build()
    entries = {"lk_level": phase_kernels(torch), "lk_track": phase_track(torch)}
    entries["hamming_matrix"], entries["hamming_match"] = phase_hamming(torch)
    if "--kernels" in sys.argv[1:]:
        print(json.dumps({"kernels": list(entries.values())}))
        print("chip_smoke: kernel phases passed; main path not run")
        return 0
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.environ.get("TMPDIR"))
    t_start = time.perf_counter()

    def timed(phase, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {phase} took {time.perf_counter() - t0:.1f} s "
              f"({time.perf_counter() - t_start:.1f} s since phase 4 began)", flush=True)
        return out

    try:
        main_counts, main_times = timed(4, phase_main, torch, work_dir)
        revisit_counts = timed(5, phase_revisit, torch, work_dir)
        timed(6, phase_solvers, torch, work_dir)
        gnss_counts = timed(7, phase_gnss, torch, work_dir, main_times)
        path_c_counts = timed(8, phase_path_c, torch, work_dir, main_times)
        timed(9, phase_map, torch, work_dir)
        line_counts = timed(10, phase_lines, torch, work_dir, main_times)
        mode_counts = timed(11, phase_modes, torch, work_dir, main_times)
        ckpt_counts = timed(12, phase_checkpoint, torch, work_dir)
        dyn_counts = timed(13, phase_dynamic_cameras, torch, work_dir, main_times)
        last_counts = timed(14, phase_last_modules, torch, work_dir, main_times)
        for name, entry in entries.items():
            entry["launches"] = (main_counts[name] + revisit_counts[name] + gnss_counts[name]
                                 + path_c_counts[name] + line_counts[name] + mode_counts[name]
                                 + ckpt_counts[name] + dyn_counts[name] + last_counts[name])
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--shard-worker"]:
        rank, world, address, device, out_path, *rest = sys.argv[2:] + ["", ""]
        shard_worker(int(rank), int(world), address, device, out_path, rest[0], rest[1])
        sys.exit(0)
    sys.exit(main())
