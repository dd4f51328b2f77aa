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
Then the card's line, the ``{"kernels": [...]}`` line (one entry per kernel
entry point: ``lk_level``, ``lk_track``, ``hamming_matrix``,
``hamming_match``; launches counted on the paths of phases 4 and 5), and the
last line ``{"ok": true, "device": {...}}``.

The script imports only the port (never JAX or the JAX package), needs no
network, and starts no process that outlives it.
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


def phase_main(torch, work_dir):
    import numpy as np

    from ground_fusion_tpu_torch.__main__ import run
    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    cfg_path = _loop_config(work_dir)
    seq = os.path.join(work_dir, "seq")
    out = os.path.join(work_dir, "out")
    t0 = time.perf_counter()
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
    return counts


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
    try:
        main_counts = phase_main(torch, work_dir)
        revisit_counts = phase_revisit(torch, work_dir)
        for name, entry in entries.items():
            entry["launches"] = main_counts[name] + revisit_counts[name]
        phase_solvers(torch, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": list(entries.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
