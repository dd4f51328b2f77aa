#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, needs one CUDA device
    python3 chip_smoke.py --kernels  # phases 1-3 only (a quick kernel check; prints no result line)

Phases (any failure ends the run with a non-zero exit code):

1. device   — require CUDA; print the card's name and power limit.
2. build    — build every CUDA source of the main path with nvcc (one process
              per source, started together) and print the seconds it took.
3. kernels  — call each kernel's wrapper on GPU tensors at the shapes the main
              path gives it and hold the result against its plain PyTorch
              version on the same inputs; time both with CUDA events; print
              the ``{"kernels": [...]}`` line.
4. main     — render a 40-frame 640x480 sequence with the port's simulator at
              the intrinsics and sensor mounts of ``configs/groundchallenge.yaml``
              (a vehicle that stands, then drives off along a circle, seen at
              30 frames a second) and run it through
              ``ground_fusion_tpu_torch.__main__.run`` on the GPU; check the
              trajectory, the device of the state and the launch counters;
              print per-stage times.
5. the last line: ``{"ok": true, "device": {...}}``.

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

N_FEATURES = 150
LEVEL_SHAPES = [(480, 640), (240, 320), (120, 160)]   # (h, w) of the 3 pyramid levels
HALF, ITERS, MIN_EIG = 10, 10, 1e-4
PTS_TOL_PX = 1e-3        # 441-term f32 sums taken in another order than the plain version
GATE_REL = 1e-3          # |eig_min/n - min_eig| / min_eig below which a mask flip is rounding
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
    from ground_fusion_tpu_torch.ops.cuda import build, klt

    t0 = time.perf_counter()
    build.build_all([klt.KERNEL_NAME])
    build.library(klt.KERNEL_NAME)
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


def _lk_bound_ms(h, w, n, n_valid, n_good):
    """Least time the card could take for this call's work: the larger of
    bytes moved once over the memory rate and operations over the f32 rate.
    The work depends on the data: an invalid feature costs nothing, a valid
    one the template and the structure tensor, a good one the iterations too."""
    p, pb = 2 * HALF + 1, 2 * HALF + 3
    bytes_moved = 2 * h * w * 4 + 2 * n * 8 + n + n * 8 + n
    tap = 14                                  # one bilinear tap: weights + 4 multiply-adds
    flop_template = pb * pb * tap + p * p * 10
    flop_iter = p * p * (tap + 5) + 12
    flops = n_valid * flop_template + n_good * ITERS * flop_iter
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOP_PER_S * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


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
        plain_ms = _time_ms(torch, run_plain, reps=10, warmup=2)
        n_valid, n_good = int(valid.sum()), int(k_ok.sum())
        bound_ms, bound_by = _lk_bound_ms(h, w, N_FEATURES, n_valid, n_good)
        per_shape.append({"shape": [h, w], "n": N_FEATURES, "n_ok": n_good, "mask_flips": n_flip,
                          "max_abs_err": err, "shift_err_px": shift_err, "ms": ms,
                          "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by})
        print(f"lk_level {h}x{w}: ok {n_good}/{N_FEATURES}, flips {n_flip}, max err {err:.2e} px, "
              f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.5f} ms ({bound_by})",
              flush=True)

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
        "ms": top["ms"], "plain_ms": top["plain_ms"], "bound_ms": top["bound_ms"],
        "bound_by": top["bound_by"], "library_ms": None,
        "tolerance_px": PTS_TOL_PX, "shapes": per_shape,
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


def phase_main(torch, work_dir):
    from ground_fusion_tpu_torch.__main__ import run
    from ground_fusion_tpu_torch.ops.cuda import klt

    cfg_path = CONFIG_PATH
    seq = os.path.join(work_dir, "seq")
    out = os.path.join(work_dir, "out")
    t0 = time.perf_counter()
    render_smoke_sequence(seq)
    print(f"rendered {N_FRAMES} frames in {time.perf_counter() - t0:.1f} s", flush=True)

    klt.LAUNCHES = 0
    klt.REFERENCE_CALLS = 0
    t0 = time.perf_counter()
    system = run(cfg_path, seq, out)          # device=None: the GPU
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, plain_calls = klt.LAUNCHES, klt.REFERENCE_CALLS

    n_poses, ate, path = trajectory_ate(os.path.join(out, "vio.txt"), os.path.join(seq, "gt.csv"))
    check(n_poses >= 20, f"main path: only {n_poses} poses in vio.txt")
    print(f"main path: {n_poses} poses over {path:.4f} m, ATE {ate:.5f} m "
          f"(bounds {ATE_BOUND_M} m and {ATE_BOUND_OF_PATH:.0%} of the path)")
    check(ate < ATE_BOUND_M, f"main path: ATE {ate:.4f} m is not below {ATE_BOUND_M} m")
    check(ate < ATE_BOUND_OF_PATH * path,
          f"main path: ATE {ate:.4f} m is not below {ATE_BOUND_OF_PATH:.0%} of {path:.3f} m")

    core = system.estimator.core
    tensors = list(core.state) + list(core.tracks) + list(core.imu_buf) + list(core.wheel_buf) \
        + [core.prior.J0, core.prior.r0, core.prior.valid] + list(core.prior.lin)
    check(all(t.is_cuda for t in tensors), "main path: a state tensor is not on the GPU")
    check(core.state.poses.dtype == torch.float32, "main path: the state is not float32")
    check(system.estimator.reboots == 0, "main path: the estimator rebooted")

    # 6 launches (3 levels x forward and backward) for every frame that had
    # features to track: every frame after the first
    tracked_frames = system.stats.counts["track"] - 1
    check(tracked_frames == N_FRAMES - 1, f"main path: {tracked_frames} tracked frames")
    check(launches == 6 * tracked_frames,
          f"main path: {launches} lk_level launches, expected {6 * tracked_frames}")
    check(plain_calls == 0, f"main path: the plain version ran {plain_calls} times")

    # the front end really fed the estimator: tracks survive, landmarks are solved
    n_tracked = int((system.tracker.track_len >= 5).sum())
    n_solved = int((core.tracks.active & core.tracks.solve_ok).sum())
    print(f"main path: {n_tracked} features tracked over 5+ frames, {n_solved} landmarks solved")
    check(n_tracked >= MIN_TRACKED, f"main path: only {n_tracked} features tracked over 5+ frames")
    check(n_solved >= MIN_SOLVED_LANDMARKS, f"main path: only {n_solved} landmarks solved")

    stats = system.stats
    print(f"main path: track median {stats.median('track'):.2f} ms/frame "
          f"(mean {stats.mean('track'):.2f}), solve median {stats.median('solve'):.2f} ms/frame "
          f"(mean {stats.mean('solve'):.2f}) over {stats.counts['solve']} frames")
    print(f"main path: {N_FRAMES / wall:.3f} frames/s ({wall:.1f} s wall for {N_FRAMES} frames, "
          f"image loading included), lk_level launches {launches}", flush=True)
    return launches


# ------------------------------------------------------------------------ main


def main() -> int:
    torch, card = phase_device()
    phase_build()
    entry = phase_kernels(torch)
    if "--kernels" in sys.argv[1:]:
        print(json.dumps({"kernels": [entry]}))
        print("chip_smoke: kernel phases passed; main path not run")
        return 0
    work_dir = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.environ.get("TMPDIR"))
    try:
        entry["launches"] = phase_main(torch, work_dir)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(card)
    print(json.dumps({"kernels": [entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
