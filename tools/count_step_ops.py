#!/usr/bin/env python3
"""How many tensor operations one window step dispatches, and in which part.

    python3 tools/count_step_ops.py [--device cpu|cuda] [--config configs/m2dgrp.yaml]
        [--use-line]

Feeds the simulator's exact feature stream (no images; IMU and wheel at the
config's mounts, as the renderer places them) to the port's ``Estimator`` at
a config (default ``configs/groundchallenge.yaml``) until the window is solved, then counts, for one more frame, every operation that
reaches the dispatcher (a ``TorchDispatchMode``; each is one kernel launch on
a GPU, give or take views) and attributes it to the function of
``estimator/step.py`` it ran under, and to the GNSS row builders of
``gnss/factors.py`` and the solve's pose-0 anchor rows. With a config that enables GNSS, each frame also gets a
GNSS epoch (the receiver of ``chip_smoke.py``'s phase 7), and the counted
frame is the third after the one in which GNSS-VI alignment happened, so the
GNSS rows are live. With ``--use-line`` the config's ``use_line`` is switched
on and each frame also carries the simulator's segments (``make_segments``,
``project_segments``) as line observations; the line blocks of
``estimator/lines.py`` are counted by name. The
count does not depend on the device, so the default is the CPU. The wall
times it prints are the host's, on whatever device was asked for.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARM_FRAMES = 13        # 11 fill the window, 2 more are solved before the counted one
MAX_GNSS_WARM = 60      # frames to wait for GNSS-VI alignment


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--config", default=os.path.join(ROOT, "configs", "groundchallenge.yaml"))
    ap.add_argument("--use-line", action="store_true")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import ground_fusion_tpu_torch.estimator.assembly as assembly_mod
    import ground_fusion_tpu_torch.estimator.lines as lines_mod
    import ground_fusion_tpu_torch.estimator.step as step_mod
    import ground_fusion_tpu_torch.gnss.factors as gnss_mod
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.pipeline import Estimator, FrameFeature
    from ground_fusion_tpu_torch.sim import synthetic as sim
    from ground_fusion_tpu_torch.sim.render import Mounts, imu_at_mount, vehicle_T_imu, wheel_at_mount

    n_ops = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n_ops[0] += 1
            return func(*args, **(kwargs or {}))

    stats: dict[str, list] = {}

    def wrap(name, mod=step_mod):
        inner = getattr(mod, name)

        def counted(*a, **k):
            n0, t0 = n_ops[0], time.perf_counter()
            out = inner(*a, **k)
            s = stats.setdefault(name, [0, 0, 0.0])
            s[0] += 1
            s[1] += n_ops[0] - n0
            s[2] += time.perf_counter() - t0
            return out

        setattr(mod, name, counted)

    # every function of the port that the step module calls by name
    for name in dir(step_mod):
        fn = getattr(step_mod, name)
        if (callable(fn) and not isinstance(fn, type) and not name.startswith("_")
                and getattr(fn, "__module__", "").startswith("ground_fusion_tpu_torch")):
            wrap(name)
    # the GNSS row builders, which the assembly looks up at each call, and
    # the pose-0 anchor rows that come with them
    for name in ("linearize_gnss_psr_dopp", "linearize_clock_chain", "gnss_psr_dopp_residuals",
                 "clock_chain_residuals"):
        wrap(name, gnss_mod)
    wrap("linearize_pose_anchor", assembly_mod)
    # the line rows and their residual probe, looked up at each call too
    for name in ("linearize_lines", "line_residuals"):
        wrap(name, lines_mod)

    cfg = load_yaml(args.config)
    if args.use_line:
        import dataclasses

        cfg = dataclasses.replace(cfg, use_line=True)
    sp = sim.SimParams(omega=0.15, frame_rate=30.0, stop_t1=-5.0, stop_t2=0.5, stop_tau=0.15)
    est = Estimator(cfg, device=args.device)
    ex = sim.body_T_cam()
    pts = torch.as_tensor(sim.make_landmarks(800, sp, seed=1), dtype=torch.float64)
    segs = torch.as_tensor(sim.make_segments(64, sp, seed=2), dtype=torch.float64)
    frame_dt, imu_dt, wheel_dt = 1.0 / sp.frame_rate, 1.0 / sp.imu_rate, 1.0 / sp.wheel_rate

    mounts = Mounts.from_config(cfg)
    r_x, t_x = vehicle_T_imu(mounts)

    def feed(ts_imu, ts_wheel):
        acc, gyr = imu_at_mount(ts_imu, sp, r_x, t_x)
        vel, wgyr = wheel_at_mount(ts_wheel, sp, r_x, t_x, mounts.t_io, mounts.q_io)
        for t, a, g in zip(ts_imu, acc, gyr):
            est.input_imu(float(t), a, g)
        for t, v, w in zip(ts_wheel, vel, wgyr):
            est.input_wheel(float(t), v, w)

    world = None
    if cfg.gnss.enabled:
        import chip_smoke

        world = chip_smoke.GnssWorld(np, sp, mounts)
    aligned_at = None
    feed(np.array([0.0]), np.array([0.0]))
    for k in range(MAX_GNSS_WARM):
        t = k * frame_dt
        if k:
            feed(np.arange(t - frame_dt + imu_dt, t + 0.5 * imu_dt, imu_dt),
                 np.arange(t - frame_dt + wheel_dt, t + 0.5 * wheel_dt, wheel_dt))
        if world is not None:
            est.input_gnss(t, world.epoch(t))
        uv, z, vis = sim.project_landmarks(sim.gt_pose7(t, sp), ex, pts)
        ids = np.nonzero(vis.numpy())[0][: cfg.tracker.max_features]
        feats = {int(i): FrameFeature(x=float(uv[i, 0]), y=float(uv[i, 1]), depth=float(z[i]))
                 for i in ids}
        line_obs = None
        if cfg.use_line:
            obs4, lvis = sim.project_segments(sim.gt_pose7(t, sp), ex, segs)
            line_obs = {int(i): obs4[i].numpy() for i in np.nonzero(lvis.numpy())[0]}
        if aligned_at is None and (world is None or est.gnss_aligned):
            aligned_at = k
        if k < WARM_FRAMES or aligned_at is None or k < aligned_at + 2:
            est.input_frame(t, feats, line_obs=line_obs)
            continue
        stats.clear()
        n_ops[0] = 0
        with Count():
            t0 = time.perf_counter()
            pose = est.input_frame(t, feats, line_obs=line_obs)
            dt = time.perf_counter() - t0
        assert pose is not None, "the counted frame was not solved"
        print(f"one frame on {args.device}: {n_ops[0]} operations dispatched, {dt:.3f} s, "
              f"{len(feats)} features, config {os.path.basename(args.config)}"
              + (f", frame {k}, GNSS aligned at frame {aligned_at}, "
                 f"{int(est.core.gnss_obs.valid.sum())} valid GNSS slots" if world else "")
              + (f", {len(line_obs)} line observations, {int(est.core.lines.active.sum())} "
                 f"active line slots ({int((est.core.lines.active & est.core.lines.solve_ok).sum())}"
                 f" solved)" if cfg.use_line else ""))
        break
    else:
        raise SystemExit("GNSS-VI alignment did not happen within the warm-up")
    for name, (calls, ops, secs) in sorted(stats.items(), key=lambda kv: -kv[1][1]):
        print(f"{name:32s} calls {calls:3d}  operations {ops:7d}  {secs:7.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
