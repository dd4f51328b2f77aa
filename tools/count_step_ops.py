#!/usr/bin/env python3
"""How many tensor operations one window step dispatches, and in which part.

    python3 tools/count_step_ops.py [--device cpu|cuda]

Feeds the simulator's exact feature stream (no images) to the port's
``Estimator`` at ``configs/groundchallenge.yaml`` until the window is solved,
then counts, for one more frame, every operation that reaches the dispatcher
(a ``TorchDispatchMode``; each is one kernel launch on a GPU, give or take
views) and attributes it to the function of ``estimator/step.py`` it ran
under. The count does not depend on the device, so the default is the CPU.
The wall times it prints are the host's, on whatever device was asked for.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

WARM_FRAMES = 13        # 11 fill the window, 2 more are solved before the counted one


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cpu")
    args = ap.parse_args()

    import numpy as np
    import torch
    from torch.utils._python_dispatch import TorchDispatchMode

    import ground_fusion_tpu_torch.estimator.step as step_mod
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.pipeline import Estimator, FrameFeature
    from ground_fusion_tpu_torch.sim import synthetic as sim

    n_ops = [0]

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            n_ops[0] += 1
            return func(*args, **(kwargs or {}))

    stats: dict[str, list] = {}

    def wrap(name):
        inner = getattr(step_mod, name)

        def counted(*a, **k):
            n0, t0 = n_ops[0], time.perf_counter()
            out = inner(*a, **k)
            s = stats.setdefault(name, [0, 0, 0.0])
            s[0] += 1
            s[1] += n_ops[0] - n0
            s[2] += time.perf_counter() - t0
            return out

        setattr(step_mod, name, counted)

    # every function of the port that the step module calls by name
    for name in dir(step_mod):
        fn = getattr(step_mod, name)
        if (callable(fn) and not isinstance(fn, type) and not name.startswith("_")
                and getattr(fn, "__module__", "").startswith("ground_fusion_tpu_torch")):
            wrap(name)

    cfg = load_yaml(os.path.join(ROOT, "configs", "groundchallenge.yaml"))
    sp = sim.SimParams(omega=0.15, frame_rate=30.0, stop_t1=-5.0, stop_t2=0.5, stop_tau=0.15)
    est = Estimator(cfg, device=args.device)
    ex = sim.body_T_cam()
    pts = torch.as_tensor(sim.make_landmarks(800, sp, seed=1), dtype=torch.float64)
    frame_dt, imu_dt, wheel_dt = 1.0 / sp.frame_rate, 1.0 / sp.imu_rate, 1.0 / sp.wheel_rate

    def feed(ts_imu, ts_wheel):
        acc, gyr = (x.numpy() for x in sim.imu_samples(ts_imu, sp))
        vel, wgyr = (x.numpy() for x in sim.wheel_samples(ts_wheel, sp))
        for t, a, g in zip(ts_imu, acc, gyr):
            est.input_imu(float(t), a, g)
        for t, v, w in zip(ts_wheel, vel, wgyr):
            est.input_wheel(float(t), v, w)

    feed(np.array([0.0]), np.array([0.0]))
    for k in range(WARM_FRAMES + 1):
        t = k * frame_dt
        if k:
            feed(np.arange(t - frame_dt + imu_dt, t + 0.5 * imu_dt, imu_dt),
                 np.arange(t - frame_dt + wheel_dt, t + 0.5 * wheel_dt, wheel_dt))
        uv, z, vis = sim.project_landmarks(sim.gt_pose7(t, sp), ex, pts)
        ids = np.nonzero(vis.numpy())[0][: cfg.tracker.max_features]
        feats = {int(i): FrameFeature(x=float(uv[i, 0]), y=float(uv[i, 1]), depth=float(z[i]))
                 for i in ids}
        if k < WARM_FRAMES:
            est.input_frame(t, feats)
            continue
        stats.clear()
        n_ops[0] = 0
        with Count():
            t0 = time.perf_counter()
            pose = est.input_frame(t, feats)
            dt = time.perf_counter() - t0
        assert pose is not None, "the counted frame was not solved"
        print(f"one frame on {args.device}: {n_ops[0]} operations dispatched, {dt:.3f} s, "
              f"{len(feats)} features")
    for name, (calls, ops, secs) in sorted(stats.items(), key=lambda kv: -kv[1][1]):
        print(f"{name:32s} calls {calls:3d}  operations {ops:7d}  {secs:7.3f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
