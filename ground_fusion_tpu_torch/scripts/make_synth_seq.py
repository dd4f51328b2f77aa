"""Render a synthetic image sequence from the simulator into the dataset
directory layout (``io/dataset.py``): ``imu.csv``, ``wheel.csv``,
``frames.csv``, ``gt.csv`` and ``img/*.npy`` (grey image and depth), the
files that ``scripts/make_synth_seq.py`` writes from the JAX package's
simulator, here from the port's (float64 on the CPU: these are set-up data).
The sequence drives the whole system, front end included, with no external
dataset:

    python -m ground_fusion_tpu_torch.scripts.make_synth_seq <out_dir> [n_frames]
    python -m ground_fusion_tpu_torch <config.yaml> <out_dir> <run_dir>

The simulator's camera mount is ``sim.synthetic.body_T_cam`` and the IMU is
the body: a config must state the same mounts (its defaults do).
"""

from __future__ import annotations

import os
import sys

import numpy as np

FX = FY = 460.0
CX, CY = 320.0, 240.0
W, H = 640, 480


def render(uv_px, z, vis, rng):
    """Gaussian blobs at projected landmark pixels over a dark background."""
    img = rng.normal(8.0, 1.0, (H, W)).astype(np.float32)
    depth = np.zeros((H, W), np.float32)
    ys, xs = np.mgrid[0:7, 0:7] - 3
    blob = 200.0 * np.exp(-(xs**2 + ys**2) / 4.0)
    for (u, v), d, ok in zip(uv_px, z, vis):
        if not ok:
            continue
        ui, vi = int(round(u)), int(round(v))
        if 4 <= ui < W - 4 and 4 <= vi < H - 4:
            img[vi - 3 : vi + 4, ui - 3 : ui + 4] += blob
            depth[vi - 3 : vi + 4, ui - 3 : ui + 4] = d
    return np.clip(img, 0, 255), depth


def main(out_dir: str, n_frames: int = 40) -> None:
    import torch

    from ground_fusion_tpu_torch.sim.synthetic import (
        SimParams,
        body_T_cam,
        gt_pose7,
        imu_samples,
        make_landmarks,
        project_landmarks,
        wheel_samples,
    )

    sp = SimParams(omega=0.25)
    os.makedirs(os.path.join(out_dir, "img"), exist_ok=True)
    ex = body_T_cam(torch.float64)
    pts_w = torch.as_tensor(make_landmarks(600, sp, seed=1), dtype=torch.float64)
    rng = np.random.default_rng(0)

    frame_dt = 1.0 / sp.frame_rate
    imu_rows, wheel_rows, frame_rows, gt_rows = [], [], [], []
    for k in range(n_frames):
        t = k * frame_dt
        tp = t - frame_dt if k else t
        # each interval's samples from the previous frame's time on (that
        # sample repeats at every frame boundary, as in the JAX script)
        for rows, rate, samples in ((imu_rows, sp.imu_rate, imu_samples),
                                    (wheel_rows, sp.wheel_rate, wheel_samples)):
            ts = np.arange(tp, t + 1e-9, 1.0 / rate) if k else np.array([t])
            a, g = (x.numpy() for x in samples(ts, sp))
            rows.extend(np.concatenate([ts[:, None], a, g], axis=1))

        pose = gt_pose7(t, sp)
        uv, z, vis = project_landmarks(pose, ex, pts_w)
        uv_px = uv.numpy() * [FX, FY] + [CX, CY]
        img, depth = render(uv_px, z.numpy(), vis.numpy(), rng)
        np.save(os.path.join(out_dir, "img", f"{k:05d}.npy"), img)
        np.save(os.path.join(out_dir, "img", f"{k:05d}_d.npy"), depth)
        frame_rows.append(f"{t:.6f},img/{k:05d}.npy,img/{k:05d}_d.npy")
        p = pose.numpy()
        gt_rows.append(f"{t:.6f} {p[0]} {p[1]} {p[2]} {p[4]} {p[5]} {p[6]} {p[3]}")

    np.savetxt(os.path.join(out_dir, "imu.csv"), np.asarray(imu_rows), delimiter=",")
    np.savetxt(os.path.join(out_dir, "wheel.csv"), np.asarray(wheel_rows), delimiter=",")
    with open(os.path.join(out_dir, "frames.csv"), "w") as f:
        f.write("\n".join(frame_rows) + "\n")
    with open(os.path.join(out_dir, "gt.csv"), "w") as f:
        f.write("\n".join(gt_rows) + "\n")
    print(f"wrote {n_frames} frames to {out_dir}")


if __name__ == "__main__":
    if len(sys.argv) < 2:
        sys.exit("usage: python -m ground_fusion_tpu_torch.scripts.make_synth_seq <out_dir> [n_frames]")
    main(sys.argv[1], int(sys.argv[2]) if len(sys.argv) > 2 else 40)
