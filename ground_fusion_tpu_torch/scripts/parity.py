"""Float32 on the card against the float64 oracle on the CPU, through the
port only: the counterpart of ``scripts/parity_tpu.py``.

Runs the test suite's golden synthetic replays (``tests/test_pipeline.py``:
the VIO-wheel replay with exact and with noisy measurements, 35 frames in
bursts of 8, and the tight-GNSS replay, 24 frames with an epoch every third
frame once aligned) once on the card in float32 (the production
configuration) and once on the CPU in float64 (the dtype every accuracy
bound of the suite is stated against), and checks the card's ATE against
the same bounds: 0.05, 0.15 and 0.1 m.

    python -m ground_fusion_tpu_torch.scripts.parity card     # cuda, float32; one JSON line
    python -m ground_fusion_tpu_torch.scripts.parity cpu      # cpu, float64; one JSON line
    python -m ground_fusion_tpu_torch.scripts.parity both [--write-md PATH]
    python -m ground_fusion_tpu_torch.scripts.parity cpu --dtype float32 --frames 16

``both`` runs the two as subprocesses side by side and prints the report;
``--write-md PATH`` writes it as a Markdown table (the JAX package's
``PARITY_TPU.md`` is its own record and is never written). ``--frames N``
shortens every replay (a rehearsal: the bounds are the full replays').
The drives are :func:`run_pipeline` and :func:`run_gnss_pipeline`, the
suite's drivers on the port's simulator, both fed from
:func:`simulator_drive`.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np

BOUNDS = {
    # the suite's own assertions (tests/test_pipeline.py): exact-measurement
    # VIO ATE < 0.05 m, noisy < 0.15 m, the GNSS replay < 0.1 m (and its
    # newest pose within 1 m in ECEF)
    "vio_wheel_exact": 0.05,
    "vio_wheel_noisy": 0.15,
    "gnss_tight": 0.1,
}
ECEF_BOUND_M = 1.0
YAW_TRUE = 0.25
ANC_LLA = (31.0, 121.4, 12.0)       # degrees, degrees, m


def simulator_drive(n_frames: int, n_landmarks: int = 200, sp=None, pix_noise: float = 0.0,
                    segments: int = 0) -> list:
    """The sensor and feature stream of ``tests/test_pipeline.py::run_pipeline``
    from the port's simulator (``sp``, default ``SimParams()``): one entry
    per frame with its time ``t``, its ground-truth pose ``gt``, the IMU and
    wheel samples since the previous frame (the first frame carries the
    samples at t = 0), the visible landmarks of ``n_landmarks`` (seed 1) as
    ``feats``, ``id -> (x, y, depth)`` in id order, projected exactly plus
    ``pix_noise`` (drawn from ``default_rng(7)`` over every landmark, frame
    after frame), and, with ``segments``, the visible segments' endpoints
    as ``lines``."""
    import torch

    from ..sim import synthetic as sim

    sp = sp if sp is not None else sim.SimParams()
    ex = sim.body_T_cam(torch.float64)
    pts_w = torch.as_tensor(sim.make_landmarks(n_landmarks, sp, seed=1))
    segs_w = torch.as_tensor(sim.make_segments(segments, sp, seed=2)) if segments else None
    rng = np.random.default_rng(7)
    frame_dt, imu_dt, wheel_dt = 1.0 / sp.frame_rate, 1.0 / sp.imu_rate, 1.0 / sp.wheel_rate
    ts = [k * frame_dt for k in range(n_frames)]
    t_imu = [np.array([0.0])] + [np.arange(t - frame_dt + imu_dt, t + 0.5 * imu_dt, imu_dt)
                                 for t in ts[1:]]
    t_wheel = [np.array([0.0])] + [np.arange(t - frame_dt + wheel_dt, t + 0.5 * wheel_dt, wheel_dt)
                                   for t in ts[1:]]
    acc, gyr = (x.numpy() for x in sim.imu_samples(np.concatenate(t_imu), sp))
    vel, wgyr = (x.numpy() for x in sim.wheel_samples(np.concatenate(t_wheel), sp))
    drive, i, j = [], 0, 0
    for k, t in enumerate(ts):
        ni, nw = len(t_imu[k]), len(t_wheel[k])
        pose = sim.gt_pose7(t, sp)
        uv, z, vis = (x.numpy() for x in sim.project_landmarks(pose, ex, pts_w))
        if pix_noise > 0:
            uv = uv + rng.normal(0, pix_noise, uv.shape)
        fr = dict(t=t, gt=pose.numpy(),
                  imu=list(zip(t_imu[k].tolist(), acc[i : i + ni], gyr[i : i + ni])),
                  wheel=list(zip(t_wheel[k].tolist(), vel[j : j + nw], wgyr[j : j + nw])),
                  feats={int(n): (float(uv[n, 0]), float(uv[n, 1]), float(z[n]))
                         for n in np.nonzero(vis)[0]})
        if segs_w is not None:
            obs4, lvis = (x.numpy() for x in sim.project_segments(pose, ex, segs_w))
            fr["lines"] = {int(n): obs4[n] for n in np.nonzero(lvis)[0]}
        drive.append(fr)
        i, j = i + ni, j + nw
    return drive


def feed_sensors(est, fr) -> None:
    """A drive entry's IMU and wheel samples into an estimator (either
    package's: both take NumPy samples)."""
    for t, a, g in fr["imu"]:
        est.input_imu(t, a, g)
    for t, v, w in fr["wheel"]:
        est.input_wheel(t, v, w)


def feed_frame(est, fr):
    """A drive entry's features (and lines) into the port's ``Estimator``;
    what ``input_frame`` returned."""
    from ..pipeline import FrameFeature

    feats = {i: FrameFeature(x=x, y=y, depth=d) for i, (x, y, d) in fr["feats"].items()}
    return est.input_frame(fr["t"], feats, line_obs=fr.get("lines"))


def feed_drive(est, drive, frames) -> list:
    """Feed ``drive[k]`` for ``k`` in ``frames`` to an ``Estimator``; the
    pose each ``input_frame`` returned (or None), per frame."""
    out = []
    for k in frames:
        feed_sensors(est, drive[k])
        out.append(feed_frame(est, drive[k]))
    return out


def run_pipeline(n_frames=35, pix_noise=0.0, burst=0, cfg=None, dtype=None, device=None):
    """``tests/test_pipeline.py::run_pipeline`` on the port: the
    :func:`simulator_drive` fed frame by frame to an ``Estimator`` of
    ``cfg`` (default ``Config()``) in ``dtype`` on ``device`` (``None``:
    float64, the GPU), in bursts of ``burst`` when it is set. Returns
    (estimator, {t: ground-truth pose})."""
    import torch

    from ..config import Config
    from ..pipeline import Estimator

    est = Estimator(cfg if cfg is not None else Config(), dtype=dtype or torch.float64,
                    device=device)
    if burst:
        est.enable_burst(burst)
    drive = simulator_drive(n_frames, pix_noise=pix_noise)
    feed_drive(est, drive, range(n_frames))
    if burst:
        est.flush_burst()
    return est, {fr["t"]: fr["gt"] for fr in drive}


class GnssTruth:
    """The GNSS world of ``tests/test_pipeline.py::_run_gnss_pipeline``: the
    simulator's frame mapped to ECEF through its first pose, the anchor at
    :data:`ANC_LLA` and the ENU-local yaw :data:`YAW_TRUE`; 10 satellites
    (seed 3) with receiver clocks (15, 0, 0, 22) m drifting 4 m/s."""

    def __init__(self, sp):
        from ..geometry.se3 import pose_inverse
        from ..gnss.coords import ecef2rotation, geo2ecef
        from ..sim import gnss as sim_gnss
        from ..sim import synthetic as sim

        self.sp = sp
        self.anc = geo2ecef(np.array([np.deg2rad(ANC_LLA[0]), np.deg2rad(ANC_LLA[1]), ANC_LLA[2]]))
        cy, sy = np.cos(YAW_TRUE), np.sin(YAW_TRUE)
        self.R = ecef2rotation(self.anc) @ np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        self.T0_inv = pose_inverse(sim.gt_pose7(0.0, sp))
        rng = np.random.default_rng(3)
        self.sats = sim_gnss.sky(self.anc, 10, rng, el_deg=(35.0, 80.0))
        self.sat_vel = rng.normal(0, 2500, (10, 3))

    def p_ecef(self, t):
        from ..geometry.se3 import pose_apply
        from ..sim import synthetic as sim

        return self.anc + self.R @ pose_apply(self.T0_inv, sim.gt_pose7(t, self.sp)[0:3]).numpy()

    def epoch(self, t):
        from ..geometry.so3 import quat_to_mat
        from ..sim import gnss as sim_gnss
        from ..sim import synthetic as sim

        R0 = quat_to_mat(self.T0_inv[3:7]).numpy()
        V = self.R @ (R0 @ sim.gt_velocity(t, self.sp).numpy())
        return sim_gnss.observe(self.p_ecef(t), V, self.sats, self.sat_vel,
                                np.array([15.0, 0.0, 0.0, 22.0]), 4.0)


def run_gnss_pipeline(n_frames=30, epoch_every=1, cfg=None, dtype=None, device=None):
    """``tests/test_pipeline.py::_run_gnss_pipeline`` on the port (the
    default config with tight GNSS, ``track_num_thresh`` 1, unless ``cfg``
    is given): the :func:`simulator_drive` with an epoch of
    :class:`GnssTruth` every frame until GNSS-VI alignment, then every
    ``epoch_every`` frames. Returns the estimator with ``last_ate`` (ATE
    against the truth) and ``last_ecef_err`` (the newest pose in ECEF
    against the truth; NaN without alignment) set, without asserting them."""
    import dataclasses

    import torch

    from ..config import Config
    from ..gnss.coords import ecef2rotation
    from ..pipeline import Estimator
    from ..sim import synthetic as sim
    from ..utils.evaluate import ate_rmse

    if cfg is None:
        cfg = Config()
        cfg = dataclasses.replace(cfg, gnss=dataclasses.replace(cfg.gnss, enabled=True,
                                                                track_num_thresh=1))
    est = Estimator(cfg, dtype=dtype or torch.float64, device=device)
    truth = GnssTruth(sim.SimParams())
    drive = simulator_drive(n_frames)
    for k, fr in enumerate(drive):
        feed_sensors(est, fr)
        if k % epoch_every == 0 or not est.gnss_aligned:
            est.input_gnss(fr["t"], truth.epoch(fr["t"]))
        feed_frame(est, fr)
    gt = {fr["t"]: fr["gt"] for fr in drive}

    est_xyz = np.stack([p[0:3] for _, p in est.trajectory])
    est.last_ate = float(ate_rmse(est_xyz, np.stack([gt[t][0:3] for t, _ in est.trajectory])))
    est.last_ecef_err = float("nan")
    if est.gnss_aligned:
        yaw = float(est.core.state.yaw_enu)
        anc = np.asarray(est.anchor_ecef())
        cy, sy = np.cos(yaw), np.sin(yaw)
        R_est = ecef2rotation(anc) @ np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1.0]])
        t_last, p_last = est.trajectory[-1]
        est.last_ecef_err = float(np.linalg.norm(anc + R_est @ p_last[0:3]
                                                 - truth.p_ecef(t_last)))
    return est


def run_scenarios(device=None, dtype=None, frames=None) -> dict:
    """Each scenario's ATE (and frames solved; for GNSS the alignment and
    the ECEF error) on ``device`` in ``dtype``; ``frames`` shortens them."""
    from ..utils.evaluate import ate_rmse

    out = {}
    for name, noise in (("vio_wheel_exact", 0.0), ("vio_wheel_noisy", 1.5 / 460.0)):
        est, gt = run_pipeline(n_frames=frames or 35, pix_noise=noise, burst=8, dtype=dtype,
                               device=device)
        est_xyz = np.stack([p[0:3] for _, p in est.trajectory])
        gt_xyz = np.stack([gt[t][0:3] for t, _ in est.trajectory])
        out[name] = {"ate_m": float(ate_rmse(est_xyz, gt_xyz)), "frames": len(est.trajectory),
                     "reboots": int(est.reboots)}
    est = run_gnss_pipeline(n_frames=frames or 24, epoch_every=3, dtype=dtype, device=device)
    out["gnss_tight"] = {"ate_m": est.last_ate, "ecef_err_m": est.last_ecef_err,
                         "aligned": bool(est.gnss_aligned), "frames": len(est.trajectory),
                         "reboots": int(est.reboots)}
    return out


def checks(card: dict, cpu: dict) -> dict:
    """Each scenario's card ATE against its bound, beside the CPU's."""
    out = {}
    for name, bound in BOUNDS.items():
        ok = card[name]["ate_m"] < bound
        if name == "gnss_tight":
            ok = ok and card[name]["aligned"] and card[name]["ecef_err_m"] < ECEF_BOUND_M
        out[name] = {"bound_m": bound, "card_ate_m": card[name]["ate_m"],
                     "cpu_ate_m": cpu[name]["ate_m"], "pass": bool(ok)}
    return out


def write_md(report: dict, path: str) -> None:
    lines = [
        "# Parity of the port: float32 on the card against the float64 oracle on the CPU",
        "",
        f"Card: `{report['card_name']}`, power limit {report['power_limit']}; float32, "
        "burst replay, TF32 off (pinned by the package import). Oracle: the CPU, float64.",
        "",
        "| scenario | bound (suite) | CPU float64 ATE | card float32 ATE | pass |",
        "|---|---|---|---|---|",
    ]
    for name, c in report["checks"].items():
        lines.append(f"| {name} | < {c['bound_m']} m | {c['cpu_ate_m']!r} m | "
                     f"{c['card_ate_m']!r} m | {'yes' if c['pass'] else 'NO'} |")
    g = report["card"]["gnss_tight"]
    lines += ["", f"gnss_tight on the card: aligned {g['aligned']}, newest pose "
              f"{g['ecef_err_m']!r} m off in ECEF (bound {ECEF_BOUND_M} m).", "",
              "Written by `python -m ground_fusion_tpu_torch.scripts.parity both --write-md "
              f"{os.path.basename(path)}`.", ""]
    with open(path, "w") as fp:
        fp.write("\n".join(lines))


def _card_line() -> tuple:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    name, _, limit = out.partition(",")
    return name.strip(), limit.strip()


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("card", "cpu", "both"))
    ap.add_argument("--dtype", default=None, choices=("float32", "float64"))
    ap.add_argument("--frames", type=int, default=None)
    ap.add_argument("--write-md", default=None)
    args = ap.parse_args(argv)

    if args.mode != "both":
        import torch

        from .. import resolve_device

        dev = resolve_device("cpu" if args.mode == "cpu" else None)
        dtype = getattr(torch, args.dtype or ("float64" if args.mode == "cpu" else "float32"))
        res = run_scenarios(dev, dtype, args.frames)
        print(json.dumps({"device": str(dev), "dtype": str(dtype).replace("torch.", ""),
                          "results": res}))
        return 0

    me = [sys.executable, "-m", "ground_fusion_tpu_torch.scripts.parity"]
    extra = ["--frames", str(args.frames)] if args.frames else []
    procs = {m: subprocess.Popen(me + [m] + extra, stdout=subprocess.PIPE, text=True)
             for m in ("cpu", "card")}
    res = {}
    for m, p in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            for q in procs.values():
                if q.poll() is None:
                    q.kill()
            print(f"parity {m} exited with {p.returncode}", file=sys.stderr)
            return 1
        res[m] = json.loads(out.strip().splitlines()[-1])
    name, limit = _card_line()
    report = {"card_name": name, "power_limit": limit, "card": res["card"]["results"],
              "cpu": res["cpu"]["results"],
              "checks": checks(res["card"]["results"], res["cpu"]["results"])}
    report["ok"] = all(c["pass"] for c in report["checks"].values())
    print(json.dumps(report))
    if args.write_md:
        write_md(report, args.write_md)
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
