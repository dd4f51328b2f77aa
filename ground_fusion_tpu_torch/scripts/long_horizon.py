"""Long-horizon float32 stability study of the port: the counterpart of
``scripts/long_horizon.py``.

A long burst replay on the test suite's synthetic circle (0.5 px noise,
wheel + IMU + depth, 400 landmarks so the window never starves, bursts of
16), with the conditioning cond(J0ᵀJ0) of the marginalization prior sampled
after a flush every ``--sample-every`` frames (default 200, the JAX
script's), and the ATE, solved frames and reboots at the end; float32 on
the card against float64 on the CPU.

    python -m ground_fusion_tpu_torch.scripts.long_horizon single <float32|float64> [frames]
        [--device cuda|cpu] [--sample-every N]        # one run, one JSON line
    python -m ground_fusion_tpu_torch.scripts.long_horizon both [frames]
        [--sample-every N] [--write-md PATH]          # float32 on the card, float64 on the CPU

``single`` runs on the card unless ``--device cpu`` is given. ``both`` runs
the two side by side as subprocesses (2200 frames by default, as the JAX
script; the card solves a frame in 1.5-3.4 s, so start with a few hundred).
``--write-md PATH`` writes the table (the JAX package's ``PROFILE.md`` is
its own record and is never written).
"""

from __future__ import annotations

import json
import subprocess
import sys

import numpy as np

SAMPLE_EVERY = 200


def prior_cond(est) -> float:
    """cond(J0ᵀJ0) over the prior's non-degenerate directions: singular
    values below 1e-12 of the largest are structural (blocks the prior has
    never touched), as the solver's clipped eigh treats them; float64 SVD on
    the host. 0 before the first prior."""
    j0 = est.core.prior.J0.detach().cpu().numpy().astype(np.float64)
    s = np.linalg.svd(j0, compute_uv=False)
    if s.max() <= 0:
        return 0.0                  # no prior yet
    s = s[s > s.max() * 1e-12]
    return float((s[0] / s[-1]) ** 2)


def run(dtype, n_frames: int, device=None, sample_every: int = SAMPLE_EVERY) -> dict:
    """One replay of ``n_frames`` in ``dtype`` on ``device`` (``None``: the
    GPU)."""
    from ..config import Config
    from ..pipeline import Estimator
    from ..utils.evaluate import ate_rmse
    from .parity import feed_drive, simulator_drive

    est = Estimator(Config(), dtype=dtype, device=device)
    est.enable_burst(16)
    drive = simulator_drive(n_frames, n_landmarks=400, pix_noise=0.5 / 460.0)
    cond_samples = []
    for k in range(n_frames):
        feed_drive(est, drive, [k])
        if (k + 1) % sample_every == 0:
            est.flush_burst()
            cond_samples.append({"frame": k + 1, "cond": prior_cond(est)})
    est.flush_burst()
    gt = {fr["t"]: fr["gt"] for fr in drive}
    est_xyz = np.stack([p[0:3] for _, p in est.trajectory])
    gt_xyz = np.stack([gt[t][0:3] for t, _ in est.trajectory])
    return {
        "dtype": str(dtype).replace("torch.", ""),
        "device": str(est.device),
        "frames": n_frames,
        "solved_keyframes": len(est.trajectory),
        "ate_m": float(ate_rmse(est_xyz, gt_xyz)),
        "reboots": int(est.reboots),
        "cond_end": cond_samples[-1]["cond"] if cond_samples else prior_cond(est),
        "cond_samples": cond_samples,
    }


def write_md(r32: dict, r64: dict, path: str, card: str) -> None:
    lines = [
        "# Long-horizon study of the port: float32 on the card, float64 on the CPU",
        "",
        f"{r32['frames']}-frame burst replay (0.5 px noise, wheel + IMU + depth, bursts of 16), "
        f"cond(J0ᵀJ0) sampled after a flush every {r32.get('sample_every', SAMPLE_EVERY)} "
        f"frames. Card: {card}.",
        "",
        "| dtype | device | solved frames | ATE (aligned) | cond(J0ᵀJ0) at the end | reboots |",
        "|---|---|---|---|---|---|",
    ]
    for r in (r32, r64):
        lines.append(f"| {r['dtype']} | {r['device']} | {r['solved_keyframes']} | "
                     f"{r['ate_m']!r} m | {r['cond_end']:.6e} | {r['reboots']} |")
    lines += ["", "| frame | cond float32 | cond float64 |", "|---|---|---|"]
    for c32, c64 in zip(r32["cond_samples"], r64["cond_samples"]):
        lines.append(f"| {c32['frame']} | {c32['cond']:.6e} | {c64['cond']:.6e} |")
    lines += ["", "Written by `python -m ground_fusion_tpu_torch.scripts.long_horizon both "
              f"{r32['frames']}`.", ""]
    with open(path, "w") as fp:
        fp.write("\n".join(lines))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("single", "both"))
    ap.add_argument("rest", nargs="*")
    ap.add_argument("--device", default=None)
    ap.add_argument("--sample-every", type=int, default=SAMPLE_EVERY)
    ap.add_argument("--write-md", default=None)
    args = ap.parse_args(argv)

    if args.mode == "single":
        import torch

        if not args.rest or args.rest[0] not in ("float32", "float64"):
            ap.error("single needs a dtype: float32 or float64")
        n = int(args.rest[1]) if len(args.rest) > 1 else 2200
        out = run(getattr(torch, args.rest[0]), n, args.device, args.sample_every)
        out["sample_every"] = args.sample_every
        print(json.dumps(out))
        return 0

    n = args.rest[0] if args.rest else "2200"
    me = [sys.executable, "-m", "ground_fusion_tpu_torch.scripts.long_horizon", "single"]
    every = ["--sample-every", str(args.sample_every)]
    procs = [subprocess.Popen(me + ["float32", n] + every, stdout=subprocess.PIPE, text=True),
             subprocess.Popen(me + ["float64", n, "--device", "cpu"] + every,
                              stdout=subprocess.PIPE, text=True)]
    res = []
    for p in procs:
        out, _ = p.communicate()
        if p.returncode != 0:
            for q in procs:
                if q.poll() is None:
                    q.kill()
            print(f"a long-horizon run exited with {p.returncode}", file=sys.stderr)
            return 1
        res.append(json.loads(out.strip().splitlines()[-1]))
    r32, r64 = res
    print(json.dumps({"float32": {k: v for k, v in r32.items() if k != "cond_samples"},
                      "float64": {k: v for k, v in r64.items() if k != "cond_samples"},
                      "cond_samples": {"float32": r32["cond_samples"],
                                       "float64": r64["cond_samples"]}}))
    if args.write_md:
        from .parity import _card_line

        write_md(r32, r64, args.write_md, ", ".join(_card_line()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
