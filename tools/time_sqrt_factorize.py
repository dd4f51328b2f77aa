#!/usr/bin/env python3
"""Time the marginal prior's square root on one GPU, at the size the main
path gives it.

    python3 tools/time_sqrt_factorize.py [--root DIR] [--reps N] [--device cuda|cpu]

``estimator/marginalization.py::_sqrt_factorize`` runs once in every
marginalization of the window step (old or second-new), on the kept block of
the Schur complement: ``nx - 15`` columns of the default config's layout.
This times it on a positive definite block (the Cholesky branch, the one the
main path takes) and on an indefinite one (the eigendecomposition branch),
in float32 (the CLI's dtype) and float64: the median over ``--reps`` calls,
each synchronized on both ends, on the host clock, which is what a step
waits. ``--root`` imports the port from another checkout's root (a parent
commit's copy), so that two versions are compared in one call by running
the script for each in turns. Prints the card's name and power limit.
Imports only the port.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=ROOT, help="checkout whose port is timed")
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))

    import numpy as np
    import torch

    from ground_fusion_tpu_torch.config import Config
    from ground_fusion_tpu_torch.estimator.marginalization import _sqrt_factorize
    from ground_fusion_tpu_torch.estimator.step import make_window_step

    if args.device == "cuda":
        if not torch.cuda.is_available():
            print("time_sqrt_factorize: no CUDA device available", file=sys.stderr)
            return 2
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
        print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
    dev = torch.device(args.device)
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    _, layout = make_window_step(Config(), dev)
    n = layout.nx - 15
    rng = np.random.default_rng(0)
    a = rng.normal(size=(2 * n, n))
    spd = a.T @ a + np.eye(n)
    indefinite = spd - 1.5 * np.linalg.eigvalsh(spd)[n // 2] * np.eye(n)
    b = rng.normal(size=n)
    print(f"root {os.path.abspath(args.root)}: kept block n = {n} (nx = {layout.nx})")
    for dtype in (torch.float32, torch.float64):
        for name, h in (("positive definite", spd), ("indefinite", indefinite)):
            H = torch.as_tensor(h, dtype=dtype, device=dev)
            bt = torch.as_tensor(b, dtype=dtype, device=dev)
            for _ in range(5):
                _sqrt_factorize(H, bt)
            times = []
            for _ in range(args.reps):
                sync()
                t0 = time.perf_counter()
                J0, r0 = _sqrt_factorize(H, bt)
                sync()
                times.append(1e3 * (time.perf_counter() - t0))
            err = float((J0.mT @ J0 - H).abs().max() / H.abs().max()) if name[0] == "p" else None
            print(f"{str(dtype)[6:]} {name}: median {np.median(times):.4f} ms, "
                  f"p10 {np.percentile(times, 10):.4f}, p90 {np.percentile(times, 90):.4f} "
                  f"over {args.reps} calls" + (f"; |J0'J0 - H| / |H| = {err:.2e}" if err else ""),
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
