"""Train the dynamic-object detector on synthetic scenes and write its
weights in the JAX package's npz key scheme (``detector/model.py::save_npz``),
so either package loads the file:

    python -m ground_fusion_tpu_torch.scripts.train_detector [steps] [out.npz]
        [--device cuda|cpu] [--seed S] [--batch B]

Defaults: 400 steps, batch 16, seed 0, on the GPU, written to
``detector.npz`` in the working directory (the shipped
``ground_fusion_tpu_torch/detector/weights.npz`` is the JAX package's file,
copied byte for byte, and is not overwritten). A run directory's
``detector.npz`` takes the place of the shipped weights when ``use_yolo``
runs there."""

from __future__ import annotations

import sys
import time


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=400)
    ap.add_argument("out", nargs="?", default="detector.npz")
    ap.add_argument("--device", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--batch", type=int, default=16)
    args = ap.parse_args(argv)

    from ground_fusion_tpu_torch.detector.model import save_npz
    from ground_fusion_tpu_torch.detector.train import train

    t0 = time.perf_counter()
    params = train(steps=args.steps, batch=args.batch, seed=args.seed, device=args.device)
    save_npz(args.out, params)
    print(f"weights written to {args.out} ({time.perf_counter() - t0:.1f} s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
