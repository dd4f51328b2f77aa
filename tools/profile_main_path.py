#!/usr/bin/env python3
"""Where a frame's time goes on the GPU: the port's main path under torch.profiler.

    python3 tools/profile_main_path.py [--frames 2] [--skip 12] [--host]

Renders the smoke sequence of ``chip_smoke.py`` (640x480,
``configs/groundchallenge.yaml``), runs its first ``--skip + --frames`` frames
through ``GroundFusionSystem`` on the GPU, and profiles the last ``--frames``
of them (device activity only, which keeps the profiler's own cost small;
``--host`` adds the host-side operators, and minutes of run time). Prints, per
profiled frame: wall time with and without the profiler, CUDA kernels
launched, the sum of their device times and the share of the wall time the
device sat idle; then the kernels that took most device time and those
launched most often. Needs one CUDA device; imports only the port. Writes
nothing outside a temporary directory.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=2)
    ap.add_argument("--skip", type=int, default=12)
    ap.add_argument("--host", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.io.dataset import Sequence, load_image
    from ground_fusion_tpu_torch.system import GroundFusionSystem

    if not torch.cuda.is_available():
        print("profile_main_path: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")

    work = tempfile.mkdtemp(prefix="profile_main_", dir=os.environ.get("TMPDIR"))
    try:
        seq = Sequence.load(chip_smoke.render_smoke_sequence(os.path.join(work, "seq")))
        system = GroundFusionSystem(load_yaml(chip_smoke.CONFIG_PATH), os.path.join(work, "out"))
        ii = wi = 0
        prof = None
        per_frame, unprofiled = [], []
        activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if args.host else [])
        for k, fr in enumerate(seq.frames[: args.skip + args.frames]):
            t = fr[0]
            while ii < len(seq.imu) and seq.imu[ii, 0] <= t:
                r = seq.imu[ii]
                system.input_imu(r[0], r[1:4], r[4:7])
                ii += 1
            while wi < len(seq.wheel) and seq.wheel[wi, 0] <= t:
                r = seq.wheel[wi]
                system.input_wheel(r[0], r[1:4], r[4:7])
                wi += 1
            img, depth = load_image(fr[1]), load_image(fr[2])
            if k == args.skip:
                prof = profile(activities=activities)
                prof.__enter__()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            pose = system.input_image(t, img, depth)
            torch.cuda.synchronize()
            (per_frame if prof is not None else unprofiled).append(
                (time.perf_counter() - t0, pose is not None))
        prof.__exit__(None, None, None)
        n = len(per_frame)
        wall_ms = 1e3 * sum(dt for dt, _ in per_frame) / n
        solved = [dt for dt, ok in unprofiled if ok]
        print(f"frames profiled: {n}; wall {wall_ms:.1f} ms/frame under the profiler, "
              f"{1e3 * sum(solved) / max(len(solved), 1):.1f} ms/frame over the {len(solved)} "
              f"solved frames before it")
        by_name: dict[str, list] = {}
        n_events, dev_us = 0, 0.0
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            n_events += 1
            dev_us += e.device_time
            agg = by_name.setdefault(e.name, [0, 0.0])
            agg[0] += 1
            agg[1] += e.device_time
        print(f"device events per frame: {n_events / n:.0f}; device time "
              f"{dev_us / n / 1e3:.2f} ms/frame; device idle share "
              f"{1.0 - dev_us / n / 1e3 / wall_ms:.4f}")
        if dev_us == 0:
            print("torch.profiler recorded no device time on this machine")
        print("--- by device time: ms/frame, launches/frame, name")
        for name, (cnt, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]:
            print(f"{us / n / 1e3:10.3f} {cnt / n:10.0f}  {name[:100]}")
        print("--- by launches: launches/frame, ms/frame, name")
        for name, (cnt, us) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]:
            print(f"{cnt / n:10.0f} {us / n / 1e3:10.3f}  {name[:100]}")
        if args.host:
            print("--- host operators by self CPU time")
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=25,
                                            max_name_column_width=60))
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
