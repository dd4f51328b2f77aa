#!/usr/bin/env python3
"""Which kernels ``torch.profiler`` records on this GPU, against CUDA events.

    python3 tools/profiler_coverage.py [--reps N]

Runs a few calls of ``profile_step``'s small stages (JᵀJ, the Cholesky solve
and ``marginalize_second_new``, on the main path's config in float32, as
phase 14e of ``chip_smoke.py`` runs them) and of three single operations at
JᵀJ's shape (a float32 and a float64 ``J.T @ J``, and an elementwise add).
For each it prints, per call: the device ms between two CUDA events around
the calls (every kernel lies inside it), then the kernels that
``torch.profiler`` records (their number and own ms) four ways: started
right before ``--reps`` calls; started right before one call, right after
the previous profiler stopped (as ``profile_step`` ran each stage before its
warm-up step); after its warm-up step (``utils.profiling.device_trace``)
over one call; and after the warm-up with the host side recorded too; then
the kernels' names. A kernel that the events time but no profiler run lists
is one that the profiler does not see on this machine. Prints the card's
name and power limit. Imports only the port.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

CONFIG_PATH = os.path.join(ROOT, "configs", "groundchallenge.yaml")   # chip_smoke.py's main path


def event_ms(torch, fn, reps: int) -> float:
    """Median device ms of one call between two CUDA events."""
    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b))
    return statistics.median(out)


def recorded(torch, fn, reps: int, warm: bool, host: bool = False) -> tuple:
    """(kernels per call, their own ms per call, their names) that the
    profiler records over ``reps`` calls: started right before them
    (device side only), or ``warm`` through ``utils.profiling.device_trace``
    (after its warm-up step; ``host`` records the host side too)."""
    from torch.autograd import DeviceType

    from ground_fusion_tpu_torch.utils.profiling import device_trace

    torch.cuda.synchronize()
    if warm:
        trace = device_trace(None, host=host)
    else:
        trace = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
    with trace as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(getattr(e, "self_device_time_total", None) or getattr(e, "self_cuda_time_total", 0.0)
               for e in rows)
    return (sum(e.count for e in rows) / reps, busy / reps / 1e3,
            sorted({e.key[:90] for e in rows}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=5)
    args = ap.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("profiler_coverage: no GPU", file=sys.stderr)
        return 1
    from ground_fusion_tpu_torch.config import load_yaml
    from ground_fusion_tpu_torch.scripts import profile_step

    dev = torch.device("cuda")
    stages = dict(profile_step.stages(load_yaml(CONFIG_PATH), dev, torch.float32))
    jtj = stages["JtJ"]               # lambda: normal_equations(J, r)
    J = jtj.__closure__[jtj.__code__.co_freevars.index("J")].cell_contents
    J64 = J.double()
    cases = [(name, stages[name]) for name in ("JtJ", "cholesky solve", "marginalize_second_new")]
    cases += [(f"J.T @ J float32 {tuple(J.shape)}", lambda: J.T @ J),
              ("J.T @ J float64", lambda: J64.T @ J64),
              ("J + J float32", lambda: J + J)]
    for name, fn in cases:
        fn()                                              # first-call set-up
        ms = event_ms(torch, fn, args.reps)
        line = [f"{name}: events {ms:.4f} ms a call"]
        for label, reps, kw in (("cold", args.reps, dict(warm=False)),
                                ("cold, 1 call", 1, dict(warm=False)),
                                ("warm, 1 call", 1, dict(warm=True)),
                                ("warm+host", args.reps, dict(warm=True, host=True))):
            n, busy, names = recorded(torch, fn, reps, **kw)
            line.append(f"{label}: {n:g} kernels, {busy:.4f} ms")
        print("profiler_coverage: " + "; ".join(line), flush=True)
        print(f"profiler_coverage: {name}: kernels {names}", flush=True)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    print(f"profiler_coverage: torch {torch.__version__}, CUDA {torch.version.cuda}; card {card}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
