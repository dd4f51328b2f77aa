#!/usr/bin/env python3
"""Host time of the CUDA kernels' wrappers, piece by piece, on one GPU.

    python3 tools/wrapper_host_cost.py

A kernel of the port takes a few microseconds on the device, so a call's
time is mostly the wrapper's host work: argument checks, output allocation,
the stream lookup and the ctypes call. This prints, in microseconds per call
(host clock over many calls, the device queue kept busy), each piece of
``hamming_match`` and ``lk_track`` and the ways of doing it, the whole
wrappers, and the control flows they replaced (the five-pass ``match_brief``:
the matrix kernel then four tensor passes; the six ``lk_level`` launches of
a bidirectional 3-level track). Needs one CUDA device; imports only the port.
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def per_call_us(fn, n):
    for _ in range(min(n, 200)):
        fn()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    return (time.perf_counter() - t0) / n * 1e6


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke
    from ground_fusion_tpu_torch.ops.cuda import hamming, klt

    if not torch.cuda.is_available():
        print("wrapper_host_cost: no CUDA device available", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    print(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
    dev = torch.device("cuda", 0)
    cur, ok_cur, old, ok_old = (torch.as_tensor(x).to(dev)
                                for x in chip_smoke._match_inputs(np, 100, 600, 0))
    track_args, _ = chip_smoke._track_inputs(np, torch, dev)
    hamming.hamming_match(cur, ok_cur, old, ok_old)
    klt.lk_track(*track_args)
    torch.cuda.synchronize()

    def five_pass_match_brief():
        return chip_smoke.five_pass_match_brief(torch, hamming, cur, ok_cur, old, ok_old,
                                                chip_smoke.MATCH_THRESH)

    buf = torch.empty(900, dtype=torch.uint8, device=dev)
    pieces = [
        ("stream: torch.cuda.current_stream(dev).cuda_stream",
         lambda: torch.cuda.current_stream(dev).cuda_stream, 20000),
        ("stream: torch._C._cuda_getCurrentRawStream(0)",
         lambda: torch._C._cuda_getCurrentRawStream(0), 20000),
        ("hamming_match: the four argument checks",
         lambda: hamming._check_match(cur, ok_cur, old, ok_old), 20000),
        ("alloc: one int64 [100] + one bool [100]",
         lambda: (torch.empty(100, dtype=torch.int64, device=dev),
                  torch.empty(100, dtype=torch.bool, device=dev)), 20000),
        ("alloc: one uint8 [900] buffer + int64 and bool views",
         lambda: (torch.empty(900, dtype=torch.uint8, device=dev)[:800].view(torch.int64),
                  buf[800:].view(torch.bool)), 20000),
        ("hamming_match: whole wrapper", lambda: hamming.hamming_match(cur, ok_cur, old, ok_old), 5000),
        ("hamming_matrix: whole wrapper", lambda: hamming.hamming_matrix(cur, old), 5000),
        ("five-pass match_brief: matrix kernel + 4 tensor passes", five_pass_match_brief, 3000),
        ("lk_track: whole wrapper (host time; the device runs behind)",
         lambda: klt.lk_track(*track_args), 300),
        ("six-launch track: 6 lk_level launches + tensor operations (host time)",
         lambda: klt.track_bidirectional_chain(klt.lk_level, *track_args), 300),
    ]
    for name, fn, n in pieces:
        us = per_call_us(fn, n)
        torch.cuda.synchronize()
        print(f"{us:10.3f} us  {name}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
