#!/usr/bin/env python3
"""Run the dynamic-objects and cameras phase of ``chip_smoke.py`` alone on one GPU.

    python3 tools/chip_dynamic.py

Runs phases 1 (device), 2 (build), 4 (main path, for the wall time that
phase 13 is held to) and 13 (the detector on the card against the CPU, the
``use_yolo`` drive through the CLI, the five camera models, the five
calibrations and the equidistant drive) of ``chip_smoke.py``, through the
same functions, and prints each phase's wall time and the card's name and
power limit. Imports only the port. Exits non-zero, as ``chip_smoke.py``
does, when a check fails or no GPU is present.
"""

from __future__ import annotations

import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402


def main() -> int:
    torch, card = chip_smoke.phase_device()
    chip_smoke.phase_build()
    work_dir = tempfile.mkdtemp(prefix="chip_dynamic_", dir=os.environ.get("TMPDIR"))
    try:
        t0 = time.perf_counter()
        _, main_times = chip_smoke.phase_main(torch, work_dir)
        print(f"phase 4 wall {time.perf_counter() - t0:.1f} s (rendering included)", flush=True)
        t0 = time.perf_counter()
        counts = chip_smoke.phase_dynamic_cameras(torch, work_dir, main_times)
        print(f"phase 13 wall {time.perf_counter() - t0:.1f} s, launches {counts}", flush=True)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
