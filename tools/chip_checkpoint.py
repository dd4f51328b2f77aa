#!/usr/bin/env python3
"""Run the checkpoint and sharding phase of ``chip_smoke.py`` alone on one GPU.

    python3 tools/chip_checkpoint.py

Phase 12 reads phase 4's rendered sequence and output, so this runs phases 1
(device), 2 (build), 4 (main path) and 12 (checkpoint: save and resume
through the CLI, relocalization against a loaded graph, two Gloo ranks on
the card) of ``chip_smoke.py``, through the same functions, and prints each
phase's wall time and the card's name and power limit. Imports only the
port. Exits non-zero, as ``chip_smoke.py`` does, when a check fails or no
GPU is present.
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
    work_dir = tempfile.mkdtemp(prefix="chip_checkpoint_", dir=os.environ.get("TMPDIR"))
    try:
        t0 = time.perf_counter()
        chip_smoke.phase_main(torch, work_dir)
        print(f"phase 4 wall {time.perf_counter() - t0:.1f} s (rendering included)", flush=True)
        t0 = time.perf_counter()
        counts = chip_smoke.phase_checkpoint(torch, work_dir)
        print(f"phase 12 wall {time.perf_counter() - t0:.1f} s, launches {counts}", flush=True)
    finally:
        shutil.rmtree(work_dir, ignore_errors=True)
    print(card)
    return 0


if __name__ == "__main__":
    sys.exit(main())
