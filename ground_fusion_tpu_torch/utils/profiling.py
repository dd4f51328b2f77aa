"""Timing & statistics: TicToc stopwatch, rolling stage means, printStatistics.

The reference wraps tracker/solver/marginalization in ``TicToc``
(``utility/tic_toc.h``) and accumulates rolling solver/marg means
(``estimator.h:190-193``; ``printStatistics``). Same surface here. The times
are host wall-clock: a stage's time includes its device work only when the
stage ends in a device→host fetch (or a synchronize), as the tracker's and
the estimator's stages do."""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict


class TicToc:
    """utility/tic_toc.h equivalent."""

    def __init__(self):
        self.tic()

    def tic(self):
        self._t0 = time.perf_counter()

    def toc(self) -> float:
        """Milliseconds since tic."""
        return (time.perf_counter() - self._t0) * 1e3


class StageStats:
    """Rolling per-stage timing means (sum_t_solver / frame_cnt analog)."""

    def __init__(self):
        self.sums = defaultdict(float)
        self.counts = defaultdict(int)
        self.samples = defaultdict(list)

    @contextlib.contextmanager
    def time(self, name: str):
        t = TicToc()
        try:
            yield
        finally:
            self.add(name, t.toc())

    def add(self, name: str, ms: float):
        self.sums[name] += ms
        self.counts[name] += 1
        self.samples[name].append(ms)

    def mean(self, name: str) -> float:
        return self.sums[name] / max(self.counts[name], 1)

    def median(self, name: str) -> float:
        v = sorted(self.samples[name])
        return v[len(v) // 2] if v else 0.0

    def report(self) -> str:
        lines = [
            f"{k}: mean {self.mean(k):.2f} ms over {self.counts[k]}"
            for k in sorted(self.sums)
        ]
        return "\n".join(lines)
