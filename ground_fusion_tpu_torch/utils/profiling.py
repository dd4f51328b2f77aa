"""Timing & statistics: TicToc stopwatch, rolling stage means, printStatistics.

The reference wraps tracker/solver/marginalization in ``TicToc``
(``utility/tic_toc.h``) and accumulates rolling solver/marg means
(``estimator.h:190-193``; ``printStatistics``). Same surface here. The times
are host wall-clock: a stage's time includes its device work only when the
stage ends in a device→host fetch (or a synchronize), as the tracker's and
the estimator's stages do. :func:`device_trace` records the device's own
times with ``torch.profiler``, where the JAX package records an XProf
trace."""

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


@contextlib.contextmanager
def device_trace(log_dir, host: bool = True):
    """``torch.profiler`` trace of the block, host and (where a GPU is
    present) CUDA activity, written into ``log_dir`` as a Chrome/TensorBoard
    trace (``<host>_<pid>.<ms>.pt.trace.json``; open it in Perfetto,
    ``chrome://tracing`` or TensorBoard's profiler); with ``log_dir=None``
    nothing is written. ``host=False`` records the device's kernels alone
    (on a window step's ~1.5e5 operations the host side makes the trace and
    its ``key_averages()`` minutes long). The profiler's warm-up step
    (tracing on, results discarded) runs first, over a few small kernels, a
    synchronize and 50 ms, so that the block is recorded by a profiler
    already running. Yields the profiler, so the caller can read
    ``key_averages()`` after the block."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU] if host else []
    cuda = torch.cuda.is_available()
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    handler = torch.profiler.tensorboard_trace_handler(log_dir) if log_dir else None
    prof = torch.profiler.profile(activities=acts, on_trace_ready=handler,
                                  schedule=torch.profiler.schedule(wait=0, warmup=1, active=1,
                                                                   repeat=1))
    prof.start()
    try:
        x = torch.zeros(1, device="cuda" if cuda else "cpu")
        for _ in range(8):
            x.add_(1.0)
        if cuda:
            torch.cuda.synchronize()
        time.sleep(0.05)
        prof.step()
        yield prof
    finally:
        prof.step()
        prof.stop()
