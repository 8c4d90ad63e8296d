"""Profiling / tracing utilities.

The reference has no tracing subsystem: its benchmarks are ad-hoc
``bench::mark``/``system.time`` calls in workspace notebooks
(workspace/yulinWspc.Rmd:791-821).  Here:

* :func:`trace`: context manager capturing a ``torch.profiler`` trace of
  the host and, where a card is present, of the card, written as a Chrome
  trace (viewable in Perfetto or ``chrome://tracing``);
* :class:`Timings`: lightweight named wall-clock section registry used
  by the benchmark scripts (pairs/sec, cell-updates/sec summaries).
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict

import torch


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


class Timings:
    """Named wall-clock sections with simple throughput accounting."""

    def __init__(self):
        self.sections: dict[str, list[float]] = defaultdict(list)
        self.items: dict[str, float] = defaultdict(float)

    @contextlib.contextmanager
    def section(self, name: str, items: float = 0.0):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.sections[name].append(time.perf_counter() - t0)
            self.items[name] += items

    def total(self, name: str) -> float:
        return sum(self.sections[name])

    def rate(self, name: str) -> float:
        """items per second for a section (0 when untimed)."""
        t = self.total(name)
        return self.items[name] / t if t > 0 else 0.0

    def report(self) -> str:
        lines = []
        for name in self.sections:
            t = self.total(name)
            n = len(self.sections[name])
            line = f"{name}: {t:.3f}s over {n} call(s)"
            if self.items[name]:
                line += f", {self.rate(name):,.1f} items/s"
            lines.append(line)
        return "\n".join(lines)
