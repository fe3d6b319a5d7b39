"""Profiling helpers (port of the JAX package's utils/profiling.py; the
reference has only per-epoch tic/toc prints, learnGeodesicBDModel.py:
242-253): a torch.profiler trace of a few steps, and step timing.
"""

from __future__ import annotations

import contextlib
import os
import time
from pathlib import Path


@contextlib.contextmanager
def profile_trace(logdir: str | Path, enabled: bool = True):
    """Trace the wrapped code with torch.profiler, host and (where CUDA is
    available) device activity, and write a Chrome trace
    `<logdir>/trace_<pid>_<n>.json` (chrome://tracing, Perfetto) when the
    block ends. Yields the profiler (None when not enabled), whose
    `key_averages()` tables the caller may print:

        with profile_trace('runs/x/profile'):
            for _ in range(3): state, m = step(state, batch)
            torch.cuda.synchronize()
    """
    if not enabled:
        yield None
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len(list(logdir.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(logdir / f"trace_{os.getpid()}_{n}.json"))


class StepTimer:
    """Wall-clock throughput over a sliding window of steps."""

    def __init__(self, window: int = 50):
        self.window = window
        self._t: list[float] = []
        self._n: list[int] = []

    def update(self, num_items: int) -> None:
        self._t.append(time.perf_counter())
        self._n.append(num_items)
        if len(self._t) > self.window + 1:
            self._t.pop(0)
            self._n.pop(0)

    @property
    def items_per_sec(self) -> float:
        if len(self._t) < 2:
            return 0.0
        dt = self._t[-1] - self._t[0]
        return sum(self._n[1:]) / max(dt, 1e-9)
