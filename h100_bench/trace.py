"""A traced sub-window: torch.profiler over the CPU and the card, reduced to
plain lists that the metric readers take.

`Tracer.tick()` is called once before each unit of work (a train step, a
request). From the first tick at or after `start_after` seconds it traces
`units` units, then stops (the profiler synchronizes the card as it stops,
so every kernel of those units is in the trace). While it traces, forward
pre- and post-hooks on the named modules open and close a
`torch.profiler.record_function` range each, so the device time of a
module's forward can be read from the trace; the hooks are removed with
the profiler.
"""

from __future__ import annotations

import bisect
import dataclasses
import time
from collections import defaultdict

import torch

_SCAN = 5000  # host operations looked back over for a gap's cover


@dataclasses.dataclass
class Trace:
    device: list  # (name, start_us, end_us): kernels, copies and memsets on the card
    host: list  # (name, start_us, end_us): operations and ranges on the host
    range_device_us: dict  # device time of the work launched under each named range
    units: int  # steps or requests traced

    def busy_window_us(self) -> tuple[float, float]:
        """(time in which some device operation ran, first start to last end)."""
        if not self.device:
            return 0.0, 0.0
        busy, cur_s, cur_e = 0.0, None, None
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += cur_e - cur_s
                cur_s, cur_e = s, e
            else:
                cur_e = max(cur_e, e)
        busy += cur_e - cur_s
        first = min(s for _, s, _ in self.device)
        last = max(e for _, _, e in self.device)
        return busy, last - first

    def gaps_us(self) -> list[tuple[float, float]]:
        """Intervals inside the window in which nothing ran on the card."""
        gaps, cur_e = [], None
        for _, s, e in sorted(self.device, key=lambda d: d[1]):
            if cur_e is not None and s > cur_e:
                gaps.append((cur_e, s))
            cur_e = e if cur_e is None else max(cur_e, e)
        return gaps

    def device_ops(self, top: int = 10) -> list:
        """[name, seconds] of the device operations that took most time."""
        total = defaultdict(float)
        for n, s, e in self.device:
            total[n[:160]] += (e - s) * 1e-6
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]

    def idle_gaps(self, top: int = 10) -> list:
        """[name, seconds] of the card's idle time by what the host was doing:
        the host operation that covers each gap's middle and began last
        (the innermost of nested ones; 'python' where none covers it)."""
        host = sorted(self.host, key=lambda h: h[1])
        starts = [h[1] for h in host]
        total = defaultdict(float)
        for g0, g1 in self.gaps_us():
            mid, name = 0.5 * (g0 + g1), "python"
            i = bisect.bisect_right(starts, mid) - 1
            for j in range(i, max(i - _SCAN, -1), -1):
                if host[j][2] >= mid:
                    name = host[j][0]
                    break
            total[name[:160]] += (g1 - g0) * 1e-6
        return [[n, t] for n, t in sorted(total.items(), key=lambda kv: -kv[1])[:top]]


def from_profiler(prof, units: int, ranges: tuple[str, ...]) -> Trace:
    """The device and host events of a finished torch.profiler run, and the
    device time under each of `ranges` (outermost occurrences only)."""
    from torch.autograd import DeviceType

    device, host, under = [], [], defaultdict(float)
    for e in prof.events():
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            host.append((e.name, start, end))
            if e.name in ranges:
                p = e.cpu_parent
                while p is not None and p.name != e.name:
                    p = p.cpu_parent
                if p is None:
                    under[e.name] += e.device_time_total
        elif not e.is_user_annotation:
            device.append((e.name, start, end))
    return Trace(device, host, dict(under), units)


class Tracer:
    """Traces two sub-windows of `units` units each, from the first tick
    after `start_after` seconds of the window (enabled=False: never).

    The first records the card's activity alone, which costs the host
    least: its timeline gives the idle share, the launches and the
    kernels' times (`device`). The second records the host's operations
    too, with the module hooks: it gives the device time under each host
    range and what the host was doing in each idle gap (`host`); the
    host's own recording slows it, so its idle share is not read."""

    def __init__(self, enabled: bool, start_after: float, units: int,
                 hooks: dict[str, list] | None = None, ranges: tuple[str, ...] = ()):
        self.enabled, self.start_after, self.units = enabled, start_after, units
        self.hooks, self.ranges = hooks or {}, ranges
        self.t0 = None
        self.prof = None
        self.left = 0
        self.stopped = []  # (profiler, units traced) of each finished sub-window
        self.device: Trace | None = None
        self.host: Trace | None = None
        self._handles = []

    def begin(self) -> None:
        self.t0 = time.perf_counter()

    def tick(self) -> None:
        if not self.enabled or len(self.stopped) == 2:
            return
        if self.prof is None:
            if time.perf_counter() - self.t0 >= self.start_after:
                self._start(with_host=False)
            return
        self.left -= 1
        if self.left == 0:
            self._stop()
            if len(self.stopped) == 1:
                self._start(with_host=True)

    def _start(self, with_host: bool) -> None:
        from torch.profiler import ProfilerActivity, profile

        cuda = torch.cuda.is_available()
        activities = [ProfilerActivity.CUDA] if cuda else []
        if with_host or not cuda:
            activities.append(ProfilerActivity.CPU)
        if with_host:
            for name, modules in self.hooks.items():
                for m in modules:
                    self._hook(m, f"bench.{name}")
        self.prof = profile(activities=activities)
        self.prof.start()
        self.left = self.units

    def _hook(self, module: torch.nn.Module, name: str) -> None:
        stack = []

        def pre(mod, args):
            rf = torch.profiler.record_function(name)
            rf.__enter__()
            stack.append(rf)

        def post(mod, args, out):
            stack.pop().__exit__(None, None, None)

        self._handles += [module.register_forward_pre_hook(pre),
                          module.register_forward_hook(post)]

    def _stop(self) -> None:
        self.prof.stop()
        for h in self._handles:
            h.remove()
        self._handles = []
        self.stopped.append((self.prof, self.units - self.left))
        self.prof = None

    def finish(self) -> None:
        """After the window: stop a sub-window still in progress (over the
        units traced so far, the one since the last tick included), then
        reduce the sub-windows to `device` and `host`."""
        if self.prof is not None:
            self.left -= 1
            self._stop()
        traces = [from_profiler(p, n, self.ranges) for p, n in self.stopped if n > 0]
        self.stopped = []
        if traces:
            self.device = traces[0]
        if len(traces) > 1:
            self.host = traces[1]
