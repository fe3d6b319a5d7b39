"""Arithmetic over the program's own spans (`utils.profiling.span` of the
port: `mmr.train.step#<n>` and `mmr.serve.request#<n>`, each holding its
layers' spans) in a run's host-recorded sub-window (`run.host_trace`).

A unit is a top span that holds its last layer's span (`mmr.train.optimizer`,
`mmr.serve.model`): the sub-window starts and stops between units or inside
a step's batch wait, so a unit begun before it is not recorded and one cut
by its end (or the pass's last batch wait, which finds the loaders empty)
holds no last span. Readers divide by the number of such units, not by the
benchmark's ticks. A program with no spans (an older checkout) reads None.

Device time under a span, by launch order: the launch calls of the host
trace (kernels, copies, memsets, from any thread: the autograd engine
launches the backward from its own) are taken in the order they began; a
cell's work runs on one stream, so the i-th launch is the i-th device
operation in time order. The trace's first device operations may have been
launched before it started, so the two lists are aligned at their ends
(the profiler synchronizes the card as it stops). A span's device time is
the time of the operations from its first launch's to its last's.
"""

from __future__ import annotations

import bisect

from h100_bench.metrics._shared import traced

STEP, REQUEST = "mmr.train.step", "mmr.serve.request"
_LAST = {STEP: "mmr.train.optimizer", REQUEST: "mmr.serve.model"}
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchCooperativeKernel", "cuLaunchKernel",
            "cudaMemcpy", "cudaMemset", "cuMemcpy", "cuMemset")


def units(tr, top: str) -> list[tuple[float, float]]:
    """(start, end) of each complete unit of `top` in the trace."""
    spans = [h for h in tr.host if h[0].startswith("mmr.")]
    last = [(s, e) for n, s, e in spans if n == _LAST[top]]
    return [(s, e) for n, s, e in spans
            if (n == top or n.startswith(top + "#"))
            and any(s <= a and b <= e for a, b in last)]


def spans_in_units(tr, top: str, names) -> tuple[list, int]:
    """The spans named in `names` that lie in a complete unit of `top`, and
    the number of such units."""
    us = units(tr, top)
    inside = [(n, s, e) for n, s, e in tr.host if n in names
              and any(a <= s and e <= b for a, b in us)]
    return inside, len(us)


def host_ms_per_unit(run, top: str, names):
    """Host time a unit in the spans named in `names` (ms)."""
    tr = traced(run, host=True)
    if tr is None:
        return None
    inside, n = spans_in_units(tr, top, names)
    if not inside or n == 0:
        return None
    return sum(e - s for _, s, e in inside) / n / 1e3


def launch_order(tr) -> tuple[list[float], list]:
    """(start of each launch call, sorted; the device operations matched to
    them in order), or None where the trace holds more launches than
    operations."""
    launches = sorted(s for n, s, _ in tr.host if n.startswith(LAUNCHES))
    ops = sorted(tr.device, key=lambda d: d[1])
    skip = len(ops) - len(launches)
    if skip < 0:
        return None
    return launches, ops[skip:]


def device_us_under(tr, spans, order) -> float:
    """Device time (us) of the operations launched inside the spans."""
    launches, ops = order
    total = 0.0
    for _, s, e in spans:
        i, j = bisect.bisect_left(launches, s), bisect.bisect_right(launches, e)
        total += sum(oe - os for _, os, oe in ops[i:j])
    return total


def device_ms_per_unit(run, top: str, names):
    """Device time a unit of the work launched inside the spans named in
    `names` (ms), by launch order."""
    tr = traced(run, host=True)
    if tr is None:
        return None
    inside, n = spans_in_units(tr, top, names)
    order = launch_order(tr)
    if not inside or n == 0 or order is None:
        return None
    return device_us_under(tr, inside, order) / n / 1e3
