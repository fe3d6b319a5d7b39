"""Arithmetic the per-layer readers share, over a run's traced sub-window."""

from __future__ import annotations

from h100_bench.peaks import PEAK_BF16_FLOPS


def traced(run, host: bool = False):
    """The run's trace of the card's activity (host=True: the sub-window
    that records the host's operations too), or None where nothing ran on
    the card in it."""
    tr = run.host_trace if host else run.trace
    return tr if tr is not None and tr.device and tr.units > 0 else None


def idle_pct(run):
    """Share of the traced window (first device operation's start to the
    last one's end) in which no kernel, copy or memset ran."""
    tr = traced(run)
    if tr is None:
        return None
    busy, window = tr.busy_window_us()
    return 100.0 * (1.0 - busy / window) if window > 0 else None


def mfu_pct(run):
    """The model's FLOPs of the traced units over the traced window's time,
    as a share of the card's dense bf16 peak."""
    tr = traced(run)
    if tr is None:
        return None
    _, window = tr.busy_window_us()
    if window <= 0:
        return None
    return 100.0 * run.flops_per_unit * tr.units / (window * 1e-6) / PEAK_BF16_FLOPS


def launches_per_unit(run):
    """Kernels, copies and memsets on the card a traced step or request."""
    tr = traced(run)
    return None if tr is None else len(tr.device) / tr.units


def range_ms_per_unit(run, name: str):
    """Device time a traced step or request of the work launched under the
    host range `name`."""
    tr = traced(run, host=True)
    if tr is None or tr.range_device_us.get(name, 0.0) <= 0:
        return None
    return tr.range_device_us[name] / tr.units / 1e3
