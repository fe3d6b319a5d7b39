"""Bytes and operations of the port's CUDA kernels #1 (normalize), #2 (stem
forward) and #8 (stem backward) from a call's dims, as PERF.md's kernel
table counts them (chip_smoke's bound() arguments, frozen here), and their
roofline share over a traced sub-window.

    #1  x (B, H, W, 3) uint8 -> out of itemsize: bytes (1 + itemsize) n,
        operations 2 n (n = B H W 3)
    #2  y (B, C, H, W) -> out (B, C, H/2, W/2): bytes itemsize (y + out),
        operations 36 out
    #8  g (out's shape), y -> dy: bytes itemsize (g + 2 y), operations 14 y

Each call's bound is max(bytes / 3.35 TB/s, operations / 67 TFLOP/s).
"""

from __future__ import annotations

from h100_bench.metrics._shared import traced
from h100_bench.peaks import PEAK_F32_FLOPS, bound_s

# kernel -> the device function names that make up its calls
NAMES = {"normalize": ("normalize_u8_kernel",),
         "stem_fwd": ("stem_fwd_kernel",),
         "stem_bwd": ("stem_bwd_kernel", "stem_dab_kernel")}


def work(kernel: str, d: dict) -> tuple[float, float]:
    """(bytes, operations) of one call."""
    i = d["itemsize"]
    if kernel == "normalize":
        n = d["B"] * d["H"] * d["W"] * 3
        return (1 + i) * n, 2 * n
    y = d["B"] * d["C"] * d["H"] * d["W"]
    out = d["B"] * d["C"] * (d["H"] // 2) * (d["W"] // 2)
    if kernel == "stem_fwd":
        return i * (y + out), 36 * out
    if kernel == "stem_bwd":
        return i * (out + 2 * y), 14 * y
    raise ValueError(f"no count for kernel {kernel!r}")


def roofline_pct(run):
    """Sum of the calls' bounds over the sum of the device time of those
    kernels in the traced units; None where none of them ran."""
    tr = traced(run)
    if tr is None:
        return None
    kernels = {k for k, _ in run.kernel_calls}
    names = tuple(n for k in kernels for n in NAMES[k])
    time_s = sum(e - s for n, s, e in tr.device if any(p in n for p in names)) * 1e-6
    if time_s <= 0:
        return None
    bound = sum(bound_s(*work(k, d), PEAK_F32_FLOPS) for k, d in run.kernel_calls)
    return 100.0 * bound * tr.units / time_s
