"""The port's CUDA kernels #1, #2 (and in training #8): the sum of their
calls' bounds over their device time in the traced units (metrics/_kernels.py)."""

from h100_bench.metrics._kernels import roofline_pct as read  # noqa: F401
