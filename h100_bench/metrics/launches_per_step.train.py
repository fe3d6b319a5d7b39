"""Kernels, copies and memsets on the card a traced training step."""

from h100_bench.metrics._shared import launches_per_unit as read  # noqa: F401
