"""Kernels, copies and memsets on the card a traced request."""

from h100_bench.metrics._shared import launches_per_unit as read  # noqa: F401
