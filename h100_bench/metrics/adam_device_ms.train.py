"""Device time a traced step of the work under the profiler's
`Optimizer.step#Adam.step` range."""

from h100_bench.metrics._shared import range_ms_per_unit


def read(run):
    return range_ms_per_unit(run, "Optimizer.step#Adam.step")
