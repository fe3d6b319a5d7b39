"""Device time of the trunk's forward (`feature_model`, between forward
hooks) a traced step or request."""

from h100_bench.metrics._shared import range_ms_per_unit


def read(run):
    return range_ms_per_unit(run, "bench.trunk_fwd")
