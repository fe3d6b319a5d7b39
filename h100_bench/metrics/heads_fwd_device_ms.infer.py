"""Device time of the head banks' forwards (`bin_models` and `res_models`,
between forward hooks) a traced step or request."""

from h100_bench.metrics._shared import range_ms_per_unit


def read(run):
    return range_ms_per_unit(run, "bench.heads_fwd")
