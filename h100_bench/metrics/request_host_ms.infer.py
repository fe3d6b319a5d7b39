"""Host time a traced request in `mmr.serve.model`: the eval step's
dispatch (preprocess, model, decode)."""

from h100_bench.metrics._spans import REQUEST, host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, REQUEST, {"mmr.serve.model"})
