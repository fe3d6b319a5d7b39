"""Host time a traced request in `mmr.serve.h2d`: the label check and the
copies of images and labels to the card."""

from h100_bench.metrics._spans import REQUEST, host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, REQUEST, {"mmr.serve.h2d"})
