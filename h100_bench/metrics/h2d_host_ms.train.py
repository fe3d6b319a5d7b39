"""Host time a traced step in `mmr.train.h2d`: the label check and the
batch's copy to the card."""

from h100_bench.metrics._spans import STEP, host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, STEP, {"mmr.train.h2d"})
