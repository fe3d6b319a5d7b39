"""Host time a traced step in `mmr.train.batch_wait`: run_epoch's wait for
the next concatenated batch from the loaders."""

from h100_bench.metrics._spans import STEP, host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, STEP, {"mmr.train.batch_wait"})
