"""Host time a traced step in the train step's dispatch: `mmr.train.forward`,
`mmr.train.backward` and `mmr.train.optimizer`."""

from h100_bench.metrics._spans import STEP, host_ms_per_unit


def read(run):
    return host_ms_per_unit(run, STEP, {"mmr.train.forward", "mmr.train.backward",
                                        "mmr.train.optimizer"})
