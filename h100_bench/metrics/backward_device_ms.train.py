"""Device time a traced step of the work launched while the host was in
`mmr.train.backward` (the autograd engine's launches included), by launch
order."""

from h100_bench.metrics._spans import STEP, device_ms_per_unit


def read(run):
    return device_ms_per_unit(run, STEP, {"mmr.train.backward"})
