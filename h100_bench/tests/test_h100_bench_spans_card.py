"""The program's spans read on the card (marked `cuda`; skips where there is
none):

    python -m pytest h100_bench/tests/test_h100_bench_spans_card.py -q

A traced run of `geodesic_bd.train`: the device time read under the train
step's forward, backward and optimizer spans by launch order covers the
traced step's device busy time less its copies to the card, within 10%,
and the four train metrics read something.
"""

from __future__ import annotations

import importlib
import time

import pytest

from h100_bench import core
from h100_bench.metrics import _spans

pytestmark = pytest.mark.cuda

SEED = 2**31 + 211
LAYERS = {"mmr.train.forward", "mmr.train.backward", "mmr.train.optimizer"}


def test_launch_order_split_covers_the_step(spec, cuda):
    _, config, traffic, _ = core.cell_files(spec, "geodesic_bd.train")
    ctx = core.Context(config, traffic,
                       importlib.import_module(f"h100_bench.configs.{config['family']}"),
                       SEED, 10.0, True, cuda, time.perf_counter())
    run = importlib.import_module(f"h100_bench.drivers.{traffic['driver']}").run(ctx)
    host, card = run.host_trace, run.trace
    spans, n = _spans.spans_in_units(host, _spans.STEP, LAYERS)
    order = _spans.launch_order(host)
    assert n >= 3 and order is not None
    # the operations launched before the host sub-window began: a step's tail at most
    assert 0 <= len(host.device) - len(order[0]) < 1000
    split_us = _spans.device_us_under(host, spans, order) / n
    busy_us = card.busy_window_us()[0] / card.units
    h2d_us = sum(e - s for name, s, e in card.device if "HtoD" in name) / card.units
    assert split_us == pytest.approx(busy_us - h2d_us, rel=0.1), (split_us, busy_us, h2d_us)
    metrics = core.read_metrics(core.cell_metrics(spec, "geodesic_bd.train", True), run)
    for name in ("batch_wait_ms.train", "h2d_host_ms.train", "step_host_ms.train",
                 "backward_device_ms.train"):
        assert metrics[name]["value"] > 0, name
