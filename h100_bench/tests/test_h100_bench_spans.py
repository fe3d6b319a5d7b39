"""The readers of the program's spans (metrics/_spans.py and the six
metrics on it) on hand-built traces: complete units, host time a unit,
device time by launch order with launches from a second thread, and
nothing read from a program without spans."""

from __future__ import annotations

import pytest

from h100_bench import core
from h100_bench.metrics import _spans
from h100_bench.trace import Trace

BENCH = core.BENCH
TRAIN_METRICS = ("batch_wait_ms.train", "h2d_host_ms.train", "step_host_ms.train",
                 "backward_device_ms.train")
INFER_METRICS = ("h2d_host_ms.infer", "request_host_ms.infer")

# one step's launches, by host time from the step's start (launcher, kind,
# device us at scale 1); the backward's come from the main thread (the
# memset of a gradient) and the autograd engine's thread in turn
STEP_LAUNCHES = [
    (7, "main", "cudaMemcpyAsync", 3.0),  # h2d
    (12, "main", "cudaLaunchKernel", 5.0), (20, "main", "cudaLaunchKernel", 7.0),  # forward
    (42, "main", "cudaMemsetAsync", 2.0), (45, "autograd", "cudaLaunchKernel", 11.0),
    (48, "main", "cudaLaunchKernel", 13.0), (52, "autograd", "cudaLaunchKernelExC", 17.0),
    (62, "main", "cudaLaunchKernelExC", 19.0), (70, "main", "cuLaunchKernel", 23.0),  # optimizer
    (95, "main", "cudaLaunchKernel", 1.0),  # after the optimizer: the logged alpha
]
STEP_SPANS = [("mmr.train.batch_wait", 1, 5), ("mmr.train.h2d", 6, 10),
              ("mmr.train.forward", 11, 40), ("mmr.train.backward", 41, 60),
              ("mmr.train.optimizer", 61, 90)]


def train_trace() -> Trace:
    """An operation launched before the sub-window began, two complete steps
    (device times at scale 1 and 2), then a step cut in its batch wait by
    the profiler's stop."""
    host, device = [], [("launched before", 0.0, 4.0)]
    t_dev = 10.0
    for k, (t0, scale) in enumerate([(100.0, 1.0), (300.0, 2.0)]):
        host.append((f"mmr.train.step#{8 + k}", t0, t0 + 100))
        host += [(n, t0 + s, t0 + e) for n, s, e in STEP_SPANS]
        host.append(("aten::convolution", t0 + 13, t0 + 19))
        for dt, _thread, name, us in STEP_LAUNCHES:
            host.append((name, t0 + dt, t0 + dt + 0.5))
            device.append((f"op{k}.{dt}", t_dev, t_dev + scale * us))
            t_dev += scale * us + 1.0
    host += [("mmr.train.step#10", 500.0, 900.0), ("mmr.train.batch_wait", 501.0, 900.0)]
    return Trace(device, sorted(host, key=lambda h: h[1]), {}, units=3)


def serve_trace() -> Trace:
    host, device = [], []
    for k, t0 in enumerate([0.0, 100.0, 200.0]):
        host += [(f"mmr.serve.request#{k + 1}", t0, t0 + 50),
                 ("mmr.serve.h2d", t0 + 1, t0 + 1 + 3 * (k + 1)),
                 ("mmr.serve.model", t0 + 20, t0 + 45),
                 ("cudaMemcpyAsync", t0 + 2, t0 + 3), ("cudaLaunchKernel", t0 + 21, t0 + 22)]
        device += [("Memcpy HtoD", t0 + 5, t0 + 9), ("kernel", t0 + 23, t0 + 40)]
    return Trace(device, host, {}, units=3)


def read(name: str, trace: Trace | None):
    reader = core.load_module(BENCH / "metrics" / f"{name}.py", f"m_{name}")
    run = core.Run(kind="train", setup_s=1.0, window_s=1.0, attempted=1, failed=0, images=1,
                   latencies_s=[], memory_peak_bytes=0, numbers={}, flops_per_unit=0.0,
                   kernel_calls=[], trace=trace, host_trace=trace)
    return reader.read(run)


def test_complete_units_hold_their_last_layer():
    assert _spans.units(train_trace(), _spans.STEP) == [(100.0, 200.0), (300.0, 400.0)]
    assert len(_spans.units(serve_trace(), _spans.REQUEST)) == 3


def test_host_time_a_step_in_each_layer():
    tr = train_trace()
    # the cut step's batch wait (399 us) is left out with its step
    assert read("batch_wait_ms.train", tr) == pytest.approx(4e-3)
    assert read("h2d_host_ms.train", tr) == pytest.approx(4e-3)
    assert read("step_host_ms.train", tr) == pytest.approx((29 + 19 + 29) * 1e-3)


def test_backward_device_time_by_launch_order_across_threads():
    # both threads' launches inside the backward span: 2 + 11 + 13 + 17 us at
    # scale 1 and twice that, each matched past the operation launched
    # before the trace
    assert read("backward_device_ms.train", train_trace()) == pytest.approx(1.5 * 43e-3)
    tr = train_trace()
    order = _spans.launch_order(tr)
    assert len(order[0]) == len(order[1]) == 2 * len(STEP_LAUNCHES)
    fwd, n = _spans.spans_in_units(tr, _spans.STEP, {"mmr.train.forward"})
    assert n == 2 and _spans.device_us_under(tr, fwd, order) == pytest.approx(3 * 12.0)


def test_more_launches_than_operations_reads_nothing():
    tr = train_trace()
    tr.device = tr.device[2:]
    assert _spans.launch_order(tr) is None
    assert read("backward_device_ms.train", tr) is None
    assert read("step_host_ms.train", tr) is not None


def test_host_time_a_request():
    tr = serve_trace()
    assert read("h2d_host_ms.infer", tr) == pytest.approx((3 + 6 + 9) / 3 * 1e-3)
    assert read("request_host_ms.infer", tr) == pytest.approx(25e-3)


def test_a_program_without_spans_reads_nothing():
    """The parent's trace (no mmr.* spans), and no trace at all."""
    bare = train_trace()
    bare.host = [h for h in bare.host if not h[0].startswith("mmr.")]
    for name in TRAIN_METRICS + INFER_METRICS:
        assert read(name, bare) is None, name
        assert read(name, None) is None, name


def test_the_six_metrics_are_declared_for_their_cells(spec):
    layers = {m["name"]: m for m in spec["per_layer"]}
    for name in TRAIN_METRICS + INFER_METRICS:
        m = layers[name]
        kind = name.rsplit(".", 1)[1]
        assert m["workloads"] == [f"geodesic_bd.{kind}", f"geodesic_bd_multires.{kind}"]
        assert m["moves"] == ("train_img_s" if kind == "train" else "infer_img_s")
