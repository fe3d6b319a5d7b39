"""The port's spans (utils/profiling.span) on the CPU: their names, numbers
and nesting under profile_trace in `Trainer.run_epoch`, the train step and
the serving function; the shared no-op with no profiler active.

The model is test_torch_port_trainer's (geodesic_bd at ResNet18 to layer2,
N0 128, N1 16, N2 8, K 8, 3 classes, 32 px, streams of 2 items x 3
classes, float32).
"""

from __future__ import annotations

import json
import time
import types

import pytest
import torch
from torch.autograd import profiler as autograd_profiler

from multi_modal_regression_tpu_torch.serving import make_inference_fn
from multi_modal_regression_tpu_torch.utils import profiling
from multi_modal_regression_tpu_torch.utils.profiling import profile_trace, span

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_trainer import _loader, _trainer

STEP_LAYERS = ["mmr.train.batch_wait", "mmr.train.h2d", "mmr.train.forward",
               "mmr.train.backward", "mmr.train.optimizer"]


def _spans(prof) -> list[tuple[str, float, float]]:
    """(name, start, end) of the program's spans in a finished profiler run,
    by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.name.startswith("mmr.")), key=lambda s: s[1])


def _inside(spans, top) -> list[str]:
    """Names of the spans inside `top`'s interval, in order."""
    _, s0, e0 = top
    return [n for n, s, e in spans if s0 <= s and e <= e0 and (n, s, e) != top]


def _two_steps(tmp_path):
    """Two run_epoch steps of three batches a loader (max_iterations 2) under
    profile_trace, step 1 logged."""
    trainer = _trainer(max_iterations=2)
    state = trainer.init_state()
    with profile_trace(tmp_path) as prof:
        state = trainer.run_epoch(state, _loader(1, 3), _loader(2, 3), "main")
    return trainer, state, prof


def test_run_epoch_steps_nest_their_layers_in_order(tmp_path):
    _, state, prof = _two_steps(tmp_path)
    spans = _spans(prof)
    steps = [s for s in spans if s[0].startswith("mmr.train.step")]
    assert [s[0] for s in steps] == ["mmr.train.step#1", "mmr.train.step#2"]
    assert state.step == 2
    assert _inside(spans, steps[0]) == STEP_LAYERS + ["mmr.train.log_fetch"]
    assert _inside(spans, steps[1]) == STEP_LAYERS


def test_serving_requests_nest_h2d_then_model(tmp_path):
    trainer = _trainer()
    infer = make_inference_fn(trainer.model, trainer.problem)
    batch = _loader(3)[0]
    with profile_trace(tmp_path) as prof:
        for _ in range(2):
            infer(batch["xdata"], batch["label"])
    spans = _spans(prof)
    requests = [s for s in spans if s[0].startswith("mmr.serve.request")]
    assert [s[0] for s in requests] == ["mmr.serve.request#1", "mmr.serve.request#2"]
    for r in requests:
        assert _inside(spans, r) == ["mmr.serve.h2d", "mmr.serve.model"]


def test_chrome_trace_puts_the_forward_ops_inside_the_forward_span(tmp_path):
    """In the exported trace, every aten op of the main thread between a
    step's H2D span and its backward span lies inside its forward span, the
    convolutions among them."""
    _two_steps(tmp_path)
    (path,) = tmp_path.glob("trace_*.json")
    events = [e for e in json.loads(path.read_text())["traceEvents"] if e.get("ph") == "X"]
    by_name = {}
    for e in events:
        by_name.setdefault(e["name"], []).append(e)
    main = by_name["mmr.train.forward"][0]["tid"]
    ops = [e for e in events if e["name"].startswith("aten::") and e["tid"] == main]
    for h2d, fwd, bwd in zip(by_name["mmr.train.h2d"], by_name["mmr.train.forward"],
                             by_name["mmr.train.backward"]):
        between = [e for e in ops if h2d["ts"] + h2d["dur"] <= e["ts"] < bwd["ts"]]
        assert any(e["name"] == "aten::convolution" for e in between)
        for e in between:
            assert fwd["ts"] <= e["ts"] and e["ts"] + e["dur"] <= fwd["ts"] + fwd["dur"], e


def test_spans_construct_nothing_without_a_profiler(monkeypatch):
    """With no profiler active a step and a request reach no
    record_function through span, and span is the one shared no-op; under a
    profiler it is a range."""
    class Refusing:  # the profiler module as span sees it, record_function refused
        @property
        def _is_profiler_enabled(self):
            return autograd_profiler._is_profiler_enabled

        def record_function(self, *args, **kwargs):
            raise AssertionError("record_function constructed with no profiler active")

    trainer = _trainer(max_iterations=1)
    with monkeypatch.context() as m:
        m.setattr(profiling, "autograd_profiler", Refusing())
        trainer.run_epoch(trainer.init_state(), _loader(1), _loader(2), "main")
        infer = make_inference_fn(trainer.model, trainer.problem)
        infer(_loader(3)[0]["xdata"], _loader(3)[0]["label"])
        assert span("a") is span("b", 3) is profiling._NO_SPAN
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert isinstance(span("a", 3), autograd_profiler.record_function)
        assert span("a", 3).name == "a#3" and span("a").name == "a"


def test_a_step_is_bit_identical_with_and_without_a_profiler(tmp_path):
    """The same step from the same state gives the same loss and weights,
    bit for bit, with and without an active profiler."""
    results = []
    for traced in (False, True):
        torch.manual_seed(0)
        trainer = _trainer(max_iterations=1)
        with profile_trace(tmp_path / str(traced), enabled=traced):
            trainer.run_epoch(trainer.init_state(), _loader(1), _loader(2), "main",
                              log_every=1)
        results.append((trainer.history[-1]["loss"],
                        {k: v.clone() for k, v in trainer.model.state_dict().items()}))
    (loss_a, w_a), (loss_b, w_b) = results
    assert loss_a == loss_b
    assert w_a.keys() == w_b.keys()
    for k in w_a:
        assert torch.equal(w_a[k], w_b[k]), k


@pytest.mark.parametrize("log_every", [1, 2])
def test_images_per_sec_counts_the_steps_since_the_last_fetch(monkeypatch, log_every):
    """images_per_sec is the images of the steps since the previous logged
    fetch (or the pass's start) over the perf_counter time between them."""
    from multi_modal_regression_tpu_torch.train import trainer as trainer_module

    ticks = iter(range(0, 1000, 2))  # each perf_counter reading 2 s after the last
    monkeypatch.setattr(trainer_module, "time", types.SimpleNamespace(
        perf_counter=lambda: float(next(ticks)), time=time.time))
    trainer = _trainer(max_iterations=4)
    trainer.run_epoch(trainer.init_state(), _loader(1, 4), _loader(2, 4), "main",
                      log_every=log_every)
    logged = [(r["step"], r["images_per_sec"]) for r in trainer.history]
    # 12 images a step; one reading at the start and one at each logged fetch
    if log_every == 1:
        assert logged == [(1, 6.0), (2, 6.0), (3, 6.0), (4, 6.0)]
    else:
        assert logged == [(1, 6.0), (2, 6.0), (4, 12.0)]
