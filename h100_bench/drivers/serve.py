"""Serving traffic: one caller in a closed loop calls the function that
`serving.make_inference_fn` returns for the model of a `Trainer` (as `cli
predict` and `Trainer.predict` serve it); a request ends with `.cpu()` of
its poses.

Traffic parameters (traffic/<name>.json): `request_sizes`, the numbers of
crops of the requests, cycled; `ring` distinct host requests made from the
seed in set-up (uint8 images, int64 labels spread over the classes) and
cycled; requests served in set-up for `warmup_seconds` (the card's clocks
and the host's caches settle); `check_requests` of the
completed requests, drawn from the seed after the window, whose poses are
compared with the reference's; `trace_after` and `trace_units` place the
traced sub-window of a `--trace 1` run.
"""

from __future__ import annotations

import sys
import time
import traceback

import torch

from h100_bench import compare, inputs
from h100_bench.core import Run
from h100_bench.drivers import common
from h100_bench.reference import bin_delta as ref
from h100_bench.reference.precision import FLOAT32, no_tf32
from h100_bench.trace import Tracer

MAX_FAILED = 3  # failed requests after which the loop stops


def run(ctx) -> Run:
    from multi_modal_regression_tpu_torch.serving import make_inference_fn

    c, t, dev = ctx.config, ctx.traffic, ctx.device
    trainer, atoms = common.seeded_trainer(ctx, eval_stats=True)
    model = trainer.model
    infer = make_inference_fn(model, trainer.problem)
    sizes = t["request_sizes"]
    ring = inputs.request_ring(ctx.seed, t["ring"], lambda i: sizes[i % len(sizes)],
                               c["num_classes"], c["image_size"], dev)
    warm_end, i = time.perf_counter() + t["warmup_seconds"], 0
    while time.perf_counter() < warm_end:
        infer(*ring[i % len(ring)]).cpu()
        i += 1
    common.free(dev)
    common.sync(dev)
    common.reset_peak(dev)

    tracer = Tracer(ctx.trace, t["trace_after"] * ctx.seconds, t["trace_units"],
                    hooks={"trunk_fwd": [model.feature_model],
                           "heads_fwd": [model.bin_models, model.res_models]},
                    ranges=("bench.trunk_fwd", "bench.heads_fwd"))
    answers, latencies, failed, i = [], [], 0, 0
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t0
    tracer.begin()
    while time.perf_counter() - t0 < ctx.seconds and failed < MAX_FAILED:
        tracer.tick()
        images, labels = ring[i % len(ring)]
        start = time.perf_counter()
        try:
            poses = infer(images, labels).cpu()
        except Exception:  # a failed request counts; the loop goes on
            traceback.print_exc(file=sys.stderr)
            failed += 1
        else:
            latencies.append(time.perf_counter() - start)
            answers.append((i % len(ring), poses))
        i += 1
    window_s = time.perf_counter() - t0
    tracer.finish()
    peak = common.peak_bytes(dev)
    del trainer, model, infer
    common.free(dev)

    rows = []
    W = common.weights(ctx, eval_stats=True)
    with no_tf32():
        for j in inputs.sample(ctx.seed, len(answers), t["check_requests"]):
            k, poses = answers[j]
            images, labels = (torch.as_tensor(a, device=dev) for a in ring[k])
            scores, cands = ref.eval_candidates(W, c, images, labels, atoms, FLOAT32)
            rows.append((poses, scores, cands))
    numbers = (compare.serve_numbers(rows) if rows
               else {"score_gap": float("inf"), "pose_gap": float("inf")})
    mean_size = sum(sizes) / len(sizes)
    lat = sorted(latencies)
    detail = {"latency_ms": {q: 1e3 * lat[min(len(lat) - 1, int(q * len(lat)))]
                             for q in (0.0, 0.5, 0.9, 0.99)} if lat else {}}
    return Run(
        kind="serve", setup_s=setup_s, window_s=window_s, attempted=i, failed=failed,
        images=sum(len(ring[k][1]) for k, _ in answers), latencies_s=latencies,
        memory_peak_bytes=peak, numbers=numbers, detail=detail,
        flops_per_unit=ctx.family.flops(c, mean_size, train=False),
        kernel_calls=ctx.family.kernel_calls(c, int(mean_size), 1, train=False),
        trace=tracer.device, host_trace=tracer.host)
