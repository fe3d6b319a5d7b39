"""Training traffic: `Trainer.run_epoch(state, real, render, "main")` fed by
two host loaders, as `cli train` runs it.

Traffic parameters (traffic/<name>.json): `items_per_batch` images of each
class a loader and step (BalancedLoader batches: uint8 images, float32
Euler degrees, int32 labels, as host numpy arrays), `ring` distinct
batches a loader made from the seed in set-up and cycled, `checked_steps`
steps that set-up drives first and the reference follows, more steps for
`warmup_seconds` (the card's clocks and the allocator settle), then the
window: run_epoch with its default logging (one fetch at
steps 1, 50, 100, ...) until the real loader stops at the window's end.
`trace_after` (share of the window) and `trace_units` (steps) place the
traced sub-window of a `--trace 1` run.

The first `checked_steps` steps go through the same call and feed, one
step a call with every step logged, so each step's loss is read; the
first step's gradient comes from Adam's moments after it (|g| from
nu = (1 - b2) g^2 in float32, its sign from mu = (1 - b1) g), kept on the
host through the window, and the parameters' change from the weights
before step 1 and after the last checked step, before any further step
(compare.py says what is compared). `bin_margin` raises one bin of each
bin head (inputs.raise_bins) on both sides.
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


class Loader:
    """Host batches of one stream from a ring, starting at `start`; stops
    after `limit` batches or once `deadline` (perf_counter) has passed,
    and calls `on_batch` before each batch it yields."""

    def __init__(self, ring: list, start: int = 0, limit: int | None = None,
                 deadline: float | None = None, on_batch=None):
        self.ring, self.start, self.limit = ring, start, limit
        self.deadline, self.on_batch = deadline, on_batch
        self.count = 0

    def __iter__(self):
        while self.limit is None or self.count < self.limit:
            if self.deadline is not None and time.perf_counter() >= self.deadline:
                return
            if self.on_batch is not None:
                self.on_batch()
            batch = self.ring[(self.start + self.count) % len(self.ring)]
            self.count += 1
            yield batch


@torch.no_grad()
def adam_grads(trainer) -> dict:
    """Each parameter's gradient at the first step, from Adam's state after
    it, as float32 host tensors."""
    b2 = trainer.optimizer.param_groups[0]["b2"]
    names = {id(p): n for n, p in trainer.model.named_parameters()}
    return {names[id(p)]: (torch.sign(st["mu"].float()) * torch.sqrt(st["nu"] / (1 - b2))).cpu()
            for p, st in trainer.optimizer.state.items() if "nu" in st}


@torch.no_grad()
def param_change(model, W0: dict) -> dict:
    params = dict(model.named_parameters())
    return {n: float(torch.linalg.vector_norm((params[n].double() - W0[n].double())))
            for n in W0 if ref.trained(n)}


def on_device(batch: dict, device) -> dict:
    return {"xdata": torch.as_tensor(batch["xdata"], device=device),
            "euler": torch.as_tensor(batch["euler"], device=device),
            "label": torch.as_tensor(batch["label"], device=device).to(torch.int64)}


def run(ctx) -> Run:
    c, t, dev = ctx.config, ctx.traffic, ctx.device
    trainer, atoms = common.seeded_trainer(ctx, eval_stats=False)
    rings = [inputs.train_ring(ctx.seed, s, t["ring"], t["items_per_batch"], c["num_classes"],
                               c["image_size"], dev) for s in ("real", "render")]
    state = trainer.init_state()
    n_check, prog = t["checked_steps"], {"loss": [], "lc": []}
    for i in range(n_check):
        state = trainer.run_epoch(state, *(Loader(r, i, 1) for r in rings), "main", log_every=1)
        prog["loss"].append(float(trainer.history[-1]["loss"]))
        prog["lc"].append(float(trainer.history[-1]["lc"]))
        if i == 0:
            prog["grad"] = adam_grads(trainer)
    prog["change"] = param_change(trainer.model, common.weights(ctx, eval_stats=False))
    warm = Loader(rings[0], n_check, deadline=time.perf_counter() + t["warmup_seconds"])
    state = trainer.run_epoch(state, warm, Loader(rings[1], n_check), "main")
    common.free(dev)
    common.sync(dev)
    common.reset_peak(dev)

    model = trainer.model
    tracer = Tracer(ctx.trace, t["trace_after"] * ctx.seconds, t["trace_units"],
                    hooks={"trunk_fwd": [model.feature_model],
                           "heads_fwd": [model.bin_models, model.res_models]},
                    ranges=("bench.trunk_fwd", "bench.heads_fwd", "Optimizer.step#Adam.step"))
    start = n_check + warm.count
    t0 = time.perf_counter()
    setup_s = t0 - ctx.t0
    tracer.begin()
    host = common.HostClock()
    real = Loader(rings[0], start, deadline=t0 + ctx.seconds, on_batch=tracer.tick)
    failed = 0
    try:
        state = trainer.run_epoch(state, real, Loader(rings[1], start), "main")
        common.sync(dev)
    except Exception:  # a step that fails counts; the run reports it
        traceback.print_exc(file=sys.stderr)
        failed = 1
    window_s = time.perf_counter() - t0
    host_detail = host.read(window_s)
    tracer.finish()
    peak = common.peak_bytes(dev)
    del trainer, state, model
    common.free(dev)

    batches = [tuple(on_device(r[i], dev) for r in rings) for i in range(n_check)]
    with no_tf32():
        want = ref.train_steps(common.weights(ctx, eval_stats=False), c, batches, atoms,
                               c["init_lr"], FLOAT32)
    numbers, detail = compare.train_readings(prog, want)
    del prog, want
    images_per_step = len(rings) * t["items_per_batch"] * c["num_classes"]
    steps = real.count - failed
    return Run(
        kind="train", setup_s=setup_s, window_s=window_s, attempted=real.count,
        failed=failed, images=steps * images_per_step, latencies_s=[],
        memory_peak_bytes=peak, numbers=numbers, detail=detail | {"host": host_detail},
        flops_per_unit=ctx.family.flops(c, images_per_step, train=True),
        kernel_calls=ctx.family.kernel_calls(c, images_per_step, len(rings), train=True),
        trace=tracer.device, host_trace=tracer.host)
