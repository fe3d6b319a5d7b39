"""Profiling (port of the JAX package's utils/profiling.py; the reference
has only per-epoch tic/toc prints, learnGeodesicBDModel.py:242-253): a
torch.profiler trace of a few steps, and the program's own spans in it.

`span(name)` marks a stretch of the program's host code. Under an active
torch.profiler session (`profile_trace`, or any other) it is a
`record_function` range, on the same clock as the card's kernels and
nested in the span that encloses it; with no session it is one shared
no-op context. The spans the port opens, by layer:

  mmr.train.step#<n>   one iteration of `Trainer.run_epoch`, n the step it
                       runs (the state's step after it)
    mmr.train.batch_wait   the next batch from the loaders (concatenated)
    mmr.train.h2d          the label check and the batch's copy to the device
    mmr.train.forward      preprocess, flips, targets, forward, losses, balance
    mmr.train.backward     zero_grad and loss.backward()
    mmr.train.optimizer    gradient reduces and optimizer.step()
      mmr.optim.adam_fused   Adam's kernel launch (ops/adam; on the card)
    mmr.train.log_fetch    a logged step's fetch of its metrics to the host
  mmr.serve.request#<n>  one call of `make_inference_fn`'s function, n its
                         sequence number from 1
    mmr.serve.h2d          the label check and the copies to the device
    mmr.serve.model        the eval step (preprocess, model, decode)

A unit's number rides in its top span's name, as torch.profiler's own
`ProfilerStep#<n>`: the profiler keeps no string argument of a range.
Where the train step replays CUDA graphs (train/steps.GraphedTrainStep)
`forward` holds the copies into the graphs' inputs and the forward graph's
replay, `backward` the backward graph's, `optimizer` Adam's step around its
own graph's replay (`adam_fused`); the device work then runs under the
replay calls (`cudaGraphLaunch`), not under a launch of its own.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

import torch
from torch.autograd import profiler as autograd_profiler

_NO_SPAN = contextlib.nullcontext()


def span(name: str, unit: int | None = None):
    """A context for one span of the program: a record_function range named
    `name` (`name#unit` where a unit's number is given) while a
    torch.profiler session is active, else the shared no-op context, which
    constructs nothing."""
    if not autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return autograd_profiler.record_function(name if unit is None else f"{name}#{unit}")


@contextlib.contextmanager
def profile_trace(logdir: str | Path, enabled: bool = True):
    """Trace the wrapped code with torch.profiler, host and (where CUDA is
    available) device activity, and write a Chrome trace
    `<logdir>/trace_<pid>_<n>.json` (chrome://tracing, Perfetto) when the
    block ends; the program's spans are in it. Yields the profiler (None
    when not enabled), whose `key_averages()` tables the caller may print:

        with profile_trace('runs/x/profile'):
            for _ in range(3): state, m = step(state, batch)
            torch.cuda.synchronize()
    """
    if not enabled:
        yield None
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    logdir = Path(logdir)
    logdir.mkdir(parents=True, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    n = len(list(logdir.glob(f"trace_{os.getpid()}_*.json")))
    prof.export_chrome_trace(str(logdir / f"trace_{os.getpid()}_{n}.json"))
