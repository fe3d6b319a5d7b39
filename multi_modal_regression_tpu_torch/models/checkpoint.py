"""Checkpointed segments of a trunk's forward, the mechanism of the train
step's rematerialization (train/remat gives a trunk its `Segments`).

A segment runs under `torch.utils.checkpoint` (non-reentrant): its input is
kept for the backward and its interior recomputed from it when the
backward reaches it, all but what the segment's selective policy
(`context_fn`) keeps. torch recomputes a segment whole at that point, so
the segments are what bounds the recompute's memory.

`torch.utils.checkpoint` runs a forward again in the backward with the
modules still in training mode, where the JAX package's `jax.checkpoint`
is functional. So a replay runs in the modes the forward saw, with every
BN's momentum at 0 and its `num_batches_tracked` detached (the running
statistics are rewritten with their own values and the counter is not
advanced a second time), and with each dropout's generator (a module's
`dropout_rng`, which the train step binds) set back to where the forward
started and then forward to where it stood.
"""

from __future__ import annotations

from typing import Callable, Iterable, NamedTuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint


class Segments(NamedTuple):
    """How a trunk checkpoints its forward in a train step: `group` 'block'
    (the stem and each residual block a segment) or 'stage' (the stem and
    each stage); `context_fn` the selective-checkpoint policy inside a
    segment (None: keep nothing inside it)."""

    group: str
    context_fn: Callable | None = None


def _replayable(fn: Callable, roots: Iterable[nn.Module]) -> Callable:
    """fn for torch.utils.checkpoint: its first call is the forward; a later
    call (the backward's recompute) runs the modules under `roots` in the
    modes the forward saw, leaves every BN's running statistics and counter
    as they are, and draws the forward's dropout masks."""
    mods = [m for root in roots for m in root.modules()]
    bns = [m for m in mods
           if isinstance(getattr(m, "momentum", None), float) and hasattr(m, "running_mean")]
    gens = [m.dropout_rng for m in mods
            if m.training and getattr(m, "dropout_rng", None) is not None]
    starts = [g.get_state() for g in gens]
    modes: list[bool] = []
    calls = 0

    def run(*args):
        nonlocal calls
        calls += 1
        if calls == 1:
            modes[:] = [m.training for m in mods]
            return fn(*args)
        # the backward runs outside the step's module modes: replay in the
        # forward's
        saved_modes = [m.training for m in mods]
        for m, t in zip(mods, modes):
            m.training = t
        saved = [(m.momentum, getattr(m, "num_batches_tracked", None)) for m in bns]
        now = [g.get_state() for g in gens]
        for m, (_, count) in zip(bns, saved):
            m.momentum = 0.0
            if count is not None:
                m.num_batches_tracked = None
        for g, s in zip(gens, starts):
            g.set_state(s)
        try:
            return fn(*args)
        finally:
            for m, (momentum, count) in zip(bns, saved):
                m.momentum = momentum
                if count is not None:
                    m.num_batches_tracked = count
            for g, s in zip(gens, now):
                g.set_state(s)
            for m, t in zip(mods, saved_modes):
                m.training = t

    return run


def segment(fn: Callable[[torch.Tensor], torch.Tensor], x: torch.Tensor,
            modules: Iterable[nn.Module], context_fn: Callable | None = None) -> torch.Tensor:
    """fn(x) as a checkpointed segment over `modules` (the ones fn runs):
    its input is kept, its interior recomputed in the backward, but for what
    `context_fn` (a selective-checkpoint policy) keeps."""
    kw = {} if context_fn is None else {"context_fn": context_fn}
    return checkpoint(_replayable(fn, modules), x, use_reentrant=False, **kw)


def chain(modules: list[nn.Module]) -> Callable[[torch.Tensor], torch.Tensor]:
    """x -> the modules applied in turn."""
    def run(x: torch.Tensor) -> torch.Tensor:
        for m in modules:
            x = m(x)
        return x
    return run
