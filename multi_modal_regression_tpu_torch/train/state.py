"""Train state carried across steps (port of the JAX package's train/state.py).

The JAX state is one donated pytree: step, params, batch_stats, optimizer
state, the self-balance scalar `s` and a flip rng. In PyTorch the
parameters and running statistics live in the model and the moments in the
optimizer, both updated in place, so the state holds those two objects,
the step count (a host int: the host knows how many steps it ran) and `s`,
a 0-d float32 tensor on the device. The flip rng waits with `train_flip`
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses

import torch
from torch import nn


@dataclasses.dataclass
class TrainState:
    step: int
    model: nn.Module
    optimizer: torch.optim.Optimizer
    s: torch.Tensor  # self-balancing log-scale (losses.self_balance)

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)
