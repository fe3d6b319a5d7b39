"""Train state carried across steps (port of the JAX package's train/state.py).

The JAX state is one donated pytree: step, params, batch_stats, optimizer
state, the self-balance scalar `s` and a flip rng. In PyTorch the
parameters and running statistics live in the model and the moments in the
optimizer, both updated in place, so the state holds those two objects,
the step count (a host int: the host knows how many steps it ran), `s`,
a 0-d float32 tensor on the device, and `rng`, the torch.Generator on the
device that is the train step's one source of randomness: its random
flips (`train_flip`) and a VGG fc7's dropout draw from it (the JAX state's
PRNG key). Draws advance it in place.
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
    rng: torch.Generator | None = None  # flips (train_flip) and dropout

    def replace(self, **kw) -> "TrainState":
        return dataclasses.replace(self, **kw)
