"""Self-balancing loss weight carried as a device scalar.

Port of the JAX package's losses/self_balance.py. The reference recomputes
the balance `s` on the host every step from the previous step's regression
loss (`s = log(Lr.item())`, learnGeodesicBDModel.py:180-185). Here `s` is a
0-d float32 tensor on the device: the loss uses the previous step's `s` (the
same one-step lag) and the next `s` comes from the detached Lr, so the step
never waits for the host.

  warm-up:  loss = Lc + 0.5*exp(-2 s)*Lr + s,   s' = 0.5*log(Lr)
  main:     loss = Lc + exp(-s)*Lr + s,         s' = log(Lr)
  sigma:    loss = Lc + 0.5*exp(-2 s)*Lr + 3 s, s' = 0.5*log(Lr/3)
            (the _rene scripts' homoscedastic form, carried as s = log sigma)
"""

from __future__ import annotations

import torch


def init_log_balance(device: torch.device | str | None = None) -> torch.Tensor:
    """Initial s = 0 (the reference starts both phases at s = 0)."""
    return torch.zeros((), dtype=torch.float32, device=device)


def self_balanced(
    lc: torch.Tensor, lr: torch.Tensor, s: torch.Tensor, mode: str = "main"
) -> tuple[torch.Tensor, torch.Tensor]:
    """Combine (Lc, Lr) with the lagged balance scalar; return (loss, s_next).

    `s` enters the loss as a constant (the reference computes the weight
    from a host float) and `s_next` comes from the detached Lr.
    """
    s = s.detach()
    lr_detached = lr.detach()
    if mode == "warmup":
        loss = lc + 0.5 * torch.exp(-2.0 * s) * lr + s
        s_next = 0.5 * torch.log(torch.clamp(lr_detached, min=1e-30))
    elif mode == "main":
        loss = lc + torch.exp(-s) * lr + s
        s_next = torch.log(torch.clamp(lr_detached, min=1e-30))
    elif mode == "sigma":
        loss = lc + 0.5 * torch.exp(-2.0 * s) * lr + 3.0 * s
        s_next = 0.5 * torch.log(torch.clamp(lr_detached / 3.0, min=1e-30))
    else:
        raise ValueError(f"unknown mode: {mode!r}")
    return loss, s_next
