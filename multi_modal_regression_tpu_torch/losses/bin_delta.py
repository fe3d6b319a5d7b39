"""Bin-delta decode (port of the JAX package's losses/bin_delta.py).

The bin-delta problems' losses are the primitives (losses/primitives.py)
and the expectation below; the other composed forms of the JAX module
arrive with their presets.
"""

from __future__ import annotations

from typing import Callable

import torch


def decode_bin_delta(
    scores: torch.Tensor, residual: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """Predicted pose = dictionary atom at the argmax bin + residual.

    torch.argmax returns the first maximal index on ties, as jnp.argmax does.
    """
    return centers[torch.argmax(scores, dim=-1)] + residual


def expected_regression(
    scores: torch.Tensor,
    candidates: torch.Tensor,  # (B, K, D) candidate poses per cluster
    y_true: torch.Tensor,  # (B, D)
    per_sample_loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """E_{k ~ softmax(scores)}[ loss(candidate_k, y_true) ], mean over batch.

    per_sample_loss maps ((..., D), (..., D)) -> (...): it is applied once to
    the (B, K, D) candidates against y_true broadcast over the cluster axis,
    where the JAX function vmaps over that axis.
    """
    losses = per_sample_loss(candidates, y_true[:, None, :].expand_as(candidates))  # (B, K)
    probs = torch.softmax(scores, dim=-1)
    return torch.mean(torch.sum(probs * losses, dim=-1))
