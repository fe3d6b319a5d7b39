"""Bin-delta decode (port of the JAX package's losses/bin_delta.py).

The geodesic problem's losses are the primitives (losses/primitives.py);
the expected-loss forms of the other problems arrive with their presets.
"""

from __future__ import annotations

import torch


def decode_bin_delta(
    scores: torch.Tensor, residual: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """Predicted pose = dictionary atom at the argmax bin + residual.

    torch.argmax returns the first maximal index on ties, as jnp.argmax does.
    """
    return centers[torch.argmax(scores, dim=-1)] + residual
