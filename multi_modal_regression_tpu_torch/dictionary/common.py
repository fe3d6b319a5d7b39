"""Shared dictionary utilities (port of the JAX package's dictionary/common.py)."""

from __future__ import annotations

import torch


def pairwise_sqeuclidean(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Squared Euclidean distances between rows of x (N, D) and y (K, D).

    The expansion |x|^2 - 2<x,y> + |y|^2, as in the JAX package, so both
    sides argmin the same numbers; clamped at zero against cancellation.
    The dtype is promoted BEFORE squaring: with mixed inputs (float64 poses
    against a float32 dictionary) squaring in float32 would inject
    1e-7-level error into otherwise float64 distances.
    """
    dt = torch.promote_types(x.dtype, y.dtype)
    x, y = x.to(dt), y.to(dt)
    x2 = torch.sum(x * x, dim=-1, keepdim=True)
    y2 = torch.sum(y * y, dim=-1, keepdim=True).T
    d = x2 - 2.0 * (x @ y.T) + y2
    return torch.clamp(d, min=0.0)
