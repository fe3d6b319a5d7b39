"""BN folding and batch moments (the JAX package's ops/fused_conv_bn.py).

`fold_bn` and `stats_to_moments` are what the explicit stem BN needs
(models/backbones.py). The fused conv+BN kernels themselves wait for the
fused training trunk (ROADMAP.md).
"""

from __future__ import annotations

import torch


def fold_bn(
    mean: torch.Tensor, var: torch.Tensor, scale: torch.Tensor,
    bias: torch.Tensor, eps: float = 1e-5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(mean, var, scale, bias) -> (a, b) with bn(x) = x * a + b, float32."""
    a = scale.float() * torch.rsqrt(var.float() + eps)
    b = bias.float() - mean.float() * a
    return a, b


def stats_to_moments(
    s: torch.Tensor, count: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """(2, N) sums (sum y, sum y^2) -> (mean, biased variance clamped at 0)."""
    mean = s[0] / count
    var = s[1] / count - mean * mean
    return mean, torch.clamp(var, min=0.0)
