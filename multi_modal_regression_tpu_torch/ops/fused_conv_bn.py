"""BN folding (port of `fold_bn` in the JAX package's ops/fused_conv_bn.py).

The fused conv+BN kernels themselves are training kernels and wait for the
training step (ROADMAP.md); the eval path needs only the fold.
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
