"""torch's running-variance correction (`bessel_factor` of the JAX package's
models/norm.py).

torch BatchNorm normalizes with the biased batch variance but feeds the
running variance the unbiased one, var * n/(n-1). nn.BatchNorm2d does that
itself; the BNs written out by hand (the explicit stem BN, the head banks)
use this factor. `batch_norm` is the torch BN sites' call: nn.BatchNorm's
own outside a data-parallel step, the global batch's moments inside one.
"""

from __future__ import annotations

import torch
from torch import nn

from multi_modal_regression_tpu_torch.parallel.mesh import global_sums, sync_mesh


def bessel_factor(count: int) -> float:
    """n/(n-1) as a python float; 1.0 for n <= 1."""
    n = int(count)
    return n / (n - 1) if n > 1 else 1.0


def batch_norm(bn: nn.BatchNorm1d | nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """bn(x); in training under a data-parallel step (parallel.mesh
    `syncing_bn`), with the moments of the global batch instead: the
    per-channel (sum x, sum x^2), in at least float32, all-reduced over the
    data group (differentiable), the biased variance from them, the running
    statistics updated at bn.momentum with torch's n/(n-1) over the global
    count, and x normalized in that dtype before the cast back."""
    mesh = sync_mesh(bn)
    if not bn.training or mesh is None:
        return bn(x)
    dims = (0, *range(2, x.ndim))
    dt = torch.promote_types(torch.float32, x.dtype)
    xf = x.to(dt)
    sums, count = global_sums(torch.stack([xf.sum(dim=dims), (xf * xf).sum(dim=dims)]),
                              x.numel() // x.shape[1], mesh)
    mean = sums[0] / count
    var = torch.clamp(sums[1] / count - mean * mean, min=0.0)
    with torch.no_grad():
        stat = bn.running_mean.dtype
        bn.running_mean.lerp_(mean.to(stat), bn.momentum)
        bn.running_var.lerp_((var * bessel_factor(count)).to(stat), bn.momentum)
        if bn.num_batches_tracked is not None:
            bn.num_batches_tracked.add_(1)
    a = bn.weight.to(dt) * torch.rsqrt(var + bn.eps)
    b = bn.bias.to(dt) - mean * a
    shape = (1, -1) + (1,) * (x.ndim - 2)
    return (xf * a.view(shape) + b.view(shape)).to(x.dtype)
