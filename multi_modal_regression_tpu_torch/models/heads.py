"""Vectorized MLP head banks (port of the JAX package's models/heads.py).

A bank of H parallel heads is one stacked weight per layer, (H, in, out),
applied as one batched product, and the class is picked by a gather, as in
the JAX package. Layer recipe: hidden layers are Linear(bias=False) + BN +
ReLU; the last layer is a Linear with bias, then the output nonlinearity.
BatchNorm in a bank is per (head, feature) over the batch, eps 1e-5.
`SharedMLP` is the same recipe as one class-agnostic head without the
head axis.

Weights are held in `param_dtype` (float32 master weights for training, or
the compute dtype for serving) and applied in the compute dtype; BN
parameters and running statistics are at least float32; outputs are returned in at
least float32. BN follows the module's mode (running statistics in eval,
batch statistics in training).
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_regression_tpu_torch import EPS
from multi_modal_regression_tpu_torch.models.norm import batch_norm, bessel_factor
from multi_modal_regression_tpu_torch.parallel.mesh import global_sums, sync_mesh
from multi_modal_regression_tpu_torch.parallel.tp import (
    copy_to_model,
    gather_heads,
    reduce_from_model,
)


def torch_linear_init(
    t: torch.Tensor, fan_in: int, generator: torch.Generator
) -> None:
    """Fill t with torch.nn.Linear's default U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
    bound = 1.0 / math.sqrt(fan_in)
    u = torch.rand(t.shape, generator=generator, dtype=torch.float32)
    with torch.no_grad():
        t.copy_(u * (2 * bound) - bound)


def apply_output_nonlinearity(y: torch.Tensor, kind: str) -> torch.Tensor:
    """Output nonlinearities of the pose-head zoo:

      'none'     raw scores / residuals (the bin-delta heads)
      'tanh'     tanh (model_2layer, poseModels.py:38)
      'pi_tanh'  pi * tanh (regression 'valid', learnGeodesicRegressionModel.py:102)
      'my_proj'  angle fmod(|y|, pi) along y/|y|, 0 for |y| <= EPS
                 (regression 'correct', :76-80,104)
      'quat'     L2-normalized tanh, a unit quaternion (quaternion.py:114,122-142)
    """
    if kind == "none":
        return y
    if kind == "tanh":
        return torch.tanh(y)
    if kind == "pi_tanh":
        return math.pi * torch.tanh(y)
    if kind == "my_proj":
        sq = torch.sum(y * y, dim=-1, keepdim=True)
        norm = torch.sqrt(torch.clamp(sq, min=EPS * EPS))
        angle = torch.fmod(norm, math.pi)
        return torch.where(sq <= EPS * EPS, torch.zeros_like(y), angle * y / norm)
    if kind == "quat":
        # F.normalize(F.tanh(y)): torch's normalize clamps the norm at 1e-12
        t = torch.tanh(y)
        norm = torch.sqrt(torch.clamp(torch.sum(t * t, dim=-1, keepdim=True), min=1e-24))
        return t / torch.clamp(norm, min=1e-12)
    raise ValueError(f"unknown output nonlinearity {kind!r}")


class HeadBatchNorm(nn.Module):
    """BatchNorm per (head, feature) on (H, B, F) activations.

    Same (H, F) parameter and statistic shapes as the flax tree
    (TorchBatchNorm with axis=(0, -1)); computed in float32 as flax's
    normalize does, returned in the input dtype. In training mode the
    statistics are taken over the batch axis, every head seeing the whole
    batch, and the running variance takes torch's n/(n-1) with n = B. The
    biased variance is taken in two passes, mean((x - mean)^2), where flax
    uses E[x^2] - E[x]^2: the same quantity, but when a feature varies by
    well under 1% across the batch (random weights, similar images) the
    one-pass form cancels in float32 and loses the variance. In a
    data-parallel step (parallel.mesh `syncing_bn`) each pass's sum is
    all-reduced over the data group, so mean, variance and n are the global
    batch's: two all-reduces.
    """

    def __init__(self, num_heads: int, features: int, eps: float = 1e-5,
                 momentum: float = 0.1, dtype: torch.dtype = torch.float32):
        super().__init__()
        shape = (num_heads, features)
        self.eps = eps
        self.momentum = momentum
        self.weight = nn.Parameter(torch.ones(shape, dtype=dtype))
        self.bias = nn.Parameter(torch.zeros(shape, dtype=dtype))
        self.register_buffer("running_mean", torch.zeros(shape, dtype=dtype))
        self.register_buffer("running_var", torch.ones(shape, dtype=dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        compute = torch.promote_types(x.dtype, torch.float32)
        xc = x.to(compute)
        if self.training:
            n = x.shape[1]
            mesh = sync_mesh(self)
            if mesh is None:
                mean = xc.mean(dim=1)
                var = torch.square(xc - mean[:, None, :]).mean(dim=1)
            else:
                total, n = global_sums(xc.sum(dim=1), n, mesh)
                mean = total / n
                var = global_sums(torch.square(xc - mean[:, None, :]).sum(dim=1),
                                  x.shape[1], mesh)[0] / n
            with torch.no_grad():
                m = 1.0 - self.momentum
                self.running_mean.copy_(m * self.running_mean + (1 - m) * mean)
                self.running_var.copy_(
                    m * self.running_var
                    + (1 - m) * (var * bessel_factor(n))
                )
        else:
            mean, var = self.running_mean, self.running_var
        mul = torch.rsqrt(var + self.eps) * self.weight
        y = (xc - mean[:, None, :]) * mul[:, None, :]
        return (y + self.bias[:, None, :]).to(x.dtype)


class MultiHeadMLP(nn.Module):
    """A bank of `num_heads` MLPs over shared input features.

    Input (B, F) shared by all heads; output (B, H, features[-1]), or with
    `select` (head indices (B,) or (B, G)) each row's selected heads, (B,
    O) or (B, G, O), by a gather. `features` lists hidden dims then the
    output dim: bin_3layer(N0, N1, N2, K) is MultiHeadMLP(N0, H, (N1, N2,
    K)). Parameters are named as in the flax tree: fc<i>_kernel (H, in,
    out), bn<i>, and fc<last>_bias (H, out).

    A bank that parallel.tp.shard_state cut to this rank's heads (`tp` set)
    takes its features through f (`copy_to_model`) and returns the
    selected heads through g (`reduce_from_model`: each selected head lives
    on one model rank, the others give zeros), or with no selection every
    head (`gather_heads`).
    """

    def __init__(
        self, in_features: int, num_heads: int, features: Sequence[int],
        *, generator: torch.Generator, output_nonlinearity: str = "none",
        dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.dtype = dtype
        self.output_nonlinearity = output_nonlinearity
        self.num_layers = len(features)
        self.tp = None  # parallel.tp.HeadShard once sharded
        fan_in = in_features
        for li, out_dim in enumerate(features, start=1):
            kernel = nn.Parameter(
                torch.empty(num_heads, fan_in, out_dim, dtype=param_dtype)
            )
            torch_linear_init(kernel, fan_in, generator)
            self.register_parameter(f"fc{li}_kernel", kernel)
            if li == self.num_layers:
                bias = nn.Parameter(torch.empty(num_heads, out_dim, dtype=param_dtype))
                torch_linear_init(bias, fan_in, generator)
                self.register_parameter(f"fc{li}_bias", bias)
            else:
                self.add_module(f"bn{li}", HeadBatchNorm(
                    num_heads, out_dim,
                    dtype=torch.promote_types(torch.float32, dtype),
                ))
            fan_in = out_dim

    def _heads(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for li in range(1, self.num_layers + 1):
            # (B, I) @ (H, I, O) broadcasts to (H, B, O); then (H, B, I) @ (H, I, O)
            x = torch.matmul(x, getattr(self, f"fc{li}_kernel").to(self.dtype))
            if li == self.num_layers:
                x = x + getattr(self, f"fc{li}_bias").to(self.dtype)[:, None, :]
            else:
                x = torch.relu(getattr(self, f"bn{li}")(x))
        x = x.transpose(0, 1)  # (H, B, O) -> (B, H, O)
        return apply_output_nonlinearity(
            x.to(torch.promote_types(torch.float32, x.dtype)),
            self.output_nonlinearity,
        )

    def forward(self, x: torch.Tensor, select: torch.Tensor | None = None) -> torch.Tensor:
        shard = self.tp
        if shard is None:
            out = self._heads(x)
            return out if select is None else select_heads(out, select)
        out = self._heads(copy_to_model(x, shard))
        if select is None:
            return gather_heads(out, shard)
        idx = select.to(torch.int64) - shard.lo
        mine = (idx >= 0) & (idx < shard.local)
        picked = select_heads(out, idx.clamp(0, shard.local - 1))
        picked = torch.where(mine[..., None], picked, torch.zeros((), dtype=picked.dtype,
                                                                   device=picked.device))
        return reduce_from_model(picked, shard)


class SharedMLP(nn.Module):
    """One class-agnostic MLP head: (B, F) -> (B, features[-1]).

    The layer recipe of MultiHeadMLP without the head axis (the Independent*
    models, learnIndependentBDModel.py:88-111). Layers are nn.Linear
    `fc<i>` (bias on the last only) and nn.BatchNorm1d `bn<i>` (eps 1e-5,
    momentum 0.1, torch's unbiased running variance, as the JAX
    TorchBatchNorm), named as in the flax tree. Weights are held in
    `param_dtype` and applied in `dtype`; BN runs in at least float32 and
    the output is at least float32.
    """

    def __init__(
        self, in_features: int, features: Sequence[int], *,
        generator: torch.Generator, output_nonlinearity: str = "none",
        dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        param_dtype = param_dtype or dtype
        self.dtype = dtype
        self.output_nonlinearity = output_nonlinearity
        self.num_layers = len(features)
        fan_in = in_features
        for li, out_dim in enumerate(features, start=1):
            last = li == self.num_layers
            fc = nn.Linear(fan_in, out_dim, bias=last, dtype=param_dtype)
            torch_linear_init(fc.weight, fan_in, generator)
            if last:
                torch_linear_init(fc.bias, fan_in, generator)
            self.add_module(f"fc{li}", fc)
            if not last:
                self.add_module(f"bn{li}", nn.BatchNorm1d(
                    out_dim, eps=1e-5, momentum=0.1,
                    dtype=torch.promote_types(torch.float32, dtype),
                ))
            fan_in = out_dim

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.dtype)
        for li in range(1, self.num_layers + 1):
            fc = getattr(self, f"fc{li}")
            bias = None if fc.bias is None else fc.bias.to(self.dtype)
            x = F.linear(x, fc.weight.to(self.dtype), bias)
            if li < self.num_layers:
                bn = getattr(self, f"bn{li}")
                x = torch.relu(batch_norm(bn, x.to(bn.weight.dtype)).to(self.dtype))
        return apply_output_nonlinearity(
            x.to(torch.promote_types(torch.float32, x.dtype)),
            self.output_nonlinearity,
        )


def select_class(per_head: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
    """Pick each sample's head output: (B, H, D), (B,) int -> (B, D); also
    each sample's entry at a bin index (the multires deltas, per-bin
    targets)."""
    idx = label.to(torch.int64)[:, None, None].expand(-1, 1, per_head.shape[-1])
    return torch.gather(per_head, 1, idx)[:, 0]


def select_heads(per_head: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """(B, H, D) at head indices (B,) -> (B, D) (`select_class`), or at
    (B, G) -> (B, G, D)."""
    if index.ndim == 1:
        return select_class(per_head, index)
    idx = index.to(torch.int64)[:, :, None].expand(-1, -1, per_head.shape[-1])
    return torch.gather(per_head, 1, idx)
