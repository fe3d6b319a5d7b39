"""ResNet feature trunks (port of the JAX package's models/backbones.py).

ResNet18/34/50/101/152 truncated after stage 2, 3 or 4, then a global
average pool. Module and parameter names follow the flax trees (`conv1`,
`bn1`, `layer<s>_<b>/conv<i>`, `downsample_conv`, ...) so
models/pretrained.py maps one onto the other.

Layout and dtypes:
  - `forward` takes NHWC images (B, H, W, 3), as the JAX package does, and
    views them as NCHW in torch.channels_last with no copy; every conv
    keeps that format, so the stem kernels get conv1's output physically
    NHWC.
  - convs compute in `dtype` (bfloat16 on the fast path) with weights held
    in `param_dtype`: float32 master weights for training, as the JAX
    package keeps them, or the compute dtype itself for serving, which then
    needs no per-call cast. BN parameters and running statistics are at
    least float32, and BN computes in float32 before rounding to a bf16
    compute dtype, as flax's BatchNorm with dtype=bf16 and float32
    parameters does.
  - the pooled features are returned in at least float32.

BatchNorm follows the module's mode: running statistics in eval mode; in
training mode batch statistics, with the running statistics updated at
momentum 0.1 (flax 0.9) from torch's Bessel-corrected variance, which is
what the JAX package's TorchBatchNorm reproduces. The fused conv+BN training
kernels and the VGG trunks wait (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_regression_tpu_torch.models.norm import bessel_factor
from multi_modal_regression_tpu_torch.ops.fused_conv_bn import (
    fold_bn,
    stats_to_moments,
)
from multi_modal_regression_tpu_torch.ops.stem_pool import stem_bn_relu_pool

# (stage_sizes, bottleneck) per architecture, torchvision naming.
RESNET_CONFIGS: dict[str, tuple[tuple[int, ...], bool]] = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}

STEM_POOL_IMPLS = (None, "plain", "kernel")

# running-stat decay of every BN: torch momentum 0.1, flax momentum 0.9
_BN_MOMENTUM = 0.1


class _Conv(nn.Conv2d):
    """Bias-free conv with symmetric padding (torch semantics); the weight
    is held in `param_dtype` and applied in the compute `dtype`."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, pad: int,
                 dtype, param_dtype):
        super().__init__(
            cin, cout, kernel, stride=stride, padding=pad, bias=False,
            dtype=param_dtype,
        )
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self._conv_forward(x, self.weight.to(self.compute_dtype), None)


def lecun_normal_(w: torch.Tensor, generator: torch.Generator) -> None:
    """Fill a conv weight (O, I, kH, kW) as flax's lecun_normal does:
    a normal of variance 1/fan_in truncated at two standard deviations."""
    std = math.sqrt(1.0 / w[0].numel()) / 0.87962566103423978
    lo = 0.5 * (1.0 + math.erf(-2.0 / math.sqrt(2.0)))  # Phi(-2)
    u = torch.rand(w.shape, generator=generator, dtype=torch.float64)
    u = lo + u * (1.0 - 2.0 * lo)
    with torch.no_grad():
        w.copy_(math.sqrt(2.0) * torch.erfinv(2.0 * u - 1.0) * std)


def init_conv_weights(module: nn.Module, generator: torch.Generator) -> None:
    """Re-draw every conv weight of `module` from `generator`."""
    for m in module.modules():
        if isinstance(m, nn.Conv2d):
            lecun_normal_(m.weight, generator)


def _bn(features: int, dtype: torch.dtype) -> nn.BatchNorm2d:
    """torch-default BN (eps 1e-5); parameters and statistics in at least
    float32 (float64 for a float64 trunk)."""
    return nn.BatchNorm2d(
        features, eps=1e-5, momentum=_BN_MOMENTUM,
        dtype=torch.promote_types(torch.float32, dtype),
    )


class BasicBlock(nn.Module):
    """ResNet18/34 residual block: 3x3 -> 3x3 with identity shortcut."""

    def __init__(self, cin: int, features: int, stride: int, dtype, param_dtype):
        super().__init__()
        self.conv1 = _Conv(cin, features, 3, stride, 1, dtype, param_dtype)
        self.bn1 = _bn(features, dtype)
        self.conv2 = _Conv(features, features, 3, 1, 1, dtype, param_dtype)
        self.bn2 = _bn(features, dtype)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or cin != features:
            self.downsample_conv = _Conv(cin, features, 1, stride, 0, dtype, param_dtype)
            self.downsample_bn = _bn(features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = self.bn2(self.conv2(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + x)


class BottleneckBlock(nn.Module):
    """ResNet50/101/152 bottleneck (torchvision v1.5: stride on the 3x3)."""

    def __init__(self, cin: int, features: int, stride: int, dtype, param_dtype):
        super().__init__()
        self.conv1 = _Conv(cin, features, 1, 1, 0, dtype, param_dtype)
        self.bn1 = _bn(features, dtype)
        self.conv2 = _Conv(features, features, 3, stride, 1, dtype, param_dtype)
        self.bn2 = _bn(features, dtype)
        self.conv3 = _Conv(features, 4 * features, 1, 1, 0, dtype, param_dtype)
        self.bn3 = _bn(4 * features, dtype)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or cin != 4 * features:
            self.downsample_conv = _Conv(cin, 4 * features, 1, stride, 0, dtype, param_dtype)
            self.downsample_bn = _bn(4 * features, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + x)


class ResNetBackbone(nn.Module):
    """ResNet feature extractor truncated after `num_stages` residual stages.

    num_stages 4 is 'layer4' (2048-d for bottleneck ResNets), 3 'layer3',
    2 'layer2'. Input (B, H, W, 3) NHWC; output (B, feature_dim).

    stem_pool selects the stem tail: None runs BN, ReLU and max-pool as
    torch ops (the flax-module stem); 'plain' folds the BN and runs
    ops.stem_pool._composite; 'kernel' folds the BN and runs the stem
    kernels (csrc/stem_pool.cu) — the counterparts of the JAX package's
    None, 'xla' and 'pallas'. With stem_pool set, the stem BN is written out
    as the JAX package writes it (backbones.py:320-348): in training, the
    float32 sum and sum of squares of conv1's output give the batch moments,
    `bn1`'s running statistics are updated from them by hand, and the
    folded affine stays differentiable back into conv1's output.
    """

    def __init__(
        self, arch: str = "resnet50", num_stages: int = 4,
        dtype: torch.dtype = torch.float32, stem_pool: str | None = None,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        if not 2 <= num_stages <= 4:
            raise ValueError(f"num_stages must be in [2, 4], got {num_stages}")
        if stem_pool not in STEM_POOL_IMPLS:
            raise ValueError(
                f"stem_pool must be one of {STEM_POOL_IMPLS}, got {stem_pool!r}"
            )
        param_dtype = param_dtype or dtype
        stage_sizes, bottleneck = RESNET_CONFIGS[arch]
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        expansion = 4 if bottleneck else 1
        self.dtype = dtype
        self.stem_pool = stem_pool
        self.conv1 = _Conv(3, 64, 7, 2, 3, dtype, param_dtype)
        self.bn1 = _bn(64, dtype)
        # blocks are attributes named as in the flax tree: layer<s>_<b>
        self.block_names: list[str] = []
        cin = 64
        for stage in range(num_stages):
            width = 64 * 2**stage
            for block in range(stage_sizes[stage]):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, block_cls(cin, width, stride, dtype, param_dtype))
                self.block_names.append(name)
                cin = width * expansion
        self.feature_dim = cin

    def _stem_affine(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The folded stem BN (a, b) for conv1's output x (B, C, H, W)."""
        bn = self.bn1
        if not self.training:
            return fold_bn(bn.running_mean, bn.running_var, bn.weight, bn.bias)
        xf = x.float()
        s = torch.stack([xf.sum(dim=(0, 2, 3)), (xf * xf).sum(dim=(0, 2, 3))])
        count = x.shape[0] * x.shape[2] * x.shape[3]
        mean, var = stats_to_moments(s, count)
        with torch.no_grad():
            m = 1.0 - _BN_MOMENTUM
            bn.running_mean.copy_(m * bn.running_mean + (1 - m) * mean)
            bn.running_var.copy_(
                m * bn.running_var + (1 - m) * (var * bessel_factor(count))
            )
            bn.num_batches_tracked.add_(1)
        return fold_bn(mean, var, bn.weight, bn.bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view; a contiguous NHWC input is channels_last already
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = self.conv1(x)
        if self.stem_pool is None:
            x = torch.relu(self.bn1(x))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        else:
            a, b = self._stem_affine(x)
            x = stem_bn_relu_pool(x, a, b, self.stem_pool)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # global average pool, accumulated in at least float32
        return x.to(torch.promote_types(torch.float32, x.dtype)).mean(dim=(2, 3))


def make_backbone(
    name: str, layer: str, dtype: torch.dtype = torch.float32,
    stem_pool: str | None = None, param_dtype: torch.dtype | None = None,
) -> ResNetBackbone:
    """Factory for the ResNet names with layer 'layer2'|'layer3'|'layer4'."""
    if name not in RESNET_CONFIGS:
        raise ValueError(
            f"backbone {name!r} is not ported; the port has "
            f"{sorted(RESNET_CONFIGS)} (VGG waits, see ROADMAP.md)"
        )
    if layer not in ("layer2", "layer3", "layer4"):
        raise ValueError(f"layer must be layer2|layer3|layer4, got {layer!r}")
    return ResNetBackbone(
        arch=name, num_stages=int(layer[-1]), dtype=dtype, stem_pool=stem_pool,
        param_dtype=param_dtype,
    )
