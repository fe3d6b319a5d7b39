"""ResNet feature trunks (port of the JAX package's models/backbones.py).

ResNet18/34/50/101/152 truncated after stage 2, 3 or 4, then a global
average pool, in eval mode (running-stat BatchNorm). Module and parameter
names follow the flax trees (`conv1`, `bn1`, `layer<s>_<b>/conv<i>`,
`downsample_conv`, ...) so models/pretrained.py maps one onto the other.

Layout and dtypes:
  - `forward` takes NHWC images (B, H, W, 3), as the JAX package does, and
    views them as NCHW in torch.channels_last with no copy; every conv
    keeps that format, so the stem kernel gets conv1's output physically
    NHWC.
  - conv weights are held in the compute dtype (bfloat16 for the serving
    path); BN parameters and running statistics stay float32, and eval BN
    computes in float32 before rounding to the compute dtype, as flax's
    BatchNorm with dtype=bf16 and float32 parameters does.
  - the pooled features are returned in at least float32.

Training mode (batch statistics, the fused conv+BN kernels) and the VGG
trunks wait (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_regression_tpu_torch.ops.fused_conv_bn import fold_bn
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


def _conv(cin: int, cout: int, kernel: int, stride: int, pad: int, dtype) -> nn.Conv2d:
    """Bias-free conv with symmetric padding (torch semantics)."""
    return nn.Conv2d(
        cin, cout, kernel, stride=stride, padding=pad, bias=False, dtype=dtype
    )


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


def _bn(features: int) -> nn.BatchNorm2d:
    """torch-default BN (eps 1e-5); float32 parameters and statistics."""
    return nn.BatchNorm2d(features, eps=1e-5, momentum=0.1, dtype=torch.float32)


def _eval_bn(x: torch.Tensor, bn: nn.BatchNorm2d) -> torch.Tensor:
    """Running-stat BN, computed in float32 and returned in x's dtype."""
    return F.batch_norm(
        x, bn.running_mean, bn.running_var, bn.weight, bn.bias,
        training=False, eps=bn.eps,
    )


class BasicBlock(nn.Module):
    """ResNet18/34 residual block: 3x3 -> 3x3 with identity shortcut."""

    def __init__(self, cin: int, features: int, stride: int, dtype):
        super().__init__()
        self.conv1 = _conv(cin, features, 3, stride, 1, dtype)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, 1, 1, dtype)
        self.bn2 = _bn(features)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or cin != features:
            self.downsample_conv = _conv(cin, features, 1, stride, 0, dtype)
            self.downsample_bn = _bn(features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(_eval_bn(self.conv1(x), self.bn1))
        y = _eval_bn(self.conv2(y), self.bn2)
        if self.downsample_conv is not None:
            x = _eval_bn(self.downsample_conv(x), self.downsample_bn)
        return torch.relu(y + x)


class BottleneckBlock(nn.Module):
    """ResNet50/101/152 bottleneck (torchvision v1.5: stride on the 3x3)."""

    def __init__(self, cin: int, features: int, stride: int, dtype):
        super().__init__()
        self.conv1 = _conv(cin, features, 1, 1, 0, dtype)
        self.bn1 = _bn(features)
        self.conv2 = _conv(features, features, 3, stride, 1, dtype)
        self.bn2 = _bn(features)
        self.conv3 = _conv(features, 4 * features, 1, 1, 0, dtype)
        self.bn3 = _bn(4 * features)
        self.downsample_conv = self.downsample_bn = None
        if stride != 1 or cin != 4 * features:
            self.downsample_conv = _conv(cin, 4 * features, 1, stride, 0, dtype)
            self.downsample_bn = _bn(4 * features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(_eval_bn(self.conv1(x), self.bn1))
        y = torch.relu(_eval_bn(self.conv2(y), self.bn2))
        y = _eval_bn(self.conv3(y), self.bn3)
        if self.downsample_conv is not None:
            x = _eval_bn(self.downsample_conv(x), self.downsample_bn)
        return torch.relu(y + x)


class ResNetBackbone(nn.Module):
    """ResNet feature extractor truncated after `num_stages` residual stages.

    num_stages 4 is 'layer4' (2048-d for bottleneck ResNets), 3 'layer3',
    2 'layer2'. Input (B, H, W, 3) NHWC; output (B, feature_dim).

    stem_pool selects the stem tail in eval mode: None runs BN, ReLU and
    max-pool as torch ops (the flax-module stem); 'plain' folds the BN and
    runs ops.stem_pool._composite; 'kernel' folds the BN and runs the stem
    kernel (csrc/stem_pool.cu) — the counterparts of the JAX package's
    None, 'xla' and 'pallas'.
    """

    def __init__(
        self, arch: str = "resnet50", num_stages: int = 4,
        dtype: torch.dtype = torch.float32, stem_pool: str | None = None,
    ):
        super().__init__()
        if not 2 <= num_stages <= 4:
            raise ValueError(f"num_stages must be in [2, 4], got {num_stages}")
        if stem_pool not in STEM_POOL_IMPLS:
            raise ValueError(
                f"stem_pool must be one of {STEM_POOL_IMPLS}, got {stem_pool!r}"
            )
        stage_sizes, bottleneck = RESNET_CONFIGS[arch]
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        expansion = 4 if bottleneck else 1
        self.dtype = dtype
        self.stem_pool = stem_pool
        self.conv1 = _conv(3, 64, 7, 2, 3, dtype)
        self.bn1 = _bn(64)
        # blocks are attributes named as in the flax tree: layer<s>_<b>
        self.block_names: list[str] = []
        cin = 64
        for stage in range(num_stages):
            width = 64 * 2**stage
            for block in range(stage_sizes[stage]):
                stride = 2 if stage > 0 and block == 0 else 1
                name = f"layer{stage + 1}_{block}"
                self.add_module(name, block_cls(cin, width, stride, dtype))
                self.block_names.append(name)
                cin = width * expansion
        self.feature_dim = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view; a contiguous NHWC input is channels_last already
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = self.conv1(x)
        if self.stem_pool is None:
            x = torch.relu(_eval_bn(x, self.bn1))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        else:
            bn = self.bn1
            a, b = fold_bn(bn.running_mean, bn.running_var, bn.weight, bn.bias)
            x = stem_bn_relu_pool(x, a, b, self.stem_pool)
        for name in self.block_names:
            x = getattr(self, name)(x)
        # global average pool, accumulated in at least float32
        return x.to(torch.promote_types(torch.float32, x.dtype)).mean(dim=(2, 3))


def make_backbone(
    name: str, layer: str, dtype: torch.dtype = torch.float32,
    stem_pool: str | None = None,
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
        arch=name, num_stages=int(layer[-1]), dtype=dtype, stem_pool=stem_pool
    )
