"""ResNet feature trunks (port of the JAX package's models/backbones.py).

ResNet18/34/50/101/152 truncated after stage 2, 3 or 4, then a global
average pool (or, with pool=False, the spatial features), and
`ResNetStage`, one residual stage on its own over such features (the
joint variant-2 model's second layer4). Module and parameter names follow
the flax trees (`conv1`, `bn1`, `layer<s>_<b>/conv<i>`, `downsample_conv`,
...) so models/pretrained.py maps one onto the other.

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
what the JAX package's TorchBatchNorm reproduces.

With `fused` set ('plain' | 'kernel', the JAX package's 'xla' | 'pallas'),
bottleneck blocks train through ops.fused_conv_bn: each conv returns its
output's per-channel sums, the BN is folded from them (`_bn_affine`) and
applied in the NEXT conv's input pass. The module tree and the state_dict
keys are the same with and without `fused`. The VGG trunks wait (ROADMAP.md).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_regression_tpu_torch.models.norm import bessel_factor
from multi_modal_regression_tpu_torch.ops.fused_conv_bn import (
    IMPLS as FUSED_IMPLS,
    conv1x1_bn_stats,
    conv3x3_bn_stats,
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


def _channel_sums(y: torch.Tensor, dims: tuple[int, ...]) -> torch.Tensor:
    """(2, C) float32 (sum y, sum y^2) over `dims`, by one float32 reduce."""
    yf = y.float()
    return torch.stack([yf.sum(dim=dims), (yf * yf).sum(dim=dims)])


def _bn_affine(
    bn: nn.BatchNorm2d, sums: torch.Tensor | None = None, count: int | None = None
) -> tuple[torch.Tensor, torch.Tensor]:
    """The folded affine (a, b) of `bn`, float32 (the JAX `_BNState` + fold_bn).

    Without `sums` (eval): from the running statistics. With the (2, C) sums
    of `count` elements per channel (training): from the batch moments
    (`stats_to_moments`), differentiable back into the sums; the running
    statistics take one update at momentum 0.1 with the Bessel-corrected
    variance, as torch's BatchNorm2d makes it.
    """
    if sums is None:
        return fold_bn(bn.running_mean, bn.running_var, bn.weight, bn.bias)
    mean, var = stats_to_moments(sums, count)
    with torch.no_grad():
        stat_dtype = bn.running_mean.dtype
        bn.running_mean.lerp_(mean.to(stat_dtype), _BN_MOMENTUM)
        bn.running_var.lerp_((var * bessel_factor(count)).to(stat_dtype), _BN_MOMENTUM)
        bn.num_batches_tracked.add_(1)
    return fold_bn(mean, var, bn.weight, bn.bias)


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
    """ResNet50/101/152 bottleneck (torchvision v1.5: stride on the 3x3).

    With `fused` set ('plain' | 'kernel') the block computes in bfloat16
    through ops.fused_conv_bn (`_forward_fused`); the modules and parameters
    are the same either way.
    """

    def __init__(self, cin: int, features: int, stride: int, dtype, param_dtype,
                 fused: str | None = None):
        super().__init__()
        if fused is not None and dtype != torch.bfloat16:
            raise ValueError(
                f"the fused conv+BN path computes in bfloat16, got dtype {dtype}"
            )
        self.fused = fused
        self.stride = stride
        self.compute_dtype = dtype
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
        if self.fused is not None:
            return self._forward_fused(x)
        y = torch.relu(self.bn1(self.conv1(x)))
        y = torch.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        if self.downsample_conv is not None:
            x = self.downsample_bn(self.downsample_conv(x))
        return torch.relu(y + x)

    def _forward_fused(self, x: torch.Tensor) -> torch.Tensor:
        """The JAX `_call_fused`. x and the result are (B, C, H, W)."""
        dt = self.compute_dtype

        def affine(y, ab, channel_dim):
            shape = [1] * y.ndim
            shape[channel_dim] = -1
            return y * ab[0].to(dt).view(shape) + ab[1].to(dt).view(shape)

        if not self.training:
            # eval: library convs and the running-stat affine in bf16, no kernel
            z1 = torch.relu(affine(self.conv1(x), _bn_affine(self.bn1), 1))
            z2 = torch.relu(affine(self.conv2(z1), _bn_affine(self.bn2), 1))
            z3 = affine(self.conv3(z2), _bn_affine(self.bn3), 1)
            if self.downsample_conv is not None:
                x = affine(self.downsample_conv(x), _bn_affine(self.downsample_bn), 1)
            return torch.relu(z3 + x)

        impl = self.fused
        # the ops take NHWC: a view of a channels_last x, a copy of any other
        xn = x.to(dt).permute(0, 2, 3, 1).contiguous()
        # conv1: its input is post-activation already, no prologue
        y1, s1 = conv1x1_bn_stats(xn, self.conv1.weight, None, relu=False, impl=impl)
        ab1 = _bn_affine(self.bn1, s1, y1.shape[0] * y1.shape[1] * y1.shape[2])
        if self.stride == 1:
            # bn1 + ReLU in the 3x3's input pass, bn2's statistics in its output pass
            y2, s2 = conv3x3_bn_stats(y1, self.conv2.weight, ab1, relu=True, impl=impl)
        else:
            # the strided 3x3 stays a library conv on the materialized
            # normalized input, its statistics one float32 reduce
            z1 = torch.relu(affine(y1, ab1, 3))
            y2 = self.conv2(z1.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
            s2 = _channel_sums(y2, (0, 1, 2))
        # the BN count is that of the ACTUAL output: the input count over
        # stride^2 undercounts at odd sizes (9x9 -> 5x5 = 25, not 81 // 4)
        count2 = y2.shape[0] * y2.shape[1] * y2.shape[2]
        ab2 = _bn_affine(self.bn2, s2, count2)
        y3, s3 = conv1x1_bn_stats(y2, self.conv3.weight, ab2, relu=True, impl=impl)
        ab3 = _bn_affine(self.bn3, s3, count2)
        if self.downsample_conv is not None:
            yd, sd = conv1x1_bn_stats(
                xn, self.downsample_conv.weight, None, stride=self.stride, relu=False,
                impl=impl,
            )
            shortcut = affine(yd, _bn_affine(self.downsample_bn, sd, count2), 3)
        else:
            shortcut = xn
        # all-bf16 glue, as the JAX package has it
        out = torch.relu(affine(y3, ab3, 3) + shortcut)
        return out.permute(0, 3, 1, 2)


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

    fused (None | 'plain' | 'kernel') selects the bottleneck blocks' fused
    conv+BN path (bfloat16 only; BasicBlock trunks ignore it); with `fused`
    set and stem_pool None the stem takes the folded BN with eager ReLU and
    max-pool, as the JAX package does.

    pool=False returns the last stage's spatial features (B, H, W, C) in
    the compute dtype, an NHWC view of the channels_last activations (the
    JAX package's layout), for a `ResNetStage` to continue.
    """

    def __init__(
        self, arch: str = "resnet50", num_stages: int = 4,
        dtype: torch.dtype = torch.float32, stem_pool: str | None = None,
        param_dtype: torch.dtype | None = None, fused: str | None = None,
        pool: bool = True,
    ):
        super().__init__()
        if not 2 <= num_stages <= 4:
            raise ValueError(f"num_stages must be in [2, 4], got {num_stages}")
        if stem_pool not in STEM_POOL_IMPLS:
            raise ValueError(
                f"stem_pool must be one of {STEM_POOL_IMPLS}, got {stem_pool!r}"
            )
        if fused is not None and fused not in FUSED_IMPLS:
            raise ValueError(
                f"fused must be None or one of {FUSED_IMPLS}, got {fused!r}"
            )
        param_dtype = param_dtype or dtype
        stage_sizes, bottleneck = RESNET_CONFIGS[arch]
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        expansion = 4 if bottleneck else 1
        self.dtype = dtype
        self.stem_pool = stem_pool
        self.pool = pool
        # BasicBlock trunks have no fused form and ignore the setting
        self.fused = fused if bottleneck else None
        kwargs = {"fused": self.fused} if bottleneck else {}
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
                self.add_module(
                    name, block_cls(cin, width, stride, dtype, param_dtype, **kwargs)
                )
                self.block_names.append(name)
                cin = width * expansion
        self.feature_dim = cin

    def _stem_affine(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The folded stem BN (a, b) for conv1's output x (B, C, H, W)."""
        if not self.training:
            return _bn_affine(self.bn1)
        count = x.shape[0] * x.shape[2] * x.shape[3]
        return _bn_affine(self.bn1, _channel_sums(x, (0, 2, 3)), count)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view; a contiguous NHWC input is channels_last already
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        x = self.conv1(x)
        if self.stem_pool is None and self.fused is None:
            x = torch.relu(self.bn1(x))
            x = F.max_pool2d(x, 3, stride=2, padding=1)
        else:
            # with `fused` alone the folded stem runs as eager ops ('plain')
            a, b = self._stem_affine(x)
            x = stem_bn_relu_pool(x, a, b, self.stem_pool or "plain")
        for name in self.block_names:
            x = getattr(self, name)(x)
        if not self.pool:
            return x.permute(0, 2, 3, 1)
        # global average pool, accumulated in at least float32
        return x.to(torch.promote_types(torch.float32, x.dtype)).mean(dim=(2, 3))


class ResNetStage(nn.Module):
    """One residual stage on its own (1-indexed `stage`), over the spatial
    features (B, H, W, C) that `ResNetBackbone(..., pool=False)` returns;
    then the global average pool in at least float32, or with pool=False
    the spatial output. Blocks are named as the trunk's (`layer<s>_<b>`),
    so a trunk's stage grafts in by renaming its prefix (models/surgery).
    Conv weights are drawn by the caller (`init_conv_weights`)."""

    def __init__(
        self, arch: str = "resnet50", stage: int = 4,
        dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None,
        pool: bool = True,
    ):
        super().__init__()
        if not 1 <= stage <= 4:
            raise ValueError(f"stage must be in [1, 4], got {stage}")
        param_dtype = param_dtype or dtype
        stage_sizes, bottleneck = RESNET_CONFIGS[arch]
        block_cls = BottleneckBlock if bottleneck else BasicBlock
        expansion = 4 if bottleneck else 1
        self.dtype = dtype
        self.pool = pool
        width = 64 * 2 ** (stage - 1)
        cin = 64 if stage == 1 else (width // 2) * expansion
        self.block_names: list[str] = []
        for block in range(stage_sizes[stage - 1]):
            stride = 2 if stage > 1 and block == 0 else 1
            name = f"layer{stage}_{block}"
            self.add_module(name, block_cls(cin, width, stride, dtype, param_dtype))
            self.block_names.append(name)
            cin = width * expansion
        self.feature_dim = cin

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view; the trunk's NHWC view is channels_last already
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        for name in self.block_names:
            x = getattr(self, name)(x)
        if not self.pool:
            return x.permute(0, 2, 3, 1)
        return x.to(torch.promote_types(torch.float32, x.dtype)).mean(dim=(2, 3))


def make_backbone(
    name: str, layer: str, dtype: torch.dtype = torch.float32,
    stem_pool: str | None = None, param_dtype: torch.dtype | None = None,
    fused: str | None = None,
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
        param_dtype=param_dtype, fused=fused,
    )
