"""Feature trunks (port of the JAX package's models/backbones.py).

ResNet18/34/50/101/152 truncated after stage 2, 3 or 4, then a global
average pool (or, with pool=False, the spatial features);
`ResNetStage`, one residual stage on its own over such features (the
joint variant-2 model's second layer4); and the VGG13/16-bn trunks cut at
fc6 or fc7 (`VGGBackbone`). Module and parameter names follow the flax
trees (`conv1`, `bn1`, `layer<s>_<b>/conv<i>`, `downsample_conv`, VGG's
`conv<i>`, `bn<i>`, `fc6`, `fc7`, ...) so models/pretrained.py maps one
onto the other.

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
keys are the same with and without `fused`.

A trunk's `remat` (None, or the `models/checkpoint.Segments` that
train/remat makes from cfg.remat when the model is built) applies when
gradients are on: the ResNet trunk then runs its stem and each block, or
each stage, as a checkpointed segment, so the stem output, the segments'
outputs and the pooled features stay for the backward, as the JAX
package's `checkpoint_name` tags select them, and a segment keeps inside
only what its policy names. A VGG trunk, which the JAX package does not
tag, runs each stage between its max pools and its classifier as segments.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_regression_tpu_torch.models.checkpoint import Segments, chain, segment
from multi_modal_regression_tpu_torch.models.heads import torch_linear_init
from multi_modal_regression_tpu_torch.models.norm import batch_norm, bessel_factor
from multi_modal_regression_tpu_torch.ops.fused_conv_bn import (
    IMPLS as FUSED_IMPLS,
    conv1x1_bn_stats,
    conv3x3_bn_stats,
    fold_bn,
    stats_to_moments,
)
from multi_modal_regression_tpu_torch.ops.stem_pool import stem_bn_relu_pool
from multi_modal_regression_tpu_torch.parallel.mesh import global_rows, global_sums, sync_mesh

# (stage_sizes, bottleneck) per architecture, torchvision naming.
RESNET_CONFIGS: dict[str, tuple[tuple[int, ...], bool]] = {
    "resnet18": ((2, 2, 2, 2), False),
    "resnet34": ((3, 4, 6, 3), False),
    "resnet50": ((3, 4, 6, 3), True),
    "resnet101": ((3, 4, 23, 3), True),
    "resnet152": ((3, 8, 36, 3), True),
}

# VGG feature stacks (torchvision convention; "M" = 2x2 max pool)
VGG_CONFIGS: dict[str, tuple] = {
    "vgg13": (64, 64, "M", 128, 128, "M", 256, 256, "M", 512, 512, "M", 512, 512, "M"),
    "vgg16": (64, 64, "M", 128, 128, "M", 256, 256, 256, "M", 512, 512, 512, "M",
              512, 512, 512, "M"),
}

STEM_POOL_IMPLS = (None, "plain", "kernel")

# running-stat decay of every BN: torch momentum 0.1, flax momentum 0.9
_BN_MOMENTUM = 0.1


class _Conv(nn.Conv2d):
    """Conv with symmetric padding (torch semantics), bias-free unless asked
    (VGG's); weight and bias are held in `param_dtype` and applied in the
    compute `dtype`."""

    def __init__(self, cin: int, cout: int, kernel: int, stride: int, pad: int,
                 dtype, param_dtype, bias: bool = False):
        super().__init__(
            cin, cout, kernel, stride=stride, padding=pad, bias=bias,
            dtype=param_dtype,
        )
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(self.compute_dtype)
        return self._conv_forward(x, self.weight.to(self.compute_dtype), bias)


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
    # the data group's, in a data-parallel step
    sums, count = global_sums(sums, count, sync_mesh(bn))
    mean, var = stats_to_moments(sums, count)
    with torch.no_grad():
        # bn.momentum: 0.1, or 0 with no counter while models/checkpoint replays a forward
        stat_dtype = bn.running_mean.dtype
        bn.running_mean.lerp_(mean.to(stat_dtype), bn.momentum)
        bn.running_var.lerp_((var * bessel_factor(count)).to(stat_dtype), bn.momentum)
        if bn.num_batches_tracked is not None:
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
        y = torch.relu(batch_norm(self.bn1, self.conv1(x)))
        y = batch_norm(self.bn2, self.conv2(y))
        if self.downsample_conv is not None:
            x = batch_norm(self.downsample_bn, self.downsample_conv(x))
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
        y = torch.relu(batch_norm(self.bn1, self.conv1(x)))
        y = torch.relu(batch_norm(self.bn2, self.conv2(y)))
        y = batch_norm(self.bn3, self.conv3(y))
        if self.downsample_conv is not None:
            x = batch_norm(self.downsample_bn, self.downsample_conv(x))
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
        self.remat: Segments | None = None  # set by train/remat from cfg.remat

    def _stem_affine(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The folded stem BN (a, b) for conv1's output x (B, C, H, W)."""
        if not self.training:
            return _bn_affine(self.bn1)
        count = x.shape[0] * x.shape[2] * x.shape[3]
        return _bn_affine(self.bn1, _channel_sums(x, (0, 2, 3)), count)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        x = self.conv1(x)
        if self.stem_pool is None and self.fused is None:
            x = torch.relu(batch_norm(self.bn1, x))
            return F.max_pool2d(x, 3, stride=2, padding=1)
        # with `fused` alone the folded stem runs as eager ops ('plain')
        a, b = self._stem_affine(x)
        return stem_bn_relu_pool(x, a, b, self.stem_pool or "plain")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> NCHW view; a contiguous NHWC input is channels_last already
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        seg = self.remat if torch.is_grad_enabled() else None
        if seg is None:
            x = self._stem(x)
            for name in self.block_names:
                x = getattr(self, name)(x)
        else:
            # the stem, then each block or stage, as segments; the stem reads
            # the trunk's own mode (`_stem_affine`)
            x = segment(self._stem, x, (self,), seg.context_fn)
            blocks = [getattr(self, n) for n in self.block_names]
            groups = ([[b] for b in blocks] if seg.group == "block" else
                      [[b for n, b in zip(self.block_names, blocks)
                        if n.startswith(f"layer{s}_")] for s in range(1, 5)])
            for group in filter(None, groups):
                x = segment(chain(group), x, group, seg.context_fn)
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


class VGGBackbone(nn.Module):
    """VGG13/16-bn feature stack + the classifier cut at fc6 or fc7
    (featureModels.py:44-67). Input (B, H, W, 3) NHWC; output (B, 4096) in
    at least float32.

    `conv<i>` (3x3, bias) -> `bn<i>` -> ReLU per layer of VGG_CONFIGS, 2x2
    max pools at "M"; then the NCHW activations flattened channel-major, as
    torch's classifier sees them (the JAX package transposes its NHWC
    activations to the same order), `fc6` Linear(512 h w, 4096) + ReLU; at
    fc7 Dropout(0.5) + `fc7` Linear(4096, 4096) + ReLU. In training mode
    the dropout mask is drawn from `dropout_rng`, the generator the train
    step binds for its forward and backward (TrainState.rng, the step's one
    source of randomness, as flax's Dropout draws from the key it is given);
    a training-mode fc7 forward with none bound raises, and eval mode draws
    nothing. Biases are drawn as torch.nn.Linear and Conv2d draw them; conv
    weights by the caller (`init_conv_weights`), as for the ResNets. There
    is no stem, so no stem kernel runs here.
    """

    feature_dim = 4096

    def __init__(
        self, arch: str = "vgg13", layer: str = "fc6",
        dtype: torch.dtype = torch.float32, param_dtype: torch.dtype | None = None,
        image_size: int = 224, generator: torch.Generator | None = None,
    ):
        super().__init__()
        if layer not in ("fc6", "fc7"):
            raise ValueError(f"layer must be fc6|fc7, got {layer!r}")
        param_dtype = param_dtype or dtype
        g = generator or torch.Generator().manual_seed(0)
        self.dtype = dtype
        self.layer = layer
        self.dropout_rng: torch.Generator | None = None  # bound by the train step
        self.remat: Segments | None = None  # set by train/remat from cfg.remat
        # the conv indices of each stage, a 2x2 max pool after each
        self.stages: list[list[int]] = [[]]
        cin, size, i = 3, image_size, 0
        for v in VGG_CONFIGS[arch]:
            if v == "M":
                self.stages.append([])
                size //= 2
                continue
            conv = _Conv(cin, int(v), 3, 1, 1, dtype, param_dtype, bias=True)
            torch_linear_init(conv.bias, cin * 9, g)
            self.add_module(f"conv{i}", conv)
            self.add_module(f"bn{i}", _bn(int(v), dtype))
            self.stages[-1].append(i)
            cin, i = int(v), i + 1
        del self.stages[-1]  # the configs end with a pool
        self.fc6 = nn.Linear(cin * size * size, 4096, dtype=param_dtype)
        self.fc7 = nn.Linear(4096, 4096, dtype=param_dtype) if layer == "fc7" else None
        for fc in filter(None, (self.fc6, self.fc7)):
            torch_linear_init(fc.weight, fc.in_features, g)
            torch_linear_init(fc.bias, fc.in_features, g)

    def _linear(self, fc: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return torch.relu(F.linear(x, fc.weight.to(self.dtype), fc.bias.to(self.dtype)))

    def _stage(self, convs: list[int]):
        def run(x: torch.Tensor) -> torch.Tensor:
            for i in convs:
                x = torch.relu(batch_norm(getattr(self, f"bn{i}"), getattr(self, f"conv{i}")(x)))
            return F.max_pool2d(x, 2, stride=2)
        return run

    def _classifier(self, x: torch.Tensor) -> torch.Tensor:
        # the logical NCHW order, whatever the memory format: C-major
        x = self._linear(self.fc6, x.flatten(1))
        if self.fc7 is not None:
            if self.training:
                if self.dropout_rng is None:
                    raise ValueError(
                        "fc7's dropout draws from the generator a train step binds "
                        "(TrainState.rng); this training-mode forward has none")
                # a data-parallel rank draws the global stream's mask and
                # keeps its rows (parallel.mesh.global_rows)
                rows, first = global_rows(x.shape[0], sync_mesh(self))
                keep = torch.rand((rows, *x.shape[1:]), generator=self.dropout_rng,
                                  device=x.device)[first:first + x.shape[0]] >= 0.5
                x = torch.where(keep, x / 0.5, torch.zeros((), dtype=x.dtype, device=x.device))
            x = self._linear(self.fc7, x)
        return x.to(torch.promote_types(torch.float32, x.dtype))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.permute(0, 3, 1, 2).to(self.dtype, memory_format=torch.channels_last)
        seg = self.remat if torch.is_grad_enabled() else None
        if seg is None:
            for convs in self.stages:
                x = self._stage(convs)(x)
            return self._classifier(x)
        # no checkpoint tags in the JAX VGG: each stage and the classifier are
        # segments, whatever the group
        for convs in self.stages:
            x = segment(self._stage(convs), x, (self,), seg.context_fn)
        return segment(self._classifier, x, (self,), seg.context_fn)


def make_backbone(
    name: str, layer: str, dtype: torch.dtype = torch.float32,
    stem_pool: str | None = None, param_dtype: torch.dtype | None = None,
    fused: str | None = None, image_size: int = 224,
    generator: torch.Generator | None = None,
) -> nn.Module:
    """Factory for the ResNet names with layer 'layer2'|'layer3'|'layer4'
    and the VGG names with layer 'fc6'|'fc7'. A VGG trunk has no stem and no
    bottleneck blocks, so it takes neither stem_pool nor fused; its fc6
    width follows `image_size`, its biases and fc weights are drawn from
    `generator`."""
    if name in VGG_CONFIGS:
        if stem_pool is not None or fused is not None:
            raise ValueError(
                f"{name} has no stem or bottleneck blocks: stem_pool and fused must "
                f"be None, got {stem_pool!r}, {fused!r}"
            )
        return VGGBackbone(name, layer, dtype, param_dtype, image_size, generator)
    if name not in RESNET_CONFIGS:
        raise ValueError(
            f"unknown backbone {name!r}; the port has "
            f"{sorted(RESNET_CONFIGS) + sorted(VGG_CONFIGS)}"
        )
    if layer not in ("layer2", "layer3", "layer4"):
        raise ValueError(f"layer must be layer2|layer3|layer4, got {layer!r}")
    return ResNetBackbone(
        arch=name, num_stages=int(layer[-1]), dtype=dtype, stem_pool=stem_pool,
        param_dtype=param_dtype, fused=fused,
    )
