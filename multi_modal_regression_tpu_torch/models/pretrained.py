"""Weights from elsewhere -> the port's state_dict: flax variables, and a
local torchvision ResNet state_dict file.

`from_jax_variables` takes the JAX package's `params` and `batch_stats`
trees, as nested dicts of numpy arrays (e.g. `jax.device_get(state.params)`),
and returns a state_dict for the port's module of the same structure
(the pose models, `ResNetBackbone`, `MultiHeadMLP`, `SharedMLP`): module
names are the same on both sides, so only leaf names and layouts change.

  conv `kernel` (kH, kW, I, O)      ->  `weight` (O, I, kH, kW)
  Dense `kernel` (I, O)             ->  Linear `weight` (O, I); its `bias`
                                        is copied as it is
  BN `scale` / `bias`               ->  `weight` / `bias`
  BN stats `mean` / `var`           ->  `running_mean` / `running_var`
  head banks `fc<i>_kernel` (H, I, O), `fc<i>_bias` (H, O), and the
  per-(head, feature) BN arrays (H, F)  ->  copied as they are

Trunk and SharedMLP BNs (1-D statistics) are torch BatchNorm2d / 1d
modules and also get `num_batches_tracked` = 0. Everything is returned as float32;
`load_state_dict` casts to the model's dtypes.

`load_torchvision_backbone` reads a torchvision resnet state_dict (a local
`.pth` file; nothing is downloaded) and returns the port's trunk
state_dict, the same as `from_jax_variables` of the JAX package's
`load_torchvision_resnet` trees: torchvision's `layerL.B.<name>` is the
port's `layerL_B.<name>`, and `downsample.0` / `downsample.1` are
`downsample_conv` / `downsample_bn`. A missing key raises KeyError.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from multi_modal_regression_tpu_torch.models.backbones import RESNET_CONFIGS

_STATS = {"mean": "running_mean", "var": "running_var"}


def _tensor(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, np.float32))  # a writable C-order copy


def _walk(tree: Mapping, prefix: str):
    for name, value in tree.items():
        if isinstance(value, Mapping):
            yield from _walk(value, f"{prefix}{name}.")
        else:
            yield prefix, name, value


def from_jax_variables(params: Mapping, batch_stats: Mapping) -> dict[str, torch.Tensor]:
    """Map flax (params, batch_stats) trees onto the port's state_dict."""
    sd: dict[str, torch.Tensor] = {}
    for prefix, name, value in _walk(params, ""):
        if name == "kernel":
            a = np.asarray(value)
            if a.ndim == 2:  # nn.Dense (I, O) -> nn.Linear (O, I)
                sd[f"{prefix}weight"] = _tensor(a.T)
            elif a.ndim == 4:
                sd[f"{prefix}weight"] = _tensor(a.transpose(3, 2, 0, 1))
            else:
                raise ValueError(
                    f"{prefix}kernel: expected an HWIO conv or (I, O) Dense kernel"
                )
        elif name == "scale":
            sd[f"{prefix}weight"] = _tensor(value)
        else:  # BN `bias`, head-bank fc<i>_kernel / fc<i>_bias
            sd[f"{prefix}{name}"] = _tensor(value)
    for prefix, name, value in _walk(batch_stats, ""):
        if name not in _STATS:
            raise ValueError(f"unexpected batch_stats leaf {prefix}{name}")
        t = _tensor(value)
        sd[f"{prefix}{_STATS[name]}"] = t
        if name == "mean" and t.ndim == 1:
            sd[f"{prefix}num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
    return sd


_BN_LEAVES = ("weight", "bias", "running_mean", "running_var")


def _load_state_dict(path_or_dict: Any) -> Mapping[str, torch.Tensor]:
    if isinstance(path_or_dict, Mapping):
        return path_or_dict
    return torch.load(path_or_dict, map_location="cpu", weights_only=True)


def load_torchvision_resnet(
    path_or_dict: Any, arch: str = "resnet50", num_stages: int = 4
) -> dict[str, torch.Tensor]:
    """The trunk state_dict of `ResNetBackbone(arch, num_stages)` from a
    torchvision resnet state_dict (a path or the dict itself); keys past
    `num_stages` (and torchvision's `fc`) are not read."""
    sd = _load_state_dict(path_or_dict)
    stage_sizes, bottleneck = RESNET_CONFIGS[arch]
    out: dict[str, torch.Tensor] = {}

    def take(dst: str, src: str, leaves) -> None:
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = _tensor(np.asarray(sd[f"{src}.{leaf}"]))
        if "running_mean" in leaves:
            out[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    take("conv1", "conv1", ("weight",))
    take("bn1", "bn1", _BN_LEAVES)
    for stage in range(num_stages):
        for block in range(stage_sizes[stage]):
            t = f"layer{stage + 1}.{block}"
            f = f"layer{stage + 1}_{block}"
            for ci in range(1, (3 if bottleneck else 2) + 1):
                take(f"{f}.conv{ci}", f"{t}.conv{ci}", ("weight",))
                take(f"{f}.bn{ci}", f"{t}.bn{ci}", _BN_LEAVES)
            if f"{t}.downsample.0.weight" in sd:
                take(f"{f}.downsample_conv", f"{t}.downsample.0", ("weight",))
                take(f"{f}.downsample_bn", f"{t}.downsample.1", _BN_LEAVES)
    return out


def load_torchvision_backbone(
    path_or_dict: Any, name: str, layer: str = "layer4"
) -> dict[str, torch.Tensor]:
    """Dispatch by backbone name (the make_backbone factory's names); the
    trunk ends at `layer`. The VGG trunks are not ported yet."""
    if name in RESNET_CONFIGS:
        stages = int(layer[-1]) if layer.startswith("layer") else 4
        return load_torchvision_resnet(path_or_dict, name, stages)
    if name.startswith("vgg"):
        raise NotImplementedError(
            f"{name}: the VGG trunks are not ported yet (ROADMAP.md)"
        )
    raise ValueError(f"unknown backbone {name!r}")
