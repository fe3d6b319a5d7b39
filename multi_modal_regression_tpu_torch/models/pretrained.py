"""Weights from elsewhere -> the port's state_dict: flax variables, local
torchvision ResNet and VGG-bn state_dict files, and the reference's own
trained checkpoints.

`from_jax_variables` takes the JAX package's `params` and `batch_stats`
trees, as nested dicts of numpy arrays (e.g. `jax.device_get(state.params)`),
and returns a state_dict for the port's module of the same structure
(the pose models, `ResNetBackbone`, `VGGBackbone`, `MultiHeadMLP`,
`SharedMLP`, the label-concat heads): module names are the same on both
sides, so only leaf names and layouts change.

  conv `kernel` (kH, kW, I, O)      ->  `weight` (O, I, kH, kW); a VGG
                                        conv's `bias` is copied as it is
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
`downsample_conv` / `downsample_bn`; a vggNN_bn's `features.<i>` are the
port's `conv<j>` / `bn<j>` and `classifier.0` / `classifier.3` its `fc6` /
`fc7`. A missing key raises KeyError.

`load_reference_bd_checkpoint` reads a reference `models/<save_str>.tar`
state_dict (every family the JAX function takes) and returns the port's
state_dict for the config's model: the JAX package's conversion into flax
trees, then `from_jax_variables`.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from multi_modal_regression_tpu_torch.models.backbones import RESNET_CONFIGS, VGG_CONFIGS

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


def load_torchvision_vgg(
    path_or_dict: Any, arch: str = "vgg13", layer: str = "fc6"
) -> dict[str, torch.Tensor]:
    """The trunk state_dict of `VGGBackbone(arch, layer)` from a torchvision
    vggNN_bn state_dict (a path or the dict itself): `features.<i>` conv and
    BN pairs in order, `classifier.0` as fc6 and, at fc7, `classifier.3`."""
    sd = _load_state_dict(path_or_dict)
    out: dict[str, torch.Tensor] = {}

    def take(dst: str, src: str, leaves) -> None:
        for leaf in leaves:
            out[f"{dst}.{leaf}"] = _tensor(np.asarray(sd[f"{src}.{leaf}"]))
        if "running_mean" in leaves:
            out[f"{dst}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)

    ti = conv = 0  # torchvision's features index; the port's conv index
    for v in VGG_CONFIGS[arch]:
        if v == "M":
            ti += 1
            continue
        take(f"conv{conv}", f"features.{ti}", ("weight", "bias"))
        take(f"bn{conv}", f"features.{ti + 1}", _BN_LEAVES)
        ti += 3  # conv, bn, relu
        conv += 1
    take("fc6", "classifier.0", ("weight", "bias"))
    if layer == "fc7":
        take("fc7", "classifier.3", ("weight", "bias"))
    return out


def load_torchvision_backbone(
    path_or_dict: Any, name: str, layer: str = "layer4"
) -> dict[str, torch.Tensor]:
    """Dispatch by backbone name (the make_backbone factory's names); the
    trunk ends at `layer`."""
    if name in RESNET_CONFIGS:
        stages = int(layer[-1]) if layer.startswith("layer") else 4
        return load_torchvision_resnet(path_or_dict, name, stages)
    if name in VGG_CONFIGS:
        return load_torchvision_vgg(path_or_dict, name, layer)
    raise ValueError(f"unknown backbone {name!r}")


# ---------------------------------------------------------------------------
# reference checkpoints (models/<save_str>.tar files)
# ---------------------------------------------------------------------------

# The reference's resnet feature model is nn.Sequential of the first 8
# torchvision children — conv1, bn1, relu, maxpool, layer1..layer4
# (featureModels.py:34); its state_dict keys are positional:
_RESNET_SEQ = {
    "0": "conv1", "1": "bn1",
    "4": "layer1", "5": "layer2", "6": "layer3", "7": "layer4",
}


def _unwrap_reference_features(sd: Mapping, vgg: bool = False) -> dict:
    """The `feature_model.*` keys under torchvision's names, so the backbone
    loaders apply unchanged: a ResNet's positional `features.N...` back onto
    `conv1.weight`, `layer3.0.conv2.weight`, ...; a VGG wrapper's named
    `features` / `classifier` submodules (featureModels.py:55-59) as they
    are. (The JAX function maps a VGG's `features.0`, `.1`, `.4`-`.7` as
    ResNet positions too, so a VGG checkpoint fails there with a KeyError.)"""
    out = {}
    for k, v in sd.items():
        if not k.startswith("feature_model."):
            continue
        rest = k[len("feature_model."):]
        if not vgg and rest.startswith("features."):
            idx, _, tail = rest[len("features."):].partition(".")
            if idx in _RESNET_SEQ:
                name = _RESNET_SEQ[idx]
                out[f"{name}.{tail}" if tail else name] = v
        else:
            out[rest] = v
    return out


def _stack_head_bank(sd: Mapping, prefix: str, num_heads: int,
                     n_layers: int) -> tuple[dict, dict]:
    """Stack `prefix.{i}.fcL/bnL` per-head modules (binDeltaModels.py:16-91
    blocks in nn.ModuleLists) into one MultiHeadMLP bank's flax trees:
    fcL.weight (O, I) x H -> fcL_kernel (H, I, O); bnL x H -> bnL (H, F)
    scale, bias and statistics; the last fc's bias x H -> fcN_bias (H, O)."""
    def stack(fmt: str):
        return np.stack([np.asarray(sd[fmt.format(i)]) for i in range(num_heads)])

    params: dict = {}
    stats: dict = {}
    for li in range(1, n_layers + 1):
        params[f"fc{li}_kernel"] = np.swapaxes(stack(f"{prefix}.{{}}.fc{li}.weight"), 1, 2)
        if li == n_layers:
            params[f"fc{li}_bias"] = stack(f"{prefix}.{{}}.fc{li}.bias")
        else:
            bn = f"{prefix}.{{}}.bn{li}"
            params[f"bn{li}"] = {"scale": stack(bn + ".weight"), "bias": stack(bn + ".bias")}
            stats[f"bn{li}"] = {"mean": stack(bn + ".running_mean"),
                                "var": stack(bn + ".running_var")}
    return params, stats


def _shared_head(sd: Mapping, prefix: str, n_layers: int) -> tuple[dict, dict]:
    """One `prefix.fcL/bnL` shared MLP (the class-agnostic bin_3layer /
    res_3layer blocks, objectnetHelperFunctions.py:110-152) as SharedMLP
    flax trees: fcL.weight (O, I) -> fcL/kernel (I, O), the last fc's
    bias, BN affine and statistics."""
    params: dict = {}
    stats: dict = {}
    for li in range(1, n_layers + 1):
        p = {"kernel": np.asarray(sd[f"{prefix}.fc{li}.weight"]).T}
        if li == n_layers:
            p["bias"] = np.asarray(sd[f"{prefix}.fc{li}.bias"])
        params[f"fc{li}"] = p
        if li < n_layers:
            bn = f"{prefix}.bn{li}"
            params[f"bn{li}"] = {"scale": np.asarray(sd[f"{bn}.weight"]),
                                 "bias": np.asarray(sd[f"{bn}.bias"])}
            stats[f"bn{li}"] = {"mean": np.asarray(sd[f"{bn}.running_mean"]),
                                "var": np.asarray(sd[f"{bn}.running_var"])}
    return params, stats


def _plain_linear(sd: Mapping, prefix: str) -> dict:
    """One bare nn.Linear (the joint scripts' category fc,
    learnJointCatPoseModel_top1.py:104) as a one-layer SharedMLP's tree."""
    return {"fc1": {"kernel": np.asarray(sd[f"{prefix}.weight"]).T,
                    "bias": np.asarray(sd[f"{prefix}.bias"])}}


def _heads(sd: Mapping, cfg) -> tuple[dict, dict]:
    """The head modules' flax trees (params, batch_stats) of cfg's model
    kind, keyed by the port's module names."""
    params: dict = {}
    stats: dict = {}

    def shared(name, n_layers=3):
        params[name], stats[name] = _shared_head(sd, name, n_layers)

    def bank(name, heads, n_layers):
        params[name], stats[name] = _stack_head_bank(sd, name, heads, n_layers)

    k = cfg.model_kind
    if k == "categorization":
        # learnCategorizationModel.py:51-60: a bare nn.Linear named `fc`
        params["category_model"] = _plain_linear(sd, "fc")
    elif k == "labelconcat_bd":
        shared("bin_model")
        shared("res_model")
    elif k in ("labelconcat_delta_per_bin", "independent_bd", "elhoseiny_bd"):
        # shared bin_3layer, one res_2layer per cluster
        # (objectnetHelperFunctions.py:181, learnIndependentBDModel.py:88-108,
        # learnElhoseinyBDModel.py:87-110)
        shared("bin_model")
        bank("res_models", cfg.dict_size, 2)
        if k == "elhoseiny_bd":
            params["category_model"] = _plain_linear(sd, "category_model")
    elif k in ("labelconcat_regression", "labelconcat_classification",
               "independent_regression"):
        shared("pose_model")
    elif k in ("per_class_regression", "per_class_classification"):
        # one model_3layer / bin_3layer per class (learnGeodesicRegressionModel.py:
        # 84-107, learnClassificationModel.py:84-104)
        bank("pose_models", cfg.num_classes, 3)
    elif k == "elhoseiny_reg":
        # learnElhoseinyRegressionModel.py:74-91
        shared("pose_model")
        params["category_model"] = _plain_linear(sd, "category_model")
    elif k == "joint_reg_v3":
        # per-class pose bank + category fc (learnJointCatPoseModel3_top1.py:96-118)
        bank("pose_models", cfg.num_classes, 3)
        params["fc"] = _plain_linear(sd, "fc")
    else:
        bank("bin_models", cfg.num_classes, 3)
        multires = k in ("one_delta_per_bin", "probabilistic") or (
            k == "joint_bd_v1" and cfg.multires)
        if multires:
            # one res_2layer per (class, cluster), class-major, the
            # reference's view(num_classes, num_clusters, ...) (binDeltaModels.py:141)
            bank("res_models", cfg.num_classes * cfg.dict_size, 2)
        elif k in ("one_bin_delta", "joint_bd_v1"):
            bank("res_models", cfg.num_classes, 3)
        else:
            raise ValueError(f"model_kind {k!r} is not a family of the reference's checkpoints")
        if k == "joint_bd_v1":
            # the grafted category head (learnJointCatPoseModel_top1.py:93-104)
            params["fc"] = _plain_linear(sd, "fc")
    return params, stats


def load_reference_bd_checkpoint(path_or_dict: Any, cfg) -> dict[str, torch.Tensor]:
    """The port's state_dict for cfg's model from a reference checkpoint
    (the model.state_dict() `models/<save_str>.tar` files,
    learnGeodesicBDModel.py:231-232; a path or the dict itself).

    The families of the JAX function: the binDeltaModels.py models
    ('one_bin_delta', 'one_delta_per_bin', 'probabilistic'), the four
    ObjectNet label-concat models (objectnetHelperFunctions.py:155-231),
    the class-agnostic independent models, the per-class regression and
    classification models, the Elhoseiny models, the categorization model
    and the grafted joint cat+pose wrappers ('joint_bd_v1', multires by
    cfg.multires; 'joint_reg_v3'). The trunk (ResNet or VGG, by
    cfg.feature_network and cfg.feature_layer) comes from
    `feature_model.*`, the heads by the family's module names.
    """
    sd = _load_state_dict(path_or_dict)
    trunk = load_torchvision_backbone(
        _unwrap_reference_features(sd, vgg=cfg.feature_network in VGG_CONFIGS),
        cfg.feature_network, cfg.feature_layer)
    params, stats = _heads(sd, cfg)
    out = {f"feature_model.{k}": v for k, v in trunk.items()}
    out.update(from_jax_variables(params, stats))
    return out
