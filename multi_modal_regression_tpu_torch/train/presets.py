"""Experiment presets (port of the JAX package's train/presets.py).

The port has one preset so far, `geodesic_bd` (learnGeodesicBDModel.py, the
north-star configuration), with the fields its serving path reads. The other
presets raise until they are ported, in the order ROADMAP.md gives.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from multi_modal_regression_tpu_torch.models.bin_delta import OneBinDeltaModel
from multi_modal_regression_tpu_torch.train.problems import Problem, make_problem

PORTED_PRESETS = ("geodesic_bd",)

_COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ExperimentConfig:
    """The fields of the JAX ExperimentConfig that the serving slice reads,
    with the same names and defaults."""

    preset: str = "geodesic_bd"
    feature_network: str = "resnet50"
    feature_layer: str = "layer4"
    num_classes: int = 12
    dict_size: int = 200
    N0: int = 2048
    N1: int = 1000
    N2: int = 500
    ndim: int = 3
    image_size: int = 224
    seed: int = 0
    compute_dtype: str = "float32"  # 'bfloat16' for the serving fast path
    # stem tail in eval mode: None | 'plain' | 'kernel' (the JAX package's
    # None | 'xla' | 'pallas'); see models/backbones.ResNetBackbone
    stem_pool: str | None = None

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


def get_config(preset: str, **overrides) -> ExperimentConfig:
    if preset not in PORTED_PRESETS:
        raise ValueError(
            f"preset {preset!r} is not ported yet; the port has "
            f"{list(PORTED_PRESETS)} (see ROADMAP.md for the order of the rest)"
        )
    return ExperimentConfig(preset=preset, **overrides)


def resolve_compute_dtype(name: str) -> torch.dtype:
    if name not in _COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, got {name!r}"
        )
    return _COMPUTE_DTYPES[name]


def build_model(
    cfg: ExperimentConfig, device: torch.device | str | None = None
) -> OneBinDeltaModel:
    """The preset's model in eval mode, weights drawn from `cfg.seed`."""
    model = OneBinDeltaModel(
        num_classes=cfg.num_classes, num_clusters=cfg.dict_size, N0=cfg.N0,
        N1=cfg.N1, N2=cfg.N2, ndim=cfg.ndim,
        feature_network=cfg.feature_network, feature_layer=cfg.feature_layer,
        dtype=resolve_compute_dtype(cfg.compute_dtype),
        stem_pool=cfg.stem_pool, seed=cfg.seed,
    )
    return model.to(device)


def build_problem(
    cfg: ExperimentConfig, dictionary: Any,
    device: torch.device | str | None = None,
) -> Problem:
    """dictionary: a KMeansDictionary or raw (K, ndim) centers."""
    centers = np.asarray(getattr(dictionary, "cluster_centers", dictionary))
    if centers.shape != (cfg.dict_size, cfg.ndim):
        raise ValueError(
            f"dictionary has shape {centers.shape}, the config expects "
            f"({cfg.dict_size}, {cfg.ndim})"
        )
    return make_problem("geodesic", centers, device)
