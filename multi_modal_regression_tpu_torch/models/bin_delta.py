"""Bin-and-delta pose model (port of `OneBinDeltaModel` in
the JAX package's models/bin_delta.py).

The multires and probabilistic variants wait (ROADMAP.md).
"""

from __future__ import annotations

import torch
from torch import nn

from multi_modal_regression_tpu_torch.models.backbones import (
    init_conv_weights,
    make_backbone,
)
from multi_modal_regression_tpu_torch.models.heads import MultiHeadMLP, select_class


class OneBinDeltaModel(nn.Module):
    """Per-class bin head + per-class delta head (binDeltaModels.py:99-121).

    bin head:   bin_3layer(N0, N1, N2, num_clusters)
    delta head: res_3layer(N0, N1, N2, ndim)

    forward(x (B, H, W, 3), label (B,)) -> scores (B, K), residual (B, ndim),
    both float32 (at least). Weights are drawn on the CPU from a
    torch.Generator seeded with `seed` and held in `param_dtype` (default:
    the compute `dtype`). The model is built in eval mode; its BNs follow
    the module's mode, as flax's `train` argument selects them. `fused_bn`
    is the trunk's fused conv+BN setting (models/backbones.ResNetBackbone).
    """

    def __init__(
        self, num_classes: int = 12, num_clusters: int = 200, N0: int = 2048,
        N1: int = 1000, N2: int = 500, ndim: int = 3,
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, stem_pool: str | None = None,
        seed: int = 0, param_dtype: torch.dtype | None = None,
        fused_bn: str | None = None,
    ):
        super().__init__()
        g = torch.Generator().manual_seed(seed)  # init draws on the CPU
        self.num_classes = num_classes
        self.feature_model = make_backbone(
            feature_network, feature_layer, dtype=dtype, stem_pool=stem_pool,
            param_dtype=param_dtype, fused=fused_bn,
        )
        if self.feature_model.feature_dim != N0:
            raise ValueError(
                f"N0={N0} but {feature_network}/{feature_layer} gives "
                f"{self.feature_model.feature_dim}-d features"
            )
        init_conv_weights(self.feature_model, g)
        self.bin_models = MultiHeadMLP(
            N0, num_classes, (N1, N2, num_clusters), generator=g, dtype=dtype,
            param_dtype=param_dtype,
        )
        self.res_models = MultiHeadMLP(
            N0, num_classes, (N1, N2, ndim), generator=g, dtype=dtype,
            param_dtype=param_dtype,
        )
        self.eval()

    def forward(
        self, x: torch.Tensor, label: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.feature_model(x)
        scores = select_class(self.bin_models(feat), label)
        residual = select_class(self.res_models(feat), label)
        return scores, residual
