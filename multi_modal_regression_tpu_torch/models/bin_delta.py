"""Bin-and-delta pose models (port of the JAX package's models/bin_delta.py).

Each model is a backbone + per-class head banks returning (scores,
residual), both float32 (at least):

  OneBinDeltaModel                  scores (B, K), residual (B, ndim)
  OneDeltaPerBinModel               scores (B, K), residual (B, ndim): the
                                    delta of the argmax bin
  ProbabilisticOneDeltaPerBinModel  scores (B, K), residuals (B, K, ndim)

Head banks are one batched product each (heads.MultiHeadMLP); class and
bin selection are gathers on the device.
"""

from __future__ import annotations

import torch
from torch import nn

from multi_modal_regression_tpu_torch.models.backbones import (
    VGG_CONFIGS,
    init_conv_weights,
    make_backbone,
)
from multi_modal_regression_tpu_torch.models.heads import MultiHeadMLP, select_class


def make_trunk(
    feature_network: str, feature_layer: str, N0: int, dtype: torch.dtype,
    generator: torch.Generator, param_dtype: torch.dtype | None = None,
    stem_pool: str | None = None, fused_bn: str | None = None,
    image_size: int = 224,
) -> nn.Module:
    """The backbone of a pose model, its weights drawn from `generator`
    (a VGG trunk's fc6 sized for `image_size`); raises if its feature width
    is not N0."""
    vgg = {}
    if feature_network in VGG_CONFIGS:
        vgg = dict(image_size=image_size, generator=generator)
    trunk = make_backbone(
        feature_network, feature_layer, dtype=dtype, stem_pool=stem_pool,
        param_dtype=param_dtype, fused=fused_bn, **vgg,
    )
    if trunk.feature_dim != N0:
        raise ValueError(
            f"N0={N0} but {feature_network}/{feature_layer} gives "
            f"{trunk.feature_dim}-d features"
        )
    init_conv_weights(trunk, generator)
    return trunk


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

    bn_train_scope names the submodules whose BNs may run in training mode
    (None: all of them): `train()` leaves every other submodule in eval
    mode, on its running statistics, and so does the train step
    (train/steps.train_modes). The _rene fine-tunes' model.eval() +
    res_models.train() (learnSimpleBDModel_rene.py:133,148).
    """

    def __init__(
        self, num_classes: int = 12, num_clusters: int = 200, N0: int = 2048,
        N1: int = 1000, N2: int = 500, ndim: int = 3,
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, stem_pool: str | None = None,
        seed: int = 0, param_dtype: torch.dtype | None = None,
        fused_bn: str | None = None, bn_train_scope: tuple[str, ...] | None = None,
        image_size: int = 224,
    ):
        super().__init__()
        g = torch.Generator().manual_seed(seed)  # init draws on the CPU
        self.num_classes = num_classes
        self.bn_train_scope = None if bn_train_scope is None else tuple(bn_train_scope)
        self.feature_model = make_trunk(
            feature_network, feature_layer, N0, dtype, g, param_dtype, stem_pool, fused_bn,
            image_size,
        )
        self.bin_models = MultiHeadMLP(
            N0, num_classes, (N1, N2, num_clusters), generator=g, dtype=dtype,
            param_dtype=param_dtype,
        )
        self.res_models = MultiHeadMLP(
            N0, num_classes, (N1, N2, ndim), generator=g, dtype=dtype,
            param_dtype=param_dtype,
        )
        self.eval()

    def train(self, mode: bool = True) -> "OneBinDeltaModel":
        super().train(mode)
        if mode and self.bn_train_scope is not None:
            for name, child in self.named_children():
                if name not in self.bn_train_scope:
                    child.train(False)
        return self

    def forward(
        self, x: torch.Tensor, label: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.feature_model(x)
        scores = select_class(self.bin_models(feat), label)
        residual = select_class(self.res_models(feat), label)
        return scores, residual


class _DeltaPerBinBase(nn.Module):
    """The multires models' structure (binDeltaModels.py:124-178).

    bin head:   per-class bin_3layer(N0, N1, N2, num_clusters)
    delta bank: one res_2layer(N0, N3, ndim) per (class, cluster) pair, a
                MultiHeadMLP of num_classes * num_clusters heads whose
                deltas are viewed as (B, C, K, ndim) and class-selected.

    Arguments as OneBinDeltaModel's, plus N3.
    """

    def __init__(
        self, num_classes: int = 12, num_clusters: int = 200, N0: int = 2048,
        N1: int = 1000, N2: int = 500, N3: int = 100, ndim: int = 3,
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, stem_pool: str | None = None,
        seed: int = 0, param_dtype: torch.dtype | None = None,
        fused_bn: str | None = None, image_size: int = 224,
    ):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        self.num_classes = num_classes
        self.num_clusters = num_clusters
        self.ndim = ndim
        self.feature_model = make_trunk(
            feature_network, feature_layer, N0, dtype, g, param_dtype, stem_pool, fused_bn,
            image_size,
        )
        self.bin_models = MultiHeadMLP(
            N0, num_classes, (N1, N2, num_clusters), generator=g, dtype=dtype,
            param_dtype=param_dtype,
        )
        self.res_models = MultiHeadMLP(
            N0, num_classes * num_clusters, (N3, ndim), generator=g, dtype=dtype,
            param_dtype=param_dtype,
        )
        self.eval()

    def _scores_and_all_deltas(
        self, x: torch.Tensor, label: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.feature_model(x)
        scores = select_class(self.bin_models(feat), label)  # (B, K)
        deltas = self.res_models(feat)  # (B, C*K, ndim)
        b = deltas.shape[0]
        deltas = deltas.reshape(b, self.num_classes, self.num_clusters * self.ndim)
        deltas = select_class(deltas, label)  # (B, K*ndim)
        return scores, deltas.reshape(b, self.num_clusters, self.ndim)


class OneDeltaPerBinModel(_DeltaPerBinBase):
    """Multires BD: the returned delta is the one at the argmax bin
    (binDeltaModels.py:146-149); no gradient flows through the selection."""

    def forward(
        self, x: torch.Tensor, label: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        scores, deltas = self._scores_and_all_deltas(x, label)
        return scores, select_class(deltas, torch.argmax(scores, dim=-1))


class ProbabilisticOneDeltaPerBinModel(_DeltaPerBinBase):
    """Multires BD returning ALL per-cluster deltas (B, K, ndim) for
    expected-loss training (binDeltaModels.py:154-178)."""

    def forward(
        self, x: torch.Tensor, label: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        return self._scores_and_all_deltas(x, label)
