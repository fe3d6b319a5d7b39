"""Regression, classification and class-agnostic pose models (port of the
JAX package's models/pose.py):

  PerClassRegressionModel      per-class model_3layer heads, output
                               nonlinearity 'none' | 'pi_tanh' ('valid') |
                               'my_proj' ('correct') | 'quat'
                               (learnGeodesicRegressionModel.py:84-107,
                                learnGeodesicRegression_quaternion.py:75-95)
  PerClassClassificationModel  per-class bin_3layer heads, bins only
                               (learnClassificationModel.py:71-89)
  IndependentRegressionModel   one shared head, pi*tanh
                               (learnIndependentRegressionModel.py:74-88)
  IndependentBDModel           shared bin head + per-cluster delta heads,
                               class-agnostic (learnIndependentBDModel.py:88-111,
                                learnRenderedBDModel.py:88-111)

Every model is called as model(images, labels), as the bin-delta models
are; the two class-agnostic ones ignore the labels. Their trunks have no
stem or fused conv+BN option, as in the JAX package. Weights are drawn on
the CPU from `seed` and held in `param_dtype` (default: the compute
`dtype`); the models are built in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from multi_modal_regression_tpu_torch.models.bin_delta import make_trunk
from multi_modal_regression_tpu_torch.models.heads import (
    MultiHeadMLP,
    SharedMLP,
    apply_output_nonlinearity,
    select_class,
)


class _BackboneModel(nn.Module):
    """Common fields and the trunk."""

    def _build_trunk(
        self, num_classes: int, N0: int, feature_network: str, feature_layer: str,
        dtype: torch.dtype, seed: int, param_dtype: torch.dtype | None,
    ) -> dict:
        """Set num_classes and the trunk; return the heads' keyword arguments,
        whose generator draws their weights next."""
        g = torch.Generator().manual_seed(seed)
        self.num_classes = num_classes
        self.feature_model = make_trunk(
            feature_network, feature_layer, N0, dtype, g, param_dtype
        )
        return dict(generator=g, dtype=dtype, param_dtype=param_dtype)


class PerClassRegressionModel(_BackboneModel):
    """Per-class 3-layer pose heads; pure regression (no bins).
    forward(x, label) -> poses (B, ndim)."""

    def __init__(
        self, num_classes: int = 12, N0: int = 2048, N1: int = 1000, N2: int = 500,
        ndim: int = 3, nonlinearity: str = "pi_tanh",
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype)
        self.nonlinearity = nonlinearity
        self.pose_models = MultiHeadMLP(N0, num_classes, (N1, N2, ndim), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        y = select_class(self.pose_models(self.feature_model(x)), label)
        # the reference applies the nonlinearity after class selection
        # (learnGeodesicRegressionModel.py:100-105): row-wise, so equal
        return apply_output_nonlinearity(y, self.nonlinearity)


class PerClassClassificationModel(_BackboneModel):
    """Per-class bin heads; the prediction is the dictionary atom at the
    argmax. forward(x, label) -> scores (B, num_clusters)."""

    def __init__(
        self, num_classes: int = 12, N0: int = 2048, N1: int = 1000, N2: int = 500,
        num_clusters: int = 100, feature_network: str = "resnet50",
        feature_layer: str = "layer4", dtype: torch.dtype = torch.float32,
        seed: int = 0, param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype)
        self.pose_models = MultiHeadMLP(
            N0, num_classes, (N1, N2, num_clusters), **kw
        )
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        return select_class(self.pose_models(self.feature_model(x)), label)


class IndependentRegressionModel(_BackboneModel):
    """One shared (class-agnostic) pose head, pi*tanh output.
    forward(x, label) -> poses (B, ndim); `label` is ignored."""

    def __init__(
        self, num_classes: int = 12, N0: int = 2048, N1: int = 1000, N2: int = 500,
        ndim: int = 3, nonlinearity: str = "pi_tanh",
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype)
        self.pose_model = SharedMLP(
            N0, (N1, N2, ndim), output_nonlinearity=nonlinearity, **kw
        )
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        return self.pose_model(self.feature_model(x))


class IndependentBDModel(_BackboneModel):
    """Class-agnostic BD: one bin head + one delta head per cluster; the
    returned delta is the one at the argmax bin.
    forward(x, label) -> scores (B, K), residual (B, ndim); `label` is
    ignored."""

    def __init__(
        self, num_classes: int = 12, N0: int = 2048, N1: int = 1000, N2: int = 500,
        num_clusters: int = 50, N3: int = 100, ndim: int = 3,
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype)
        self.bin_model = SharedMLP(N0, (N1, N2, num_clusters), **kw)
        self.res_models = MultiHeadMLP(N0, num_clusters, (N3, ndim), **kw)
        self.eval()

    def forward(
        self, x: torch.Tensor, label: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.feature_model(x)
        scores = self.bin_model(feat)  # (B, K)
        deltas = self.res_models(feat)  # (B, K, ndim)
        return scores, select_class(deltas, torch.argmax(scores, dim=-1))
