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
  CategorizationModel          the object-category classifier, one linear
                               head over the trunk (learnCategorizationModel.py)
  LabelConcat*                 the ObjectNet3D models: the trunk's features
                               concatenated with one_hot(label) feed one
                               shared head, no per-class bank
                               (objectnetHelperFunctions.py:155-231)

Every model is called as model(images, labels), as the bin-delta models
are; the class-agnostic ones and the classifier ignore the labels. Their
trunks (ResNet or VGG) have no stem or fused conv+BN option, as in the
JAX package, except the label-concat models' ResNet trunks, which take
`stem_pool` and `fused_bn` as the bin-delta models do (None is the JAX
trunk). Weights are drawn on the CPU from `seed` and held in `param_dtype`
(default: the compute `dtype`); the models are built in eval mode.
"""

from __future__ import annotations

import torch
from torch import nn

from multi_modal_regression_tpu_torch.models.bin_delta import make_trunk
from multi_modal_regression_tpu_torch.models.heads import (
    MultiHeadMLP,
    SharedMLP,
    apply_output_nonlinearity,
)


class _BackboneModel(nn.Module):
    """Common fields and the trunk."""

    def _build_trunk(
        self, num_classes: int, N0: int, feature_network: str, feature_layer: str,
        dtype: torch.dtype, seed: int, param_dtype: torch.dtype | None,
        image_size: int = 224, stem_pool: str | None = None, fused_bn: str | None = None,
    ) -> dict:
        """Set num_classes and the trunk; return the heads' keyword arguments,
        whose generator draws their weights next."""
        g = torch.Generator().manual_seed(seed)
        self.num_classes = num_classes
        self.feature_model = make_trunk(
            feature_network, feature_layer, N0, dtype, g, param_dtype, stem_pool, fused_bn,
            image_size,
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
        param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype, image_size)
        self.nonlinearity = nonlinearity
        self.pose_models = MultiHeadMLP(N0, num_classes, (N1, N2, ndim), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        y = self.pose_models(self.feature_model(x), select=label)
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
        seed: int = 0, param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype, image_size)
        self.pose_models = MultiHeadMLP(
            N0, num_classes, (N1, N2, num_clusters), **kw
        )
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        return self.pose_models(self.feature_model(x), select=label)


class IndependentRegressionModel(_BackboneModel):
    """One shared (class-agnostic) pose head, pi*tanh output.
    forward(x, label) -> poses (B, ndim); `label` is ignored."""

    def __init__(
        self, num_classes: int = 12, N0: int = 2048, N1: int = 1000, N2: int = 500,
        ndim: int = 3, nonlinearity: str = "pi_tanh",
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype, image_size)
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
        param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype, image_size)
        self.bin_model = SharedMLP(N0, (N1, N2, num_clusters), **kw)
        self.res_models = MultiHeadMLP(N0, num_clusters, (N3, ndim), **kw)
        self.eval()

    def forward(
        self, x: torch.Tensor, label: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        feat = self.feature_model(x)
        scores = self.bin_model(feat)  # (B, K)
        return scores, self.res_models(feat, select=torch.argmax(scores, dim=-1))


class CategorizationModel(_BackboneModel):
    """Object-category classifier: one linear head `category_model` over the
    trunk's features. forward(x, label) -> category logits (B, num_classes);
    `label` is ignored."""

    def __init__(
        self, num_classes: int = 12, N0: int = 2048, N1: int = 1000, N2: int = 500,
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        del N1, N2  # the config's head widths; the classifier has one layer
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype, image_size)
        self.category_model = SharedMLP(N0, (num_classes,), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        return self.category_model(self.feature_model(x))


class _LabelConcatBase(_BackboneModel):
    """ObjectNet3D base: the trunk's features (B, N0) concatenated with
    one_hot(label, num_classes) in the features' dtype, (B, N0 + C), feed
    shared heads of N0 + num_classes inputs (2148 for ResNet50 with 100
    classes, 4196 for VGG)."""

    def _concat_trunk(
        self, num_classes: int, N0: int, feature_network: str = "resnet50",
        feature_layer: str = "layer4", dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None, image_size: int = 224,
        stem_pool: str | None = None, fused_bn: str | None = None,
    ) -> tuple[dict, int]:
        """The trunk (`_build_trunk`, with its stem and fused settings); returns
        the heads' keyword arguments and their input width N0 + num_classes."""
        kw = self._build_trunk(num_classes, N0, feature_network, feature_layer, dtype,
                               seed, param_dtype, image_size, stem_pool, fused_bn)
        return kw, self.feature_model.feature_dim + num_classes

    def _features(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        feat = self.feature_model(x)
        onehot = torch.nn.functional.one_hot(label.long(), self.num_classes)
        return torch.cat([feat, onehot.to(feat.dtype)], dim=-1)


class LabelConcatBDModel(_LabelConcatBase):
    """objectnetHelperFunctions.OneBinDeltaModel:155-172: shared bin_3layer
    `bin_model` (N1, N2, K) and res_3layer `res_model` (N1, N2, ndim).
    forward(x, label) -> scores (B, K), residual (B, ndim)."""

    def __init__(self, num_classes: int = 100, N0: int = 2048, N1: int = 1000,
                 N2: int = 500, num_clusters: int = 200, ndim: int = 3, **trunk):
        super().__init__()
        kw, fin = self._concat_trunk(num_classes, N0, **trunk)
        self.bin_model = SharedMLP(fin, (N1, N2, num_clusters), **kw)
        self.res_model = SharedMLP(fin, (N1, N2, ndim), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        z = self._features(x, label)
        return self.bin_model(z), self.res_model(z)


class LabelConcatDeltaPerBinModel(_LabelConcatBase):
    """objectnetHelperFunctions.OneDeltaPerBinModel:175-198: shared bin head
    + one res_2layer (N3, ndim) per cluster, the delta at the argmax bin
    returned (no gradient through the selection).
    forward(x, label) -> scores (B, K), residual (B, ndim)."""

    def __init__(self, num_classes: int = 100, N0: int = 2048, N1: int = 1000,
                 N2: int = 500, num_clusters: int = 16, N3: int = 100, ndim: int = 3,
                 **trunk):
        super().__init__()
        kw, fin = self._concat_trunk(num_classes, N0, **trunk)
        self.bin_model = SharedMLP(fin, (N1, N2, num_clusters), **kw)
        self.res_models = MultiHeadMLP(fin, num_clusters, (N3, ndim), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        z = self._features(x, label)
        scores = self.bin_model(z)
        return scores, self.res_models(z, select=torch.argmax(scores, dim=-1))


class LabelConcatRegressionModel(_LabelConcatBase):
    """objectnetHelperFunctions.RegressionModel:201-215: a shared
    model_3layer `pose_model` with the output nonlinearity (pi*tanh).
    forward(x, label) -> poses (B, ndim)."""

    def __init__(self, num_classes: int = 100, N0: int = 2048, N1: int = 1000,
                 N2: int = 500, ndim: int = 3, nonlinearity: str = "pi_tanh", **trunk):
        super().__init__()
        kw, fin = self._concat_trunk(num_classes, N0, **trunk)
        self.pose_model = SharedMLP(fin, (N1, N2, ndim), output_nonlinearity=nonlinearity,
                                    **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        return self.pose_model(self._features(x, label))


class LabelConcatClassificationModel(_LabelConcatBase):
    """objectnetHelperFunctions.ClassificationModel:218-231: a shared
    bin_3layer `pose_model`, bins only. forward(x, label) -> scores (B, K)."""

    def __init__(self, num_classes: int = 100, N0: int = 2048, N1: int = 1000,
                 N2: int = 500, num_clusters: int = 16, **trunk):
        super().__init__()
        kw, fin = self._concat_trunk(num_classes, N0, **trunk)
        self.pose_model = SharedMLP(fin, (N1, N2, num_clusters), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor) -> torch.Tensor:
        return self.pose_model(self._features(x, label))
