"""Joint category + pose models (port of the JAX package's models/joint.py).

The reference's two-stage pipelines graft a category head onto a trained
pose "oracle" and mix the per-class pose heads by the PREDICTED category:

  JointCatPoseBDModel      variant 1: category fc on the shared features
                           (learnJointCatPoseModel_top1.py:93-127,
                            _weighted.py:94-126, _top1_new.py:107-130)
  JointCatPoseBDModel2     variant 2: shared stage-1..3 trunk, a separate
                           layer4 branch for the category
                           (learnJointCatPoseModel2_weighted.py:92-137)
  JointCatPoseRegModel     variant 3: regression oracle, pi*tanh
                           (learnJointCatPoseModel3_top1.py:96-118)
  ElhoseinyBDModel         one-stage multi-task: class-agnostic BD heads +
                           a category linear head (learnElhoseinyBDModel.py:88-111)
  ElhoseinyRegressionModel the same with one regression head
                           (learnElhoseinyRegressionModel.py)

Mixing modes (`mixing`):
  'top1'        a one-hot of argmax(category logits), detached (the
                reference scatters on the CPU)
  'joint_top1'  a detached one-hot of the class at the argmax of the joint
                posterior softmax(bin scores) * softmax(category logits),
                flattened as (C, K) as the JAX package does; multires also
                takes that argmax's bin (_top1_new.py:110-130)
  'top1_st'     straight-through: the forward is top1's one-hot, the
                gradient softmax's
  'weighted'    softmax(category logits), gradients into the category fc

Mixing is one einsum over the class axis of the head banks. Every model is
called as model(images, labels) and ignores the labels. Module names are the
flax names, so models/pretrained.from_jax_variables carries the weights.
Weights are drawn on the CPU from `seed`, held in `param_dtype` (default:
the compute `dtype`); the models are built in eval mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from multi_modal_regression_tpu_torch.models.backbones import (
    ResNetBackbone,
    ResNetStage,
    init_conv_weights,
)
from multi_modal_regression_tpu_torch.models.bin_delta import make_trunk
from multi_modal_regression_tpu_torch.models.heads import (
    MultiHeadMLP,
    SharedMLP,
    apply_output_nonlinearity,
    select_class,
)

MIXINGS = ("top1", "joint_top1", "top1_st", "weighted")


def class_weights(cat_logits: torch.Tensor, mixing: str) -> torch.Tensor:
    """Category logits (B, C) -> mixing weights (B, C) ('top1', 'top1_st',
    'weighted'; 'joint_top1' selects inside the model)."""
    if mixing == "weighted":
        return torch.softmax(cat_logits, dim=-1)
    hard = F.one_hot(torch.argmax(cat_logits, dim=-1), cat_logits.shape[-1]).to(
        cat_logits.dtype)
    if mixing == "top1":
        return hard.detach()
    if mixing == "top1_st":
        soft = torch.softmax(cat_logits, dim=-1)
        return soft + (hard - soft).detach()
    raise ValueError(f"unknown mixing {mixing!r}")


def mix_heads(per_head: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """(B, C, D) head-bank outputs x (B, C) weights -> (B, D)."""
    return torch.einsum("bcd,bc->bd", per_head, weights)


def _per_class_residuals(
    deltas: torch.Tensor, per_head: torch.Tensor, multires: bool,
    num_classes: int, num_clusters: int, ndim: int,
) -> torch.Tensor:
    """(B, C, D) per-class residuals for the analysis protocol; for a
    multires bank ((B, C*K, D) per class x cluster) each class's delta is
    the one at that class's own bin argmax (evaluateJointModel.py:89-98)."""
    if not multires:
        return deltas
    b = deltas.shape[0]
    deltas = deltas.reshape(b, num_classes, num_clusters, ndim)
    ind = torch.argmax(per_head, dim=-1)  # (B, C)
    idx = ind[..., None, None].expand(-1, -1, 1, ndim)
    return torch.gather(deltas, 2, idx)[:, :, 0]


def _check_mixing(mixing: str, allowed=MIXINGS) -> None:
    if mixing not in allowed:
        raise ValueError(f"unknown mixing {mixing!r}; the model takes {allowed}")


class _BDHeads(nn.Module):
    """The BD head banks shared by variants 1 and 2: per-class bin heads,
    per-class (or, multires, per class x cluster) delta heads, the category
    fc; their mixing and the analysis decode."""

    def _build_heads(self, num_classes, num_clusters, N0, N1, N2, N3, ndim, multires,
                     mixing, kw) -> None:
        self.num_classes = num_classes
        self.num_clusters = num_clusters
        self.ndim = ndim
        self.multires = multires
        self.mixing = mixing
        self.bin_models = MultiHeadMLP(N0, num_classes, (N1, N2, num_clusters), **kw)
        if multires:
            self.res_models = MultiHeadMLP(N0, num_classes * num_clusters, (N3, ndim), **kw)
        else:
            self.res_models = MultiHeadMLP(N0, num_classes, (N1, N2, ndim), **kw)
        self.fc = SharedMLP(N0, (num_classes,), **kw)

    def _mix(self, cat_logits, feat):
        per_head = self.bin_models(feat)  # (B, C, K)
        joint_bin = None
        if self.mixing == "joint_top1":
            joint = torch.softmax(per_head, dim=-1) * torch.softmax(cat_logits, dim=-1)[:, :, None]
            flat = torch.argmax(joint.reshape(joint.shape[0], -1), dim=-1)
            joint_bin = flat % self.num_clusters
            w = F.one_hot(flat // self.num_clusters, self.num_classes).to(
                cat_logits.dtype).detach()
        else:
            w = class_weights(cat_logits, self.mixing)
        scores = mix_heads(per_head, w)  # (B, K)
        deltas = self.res_models(feat)
        if self.multires:
            b = deltas.shape[0]
            deltas = deltas.reshape(b, self.num_classes, self.num_clusters, self.ndim)
            deltas = torch.einsum("bckd,bc->bkd", deltas, w)
            ind = torch.argmax(scores, dim=-1) if joint_bin is None else joint_bin
            residual = select_class(deltas, ind)
        else:
            residual = mix_heads(deltas, w)
        return cat_logits, scores, residual

    def _analysis(self, cat_logits, feat):
        per_head = self.bin_models(feat)
        deltas = self.res_models(feat)
        return cat_logits, per_head, _per_class_residuals(
            deltas, per_head, self.multires, self.num_classes, self.num_clusters,
            self.ndim)


class JointCatPoseBDModel(_BDHeads):
    """Variant 1: category fc on the shared trunk features + BD head banks
    mixed by it. forward(x, label) -> (cat_logits (B, C), scores (B, K),
    residual (B, ndim)); multires picks the mixed delta at the argmax bin
    (joint_top1: the joint posterior's bin)."""

    def __init__(
        self, num_classes: int = 12, num_clusters: int = 200, N0: int = 2048,
        N1: int = 1000, N2: int = 500, N3: int = 100, ndim: int = 3,
        multires: bool = False, mixing: str = "top1",
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        _check_mixing(mixing)
        g = torch.Generator().manual_seed(seed)
        self.feature_model = make_trunk(feature_network, feature_layer, N0, dtype, g,
                                        param_dtype, image_size=image_size)
        self._build_heads(num_classes, num_clusters, N0, N1, N2, N3, ndim, multires, mixing,
                          dict(generator=g, dtype=dtype, param_dtype=param_dtype))
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feat = self.feature_model(x)
        return self._mix(self.fc(feat), feat)

    def analysis(self, x: torch.Tensor):
        """The evaluateJointModel.py forward (:82-104): category logits,
        per-class bin scores (B, C, K) and per-class residuals (B, C, D),
        whatever the mixing; multires residuals at each class's own bin
        argmax. Decoded as centers[argmax(scores, -1)] + residuals
        (train/analysis)."""
        feat = self.feature_model(x)
        return self._analysis(self.fc(feat), feat)


class JointCatPoseBDModel2(_BDHeads):
    """Variant 2: a shared stage-1..3 trunk (`feature_trunk`), the pose
    branch the oracle's layer4 (`pose_stage`), the category branch a second
    layer4 (`category_stage`) + fc. The JAX package's runnable reading of
    learnJointCatPoseModel2_*.py (its class docstring): heads at the layer4
    width N0, models/surgery splits a layer4 oracle at layer3."""

    def __init__(
        self, num_classes: int = 12, num_clusters: int = 200, N0: int = 2048,
        N1: int = 1000, N2: int = 500, N3: int = 100, ndim: int = 3,
        multires: bool = False, mixing: str = "weighted", arch: str = "resnet50",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None,
    ):
        super().__init__()
        _check_mixing(mixing, ("top1", "top1_st", "weighted"))
        g = torch.Generator().manual_seed(seed)
        self.feature_trunk = ResNetBackbone(arch, num_stages=3, dtype=dtype,
                                            param_dtype=param_dtype, pool=False)
        self.pose_stage = ResNetStage(arch, 4, dtype=dtype, param_dtype=param_dtype)
        self.category_stage = ResNetStage(arch, 4, dtype=dtype, param_dtype=param_dtype)
        if self.pose_stage.feature_dim != N0:
            raise ValueError(
                f"N0={N0} but {arch}'s layer4 gives {self.pose_stage.feature_dim}-d features"
            )
        for m in (self.feature_trunk, self.pose_stage, self.category_stage):
            init_conv_weights(m, g)
        self._build_heads(num_classes, num_clusters, N0, N1, N2, N3, ndim, multires, mixing,
                          dict(generator=g, dtype=dtype, param_dtype=param_dtype))
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        trunk = self.feature_trunk(x)  # (B, 14, 14, 1024) at 224 px
        cat_logits = self.fc(self.category_stage(trunk))
        return self._mix(cat_logits, self.pose_stage(trunk))

    def analysis(self, x: torch.Tensor):
        """As JointCatPoseBDModel.analysis (evaluateJointModel2.py:85-115)."""
        trunk = self.feature_trunk(x)
        return self._analysis(self.fc(self.category_stage(trunk)), self.pose_stage(trunk))


class JointCatPoseRegModel(nn.Module):
    """Variant 3: regression oracle + category fc. forward(x, label) ->
    (cat_logits (B, C), poses (B, ndim)): the class heads' raw outputs are
    mixed, then the output nonlinearity (learnJointCatPoseModel3_top1.py:113-116)."""

    def __init__(
        self, num_classes: int = 12, N0: int = 2048, N1: int = 1000, N2: int = 500,
        ndim: int = 3, mixing: str = "top1", nonlinearity: str = "pi_tanh",
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        _check_mixing(mixing, ("top1", "top1_st", "weighted"))
        g = torch.Generator().manual_seed(seed)
        kw = dict(generator=g, dtype=dtype, param_dtype=param_dtype)
        self.num_classes = num_classes
        self.mixing = mixing
        self.nonlinearity = nonlinearity
        self.feature_model = make_trunk(feature_network, feature_layer, N0, dtype, g,
                                        param_dtype, image_size=image_size)
        self.pose_models = MultiHeadMLP(N0, num_classes, (N1, N2, ndim), **kw)
        self.fc = SharedMLP(N0, (num_classes,), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feat = self.feature_model(x)
        cat_logits = self.fc(feat)
        y = mix_heads(self.pose_models(feat), class_weights(cat_logits, self.mixing))
        return cat_logits, apply_output_nonlinearity(y, self.nonlinearity)


class ElhoseinyBDModel(nn.Module):
    """One-stage multi-task BD: a class-agnostic bin head, one delta head per
    cluster, a category linear head. forward(x, label) -> (cat_logits (B, C),
    scores (B, K), the delta at the argmax bin (B, ndim))."""

    def __init__(
        self, num_classes: int = 12, num_clusters: int = 50, N0: int = 2048,
        N1: int = 1000, N2: int = 500, N3: int = 100, ndim: int = 3,
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        kw = dict(generator=g, dtype=dtype, param_dtype=param_dtype)
        self.num_classes = num_classes
        self.feature_model = make_trunk(feature_network, feature_layer, N0, dtype, g,
                                        param_dtype, image_size=image_size)
        self.bin_model = SharedMLP(N0, (N1, N2, num_clusters), **kw)
        self.res_models = MultiHeadMLP(N0, num_clusters, (N3, ndim), **kw)
        self.category_model = SharedMLP(N0, (num_classes,), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feat = self.feature_model(x)
        cat_logits = self.category_model(feat)
        scores = self.bin_model(feat)
        return cat_logits, scores, self.res_models(feat, select=torch.argmax(scores, dim=-1))


class ElhoseinyRegressionModel(nn.Module):
    """Multi-task regression: one shared pose head (output nonlinearity
    included) + a category linear head. forward(x, label) -> (cat_logits
    (B, C), poses (B, ndim))."""

    def __init__(
        self, num_classes: int = 12, N0: int = 2048, N1: int = 1000, N2: int = 500,
        ndim: int = 3, nonlinearity: str = "pi_tanh",
        feature_network: str = "resnet50", feature_layer: str = "layer4",
        dtype: torch.dtype = torch.float32, seed: int = 0,
        param_dtype: torch.dtype | None = None, image_size: int = 224,
    ):
        super().__init__()
        g = torch.Generator().manual_seed(seed)
        kw = dict(generator=g, dtype=dtype, param_dtype=param_dtype)
        self.num_classes = num_classes
        self.feature_model = make_trunk(feature_network, feature_layer, N0, dtype, g,
                                        param_dtype, image_size=image_size)
        self.pose_model = SharedMLP(N0, (N1, N2, ndim), output_nonlinearity=nonlinearity,
                                    **kw)
        self.category_model = SharedMLP(N0, (num_classes,), **kw)
        self.eval()

    def forward(self, x: torch.Tensor, label: torch.Tensor):
        feat = self.feature_model(x)
        return self.category_model(feat), self.pose_model(feat)
