"""Experiment presets (port of the JAX package's train/presets.py).

`PRESETS` holds all 42 of the JAX package's reference scripts: the
single-model pose zoo over the bin-delta, multires, regression,
classification and class-agnostic models, the two-stage and joint
category + pose pipelines (the `_rene` fine-tunes, the joint variants 1-3,
the Elhoseiny multi-task models, categorization and cat-given-pose) and
the five ObjectNet3D presets over the label-concat models, each with the
JAX package's overrides and comments, over a config of the JAX names and
defaults. Every field of the JAX ExperimentConfig runs, on-device resize,
train-time flips, remat and `tensorboard` (scalars in <workdir>/tb, written
by utils/metrics_writer) among them.

`build_model` and `build_problem` place what they build on the card
("cuda") unless the caller names another device, as `Trainer` does.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Iterable

import numpy as np
import torch

from multi_modal_regression_tpu_torch.dictionary.common import get_gamma
from torch import nn

from multi_modal_regression_tpu_torch.models.backbones import FUSED_IMPLS
from multi_modal_regression_tpu_torch.models.bin_delta import (
    OneBinDeltaModel,
    OneDeltaPerBinModel,
    ProbabilisticOneDeltaPerBinModel,
)
from multi_modal_regression_tpu_torch.models.joint import (
    ElhoseinyBDModel,
    ElhoseinyRegressionModel,
    JointCatPoseBDModel,
    JointCatPoseBDModel2,
    JointCatPoseRegModel,
)
from multi_modal_regression_tpu_torch.models.pose import (
    CategorizationModel,
    IndependentBDModel,
    IndependentRegressionModel,
    LabelConcatBDModel,
    LabelConcatClassificationModel,
    LabelConcatDeltaPerBinModel,
    LabelConcatRegressionModel,
    PerClassClassificationModel,
    PerClassRegressionModel,
)
from multi_modal_regression_tpu_torch.ops import adam as adam_ops
from multi_modal_regression_tpu_torch.train.joint_problems import (
    JOINT_DICTIONARY_FREE,
    JOINT_PROBLEMS,
    make_joint_problem,
)
from multi_modal_regression_tpu_torch.train.problems import (
    DICTIONARY_FREE,
    Problem,
    make_problem,
)
from multi_modal_regression_tpu_torch.train.remat import check_mode, use_remat
from multi_modal_regression_tpu_torch.train.schedules import EPOCH_LR_FACTORS

# 'float64' exists for the parity tests against the JAX package's x64
# harness (on CPU tensors; the kernels take float32 and bfloat16)
_COMPUTE_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64,
}
# optimizer_dtype -> Adam's mu_dtype (None: the parameters' own dtype)
_MU_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}


@dataclasses.dataclass
class ExperimentConfig:
    """The fields of the JAX ExperimentConfig that the serving and training
    paths read, with the same names and defaults (except stem_pool and
    fused_conv_bn, whose JAX default 'auto' resolves to off)."""

    preset: str = "geodesic_bd"
    # model
    model_kind: str = "one_bin_delta"  # see build_model
    feature_network: str = "resnet50"
    feature_layer: str = "layer4"
    num_classes: int = 12
    dict_size: int = 200
    N0: int = 2048
    N1: int = 1000
    N2: int = 500
    N3: int = 100
    ndim: int = 3
    nonlinearity: str = "pi_tanh"  # regression models
    multires: bool = False
    # problem / loss
    problem: str = "geodesic"
    self_balance: bool = True  # False -> fixed loss Lc + alpha * Lr
    reset_s_between_phases: bool = True  # s = 0 before the main phase
    alpha: float = 1.0  # fixed main-phase Lr weight when self-balance is off
    warmup_alpha: float = 1.0  # fixed warm-up Lr weight
    # RBF soft-bin width; None -> derived from the dictionary geometry via
    # get_gamma (the ablationXBDModel.py:61-62 protocol)
    gamma: float | None = 10.0
    # joint models: 'top1' | 'joint_top1' | 'top1_st' | 'weighted' (models/joint)
    mixing: str = "top1"
    # train only these top-level modules (None = all); the others' weights
    # stay bit-equal and Adam keeps no moments for them
    # (learnCatGivenPoseModel.py:108-126's frozen oracle; build_optimizer)
    train_only: tuple[str, ...] | None = None
    # BN in training mode only in these top-level modules (None = all);
    # the rest runs on its running statistics in the train step too (the
    # _rene scripts' model.eval() + res_models.train(),
    # learnSimpleBDModel_rene.py:133,148); one_bin_delta only
    bn_train_only: tuple[str, ...] | None = None
    # two loaders (real, render): per-stream BN statistics, two running-stat
    # updates per step, real first (learnGeodesicBDModel.py:116-121)
    bn_per_stream: bool = True
    bn_stream_fused: bool = True  # same semantics; see train/steps.py
    loss_stream_sum: bool = False  # loss_real + loss_render (= 2 x concat mean)
    # optimization (learnGeodesicBDModel.py:41-42,96)
    init_lr: float = 1e-4
    # per-epoch LR decay applied before each MAIN epoch, the reference's
    # scheduler.step()-before-training() pattern (main epoch e runs at
    # init_lr * factor(e+1); warm-up passes at factor(0)=1): 'objectnet' |
    # 'step' | 'inv' (train/schedules.py); None = constant lr
    epoch_lr_decay: str | None = None
    lr_scaling: str = "none"  # 'none' | 'linear' | 'sqrt' in items_per_batch
    lr_scaling_base_items: int = 8
    num_warmup_epochs: int = 1
    num_epochs: int = 3
    items_per_batch: int = 8  # images per loader per step = items * classes
    image_size: int = 224
    max_iterations: int | None = None  # cap on steps per epoch
    eval_batch: int = 96  # test-loader batch (the last one padded)
    eval_every: int = 1000
    seed: int = 0
    compute_dtype: str = "float32"  # 'bfloat16' for the fast path
    # Adam's first moment: 'bfloat16' stores it in bf16 as optax's mu_dtype
    # does (the update runs in f32); 'float32' is the reference's torch Adam
    optimizer_dtype: str = "bfloat16"
    # stem tail: None | 'plain' | 'kernel' (the JAX package's None | 'xla' |
    # 'pallas'); see models/backbones.ResNetBackbone
    stem_pool: str | None = None
    # fused conv+BN bottleneck blocks in training: None | 'plain' | 'kernel'
    # (the JAX package's None | 'xla' | 'pallas'); needs compute_dtype
    # 'bfloat16'; see models/backbones.BottleneckBlock
    fused_conv_bn: str | None = None
    # checkpoints (Trainer.save_checkpoint): the state is copied to the host
    # on the caller's thread, then written on a background thread;
    # Trainer.wait_for_checkpoints() observes completion and failure
    checkpoint_async: bool = True
    tensorboard: bool = False  # TensorBoard scalars in <workdir>/tb beside metrics.jsonl
    # snapshot-ensemble evaluation: the cyclical rate's endpoints and the
    # fine-tune's epochs (helperFunctions.py:64,112-118; train/evaluator.py)
    eval_alpha1: float = 1e-6
    eval_alpha2: float = 1e-8
    eval_num_epochs: int = 9
    # every BN in eval mode through training: running statistics, none
    # updated, one forward over the whole batch (no per-stream split);
    # every trained leaf still trains (learnCategorizationModel.py:66,75)
    frozen_bn: bool = False
    # the backward's rematerialization (train/remat.py): None | 'none' |
    # 'block' | 'stage' | 'conv' | 'dots' | 'nothing'
    remat: str | None = None
    # random horizontal flips in the train step, with the (-az, el, -ct)
    # pose: the train-time form of the reference's offline flipped copies
    train_flip: bool = False
    # the loaders ship images at this size and the steps resize them to
    # image_size on the device (ops/augment); None: the loaders resize
    device_resize_from: int | None = None

    def __post_init__(self):
        check_mode(self.remat)
        if self.device_resize_from is not None and self.device_resize_from <= 0:
            raise ValueError(
                f"device_resize_from must be a positive size, got {self.device_resize_from!r}"
            )
        if self.epoch_lr_decay is not None and self.epoch_lr_decay not in EPOCH_LR_FACTORS:
            raise ValueError(
                f"unknown epoch_lr_decay {self.epoch_lr_decay!r}; "
                f"available: {sorted(EPOCH_LR_FACTORS)}"
            )
        if self.fused_conv_bn is not None:
            if self.fused_conv_bn not in FUSED_IMPLS:
                raise ValueError(
                    f"fused_conv_bn must be None or one of {FUSED_IMPLS}, got "
                    f"{self.fused_conv_bn!r}"
                )
            if self.compute_dtype != "bfloat16":
                raise ValueError(
                    "fused_conv_bn needs compute_dtype='bfloat16' (the fused "
                    f"convs write bf16), got {self.compute_dtype!r}"
                )
        for name in ("train_only", "bn_train_only"):
            v = getattr(self, name)
            if v is not None:
                if isinstance(v, str) or not all(isinstance(m, str) for m in v):
                    raise ValueError(f"{name} must be a tuple of module names, got {v!r}")
                setattr(self, name, tuple(v))
        if self.optimizer_dtype not in _MU_DTYPES:
            raise ValueError(
                f"optimizer_dtype must be one of {sorted(_MU_DTYPES)}, "
                f"got {self.optimizer_dtype!r}"
            )

    def replace(self, **kw) -> "ExperimentConfig":
        return dataclasses.replace(self, **kw)


# The ported presets with the JAX package's overrides (its PRESETS table,
# in its order).
PRESETS: dict[str, dict] = {
    # learnSimpleBDModel.py — CE + MSE(residual), self-balanced throughout
    "simple_bd": dict(
        model_kind="one_bin_delta", problem="simple",
        num_warmup_epochs=0,  # single training() phase (learnSimpleBDModel.py:104)
    ),
    # learnSimpleBDModel_rene.py — fine-tune FRESH delta heads on a frozen
    # classifier-grafted oracle (warm start: models.surgery.
    # graft_classifier_into_bd / cli --warm-start-kind classifier):
    # optimizer over res_models only (:136), model.eval() with
    # res_models.train() (:133,148 — train-mode BN in the delta heads,
    # running stats everywhere else), homoscedastic sigma balance on the
    # raw-residual MSE (:160-170); a StepLR is constructed but its
    # scheduler.step() is commented out (:137,223) — constant lr
    "simple_bd_rene": dict(
        model_kind="one_bin_delta", problem="simple_rene",
        num_warmup_epochs=0,  # single training() phase
        train_only=("res_models",),
        bn_train_only=("res_models",),
    ),
    # learnEuclideanBDModel_rene.py — same protocol, sigma-balanced MSE on
    # the DECODED pose (centers[argmax] + residual, :159-170)
    "euclidean_bd_rene": dict(
        model_kind="one_bin_delta", problem="euclidean_rene",
        num_warmup_epochs=0,  # single training() phase
        train_only=("res_models",),
        bn_train_only=("res_models",),
    ),
    # learnGeodesicBDModel.py — the north-star config
    "geodesic_bd": dict(model_kind="one_bin_delta", problem="geodesic"),
    # learnGeodesicBDModel.py --multires
    "geodesic_bd_multires": dict(
        model_kind="one_delta_per_bin", problem="geodesic", multires=True
    ),
    # learnGeodesicBDModel_quaternion.py
    "geodesic_bd_quaternion": dict(
        model_kind="one_bin_delta", problem="geodesic_quat", ndim=4
    ),
    # learnEuclideanBDModel.py / learnLaplacianBDModel.py
    "euclidean_bd": dict(model_kind="one_bin_delta", problem="euclidean"),
    "laplacian_bd": dict(model_kind="one_bin_delta", problem="laplacian"),
    # learnLogEuclideanModel.py ('m2' tangent residuals)
    "log_euclidean_bd": dict(
        model_kind="one_bin_delta", problem="log_euclidean",
        num_warmup_epochs=0,  # single-phase script (learnLogEuclideanModel.py:111)
    ),
    # learnRiemannianBDModel.py — the one self-balanced two-phase script
    # with NO s=0 reset between training_init() and training()
    "riemannian_bd": dict(
        model_kind="one_bin_delta", problem="riemannian",
        reset_s_between_phases=False,
    ),
    # learnProbabilisticBDModel.py (GMM soft bins, expected loss)
    "probabilistic_bd": dict(
        model_kind="one_bin_delta", problem="probabilistic",
        num_warmup_epochs=0,  # single-phase (learnProbabilisticBDModel.py:106)
        epoch_lr_decay="step",  # StepLR(1, 0.1) stepped at :204
    ),
    "probabilistic_bd_multires": dict(
        model_kind="probabilistic", problem="probabilistic_multires",
        multires=True, num_warmup_epochs=0, epoch_lr_decay="step",
    ),
    # RelaXedProbabilisticLossQ / RelaXedProbabilisticMultiresLossQ
    # (binDeltaLosses.py:149-166,197-208) + XPBDGeneratorQ targets
    # (binDeltaGenerators.py:86-110) — reference-dormant loss variants no
    # learn* script invokes; preset conventions mirror probabilistic_bd
    "probabilistic_bd_quaternion": dict(
        model_kind="one_bin_delta", problem="probabilistic_quat", ndim=4,
        num_warmup_epochs=0, epoch_lr_decay="step",
    ),
    "probabilistic_bd_quaternion_multires": dict(
        model_kind="probabilistic", problem="probabilistic_quat_multires",
        ndim=4, multires=True, num_warmup_epochs=0, epoch_lr_decay="step",
    ),
    # ablationXBDModel.py (RBF-relaxed soft bins)
    "relaxed_bd": dict(
        model_kind="one_bin_delta", problem="relaxed_kmeans",
        self_balance=False,  # fixed-alpha criteria, ablationXBDModel.py:67-69
        epoch_lr_decay="step",  # ablationXBDModel.py:96,218
        loss_stream_sum=True,  # loss_real + loss_render, ablationXBDModel.py:120
    ),
    # learnClassificationModel.py (dict_size=100) / _new.py (200)
    "classification": dict(
        model_kind="per_class_classification", problem="classification",
        dict_size=100, num_warmup_epochs=0,
        epoch_lr_decay="step",  # learnClassificationModel.py:94,167
        loss_stream_sum=True,  # loss_real + loss_render, learnClassificationModel.py:118
    ),
    # learnGeodesicRegressionModel.py (--nonlinearity valid)
    "geodesic_regression": dict(
        model_kind="per_class_regression", problem="regression",
        nonlinearity="pi_tanh",
        epoch_lr_decay="step",  # learnGeodesicRegressionModel.py:114,234
        loss_stream_sum=True,  # loss_real + loss_render, learnGeodesicRegressionModel.py:138,178
    ),
    # learnGeodesicRegression_quaternion.py
    "geodesic_regression_quaternion": dict(
        model_kind="per_class_regression", problem="regression_quat",
        ndim=4, nonlinearity="quat",
        epoch_lr_decay="step",  # learnGeodesicRegression_quaternion.py:99
        loss_stream_sum=True,  # loss_real + loss_render, learnGeodesicRegression_quaternion.py:123,163
    ),
    # learnIndependentRegressionModel.py
    "independent_regression": dict(
        model_kind="independent_regression", problem="regression",
        nonlinearity="pi_tanh",
        epoch_lr_decay="step",  # learnIndependentRegressionModel.py:92
    ),
    # learnIndependentBDModel.py (fixed weights CE+MSE -> CE+10*geodesic)
    "independent_bd": dict(
        model_kind="independent_bd", problem="geodesic",
        dict_size=16,  # learnIndependentBDModel.py:33
        alpha=10.0, self_balance=False,
        epoch_lr_decay="step",  # learnIndependentBDModel.py:115,255
    ),
    # learnRenderedBDModel.py (class-agnostic, dict 16, render+real)
    "rendered_bd": dict(
        model_kind="independent_bd", problem="geodesic", dict_size=16,
        alpha=10.0, self_balance=False,
        epoch_lr_decay="step",  # learnRenderedBDModel.py:115,234
    ),
    # learnJointCatPoseModel_{top1,weighted}.py / _top1_new.py ('joint_top1')
    "joint_cat_pose_top1": dict(
        num_warmup_epochs=0,  # joint scripts fine-tune an oracle: no warm-up phase
        model_kind="joint_bd_v1", problem="joint_bd", mixing="top1",
        self_balance=False, num_epochs=50,  # learnJointCatPoseModel_top1.py:33
        epoch_lr_decay="inv",  # my_schedule 1/(1+ep), learnJointCatPoseModel_top1.py:141,219
    ),
    # the _top1_new variant selects the class (and, multires, the bin) by
    # the argmax of the JOINT posterior softmax(bins)*softmax(cat), with a
    # detached one-hot (learnJointCatPoseModel_top1_new.py:110-130)
    "joint_cat_pose_top1_new": dict(
        num_warmup_epochs=0,  # joint scripts fine-tune an oracle: no warm-up phase
        model_kind="joint_bd_v1", problem="joint_bd", mixing="joint_top1",
        self_balance=False, num_epochs=50,  # learnJointCatPoseModel_top1_new.py:34
        epoch_lr_decay="inv",  # my_schedule 1/(1+ep), learnJointCatPoseModel_top1_new.py:144
    ),
    "joint_cat_pose_weighted": dict(
        num_warmup_epochs=0,  # joint scripts fine-tune an oracle: no warm-up phase
        model_kind="joint_bd_v1", problem="joint_bd", mixing="weighted",
        self_balance=False, num_epochs=50,  # learnJointCatPoseModel_weighted.py:34
        epoch_lr_decay="inv",  # my_schedule 1/(1+ep), learnJointCatPoseModel_weighted.py:140
    ),
    # learnJointCatPoseModel2_{top1,weighted}.py (separate category layer4)
    # NOTE the v2 scripts are the ONLY joint scripts defaulting to
    # init_lr=1e-5 (not 1e-4) and 20 (not 50) epochs
    # (learnJointCatPoseModel2_top1.py:35,38)
    "joint_cat_pose2_top1": dict(
        num_warmup_epochs=0,  # joint scripts fine-tune an oracle: no warm-up phase
        model_kind="joint_bd_v2", problem="joint_bd", mixing="top1",
        self_balance=False, num_epochs=20, init_lr=1e-5,
        epoch_lr_decay="inv",  # my_schedule 1/(1+ep), learnJointCatPoseModel2_top1.py:148,226
    ),
    "joint_cat_pose2_weighted": dict(
        num_warmup_epochs=0,  # joint scripts fine-tune an oracle: no warm-up phase
        model_kind="joint_bd_v2", problem="joint_bd", mixing="weighted",
        self_balance=False, num_epochs=20, init_lr=1e-5,
        epoch_lr_decay="inv",  # my_schedule 1/(1+ep), learnJointCatPoseModel2_weighted.py:147
    ),
    # learnJointCatPoseModel3_{top1,weighted}.py (regression oracle)
    "joint_cat_pose3_top1": dict(
        num_warmup_epochs=0,  # joint scripts fine-tune an oracle: no warm-up phase
        model_kind="joint_reg_v3", problem="joint_reg", mixing="top1",
        self_balance=False, num_epochs=50,  # learnJointCatPoseModel3_top1.py:31
        epoch_lr_decay="inv",  # my_schedule 1/(1+ep), learnJointCatPoseModel3_top1.py:129
    ),
    "joint_cat_pose3_weighted": dict(
        num_warmup_epochs=0,  # joint scripts fine-tune an oracle: no warm-up phase
        model_kind="joint_reg_v3", problem="joint_reg", mixing="weighted",
        self_balance=False, num_epochs=50,  # learnJointCatPoseModel3_weighted.py:31
        epoch_lr_decay="inv",  # my_schedule 1/(1+ep), learnJointCatPoseModel3_weighted.py:127
    ),
    # learnElhoseinyBDModel.py / learnElhoseinyRegressionModel.py
    "elhoseiny_bd": dict(
        model_kind="elhoseiny_bd", problem="elhoseiny_bd",
        dict_size=16,  # learnElhoseinyBDModel.py:33
        alpha=10.0, self_balance=False,
        epoch_lr_decay="step",  # learnElhoseinyBDModel.py:117
    ),
    "elhoseiny_regression": dict(
        model_kind="elhoseiny_reg", problem="elhoseiny_reg",
        self_balance=False,
        epoch_lr_decay="step",  # learnElhoseinyRegressionModel.py:98
    ),
    # learnCategorizationModel.py (12-way category classifier over a FROZEN
    # backbone: requires_grad=False + model.eval() during training, :64-66 —
    # BN runs on running stats and never updates)
    "categorization": dict(
        model_kind="categorization", problem="category", self_balance=False,
        num_epochs=50,  # learnCategorizationModel.py:36
        train_only=("category_model",),
        frozen_bn=True,  # model.eval() through training(), learnCategorizationModel.py:66,75
        epoch_lr_decay="inv",  # LambdaLR 1/(1+ep), learnCategorizationModel.py:69,118
    ),
    # learnCatGivenPoseModel.py — category fc trained on a FROZEN BD oracle
    "cat_given_pose": dict(
        model_kind="joint_bd_v1", problem="category", self_balance=False,
        num_epochs=50,  # learnCatGivenPoseModel.py:33
        train_only=("fc",),
        frozen_bn=True,  # feature_model.eval() + never model.train(), learnCatGivenPoseModel.py:109-117,135
        epoch_lr_decay="inv",  # my_schedule 1/(1+ep), learnCatGivenPoseModel.py:121,127,204
    ),
    # learnCatGivenPoseModel3.py — frozen regression oracle
    "cat_given_pose3": dict(
        model_kind="joint_reg_v3", problem="category", self_balance=False,
        num_epochs=50,  # learnCatGivenPoseModel3.py:30
        train_only=("fc",),
        frozen_bn=True,  # feature_model.eval() + never model.train(), learnCatGivenPoseModel3.py:113-118,135
        epoch_lr_decay="inv",  # learnCatGivenPoseModel3.py:121,127,204
    ),
    # learnObjectnetModel.py — fixed analytic quaternion dictionary, 100
    # classes, label-concat heads, single (real-only) train loader
    "objectnet_quat": dict(
        model_kind="labelconcat_bd", problem="objectnet_quat",
        num_classes=100, dict_size=16, ndim=4, alpha=10.0,
        num_epochs=10,  # learnObjectnetModel.py:32
        self_balance=False, epoch_lr_decay="objectnet",
    ),
    # learnObjectnetBDModel.py (axis-angle, learned kmeans dictionary)
    "objectnet_bd": dict(
        model_kind="labelconcat_bd", problem="geodesic",
        num_classes=100, alpha=10.0, self_balance=False,
        num_epochs=10,  # learnObjectnetBDModel.py:30
        epoch_lr_decay="objectnet",  # scheduler.step() at :190
    ),
    "objectnet_bd_multires": dict(
        model_kind="labelconcat_delta_per_bin", problem="geodesic",
        # dict_size 16: the script builds OneDeltaPerBinModel(num_classes)
        # with the ctor default 16 heads (:83, objectnetHelperFunctions.py:176)
        # — runnable only with a 16-atom dictionary (--dict_size 16); the
        # argparse default 200 would CE-index past the 16 bin scores
        num_classes=100, dict_size=16, alpha=10.0, self_balance=False,
        num_epochs=10,
        epoch_lr_decay="objectnet",
    ),
    # learnObjectnetRegressionModel.py / learnObjectnetClassificationModel.py
    # — NO epoch LR decay: both scripts comment their scheduler.step() out
    # (learnObjectnetRegressionModel.py:162, learnObjectnetClassificationModel.py:145)
    "objectnet_regression": dict(
        model_kind="labelconcat_regression", problem="regression",
        num_classes=100, self_balance=False,
        num_epochs=10,  # learnObjectnetRegressionModel.py:26
    ),
    "objectnet_classification": dict(
        model_kind="labelconcat_classification", problem="classification",
        # dict_size 200: the script passes args.dict_size (default 200,
        # :29) into ClassificationModel(:80), overriding the ctor's 16
        num_classes=100, dict_size=200, self_balance=False,
        num_epochs=10,  # learnObjectnetClassificationModel.py:28
        num_warmup_epochs=0,  # single-phase (learnObjectnetClassificationModel.py:89)
    ),
    # ablationGeodesicBDModel.py — geodesic BD evaluated on the val split
    # (model selection); identical objective, ablation data split
    "ablation_geodesic_bd": dict(
        model_kind="one_bin_delta", problem="geodesic", self_balance=False,
        epoch_lr_decay="step",  # ablationGeodesicBDModel.py:95,217
        loss_stream_sum=True,  # loss_real + loss_render, ablationGeodesicBDModel.py:117
    ),
    # ablationXBDModel.py — relaxed soft bins with data-driven gamma
    # (get_gamma over the dictionary, ablationXBDModel.py:61-62)
    "ablation_xbd": dict(
        model_kind="one_bin_delta", problem="relaxed_kmeans", gamma=None,
        dict_size=100,  # ablationXBDModel.py:34 (GMM dictionary, not the usual 200)
        self_balance=False,  # fixed-alpha criteria, ablationXBDModel.py:67-69
        epoch_lr_decay="step",  # ablationXBDModel.py:96,218
        loss_stream_sum=True,  # loss_real + loss_render, ablationXBDModel.py:120
    ),
    # ablationGBDAugmentation.py — same objective; the augmented-vs-render
    # data selection is the loader choice (--type real/render/both)
    "ablation_gbd_augmentation": dict(
        model_kind="one_bin_delta", problem="geodesic", self_balance=False,
        dict_size=100,  # ablationGBDAugmentation.py:34 (not the usual 200)
        epoch_lr_decay="step",  # ablationGBDAugmentation.py:99,205
    ),
    # ablationDictionarySizeC0.py — classification-only dict-size sweep
    "ablation_c0": dict(
        model_kind="per_class_classification", problem="classification",
        num_warmup_epochs=0,
        epoch_lr_decay="step",  # ablationDictionarySizeC0.py:97,168
        loss_stream_sum=True,  # loss_real + loss_render, ablationDictionarySizeC0.py:120
    ),
}


def get_config(preset: str, **overrides) -> ExperimentConfig:
    if preset not in PRESETS:
        raise ValueError(f"unknown preset {preset!r}; available: {sorted(PRESETS)}")
    base = dict(PRESETS[preset])
    base.update(overrides)
    return ExperimentConfig(preset=preset, **base)


def resolve_compute_dtype(name: str) -> torch.dtype:
    if name not in _COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, got {name!r}"
        )
    return _COMPUTE_DTYPES[name]


# model_kind -> the model class; the bin-delta and label-concat kinds take
# the trunk's stem and fused conv+BN settings (None: the JAX package's
# trunk), the other models/pose and models/joint kinds have neither (the
# JAX _BackboneModel and joint models build their trunk without them,
# joint.py:96-99)
_BD_KINDS = {
    "one_bin_delta": OneBinDeltaModel,
    "one_delta_per_bin": OneDeltaPerBinModel,
    "probabilistic": ProbabilisticOneDeltaPerBinModel,
}
_CONCAT_KINDS = {
    "labelconcat_bd": LabelConcatBDModel,
    "labelconcat_delta_per_bin": LabelConcatDeltaPerBinModel,
    "labelconcat_regression": LabelConcatRegressionModel,
    "labelconcat_classification": LabelConcatClassificationModel,
}
_POSE_KINDS = {
    "per_class_regression": PerClassRegressionModel,
    "per_class_classification": PerClassClassificationModel,
    "independent_regression": IndependentRegressionModel,
    "independent_bd": IndependentBDModel,
    "categorization": CategorizationModel,
    "joint_bd_v1": JointCatPoseBDModel,
    "joint_bd_v2": JointCatPoseBDModel2,
    "joint_reg_v3": JointCatPoseRegModel,
    "elhoseiny_bd": ElhoseinyBDModel,
    "elhoseiny_reg": ElhoseinyRegressionModel,
}


def _kind_args(cfg: ExperimentConfig) -> dict:
    """The arguments of a models/pose or models/joint kind beyond the common ones."""
    k = cfg.model_kind
    reg = dict(ndim=cfg.ndim, nonlinearity=cfg.nonlinearity)
    bd = dict(num_clusters=cfg.dict_size, N3=cfg.N3, ndim=cfg.ndim)
    return {
        "per_class_regression": reg,
        "independent_regression": reg,
        "per_class_classification": dict(num_clusters=cfg.dict_size),
        "independent_bd": bd,
        "categorization": {},
        "joint_bd_v1": dict(bd, multires=cfg.multires, mixing=cfg.mixing),
        "joint_bd_v2": dict(bd, multires=cfg.multires, mixing=cfg.mixing),
        "joint_reg_v3": dict(reg, mixing=cfg.mixing),
        "elhoseiny_bd": bd,
        "elhoseiny_reg": reg,
        "labelconcat_bd": dict(num_clusters=cfg.dict_size, ndim=cfg.ndim),
        "labelconcat_delta_per_bin": bd,
        "labelconcat_regression": reg,
        "labelconcat_classification": dict(num_clusters=cfg.dict_size),
    }[k]


def build_model(
    cfg: ExperimentConfig, device: torch.device | str = "cuda",
    param_dtype: torch.dtype | None = None,
) -> nn.Module:
    """The preset's model (by cfg.model_kind) in eval mode on `device`,
    weights drawn from `cfg.seed` (on the CPU, then moved). Every model is
    called as model(images, labels).

    param_dtype None holds the weights in the compute dtype (serving: no
    per-call cast); training passes at least float32 for master weights,
    as the JAX package keeps its params. The trunks take cfg.remat's
    segments (train/remat.use_remat), which apply when gradients are on.
    """
    k = cfg.model_kind
    common = dict(
        num_classes=cfg.num_classes, N0=cfg.N0, N1=cfg.N1, N2=cfg.N2,
        feature_network=cfg.feature_network, feature_layer=cfg.feature_layer,
        dtype=resolve_compute_dtype(cfg.compute_dtype), seed=cfg.seed,
        param_dtype=param_dtype, image_size=cfg.image_size,
    )
    if cfg.bn_train_only is not None and k != "one_bin_delta":
        raise ValueError(
            "bn_train_only is only supported for model_kind 'one_bin_delta' "
            "(the _rene fine-tune scripts)"
        )
    if k in _BD_KINDS:
        extra = dict(bn_train_scope=cfg.bn_train_only) if k == "one_bin_delta" else dict(
            N3=cfg.N3)
        model = _BD_KINDS[k](
            **common, **extra, num_clusters=cfg.dict_size, ndim=cfg.ndim,
            stem_pool=cfg.stem_pool, fused_bn=cfg.fused_conv_bn,
        )
    elif k in _CONCAT_KINDS:
        model = _CONCAT_KINDS[k](
            **common, **_kind_args(cfg), stem_pool=cfg.stem_pool,
            fused_bn=cfg.fused_conv_bn,
        )
    elif k in _POSE_KINDS:
        if cfg.stem_pool is not None or cfg.fused_conv_bn is not None:
            raise ValueError(
                f"model_kind {k!r} has no stem_pool or fused_conv_bn option (its "
                f"trunk is the plain one, as in the JAX package); got stem_pool="
                f"{cfg.stem_pool!r}, fused_conv_bn={cfg.fused_conv_bn!r}"
            )
        if k == "joint_bd_v2":
            # a stage-1..3 trunk and two layer4 stages of feature_network
            # (ResNet only, whose shapes do not follow the image size)
            common.pop("feature_layer")
            common.pop("image_size")
            common["arch"] = common.pop("feature_network")
        model = _POSE_KINDS[k](**common, **_kind_args(cfg))
    else:
        raise ValueError(
            f"unknown model_kind {k!r}; the port has "
            f"{sorted({**_BD_KINDS, **_CONCAT_KINDS, **_POSE_KINDS})}"
        )
    return use_remat(model, cfg.remat).to(device)


def build_problem(
    cfg: ExperimentConfig, dictionary: Any = None,
    device: torch.device | str = "cuda",
) -> Problem:
    """dictionary: a GMMDictionary (its means are the atoms), a
    KMeansDictionary or raw (K, 3) axis-angle centers; the quaternion
    problems convert the atoms themselves, and the regression problems take
    none (a dictionary given to them is not read). cfg.gamma None resolves
    to `get_gamma` of the atoms. The joint problems (train/joint_problems)
    take the atoms for their BD forms; variant 2 takes its category CE over
    all images, the others over real ones
    (learnJointCatPoseModel2_weighted.py:171 against _top1.py:176)."""
    centers, gmm_kw = None, {}
    if cfg.problem not in DICTIONARY_FREE + JOINT_DICTIONARY_FREE:
        if dictionary is None:
            raise ValueError(
                f"the {cfg.problem!r} problem needs a pose dictionary "
                f"({cfg.dict_size}, 3); fit one with `cli dictionary`"
            )
        if hasattr(dictionary, "means"):  # GMM
            gmm_kw = dict(
                gmm_means=dictionary.means,
                gmm_covariances=dictionary.covariances,
                gmm_weights=dictionary.weights,
            )
            centers = np.asarray(dictionary.means)
        else:
            centers = np.asarray(getattr(dictionary, "cluster_centers", dictionary))
        if centers.shape != (cfg.dict_size, 3):
            raise ValueError(
                f"dictionary has shape {centers.shape}, the config expects an "
                f"axis-angle dictionary ({cfg.dict_size}, 3)"
            )
        if cfg.problem in ("probabilistic", "probabilistic_multires") and not gmm_kw:
            raise ValueError(
                f"the {cfg.problem!r} problem needs a GMMDictionary (means, "
                "covariances, weights); fit one with dictionary.fit_gmm"
            )
    if cfg.problem in JOINT_PROBLEMS:
        problem = make_joint_problem(cfg.problem, centers, device,
                                     cat_on_real_only=cfg.model_kind != "joint_bd_v2")
    else:
        gamma = cfg.gamma
        if gamma is None and centers is not None:
            gamma = get_gamma(centers)
        problem = make_problem(
            cfg.problem, centers, device, gamma=10.0 if gamma is None else gamma,
            multires=cfg.multires, **gmm_kw,
        )
    if not cfg.self_balance:
        problem = dataclasses.replace(
            problem, warmup_balance=None, main_balance=None
        )
    return problem


def scaled_lr(cfg: ExperimentConfig) -> float:
    """init_lr adjusted by the global-batch scaling rule (cfg.lr_scaling):
    k = items_per_batch / lr_scaling_base_items; 'linear' -> k * init_lr,
    'sqrt' -> sqrt(k) * init_lr, 'none' -> init_lr."""
    if cfg.lr_scaling == "none":
        return cfg.init_lr
    k = cfg.items_per_batch / cfg.lr_scaling_base_items
    if cfg.lr_scaling == "linear":
        return cfg.init_lr * k
    if cfg.lr_scaling == "sqrt":
        return cfg.init_lr * float(np.sqrt(k))
    raise ValueError(f"unknown lr_scaling {cfg.lr_scaling!r}")


class Adam(torch.optim.Optimizer):
    """Adam with optax's update formula and first-moment dtype.

    Per parameter, with count t (optax.scale_by_adam, then
    scale_by_learning_rate and apply_updates):

        mu  = (1 - b1) * g + b1 * mu
        nu  = (1 - b2) * g**2 + b2 * nu
        p  += -lr * (mu / (1 - b1**t)) / (sqrt(nu / (1 - b2**t)) + eps)

    The update runs in the parameters' dtype (float32 master weights). The
    stored mu takes `mu_dtype` (None: the parameter's dtype): as under
    optax's mu_dtype, b1 * mu is computed in that dtype with b1 itself
    rounded to it (XLA's weak-typed scalar; bf16 0.8984375), and the new mu
    is rounded to it once per step, after the update used it.
    torch.optim.Adam computes the same float32 step in another rounding
    order. Moments live in `self.state[p]` and are cleared with it.

    The update is ops/adam.adam_update: on the card the one-pass kernel,
    one launch a param group, in a span `mmr.optim.adam_fused` (float32
    parameters whose gradient and moments share their layout, `fusable`;
    any other parameter there raises ValueError); on the CPU, float64
    included, the foreach passes (`adam_update_plain`). Both give the same
    bits. `fused_share` is the share of the last step's updated elements
    that the kernel took.

    `capture_update` captures the kernel launches of an update over the
    tensors the groups hold (ops/adam.CapturedUpdate); step() then replays
    them while the parameters, gradients and moments are those tensors and
    b1, b2, eps unchanged, writing each step's rate and bias corrections to
    the card first (train/steps.GraphedTrainStep captures it with the
    step). The counts and every host value stay as the eager step keeps
    them.
    """

    def __init__(self, params: Iterable, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype | None = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.mu_dtype = mu_dtype
        self.fused_share = 0.0
        # the update capture_update made, which step() replays (None: none)
        self.captured: adam_ops.CapturedUpdate | None = None

    def _due(self) -> list[tuple]:
        """(group, params, states, count) of each param group with
        gradients: its parameters that have one, their states (created on a
        parameter's first step) and the count they step to."""
        due = []
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            for p in params:
                if not self.state[p]:
                    self.state[p]["count"] = 0
                    self.state[p]["mu"] = torch.zeros_like(
                        p, dtype=self.mu_dtype or p.dtype,
                        memory_format=torch.preserve_format,
                    )
                    self.state[p]["nu"] = torch.zeros_like(
                        p, memory_format=torch.preserve_format
                    )
            states = [self.state[p] for p in params]
            count = states[0]["count"] + 1
            if any(st["count"] + 1 != count for st in states):
                raise RuntimeError("Adam: parameters of one group at different steps")
            due.append((group, params, states, count))
        return due

    def _lists(self, due: list[tuple]) -> list[tuple]:
        """CapturedUpdate's groups: tensors and constants of each due group."""
        return [(params, [p.grad for p in params], [st["mu"] for st in states],
                 [st["nu"] for st in states], group["b1"], group["b2"], group["eps"],
                 self.mu_dtype) for group, params, states, _ in due]

    @staticmethod
    def _bias_corrections(group: dict, count: int) -> tuple[float, float]:
        # in float32, as optax computes 1 - decay**count
        return (float(np.float32(1) - np.float32(group["b1"]) ** np.float32(count)),
                float(np.float32(1) - np.float32(group["b2"]) ** np.float32(count)))

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        due = self._due()
        total = sum(p.numel() for _, params, _, _ in due for p in params)
        if self.captured is not None and self.captured.covers(self._lists(due)):
            self.captured.replay(torch.stack([
                adam_ops.kernel_step(group["lr"], *self._bias_corrections(group, count))
                for group, _, _, count in due]))
            fused = total
            for _, _, states, count in due:
                for st in states:
                    st["count"] = count
        else:
            fused = 0
            for group, params, states, count in due:
                bc1, bc2 = self._bias_corrections(group, count)
                fused += adam_ops.adam_update(
                    params, [p.grad for p in params], [st["mu"] for st in states],
                    [st["nu"] for st in states], lr=group["lr"], b1=group["b1"],
                    b2=group["b2"], eps=group["eps"], bc1=bc1, bc2=bc2,
                    mu_dtype=self.mu_dtype,
                )
                for st in states:
                    st["count"] = count
        self.fused_share = fused / total if total else 0.0

    def ready_to_capture(self) -> bool:
        """Whether every parameter with a gradient has its moments (an
        update can be captured: it creates none)."""
        with_grad = [p for group in self.param_groups for p in group["params"]
                     if p.grad is not None]
        return bool(with_grad) and all(self.state[p] for p in with_grad)

    @torch.no_grad()
    def capture_update(self, pool=None) -> None:
        """Capture the update of the parameters that have gradients now, over
        their gradients and moments as they are (ops/adam.CapturedUpdate, in
        the graph memory pool `pool`), for step() to replay. Runs nothing;
        ValueError where the kernel cannot take a parameter."""
        if not self.ready_to_capture():
            raise ValueError("capture_update needs the moments of every parameter with "
                             "a gradient (one eager step first)")
        self.captured = None
        self.captured = adam_ops.CapturedUpdate(self._lists(self._due()), pool)

    def holds_update(self) -> bool:
        """Whether the captured update's parameters and moments are still the
        groups' and their states' (the gradients are checked at step())."""
        c = self.captured
        if c is None:
            return False
        state = self.state
        return all(state[p].get("mu") is mu and state[p].get("nu") is nu
                   for params, _, mus, nus in c.tensors
                   for p, mu, nu in zip(params, mus, nus))


def trained_parameters(cfg: ExperimentConfig, model: nn.Module) -> list[nn.Parameter]:
    """The parameters that train: all of the model's, or with cfg.train_only
    those of the named top-level modules (the JAX build_optimizer's
    optax.set_to_zero outside them). An unknown name raises."""
    if cfg.train_only is None:
        return list(model.parameters())
    children = dict(model.named_children())
    unknown = [n for n in cfg.train_only if n not in children]
    if unknown:
        raise ValueError(
            f"train_only names {unknown}, which the {cfg.model_kind!r} model does not "
            f"have; its modules are {sorted(children)}"
        )
    return [p for n in cfg.train_only for p in children[n].parameters()]


def build_optimizer(cfg: ExperimentConfig, model: nn.Module | Iterable) -> Adam:
    """Adam at scaled_lr(cfg), b1 0.9, b2 0.999, eps 1e-8, first moment in
    bfloat16 for cfg.optimizer_dtype 'bfloat16', else in the parameters'
    dtype, over `trained_parameters(cfg, model)` (a model), or over the
    parameters given (an iterable; cfg.train_only then needs the model).
    Frozen leaves are not in the optimizer: the train step computes no
    gradient for them, Adam keeps no moments for them and they stay
    bit-equal, as under the JAX package's optax.multi_transform. The rate is
    the optimizer's `lr` of each param group, which `Trainer.apply_epoch_lr`
    sets per main epoch under cfg.epoch_lr_decay; the moments are untouched
    by that."""
    if isinstance(model, nn.Module):
        params = trained_parameters(cfg, model)
    elif cfg.train_only is not None:
        raise ValueError("train_only needs the model, to find its named modules")
    else:
        params = model
    return Adam(
        params, scaled_lr(cfg), mu_dtype=_MU_DTYPES[cfg.optimizer_dtype]
    )
