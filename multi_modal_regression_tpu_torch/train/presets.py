"""Experiment presets (port of the JAX package's train/presets.py).

The ported presets (`PRESETS`) are the single-model pose zoo: 23 of the
JAX package's 42 reference scripts, over the bin-delta, multires,
regression, classification and class-agnostic models, each with the JAX
package's overrides and comments, over a config that has the fields the
serving and training paths read, under the JAX names and defaults.
Settings that are not ported yet raise NotImplementedError when the config
is made, so none is ignored; the other presets (the `_rene` fine-tunes, the
joint, categorization and ObjectNet models) raise until they are ported, in
the order ROADMAP.md gives.

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
from multi_modal_regression_tpu_torch.models.pose import (
    IndependentBDModel,
    IndependentRegressionModel,
    PerClassClassificationModel,
    PerClassRegressionModel,
)
from multi_modal_regression_tpu_torch.train.problems import (
    DICTIONARY_FREE,
    Problem,
    make_problem,
)
from multi_modal_regression_tpu_torch.train.schedules import EPOCH_LR_FACTORS

# 'float64' exists for the parity tests against the JAX package's x64
# harness (on CPU tensors; the kernels take float32 and bfloat16)
_COMPUTE_DTYPES = {
    "float32": torch.float32, "bfloat16": torch.bfloat16, "float64": torch.float64,
}
# optimizer_dtype -> Adam's mu_dtype (None: the parameters' own dtype)
_MU_DTYPES = {"float32": None, "bfloat16": torch.bfloat16}

# field -> the only value the port runs so far (the JAX package's "off" value)
_NOT_PORTED = {
    "frozen_bn": False,
    "remat": None,
    "train_flip": False,
    "device_resize_from": None,
    "train_only": None,
    "bn_train_only": None,
}


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
    tensorboard: bool = False  # TensorBoard scalars: not ported, True raises
    # snapshot-ensemble evaluation: the cyclical rate's endpoints and the
    # fine-tune's epochs (helperFunctions.py:64,112-118; train/evaluator.py)
    eval_alpha1: float = 1e-6
    eval_alpha2: float = 1e-8
    eval_num_epochs: int = 9
    # not ported yet: setting any of them raises (ROADMAP.md)
    frozen_bn: bool = False
    remat: str | None = None
    train_flip: bool = False
    device_resize_from: int | None = None
    train_only: tuple[str, ...] | None = None
    bn_train_only: tuple[str, ...] | None = None

    def __post_init__(self):
        for name, off in _NOT_PORTED.items():
            if getattr(self, name) != off:
                raise NotImplementedError(
                    f"{name}={getattr(self, name)!r} is not ported yet; the "
                    f"port runs {name}={off!r} (see ROADMAP.md)"
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
        raise ValueError(
            f"preset {preset!r} is not ported yet; the port has "
            f"{sorted(PRESETS)} (see ROADMAP.md for the order of the rest)"
        )
    base = dict(PRESETS[preset])
    base.update(overrides)
    return ExperimentConfig(preset=preset, **base)


def resolve_compute_dtype(name: str) -> torch.dtype:
    if name not in _COMPUTE_DTYPES:
        raise ValueError(
            f"compute_dtype must be one of {sorted(_COMPUTE_DTYPES)}, got {name!r}"
        )
    return _COMPUTE_DTYPES[name]


# model_kind -> the model class; the bin-delta kinds take the trunk's stem
# and fused conv+BN settings, the models/pose kinds have neither (the JAX
# _BackboneModel builds its trunk without them)
_BD_KINDS = {
    "one_bin_delta": OneBinDeltaModel,
    "one_delta_per_bin": OneDeltaPerBinModel,
    "probabilistic": ProbabilisticOneDeltaPerBinModel,
}
_POSE_KINDS = {
    "per_class_regression": PerClassRegressionModel,
    "per_class_classification": PerClassClassificationModel,
    "independent_regression": IndependentRegressionModel,
    "independent_bd": IndependentBDModel,
}


def build_model(
    cfg: ExperimentConfig, device: torch.device | str = "cuda",
    param_dtype: torch.dtype | None = None,
) -> nn.Module:
    """The preset's model (by cfg.model_kind) in eval mode on `device`,
    weights drawn from `cfg.seed` (on the CPU, then moved). Every model is
    called as model(images, labels).

    param_dtype None holds the weights in the compute dtype (serving: no
    per-call cast); training passes at least float32 for master weights,
    as the JAX package keeps its params.
    """
    k = cfg.model_kind
    common = dict(
        num_classes=cfg.num_classes, N0=cfg.N0, N1=cfg.N1, N2=cfg.N2,
        feature_network=cfg.feature_network, feature_layer=cfg.feature_layer,
        dtype=resolve_compute_dtype(cfg.compute_dtype), seed=cfg.seed,
        param_dtype=param_dtype,
    )
    if k in _BD_KINDS:
        extra = {} if k == "one_bin_delta" else dict(N3=cfg.N3)
        model = _BD_KINDS[k](
            **common, **extra, num_clusters=cfg.dict_size, ndim=cfg.ndim,
            stem_pool=cfg.stem_pool, fused_bn=cfg.fused_conv_bn,
        )
    elif k in _POSE_KINDS:
        if cfg.stem_pool is not None or cfg.fused_conv_bn is not None:
            raise ValueError(
                f"model_kind {k!r} has no stem_pool or fused_conv_bn option (its "
                f"trunk is the plain one, as in the JAX package); got stem_pool="
                f"{cfg.stem_pool!r}, fused_conv_bn={cfg.fused_conv_bn!r}"
            )
        if k in ("per_class_regression", "independent_regression"):
            extra = dict(ndim=cfg.ndim, nonlinearity=cfg.nonlinearity)
        elif k == "per_class_classification":
            extra = dict(num_clusters=cfg.dict_size)
        else:
            extra = dict(num_clusters=cfg.dict_size, N3=cfg.N3, ndim=cfg.ndim)
        model = _POSE_KINDS[k](**common, **extra)
    else:
        raise ValueError(
            f"model_kind {k!r} is not ported yet; the port has "
            f"{sorted({**_BD_KINDS, **_POSE_KINDS})} (see ROADMAP.md)"
        )
    return model.to(device)


def build_problem(
    cfg: ExperimentConfig, dictionary: Any = None,
    device: torch.device | str = "cuda",
) -> Problem:
    """dictionary: a GMMDictionary (its means are the atoms), a
    KMeansDictionary or raw (K, 3) axis-angle centers; the quaternion
    problems convert the atoms themselves, and the regression problems take
    none (a dictionary given to them is not read). cfg.gamma None resolves
    to `get_gamma` of the atoms."""
    if cfg.problem in DICTIONARY_FREE:
        problem = make_problem(cfg.problem, None, device)
    else:
        if dictionary is None:
            raise ValueError(
                f"the {cfg.problem!r} problem needs a pose dictionary "
                f"({cfg.dict_size}, 3); fit one with `cli dictionary`"
            )
        gmm_kw: dict = {}
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
        gamma = get_gamma(centers) if cfg.gamma is None else cfg.gamma
        problem = make_problem(
            cfg.problem, centers, device, gamma=gamma, multires=cfg.multires, **gmm_kw
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
    """

    def __init__(self, params: Iterable, lr: float, b1: float = 0.9,
                 b2: float = 0.999, eps: float = 1e-8,
                 mu_dtype: torch.dtype | None = None):
        super().__init__(params, dict(lr=lr, b1=b1, b2=b2, eps=eps))
        self.mu_dtype = mu_dtype

    @torch.no_grad()
    def step(self, closure=None):
        if closure is not None:
            raise ValueError("Adam.step takes no closure")
        for group in self.param_groups:
            params = [p for p in group["params"] if p.grad is not None]
            if not params:
                continue
            lr, b1, b2, eps = group["lr"], group["b1"], group["b2"], group["eps"]
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
            grads = [p.grad for p in params]
            mus = [st["mu"] for st in states]
            nus = [st["nu"] for st in states]
            mu = torch._foreach_mul(grads, 1 - b1)
            if self.mu_dtype is None:
                decayed = torch._foreach_mul(mus, b1)
            else:
                b1_mu = float(torch.tensor(b1, dtype=self.mu_dtype))
                decayed = [
                    m.to(p.dtype) for m, p in zip(torch._foreach_mul(mus, b1_mu), params)
                ]
            torch._foreach_add_(mu, decayed)
            torch._foreach_mul_(nus, b2)
            torch._foreach_add_(
                nus, torch._foreach_mul(torch._foreach_mul(grads, grads), 1 - b2)
            )
            # bias corrections in float32, as optax computes 1 - decay**count
            bc1 = float(np.float32(1) - np.float32(b1) ** np.float32(count))
            bc2 = float(np.float32(1) - np.float32(b2) ** np.float32(count))
            denom = torch._foreach_div(nus, bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, eps)
            upd = torch._foreach_div(mu, bc1)
            torch._foreach_div_(upd, denom)
            torch._foreach_mul_(upd, -lr)
            torch._foreach_add_(params, upd)
            torch._foreach_copy_(mus, mu)
            for st in states:
                st["count"] = count


def build_optimizer(cfg: ExperimentConfig, params: Iterable) -> Adam:
    """Adam at scaled_lr(cfg), b1 0.9, b2 0.999, eps 1e-8, first moment in
    bfloat16 for cfg.optimizer_dtype 'bfloat16', else in the parameters'
    dtype (the JAX build_optimizer without the unported train_only masking,
    which the config refuses). The rate is the optimizer's `lr` of each
    param group, which `Trainer.apply_epoch_lr` sets per main epoch under
    cfg.epoch_lr_decay; the moments are untouched by that."""
    return Adam(
        params, scaled_lr(cfg), mu_dtype=_MU_DTYPES[cfg.optimizer_dtype]
    )
