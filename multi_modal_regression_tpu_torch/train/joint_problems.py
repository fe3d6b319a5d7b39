"""Joint category + pose objectives (port of the JAX package's
train/joint_problems.py).

  joint_bd        0.1 * Lc_cat + Lc_pose + alpha * Lr_geodesic
                  (learnJointCatPoseModel_top1.py:176-181; variants 1 and 3
                  take the category CE over real images only, variant 2 over
                  all, learnJointCatPoseModel2_weighted.py:171-177)
  joint_reg       0.1 * Lc_cat(real) + Lr_geodesic
                  (learnJointCatPoseModel3_top1.py:156-160)
  elhoseiny_bd    warm-up  Lc_cat(real) + Lc_pose + Lr_mse(residual)
                  main     0.1 * Lc_cat(real) + Lc_pose + 10 * Lr_geodesic
                  (learnElhoseinyBDModel.py:147-150)
  elhoseiny_reg   warm-up  Lc_cat(real) + Lr_mse
                  main     0.1 * Lc_cat(real) + Lr_geodesic
                  (learnElhoseinyRegressionModel.py:122-124,167-169)
  category        CE on the category logits only; decode -> int32 class
                  ids, headline metric the mean per-class accuracy
                  (learnCategorizationModel.py, learnCatGivenPoseModel.py:144)

The targets dict the train step builds carries `class_label` and the
device mask `is_real` besides the problem's own targets. Fixed weights
throughout (no reference joint script self-balances).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch.data.targets import hard_bin_targets
from multi_modal_regression_tpu_torch.losses.primitives import geodesic_aa, mse
from multi_modal_regression_tpu_torch.train.problems import Problem

JOINT_PROBLEMS = ("joint_bd", "joint_reg", "elhoseiny_bd", "elhoseiny_reg", "category")
# the joint problems that train without a pose dictionary
JOINT_DICTIONARY_FREE = ("joint_reg", "elhoseiny_reg", "category")


def masked_cross_entropy(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> torch.Tensor:
    """Softmax CE averaged over the rows where mask is True (0 for none)."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    m = mask.to(nll.dtype)
    return torch.sum(nll * m) / torch.clamp(torch.sum(m), min=1.0)


def _cat_ce(cat_logits, tg, real_only: bool) -> torch.Tensor:
    mask = tg["is_real"] if real_only else torch.ones_like(tg["is_real"])
    return masked_cross_entropy(cat_logits, tg["class_label"], mask)


def _all(tg) -> torch.Tensor:
    return torch.ones_like(tg["is_real"])


def make_joint_problem(
    name: str,
    centers: np.ndarray | None = None,
    device: torch.device | str = "cuda",
    *,
    cat_on_real_only: bool = True,
) -> Problem:
    """A joint problem by name; `centers` the (K, 3) axis-angle dictionary of
    the BD problems, placed on `device` once."""
    if name not in JOINT_PROBLEMS:
        raise ValueError(f"unknown joint problem {name!r}; the port has {JOINT_PROBLEMS}")

    def bd_targets(C):
        def targets(y):
            bins, res = hard_bin_targets(y, C)
            return {"y": y, "bins": bins, "res": res}

        return targets

    if name in ("joint_bd", "elhoseiny_bd"):
        C = torch.as_tensor(np.asarray(centers, np.float32), device=device)
        real_only = cat_on_real_only if name == "joint_bd" else True
        # joint_bd weighs the category CE 0.1 in both phases; elhoseiny_bd 1
        # in warm-up, 0.1 in main
        w_warm = 0.1 if name == "joint_bd" else 1.0

        def warmup(out, tg):
            cat, scores, residual = out
            lc = w_warm * _cat_ce(cat, tg, real_only) + masked_cross_entropy(
                scores, tg["bins"], _all(tg))
            return lc, mse(residual, tg["res"])

        def main(out, tg):
            cat, scores, residual = out
            lc = 0.1 * _cat_ce(cat, tg, real_only) + masked_cross_entropy(
                scores, tg["bins"], _all(tg))
            ind = torch.argmax(scores, dim=-1)
            return lc, geodesic_aa(C[ind] + residual, tg["y"])

        def decode(out):
            _, scores, residual = out
            return C[torch.argmax(scores, dim=-1)] + residual

        return Problem(name, "axis_angle", bd_targets(C), warmup, main, decode,
                       warmup_balance=None, main_balance=None)

    if name in ("joint_reg", "elhoseiny_reg"):
        real_only = cat_on_real_only if name == "joint_reg" else True
        w_warm = 0.1 if name == "joint_reg" else 1.0

        def warmup(out, tg):
            cat, pose = out
            return w_warm * _cat_ce(cat, tg, real_only), mse(pose, tg["y"])

        def main(out, tg):
            cat, pose = out
            return 0.1 * _cat_ce(cat, tg, real_only), geodesic_aa(pose, tg["y"])

        return Problem(name, "axis_angle", lambda y: {"y": y}, warmup, main,
                       lambda out: out[1], warmup_balance=None, main_balance=None)

    # category: the first output of a joint model, or a classifier's logits
    def first(out):
        return out[0] if isinstance(out, tuple) else out

    def losses(out, tg):
        cat = first(out)
        return _cat_ce(cat, tg, True), torch.zeros((), dtype=cat.dtype, device=cat.device)

    return Problem(
        name, "axis_angle", lambda y: {"y": y}, losses, losses,
        lambda out: torch.argmax(first(out), dim=-1).to(torch.int32),
        warmup_balance=None, main_balance=None, metric="category_accuracy",
    )
