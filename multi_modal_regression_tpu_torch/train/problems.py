"""Problems (port of the JAX package's train/problems.py).

Ported problems, all over the one-bin-delta model's (scores, residual):

  geodesic        learnGeodesicBDModel.py:106-205, the north star: hard bin +
                  residual targets; warm-up CE + MSE on the residual; main
                  CE + geodesic loss on the decoded pose, main self-balance
  relaxed_kmeans  ablationXBDModel.py: RBF soft bins over a kmeans
                  dictionary (width gamma), KL in place of CE, fixed weights
                  (no self-balance)
  probabilistic   learnProbabilisticBDModel.py: GMM posterior soft bins;
                  warm-up KL + MSE on the soft residual; main KL + the
                  expected geodesic loss under the softmax posterior; argmax
                  decode over the GMM means

The rest of the problem zoo arrives with its presets (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch.data.targets import (
    gmm_soft_targets,
    hard_bin_targets,
    rbf_soft_targets,
)
from multi_modal_regression_tpu_torch.losses.bin_delta import (
    decode_bin_delta,
    expected_regression,
)
from multi_modal_regression_tpu_torch.losses.primitives import (
    cross_entropy,
    geodesic_aa,
    kl_div_mean,
    mse,
)

PORTED_PROBLEMS = ("geodesic", "relaxed_kmeans", "probabilistic")


@dataclasses.dataclass(frozen=True)
class Problem:
    """A training problem: target transform + (Lc, Lr) losses + decoder.

      targets(y)                 pose batch -> dict of target tensors
      warmup_losses(out, tg)     -> (lc, lr) for the warm-up phase
      main_losses(out, tg)       -> (lc, lr) for the main phase
      decode(out)                -> predicted poses (test protocol)
    `out` is the model output (scores, residual). The balance modes are
    'warmup' | 'main' | None (fixed weights Lc + alpha * Lr).
    """

    name: str
    ydata_type: str
    targets: Callable
    warmup_losses: Callable
    main_losses: Callable
    decode: Callable
    warmup_balance: str | None = "warmup"
    main_balance: str | None = "main"


def make_problem(
    name: str,
    centers: np.ndarray | None = None,
    device: torch.device | str = "cuda",
    *,
    gmm_means: np.ndarray | None = None,
    gmm_covariances: np.ndarray | None = None,
    gmm_weights: np.ndarray | None = None,
    gamma: float = 10.0,
) -> Problem:
    """Build a Problem by name. `centers` is the (K, 3) axis-angle dictionary
    of the kmeans problems; the `gmm_*` arrays are the fitted mixture of the
    probabilistic problem; `gamma` is the RBF width of `relaxed_kmeans`. The
    arrays are placed on `device` once (the card unless the caller asks for
    "cpu")."""
    if name == "probabilistic_multires":
        raise NotImplementedError(
            "the multires probabilistic problem needs "
            "ProbabilisticOneDeltaPerBinModel, which is not ported yet "
            "(see ROADMAP.md)"
        )
    if name not in PORTED_PROBLEMS:
        raise ValueError(
            f"problem {name!r} is not ported yet; the port has "
            f"{list(PORTED_PROBLEMS)} (see ROADMAP.md)"
        )

    def on_device(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    def soft_lc(scores, tg):
        return kl_div_mean(F.log_softmax(scores, dim=-1), tg["soft"])

    if name == "geodesic":
        C = on_device(centers)

        def targets(y):
            bins, res = hard_bin_targets(y, C)
            return {"y": y, "bins": bins, "res": res}

        def warmup(out, tg):
            scores, residual = out
            return cross_entropy(scores, tg["bins"]), mse(residual, tg["res"])

        def main(out, tg):
            # the decode's argmax passes no gradient: Lr reaches the residual only
            scores, residual = out
            ypred = decode_bin_delta(scores, residual, C)
            return cross_entropy(scores, tg["bins"]), geodesic_aa(ypred, tg["y"])

        return Problem(
            name, "axis_angle", targets, warmup, main,
            lambda out: decode_bin_delta(out[0], out[1], C),
        )

    if name == "relaxed_kmeans":
        C = on_device(centers)

        def targets(y):
            soft, res = rbf_soft_targets(y, C, gamma=gamma)
            return {"y": y, "soft": soft, "res": res}

        def warmup(out, tg):
            scores, residual = out
            return soft_lc(scores, tg), mse(residual, tg["res"])

        def main(out, tg):
            scores, residual = out
            ypred = decode_bin_delta(scores, residual, C)
            return soft_lc(scores, tg), geodesic_aa(ypred, tg["y"])

        # the relaxed ablation trains with FIXED weights (alpha), no
        # self-balance scalar anywhere (ablationXBDModel.py:63-170)
        return Problem(
            name, "axis_angle", targets, warmup, main,
            lambda out: decode_bin_delta(out[0], out[1], C),
            warmup_balance=None, main_balance=None,
        )

    mu, cov, w = on_device(gmm_means), on_device(gmm_covariances), on_device(gmm_weights)

    def targets(y):
        resp, res = gmm_soft_targets(y, mu, cov, w)
        return {"y": y, "soft": resp, "res": res}

    def warmup(out, tg):
        scores, residual = out
        return soft_lc(scores, tg), mse(residual, tg["res"])

    def main(out, tg):
        scores, residual = out
        cand = mu[None, :, :] + residual[:, None, :]  # (B, K, D)
        lr = expected_regression(
            scores, cand, tg["y"], lambda p, t: geodesic_aa(p, t, reduce=False)
        )
        return soft_lc(scores, tg), lr

    # argmax decode: dict[argmax] + delta, the reference's LIVE test path; its
    # softmax-expectation decode is commented out
    # (learnProbabilisticBDModel.py:168-181)
    return Problem(
        name, "axis_angle", targets, warmup, main,
        lambda out: decode_bin_delta(out[0], out[1], mu),
    )
