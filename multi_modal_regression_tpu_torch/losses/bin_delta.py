"""Bin-delta losses: classification term + weighted regression term (port
of the JAX package's losses/bin_delta.py).

All variants share the shape L = Lc(bin scores) + alpha * Lr(pose
regression); they differ in what Lc and Lr are and how the predicted pose
is decoded from (scores, residual) and the dictionary. Per-cluster
expectation losses are one batched computation over the cluster axis.

Decode semantics: `centers[argmax(scores)] + residual`. The argmax
selection carries no gradient; gradients flow through the residual and, in
the geodesic variants, through the decoded pose into the regression loss.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch.geometry.so3 import exp_so3
from multi_modal_regression_tpu_torch.losses.primitives import (
    cross_entropy,
    geodesic_rotmat,
    kl_div_mean,
    mse,
)
from multi_modal_regression_tpu_torch.models.heads import select_class

LossFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]


def decode_bin_delta(
    scores: torch.Tensor, residual: torch.Tensor, centers: torch.Tensor
) -> torch.Tensor:
    """Predicted pose = dictionary atom at the argmax bin + residual.

    torch.argmax returns the first maximal index on ties, as jnp.argmax does.
    """
    return centers[torch.argmax(scores, dim=-1)] + residual


def simple_loss(
    scores: torch.Tensor, residual: torch.Tensor, bin_true: torch.Tensor,
    res_true: torch.Tensor, alpha: float = 1.0,
) -> torch.Tensor:
    """CE on bins + alpha * MSE on the raw residual (SimpleLoss / loss_m0)."""
    return cross_entropy(scores, bin_true) + alpha * mse(residual, res_true)


def bd_loss(
    scores: torch.Tensor, residual: torch.Tensor, bin_true: torch.Tensor,
    y_true: torch.Tensor, centers: torch.Tensor, alpha: float = 1.0,
    regression_loss: LossFn = mse,
) -> torch.Tensor:
    """CE on bins + alpha * regression loss on the decoded pose.

    regression_loss = mse -> EuclideanBD, l1 -> LaplacianBD, geodesic_aa /
    geodesic_quat -> GeodesicBD (axis-angle / quaternion).
    """
    lc = cross_entropy(scores, bin_true)
    lr = regression_loss(decode_bin_delta(scores, residual, centers), y_true)
    return lc + alpha * lr


def relaxed_simple_loss(
    scores: torch.Tensor, residual: torch.Tensor, soft_bins: torch.Tensor,
    res_true: torch.Tensor, alpha: float = 1.0,
) -> torch.Tensor:
    """KL vs soft bin targets + alpha * MSE on residual (SimpleRelaXedLoss)."""
    lc = kl_div_mean(F.log_softmax(scores, dim=-1), soft_bins)
    return lc + alpha * mse(residual, res_true)


def relaxed_bd_loss(
    scores: torch.Tensor, residual: torch.Tensor, soft_bins: torch.Tensor,
    y_true: torch.Tensor, centers: torch.Tensor, alpha: float = 1.0,
    regression_loss: LossFn = mse,
) -> torch.Tensor:
    """KL vs soft bins + alpha * regression on the decoded pose (RelaXedLoss)."""
    lc = kl_div_mean(F.log_softmax(scores, dim=-1), soft_bins)
    lr = regression_loss(decode_bin_delta(scores, residual, centers), y_true)
    return lc + alpha * lr


def expected_regression(
    scores: torch.Tensor,
    candidates: torch.Tensor,  # (B, K, D) candidate poses per cluster
    y_true: torch.Tensor,  # (B, D)
    per_sample_loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor],
) -> torch.Tensor:
    """E_{k ~ softmax(scores)}[ loss(candidate_k, y_true) ], mean over batch.

    per_sample_loss maps ((..., D), (..., D)) -> (...): it is applied once to
    the (B, K, D) candidates against y_true broadcast over the cluster axis,
    where the JAX function vmaps over that axis.
    """
    losses = per_sample_loss(candidates, y_true[:, None, :].expand_as(candidates))  # (B, K)
    probs = torch.softmax(scores, dim=-1)
    return torch.mean(torch.sum(probs * losses, dim=-1))


def _mse_rows(p: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.square(p - t).mean(dim=-1)


def _bin_term(scores: torch.Tensor, bin_target: torch.Tensor, soft_bins: bool) -> torch.Tensor:
    if soft_bins:
        return kl_div_mean(F.log_softmax(scores, dim=-1), bin_target)
    return cross_entropy(scores, bin_target)


def probabilistic_loss(
    scores: torch.Tensor,
    residual: torch.Tensor,  # (B, D): one shared residual
    bin_target: torch.Tensor,  # int labels (hard) or (B, K) soft posteriors
    y_true: torch.Tensor,
    centers: torch.Tensor,  # (K, D)
    alpha: float = 1.0,
    per_sample_loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    soft_bins: bool = False,
) -> torch.Tensor:
    """Expected regression loss under the softmax bin posterior, candidate_k
    = residual + center_k (ProbabilisticLoss / RelaXedProbabilisticLoss;
    soft_bins selects KL vs CE for the bin term)."""
    lc = _bin_term(scores, bin_target, soft_bins)
    candidates = residual[:, None, :] + centers[None, :, :]  # (B, K, D)
    lr = expected_regression(scores, candidates, y_true, per_sample_loss or _mse_rows)
    return lc + alpha * lr


def probabilistic_multires_loss(
    scores: torch.Tensor,
    residuals: torch.Tensor,  # (B, K, D): one residual per cluster
    bin_target: torch.Tensor,
    y_true: torch.Tensor,
    centers: torch.Tensor,
    alpha: float = 1.0,
    per_sample_loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] | None = None,
    soft_bins: bool = False,
) -> torch.Tensor:
    """Multires variant: candidate_k = center_k + residual_k
    (ProbabilisticMultiresLoss and its relaxed / quaternion variants)."""
    lc = _bin_term(scores, bin_target, soft_bins)
    candidates = centers[None, :, :] + residuals  # (B, K, D)
    lr = expected_regression(scores, candidates, y_true, per_sample_loss or _mse_rows)
    return lc + alpha * lr


def riemannian_loss(
    scores: torch.Tensor,
    residual: torch.Tensor,  # (B, 3) tangent-space residual
    bin_true: torch.Tensor,
    R_true: torch.Tensor,  # (B, 3, 3) target rotations
    key_rotations: torch.Tensor,  # (K, 3, 3) dictionary atoms as rotations
    alpha: float = 1.0,
) -> torch.Tensor:
    """CE + geodesic trace-angle loss on R_bin @ exp(residual) vs R_true
    (RiemannianLoss, binDeltaLosses.py:227-238): Rodrigues with angle =
    |residual| and axis = residual/|residual|, exactly exp_so3."""
    lc = cross_entropy(scores, bin_true)
    R = exp_so3(residual)
    R_pred = key_rotations.to(R.dtype)[torch.argmax(scores, dim=-1)] @ R
    return lc + alpha * geodesic_rotmat(R_pred, R_true)


def per_bin_residual_loss(
    scores: torch.Tensor,
    residual: torch.Tensor,  # (B, D) predicted residual
    bin_true: torch.Tensor,
    res_true_per_bin: torch.Tensor,  # (B, K, D) residual target per bin
    alpha: float = 1.0,
) -> torch.Tensor:
    """CE + MSE against the residual target at the PREDICTED bin (loss_m2):
    the regression target depends on argmax(scores)."""
    lc = cross_entropy(scores, bin_true)
    target = select_class(res_true_per_bin, torch.argmax(scores, dim=-1))
    return lc + alpha * mse(residual, target)
