"""On-device pose targets (port of the JAX package's data/targets.py).

  euler_to_pose             Euler (az, el, ct) -> axis-angle / quaternion
  hard_bin_targets          kmeans hard bin + Euclidean residual
  gmm_soft_targets          GMM posterior soft bins + posterior-mean residual
  rbf_soft_targets          exp(-gamma * d^2) normalized soft bins
  tangent_residual_targets  hard bin + log(R_bin^T R) (RBDGenerator)
  per_bin_tangent_residuals the residual target of every bin
                            (dataGenerators.py:173-178)

Each is one batched computation on the batch's device: no host loop.
"""

from __future__ import annotations

import math

import torch

from multi_modal_regression_tpu_torch.dictionary.common import pairwise_sqeuclidean
from multi_modal_regression_tpu_torch.geometry.quaternion import quat_from_rotation
from multi_modal_regression_tpu_torch.geometry.so3 import (
    exp_so3,
    log_so3,
    rotation_from_euler,
)


def euler_to_pose(
    euler: torch.Tensor, ydata_type: str = "axis_angle"
) -> torch.Tensor:
    """Euler (B, 3) degrees -> pose targets: axis-angle (B, 3) or unit
    quaternion (B, 4). The tilt-sign convention (render -ct) is applied by
    the loader before this point."""
    R = rotation_from_euler(euler[:, 0], euler[:, 1], euler[:, 2])
    if ydata_type == "axis_angle":
        return log_so3(R)
    if ydata_type == "quaternion":
        return quat_from_rotation(R)
    raise ValueError(f"unknown ydata_type {ydata_type!r}")


def hard_bin_targets(
    y: torch.Tensor, centers: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """kmeans.predict + Euclidean residual (binDeltaGenerators.py:27-31).

    y (B, D), centers (K, D) -> bins (B,) int64, residual y - centers[bins]
    (B, D). A plain argmin over the distances, first index on ties, as the
    JAX train step computes it.
    """
    bins = torch.argmin(pairwise_sqeuclidean(y, centers), dim=-1)
    return bins, y - centers[bins]


def gmm_log_responsibilities(
    y: torch.Tensor, means: torch.Tensor, covariances: torch.Tensor,
    weights: torch.Tensor,
) -> torch.Tensor:
    """log p(k | y) (B, K) for a full-covariance GMM, batched over the
    components: one batched Cholesky and one batched triangular solve."""
    d = means.shape[-1]
    # factor in the mixture's own dtype, then promote (float64 poses against
    # a float32 mixture under the float64 parity tests), as the JAX function
    chol = torch.linalg.cholesky(covariances)  # (K, D, D)
    diff = y[:, None, :] - means[None, :, :]  # (B, K, D)
    chol = chol.to(diff.dtype)
    sol = torch.linalg.solve_triangular(chol, diff.permute(1, 2, 0), upper=False)
    maha = torch.sum(sol * sol, dim=1).T  # (B, K)
    logdet = torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)  # (K,)
    log_prob = (
        -0.5 * (maha + d * math.log(2.0 * math.pi))
        - logdet[None, :]
        + torch.log(weights).to(diff.dtype)[None, :]
    )
    return log_prob - torch.logsumexp(log_prob, dim=-1, keepdim=True)


def gmm_soft_targets(
    y: torch.Tensor, means: torch.Tensor, covariances: torch.Tensor,
    weights: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GMM posterior soft bins + residual vs the posterior mean
    (XPBDGenerator, binDeltaGenerators.py:52-56)."""
    resp = torch.exp(gmm_log_responsibilities(y, means, covariances, weights))
    return resp, y - resp @ means.to(resp.dtype)


def rbf_soft_targets(
    y: torch.Tensor, centers: torch.Tensor, gamma: float = 10.0
) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft bins exp(-gamma * ||y - c||^2), normalized; residual vs the
    soft-weighted center (problem 'm3', dataGenerators.py:156-166 and
    XPBDGeneratorQ, binDeltaGenerators.py:104-108; the ablation's tunable
    gamma is ablationFunctions.py:146)."""
    d = pairwise_sqeuclidean(y, centers)
    # softmax over -gamma*d == normalized exp(-gamma*d), but stable
    soft = torch.softmax(-gamma * d, dim=-1)
    return soft, y - soft @ centers.to(soft.dtype)


def tangent_residual_targets(
    y: torch.Tensor, centers: torch.Tensor, key_rotations: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Hard bin + SO(3) tangent residual at the assigned bin + R matrices.

    Returns (bins (B,) int64, residual (B, 3) = log(R_bin^T R), R (B, 3, 3)),
    the RBDGenerator targets (binDeltaGenerators.py:125-139) with batched
    exp/log maps. The key rotations are taken in y's dtype.
    """
    bins = torch.argmin(pairwise_sqeuclidean(y, centers), dim=-1)
    R = exp_so3(y)
    key = key_rotations.to(R.dtype)[bins]
    return bins, log_so3(key.transpose(-2, -1) @ R), R


def per_bin_tangent_residuals(
    y: torch.Tensor, key_rotations: torch.Tensor
) -> torch.Tensor:
    """Residual target per bin: res[b, k] = log(R_k^T R_b) (B, K, 3), all
    B x K rotations in one batched product and one batched log map."""
    R = exp_so3(y)  # (B, 3, 3)
    rel = key_rotations.to(R.dtype).transpose(-2, -1)[None] @ R[:, None]  # (B, K, 3, 3)
    return log_so3(rel)
