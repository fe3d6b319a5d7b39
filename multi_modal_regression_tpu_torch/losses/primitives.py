"""Loss primitives with the reference's reduction conventions.

Port of the JAX package's losses/primitives.py, as far as the `geodesic`
problem needs: cross-entropy averages over the batch, MSE over all
elements, and the geodesic loss between axis-angle poses.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from multi_modal_regression_tpu_torch import EPS


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Softmax cross-entropy with integer labels, mean over the batch."""
    logp = F.log_softmax(logits, dim=-1)
    nll = -torch.gather(logp, -1, labels.to(torch.int64)[..., None])[..., 0]
    return nll.mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements."""
    return torch.square(pred - target).mean()


def _normalize(v: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """L2-normalize along the last axis (torch F.normalize semantics)."""
    norm = torch.linalg.vector_norm(v, dim=-1, keepdim=True)
    return v / torch.clamp(norm, min=eps)


def geodesic_aa(
    ypred: torch.Tensor, ytrue: torch.Tensor, reduce: bool = True, eps: float = EPS
) -> torch.Tensor:
    """Geodesic distance between axis-angle poses via quaternion composition.

    |q(ytrue) . q(ypred)| = cos(theta/2) of the relative rotation; theta =
    2*acos(clamp(., +/-(1-eps))) (axisAngle.geodesic_loss,
    axisAngle.py:103-120).
    """
    angle_p = torch.linalg.vector_norm(ypred, dim=-1)
    angle_t = torch.linalg.vector_norm(ytrue, dim=-1)
    dot = torch.sum(_normalize(ytrue) * _normalize(ypred), dim=-1)
    tmp = torch.abs(
        torch.cos(angle_t / 2) * torch.cos(angle_p / 2)
        + torch.sin(angle_t / 2) * torch.sin(angle_p / 2) * dot
    )
    theta = 2.0 * torch.arccos(torch.clamp(tmp, -1.0 + eps, 1.0 - eps))
    return theta.mean() if reduce else theta
