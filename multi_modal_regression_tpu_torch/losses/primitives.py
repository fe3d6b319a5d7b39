"""Loss primitives with the reference's reduction conventions.

Port of the JAX package's losses/primitives.py. Reductions matter for
parity: cross-entropy averages over the batch, MSE, L1 and the KL
divergence over ALL elements (the nn.KLDivLoss() default the reference
relies on, not batchmean); and the geodesic losses between axis-angle
poses, quaternions and rotation matrices.
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


def kl_div_mean(log_pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """KL(target || softmax) given log-probabilities, mean over ALL elements.

    Pointwise target * (log(target) - log_pred), with 0*log(0) := 0: the
    nn.KLDivLoss(reduction='mean') convention used by every relaxed loss in
    the reference (binDeltaLosses.py:75-106). Where target is 0 neither the
    value nor the gradient sees log_pred.
    """
    safe = torch.clamp(target, min=1e-38)
    pointwise = torch.where(
        target > 0, target * (torch.log(safe) - log_pred), torch.zeros_like(log_pred)
    )
    return pointwise.mean()


def mse(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean squared error over all elements."""
    return torch.square(pred - target).mean()


def l1(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error over all elements."""
    return torch.abs(pred - target).mean()


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


def geodesic_quat(
    ypred: torch.Tensor, ytrue: torch.Tensor, reduce: bool = True, eps: float = EPS
) -> torch.Tensor:
    """Geodesic distance between quaternions: the FIRST argument is
    renormalized, the double cover is taken by |<., .>| (the loss form of
    quaternion.geodesic_loss, quaternion.py:149-163)."""
    tmp = torch.abs(torch.sum(ytrue * _normalize(ypred), dim=-1))
    theta = 2.0 * torch.arccos(torch.clamp(tmp, -1.0 + eps, 1.0 - eps))
    return theta.mean() if reduce else theta


def geodesic_rotmat(
    Rpred: torch.Tensor, Rtrue: torch.Tensor, reduce: bool = True, eps: float = EPS
) -> torch.Tensor:
    """Geodesic angle between rotation matrices by the trace formula with the
    loss-style clamp (RiemannianLoss.my_loss, binDeltaLosses.py:220-225);
    trace(R1^T R2) as the elementwise Frobenius inner product."""
    tR = 0.5 * (torch.sum(Rpred * Rtrue, dim=(-2, -1)) - 1.0)
    angle = torch.arccos(torch.clamp(tR, -1.0 + eps, 1.0 - eps))
    return angle.mean() if reduce else angle
