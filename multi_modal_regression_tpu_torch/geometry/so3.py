"""Batched SO(3) operations in PyTorch.

Port of the JAX package's geometry/so3.py with the same numeric
conventions:
  - Euler convention R = Rz(ct) @ Rx(el) @ Rz(az), angles in degrees.
  - log map: theta = atan2(|skew|, (tr(R)-1)/2); the axis comes from the
    skew part and is zeroed when its norm <= eps.
  - exp map: Rodrigues formula in elementwise form, identity when |v| < eps.

The Rodrigues and trace forms stay elementwise (no 3x3 matrix products),
as in the JAX package, so float32 results do not depend on how a backend
runs small matrix products.
"""

from __future__ import annotations

import math

import torch

from multi_modal_regression_tpu_torch import EPS


def hat(v: torch.Tensor) -> torch.Tensor:
    """Map axis vectors (..., 3) to skew-symmetric matrices (..., 3, 3).

    hat(v) @ x == cross(v, x).
    """
    z = torch.zeros_like(v[..., 0])
    row0 = torch.stack([z, -v[..., 2], v[..., 1]], dim=-1)
    row1 = torch.stack([v[..., 2], z, -v[..., 0]], dim=-1)
    row2 = torch.stack([-v[..., 1], v[..., 0], z], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def rotation_from_euler(
    az: torch.Tensor, el: torch.Tensor, ct: torch.Tensor
) -> torch.Tensor:
    """Euler angles (degrees) -> rotation matrices (..., 3, 3).

    R = Rz(ct) @ Rx(el) @ Rz(az) — azimuth about Z, elevation about X,
    camera tilt about Z, the PASCAL3D+ viewpoint convention.
    """
    a = az * (math.pi / 180.0)
    b = el * (math.pi / 180.0)
    c = ct * (math.pi / 180.0)
    ca, sa = torch.cos(a), torch.sin(a)
    cb, sb = torch.cos(b), torch.sin(b)
    cc, sc = torch.cos(c), torch.sin(c)
    z = torch.zeros_like(ca)
    one = torch.ones_like(ca)
    Ra = torch.stack([
        torch.stack([ca, -sa, z], dim=-1),
        torch.stack([sa, ca, z], dim=-1),
        torch.stack([z, z, one], dim=-1),
    ], dim=-2)
    Rb = torch.stack([
        torch.stack([one, z, z], dim=-1),
        torch.stack([z, cb, -sb], dim=-1),
        torch.stack([z, sb, cb], dim=-1),
    ], dim=-2)
    Rc = torch.stack([
        torch.stack([cc, -sc, z], dim=-1),
        torch.stack([sc, cc, z], dim=-1),
        torch.stack([z, z, one], dim=-1),
    ], dim=-2)
    return Rc @ Rb @ Ra


def exp_so3(v: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> rotation matrices (..., 3, 3).

    Rodrigues as R = cos(t) I + sin(t) V + (1-cos(t)) u u^T for the unit
    axis u (V = hat(u)); the identity for |v| < eps. The rows inside the
    eps ball take their norm from a stand-in 1, so the gradient there is 0
    (the derivative of the constant identity) and not 0 * inf = NaN: a
    residual row of exactly 0 trains (riemannian's main loss).
    """
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    small_sq = sq < eps * eps
    theta = torch.sqrt(torch.where(small_sq, torch.ones_like(sq), sq))
    unit = v / theta
    theta = theta[..., 0]
    V = hat(unit)
    outer = unit[..., :, None] * unit[..., None, :]
    sin_t = torch.sin(theta)[..., None, None]
    cos_t = torch.cos(theta)[..., None, None]
    eye = torch.eye(3, dtype=v.dtype, device=v.device).expand(V.shape)
    R = cos_t * eye + sin_t * V + (1.0 - cos_t) * outer
    return torch.where(small_sq[..., None], eye, R)


def log_so3(R: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> axis-angle vectors (..., 3).

    theta via atan2(|skew|, (tr-1)/2), well-conditioned in float32 near the
    identity; the axis from the skew part, zeroed when its norm is <= eps
    (theta near 0 or pi).
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    tR = 0.5 * (tr - 1.0)
    skew = 0.5 * (R - R.transpose(-2, -1))
    v = torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], dim=-1)
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    theta = torch.atan2(torch.sqrt(torch.clamp(sq[..., 0], min=0.0)), tR)
    norm = torch.sqrt(torch.clamp(sq, min=eps * eps))
    small = torch.sqrt(torch.clamp(sq, min=0.0)) <= eps
    unit = torch.where(small, torch.zeros_like(v), v / norm)
    return theta[..., None] * unit
