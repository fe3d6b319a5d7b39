"""Batched quaternion operations in PyTorch (scalar-first (w, x, y, z)).

Port of the JAX package's geometry/quaternion.py with the same numeric
conventions (the reference's quaternion.py):
  - q = (cos(theta/2), sin(theta/2) * axis); when the rotation's skew-part
    norm is <= eps the angle is treated as 0 and q = (1, 0, 0, 0)
    (quaternion.py:18-29).
  - geodesic angle between unit quaternions: 2*arccos(|<q1, q2>|), the
    double cover (q and -q are one rotation; quaternion.py:33-51).
  - axis-angle dictionary -> quaternion dictionary renormalizes each atom
    (quaternion.py:79-92).
"""

from __future__ import annotations

import torch

from multi_modal_regression_tpu_torch import EPS


def quat_from_axis_angle(v: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Axis-angle vectors (..., 3) -> unit quaternions (..., 4)."""
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    angle = torch.sqrt(torch.clamp(sq, min=0.0))
    norm = torch.sqrt(torch.clamp(sq, min=eps * eps))
    axis = torch.where(angle <= eps, torch.zeros_like(v), v / norm)
    half = 0.5 * angle
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def quat_from_rotation(R: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Rotation matrices (..., 3, 3) -> unit quaternions (..., 4).

    theta from atan2(|skew|, (tr-1)/2) (the arccos of the trace, stable in
    float32), the axis from the skew part; when the skew norm is <= eps the
    result is the identity quaternion (quaternion.py:18-29 sets theta = 0
    in that branch).
    """
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    skew = 0.5 * (R - R.transpose(-2, -1))
    v = torch.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], dim=-1)
    sq = torch.sum(v * v, dim=-1, keepdim=True)
    sin_t = torch.sqrt(torch.clamp(sq, min=0.0))
    theta = torch.atan2(sin_t, 0.5 * (tr[..., None] - 1.0))
    small = sin_t <= eps
    axis = torch.where(small, torch.zeros_like(v), v / torch.sqrt(torch.clamp(sq, min=eps * eps)))
    half = 0.5 * torch.where(small, torch.zeros_like(theta), theta)
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def axis_angle_from_quat(q: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Unit quaternions (..., 4) -> axis-angle vectors (..., 3)."""
    theta = 2.0 * torch.arccos(torch.clamp(q[..., :1], -1.0, 1.0))
    xyz = q[..., 1:]
    sq = torch.sum(xyz * xyz, dim=-1, keepdim=True)
    norm = torch.sqrt(torch.clamp(sq, min=eps * eps))
    small = torch.sqrt(torch.clamp(sq, min=0.0)) <= eps
    return theta * torch.where(small, torch.zeros_like(xyz), xyz / norm)


def quat_geodesic_angle(
    q1: torch.Tensor, q2: torch.Tensor, eps: float | None = None
) -> torch.Tensor:
    """Angle (radians) between rotations given as unit quaternions.

    2*arccos(|<q1, q2>|), the dot clipped to [-1, 1] (metric convention) or
    its magnitude to +/-(1-eps) when eps is given (loss convention).
    """
    dot = torch.sum(q1 * q2, dim=-1)
    if eps is None:
        return 2.0 * torch.arccos(torch.abs(torch.clamp(dot, -1.0, 1.0)))
    return 2.0 * torch.arccos(torch.clamp(torch.abs(dot), -1.0 + eps, 1.0 - eps))


def convert_dictionary(axis_angle_dict: torch.Tensor, eps: float = EPS) -> torch.Tensor:
    """Axis-angle dictionary (K, 3) -> renormalized quaternion dictionary (K, 4)."""
    q = quat_from_axis_angle(axis_angle_dict, eps=eps)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
