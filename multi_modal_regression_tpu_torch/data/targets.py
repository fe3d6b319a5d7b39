"""On-device pose targets (port of the JAX package's data/targets.py).

Ported so far: Euler angles -> axis-angle poses, and the hard bin +
residual targets of the bin-delta problems. The soft and tangent targets of
the other problems arrive with their presets (ROADMAP.md).
"""

from __future__ import annotations

import torch

from multi_modal_regression_tpu_torch.dictionary.common import pairwise_sqeuclidean
from multi_modal_regression_tpu_torch.geometry.so3 import (
    log_so3,
    rotation_from_euler,
)


def euler_to_pose(
    euler: torch.Tensor, ydata_type: str = "axis_angle"
) -> torch.Tensor:
    """Euler (B, 3) degrees -> axis-angle poses (B, 3).

    The quaternion form waits for `geometry/quaternion.py` (ROADMAP.md).
    """
    if ydata_type != "axis_angle":
        raise ValueError(
            f"ydata_type {ydata_type!r} is not ported yet; only 'axis_angle' "
            "is (see ROADMAP.md)"
        )
    R = rotation_from_euler(euler[:, 0], euler[:, 1], euler[:, 2])
    return log_so3(R)


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
