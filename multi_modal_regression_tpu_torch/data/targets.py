"""On-device pose targets (port of the JAX package's data/targets.py).

Only what the eval step needs is ported: Euler angles -> axis-angle poses.
The bin/residual training targets arrive with the training step.
"""

from __future__ import annotations

import torch

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
