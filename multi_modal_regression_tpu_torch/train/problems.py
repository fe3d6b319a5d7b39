"""Problems (port of the JAX package's train/problems.py).

Only the `geodesic` problem's decode and target type are ported: the eval
and serving paths need nothing else. Its targets and losses, and the rest of
the problem zoo, arrive with the training step (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from multi_modal_regression_tpu_torch.losses.bin_delta import decode_bin_delta


@dataclasses.dataclass(frozen=True)
class Problem:
    """decode(out) maps the model output (scores, residual) to poses."""

    name: str
    ydata_type: str
    decode: Callable


def make_problem(
    name: str, centers: np.ndarray, device: torch.device | str | None = None
) -> Problem:
    """Build a Problem by name; `centers` is the (K, 3) axis-angle dictionary,
    placed on `device` once."""
    if name != "geodesic":
        raise ValueError(
            f"problem {name!r} is not ported yet; the port has 'geodesic' "
            "(see ROADMAP.md)"
        )
    C = torch.as_tensor(np.asarray(centers, np.float32), device=device)
    return Problem(
        name, "axis_angle", lambda out: decode_bin_delta(out[0], out[1], C)
    )
