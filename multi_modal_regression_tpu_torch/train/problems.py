"""Problems (port of the JAX package's train/problems.py).

Only the `geodesic` problem is ported (learnGeodesicBDModel.py:106-205,
the north star): hard bin + residual targets; warm-up losses CE + MSE on the
residual; main losses CE + geodesic loss on the decoded pose, with the main
self-balance form. The rest of the problem zoo arrives with its presets
(ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch

from multi_modal_regression_tpu_torch.data.targets import hard_bin_targets
from multi_modal_regression_tpu_torch.losses.bin_delta import decode_bin_delta
from multi_modal_regression_tpu_torch.losses.primitives import (
    cross_entropy,
    geodesic_aa,
    mse,
)


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
    name: str, centers: np.ndarray, device: torch.device | str = "cuda"
) -> Problem:
    """Build a Problem by name; `centers` is the (K, 3) axis-angle dictionary,
    placed on `device` once (the card unless the caller asks for "cpu")."""
    if name != "geodesic":
        raise ValueError(
            f"problem {name!r} is not ported yet; the port has 'geodesic' "
            "(see ROADMAP.md)"
        )
    C = torch.as_tensor(np.asarray(centers, np.float32), device=device)

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
