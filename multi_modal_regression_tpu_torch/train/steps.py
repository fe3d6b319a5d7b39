"""The eval step (port of `make_eval_step` in the JAX package's train/steps.py).

One eval step: uint8 batch on the device -> normalize kernel -> model in
eval mode -> decode, with no host synchronisation. The train step arrives
with the training kernels (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from multi_modal_regression_tpu_torch.data.targets import euler_to_pose
from multi_modal_regression_tpu_torch.ops.preprocess import normalize_images_cuda
from multi_modal_regression_tpu_torch.train.problems import Problem


def _check_resize(resize_to: int | None) -> None:
    if resize_to is not None:
        raise NotImplementedError(
            "on-device resize waits for ops/augment (ROADMAP.md); "
            "send images at the model's image size"
        )


def _preprocess(
    batch: dict, resize_to: int | None, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """uint8 batch -> normalized images, written directly in `dtype`."""
    _check_resize(resize_to)
    return normalize_images_cuda(batch["xdata"], dtype=dtype or torch.float32)


def make_eval_step(
    model: nn.Module, problem: Problem, resize_to: int | None = None,
    compute_dtype: torch.dtype | None = None,
) -> Callable[[dict], tuple[torch.Tensor, torch.Tensor | None]]:
    """batch -> (ypred, ytrue) on the batch's device.

    batch holds `xdata` uint8 (B, H, W, 3) and `label` (B,) on the model's
    device, and optionally `euler` (B, 3) degrees (ytrue = its axis-angle
    pose) or `ydata` (ytrue as given); with neither, ytrue is None.
    """
    _check_resize(resize_to)

    def eval_step(batch: dict):
        with torch.inference_mode():
            images = _preprocess(batch, resize_to, compute_dtype)
            if "euler" in batch:
                y = euler_to_pose(batch["euler"], problem.ydata_type)
            else:
                y = batch.get("ydata")
            outputs = model(images, batch["label"])
            return problem.decode(outputs), y

    return eval_step
