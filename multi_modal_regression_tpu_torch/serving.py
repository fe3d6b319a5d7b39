"""Serving: uint8 images + class labels in, decoded poses out.

Port of `make_inference_fn` in the JAX package's serving.py. It takes the
model and the problem directly (a Trainer's `model` and `problem` serve
as they are). The whole path runs on the model's device, with the model in
eval mode whatever mode it was left in: normalize kernel, the ResNet or
VGG trunk in eval mode (stem kernel when a ResNet trunk is built with
stem_pool='kernel'), head banks, class select, the problem's decode. Any
model that `train.presets.build_model` makes serves: the bin-delta,
multires, regression, classification, class-agnostic, joint and
label-concat models, the last fed their labels as one-hot features.
`export_inference`/`load_inference` (-> torch.export) wait (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable

import torch
from torch import nn

from multi_modal_regression_tpu_torch.models.backbones import ResNetBackbone, VGGBackbone
from multi_modal_regression_tpu_torch.train.problems import Problem
from multi_modal_regression_tpu_torch.train.steps import make_eval_step


def make_inference_fn(
    model: nn.Module, problem: Problem,
    compute_dtype: torch.dtype | None = None,
) -> Callable:
    """(images uint8 (B, S, S, 3), labels int32/int64 (B,)) -> poses (B, D),
    axis-angle or quaternions as the problem's representation.

    Inputs may be numpy arrays or tensors; they are moved to the model's
    device, and the poses (float32) stay there. compute_dtype None takes the
    model's own compute dtype (its first trunk's, ResNet or VGG), so the
    normalize kernel writes what the trunk reads. Labels given on the host are range-checked there; labels already
    on the device are not (an out-of-range label then fails in the gather).
    """
    device = next(model.parameters()).device
    # the trunk's compute dtype (every model has a ResNet or a VGG trunk)
    dtype = compute_dtype or next(
        m.dtype for m in model.modules() if isinstance(m, (ResNetBackbone, VGGBackbone)))
    eval_step = make_eval_step(model, problem, compute_dtype=dtype)

    def infer(images, labels) -> torch.Tensor:
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels)
        if labels.dtype not in (torch.int32, torch.int64):
            raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
        if labels.shape != images.shape[:1]:
            raise ValueError(
                f"{images.shape[0]} images but labels of shape {tuple(labels.shape)}"
            )
        if labels.device.type == "cpu" and labels.numel():
            lo, hi = int(labels.min()), int(labels.max())
            if lo < 0 or hi >= model.num_classes:
                raise ValueError(
                    f"labels must be in [0, {model.num_classes}), got [{lo}, {hi}]"
                )
        batch = {"xdata": images.to(device), "label": labels.to(device)}
        ypred, _ = eval_step(batch)
        return ypred

    return infer
