"""Serving: uint8 images + class labels in, decoded poses out.

Port of the JAX package's serving.py. `make_inference_fn` takes the model
and the problem directly (a Trainer's `model` and `problem` serve as they
are). The whole path runs on the model's device, with the model in eval
mode whatever mode it was left in: normalize kernel (or, with `resize_to`,
the on-device resize and the plain normalize), the ResNet or VGG trunk in
eval mode (stem kernel when a ResNet trunk is built with
stem_pool='kernel'), head banks, class select, the problem's decode. Any
model that `train.presets.build_model` makes serves: the bin-delta,
multires, regression, classification, class-agnostic, joint and
label-concat models, the last fed their labels as one-hot features.

`export_inference` packages the same path as a torch.export program: the
weights, running statistics and the dictionary are held in it, and the
kernels are in it as the custom ops `mmr::normalize_u8` and
`mmr::stem_pool_fwd` (ops/), which launch on the card:

  exported = export_inference(trainer, batch_size=64)   # or "dynamic"
  save_inference("pose.pt2", exported)                  # torch.export.save
  fn = load_inference("pose.pt2")                       # no model code
  poses = fn(images_uint8, labels)

Loading imports only the port's `ops` (which registers the ops) and
`utils.profiling`, and builds no model; the loaded callable checks the
labels on the host, outside the program, as `make_inference_fn` does.
"""

from __future__ import annotations

import io
import itertools
import json
from pathlib import Path
from typing import Callable

import torch
from torch import nn

from multi_modal_regression_tpu_torch.utils.profiling import span

_META = "mmr_inference.json"  # the extra file of a saved program


def _check_labels(images: torch.Tensor, labels: torch.Tensor, num_classes: int) -> None:
    """Labels int32/int64, one per image; labels on the host range-checked
    there (a device label out of range fails in the gather instead)."""
    if labels.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"labels must be int32 or int64, got {labels.dtype}")
    if labels.shape != images.shape[:1]:
        raise ValueError(
            f"{images.shape[0]} images but labels of shape {tuple(labels.shape)}"
        )
    if labels.device.type == "cpu" and labels.numel():
        lo, hi = int(labels.min()), int(labels.max())
        if lo < 0 or hi >= num_classes:
            raise ValueError(f"labels must be in [0, {num_classes}), got [{lo}, {hi}]")


def _trunk_dtype(model: nn.Module) -> torch.dtype:
    from multi_modal_regression_tpu_torch.models.backbones import ResNetBackbone, VGGBackbone

    # every model has a ResNet or a VGG trunk
    return next(m.dtype for m in model.modules() if isinstance(m, (ResNetBackbone, VGGBackbone)))


def make_inference_fn(
    model: nn.Module, problem, compute_dtype: torch.dtype | None = None,
    resize_to: int | None = None,
) -> Callable:
    """(images uint8 (B, S, S, 3), labels int32/int64 (B,)) -> poses (B, D),
    axis-angle or quaternions as the problem's representation.

    Inputs may be numpy arrays or tensors; they are moved to the model's
    device, and the poses (float32) stay there. compute_dtype None takes the
    model's own compute dtype (its first trunk's, ResNet or VGG), so the
    normalize kernel writes what the trunk reads. resize_to: images of
    another size are resized to it on the device first (then the plain
    normalize, no kernel), as the JAX package's make_inference_fn does. Labels
    given on the host are range-checked there; labels already on the device
    are not (an out-of-range label then fails in the gather). Each call is
    a span `mmr.serve.request#<n>` (n from 1) holding `mmr.serve.h2d` and
    `mmr.serve.model` (utils/profiling).
    """
    from multi_modal_regression_tpu_torch.train.steps import make_eval_step

    device = next(model.parameters()).device
    eval_step = make_eval_step(model, problem, resize_to=resize_to,
                               compute_dtype=compute_dtype or _trunk_dtype(model))

    requests = itertools.count(1)

    def infer(images, labels) -> torch.Tensor:
        with span("mmr.serve.request", next(requests)):
            with span("mmr.serve.h2d"):
                images = torch.as_tensor(images)
                labels = torch.as_tensor(labels)
                _check_labels(images, labels, model.num_classes)
                batch = {"xdata": images.to(device), "label": labels.to(device)}
            with span("mmr.serve.model"):
                ypred, _ = eval_step(batch)
        return ypred

    return infer


class _Inference(nn.Module):
    """The exported body: preprocess (normalize kernel, or resize + plain
    normalize), the model in eval mode, the problem's decode."""

    def __init__(self, model: nn.Module, problem, dtype: torch.dtype,
                 resize_to: int | None):
        super().__init__()
        self.model = model
        self.decode = problem.decode
        self.dtype = dtype
        self.resize_to = resize_to

    def forward(self, images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        from multi_modal_regression_tpu_torch.train.steps import _preprocess

        x = _preprocess({"xdata": images}, self.resize_to, self.dtype)
        return self.decode(self.model(x, labels))


def export_inference(
    trainer, batch_size: int | str = 64, image_size: int | None = None,
) -> torch.export.ExportedProgram:
    """torch.export the inference path of a Trainer's model and problem.

    batch_size: an int exports a fixed batch shape; "dynamic" exports the
    batch as a symbolic dimension (torch.export.Dim "b"), one program for
    every batch size. image_size different from the model's training
    resolution (cfg.image_size) puts the on-device resize in the program
    (with the plain normalize after it), so raw-size images serve
    directly. The program is traced on the trainer's device, in eval mode,
    with no gradient. The weights (in their stored dtype) and running
    statistics are the program's parameters and buffers; the dictionary's
    atoms, which the problem's decode closes over, are a constant tensor
    that torch.export lifts into it (`lifted_tensor_*`)."""
    cfg = trainer.config
    size = image_size or cfg.image_size
    resize_to = cfg.image_size if size != cfg.image_size else None
    model = trainer.model
    body = _Inference(model, trainer.problem, _trunk_dtype(model), resize_to)
    if batch_size == "dynamic":
        b, dims = 2, {"images": {0: torch.export.Dim("b", min=1, max=2**20)},
                      "labels": {0: torch.export.Dim("b", min=1, max=2**20)}}
    else:
        b, dims = int(batch_size), None
    device = next(model.parameters()).device
    example = (torch.zeros((b, size, size, 3), dtype=torch.uint8, device=device),
               torch.zeros((b,), dtype=torch.int64, device=device))
    modes = [m.training for m in model.modules()]
    model.eval()
    try:
        with torch.no_grad():
            ep = torch.export.export(body, example, dynamic_shapes=dims)
    finally:
        for m, t in zip(model.modules(), modes):
            m.training = t
    ep.mmr_meta = {"num_classes": int(model.num_classes), "image_size": int(size),
                   "batch_size": batch_size if batch_size == "dynamic" else b}
    return ep


def save_inference(path, exported: torch.export.ExportedProgram) -> None:
    """torch.export.save to `path` (.pt2), with the label check's class count."""
    meta = json.dumps(getattr(exported, "mmr_meta", {}))
    torch.export.save(exported, path, extra_files={_META: meta})


def load_inference(path_or_bytes) -> Callable:
    """A saved program -> fn(images uint8 (B, S, S, 3), labels (B,)) -> poses,
    on the device the program was exported on. Builds no model: it imports
    the port's ops (registering `mmr::*`) and torch.export.load."""
    import multi_modal_regression_tpu_torch.ops.preprocess  # noqa: F401  (mmr::normalize_u8)
    import multi_modal_regression_tpu_torch.ops.stem_pool  # noqa: F401  (mmr::stem_pool_fwd)

    src = (io.BytesIO(bytes(path_or_bytes))
           if isinstance(path_or_bytes, (bytes, bytearray)) else Path(path_or_bytes))
    extra = {_META: ""}
    ep = torch.export.load(src, extra_files=extra)
    meta = json.loads(extra[_META] or "{}")
    program = ep.module()
    device = next((t.device for t in [*ep.state_dict.values(), *ep.constants.values()]
                   if isinstance(t, torch.Tensor)), torch.device("cpu"))
    num_classes = meta.get("num_classes")

    def fn(images, labels) -> torch.Tensor:
        images = torch.as_tensor(images)
        labels = torch.as_tensor(labels)
        if num_classes is not None:
            _check_labels(images, labels, num_classes)
        with torch.no_grad():
            return program(images.to(device, torch.uint8), labels.to(device, torch.int64))

    fn.meta = meta
    return fn
