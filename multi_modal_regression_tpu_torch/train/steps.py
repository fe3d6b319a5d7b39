"""Train and eval steps (port of the JAX package's train/steps.py).

One train step, on the batch's device with no host synchronisation: the
uint8 batch -> normalize kernel (or, with `resize_to`, the on-device
resize and the plain normalize, ops/augment, as in the JAX package) ->
random flips of images and poses (`random_flip`) -> Euler -> axis-angle or
quaternion poses -> the problem's targets -> forward in training mode ->
losses -> self-balance -> backward (through the trunk's checkpointed
segments where the model was built with a `remat` mode, train/remat) ->
optimizer update, with the BN running statistics updated in the forward.
The state's generator (`rng`) is the step's one source of randomness: the
flip masks and a VGG fc7's dropout masks draw from it. Only the
optimizer's parameters take gradients (the others, frozen by a preset's
train_only, get none and stay as they are); BN runs in training mode
where `train_modes` says so. `s`, the loss and the metrics
stay on the device; nothing in the step calls `.item()`, `float()` or
`.cpu()`.

One eval step: the normalize kernel (or the resize and the plain
normalize) -> the model in eval mode, whatever mode the module was left
in -> decode.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn

from multi_modal_regression_tpu_torch.data.targets import euler_to_pose
from multi_modal_regression_tpu_torch.geometry.quaternion import quat_from_axis_angle
from multi_modal_regression_tpu_torch.losses.self_balance import self_balanced
from multi_modal_regression_tpu_torch.ops.augment import (
    device_preprocess,
    flip_images,
    flip_pose_euler,
)
from multi_modal_regression_tpu_torch.ops.preprocess import normalize_images_cuda
from multi_modal_regression_tpu_torch.train.problems import Problem
from multi_modal_regression_tpu_torch.train.state import TrainState


def _preprocess(
    batch: dict, resize_to: int | None, dtype: torch.dtype | None = None
) -> torch.Tensor:
    """uint8 batch -> normalized images, written directly in `dtype`: the
    normalize kernel, or with resize_to set the JAX package's
    augment.device_preprocess (the resize, then the plain normalize on its
    float values; no kernel launch), whether or not the batch is at
    resize_to already. Flips come after, on the normalized images (they
    commute with the per-channel affine), so a flip-only step keeps the
    kernel."""
    dtype = dtype or torch.float32
    if resize_to is not None:
        return device_preprocess(batch["xdata"], out_size=resize_to, dtype=dtype)
    return normalize_images_cuda(batch["xdata"], dtype=dtype)


def flip_mask(rng: torch.Generator, n: int, device: torch.device) -> torch.Tensor:
    """(n,) bool: each sample flipped with probability 1/2, drawn from `rng`
    as `rand < 0.5` (torch.rand repeats its draws from a seeded CUDA
    generator; torch.multinomial does not)."""
    return torch.rand(n, generator=rng, device=device) < 0.5


@contextlib.contextmanager
def _mode(modules: list[nn.Module], training):
    """Run with the modules in `training` mode (one bool for all, or one
    each), then restore each one's own."""
    modes = [training] * len(modules) if isinstance(training, bool) else training
    saved = [m.training for m in modules]
    for m, t in zip(modules, modes):
        m.training = t
    try:
        yield
    finally:
        for m, t in zip(modules, saved):
            m.training = t


@contextlib.contextmanager
def _drawing_from(modules: list[nn.Module], rng: torch.Generator | None):
    """Run with `rng` bound as the dropout generator of every module that
    draws one (a `dropout_rng` attribute), then unbind it."""
    for m in modules:
        m.dropout_rng = rng
    try:
        yield
    finally:
        for m in modules:
            m.dropout_rng = None


@contextlib.contextmanager
def _grads_for(params: list[nn.Parameter], trained: list[nn.Parameter]):
    """Run with requires_grad on exactly the `trained` parameters of
    `params`, then restore each one's own."""
    on = {id(p) for p in trained}
    saved = [p.requires_grad for p in params]
    for p in params:
        p.requires_grad_(id(p) in on)
    try:
        yield
    finally:
        for p, r in zip(params, saved):
            p.requires_grad_(r)


def train_modes(model: nn.Module, frozen_bn: bool = False) -> list[bool]:
    """The training flag of each of model.modules() in a train step: what
    model.train() sets (all True, or, for a model with a `bn_train_scope`,
    True only inside its named top-level modules), or all False under
    frozen_bn (BN on running statistics, none updated). The model is left
    in the modes it was in."""
    modules = list(model.modules())
    with _mode(modules, [m.training for m in modules]):
        model.train(not frozen_bn)
        return [m.training for m in modules]


def validate_dual_stream_layout(batch: dict) -> None:
    """Per-stream BN (dual_stream_bn) splits each batch at its midpoint into
    (real, render) halves; refuse any batch whose host `is_real` mask is not
    exactly [real*n, render*n] (e.g. loaders of different batch sizes),
    which would mix render rows into the real stream's batch statistics."""
    m = batch["is_real"]
    half = len(m) // 2
    if len(m) % 2 or not m[:half].all() or m[half:].any():
        raise ValueError(
            "bn_per_stream needs equal real/render halves per step "
            "(match the two loaders' batch sizes, as the reference does) "
            f"— got a {int(m.sum())}/{int(len(m) - m.sum())} split"
        )


def make_train_step(
    model: nn.Module,
    problem: Problem,
    optimizer: torch.optim.Optimizer,
    phase: str = "main",
    alpha: float = 1.0,
    dual_stream_bn: bool = False,
    dual_loss_sum: bool = False,
    dual_stream_fused: bool = True,
    compute_dtype: torch.dtype | None = None,
    frozen_bn: bool = False,
    resize_to: int | None = None,
    random_flip: bool = False,
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build the train step (state, batch) -> (state, metrics) for
    (model, problem, optimizer, phase); the semantics of the JAX step.

    batch holds, on the model's device, `xdata` uint8 (B, S, S, 3), `euler`
    float32 (B, 3) degrees and `label` (B,) int, and optionally `is_real`
    (B,) bool, the rows of real images (all rows when absent). The losses
    see the problem's targets plus `class_label` (the labels) and
    `is_real`: the joint problems take their category CE over real rows.

    phase 'warmup' uses problem.warmup_losses / warmup_balance, 'main'
    main_losses / main_balance. A balance of None is the fixed combination
    Lc + alpha * Lr; otherwise losses.self_balance with the state's `s`.

    dual_stream_bn=True is the reference's dual-loader forward: model(real)
    then model(render) (learnGeodesicBDModel.py:116-121), so train-mode BN
    normalizes each stream by its own batch statistics and the running
    statistics take two updates per step, real first. The batch is the
    Trainer's interleaved layout, first half real, second half render; the
    losses see the concatenated outputs (a tuple of tensors, or one tensor
    for the regression and classification models). dual_stream_fused is the JAX
    package's choice of execution for the same semantics (one vmapped
    forward with the two updates composed, identical up to ~1 ulp of the
    running statistics); here both values run the literal two forwards.
    The one-forward form is a later, measured change (ROADMAP.md).
    dual_loss_sum=True scales (loss, lc, lr) by 2, the scripts that sum the
    two streams' mean losses; it needs fixed weights (balance None).

    frozen_bn=True runs one forward over the whole batch with every BN in
    eval mode (running statistics, none updated), dual_stream_bn or not,
    while every trained parameter still trains (the JAX step's frozen_bn,
    torch's model.eval()-during-training, learnCategorizationModel.py:66).

    resize_to: the batch's images are resized to this size on the device
    before the plain normalize (`_preprocess`). random_flip: a mask drawn
    from the state's `rng` (`flip_mask`) flips those rows' Euler angles to
    (-az, el, -ct) before the targets and their images after normalize. A
    VGG fc7's dropout draws from the same `rng`, bound for the forward and
    the backward (whose recompute replays the masks). A model built with a
    remat mode gives the same values; the BN running statistics take one
    update per forward.

    Gradients are taken for the optimizer's parameters only: a parameter the
    optimizer does not hold gets none and no backward runs into a module
    with no trained parameter below it. The model runs in the modes
    `train_modes` gives for the step and is left in the mode it was in.
    Metrics: loss, lc, lr, s (after the update) and alpha (the effective Lr
    weight after the update, as the reference logs it), all 0-d tensors on
    the device.
    """
    if phase == "warmup":
        loss_pair, balance = problem.warmup_losses, problem.warmup_balance
    elif phase == "main":
        loss_pair, balance = problem.main_losses, problem.main_balance
    else:
        raise ValueError(f"phase must be warmup|main, got {phase!r}")
    if dual_loss_sum and balance is not None:
        raise ValueError(
            "dual_loss_sum models fixed-weight stream-sum scripts; none of "
            "them self-balance (balance must be None)"
        )
    del dual_stream_fused  # same two forwards either way (see above)
    loss_scale = 2.0 if (dual_stream_bn and dual_loss_sum) else 1.0
    modules = list(model.modules())
    drawing = [m for m in modules if hasattr(m, "dropout_rng")]
    modes = train_modes(model, frozen_bn)
    params = list(model.parameters())
    trained = [p for group in optimizer.param_groups for p in group["params"]]
    device = params[0].device
    fixed_alpha = torch.tensor(alpha, dtype=torch.float32, device=device)

    def forward(images, labels):
        if frozen_bn or not dual_stream_bn:
            return model(images, labels)
        if images.shape[0] % 2:
            raise ValueError(
                "dual_stream_bn needs an even batch (equal real/render "
                f"halves), got {images.shape[0]}"
            )
        n = images.shape[0] // 2
        out_a = model(images[:n], labels[:n])
        # the render forward's running-stat update composes on the real one's
        out_b = model(images[n:], labels[n:])
        # one tensor (regression, classification) or a tuple of them
        if isinstance(out_a, torch.Tensor):
            return torch.cat([out_a, out_b])
        return tuple(torch.cat([a, b]) for a, b in zip(out_a, out_b))

    def train_step(state: TrainState, batch: dict):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this step")
        images = _preprocess(batch, resize_to, compute_dtype)
        euler = batch["euler"]
        if random_flip:
            if state.rng is None:
                raise ValueError("random_flip needs a state with a flip generator (rng)")
            flip = flip_mask(state.rng, euler.shape[0], euler.device)
            euler = flip_pose_euler(euler, flip)
            images = flip_images(images, flip)
        tg = dict(problem.targets(euler_to_pose(euler, problem.ydata_type)))
        labels = batch["label"]
        tg["class_label"] = labels
        is_real = batch.get("is_real")
        tg["is_real"] = (torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
                         if is_real is None else is_real)
        with _grads_for(params, trained), _drawing_from(drawing, state.rng):
            with _mode(modules, modes):
                lc, lr = loss_pair(forward(images, labels), tg)
            if balance is None:
                lc, lr = loss_scale * lc, loss_scale * lr
                loss, s_next = lc + alpha * lr, state.s
            else:
                loss, s_next = self_balanced(lc, lr, state.s, mode=balance)
            optimizer.zero_grad(set_to_none=True)
            loss.backward()
        optimizer.step()
        if balance is None:
            alpha_logged = fixed_alpha
        elif balance == "warmup":
            alpha_logged = 0.5 * torch.exp(-2.0 * s_next)
        else:
            alpha_logged = torch.exp(-s_next)
        metrics = {
            "loss": loss.detach(), "lc": lc.detach(), "lr": lr.detach(),
            "s": s_next, "alpha": alpha_logged,
        }
        return state.replace(step=state.step + 1, s=s_next), metrics

    return train_step


def make_eval_step(
    model: nn.Module, problem: Problem, resize_to: int | None = None,
    compute_dtype: torch.dtype | None = None,
) -> Callable[[dict], tuple[torch.Tensor, torch.Tensor | None]]:
    """batch -> (ypred, ytrue) on the batch's device.

    batch holds `xdata` uint8 (B, H, W, 3) and `label` (B,) on the model's
    device, and optionally `euler` (B, 3) degrees (ytrue = its pose in the
    problem's representation) or axis-angle `ydata` (ytrue as given, turned
    into quaternions for a quaternion problem); with neither, ytrue is None.
    ypred is the problem's decode: poses, or int32 class ids for the
    category problem. The model runs in eval mode (running statistics, none
    updated), as the JAX eval step does, and is left in the mode it was in.
    With resize_to set the images are resized on the device first, before
    the plain normalize (`_preprocess`).
    """
    modules = list(model.modules())

    def eval_step(batch: dict):
        with torch.inference_mode(), _mode(modules, False):
            images = _preprocess(batch, resize_to, compute_dtype)
            if "euler" in batch:
                y = euler_to_pose(batch["euler"], problem.ydata_type)
            else:
                # .mat crops ship axis-angle `ydata`; quaternion problems
                # compare quaternions
                y = batch.get("ydata")
                if y is not None and problem.ydata_type == "quaternion":
                    y = quat_from_axis_angle(y)
            outputs = model(images, batch["label"])
            return problem.decode(outputs), y

    return eval_step
