"""Train and eval steps (port of the JAX package's train/steps.py).

One train step, on the batch's device with no host synchronisation: the
uint8 batch -> normalize kernel -> Euler -> axis-angle or quaternion
poses -> the problem's targets -> forward in training mode -> losses -> self-balance ->
backward -> optimizer update, with the BN running statistics updated in the
forward. `s`, the loss and the metrics stay on the device; nothing in the
step calls `.item()`, `float()` or `.cpu()`.

One eval step: the normalize kernel -> the model in eval mode, whatever mode
the module was left in -> decode.
"""

from __future__ import annotations

import contextlib
from typing import Callable

import torch
from torch import nn

from multi_modal_regression_tpu_torch.data.targets import euler_to_pose
from multi_modal_regression_tpu_torch.geometry.quaternion import quat_from_axis_angle
from multi_modal_regression_tpu_torch.losses.self_balance import self_balanced
from multi_modal_regression_tpu_torch.ops.preprocess import normalize_images_cuda
from multi_modal_regression_tpu_torch.train.problems import Problem
from multi_modal_regression_tpu_torch.train.state import TrainState


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


@contextlib.contextmanager
def _mode(modules: list[nn.Module], training: bool):
    """Run with every module in `training` mode, then restore each one's own."""
    saved = [m.training for m in modules]
    for m in modules:
        m.training = training
    try:
        yield
    finally:
        for m, t in zip(modules, saved):
            m.training = t


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
) -> Callable[[TrainState, dict], tuple[TrainState, dict]]:
    """Build the train step (state, batch) -> (state, metrics) for
    (model, problem, optimizer, phase); the semantics of the JAX step.

    batch holds, on the model's device, `xdata` uint8 (B, S, S, 3), `euler`
    float32 (B, 3) degrees and `label` (B,) int.

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

    The model runs in training mode for the step and is left in the mode it
    was in. Metrics: loss, lc, lr, s (after the update) and alpha (the
    effective Lr weight after the update, as the reference logs it), all
    0-d tensors on the device.
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
    device = next(model.parameters()).device
    fixed_alpha = torch.tensor(alpha, dtype=torch.float32, device=device)

    def forward(images, labels):
        if not dual_stream_bn:
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
        images = _preprocess(batch, None, compute_dtype)
        tg = problem.targets(euler_to_pose(batch["euler"], problem.ydata_type))
        with _mode(modules, True):
            lc, lr = loss_pair(forward(images, batch["label"]), tg)
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
    into quaternions for a quaternion problem); with neither, ytrue is None. The model
    runs in eval mode (running statistics, none updated), as the JAX eval
    step does, and is left in the mode it was in.
    """
    _check_resize(resize_to)
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
