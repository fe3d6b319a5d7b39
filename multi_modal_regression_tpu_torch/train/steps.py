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

With a data-parallel `mesh` (parallel/) each rank runs the step on its own
rows and the step is the global batch's: BN moments over the data group,
the loss terms that feed self-balance and the logged metrics averaged over
it, flip and dropout masks drawn for the global batch with each rank
keeping its rows, and one all-reduce of the gradients before the update.

On the card a one-process step replays its work as CUDA graphs
(`GraphedTrainStep`: captured on the second call with a batch layout, the
same bits as the eager step); the CPU and the configurations that
`graph_blocker` names run the eager step.

One eval step: the normalize kernel (or the resize and the plain
normalize) -> the model in eval mode, whatever mode the module was left
in -> decode.
"""

from __future__ import annotations

import contextlib
import warnings
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
from multi_modal_regression_tpu_torch.ops import fused_conv_bn, preprocess, stem_pool
from multi_modal_regression_tpu_torch.ops.preprocess import normalize_images_cuda
from multi_modal_regression_tpu_torch.parallel.mesh import (
    Mesh,
    mean_over_data,
    reduce_gradients,
    syncing_bn,
)
from multi_modal_regression_tpu_torch.parallel.tp import param_shards
from multi_modal_regression_tpu_torch.train.problems import Problem
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.utils.profiling import span


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
    mesh: Mesh | None = None,
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

    mesh (parallel.mesh.Mesh; None or one data rank: the one-process step):
    the batch is this rank's rows, the same count on every rank. The step
    is then the one-process step over the global batch whose streams are
    the ranks' streams concatenated in rank order (with dual_stream_bn each
    half is a stream, so the global batch is [real of every rank, render
    of every rank]; else the whole local batch is one): every BN forward
    (`syncing_bn`) takes the global stream's moments; the flip mask and a
    VGG fc7's dropout are drawn for the global stream and each rank keeps
    its block, so every rank's generator advances alike; (lc, lr) are
    averaged over the data group for `s` and the metrics, while each rank
    backpropagates its own rows' loss; the gradients are averaged over the
    data group (`reduce_gradients`) before the update. On a mesh with a
    model axis the replicated parameters' gradients (all but the bank
    shards, parallel/tp) first take their mean over the model group.

    The step returned is that function itself, or, where `graph_blocker`
    finds nothing against it (a one-process step on the card with Adam and
    no remat, VGG trunk, resize or GMM targets), a `GraphedTrainStep`
    around it.
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
    dp = mesh is not None and mesh.n_data > 1
    shards = param_shards(model)  # the Trainer shards the banks before any step is made
    replicated = ([p for p in trained if id(p) not in shards]
                  if mesh is not None and mesh.n_model > 1 else [])
    streams = 2 if dual_stream_bn and not frozen_bn else 1

    def draw_flips(rng, n):
        if not dp:
            return flip_mask(rng, n, device)
        # the global batch's mask, each stream's rows of every rank in turn
        per, blk = n // streams, n // streams * mesh.n_data
        full = flip_mask(rng, blk * streams, device)
        lo = mesh.data_rank * per
        return torch.cat([full[s * blk + lo:s * blk + lo + per] for s in range(streams)])

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

    def losses(s, rng, batch):
        """#1, flips, targets, the forward, the losses and the balance:
        (loss, lc, lr, s_next)."""
        images = _preprocess(batch, resize_to, compute_dtype)
        euler = batch["euler"]
        if random_flip:
            if rng is None:
                raise ValueError("random_flip needs a state with a flip generator (rng)")
            flip = draw_flips(rng, euler.shape[0])
            euler = flip_pose_euler(euler, flip)
            images = flip_images(images, flip)
        tg = dict(problem.targets(euler_to_pose(euler, problem.ydata_type)))
        labels = batch["label"]
        tg["class_label"] = labels
        is_real = batch.get("is_real")
        tg["is_real"] = (torch.ones(labels.shape, dtype=torch.bool, device=labels.device)
                         if is_real is None else is_real)
        with _mode(modules, modes):
            lc, lr = loss_pair(forward(images, labels), tg)
        if balance is None:
            lc, lr = loss_scale * lc, loss_scale * lr
            return lc + alpha * lr, lc, lr, s
        loss, s_next = self_balanced(lc, lr, s, mode=balance)
        return loss, lc, lr, s_next

    def alpha_after(s_next):
        if balance is None:
            return fixed_alpha
        if balance == "warmup":
            return 0.5 * torch.exp(-2.0 * s_next)
        return torch.exp(-s_next)

    def train_step(state: TrainState, batch: dict):
        if state.model is not model or state.optimizer is not optimizer:
            raise ValueError("the state holds another model or optimizer than this step")
        with _grads_for(params, trained), _drawing_from(drawing, state.rng), \
                syncing_bn(modules, mesh if dp else None):
            with span("mmr.train.forward"):
                loss, lc, lr, s_next = losses(state.s, state.rng, batch)
            with span("mmr.train.backward"):
                optimizer.zero_grad(set_to_none=True)
                loss.backward()
        with span("mmr.train.optimizer"):
            if replicated:
                reduce_gradients(replicated, mesh, "model")
            if dp:
                # the global batch's terms: s and the metrics; this rank's loss
                # above is what it backpropagated
                lc, lr = mean_over_data(torch.stack([lc.detach(), lr.detach()]), mesh)
                if balance is None:
                    loss = lc + alpha * lr
                else:
                    loss, s_next = self_balanced(lc, lr, state.s, mode=balance)
                reduce_gradients(trained, mesh)
            optimizer.step()
        metrics = {
            "loss": loss.detach(), "lc": lc.detach(), "lr": lr.detach(),
            "s": s_next, "alpha": alpha_after(s_next),
        }
        return state.replace(step=state.step + 1, s=s_next), metrics

    if graph_blocker(device, mesh, modules, optimizer, resize_to, problem) is not None:
        return train_step
    return GraphedTrainStep(train_step, losses, alpha_after, model, optimizer, params,
                            trained, draws=random_flip)


def graph_blocker(device: torch.device, mesh: Mesh | None, modules: list[nn.Module],
                  optimizer: torch.optim.Optimizer, resize_to: int | None,
                  problem: Problem) -> str | None:
    """Why a train step of this configuration runs eagerly, or None where
    make_train_step replays it as CUDA graphs (`GraphedTrainStep`). The
    path follows the device and the configuration, with no setting."""
    if device.type != "cuda":
        return f"a {device.type} device: graphs are the card's"
    if mesh is not None and mesh.world > 1:
        return "a mesh of several ranks: the collectives go through the host"
    if any(getattr(m, "remat", None) is not None for m in modules):
        return "a remat mode: the backward reruns checkpointed segments of the forward"
    if any(hasattr(m, "dropout_rng") for m in modules):
        return "a VGG trunk: its fc7 dropout draws from a generator the step binds"
    if resize_to is not None:
        return "device_resize_from: the resize builds its matrices on the host each step"
    if not problem.graphable:
        return f"the {problem.name} problem: its targets wait on the host each step"
    if not callable(getattr(optimizer, "capture_update", None)):
        return f"{type(optimizer).__name__} cannot capture its update"
    return None


# the kernel launch counters of the ops a train step runs (ops/__init__.py);
# Adam keeps its own (train/presets.Adam.capture_update)
_COUNTERS = ((preprocess, "launches"), (stem_pool, "launches"), (stem_pool, "bwd_launches"),
             (fused_conv_bn, "mm_launches"), (fused_conv_bn, "mm_bwd_launches"),
             (fused_conv_bn, "c3_launches"), (fused_conv_bn, "c3_bwd_launches"))


def _counts() -> list[int]:
    return [getattr(module, name) for module, name in _COUNTERS]


def _add_counts(delta: list[int]) -> None:
    for (module, name), d in zip(_COUNTERS, delta):
        setattr(module, name, getattr(module, name) + d)


def _layout(batch: dict, device: torch.device):
    """The batch's keys, shapes and dtypes, or None where a tensor is not on
    `device`."""
    if any(v.device != device for v in batch.values()):
        return None
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))


class _StepGraphs:
    """One batch layout's step captured as three CUDA graphs in one memory
    pool, at the step's layer boundaries: `fwd` (#1, flips, targets, the
    forward with its BN updates, the losses, the balance, alpha), `bwd` (the
    backward into gradients that keep their addresses) and Adam's update,
    which the optimizer holds and replays from its own step(). The batch and
    `s` are copied into static inputs before a replay; `outputs` are the
    metrics, cloned after it."""

    def __init__(self, layout, inputs, s_in, outputs, fwd, bwd, update, grads, rng, held,
                 launched):
        self.layout, self.inputs, self.s_in, self.outputs = layout, inputs, s_in, outputs
        self.fwd, self.bwd, self.update, self.grads, self.rng = fwd, bwd, update, grads, rng
        self.held = held  # (the module's dict, name, tensor) of every parameter and buffer
        self.launched = launched  # the counted kernel launches of one replay


class GraphedTrainStep:
    """A train step on the card that replays its work as CUDA graphs.

    Called as the eager step `eager` is, with the same results bit for bit.
    The first call with a batch layout (keys, shapes, dtypes) runs eagerly;
    the next call with the same layout captures the step (`_StepGraphs`)
    and replays it, and later calls with that layout replay it while the
    state's tensors are those captured: the model's parameters and buffers
    (BN statistics), Adam's moments and, where the step draws flips, the
    state's generator (registered with the forward graph, which advances it
    as the eager draws would). Any other call runs `eager`: a batch of
    another layout (a pass's last, partial batch), a state it does not hold
    (a restored checkpoint: the stale graphs are dropped at once and the
    next repeated layout captures anew), an optimizer with no moments yet
    (after init_state). A capture runs no
    kernel: the state after it is the state before it, so every step,
    the first replay's included, is a real step. The spans of the eager
    step enclose the replays (Adam's inside Optimizer.step); the kernel
    launch counters count each replay's launches. A capture that raises
    leaves the step eager for good (`failure` says why). The graphs' memory
    pool (a step's activations and gradients) stays reserved while the step
    holds them, not shared with other steps' as the eager ones' memory is:
    `release` drops it. torch keeps for good what a capture that raised had
    allocated, so `graph_blocker` keeps the configurations known to fail
    one eager."""

    def __init__(self, eager, losses, alpha_after, model, optimizer, params, trained,
                 draws: bool):
        self.eager = eager
        self._losses, self._alpha_after = losses, alpha_after
        self._model, self._optimizer = model, optimizer
        self._params, self._trained = params, trained
        self._draws = draws
        self._device = params[0].device
        self._graphs: _StepGraphs | None = None
        self._last = None  # the previous call's layout
        self.failure: str | None = None
        self.replays = 0  # steps replayed

    def release(self) -> None:
        """Drop the captured graphs, and the optimizer's update captured with
        them where it still holds it: their memory pool goes with them."""
        if self._graphs is not None and self._optimizer.captured is self._graphs.update:
            self._optimizer.captured = None
        self._graphs = None

    def _holds(self, g: _StepGraphs, state: TrainState) -> bool:
        return ((not self._draws or state.rng is g.rng)
                and all(d.get(name) is t for d, name, t in g.held)
                and self._optimizer.holds_update())

    def __call__(self, state: TrainState, batch: dict):
        if state.model is not self._model or state.optimizer is not self._optimizer:
            raise ValueError("the state holds another model or optimizer than this step")
        layout = _layout(batch, self._device)
        if self._graphs is not None and not self._holds(self._graphs, state):
            self.release()  # stale: its memory goes before this step's
        g = self._graphs
        if layout is None or (self._draws and state.rng is None):
            out = self.eager(state, batch)
        elif g is not None and g.layout == layout:
            out = self._replay(g, state, batch)
        elif (layout == self._last and self.failure is None
              and self._optimizer.ready_to_capture()):
            g = None  # the old graphs' pool goes before the new one is made
            self.release()
            self._graphs = self._capture(layout, state, batch)
            out = (self.eager(state, batch) if self._graphs is None
                   else self._replay(self._graphs, state, batch))
        else:
            out = self.eager(state, batch)
        self._last = layout
        return out

    def _capture(self, layout, state: TrainState, batch: dict) -> _StepGraphs | None:
        opt = self._optimizer
        inputs = {k: v.clone() for k, v in batch.items()}
        s_in = state.s.clone()
        rng = state.rng if self._draws else None
        pool = torch.cuda.graph_pool_handle()
        fwd, bwd = torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph()
        if rng is not None:
            fwd.register_generator_state(rng)
        before = _counts()
        # gradients held from an earlier capture free their pool for the
        # empty_cache that each capture begins with
        opt.zero_grad(set_to_none=True)
        try:
            with _grads_for(self._params, self._trained):
                with torch.cuda.graph(fwd, pool=pool):
                    loss, lc, lr, s_next = self._losses(s_in, rng, inputs)
                    outputs = {"loss": loss.detach(), "lc": lc.detach(), "lr": lr.detach(),
                               "s": s_next, "alpha": self._alpha_after(s_next)}
                with torch.cuda.graph(bwd, pool=pool):
                    opt.zero_grad(set_to_none=True)
                    loss.backward()
            opt.capture_update(pool)
        except RuntimeError as e:
            self.failure = f"{type(e).__name__}: {e}"
            warnings.warn(f"the train step runs eagerly: its capture failed ({self.failure})",
                          stacklevel=3)
            return None
        finally:
            launched = [a - b for a, b in zip(_counts(), before)]
            _add_counts([-d for d in launched])
        held = [(m._parameters, n, t) for m in self._model.modules()
                for n, t in m._parameters.items() if t is not None]
        held += [(m._buffers, n, t) for m in self._model.modules()
                 for n, t in m._buffers.items() if t is not None]
        return _StepGraphs(layout, inputs, s_in, outputs, fwd, bwd, opt.captured,
                           [p.grad for p in self._trained], rng, held, launched)

    def _replay(self, g: _StepGraphs, state: TrainState, batch: dict):
        with span("mmr.train.forward"):
            for k, t in g.inputs.items():
                t.copy_(batch[k])
            g.s_in.copy_(state.s)
            g.fwd.replay()
        with span("mmr.train.backward"):
            g.bwd.replay()
            for p, grad in zip(self._trained, g.grads):
                if p.grad is not grad:  # an eager step set its own
                    p.grad = grad
        with span("mmr.train.optimizer"):
            self._optimizer.step()
        metrics = {k: v.clone() for k, v in g.outputs.items()}
        _add_counts(g.launched)
        self.replays += 1
        return state.replace(step=state.step + 1, s=metrics["s"]), metrics


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
