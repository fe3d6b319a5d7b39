"""The Trainer: warm-up and main phases of steps, periodic MedErr evaluation,
checkpoints (port of the JAX package's train/trainer.py).

Each step consumes one real batch and one render batch, concatenated (the
reference zips two DataLoaders, learnGeodesicBDModel.py:160-173). Loaders
are any iterables of the BalancedLoader batch dicts (data/loader.py):
`xdata` uint8 (n, S, S, 3), `euler` float32 degrees (n, 3), `label` int32
(n,), as numpy arrays or tensors on the host; test loaders add a boolean
`valid` row mask (TestLoader, MatCropLoader). Labels are checked on the
host before a batch crosses to the device: on the card an out-of-range
label would be a device-side assert that ends the process's CUDA context.

Evaluation decodes on the device and computes the problem's headline
metric on the host: MedErr (the mean of per-class median geodesic errors,
metrics/pose_error.py), or for the category problem the mean per-class
accuracy of the decoded class ids (`best` then keeps the highest).

Checkpoints (`workdir`) hold the full state, which the reference does not
save (it saves parameters only, learnGeodesicBDModel.py:231-232): the
model's state_dict with its BN running statistics, Adam's per-parameter
count and moments in their own dtypes (a bfloat16 first moment stays
bfloat16), the learning rate, `s`, the state's generator (flips and
dropout), the step and the config. A checkpoint written before the state
carried the generator restores with a fresh one seeded from cfg.seed (the
JAX trainer's migration). They are written with `torch.save` to
`<workdir>/checkpoints/<name>` (`last` after every main epoch, `best` at
the best headline metric, `final` by the CLI), atomically: a temporary
file in the same directory, then `os.replace`.
Metrics go to `<workdir>/metrics.jsonl` under the JAX package's record keys
and the validation curve to `<workdir>/plots.npz`. The multi-host predict
waits for `parallel/` (ROADMAP.md).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import threading
import time
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from multi_modal_regression_tpu_torch.losses.self_balance import init_log_balance
from multi_modal_regression_tpu_torch.metrics.pose_error import (
    mean_class_accuracy,
    mean_class_median_error,
)
from multi_modal_regression_tpu_torch.train.presets import (
    ExperimentConfig,
    build_model,
    build_optimizer,
    build_problem,
    resolve_compute_dtype,
    scaled_lr,
)
from multi_modal_regression_tpu_torch.train.schedules import epoch_lr_factor
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.steps import (
    make_eval_step,
    make_train_step,
    validate_dual_stream_layout,
)
from multi_modal_regression_tpu_torch.utils.metrics_writer import MetricsWriter

_METRIC_KEYS = ("loss", "lc", "lr", "s", "alpha")
# the batch entries that cross to the device (`valid` stays on the host;
# `is_real` goes too, as the joint losses' row mask)
_DEVICE_KEYS = ("xdata", "euler", "ydata", "label", "is_real")


def _interleave(real_loader: Iterable, render_loader: Iterable | None):
    """Yield concatenated (real, render) batches; stop at the shorter (zip
    semantics of the reference, learnGeodesicBDModel.py:160). Adds a host
    'is_real' row mask. With render_loader None (the single-loader
    protocol) the real batches pass through unchanged."""
    if render_loader is None:
        yield from real_loader
        return
    mask = None
    for a, b in zip(real_loader, render_loader):
        out = {k: np.concatenate([np.asarray(a[k]), np.asarray(b[k])]) for k in a}
        if mask is None or len(mask) != len(out["label"]):
            mask = np.concatenate(
                [np.ones(len(a["label"]), bool), np.zeros(len(b["label"]), bool)]
            )
        out["is_real"] = mask
        yield out


def _host_copy(value):
    """A copy on the host of a tensor, or of the tensors in a dict or list."""
    if isinstance(value, torch.Tensor):
        return value.detach().to("cpu", copy=True)
    if isinstance(value, dict):
        return {k: _host_copy(v) for k, v in value.items()}
    if isinstance(value, list):
        return [_host_copy(v) for v in value]
    return value


def _write_atomic(path: Path, payload: dict) -> None:
    """torch.save to a temporary file beside `path`, flushed to disk, then
    renamed over it: a reader finds the old checkpoint or the new one."""
    path.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.", suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            torch.save(payload, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


class Trainer:
    """Model, problem and optimizer of one experiment, and the loop over them.

    device: where the model, the batches and the state live (the kernels
    run on a CUDA device; a CPU device takes their plain versions).
    The model keeps float32 master weights (float64 for a float64 run) and
    computes in cfg.compute_dtype, as the JAX package does.
    """

    def __init__(
        self, config: ExperimentConfig, dictionary=None,
        workdir: str | Path | None = None, device: torch.device | str = "cuda",
    ):
        self.config = config
        self.device = torch.device(device)
        self.workdir = Path(workdir) if workdir else None
        if self.workdir:
            self.workdir.mkdir(parents=True, exist_ok=True)
        self._writer = (
            MetricsWriter(self.workdir, tensorboard=config.tensorboard)
            if self.workdir else None
        )
        self.compute_dtype = resolve_compute_dtype(config.compute_dtype)
        self.model = build_model(
            config, self.device,
            param_dtype=torch.promote_types(torch.float32, self.compute_dtype),
        )
        self.problem = build_problem(config, dictionary, self.device)
        # over the trained parameters only (cfg.train_only)
        self.optimizer = build_optimizer(config, self.model)
        self._train_steps: dict = {}
        # with device_resize_from the loaders ship images at that size and
        # the steps resize them to image_size on the device
        self.resize_to = config.image_size if config.device_resize_from else None
        self._eval_step = make_eval_step(
            self.model, self.problem, resize_to=self.resize_to,
            compute_dtype=self.compute_dtype,
        )
        self.history: list[dict] = []  # the logged step records, in order
        self.val_history: list[float] = []  # MedErr curve (plots.npz)
        self._save_thread: threading.Thread | None = None
        self._save_error: Exception | None = None

    def train_step_fn(self, phase: str = "main", dual_stream: bool = False):
        """The train step for a phase; dual_stream=True is the per-stream-BN
        variant (the reference's two-forward dual-loader protocol). Built on
        first request."""
        key = (phase, dual_stream)
        if key not in self._train_steps:
            cfg = self.config
            self._train_steps[key] = make_train_step(
                self.model, self.problem, self.optimizer,
                phase=phase,
                alpha=cfg.alpha if phase == "main" else cfg.warmup_alpha,
                dual_stream_bn=dual_stream,
                dual_loss_sum=dual_stream and cfg.loss_stream_sum,
                dual_stream_fused=cfg.bn_stream_fused,
                compute_dtype=self.compute_dtype,
                frozen_bn=cfg.frozen_bn,
                resize_to=self.resize_to,
                random_flip=cfg.train_flip,
            )
        return self._train_steps[key]

    # -- state ------------------------------------------------------------

    def _fresh_rng(self) -> torch.Generator:
        """The step's generator (flips, dropout) on the trainer's device,
        seeded from cfg.seed (the JAX state's PRNGKey(seed))."""
        return torch.Generator(device=self.device).manual_seed(self.config.seed)

    def init_state(self) -> TrainState:
        """Step 0, s = 0, the trainer's model (weights as built from
        cfg.seed or as loaded since) and its optimizer with no moments,
        at the base rate scaled_lr(cfg), and a generator seeded from
        cfg.seed. Unlike the JAX init_state, the weights are not drawn
        again."""
        self.optimizer.state.clear()
        self._set_lr(scaled_lr(self.config))
        return TrainState(
            step=0, model=self.model, optimizer=self.optimizer,
            s=init_log_balance(self.device), rng=self._fresh_rng(),
        )

    def _set_lr(self, lr: float) -> None:
        for group in self.optimizer.param_groups:
            group["lr"] = lr

    def _params(self) -> list[torch.Tensor]:
        return [p for group in self.optimizer.param_groups for p in group["params"]]

    def apply_epoch_lr(self, state: TrainState, epoch: int) -> TrainState:
        """Set the MAIN-epoch learning rate (cfg.epoch_lr_decay: 'objectnet'
        | 'step' | 'inv', see schedules.EPOCH_LR_FACTORS). Every stepping
        reference script calls scheduler.step() BEFORE each training() epoch
        (learnObjectnetBDModel.py:190, learnGeodesicRegressionModel.py:234,
        learnCategorizationModel.py:118), so main epoch e (0-based) runs at
        scaled_lr * factor(e+1); the warm-up pass before the epoch loop ran
        at factor(0)=1. The rate is a host scalar in the optimizer's param
        groups, read by each step: Adam's moments are untouched."""
        if state.optimizer is not self.optimizer:
            raise ValueError("the state holds another optimizer than this trainer")
        self._set_lr(
            scaled_lr(self.config) * epoch_lr_factor(self.config.epoch_lr_decay, epoch + 1)
        )
        return state

    def _to_device(self, batch: dict) -> dict:
        """The batch's images, poses and labels on the trainer's device,
        after the labels were checked on the host against the class count."""
        labels = batch["label"]
        if isinstance(labels, torch.Tensor):
            labels = labels.cpu()
        labels = np.asarray(labels)
        n = self.config.num_classes
        if labels.size and (labels.min() < 0 or labels.max() >= n):
            raise ValueError(
                f"labels must lie in [0, {n}) (num_classes {n}); this batch "
                f"holds {labels.min()}..{labels.max()}"
            )
        return {
            k: torch.as_tensor(batch[k]).to(self.device)
            for k in _DEVICE_KEYS if k in batch
        }

    # -- checkpointing ----------------------------------------------------

    def _checkpoint_path(self, name: str) -> Path:
        if not self.workdir:
            raise ValueError("this trainer has no workdir to hold checkpoints")
        return self.workdir / "checkpoints" / name

    def save_checkpoint(self, state: TrainState, name: str = "last") -> None:
        """Write the full state to `<workdir>/checkpoints/<name>` (nothing
        without a workdir). The state is copied to the host here, on the
        caller's thread, so later steps may update the model in place; with
        cfg.checkpoint_async the file is written on a background thread
        (one save in flight at a time), else before this returns."""
        if not self.workdir:
            return
        payload = {
            "model": _host_copy(state.model.state_dict()),
            # Adam's state per parameter, in the order of its param groups:
            # count, mu and nu in their own dtypes
            "optimizer": [_host_copy(dict(state.optimizer.state.get(p, {})))
                          for p in self._params()],
            "learning_rate": self.optimizer.param_groups[0]["lr"],
            "s": _host_copy(state.s),
            "rng": None if state.rng is None else state.rng.get_state(),
            "step": int(state.step),
            "config": dataclasses.asdict(self.config),
        }
        path = self._checkpoint_path(name)
        self.wait_for_checkpoints()
        if self.config.checkpoint_async:
            t = threading.Thread(
                target=self._run_save, args=(path, payload),
                name=f"ckpt-save-{name}", daemon=False,
            )
            self._save_thread = t
            t.start()
        else:
            _write_atomic(path, payload)

    def _run_save(self, path: Path, payload: dict) -> None:
        try:
            _write_atomic(path, payload)
        except Exception as e:  # surfaced by wait_for_checkpoints
            self._save_error = e

    def wait_for_checkpoints(self) -> None:
        """Block until the background save in flight, if any, is on disk;
        raise RuntimeError from its error if it failed. The thread is not a
        daemon, so an exiting process finishes the write even without this
        call; this makes completion and failure visible to the caller."""
        if self._save_thread is not None:
            self._save_thread.join()
            self._save_thread = None
        if self._save_error is not None:
            err, self._save_error = self._save_error, None
            raise RuntimeError("background checkpoint save failed") from err

    def restore_checkpoint(self, name: str = "last") -> TrainState:
        """The state saved under `name`, loaded into this trainer's model and
        optimizer on its device."""
        self.wait_for_checkpoints()  # don't read a checkpoint mid-write
        payload = torch.load(
            self._checkpoint_path(name), map_location="cpu", weights_only=True
        )
        self.model.load_state_dict(payload["model"])
        params = self._params()
        if len(payload["optimizer"]) != len(params):
            raise ValueError(
                f"checkpoint {name!r} holds optimizer state for "
                f"{len(payload['optimizer'])} parameters, the model has {len(params)}"
            )
        self.optimizer.state.clear()
        for p, st in zip(params, payload["optimizer"]):
            if st:  # torch's Optimizer.load_state_dict would cast mu to p's dtype
                self.optimizer.state[p] = {
                    k: v.to(p.device) if isinstance(v, torch.Tensor) else v
                    for k, v in st.items()
                }
        self._set_lr(payload["learning_rate"])
        rng = self._fresh_rng()
        if payload.get("rng") is not None:
            rng.set_state(payload["rng"])
        return TrainState(
            step=payload["step"], model=self.model, optimizer=self.optimizer,
            s=payload["s"].to(self.device), rng=rng,
        )

    # -- logging ----------------------------------------------------------

    def _log(self, record: dict) -> None:
        """One record to metrics.jsonl, keyed by its step (no phase)."""
        if self._writer:
            record = dict(record)
            step = record.pop("step", 0)
            record.pop("phase", None)
            self._writer.write(step, record)

    # -- training ---------------------------------------------------------

    def run_epoch(
        self, state: TrainState, real_loader: Iterable,
        render_loader: Iterable | None, phase: str, test_loader=None,
        log_every: int = 50,
    ) -> TrainState:
        """One pass over the zipped loaders (at most cfg.max_iterations
        steps), evaluating on test_loader every cfg.eval_every steps. Steps
        1, log_every, 2*log_every, ... are logged: one device-to-host fetch
        of the step's metrics each, printed, appended to self.history with
        the learning rate the step ran at, and written to metrics.jsonl; no
        other step waits for the device."""
        cfg = self.config
        # frozen_bn has no batch statistics, so there is nothing to split
        use_dual = render_loader is not None and cfg.bn_per_stream and not cfg.frozen_bn
        step_fn = self.train_step_fn(phase, dual_stream=use_dual)
        n_steps = images_done = 0
        t0 = time.time()
        for batch in _interleave(real_loader, render_loader):
            if use_dual:
                validate_dual_stream_layout(batch)
            state, metrics = step_fn(state, self._to_device(batch))
            n_steps += 1
            images_done += len(batch["label"])
            if n_steps % log_every == 0 or n_steps == 1:
                values = torch.stack([metrics[k] for k in _METRIC_KEYS]).tolist()
                m = dict(zip(_METRIC_KEYS, values))
                rec = {
                    "step": state.step, "phase": phase, **m,
                    # reference scalar name (learnGeodesicBDModel.py:187-189)
                    "train_loss": m["loss"],
                    "images_per_sec": images_done / max(time.time() - t0, 1e-9),
                }
                print(
                    f"[{phase}] step {state.step} loss {m['loss']:.4f} "
                    f"lc {m['lc']:.4f} lr {m['lr']:.4f} "
                    f"({rec['images_per_sec']:.1f} img/s)",
                    flush=True,
                )
                self._log(rec)
                self.history.append(
                    {**rec, "learning_rate": self.optimizer.param_groups[0]["lr"]}
                )
            if test_loader is not None and cfg.eval_every and n_steps % cfg.eval_every == 0:
                med = self.evaluate(state, test_loader)
                print(f"[{phase}] step {state.step} {self.metric_label(med)}", flush=True)
                self._log({"step": state.step, "med_err": med, "val_loss": med})
                self.val_history.append(med)
            if cfg.max_iterations and n_steps >= cfg.max_iterations:
                break
        return state

    def fit(
        self, state: TrainState, real_loader: Iterable,
        render_loader: Iterable | None, test_loader=None, log_every: int = 50,
    ) -> TrainState:
        """cfg.num_warmup_epochs warm-up epochs, s reset to 0 when
        cfg.reset_s_between_phases (learnGeodesicBDModel.py:240), then
        cfg.num_epochs main epochs, each at its own learning rate under
        cfg.epoch_lr_decay. After every main epoch: the `last` checkpoint,
        and with a test_loader MedErr, logged and kept in val_history, with
        the `best` checkpoint at the lowest so far. plots.npz holds the
        curve; every save is on disk when fit returns. `best` keeps the
        lowest MedErr, or the highest accuracy for a category problem."""
        cfg = self.config
        maximize = self.problem.metric == "category_accuracy"
        best = -float("inf") if maximize else float("inf")
        for _ in range(cfg.num_warmup_epochs):
            state = self.run_epoch(
                state, real_loader, render_loader, "warmup", test_loader, log_every
            )
        if cfg.reset_s_between_phases:
            state = state.replace(s=init_log_balance(self.device))
        for epoch in range(cfg.num_epochs):
            tic = time.time()
            if cfg.epoch_lr_decay is not None:
                state = self.apply_epoch_lr(state, epoch)
            state = self.run_epoch(
                state, real_loader, render_loader, "main", test_loader, log_every
            )
            self.save_checkpoint(state)
            if test_loader is not None:
                med = self.evaluate(state, test_loader)
                print(
                    f"Epoch {epoch} done in {time.time() - tic:.1f}s "
                    f"{self.metric_label(med)}",
                    flush=True,
                )
                self._log({"step": state.step, "epoch": epoch, "med_err": med})
                self.val_history.append(med)
                if (med > best) if maximize else (med < best):
                    best = med  # the best-by-headline-metric checkpoint
                    self.save_checkpoint(state, "best")
        if self.workdir and self.val_history:
            # validation-curve history (the reference's plots/<S>.mat,
            # learnGeodesicBDModel.py:257-258)
            np.savez(self.workdir / "plots.npz", val_loss=np.asarray(self.val_history))
        self.wait_for_checkpoints()
        return state

    # -- evaluation -------------------------------------------------------

    def predict(self, state: TrainState, test_loader: Iterable) -> tuple[np.ndarray, ...]:
        """(ytrue, ypred, labels) on the host over the whole test set, the
        padded rows (`valid` False) dropped. The model runs in eval mode.
        Float outputs come back in at least float32; class ids (the category
        problem's decode) as int32."""
        if state.model is not self.model:
            raise ValueError("the state holds another model than this trainer")
        preds, trues, labels = [], [], []
        for batch in test_loader:
            valid = np.asarray(batch["valid"], bool)
            ypred, ytrue = self._eval_step(self._to_device(batch))
            for out, y in ((preds, ypred), (trues, ytrue)):
                if y.is_floating_point():
                    y = y.to(torch.promote_types(torch.float32, y.dtype))
                out.append(y.cpu().numpy()[valid])
            labels.append(np.asarray(batch["label"])[valid])
        return np.concatenate(trues), np.concatenate(preds), np.concatenate(labels)

    def metric_label(self, value: float) -> str:
        """The headline metric as printed: 'MedErr 12.345 deg', or 'Acc
        0.9300' for a category problem (learnCategorizationModel.py:118)."""
        if self.problem.metric == "category_accuracy":
            return f"Acc {value:.4f}"
        return f"MedErr {value:.3f} deg"

    def evaluate(self, state: TrainState, test_loader: Iterable) -> float:
        """The headline metric: MedErr, the mean over classes of the
        per-class median pose error in degrees (get_error2 parity,
        axisAngle.py:70-95); for a category problem the mean per-class
        accuracy (helperFunctions.get_accuracy)."""
        ytrue, ypred, labels = self.predict(state, test_loader)
        if self.problem.metric == "category_accuracy":
            return mean_class_accuracy(labels, ypred, self.config.num_classes)
        rep = "quaternion" if self.problem.ydata_type == "quaternion" else "axis_angle"
        return mean_class_median_error(
            ytrue, ypred, labels, self.config.num_classes, representation=rep
        )
