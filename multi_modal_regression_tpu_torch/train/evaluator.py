"""Snapshot-ensemble evaluation (the reference's evaluate*.py protocol; port
of the JAX package's train/evaluator.py).

"Evaluation" in the reference is NOT plain inference: it loads a trained
checkpoint, fine-tunes for ~9 epochs with the cyclical mySGD rate
(1e-6 <-> 1e-8, period c = 2 * len(real_loader)), and dumps a prediction
snapshot every time the rate bottoms out (count % c == c/2),
evaluateGeodesicBDModel.py:92-145. The snapshots are then ensembled
offline. Here the whole protocol is one object:

  - fine-tune with cyclical_sgd through the Trainer's train step
    (train/steps.make_train_step), the model's weights updated in place;
    the Trainer's own Adam and its moments are not touched
  - at each minimum of the rate, run the test pass and keep (and
    optionally save as .npz, replacing the reference's
    results/<S>_<db>/num<k>.mat files) the (ytrue, ypred, labels) snapshot
  - `ensemble()` averages predictions across snapshots (rotation-aware:
    chordal L2 mean for axis-angle via matrix averaging + projection,
    sign-aligned mean for quaternions) and reports per-snapshot and
    ensembled MedErr.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Iterable

import numpy as np
import torch

from multi_modal_regression_tpu_torch.losses.self_balance import init_log_balance
from multi_modal_regression_tpu_torch.metrics.pose_error import (
    _exp_so3_np,
    mean_class_median_error,
)
from multi_modal_regression_tpu_torch.train.schedules import cyclical_sgd, is_snapshot_step
from multi_modal_regression_tpu_torch.train.state import TrainState
from multi_modal_regression_tpu_torch.train.steps import (
    make_train_step,
    validate_dual_stream_layout,
)
from multi_modal_regression_tpu_torch.train.trainer import Trainer, _interleave


def _project_to_so3(M: np.ndarray) -> np.ndarray:
    """Closest rotation matrices to (N, 3, 3) via SVD (chordal mean step)."""
    U, _, Vt = np.linalg.svd(M)
    det = np.linalg.det(U @ Vt)
    D = np.stack([np.ones_like(det), np.ones_like(det), det], axis=-1)
    return (U * D[:, None, :]) @ Vt


def ensemble_poses(snapshots: list[np.ndarray], representation: str) -> np.ndarray:
    """Average predictions across snapshots, rotation-aware.

    axis_angle: convert to matrices, average, project back to SO(3) (the
    chordal/Frobenius mean), return axis-angle.
    quaternion: align signs to the first snapshot (double cover), average,
    renormalize.
    """
    stack = np.stack(snapshots)  # (S, N, D)
    if representation == "quaternion":
        ref = stack[0]
        sign = np.sign(np.sum(stack * ref[None], axis=-1, keepdims=True))
        sign[sign == 0] = 1.0
        q = np.mean(stack * sign, axis=0)
        return q / np.maximum(np.linalg.norm(q, axis=-1, keepdims=True), 1e-12)
    R = np.stack([_exp_so3_np(s, 1e-6) for s in stack])  # (S, N, 3, 3)
    R_mean = _project_to_so3(np.mean(R, axis=0))
    # matrix log back to axis-angle
    tr = np.trace(R_mean, axis1=-2, axis2=-1)
    theta = np.arccos(np.clip(0.5 * (tr - 1.0), -1.0, 1.0))
    skew = 0.5 * (R_mean - np.swapaxes(R_mean, -2, -1))
    v = np.stack([skew[..., 2, 1], skew[..., 0, 2], skew[..., 1, 0]], axis=-1)
    norm = np.linalg.norm(v, axis=-1, keepdims=True)
    axis = np.where(norm > 1e-12, v / np.maximum(norm, 1e-12), 0.0)
    return theta[..., None] * axis


@dataclasses.dataclass
class SnapshotResult:
    step: int
    med_err: float
    ytrue: np.ndarray
    ypred: np.ndarray
    labels: np.ndarray


class SnapshotEnsembleEvaluator:
    """Fine-tune + snapshot at the rate's minima + ensemble (evaluate*.py)."""

    def __init__(
        self,
        trainer: Trainer,
        cycle_len: int | None = None,
        workdir: str | Path | None = None,
        record_history: bool = False,
    ):
        self.trainer = trainer
        self.cycle_len = cycle_len  # default set from the loader's length in run()
        self.workdir = Path(workdir) if workdir else None
        if self.workdir:
            self.workdir.mkdir(parents=True, exist_ok=True)
        self.snapshots: list[SnapshotResult] = []
        # record_history keeps every fine-tune step's metric dict (the
        # reference logs train_loss/alpha per step during evaluation too,
        # evaluateGeodesicBDModel.py:135-137). Opt-in: each record is a
        # device-to-host fetch, which waits for the step.
        self.record_history = record_history
        self.history: list[dict] = []

    def run(
        self,
        state: TrainState,
        real_loader: Iterable,
        render_loader: Iterable | None,
        test_loader: Iterable,
        num_epochs: int | None = None,
    ) -> TrainState:
        """Fine-tune the state's model for `num_epochs` (cfg.eval_num_epochs
        when None) over the zipped loaders with a fresh cyclical SGD (step
        and s reset to 0), the whole run capped at cfg.max_iterations x
        epochs steps when cfg.max_iterations is set, and take a snapshot at
        each minimum of the rate (at least one: the final state). Returns
        the state, which holds the SGD."""
        trainer = self.trainer
        cfg = trainer.config
        # a fresh run records a fresh fine-tune: stale snapshots/history
        # from a previous run() on the same evaluator would silently
        # concatenate two runs' records
        self.snapshots = []
        self.history = []
        # c = 2 * len(real_loader) (evaluateGeodesicBDModel.py:94)
        c = self.cycle_len or 2 * len(real_loader)
        sgd = cyclical_sgd(trainer.model.parameters(), c, cfg.eval_alpha1, cfg.eval_alpha2)
        # the evaluate scripts' fine-tune loop is ALSO two-forward
        # (evaluateGeodesicBDModel.py:112-117): per-stream BN when
        # fine-tuning from dual loaders, like Trainer.fit
        use_dual = render_loader is not None and cfg.bn_per_stream and not cfg.frozen_bn
        step_fn = make_train_step(
            trainer.model, trainer.problem, sgd, phase="main", alpha=cfg.alpha,
            dual_stream_bn=use_dual, dual_loss_sum=use_dual and cfg.loss_stream_sum,
            dual_stream_fused=cfg.bn_stream_fused, compute_dtype=trainer.compute_dtype,
            frozen_bn=cfg.frozen_bn,
            # the training steps' input contract: device resize and flips
            resize_to=trainer.resize_to, random_flip=cfg.train_flip,
        )
        # the reference fine-tune starts at step 0 with s = 0
        state = state.replace(optimizer=sgd, step=0, s=init_log_balance(trainer.device))
        epochs = cfg.eval_num_epochs if num_epochs is None else num_epochs
        # max_iterations caps the WHOLE fine-tune (not per epoch): once
        # spent the run ends, rather than re-entering each later epoch for
        # one batch
        budget = cfg.max_iterations * epochs if cfg.max_iterations else None
        local_step = 0
        for _ in range(epochs):
            if budget is not None and local_step >= budget:
                break
            for batch in _interleave(real_loader, render_loader):
                if use_dual:
                    validate_dual_stream_layout(batch)
                state, metrics = step_fn(state, trainer._to_device(batch))
                if self.record_history:
                    keys = list(metrics)
                    values = torch.stack([metrics[k].double() for k in keys]).tolist()
                    self.history.append(dict(zip(keys, values)))
                if is_snapshot_step(local_step, c):
                    self._take_snapshot(state, test_loader)
                local_step += 1
                if budget is not None and local_step >= budget:
                    break
        if not self.snapshots:  # always keep at least the final state
            self._take_snapshot(state, test_loader)
        return state

    def _take_snapshot(self, state: TrainState, test_loader: Iterable) -> None:
        ytrue, ypred, labels = self.trainer.predict(state, test_loader)
        med = mean_class_median_error(
            ytrue, ypred, labels, self.trainer.config.num_classes,
            representation=self._representation(),
        )
        snap = SnapshotResult(
            step=int(state.step), med_err=med, ytrue=ytrue, ypred=ypred, labels=labels,
        )
        self.snapshots.append(snap)
        k = len(self.snapshots) - 1
        print(f"[snapshot {k}] step {snap.step} MedErr {med:.3f} deg", flush=True)
        if self.workdir:
            np.savez(
                self.workdir / f"num{k}.npz",
                ytest=ytrue, yhat_test=ypred, test_labels=labels,
                step=np.int64(snap.step),
            )

    def load_saved(self) -> int:
        """Repopulate `self.snapshots` from the num<k>.npz files written to
        workdir (they replace the reference's results/<S>_<db>/num<k>.mat).
        Returns the count."""
        if not self.workdir:
            raise RuntimeError("no workdir to load snapshots from")
        rep = self._representation()
        self.snapshots = []
        k = 0
        while (path := self.workdir / f"num{k}.npz").exists():
            with np.load(path) as z:
                labels = z["test_labels"].astype(np.int32)
                ytrue, ypred = z["ytest"], z["yhat_test"]
                step = int(z["step"]) if "step" in z.files else -1
            med = mean_class_median_error(
                ytrue, ypred, labels, self.trainer.config.num_classes,
                representation=rep,
            )
            self.snapshots.append(
                SnapshotResult(step=step, med_err=med, ytrue=ytrue, ypred=ypred,
                               labels=labels)
            )
            k += 1
        return len(self.snapshots)

    def _representation(self) -> str:
        return (
            "quaternion" if self.trainer.problem.ydata_type == "quaternion"
            else "axis_angle"
        )

    def ensemble(self) -> tuple[float, np.ndarray]:
        """(ensembled MedErr, ensembled predictions) over all snapshots."""
        if not self.snapshots:
            raise RuntimeError("no snapshots taken")
        rep = self._representation()
        ypred = ensemble_poses([s.ypred for s in self.snapshots], rep)
        first = self.snapshots[0]
        med = mean_class_median_error(
            first.ytrue, ypred, first.labels, self.trainer.config.num_classes,
            representation=rep,
        )
        return med, ypred
