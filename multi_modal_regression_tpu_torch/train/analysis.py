"""The joint-model analysis protocol (port of the JAX package's
train/analysis.py; evaluateJointModel.py / evaluateJointModel2.py).

Those two reference scripts are inference dumps: a wrapper forward
(evaluateJointModel.py:69-104) computes the category logits and one decoded
pose per (sample, class), `centers[argmax(bin_i)] + res_i` for every class
head i whatever the mixing, and `testing()` (:112-134) collects {ytrue_cat,
ytrue_pose, ypred_cat, ypred_pose} over the test set, for up to four
checkpoints (oracle / cat / top1 / wgt, :137-161), into one
`results/<save_str>_<db_type>_analysis` .mat.

Here the per-class decode runs on the device over each test batch (the
normalize kernel, the model's `analysis` forward in eval mode, the argmax
and the gather), and the .mat writer keeps the reference layout.
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable, Iterable, Sequence

import numpy as np
import torch

from multi_modal_regression_tpu_torch.data.targets import euler_to_pose
from multi_modal_regression_tpu_torch.train.steps import _mode, _preprocess


def make_analysis_step(
    model, problem, centers, compute_dtype: torch.dtype | None = None
) -> Callable[[dict], tuple[torch.Tensor, ...]]:
    """batch -> (ytrue_cat, ytrue_pose, ypred_cat, ypred_pose) on the
    device. batch as the eval step's (`xdata`, `label`, and `euler` or
    `ydata`). ypred_pose is (B, D, C), the reference's
    `torch.stack(ypred).permute(1, 2, 0)` (evaluateJointModel.py:102);
    ypred_cat the category argmax (:122). The model runs in eval mode and
    is left in the mode it was in."""
    device = next(model.parameters()).device
    C = torch.as_tensor(np.asarray(centers, np.float32), device=device)
    modules = list(model.modules())

    def step(batch: dict):
        with torch.inference_mode(), _mode(modules, False):
            images = _preprocess(batch, None, compute_dtype)
            cat_logits, per_head, res = model.analysis(images)
            ypose = C[torch.argmax(per_head, dim=-1)] + res  # (B, C, D)
            if "euler" in batch:
                ytrue = euler_to_pose(batch["euler"], problem.ydata_type)
            else:
                ytrue = batch["ydata"]
            ypred_cat = torch.argmax(cat_logits, dim=-1).to(torch.int32)
            return batch["label"], ytrue, ypred_cat, ypose.permute(0, 2, 1)

    return step


def run_joint_analysis(trainer, state, test_loader: Iterable, centers) -> dict:
    """One checkpoint's analysis pass: the reference testing() dict
    {ytrue_cat, ytrue_pose, ypred_cat, ypred_pose} as numpy arrays over the
    valid rows (evaluateJointModel.py:112-134); poses in at least float32."""
    if state.model is not trainer.model:
        raise ValueError("the state holds another model than this trainer")
    step = make_analysis_step(trainer.model, trainer.problem, centers,
                              compute_dtype=trainer.compute_dtype)
    cols: list[list[np.ndarray]] = [[], [], [], []]
    for batch in test_loader:
        valid = np.asarray(batch["valid"], bool)
        for col, t in zip(cols, step(trainer._to_device(batch))):
            if t.is_floating_point():
                t = t.to(torch.promote_types(torch.float32, t.dtype))
            col.append(t.cpu().numpy()[valid])
    keys = ("ytrue_cat", "ytrue_pose", "ypred_cat", "ypred_pose")
    return {k: np.concatenate(col) for k, col in zip(keys, cols)}


def analysis_report(result: dict, num_classes: int) -> dict:
    """The numbers the reference computes from its analysis .mat in MATLAB
    (computeGeodesicError.m over `ypred_pose(:, :, class)` slices, and the
    category accuracy): the mean per-class category accuracy, and the pose
    MedErr / Acc@30 under both class selections, the true class ('oracle')
    and the predicted one ('predcat', the joint protocol the paper
    reports)."""
    from multi_modal_regression_tpu_torch.metrics.pose_error import (
        mean_class_accuracy,
        per_class_report,
    )

    ytrue_cat = np.asarray(result["ytrue_cat"]).ravel()
    ypred_cat = np.asarray(result["ypred_cat"]).ravel()
    ypose = np.asarray(result["ypred_pose"])  # (N, D, C)
    ytrue = np.asarray(result["ytrue_pose"])
    idx = np.arange(len(ytrue_cat))
    out = {"cat_acc": mean_class_accuracy(ytrue_cat, ypred_cat, num_classes)}
    for sel, cats in (("oracle", ytrue_cat), ("predcat", ypred_cat)):
        table = per_class_report(ytrue, ypose[idx, :, cats], ytrue_cat,
                                 list(range(num_classes)))
        out[f"mederr_{sel}"] = table["mean"]["median_err_deg"]
        out[f"acc30_{sel}"] = table["mean"]["acc_30deg"]
    return out


def save_analysis_mat(path: str | Path, results: dict[str, dict]) -> None:
    """Write the reference's combined analysis file: one struct per run,
    keyed `<name>_results` (evaluateJointModel.py:160-161 writes
    pose/cat/top1/wgt; evaluateJointModel2.py:164 omits cat)."""
    import scipy.io as spio

    spio.savemat(str(path), {f"{name}_results": r for name, r in results.items()})


def parse_analysis_runs(
    checkpoints: Sequence[str], names: Sequence[str] | None
) -> list[tuple[str, str]]:
    """Pair run names with checkpoint names; by default the reference's
    four-stage order (pose, cat, top1, wgt) for up to four checkpoints."""
    default = ["pose", "cat", "top1", "wgt"]
    if names is None:
        if len(checkpoints) > len(default):
            raise SystemExit(
                "more than 4 analysis checkpoints need explicit --analysis-names"
            )
        names = default[: len(checkpoints)]
    if len(names) != len(checkpoints):
        raise SystemExit(
            f"--analysis-names has {len(names)} names for {len(checkpoints)} checkpoints"
        )
    return list(zip(names, checkpoints))
