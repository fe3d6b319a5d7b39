"""Pose-error metrics on the host (vectorized numpy, float64): the port's copy
of the JAX package's metrics/pose_error.py.

These reproduce the reference's evaluation numerics exactly (within fp
tolerance), which is the acceptance gate for benchmark parity:

  - geodesic_error_deg        <-> axisAngle.get_error's per-sample error
                                  (axisAngle.py:45-66) and, with
                                  convention="matlab", computeGeodesicError.m
                                  (eps=1e-10 open-interval clip).
  - quaternion_error_deg      <-> quaternion.get_error (quaternion.py:33-51)
                                  and computeQuaternionError.m.
  - pose_error_stats          <-> axisAngle.get_error's (acc, medErr, errs).
  - mean_class_median_error   <-> axisAngle.get_error2 / quaternion.get_error2:
                                  mean over classes of per-class median error.
  - mean_class_accuracy       <-> helperFunctions.get_accuracy.

Unlike the reference (per-sample Python loops over Rodrigues formulas), these
are fully vectorized; a 10k-sample eval is a few matrix ops.
"""

from __future__ import annotations

import numpy as np

EPS = 1e-6


def _exp_so3_np(v: np.ndarray, eps: float) -> np.ndarray:
    """Vectorized Rodrigues formula: (N, 3) axis-angle -> (N, 3, 3) rotations."""
    v = np.asarray(v, dtype=np.float64)
    theta = np.linalg.norm(v, axis=-1)
    safe = np.maximum(theta, eps)
    unit = v / safe[..., None]
    zeros = np.zeros_like(theta)
    V = np.stack([
        np.stack([zeros, -unit[..., 2], unit[..., 1]], axis=-1),
        np.stack([unit[..., 2], zeros, -unit[..., 0]], axis=-1),
        np.stack([-unit[..., 1], unit[..., 0], zeros], axis=-1),
    ], axis=-2)
    eye = np.broadcast_to(np.eye(3), V.shape)
    R = (eye + np.sin(theta)[..., None, None] * V
         + (1.0 - np.cos(theta))[..., None, None] * (V @ V))
    return np.where((theta < eps)[..., None, None], eye, R)


def geodesic_error_deg(
    ygt: np.ndarray, yhat: np.ndarray, convention: str = "reference"
) -> np.ndarray:
    """Per-sample geodesic angle (degrees) between axis-angle poses (N, 3).

    convention="reference": exp-map treats |v| < 1e-6 as identity and the
    trace argument is clipped to the closed interval [-1, 1]
    (axisAngle.get_error).
    convention="matlab": axes normalized by max(|v|, 1e-10) and the trace
    argument clipped to +/-(1 - 1e-10) (computeGeodesicError.m) — the two
    agree to ~1e-4 degrees but both are provided for exact parity checks.
    """
    ygt = np.asarray(ygt, dtype=np.float64)
    yhat = np.asarray(yhat, dtype=np.float64)
    if convention == "reference":
        eps = EPS
        R1 = _exp_so3_np(ygt, eps)
        R2 = _exp_so3_np(yhat, eps)
        tR = 0.5 * (np.trace(np.swapaxes(R1, -2, -1) @ R2, axis1=-2, axis2=-1) - 1.0)
        theta = np.arccos(np.clip(tR, -1.0, 1.0))
    elif convention == "matlab":
        eps = 1e-10
        # MATLAB normalizes by max(norm, eps) with no identity special-case;
        # for |v| ~ 0 that still gives R ~ I because sin(t), (1-cos t) -> 0.
        def expm(v):
            t = np.linalg.norm(v, axis=-1)
            unit = v / np.maximum(t, eps)[..., None]
            zeros = np.zeros_like(t)
            V = np.stack([
                np.stack([zeros, -unit[..., 2], unit[..., 1]], axis=-1),
                np.stack([unit[..., 2], zeros, -unit[..., 0]], axis=-1),
                np.stack([-unit[..., 1], unit[..., 0], zeros], axis=-1),
            ], axis=-2)
            eye = np.broadcast_to(np.eye(3), V.shape)
            return (eye + np.sin(t)[..., None, None] * V
                    + (1.0 - np.cos(t))[..., None, None] * (V @ V))

        R1 = expm(ygt)
        R2 = expm(yhat)
        tR = 0.5 * (np.trace(np.swapaxes(R1, -2, -1) @ R2, axis1=-2, axis2=-1) - 1.0)
        theta = np.arccos(np.clip(tR, -1.0 + eps, 1.0 - eps))
    else:
        raise ValueError(f"unknown convention: {convention!r}")
    return np.degrees(np.abs(theta))


def quaternion_error_deg(ygt: np.ndarray, yhat: np.ndarray) -> np.ndarray:
    """Per-sample angle (degrees) between unit quaternions (N, 4), double-cover aware."""
    ygt = np.asarray(ygt, dtype=np.float64)
    yhat = np.asarray(yhat, dtype=np.float64)
    dot = np.clip(np.sum(ygt * yhat, axis=-1), -1.0, 1.0)
    return np.degrees(2.0 * np.arccos(np.abs(dot)))


def pose_error_stats(
    ygt: np.ndarray, yhat: np.ndarray, representation: str = "axis_angle"
) -> tuple[float, float, np.ndarray]:
    """(Acc@30deg percentage, median error deg, per-sample errors deg)."""
    if representation == "axis_angle":
        err = geodesic_error_deg(ygt, yhat)
    elif representation == "quaternion":
        err = quaternion_error_deg(ygt, yhat)
    else:
        raise ValueError(f"unknown representation: {representation!r}")
    acc = 100.0 * np.sum(err < 30.0) / err.size
    med = float(np.median(err))
    return float(acc), med, err


def mean_class_median_error(
    ygt: np.ndarray,
    yhat: np.ndarray,
    labels: np.ndarray,
    num_classes: int,
    representation: str = "axis_angle",
) -> float:
    """Mean over classes of the per-class median pose error (degrees).

    This is the headline "MedErr" number printed by every reference trainer.
    """
    if representation == "axis_angle":
        err = geodesic_error_deg(ygt, yhat)
    elif representation == "quaternion":
        err = quaternion_error_deg(ygt, yhat)
    else:
        raise ValueError(f"unknown representation: {representation!r}")
    labels = np.squeeze(np.asarray(labels))
    med = np.zeros(num_classes)
    for i in range(num_classes):
        med[i] = np.median(err[labels == i])
    return float(np.mean(med))


def per_class_report(
    ygt: np.ndarray,
    yhat: np.ndarray,
    labels: np.ndarray,
    class_names,
    representation: str = "axis_angle",
) -> dict:
    """Per-class median error / Acc@30 table plus the MedErr mean row —
    the expanded form of the reference's printed diagnostics
    (axisAngle.get_error2 per-class medians, get_error's Acc@30)."""
    if representation == "axis_angle":
        err = geodesic_error_deg(ygt, yhat)
    elif representation == "quaternion":
        err = quaternion_error_deg(ygt, yhat)
    else:
        raise ValueError(f"unknown representation: {representation!r}")
    labels = np.squeeze(np.asarray(labels))
    table = {}
    meds = []
    for i, name in enumerate(class_names):
        e = err[labels == i]
        if e.size == 0:
            continue
        med = float(np.median(e))
        meds.append(med)
        table[str(name)] = {
            "median_err_deg": med,
            "acc_30deg": float(100.0 * np.mean(e < 30.0)),
            "count": int(e.size),
        }
    table["mean"] = {
        "median_err_deg": float(np.mean(meds)) if meds else float("nan"),
        "acc_30deg": float(100.0 * np.mean(err < 30.0)),
        "count": int(err.size),
    }
    return table


def mean_class_accuracy(ytrue: np.ndarray, ypred: np.ndarray, num_classes: int) -> float:
    """Mean over classes of per-class classification accuracy
    (helperFunctions.py:123-129).

    Classes absent from ytrue are skipped (with a warning) instead of
    contributing 0/0 = NaN: on full datasets every class appears, so the
    value is identical to the reference's; on synthetic/mini sets the
    headline metric stays finite."""
    ytrue = np.asarray(ytrue).ravel()
    ypred = np.asarray(ypred).ravel()
    accs = []
    absent = []
    for i in range(num_classes):
        mask = ytrue == i
        n = np.sum(mask)
        if n == 0:
            absent.append(i)
            continue
        accs.append(np.sum(mask & (ypred == i)) / n)
    if absent:
        import warnings

        warnings.warn(
            f"mean_class_accuracy: classes {absent} absent from ytrue; "
            "mean over the present classes only"
        )
    return float(np.mean(accs)) if accs else float("nan")
