"""Detection-conditioned pose metrics: AP / AVP / ARP (the port's copy of
the JAX package's metrics/detection.py, a Python port of the reference's
MATLAB metric layer: computeAVP.m, computeARP.m, VOCap.m, box_overlap.m).

The core evaluator operates on in-memory per-image ground truth and detection
lists so it is testable without PASCAL3D+ on disk; `compute_detection_metrics`
implements the greedy IoU>=0.5 matching + view-correctness protocol shared by
AVP (azimuth-bin equality, computeAVP.m:83-97) and ARP (geodesic error < 30
degrees, computeARP.m:87-97), accumulating a PR curve ranked by detection
score and integrating it with the VOC AP rule (VOCap.m).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from multi_modal_regression_tpu_torch.metrics.pose_error import geodesic_error_deg


def box_overlap(boxes: np.ndarray, box: np.ndarray) -> np.ndarray:
    """IoU of each row of `boxes` (N, 4) vs a single `box` (4,), [x1 y1 x2 y2].

    Uses the +1 pixel-area convention of the PASCAL devkit (box_overlap.m).
    """
    boxes = np.asarray(boxes, dtype=np.float64).reshape(-1, 4)
    box = np.asarray(box, dtype=np.float64).ravel()
    x1 = np.maximum(boxes[:, 0], box[0])
    y1 = np.maximum(boxes[:, 1], box[1])
    x2 = np.minimum(boxes[:, 2], box[2])
    y2 = np.minimum(boxes[:, 3], box[3])
    w = x2 - x1 + 1
    h = y2 - y1 + 1
    inter = w * h
    area_a = (boxes[:, 2] - boxes[:, 0] + 1) * (boxes[:, 3] - boxes[:, 1] + 1)
    area_b = (box[2] - box[0] + 1) * (box[3] - box[1] + 1)
    iou = inter / (area_a + area_b - inter)
    iou[w <= 0] = 0.0
    iou[h <= 0] = 0.0
    return iou


def voc_ap(recall: np.ndarray, precision: np.ndarray) -> float:
    """PASCAL VOC average precision: precision-envelope integral (VOCap.m)."""
    mrec = np.concatenate([[0.0], np.asarray(recall, dtype=np.float64).ravel(), [1.0]])
    mpre = np.concatenate([[0.0], np.asarray(precision, dtype=np.float64).ravel(), [0.0]])
    for i in range(mpre.size - 2, -1, -1):
        mpre[i] = max(mpre[i], mpre[i + 1])
    idx = np.where(mrec[1:] != mrec[:-1])[0] + 1
    return float(np.sum((mrec[idx] - mrec[idx - 1]) * mpre[idx]))


def azimuth_from_axis_angle(y: np.ndarray) -> float:
    """Extract the azimuth angle (degrees, in [0, 360)) from an axis-angle pose.

    Port of computeAVP.m's get_angles/get_azimuth: rebuild R with Rodrigues
    (eps = 1e-10 floor on the norm), then invert the Rz(ct)Rx(el)Rz(az)
    factorization.
    """
    y = np.asarray(y, dtype=np.float64).ravel()
    eps = 1e-10
    t = np.linalg.norm(y)
    v = y / max(t, eps)
    V = np.array([
        [0.0, -v[2], v[1]],
        [v[2], 0.0, -v[0]],
        [-v[1], v[0], 0.0],
    ])
    R = np.eye(3) + np.sin(t) * V + (1.0 - np.cos(t)) * (V @ V)
    el = np.sign(-R[1, 2]) * np.degrees(np.arccos(np.clip(R[2, 2], -1.0, 1.0)))
    sel = np.sin(np.radians(el))
    if el != 0 and abs(sel) > 1e-12:
        az = np.degrees(np.arctan2(R[2, 0] / sel, R[2, 1] / sel))
    else:
        # el == 0 or +/-180: the Z-rotation factor is read off directly
        # (guards the 0/0 NaN the MATLAB original traps with `keyboard`,
        # computeAVP.m:166)
        az = np.degrees(np.arctan2(R[1, 0], R[0, 0]))
    if not np.isfinite(az):
        raise ValueError(f"non-finite azimuth from pose {y}")
    if az < 0:
        az += 360.0
    return float(az)


def azimuth_bin(azimuth: float, nbins: int) -> int:
    """Azimuth (degrees) -> bin index in [0, nbins), matching find_interval.

    Bin edges are [0, 360/(2n), 360/(2n)+360/n, ...]: bin 0 straddles 0
    degrees (computeAVP.m:5, find_interval :168-178). The MATLAB loop uses a
    strict `azimuth < a(i)` test, so an azimuth exactly on an edge belongs
    to the UPPER bin (searchsorted side='right'), the loop index caps at the
    last edge, and azimuth beyond the last edge wraps to bin 0.
    """
    edges = np.concatenate([
        [0.0],
        np.arange(360.0 / (nbins * 2), 360.0 - 360.0 / (nbins * 2) + 1e-9, 360.0 / nbins),
    ])
    if azimuth > edges[-1]:
        return 0
    idx = min(int(np.searchsorted(edges, azimuth, side="right")), len(edges) - 1)
    return idx - 1


@dataclasses.dataclass
class ImageGroundTruth:
    """Non-difficult GT objects of one class in one image."""

    boxes: np.ndarray  # (n, 4) [x1 y1 x2 y2]
    poses: np.ndarray  # (n, 3) axis-angle viewpoints
    azimuths: np.ndarray | None = None  # (n,) raw azimuth degrees (for AVP)


@dataclasses.dataclass
class ImageDetections:
    """Detections of one class in one image."""

    boxes: np.ndarray  # (m, 4)
    scores: np.ndarray  # (m,)
    poses: np.ndarray  # (m, 3) predicted axis-angle viewpoints


@dataclasses.dataclass
class DetectionMetrics:
    ap: float
    avp: float  # VOCap over (recall, view-accuracy) — "AA" in the reference
    med_err: float
    num_gt: int
    num_correct: int
    num_correct_view: int


def compute_detection_metrics(
    gts: Sequence[ImageGroundTruth | None],
    dets: Sequence[ImageDetections | None],
    mode: str = "arp",
    nbins: int = 4,
    iou_threshold: float = 0.5,
) -> DetectionMetrics:
    """Evaluate one class over a set of images.

    mode="arp": a matched detection is view-correct if the geodesic error
    between predicted and GT axis-angle pose is < 30 degrees; the reported
    median error is geodesic degrees.
    mode="avp": view-correct if predicted and GT azimuth fall in the same of
    `nbins` bins; the reported median error is |az_pred - az_gt| degrees.
    """
    if mode not in ("arp", "avp"):
        raise ValueError(f"unknown mode: {mode!r}")
    scores, correct, correct_view = [], [], []
    errors = []
    total_gt = 0
    for gt, det in zip(gts, dets):
        if gt is None:
            # image not annotated for this class: its detections are
            # SKIPPED, not counted as false positives (computeAVP.m:42-43).
            # An annotated image with zero objects is an ImageGroundTruth
            # with empty boxes — those detections DO count as FPs.
            continue
        n = len(gt.boxes)
        total_gt += n
        if det is None or len(det.boxes) == 0:
            continue
        matched = np.zeros(n, dtype=bool)
        for j in range(len(det.boxes)):
            scores.append(float(det.scores[j]))
            ok, ok_view = 0, 0
            if n > 0:
                iou = box_overlap(gt.boxes, det.boxes[j])
                idx = int(np.argmax(iou))
                if iou[idx] >= iou_threshold and not matched[idx]:
                    matched[idx] = True
                    ok = 1
                    if mode == "arp":
                        theta = float(
                            geodesic_error_deg(
                                gt.poses[idx][None, :],
                                det.poses[j][None, :],
                                convention="matlab",
                            )[0]
                        )
                        errors.append(theta)
                        ok_view = 1 if theta < 30.0 else 0
                    else:
                        az_pred = azimuth_from_axis_angle(det.poses[j])
                        az_gt = float(gt.azimuths[idx])
                        errors.append(abs(az_pred - az_gt))
                        ok_view = 1 if azimuth_bin(az_pred, nbins) == azimuth_bin(az_gt, nbins) else 0
            correct.append(ok)
            correct_view.append(ok_view)

    if not scores or total_gt == 0:
        return DetectionMetrics(0.0, 0.0, float("nan"), total_gt, 0, 0)

    order = np.argsort(-np.asarray(scores), kind="stable")
    correct = np.asarray(correct)[order]
    correct_view = np.asarray(correct_view)[order]
    tp = np.cumsum(correct)
    tp_view = np.cumsum(correct_view)
    npos = np.arange(1, len(correct) + 1)
    precision = tp / npos
    accuracy = tp_view / npos
    recall = tp / total_gt
    ap = voc_ap(recall, precision)
    avp = voc_ap(recall, accuracy)
    med = float(np.median(errors)) if errors else float("nan")
    return DetectionMetrics(
        ap=ap,
        avp=avp,
        med_err=med,
        num_gt=total_gt,
        num_correct=int(tp[-1]),
        num_correct_view=int(tp_view[-1]),
    )
