"""Detection-conditioned pose inference (evaluateModelDetectedBBoxes.py;
port of the JAX package's detection.py).

The reference iterates images one by one, splitting each image's variable
box count into --batch_size chunks and syncing to host per chunk
(evaluateModelDetectedBBoxes.py:135-171). Here all detector crops are
flattened into ONE stream cut into batches of `batch_size` regardless of
per-image box counts, each batch run through the eval step on the model's
device (the normalize kernel, the trunk in eval mode, the head banks,
decode), and predictions are scattered back to per-image lists at the end.
The JAX package pads the tail batch to keep XLA's shapes static; the port
runs it at its own size (eval-mode BN treats every row on its own, so the
poses are the same). Output matches the reference's results .mat ({bbox,
ypred, labels}, :174-189) and feeds metrics.detection.compute_detection_metrics
(the AVP/ARP Python port) directly.

On-disk layout (written by the setupDataDetection_* MATLAB scripts and by
tools.ingest.prepare_detection_set): `<det_path>/dbinfo.mat` with
`image_names`, and `<det_path>/all/<image>.mat` with `xdata` (n, 224, 224,
3) uint8, `bboxes` (n, 4), `labels` (n,) 1-based class ids.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Sequence

import numpy as np
import torch
from torch import nn

from multi_modal_regression_tpu_torch.train.problems import Problem
from multi_modal_regression_tpu_torch.train.steps import make_eval_step


@dataclasses.dataclass
class DetectionSetIndex:
    """Index over a detector's crop set (`dbinfo.mat` + `all/*.mat`)."""

    db_path: str

    def __post_init__(self):
        import scipy.io as spio

        tmp = spio.loadmat(
            os.path.join(self.db_path, "dbinfo.mat"), squeeze_me=True
        )
        names = tmp["image_names"]
        if isinstance(names, str):
            names = [names]
        self.image_names = [str(n).strip() for n in names]

    def __len__(self) -> int:
        return len(self.image_names)

    def load_image(self, idx: int) -> dict | None:
        """{'xdata' uint8 (n,S,S,3), 'bboxes' raw (n,4|5), 'boxes' (n,4),
        'scores' (n,), 'labels' (n,) 0-based} or None for images with no
        detections.

        Reference detection sets store (n, 5) [x1 y1 x2 y2 score] rows
        (setupDataDetection_maskrcnn.m:41,55,66); the score column ranks
        the PR curve (computeAVP.m:75,107). Plain (n, 4) sets get unit
        scores.
        """
        import scipy.io as spio

        tmp = spio.loadmat(
            os.path.join(self.db_path, "all", self.image_names[idx] + ".mat"),
            verify_compressed_data_integrity=False,
        )
        xdata = np.asarray(tmp["xdata"])
        if xdata.size == 0:
            return None
        raw = np.asarray(tmp["bboxes"], np.float64)
        raw = raw.reshape(len(raw), -1)
        boxes = raw[:, :4]
        scores = raw[:, 4] if raw.shape[1] >= 5 else np.ones(len(raw))
        return {
            "xdata": xdata.astype(np.uint8),
            "bboxes": raw,
            "boxes": boxes,
            "scores": scores,
            # reference labels are 1-based MATLAB ids (:60)
            "labels": np.asarray(tmp["labels"], np.int64).ravel() - 1,
        }


def run_detection_inference(
    model: nn.Module,
    problem: Problem,
    index: DetectionSetIndex,
    batch_size: int = 64,
    compute_dtype: torch.dtype | None = None,
) -> tuple[list[np.ndarray], list[np.ndarray], list[np.ndarray], list[np.ndarray]]:
    """Per-image (bboxes_raw, ypred, labels, scores) lists over a detection
    set. bboxes_raw keeps the stored columns (incl. the score column when
    present) so saved results match the reference layout.

    The model and problem are a Trainer's (`trainer.model`,
    `trainer.problem`), as serving.make_inference_fn takes them; every batch
    runs on the model's device. compute_dtype is the dtype the normalize
    writes, as in the JAX function: None is float32 (the model casts to its
    own compute dtype), float64 gives a float64 model full-precision
    pixels. Labels are checked on the host against the model's class count
    before any batch crosses to the device."""
    device = next(model.parameters()).device
    eval_step = make_eval_step(model, problem, compute_dtype=compute_dtype or torch.float32)

    # flatten all crops into one stream
    all_x, all_l, owners = [], [], []
    per_image: list[dict | None] = []
    for i in range(len(index)):
        sample = index.load_image(i)
        per_image.append(sample)
        if sample is None:
            continue
        all_x.append(sample["xdata"])
        all_l.append(sample["labels"])
        owners.append(np.full(len(sample["labels"]), i))
    if not all_x:
        empty = [np.array([]) for _ in range(len(index))]
        return empty, list(empty), list(empty), list(empty)

    # scipy reads MATLAB's arrays in Fortran order; the kernel takes C order
    X = np.ascontiguousarray(np.concatenate(all_x))
    L = np.concatenate(all_l).astype(np.int64)
    O = np.concatenate(owners)
    n = len(X)
    if len(L) != n:
        raise ValueError(f"{n} crops but {len(L)} labels in the detection set")
    lo, hi = int(L.min()), int(L.max())
    if lo < 0 or hi >= model.num_classes:
        raise ValueError(
            f"detection labels must be in [0, {model.num_classes}) after the "
            f"1-based -> 0-based shift, got [{lo}, {hi}]"
        )

    preds = []
    for start in range(0, n, batch_size):
        batch = {
            "xdata": torch.from_numpy(X[start : start + batch_size]).to(device),
            "label": torch.from_numpy(L[start : start + batch_size]).to(device),
        }
        yp, _ = eval_step(batch)
        preds.append(yp.to(torch.promote_types(torch.float32, yp.dtype)).cpu().numpy())
    Y = np.concatenate(preds)

    bboxes_out, ypred_out, labels_out, scores_out = [], [], [], []
    for i, sample in enumerate(per_image):
        if sample is None:
            bboxes_out.append(np.array([]))
            ypred_out.append(np.array([]))
            labels_out.append(np.array([]))
            scores_out.append(np.array([]))
        else:
            sel = O == i
            bboxes_out.append(sample["bboxes"])
            ypred_out.append(Y[sel])
            labels_out.append(sample["labels"])
            scores_out.append(sample["scores"])
    return bboxes_out, ypred_out, labels_out, scores_out


def save_results_mat(
    path: str | Path,
    bboxes: Sequence[np.ndarray],
    ypred: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
) -> None:
    """Write the reference-format results file ({bbox, ypred, labels} cell
    arrays, evaluateModelDetectedBBoxes.py:176)."""
    import scipy.io as spio

    bb = np.empty(len(bboxes), object)
    yp = np.empty(len(ypred), object)
    lb = np.empty(len(labels), object)
    for i in range(len(bboxes)):
        bb[i], yp[i], lb[i] = bboxes[i], ypred[i], labels[i]
    spio.savemat(str(path), {"bbox": bb, "ypred": yp, "labels": lb})


def load_results_mat(
    path: str | Path,
) -> tuple[list[np.ndarray], list[np.ndarray], list[np.ndarray], list[np.ndarray]]:
    """Read a results file written by save_results_mat back into per-image
    (bboxes_raw, ypred, labels, scores) lists (scores from the boxes' 5th
    column when present, else 1.0). Labels are the 0-based ids
    run_detection_inference emits."""
    import scipy.io as spio

    tmp = spio.loadmat(str(path), squeeze_me=False)
    bb = np.asarray(tmp["bbox"], object).ravel()
    yp = np.asarray(tmp["ypred"], object).ravel()
    lb = np.asarray(tmp["labels"], object).ravel()
    bboxes, ypred, labels, scores = [], [], [], []
    for i in range(len(bb)):
        raw = np.asarray(bb[i], np.float64)
        if raw.size == 0:
            bboxes.append(np.zeros((0, 4)))
            ypred.append(np.zeros((0, 3)))
            labels.append(np.zeros(0, np.int64))
            scores.append(np.zeros(0))
            continue
        raw = raw.reshape(len(raw), -1)
        bboxes.append(raw)
        ypred.append(np.asarray(yp[i], np.float64).reshape(len(raw), -1))
        labels.append(np.asarray(lb[i], np.int64).ravel())
        scores.append(
            raw[:, 4] if raw.shape[1] >= 5 else np.ones(len(raw))
        )
    return bboxes, ypred, labels, scores


def build_voc_ground_truth(
    anno_root: str | Path,
    image_names: Sequence[str],
    classes: Sequence[str],
) -> dict[str, list]:
    """Per-class per-image annotation lists from a PASCAL3D+ Annotations
    tree (computeAVP.m:40-43: class `cls` reads
    `<anno_root>/<cls>_pascal/<image>.mat`; a missing file means the image
    is unannotated FOR THAT CLASS and its detections are skipped). Returns
    {class: annotations_by_image} for evaluate_detection_results."""
    from multi_modal_regression_tpu_torch.tools.ingest import load_annotations_for_images

    anno_root = Path(anno_root)
    return {
        cls: load_annotations_for_images(
            anno_root / f"{cls}_pascal", image_names
        )
        for cls in classes
    }


def ground_truth_per_class(annotations_by_image, class_name: str, class_id: int):
    """Per-image ImageGroundTruth for one class from ObjectAnnotation lists
    (the VOC record loading of computeAVP.m:40-63 / computeARP.m:40-69).

    Protocol parity:
      - an image whose entry is None (no annotation file) yields None —
        its detections are SKIPPED by the metric (computeAVP.m:42-43);
      - GT keeps class-matching NON-DIFFICULT objects (no truncated/occluded
        filter at eval time — that filter is training prep only);
      - an annotated image with zero such objects yields an EMPTY
        ImageGroundTruth, so its detections count as false positives;
      - objects with distance == 0 fall back to the coarse viewpoint
        (azimuth_coarse, elevation_coarse, theta — computeARP.m:57-67).

    All euler->axis-angle conversions run as ONE batched float32 call on
    the CPU, through the port's geometry/so3.
    """
    from multi_modal_regression_tpu_torch.geometry.so3 import log_so3, rotation_from_euler
    from multi_modal_regression_tpu_torch.metrics.detection import ImageGroundTruth

    del class_id  # annotations carry class names
    selected: list[list] = []
    flat_angles: list[tuple[float, float, float]] = []
    for objs in annotations_by_image:
        if objs is None:
            selected.append(None)
            continue
        sel = [o for o in objs if o.cls == class_name and not o.difficult]
        selected.append(sel)
        flat_angles.extend(o.eval_angles for o in sel)

    if flat_angles:
        ang = torch.from_numpy(np.asarray(flat_angles, np.float32))
        poses_all = log_so3(rotation_from_euler(ang[:, 0], ang[:, 1], ang[:, 2])).numpy()
    else:
        poses_all = np.zeros((0, 3))

    out = []
    cursor = 0
    for sel in selected:
        if sel is None:
            out.append(None)
            continue
        n = len(sel)
        poses = poses_all[cursor : cursor + n]
        cursor += n
        out.append(
            ImageGroundTruth(
                boxes=(
                    np.stack([np.asarray(o.bbox, np.float64)[:4] for o in sel])
                    if n else np.zeros((0, 4))
                ),
                poses=poses,
                azimuths=np.asarray([o.eval_angles[0] % 360.0 for o in sel]),
            )
        )
    return out


def evaluate_detection_results(
    annotations_by_image,
    bboxes,
    ypred,
    labels,
    classes,
    scores=None,
    nbins: int = 4,
):
    """Full AVP/ARP evaluation over all classes (the computeAVP.m /
    computeARP.m top level): returns {class: {'ap', 'avp', 'arp', 'med_err_deg',
    'med_az_err_deg'}} plus a 'mean' row.

    annotations_by_image is either one per-image list shared by all classes
    or a {class: per-image list} dict (the PASCAL3D+ layout keeps separate
    `<cls>_pascal` annotation trees whose None/missing semantics are
    per-class — build_voc_ground_truth)."""
    from multi_modal_regression_tpu_torch.metrics.detection import compute_detection_metrics

    table = {}
    for ci, cls in enumerate(classes):
        annos = (
            annotations_by_image[cls]
            if isinstance(annotations_by_image, dict)
            else annotations_by_image
        )
        gts = ground_truth_per_class(annos, cls, ci)
        dets = detections_per_class(bboxes, ypred, labels, scores, ci)
        if all(g is None for g in gts):
            continue
        arp = compute_detection_metrics(gts, dets, mode="arp")
        avp = compute_detection_metrics(gts, dets, mode="avp", nbins=nbins)
        table[cls] = {
            "ap": arp.ap,
            "arp": arp.avp,
            "avp": avp.avp,
            "med_err_deg": arp.med_err,
            "med_az_err_deg": avp.med_err,
            "num_gt": arp.num_gt,
        }
    if table:
        keys = ("ap", "arp", "avp", "med_err_deg", "med_az_err_deg")
        table["mean"] = {
            k: float(np.nanmean([v[k] for v in table.values()])) for k in keys
        }
    return table


def detections_per_class(
    bboxes: Sequence[np.ndarray],
    ypred: Sequence[np.ndarray],
    labels: Sequence[np.ndarray],
    scores: Sequence[np.ndarray] | None,
    class_id: int,
):
    """Group flat per-image results into metrics.detection.ImageDetections
    for one class (scores default to 1.0 — the reference's detectors store
    ranked boxes; pass real scores when available)."""
    from multi_modal_regression_tpu_torch.metrics.detection import ImageDetections

    out = []
    for i in range(len(bboxes)):
        if len(labels[i]) == 0:
            out.append(None)
            continue
        sel = np.asarray(labels[i]).ravel() == class_id
        if not np.any(sel):
            out.append(None)
            continue
        s = (
            np.asarray(scores[i]).ravel()[sel]
            if scores is not None
            else np.ones(int(sel.sum()))
        )
        raw = np.asarray(bboxes[i], np.float64)
        raw = raw.reshape(len(raw), -1)
        out.append(
            ImageDetections(
                boxes=raw[sel, :4],  # raw rows may carry a 5th score column
                scores=s,
                poses=np.asarray(ypred[i])[sel],
            )
        )
    return out
