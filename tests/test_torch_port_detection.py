"""The port's detection protocol (detection.py, metrics/detection.py)
against the JAX package's, on CPU.

- metrics/detection on seeded boxes, scores and poses: within 1e-12.
- ground_truth_per_class and evaluate_detection_results over a synthesized
  release's VOC val annotations and seeded detections: within 1e-6 (the
  ground-truth poses come from each package's so3 in float32).
- run_detection_inference from the same weights (a small JAX Trainer,
  ResNet18 to layer2, N0 128, N1 16, N2 8, K 8, 3 classes, 32 px, random BN
  statistics; carried across by from_jax_variables), both in float64: poses
  within 1e-8, at a batch the JAX function pads (one batch of 64) and at 4
  (full batches, then a tail the JAX function pads and the port does not).
- The detection index and the results .mat files: equal, and each
  package's files read by the other's load_results_mat.
"""

import numpy as np
import pytest
import scipy.io as spio
import torch

import jax
import jax.numpy as jnp
from multi_modal_regression_tpu import detection as jax_det
from multi_modal_regression_tpu.metrics import detection as jax_metrics
from multi_modal_regression_tpu.parallel.mesh import make_mesh
from multi_modal_regression_tpu.tools.ingest import read_image_set
from multi_modal_regression_tpu.tools.synthetic import (
    generate_detection_set,
    generate_pascal3d_release,
)
from multi_modal_regression_tpu.train import Trainer as JaxTrainer
from multi_modal_regression_tpu.train import get_config as jax_get_config
from multi_modal_regression_tpu.train.state import create_train_state
from multi_modal_regression_tpu_torch import detection
from multi_modal_regression_tpu_torch import metrics
from multi_modal_regression_tpu_torch.metrics import detection as det_metrics
from multi_modal_regression_tpu_torch.models.pretrained import from_jax_variables
from multi_modal_regression_tpu_torch.train.presets import get_config
from multi_modal_regression_tpu_torch.train.trainer import Trainer

from test_torch_port_ops import one_torch_thread, randomize_batch_stats  # noqa: F401

CLASSES = ("aeroplane", "bicycle", "boat")
SMALL = dict(
    feature_network="resnet18", feature_layer="layer2", N0=128, N1=16, N2=8,
    dict_size=8, num_classes=3, image_size=32,
)
BATCHES = (64, 4)


def _centers() -> np.ndarray:
    return (0.7 * np.random.default_rng(0).standard_normal((8, 3))).astype(np.float32)


def _poses(rng, n: int) -> np.ndarray:
    v = rng.standard_normal((n, 3))
    return v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(0, np.pi, (n, 1))


# --- metrics/detection -------------------------------------------------------------------


def _image_sets(rng, n_images: int, mod):
    """Per-image ground truth and detections of one class, built with the
    dataclasses of `mod`: unannotated images (None), annotated images with
    no object, images without detections, boxes that hit and miss."""
    gts, dets = [], []
    for i in range(n_images):
        if i % 7 == 3:
            gts.append(None)
        else:
            n = 0 if i % 5 == 4 else int(rng.integers(1, 4))
            xy = rng.uniform(0, 150, (n, 2))
            boxes = np.concatenate([xy, xy + rng.uniform(20, 80, (n, 2))], axis=1)
            gts.append(mod.ImageGroundTruth(boxes=boxes, poses=_poses(rng, n),
                                            azimuths=rng.uniform(0, 360, n)))
        if i % 6 == 2:
            dets.append(None)
            continue
        m = int(rng.integers(1, 5))
        base = gts[-1].boxes if gts[-1] is not None and len(gts[-1].boxes) else None
        xy = rng.uniform(0, 150, (m, 2))
        boxes = np.concatenate([xy, xy + rng.uniform(20, 80, (m, 2))], axis=1)
        if base is not None:
            k = min(m, len(base))
            boxes[:k] = base[:k] + rng.normal(0, 3, (k, 4))
        dets.append(mod.ImageDetections(boxes=boxes, scores=rng.uniform(0, 1, m),
                                        poses=_poses(rng, m)))
    return gts, dets


def test_metrics_match_jax():
    """box_overlap, voc_ap, azimuth_from_axis_angle (el = 0 included),
    azimuth_bin (on and beside the edges) and compute_detection_metrics in
    both modes and at 4 and 8 bins: within 1e-12; the package exports
    them."""
    rng = np.random.default_rng(0)
    boxes = np.concatenate([rng.uniform(0, 50, (20, 2)), rng.uniform(60, 120, (20, 2))], 1)
    for box in (boxes[0], np.array([200.0, 200, 210, 210]), np.array([10.0, 10, 70, 90])):
        np.testing.assert_allclose(det_metrics.box_overlap(boxes, box),
                                   jax_metrics.box_overlap(boxes, box), rtol=0, atol=1e-12)
    rec, prec = np.sort(rng.uniform(0, 1, 30)), rng.uniform(0, 1, 30)
    assert abs(det_metrics.voc_ap(rec, prec) - jax_metrics.voc_ap(rec, prec)) <= 1e-12
    for y in [*_poses(rng, 50), np.array([0.0, 0.0, 1.0]), np.zeros(3)]:
        assert abs(det_metrics.azimuth_from_axis_angle(y)
                   - jax_metrics.azimuth_from_axis_angle(y)) <= 1e-12
    for nbins in (4, 8, 24):
        for az in (0.0, 45.0, 44.999, 337.5, 359.9, *rng.uniform(0, 360, 20)):
            assert det_metrics.azimuth_bin(az, nbins) == jax_metrics.azimuth_bin(az, nbins)
    gts, dets = _image_sets(np.random.default_rng(1), 40, det_metrics)
    jgts, jdets = _image_sets(np.random.default_rng(1), 40, jax_metrics)
    for mode, nbins in (("arp", 4), ("avp", 4), ("avp", 8)):
        got = det_metrics.compute_detection_metrics(gts, dets, mode=mode, nbins=nbins)
        want = jax_metrics.compute_detection_metrics(jgts, jdets, mode=mode, nbins=nbins)
        assert got.num_gt == want.num_gt > 0 and 0 < got.num_correct == want.num_correct
        assert got.num_correct_view == want.num_correct_view
        for k in ("ap", "avp", "med_err"):
            assert abs(getattr(got, k) - getattr(want, k)) <= 1e-12, (mode, k)
    assert metrics.compute_detection_metrics is det_metrics.compute_detection_metrics
    assert metrics.voc_ap is det_metrics.voc_ap and metrics.box_overlap is det_metrics.box_overlap


@pytest.fixture(scope="module")
def voc(tmp_path_factory):
    """A synthesized release: (db, the VOC val image names)."""
    db, voc_dir = generate_pascal3d_release(tmp_path_factory.mktemp("det_release") / "r",
                                            classes=CLASSES)
    return db, read_image_set(voc_dir / "ImageSets" / "Main" / "val.txt") + ["2099_000999"]


def _detections(rng, gt_tables, n_images):
    """Seeded results over the images: each class's ground truth with jitter
    and posed near the truth (some far), and false positives."""
    bboxes, ypred, labels, scores = [], [], [], []
    for i in range(n_images):
        rows, ys, ls = [], [], []
        for ci, gts in enumerate(gt_tables):
            g = gts[i]
            if g is None:
                continue
            for box, pose in zip(g.boxes, g.poses):
                rows.append(box + rng.normal(0, 2, 4))
                ys.append(pose + rng.normal(0, 0.3 if rng.uniform() < 0.7 else 1.5, 3))
                ls.append(ci)
            if rng.uniform() < 0.5:
                rows.append(rng.uniform(0, 40, 4) + [0, 0, 40, 40])
                ys.append(_poses(rng, 1)[0])
                ls.append(ci)
        n = len(rows)
        if n == 0:
            bboxes.append(np.zeros((0, 4)))
            ypred.append(np.zeros((0, 3)))
            labels.append(np.zeros(0, np.int64))
            scores.append(np.zeros(0))
            continue
        s = rng.uniform(0, 1, n)
        bboxes.append(np.concatenate([np.stack(rows), s[:, None]], axis=1))
        ypred.append(np.stack(ys))
        labels.append(np.asarray(ls, np.int64))
        scores.append(s)
    return bboxes, ypred, labels, scores


def test_ground_truth_and_evaluation_match_jax(voc):
    """build_voc_ground_truth + ground_truth_per_class (the same None
    images, boxes and azimuths; poses within 1e-6), detections_per_class
    equal, and the AP / AVP / ARP table of evaluate_detection_results
    within 1e-6, at 4 and 8 azimuth bins."""
    db, names = voc
    annos = detection.build_voc_ground_truth(db / "Annotations", names, CLASSES)
    jannos = jax_det.build_voc_ground_truth(db / "Annotations", names, CLASSES)
    tables = []
    for ci, cls in enumerate(CLASSES):
        got = detection.ground_truth_per_class(annos[cls], cls, ci)
        want = jax_det.ground_truth_per_class(jannos[cls], cls, ci)
        assert [g is None for g in got] == [w is None for w in want]
        assert got[-1] is None and any(g is not None and len(g.boxes) for g in got)
        for g, w in zip(got, want):
            if g is None:
                continue
            np.testing.assert_array_equal(g.boxes, w.boxes)
            np.testing.assert_array_equal(g.azimuths, w.azimuths)
            assert g.poses.dtype == np.asarray(w.poses).dtype == np.float32
            np.testing.assert_allclose(g.poses, w.poses, rtol=0, atol=1e-6)
        tables.append(want)
    results = _detections(np.random.default_rng(2), tables, len(names))
    for ci in range(len(CLASSES)):
        got = detection.detections_per_class(*results, ci)
        want = jax_det.detections_per_class(*results, ci)
        assert [g is None for g in got] == [w is None for w in want]
        for g, w in zip(got, want):
            if g is not None:
                for k in ("boxes", "scores", "poses"):
                    np.testing.assert_array_equal(getattr(g, k), getattr(w, k))
    for nbins in (4, 8):
        got = detection.evaluate_detection_results(annos, *results[:3], CLASSES,
                                                   scores=results[3], nbins=nbins)
        want = jax_det.evaluate_detection_results(jannos, *results[:3], CLASSES,
                                                  scores=results[3], nbins=nbins)
        assert got.keys() == want.keys() == {*CLASSES, "mean"}
        for cls in want:
            assert got[cls].keys() == want[cls].keys()
            for k in want[cls]:
                assert abs(got[cls][k] - want[cls][k]) <= 1e-6, (cls, k)
        assert 0 < want["mean"]["arp"] < want["mean"]["ap"]


# --- the index, the inference and the results files ----------------------------------------


@pytest.fixture(scope="module")
def det_set(tmp_path_factory):
    """A detector crop set of 6 images (32 px crops, 1-based labels of 3
    classes, an image with no boxes) and the JAX package's index of it."""
    root = generate_detection_set(tmp_path_factory.mktemp("det_set") / "set", num_images=6,
                                  max_boxes=3, image_size=32, num_classes=3, seed=3)
    return root


@pytest.fixture(scope="module")
def jax_run(det_set):
    """The JAX inference in float64 (jax_enable_x64 for this fixture only)
    from seeded weights with random BN statistics: (its variables, its
    results at each batch size)."""
    jax.config.update("jax_enable_x64", True)
    try:
        trainer = JaxTrainer(
            jax_get_config("geodesic_bd", **SMALL, compute_dtype="float64", stem_pool=None,
                           fused_conv_bn=None),
            dictionary=_centers(), mesh=make_mesh(jax.devices("cpu")[:1]),
        )
        state = jax.device_get(trainer.init_state())
        stats = randomize_batch_stats(state.batch_stats, np.random.default_rng(1))
        f64 = lambda t: jax.tree.map(lambda a: np.asarray(a, np.float64), t)  # noqa: E731
        params, stats = f64(state.params), f64(stats)
        jstate = create_train_state({"params": params, "batch_stats": stats}, trainer.tx)
        index = jax_det.DetectionSetIndex(str(det_set))
        runs = {bs: jax_det.run_detection_inference(trainer.apply_fn, trainer.problem, jstate,
                                                    index, batch_size=bs,
                                                    compute_dtype=jnp.float64)
                for bs in BATCHES}
        return (params, stats), runs
    finally:
        jax.config.update("jax_enable_x64", False)


def _port_trainer(variables) -> Trainer:
    cfg = get_config("geodesic_bd", **SMALL, compute_dtype="float64")
    trainer = Trainer(cfg, dictionary=_centers(), device="cpu")
    trainer.model.load_state_dict(from_jax_variables(*variables))
    return trainer


def test_detection_index_matches_jax(det_set, tmp_path):
    """The same image names and, per image, the same crops, raw boxes,
    boxes, scores and 0-based labels (None for the empty image); a set
    whose boxes carry a score column ranks by it."""
    ours, theirs = detection.DetectionSetIndex(str(det_set)), jax_det.DetectionSetIndex(str(det_set))
    assert ours.image_names == theirs.image_names and len(ours) == 6
    for i in range(len(ours)):
        a, b = ours.load_image(i), theirs.load_image(i)
        assert (a is None) == (b is None)
        if a is not None:
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k])
    assert ours.load_image(1) is None
    (tmp_path / "all").mkdir()
    spio.savemat(str(tmp_path / "dbinfo.mat"), {"image_names": np.array(["x"], dtype=object)})
    spio.savemat(str(tmp_path / "all" / "x.mat"), {
        "xdata": np.zeros((2, 4, 4, 3), np.uint8),
        "bboxes": np.array([[1.0, 2, 3, 4, 0.25], [5, 6, 7, 8, 0.75]]),
        "labels": np.array([2, 1])})
    one = detection.DetectionSetIndex(str(tmp_path))
    assert one.image_names == ["x"]
    np.testing.assert_array_equal(one.load_image(0)["scores"], [0.25, 0.75])
    np.testing.assert_array_equal(one.load_image(0)["labels"], [1, 0])


@pytest.mark.parametrize("batch_size", BATCHES)
def test_run_detection_inference_matches_jax(jax_run, det_set, batch_size):
    """Per-image raw boxes, labels and scores equal and poses within 1e-8
    of the JAX function's in float64; the tail batch runs at its own size
    here (JAX pads it). The empty image gives empty arrays."""
    variables, runs = jax_run
    trainer = _port_trainer(variables)
    index = detection.DetectionSetIndex(str(det_set))
    got = detection.run_detection_inference(trainer.model, trainer.problem, index,
                                            batch_size=batch_size, compute_dtype=torch.float64)
    want = runs[batch_size]
    n = sum(len(l) for l in want[2])
    assert n % batch_size and n > 4  # a tail batch
    for g_list, w_list, name in zip(got, want, ("bboxes", "ypred", "labels", "scores")):
        assert len(g_list) == len(w_list) == 6
        for g, w in zip(g_list, w_list):
            assert np.asarray(g).shape == np.asarray(w).shape, name
            if name == "ypred":
                assert g.size == 0 or g.dtype == np.float64
                np.testing.assert_allclose(g, w, rtol=0, atol=1e-8)
            else:
                np.testing.assert_array_equal(g, w)
    assert got[1][1].size == 0


def test_run_detection_inference_hands_the_kernel_c_order_batches(jax_run, det_set,
                                                                  monkeypatch):
    """scipy reads the crop sets' arrays in Fortran order; every batch that
    reaches the normalize (a kernel on the card, which takes C order only)
    is C-contiguous, on the model's device, one call a batch."""
    from multi_modal_regression_tpu_torch.train import steps

    seen = []
    real = steps.normalize_images_cuda

    def check(x, dtype=torch.float32):
        seen.append((x.is_contiguous(), x.dtype, x.shape[0]))
        return real(x, dtype)

    monkeypatch.setattr(steps, "normalize_images_cuda", check)
    trainer = _port_trainer(jax_run[0])
    index = detection.DetectionSetIndex(str(det_set))
    assert not index.load_image(0)["xdata"].flags.c_contiguous
    detection.run_detection_inference(trainer.model, trainer.problem, index, batch_size=4)
    n = sum(len(s["labels"]) for s in map(index.load_image, range(len(index))) if s)
    assert seen == [(True, torch.uint8, min(4, n - i)) for i in range(0, n, 4)]


def test_run_detection_inference_refuses_labels_out_of_range(jax_run, det_set, tmp_path):
    """A label past the model's classes is refused on the host, no batch run."""
    import shutil

    shutil.copytree(det_set, tmp_path / "set")
    f = tmp_path / "set" / "all" / "img0000.mat"
    m = spio.loadmat(str(f))
    m["labels"] = np.full_like(m["labels"], 4)  # 1-based: class index 3 of 3
    spio.savemat(str(f), {k: v for k, v in m.items() if not k.startswith("__")})
    trainer = _port_trainer(jax_run[0])
    with pytest.raises(ValueError, match=r"labels must be in \[0, 3\)"):
        detection.run_detection_inference(trainer.model, trainer.problem,
                                          detection.DetectionSetIndex(str(tmp_path / "set")))


def test_results_files_cross_between_packages(jax_run, tmp_path):
    """A results .mat written by either package reads back the same through
    both packages' load_results_mat (empty images as empty arrays, scores
    from the boxes' 5th column)."""
    _, runs = jax_run
    bboxes, ypred, labels, _ = runs[4]
    detection.save_results_mat(tmp_path / "port.mat", bboxes, ypred, labels)
    jax_det.save_results_mat(tmp_path / "jax.mat", bboxes, ypred, labels)
    loaded = [load(tmp_path / f) for load in (detection.load_results_mat,
                                              jax_det.load_results_mat)
              for f in ("port.mat", "jax.mat")]
    for other in loaded[1:]:
        for a_list, b_list in zip(loaded[0], other, strict=True):
            for a, b in zip(a_list, b_list, strict=True):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    assert loaded[0][1][1].shape == (0, 3)
    np.testing.assert_allclose(np.concatenate(loaded[0][1][:1]), ypred[0], rtol=0, atol=0)
