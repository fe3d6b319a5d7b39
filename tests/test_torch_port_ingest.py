"""The port's release ingestion (tools/ingest.py) against the JAX package's,
on CPU: the readers, the PASCAL3D+ and ObjectNet3D walkers, the four
detector parsers and the detection-set writers.

One PASCAL3D+ release (2 classes, 2 images a split, 96 px, from the JAX
package's writer, with its gray image, missing annotation file, truncated,
difficult and other-class objects) is walked once by the JAX package; the
port walks it at workers 1 and 2. Tolerances: the same file names, decoded
PNG pixels equal, .mat keys, dtypes (cellstr name arrays) and values equal,
`ydata` within 1e-6; readers and parsers equal. The parsers' inputs are
the ones tests/test_ingest.py writes.
"""

import dataclasses

import numpy as np
import pytest
import scipy.io as spio
from PIL import Image

from multi_modal_regression_tpu.tools import ingest as jax_ingest
from multi_modal_regression_tpu.tools.synthetic import (
    generate_objectnet3d_release,
    generate_pascal3d_release,
)
from multi_modal_regression_tpu_torch.tools import ingest

from test_torch_port_ops import one_torch_thread  # noqa: F401
from test_torch_port_prep import assert_cellstr, same_tree

CLASSES = ("aeroplane", "bicycle")
O3D_CLASSES = ("bed", "coffee_maker", "shoe")


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """(release root, VOC dir, the JAX package's prepared tree, its summary)."""
    root = tmp_path_factory.mktemp("ingest_release")
    db, voc = generate_pascal3d_release(root / "release", classes=CLASSES, images_per_split=2)
    summary = jax_ingest.prepare_pascal3d(db, voc, root / "jax", classes=CLASSES,
                                          log=lambda s: None)
    return db, voc, root / "jax", summary


def _fields(objs):
    return [dataclasses.asdict(o) for o in objs]


def _same_fields(got, want) -> None:
    assert len(got) == len(want)
    for g, w in zip(_fields(got), _fields(want), strict=True):
        assert g.keys() == w.keys()
        for k in g:
            assert np.array_equal(g[k], w[k]), k


def test_readers_match_jax(release):
    """Set files, records of every annotation file (fields equal), the
    per-image lists with a missing file, CAD vertices, images (gray refused
    unless converted, a missing file None), the bbox filter and the splits."""
    db, voc, _, _ = release
    for cls in CLASSES:
        assert ingest.pascal3d_splits(db, voc, cls) == jax_ingest.pascal3d_splits(db, voc, cls)
        assert ingest.read_image_set(db / "Image_sets" / f"{cls}_imagenet_val.txt") == \
            jax_ingest.read_image_set(db / "Image_sets" / f"{cls}_imagenet_val.txt")
        main = voc / "ImageSets" / "Main" / f"{cls}_train.txt"
        assert ingest.read_voc_image_set(main) == jax_ingest.read_voc_image_set(main) != []
        cad = db / "CAD" / f"{cls}.mat"
        for a, b in zip(ingest.load_cad_vertices(cad, cls),
                        jax_ingest.load_cad_vertices(cad, cls), strict=True):
            np.testing.assert_array_equal(a, b)
        for source in ("imagenet", "pascal"):
            anno = db / "Annotations" / f"{cls}_{source}"
            names = sorted(p.stem for p in anno.glob("*.mat")) + ["missing"]
            got = ingest.load_annotations_for_images(anno, names)
            want = jax_ingest.load_annotations_for_images(anno, names)
            assert got[-1] is None and want[-1] is None
            for g, w in zip(got[:-1], want[:-1], strict=True):
                _same_fields(g, w)
    assert ingest.image_id("n02000_train0") == jax_ingest.image_id("n02000_train0")
    gray = db / "Images" / "aeroplane_imagenet" / "n02000_val1"
    assert ingest.load_rgb_image(gray) is None and jax_ingest.load_rgb_image(gray) is None
    np.testing.assert_array_equal(ingest.load_rgb_image(gray, gray_to_rgb=True),
                                  jax_ingest.load_rgb_image(gray, gray_to_rgb=True))
    assert ingest.load_rgb_image(db / "nothing") is None
    img = ingest.load_rgb_image(db / "Images" / "aeroplane_pascal" / "2000_000000")
    objs = ingest.load_record_objects(db / "Annotations" / "aeroplane_pascal" / "2000_000000.mat")
    far = dataclasses.replace(objs[0], bbox=np.array([500.0, 1.0, 600.0, 9.0]))
    kept = ingest._filter_objects([*objs, far], img)
    assert kept == objs and ingest._bad_bbox(far, img) == jax_ingest._bad_bbox(far, img)


@pytest.mark.parametrize("workers", [1, 2])
def test_prepare_pascal3d_matches_jax(release, tmp_path, workers):
    """The port's walk writes the JAX package's trees: train/, test/,
    augmented2/, original/ with their info files, and dbinfo.mat; the same
    summary; the index files cellstr."""
    db, voc, want, summary = release
    got = ingest.prepare_pascal3d(db, voc, tmp_path / "port", classes=CLASSES,
                                  workers=workers, log=lambda s: None)
    assert got == summary
    assert same_tree(want, tmp_path / "port", approx={"ydata": 1e-6}) > 200
    for tree in ("train", "test", "augmented2", "original"):
        assert_cellstr(tmp_path / "port" / tree / "bicycle_info.mat")


@pytest.mark.parametrize("workers", [1, 2])
def test_prepare_objectnet3d_matches_jax(tmp_path, workers):
    """ObjectNet3D: 8 crops an object in train/ (flips x rotations), one in
    test/, the info files and dbinfo.mat, as the JAX walk writes them."""
    db = generate_objectnet3d_release(tmp_path / "release", classes=O3D_CLASSES)
    want = jax_ingest.prepare_objectnet3d(db, tmp_path / "jax", log=lambda s: None)
    got = ingest.prepare_objectnet3d(db, tmp_path / "port", workers=workers, log=lambda s: None)
    assert got == want and sum(v["train"] for v in got.values()) > 0
    assert same_tree(tmp_path / "jax", tmp_path / "port") > 20


# --- the detector parsers and the detection sets --------------------------------------


def _vk_fixture(path, rng, n):
    """VOC2012_val_det.mat: 20-class chosenboxes/topscores cells."""
    chosen = np.empty((1, 20), object)
    tops = np.empty((1, 20), object)
    for c in range(20):
        boxes = np.empty((1, n), object)
        scores = np.empty((1, n), object)
        for i in range(n):
            k = int(rng.integers(0, 3)) if c in (0, 3) else 0
            boxes[0, i] = rng.uniform(0, 60, (k, 4)) + [0, 0, 30, 30]
            scores[0, i] = rng.uniform(0, 1, (k, 1))
        chosen[0, c] = boxes
        tops[0, c] = scores
    f = path / "VOC2012_val_det.mat"
    spio.savemat(str(f), {"chosenboxes": chosen, "topscores": tops})
    return f


def _same_dets(got, want) -> None:
    assert len(got) == len(want)
    for (b, l), (wb, wl) in zip(got, want, strict=True):
        assert b.dtype == wb.dtype and l.dtype == wl.dtype
        np.testing.assert_array_equal(b, wb)
        np.testing.assert_array_equal(l, wl)


@pytest.mark.parametrize("detector", ["vk", "r4cnn", "maskrcnn", "objectnet"])
def test_detection_parsers_match_jax(release, tmp_path, detector):
    """Each parser returns the JAX parser's boxes (with their score column),
    labels (1-based) and, for ObjectNet3D, names, scores and poses."""
    rng = np.random.default_rng(0)
    if detector == "vk":
        f = _vk_fixture(tmp_path, rng, 4)
        _same_dets(ingest.parse_vk_detections(f, num_images=4),
                   jax_ingest.parse_vk_detections(f, num_images=4))
    elif detector == "r4cnn":
        for cls in CLASSES:
            cell = np.empty((1, 3), object)
            for i in range(3):
                cell[0, i] = rng.uniform(0, 50, (int(rng.integers(0, 3)), 5))
            spio.savemat(str(tmp_path / f"{cls}_pruned_boxes_voc_2012_val_bbox_reg.mat"),
                         {"boxes": cell})
        _same_dets(ingest.parse_r4cnn_detections(tmp_path, classes=CLASSES, num_images=3),
                   jax_ingest.parse_r4cnn_detections(tmp_path, classes=CLASSES, num_images=3))
    elif detector == "maskrcnn":
        _, voc, _, _ = release
        names = ingest.read_image_set(voc / "ImageSets" / "Main" / "val.txt")
        rows = [f"{n} 5 5 40 40 0.{9 - i}" for i, n in enumerate(names[:3])] + ["short row"]
        (tmp_path / "results_aeroplane.txt").write_text("\n".join(rows) + "\n")
        (tmp_path / "results_bicycle.txt").write_text(f"{names[0]} 1 2 30 31 0.5\n")
        _same_dets(ingest.parse_maskrcnn_results(tmp_path, names + ["none"], classes=CLASSES),
                   jax_ingest.parse_maskrcnn_results(tmp_path, names + ["none"], classes=CLASSES))
    else:
        f = tmp_path / "detections_bed.txt"
        f.write_text("o3dval_00000 1 2 30 40 0.8 0.1 0.2 0.3\nshort\n"
                     "o3dval_00001 5 6 50 60 0.7 -0.1 0.0 0.4\n")
        got, want = ingest.parse_objectnet_detections(f), jax_ingest.parse_objectnet_detections(f)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("workers", [1, 2])
def test_prepare_detection_set_matches_jax(release, tmp_path, workers):
    """prepare_detection_set over the VOC val images (boxes with scores, an
    image without detections, a name with no image file): the same
    dbinfo.mat (cellstr) and all/<image>.mat files."""
    _, voc, _, _ = release
    names = ingest.read_image_set(voc / "ImageSets" / "Main" / "val.txt") + ["2099_000900"]
    rows = "".join(f"{n} {3 + i} 4 {50 + i} 60 0.{8 - i}\n" for i, n in enumerate(names[:3]))
    (tmp_path / "results_aeroplane.txt").write_text(rows + f"{names[-1]} 1 1 20 20 0.3\n")
    dets = jax_ingest.parse_maskrcnn_results(tmp_path, names, classes=CLASSES)
    jax_ingest.prepare_detection_set(voc / "JPEGImages", names, dets, tmp_path / "jax", size=32)
    ingest.prepare_detection_set(voc / "JPEGImages", names, dets, tmp_path / "port", size=32,
                                 workers=workers)
    assert same_tree(tmp_path / "jax", tmp_path / "port") == len(names) + 1
    assert_cellstr(tmp_path / "port" / "dbinfo.mat")


def test_prepare_objectnet_detected_matches_jax(tmp_path):
    """The setupDataDetected_objectnet3d.m script: <cls>_detinfo.mat, the
    per-class crop trees (a box larger than the crop size downscaled, a
    small one kept, a row whose image is missing skipped) and the
    detection set, as the JAX function writes them; the same count."""
    rng = np.random.default_rng(0)
    img_dir = tmp_path / "Images"
    img_dir.mkdir()
    for name, hw in (("o3d_000", (300, 400)), ("o3d_001", (80, 90))):
        Image.fromarray(rng.integers(0, 256, (*hw, 3), np.uint8)).save(img_dir / f"{name}.JPEG")
    det_dir = tmp_path / "dets"
    det_dir.mkdir()
    (det_dir / "detections_bed.txt").write_text(
        "o3d_000 10 10 350 280 0.9 0.1 0.2 0.3\no3d_001 5 5 40 50 0.8 0.0 -0.1 0.2\n"
        "o3d_999 5 5 40 50 0.6 0.0 -0.1 0.2\n")
    (det_dir / "detections_chair.txt").write_text("o3d_000 20 30 200 150 0.7 0.3 0.0 0.1\n")
    n = {sub: mod.prepare_objectnet_detected(det_dir, img_dir, tmp_path / sub,
                                             classes=("bed", "chair"), size=64)
         for mod, sub in ((jax_ingest, "jax"), (ingest, "port"))}
    assert n["port"] == n["jax"] == 3
    assert same_tree(tmp_path / "jax", tmp_path / "port") == 9
