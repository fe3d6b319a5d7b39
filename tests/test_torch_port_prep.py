"""The port's data-preparation tools (tools/pascal3d_prep.py and the release
writers of tools/synthetic.py) against the JAX package's, on CPU.

One synthesized PASCAL3D+ release (3 classes, 3 images a split, 96 px) is
written by each package from the same seed. Tolerances: the release writers
byte-equal (the .mat files apart from the creation date in their header);
integer and uint8 outputs exact; float outputs within 1e-6 relative; the
crop writers' file names equal, decoded pixels equal, .mat keys and dtypes
equal with the name arrays cellstr, `ydata` (axis-angle from each
package's so3 in float32) within 1e-6.

`same_tree` is shared with test_torch_port_ingest.py and
test_torch_port_parity_gate.py.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest
import scipy.io as spio
from PIL import Image

from multi_modal_regression_tpu.tools import pascal3d_prep as jax_prep
from multi_modal_regression_tpu.tools import synthetic as jax_synthetic
from multi_modal_regression_tpu.tools.ingest import load_cad_vertices, load_record_objects
from multi_modal_regression_tpu_torch.tools import pascal3d_prep as prep
from multi_modal_regression_tpu_torch.tools import synthetic

from test_torch_port_ops import one_torch_thread  # noqa: F401

CLASSES = ("aeroplane", "bicycle", "boat")
# the .mat index arrays that the readers take as lists of names
NAME_KEYS = ("image_names", "pascal_train", "pascal_val", "imagenet_train", "imagenet_val")
_MAT_META = ("__header__", "__version__", "__globals__")
_DATE = len(b"MATLAB 5.0 MAT-file Platform: posix, Created on:")


def same_mat(a: Path, b: Path, approx: dict | None = None) -> None:
    """Two .mat files hold the same keys, dtypes and values: exact, except
    the keys in `approx` ({key: atol}); object arrays cell by cell. Equal
    dtypes keep a cellstr name array (object dtype) from turning into a
    char matrix."""
    ma, mb = (spio.loadmat(str(p), squeeze_me=False) for p in (a, b))
    keys = sorted(k for k in ma if k not in _MAT_META)
    assert keys == sorted(k for k in mb if k not in _MAT_META), (a, b)
    for k in keys:
        va, vb = ma[k], mb[k]
        assert va.dtype == vb.dtype and va.shape == vb.shape, (a, k, va.dtype, vb.dtype)
        if va.dtype == object:
            for x, y in zip(va.ravel(), vb.ravel(), strict=True):
                x, y = np.asarray(x), np.asarray(y)
                assert x.dtype == y.dtype and x.shape == y.shape, (a, k)
                assert np.array_equal(x, y), (a, k)
        elif approx and k in approx:
            np.testing.assert_allclose(vb, va, rtol=0, atol=approx[k], err_msg=f"{a} {k}")
        else:
            np.testing.assert_array_equal(vb, va, err_msg=f"{a} {k}")


def same_tree(a: Path, b: Path, approx: dict | None = None, skip: tuple = ()) -> int:
    """Two directory trees hold the same relative file names; PNGs decode to
    the same pixels (the encoders may differ), .mat files as `same_mat`,
    other files byte-equal. Paths under a directory named in `skip` are
    left out. Returns the number of files."""

    def files(root: Path) -> list[str]:
        return sorted(str(p.relative_to(root)) for p in root.rglob("*")
                      if p.is_file() and not set(p.relative_to(root).parts) & set(skip))

    names = files(a)
    assert names == files(b), (a, b)
    for rel in names:
        pa, pb = a / rel, b / rel
        if rel.endswith(".png"):
            with Image.open(pa) as x, Image.open(pb) as y:
                assert x.mode == y.mode and x.size == y.size, rel
                assert np.array_equal(np.asarray(x), np.asarray(y)), rel
        elif rel.endswith(".mat"):
            same_mat(pa, pb, approx)
        else:
            assert pa.read_bytes() == pb.read_bytes(), rel
    return len(names)


def assert_cellstr(path: Path) -> None:
    """Every name array of an index file is a cell array of strings."""
    m = spio.loadmat(str(path), squeeze_me=False)
    keys = [k for k in NAME_KEYS if k in m]
    assert keys, path
    for k in keys:
        assert m[k].dtype == object, (path, k, m[k].dtype)


def same_bytes(a: Path, b: Path) -> int:
    """Every file byte-equal; a .mat header's creation date is masked."""
    names = sorted(str(p.relative_to(a)) for p in a.rglob("*") if p.is_file())
    assert names == sorted(str(p.relative_to(b)) for p in b.rglob("*") if p.is_file())
    for rel in names:
        x, y = (a / rel).read_bytes(), (b / rel).read_bytes()
        if rel.endswith(".mat"):
            x, y = x[:_DATE] + x[116:], y[:_DATE] + y[116:]
        assert x == y, rel
    return len(names)


@pytest.fixture(scope="module")
def release(tmp_path_factory):
    """(JAX release root, port release root, VOC dir of the JAX one)."""
    root = tmp_path_factory.mktemp("prep_release")
    db, voc = jax_synthetic.generate_pascal3d_release(root / "jax", classes=CLASSES)
    ours, _ = synthetic.generate_pascal3d_release(root / "port", classes=CLASSES)
    return db, ours, voc


def _image(db: Path, cls: str, name: str, source: str) -> np.ndarray:
    ext = ".JPEG" if source == "imagenet" else ".jpg"
    with Image.open(db / "Images" / f"{cls}_{source}" / f"{name}{ext}") as im:
        return np.asarray(im.convert("RGB"), np.uint8)


def _objects(db: Path, cls: str, name: str, source: str):
    """(the JAX package's annotations, the same as the port's dataclass)."""
    objs = load_record_objects(db / "Annotations" / f"{cls}_{source}" / f"{name}.mat")
    return objs, [prep.ObjectAnnotation(**dataclasses.asdict(o)) for o in objs]


# --- the release writers -------------------------------------------------------------


@pytest.mark.parametrize("kind", ["pascal3d", "objectnet3d", "detection_set"])
def test_release_writers_write_the_same_files(release, tmp_path, kind):
    """The same seed gives the same files, byte for byte: JPEGs, set files,
    annotation records, CAD models, detection crops and their index."""
    if kind == "pascal3d":
        db, ours, _ = release
        assert same_bytes(db, ours) > 100
        return
    if kind == "objectnet3d":
        for pkg, sub in ((jax_synthetic, "jax"), (synthetic, "port")):
            pkg.generate_objectnet3d_release(tmp_path / sub, num_train=4, num_test=3, seed=5)
    else:
        for pkg, sub in ((jax_synthetic, "jax"), (synthetic, "port")):
            pkg.generate_detection_set(tmp_path / sub, num_images=6, seed=7)
    assert same_bytes(tmp_path / "jax", tmp_path / "port") >= 7


# --- the camera model, homography, warp and crops --------------------------------------

POSES = [(30.0, 10.0, -5.0, 4.0), (200.0, -40.0, 25.0, 6.5), (359.0, 44.0, 0.0, 3.0)]


@pytest.mark.parametrize("pose", POSES, ids=lambda p: f"az{p[0]:g}")
def test_camera_model_matches_jax(release, pose):
    """camera_rotation and project_vertices within 1e-6 relative; the
    visibility mask equal."""
    db, _, _ = release
    P = load_cad_vertices(db / "CAD" / "bicycle.mat", "bicycle")[1]
    az, el, ct, d = pose
    np.testing.assert_allclose(prep.camera_rotation(az, el, ct),
                               jax_prep.camera_rotation(az, el, ct), rtol=1e-6, atol=0)
    for got, want in zip(prep.project_vertices(P, az, el, ct, d, 3000.0, 48.0, 40.0),
                         jax_prep.project_vertices(P, az, el, ct, d, 3000.0, 48.0, 40.0),
                         strict=True):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)
    vis = prep.visible_vertices(P, az, el, ct, d)
    assert vis.dtype == bool and 0 < vis.sum() < len(P)
    np.testing.assert_array_equal(vis, jax_prep.visible_vertices(P, az, el, ct, d))


def test_homography_and_warp_match_jax(release):
    """fit_homography between the visible vertices' projections at a pose
    and a perturbed one within 1e-6 relative; warp_image of a release image
    (uint8, 3 channels) and of a bbox mask (2-D) equal, with equal offsets;
    fewer than 4 points refused alike."""
    db, _, _ = release
    P = load_cad_vertices(db / "CAD" / "boat.mat", "boat")[0]
    vis = jax_prep.visible_vertices(P, 40.0, 15.0, 3.0, 5.0)
    src = np.stack(jax_prep.project_vertices(P[vis], 40.0, 15.0, 3.0, 5.0, 3000.0, 48, 48), 1)
    dst = np.stack(jax_prep.project_vertices(P[vis], 41.0, 14.0, 7.0, 5.0, 3000.0, 48, 48), 1)
    H = prep.fit_homography(src, dst)
    np.testing.assert_allclose(H, jax_prep.fit_homography(src, dst), rtol=1e-6, atol=1e-12)
    img = _image(db, "boat", "2002_000000", "pascal")
    mask = np.zeros(img.shape[:2], np.uint8)
    mask[10:60, 20:70] = 255
    for a in (img, mask):
        got, off = prep.warp_image(a, H)
        want, want_off = jax_prep.warp_image(a, H)
        assert got.dtype == np.uint8 and got.shape == want.shape and off == want_off
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match=">= 4"):
        prep.fit_homography(src[:3], dst[:3])


@pytest.mark.parametrize("max_size", [224, 40])
def test_crops_match_jax(release, max_size):
    """crop_patch (downscale-only: at 40 px every box is cut down) and
    crop_patch_resized (to max_size^2) equal on every object of a class's
    pascal images, boxes past the image edge included."""
    db, _, _ = release
    n = 0
    for name in ("2000_000000", "2000_000001", "2000_000100"):
        img = _image(db, "aeroplane", name, "pascal")
        objs, _ = _objects(db, "aeroplane", name, "pascal")
        for o in objs:
            for bbox in (o.bbox, o.bbox + [-5.0, -5.0, 200.0, 200.0]):
                got = prep.crop_patch(img, bbox, max_size)
                want = jax_prep.crop_patch(img, bbox, max_size)
                assert got.dtype == np.uint8 and max(got.shape[:2]) <= max(max_size, 96)
                np.testing.assert_array_equal(got, want)
                got = prep.crop_patch_resized(img, bbox, max_size)
                assert got.shape == (max_size, max_size, 3)
                np.testing.assert_array_equal(got, jax_prep.crop_patch_resized(img, bbox, max_size))
                n += 1
    assert n >= 8


# --- the writers -------------------------------------------------------------------------

# (class, image, source): a pascal image with a usable object of another
# cad_index, an imagenet image with a truncated and an other-class object
IMAGES = [("bicycle", "2001_000001", "pascal"), ("aeroplane", "n02000_train0", "imagenet")]


@pytest.mark.parametrize("writer", ["flipped", "original", "augmented"])
def test_crop_writers_match_jax(release, tmp_path, writer):
    """write_flipped_crops, write_original_crops and write_augmented_crops
    return the same names and write the same files: PNG pixels equal,
    .mat keys and dtypes equal, `xdata` equal, `ydata` within 1e-6."""
    db, _, _ = release
    written = 0
    for cls, name, source in IMAGES:
        img = _image(db, cls, name, source)
        jobjs, objs = _objects(db, cls, name, source)
        iid = name.replace("_", "")
        if writer == "augmented":
            cad = load_cad_vertices(db / "CAD" / f"{cls}.mat", cls)
            got = prep.write_augmented_crops(img, objs, cad, iid, tmp_path / "port", cls)
            want = jax_prep.write_augmented_crops(img, jobjs, cad, iid, tmp_path / "jax", cls)
        elif writer == "original":
            got = prep.write_original_crops(img, objs, name, tmp_path / "port", cls)
            want = jax_prep.write_original_crops(img, jobjs, name, tmp_path / "jax", cls)
        else:
            got = prep.write_flipped_crops(img, objs, iid, tmp_path / "port", cls)
            want = jax_prep.write_flipped_crops(img, jobjs, iid, tmp_path / "jax", cls)
        assert got == want and len(got) >= 1
        written += len(got)
    assert same_tree(tmp_path / "jax", tmp_path / "port", approx={"ydata": 1e-6}) >= written
    if writer == "original":
        y = spio.loadmat(str(tmp_path / "port" / f"{IMAGES[0][1]}.mat"))["ydata"]
        assert y.dtype == np.float32 and y.shape[1] == 3


def test_augmented_patches_match_jax(release):
    """augmented_patches' grid (3 x 3 x 5 poses and their flips) on a usable
    object: the same patches, equal pixels and angles."""
    db, _, _ = release
    cls, name, source = IMAGES[0]
    img = _image(db, cls, name, source)
    jobjs, objs = _objects(db, cls, name, source)
    k = next(i for i, o in enumerate(objs) if o.usable and o.cls == cls)
    cad = load_cad_vertices(db / "CAD" / f"{cls}.mat", cls)
    got = prep.augmented_patches(img, objs[k], cad[objs[k].cad_index])
    want = jax_prep.augmented_patches(img, jobjs[k], cad[jobjs[k].cad_index])
    assert len(got) == len(want) > 2
    for (p, angles), (q, want_angles) in zip(got, want, strict=True):
        assert angles == want_angles and p.dtype == q.dtype
        np.testing.assert_array_equal(p, q)


def test_detection_and_info_writers_match_jax(release, tmp_path):
    """write_detection_crops (an image with two boxes, one with none, one
    missing from the detections) and write_info_mat with its split lists:
    the same files, names cellstr."""
    db, _, _ = release
    images = {n: _image(db, "boat", n, "pascal") for n in
              ("2002_000000", "2002_000001", "2002_000100")}
    boxes = np.array([[5.0, 6.0, 60.0, 70.0], [20.0, 10.0, 90.0, 50.0]])
    dets = {"2002_000000": (boxes, np.array([3, 1])),
            "2002_000001": (np.zeros((0, 4)), np.zeros(0))}
    for mod, sub in ((jax_prep, "jax"), (prep, "port")):
        mod.write_detection_crops(images, dets, tmp_path / sub / "det", size=32)
        mod.write_info_mat(tmp_path / sub, "boat", ["a_1", "b_2"], pascal_train=["a_1"],
                           pascal_val=["b_2"])
        mod.write_info_mat(tmp_path / sub, "bus", ["c_3"], suffix="_x")
    assert same_tree(tmp_path / "jax", tmp_path / "port") == 6
    for f in ("boat_info.mat", "bus_x.mat", "det/dbinfo.mat"):
        assert_cellstr(tmp_path / "port" / f)
    m = spio.loadmat(str(tmp_path / "port" / "boat_info.mat"), squeeze_me=True)
    assert list(m["image_names"]) == ["a_1", "b_2"] and m["pascal_val"] == "b_2"
