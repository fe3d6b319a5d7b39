"""The port's host input pipeline and metrics vs the JAX package, on CPU.

Trees are written inside tmp_path by the JAX package's tools/synthetic
(3 classes, 16-32 px PNGs, a few images each); the .mat crop sets by
scipy in the Pascal3dAll layout. The same tree and the same seed go
through both packages. Tolerances: loaders, decode and the synthetic
writer byte-equal; metrics within 1e-12 in float64.
"""

import os
import warnings
from pathlib import Path

import numpy as np
import pytest
import scipy.io as spio
from PIL import Image

from multi_modal_regression_tpu.data import index as jax_index
from multi_modal_regression_tpu.data import loader as jax_loader
from multi_modal_regression_tpu.data import native as jax_native
from multi_modal_regression_tpu.metrics import pose_error as jax_pose_error
from multi_modal_regression_tpu.tools.synthetic import (
    generate_pose_dataset as jax_generate_pose_dataset,
)
from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES
from multi_modal_regression_tpu_torch.data import index, loader, native
from multi_modal_regression_tpu_torch.metrics import pose_error
from multi_modal_regression_tpu_torch.tools.synthetic import generate_pose_dataset

CLASSES = PASCAL3D_CLASSES[:3]


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    """A train tree (5-7 PNGs a class, 24 px) and a test tree (3-5, 24 px)."""
    root = tmp_path_factory.mktemp("tree")
    jax_generate_pose_dataset(root / "train", CLASSES, 5, 24, seed=1, pattern="pose")
    jax_generate_pose_dataset(root / "test", CLASSES, 3, 24, seed=2)
    return root


def _assert_batches_equal(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _two_epochs(ld) -> list[dict]:
    return list(ld) + list(ld)


@pytest.mark.parametrize("hosts", [(1, 0), (2, 0), (2, 1)], ids=str)
@pytest.mark.parametrize("size", [24, 16])
def test_balanced_loader_matches_jax(tree, hosts, size):
    """Two epochs of class-balanced batches from one seed: the same images
    (resized to 16 px or not), Euler angles, labels and per-class shuffles,
    for one host and for each of two."""
    host_count, host_index = hosts
    kw = dict(items_per_batch=2, image_size=size, seed=3, num_workers=2,
              host_count=host_count, host_index=host_index)
    for db_type in ("real", "render"):
        jidx = jax_index.ClassBalancedIndex(str(tree / "train"), db_type, CLASSES)
        pidx = index.ClassBalancedIndex(str(tree / "train"), db_type, CLASSES)
        jl, pl = jax_loader.BalancedLoader(jidx, **kw), loader.BalancedLoader(pidx, **kw)
        assert len(pl) == len(jl) and pl.batch_images == jl.batch_images
        for _ in range(2):
            _assert_batches_equal(list(pl), list(jl))
            for a, b in zip(pidx.image_names, jidx.image_names):
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hosts", [(1, 0), (2, 1)], ids=str)
def test_flat_and_test_loaders_match_jax(tree, hosts):
    """FlatLoader (shuffled, drop-last) and TestLoader (in order, the last
    batch padded with zeros and `valid` False) over two epochs."""
    host_count, host_index = hosts
    hk = dict(num_workers=2, host_count=host_count, host_index=host_index)
    jidx = jax_index.FlatTestIndex(str(tree / "test"), CLASSES)
    pidx = index.FlatTestIndex(str(tree / "test"), CLASSES)
    assert len(pidx) == len(jidx) == 12
    for i in range(len(pidx)):
        assert pidx.path(i) == jidx.path(i)
        np.testing.assert_array_equal(pidx.euler(i), jidx.euler(i))
    flat = dict(batch_size=3, image_size=24, seed=5, **hk)
    _assert_batches_equal(_two_epochs(loader.FlatLoader(pidx, **flat)),
                          _two_epochs(jax_loader.FlatLoader(jidx, **flat)))
    got = _two_epochs(loader.TestLoader(pidx, 5, 16, **hk))
    _assert_batches_equal(got, _two_epochs(jax_loader.TestLoader(jidx, 5, 16, **hk)))
    n = len(range(host_index, 12, host_count))
    assert sum(int(b["valid"].sum()) for b in got) == 2 * n
    assert not got[-1]["valid"][-1] and not got[-1]["xdata"][-1].any()


@pytest.fixture(scope="module")
def mat_tree(tmp_path_factory) -> Path:
    """Pascal3dAll layout: `<cls>_info.mat` name lists and per-image .mat
    crop sets of 1-3 crops, 20 px, with axis-angle ydata."""
    root = tmp_path_factory.mktemp("mat")
    rng = np.random.default_rng(4)
    for ci, cls in enumerate(CLASSES):
        (root / cls).mkdir()
        names = [f"{cls}_{i}" for i in range(2 + ci)]
        for name in names:
            n = int(rng.integers(1, 4))
            spio.savemat(str(root / cls / f"{name}.mat"), {
                "xdata": rng.integers(0, 256, (n, 20, 20, 3), np.uint8),
                "ydata": rng.standard_normal((n, 3)).astype(np.float32),
            })
        spio.savemat(str(root / f"{cls}_info.mat"), {
            "pascal_val": np.array(names, dtype=object),
            "pascal_train": np.array(names[:1], dtype=object),
        })
    return root


@pytest.mark.parametrize("split", ["test", "val"])
@pytest.mark.parametrize("size", [None, 16])
@pytest.mark.parametrize("hosts", [(1, 0), (2, 1)], ids=str)
def test_mat_crop_loader_matches_jax(mat_tree, split, size, hosts):
    """MatCropIndex and MatCropLoader: crops flattened into padded batches
    of 4, resized with PIL or kept, ydata passed through, two epochs."""
    host_count, host_index = hosts
    jidx = jax_index.MatCropIndex(str(mat_tree), split, CLASSES)
    pidx = index.MatCropIndex(str(mat_tree), split, CLASSES)
    np.testing.assert_array_equal(pidx.image_names, jidx.image_names)
    np.testing.assert_array_equal(pidx.labels, jidx.labels)
    kw = dict(batch_size=4, image_size=size, num_workers=2,
              host_count=host_count, host_index=host_index)
    _assert_batches_equal(_two_epochs(loader.MatCropLoader(pidx, **kw)),
                          _two_epochs(jax_loader.MatCropLoader(jidx, **kw)))
    x, y = loader.load_mat_crops(pidx.path(0), size)
    jx, jy = jax_loader.load_mat_crops(jidx.path(0), size)
    np.testing.assert_array_equal(x, jx)
    np.testing.assert_array_equal(y, jy)


@pytest.fixture(scope="module")
def png_zoo(tmp_path_factory) -> list[Path]:
    """8-bit RGB PNGs of several sizes, a gray and a palette PNG (the
    native path decodes them), an RGBA and a 16-bit one (it refuses them)."""
    root = tmp_path_factory.mktemp("pngs")
    rng = np.random.default_rng(42)
    paths = []
    for i, (h, w) in enumerate([(24, 24), (33, 17), (16, 40)]):
        p = root / f"rgb{i}.png"
        Image.fromarray(rng.integers(0, 256, (h, w, 3), np.uint8)).save(p)
        paths.append(p)
    for name, img in (
        ("gray.png", Image.fromarray(rng.integers(0, 256, (20, 30), np.uint8))),
        ("palette.png", Image.fromarray(rng.integers(0, 256, (18, 22, 3), np.uint8))
         .convert("P", palette=Image.ADAPTIVE)),
        ("rgba.png", Image.fromarray(rng.integers(0, 256, (21, 21, 4), np.uint8))),
        ("gray16.png", Image.fromarray(rng.integers(0, 65536, (19, 23), np.uint16))),
    ):
        img.save(root / name)
        paths.append(root / name)
    return paths


@pytest.mark.parametrize("route", ["native", "pil"])
@pytest.mark.parametrize("size", [24, 16, 40])
def test_decode_matches_jax(png_zoo, monkeypatch, route, size):
    """decode_image and the batch decode equal the JAX decode_image byte for
    byte, resized or not, through the port's native library (files it
    refuses through PIL) and through PIL alone (no library)."""
    if route == "native":
        assert native.available()
    else:
        monkeypatch.setattr(native, "_load", lambda: None)
    paths = [str(p) for p in png_zoo]
    want = np.stack([jax_loader.decode_image(p, size) for p in paths])
    got = np.stack([loader.decode_image(p, size) for p in paths])
    np.testing.assert_array_equal(got, want)
    with loader.cf.ThreadPoolExecutor(2) as pool:
        np.testing.assert_array_equal(loader._decode_many(paths, size, pool, 2), want)


def test_native_library_builds_in_the_port_tree():
    """The port builds its own decode.cc (a byte copy of the JAX package's)
    into build/native of the checkout, never into the JAX package's cache."""
    assert native.available()
    port_root = Path(loader.__file__).resolve().parents[2]
    so = Path(native._lib._name)
    assert so == native.library_path() and so.parent == port_root / "build" / "native"
    assert not so.is_relative_to(jax_native._cache_dir())
    assert native._SRC.read_bytes() == jax_native._SRC.read_bytes()


def test_save_png_round_trips(tmp_path, monkeypatch):
    """save_png writes pixels that read back equal, natively and with PIL."""
    img = np.random.default_rng(6).integers(0, 256, (13, 29, 3), np.uint8)
    native.save_png(img, tmp_path / "a.png")
    monkeypatch.setattr(native, "_load", lambda: None)
    native.save_png(img, tmp_path / "b.png")
    for name in ("a.png", "b.png"):
        with Image.open(tmp_path / name) as f:
            np.testing.assert_array_equal(np.asarray(f.convert("RGB")), img)


@pytest.mark.parametrize("pattern", ["pose", "noise"])
def test_synthetic_dataset_matches_jax(tmp_path, pattern):
    """generate_pose_dataset writes the same file names and pixels as the
    JAX package's, and the same `<cls>_info.mat` name lists."""
    kw = dict(classes=CLASSES, images_per_class=2, image_size=20, seed=7,
              pattern=pattern, write_info_mat=True)
    generate_pose_dataset(tmp_path / "port", **kw)
    jax_generate_pose_dataset(tmp_path / "jax", **kw)
    files = sorted(p.relative_to(tmp_path / "jax") for p in (tmp_path / "jax").rglob("*.png"))
    assert files == sorted(
        p.relative_to(tmp_path / "port") for p in (tmp_path / "port").rglob("*.png"))
    assert len(files) == 2 + 3 + 4
    for f in files:
        with Image.open(tmp_path / "port" / f) as a, Image.open(tmp_path / "jax" / f) as b:
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for cls in CLASSES:
        got = spio.loadmat(str(tmp_path / "port" / f"{cls}_info.mat"), squeeze_me=True)
        want = spio.loadmat(str(tmp_path / "jax" / f"{cls}_info.mat"), squeeze_me=True)
        np.testing.assert_array_equal(got["image_names"], want["image_names"])


def _poses(rng, n: int) -> np.ndarray:
    v = rng.standard_normal((n, 3))
    v = v / np.linalg.norm(v, axis=1, keepdims=True) * rng.uniform(0, np.pi, (n, 1))
    v[:2] = 0.0  # identity poses
    v[2] = 1e-8  # under the exp map's identity threshold
    return v


def _close(got, want) -> None:
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_pose_error_metrics_match_jax():
    """Every metric of metrics/pose_error on seeded float64 poses, both
    geodesic conventions and quaternions, with labels that leave class 3 of
    4 without rows: within 1e-12 of the JAX package's (NaN where it is)."""
    rng = np.random.default_rng(8)
    ygt, yhat = _poses(rng, 40), _poses(rng, 40)
    qgt, qhat = (q / np.linalg.norm(q, axis=1, keepdims=True)
                 for q in rng.standard_normal((2, 40, 4)))
    labels = rng.integers(0, 3, 40)
    for conv in ("reference", "matlab"):
        _close(pose_error.geodesic_error_deg(ygt, yhat, conv),
               jax_pose_error.geodesic_error_deg(ygt, yhat, conv))
    _close(pose_error.quaternion_error_deg(qgt, qhat),
           jax_pose_error.quaternion_error_deg(qgt, qhat))
    for rep, (a, b) in (("axis_angle", (ygt, yhat)), ("quaternion", (qgt, qhat))):
        got = pose_error.pose_error_stats(a, b, rep)
        want = jax_pose_error.pose_error_stats(a, b, rep)
        for g, w in zip(got, want):
            _close(g, w)
        for n_cls in (3, 4):
            with warnings.catch_warnings():
                warnings.simplefilter("ignore", RuntimeWarning)  # median of no rows
                got = pose_error.mean_class_median_error(a, b, labels, n_cls, rep)
                want = jax_pose_error.mean_class_median_error(a, b, labels, n_cls, rep)
            assert np.isnan(got) == np.isnan(want) == (n_cls == 4)
            _close(got, want)
        names = ["a", "b", "c", "d"]
        assert pose_error.per_class_report(a, b, labels, names, rep) == \
            jax_pose_error.per_class_report(a, b, labels, names, rep)
    ypred = rng.integers(0, 4, 40)
    with pytest.warns(UserWarning, match="absent"):
        got = pose_error.mean_class_accuracy(labels, ypred, 4)
    with pytest.warns(UserWarning, match="absent"):
        want = jax_pose_error.mean_class_accuracy(labels, ypred, 4)
    _close(got, want)
    with pytest.raises(ValueError, match="representation"):
        pose_error.pose_error_stats(ygt, yhat, "euler")


def test_loader_surfaces_a_producer_failure(tree, tmp_path):
    """A file that cannot be decoded raises in the consumer, after the
    batches before it, instead of ending the epoch early."""
    bad = tmp_path / "t"
    for i, cls in enumerate(CLASSES):
        (bad / cls).mkdir(parents=True)
        for p in sorted((tree / "test" / cls).glob("*.png"))[:2]:
            (bad / cls / p.name).write_bytes(p.read_bytes())
    victim = sorted((bad / CLASSES[2]).glob("*.png"))[0]
    victim.write_bytes(b"not a png")
    ld = loader.TestLoader(index.FlatTestIndex(str(bad), CLASSES), 2, 24, num_workers=2)
    it = iter(ld)
    assert len(next(it)["label"]) == 2 and len(next(it)["label"]) == 2
    with pytest.raises(Exception, match="cannot identify image file"):
        next(it)
    assert os.path.exists(victim)
