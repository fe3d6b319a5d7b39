"""The port's packed crop caches (data/packed.py) vs the JAX package's, on CPU.

Trees are written inside tmp_path by the JAX package's tools/synthetic
(3 classes, 24 px PNGs, a few images each); the .mat crop sets by scipy in
the Pascal3dAll layout. The same tree and the same seed go through both
packages. Tolerances: caches, meta.json and loader batches byte-equal.
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import scipy.io as spio

from multi_modal_regression_tpu.data import index as jax_index
from multi_modal_regression_tpu.data import packed as jax_packed
from multi_modal_regression_tpu.tools.synthetic import (
    generate_pose_dataset as jax_generate_pose_dataset,
)
from multi_modal_regression_tpu_torch import PASCAL3D_CLASSES
from multi_modal_regression_tpu_torch.data import index, loader, native, packed

CLASSES = PASCAL3D_CLASSES[:3]


@pytest.fixture(scope="module")
def tree(tmp_path_factory) -> Path:
    """A train tree (5-7 PNGs a class) and a test tree (3-5), 24 px."""
    root = tmp_path_factory.mktemp("tree")
    jax_generate_pose_dataset(root / "train", CLASSES, 5, 24, seed=1, pattern="pose")
    jax_generate_pose_dataset(root / "test", CLASSES, 3, 24, seed=2)
    return root


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


def _indices(tree: Path, kind: str):
    """(port index, JAX index) of one kind over the same tree."""
    if kind == "balanced":
        return (index.ClassBalancedIndex(str(tree / "train"), "real", CLASSES),
                jax_index.ClassBalancedIndex(str(tree / "train"), "real", CLASSES))
    return (index.FlatTestIndex(str(tree / "test"), CLASSES),
            jax_index.FlatTestIndex(str(tree / "test"), CLASSES))


def _assert_same_files(a: Path, b: Path) -> None:
    names = sorted(p.name for p in a.iterdir())
    assert names == sorted(p.name for p in b.iterdir())
    assert "meta.json" in names and len(names) > 1
    for n in names:
        assert (a / n).read_bytes() == (b / n).read_bytes(), n


class _Decodes:
    """Counts the decodes of one package's pack_index (native and PIL)."""

    def __init__(self, monkeypatch, module):
        self.n = 0
        for name in ("decode_image", "_decode_image_pil"):
            monkeypatch.setattr(module, name, self._wrap(getattr(module, name)))
        monkeypatch.setattr(module.native, "decode_batch_native",
                            self._wrap(module.native.decode_batch_native))

    def _wrap(self, fn):
        def counted(*a, **k):
            self.n += 1
            return fn(*a, **k)
        return counted


@pytest.mark.parametrize("route", ["native", "pil"])
@pytest.mark.parametrize("kind", ["balanced", "flat"])
def test_pack_index_matches_jax(tree, tmp_path, monkeypatch, kind, route):
    """pack_index of the same index writes the JAX package's files byte for
    byte (<cls>.npy and meta.json), whether the port decodes natively or
    with PIL (`native._load` patched to None), at the tree's size and
    resized to 16 px."""
    if route == "pil":
        monkeypatch.setattr(native, "_load", lambda: None)
    pidx, jidx = _indices(tree, kind)
    for size in (24, 16):
        got = packed.pack_index(pidx, tmp_path / f"port{size}", image_size=size, num_workers=2)
        want = jax_packed.pack_index(jidx, tmp_path / f"jax{size}", image_size=size,
                                     num_workers=2)
        _assert_same_files(got.cache_dir, want.cache_dir)
        assert got.meta == want.meta and got.image_size == size
        cls = CLASSES[1]
        names = list(got.meta["classes"][cls])[::-1]
        np.testing.assert_array_equal(got.rows(cls, names), want.rows(cls, names))
        assert got.array(cls).shape == (len(names), size, size, 3)
    assert not [p for p in tmp_path.iterdir() if ".tmp-" in p.name]


@pytest.mark.parametrize("first", ["port", "jax"])
def test_each_package_adopts_the_others_cache(tree, tmp_path, monkeypatch, first):
    """A cache packed by one package is adopted by the other with no decode;
    a touched file (new mtime) makes the adopter repack, and the repacked
    cache is adopted back without a decode."""
    pidx, jidx = _indices(tree, "balanced")
    builders = {"port": (packed, pidx), "jax": (jax_packed, jidx)}
    second = "jax" if first == "port" else "port"
    cache = tmp_path / "cache"
    mod, idx = builders[first]
    mod.pack_index(idx, cache, image_size=24, num_workers=2)
    other, oidx = builders[second]
    decodes = _Decodes(monkeypatch, other)
    adopted = other.pack_index(oidx, cache, image_size=24, num_workers=2)
    assert decodes.n == 0 and adopted.cache_dir == cache
    before = json.loads((cache / "meta.json").read_text())["fingerprint"]
    png = tree / "train" / CLASSES[0] / f"{pidx.image_names[0][0]}.png"
    st = png.stat()
    try:
        os.utime(png, ns=(st.st_atime_ns, st.st_mtime_ns + 10**9))
        repacked = other.pack_index(oidx, cache, image_size=24, num_workers=2)
        assert decodes.n > 0
        fp = repacked.meta["fingerprint"]
        assert fp[CLASSES[0]] != before[CLASSES[0]] and fp[CLASSES[1]] == before[CLASSES[1]]
        back = _Decodes(monkeypatch, mod)
        mod.pack_index(idx, cache, image_size=24, num_workers=2)
        assert back.n == 0
    finally:
        os.utime(png, ns=(st.st_atime_ns, st.st_mtime_ns))


@pytest.mark.parametrize("size", [20, 16])
def test_pack_mat_index_matches_jax(mat_tree, tmp_path, size):
    """pack_mat_index writes the JAX package's crops_<cls>.npy,
    ydata_<cls>.npy and meta.json byte for byte (crops kept at 20 px or
    resized to 16), and each package adopts the other's cache as it is
    (no file rewritten)."""
    pidx = index.MatCropIndex(str(mat_tree), "test", CLASSES)
    jidx = jax_index.MatCropIndex(str(mat_tree), "test", CLASSES)
    got = packed.pack_mat_index(pidx, tmp_path / "port", image_size=size, num_workers=2)
    want = jax_packed.pack_mat_index(jidx, tmp_path / "jax", image_size=size, num_workers=2)
    _assert_same_files(got.cache_dir, want.cache_dir)
    np.testing.assert_array_equal(got.file_rows, want.file_rows)
    stamps = {d: [p.stat().st_mtime_ns for p in sorted(d.iterdir())]
              for d in (got.cache_dir, want.cache_dir)}
    assert packed.pack_mat_index(pidx, tmp_path / "jax", image_size=size).meta == want.meta
    assert jax_packed.pack_mat_index(jidx, tmp_path / "port", image_size=size).meta == got.meta
    for d, before in stamps.items():
        assert [p.stat().st_mtime_ns for p in sorted(d.iterdir())] == before


def _assert_batches_equal(got: list[dict], want: list[dict]) -> None:
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            assert g[k].dtype == w[k].dtype and g[k].shape == w[k].shape, k
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)


def _two_epochs(ld) -> list[dict]:
    return list(ld) + list(ld)


HOSTS = [(1, 0), (2, 0), (2, 1)]


@pytest.fixture(scope="module")
def packs(tree, tmp_path_factory) -> dict:
    """The train and test trees packed once by each package at 24 px."""
    root = tmp_path_factory.mktemp("packs")
    out = {}
    for kind in ("balanced", "flat"):
        pidx, jidx = _indices(tree, kind)
        out[kind] = (packed.pack_index(pidx, root / f"port_{kind}", 24, num_workers=2),
                     jax_packed.pack_index(jidx, root / f"jax_{kind}", 24, num_workers=2))
    return out


@pytest.mark.parametrize("hosts", HOSTS, ids=str)
def test_packed_balanced_loader_matches_jax_and_png(tree, packs, hosts):
    """Two epochs of PackedBalancedLoader from one seed: byte-equal to the
    JAX PackedBalancedLoader and to the port's BalancedLoader (PNG decode),
    per-class reshuffles included."""
    host_count, host_index = hosts
    kw = dict(items_per_batch=2, seed=3, host_count=host_count, host_index=host_index)
    ppack, jpack = packs["balanced"]
    idx = [_indices(tree, "balanced") for _ in range(2)]
    got = packed.PackedBalancedLoader(idx[0][0], ppack, **kw)
    want = jax_packed.PackedBalancedLoader(idx[0][1], jpack, **kw)
    png = loader.BalancedLoader(idx[1][0], image_size=24, num_workers=2, **kw)
    assert len(got) == len(want) == len(png) and got.batch_images == 6
    for _ in range(2):
        g = list(got)
        _assert_batches_equal(g, list(want))
        _assert_batches_equal(g, list(png))


@pytest.mark.parametrize("hosts", HOSTS, ids=str)
def test_packed_flat_and_test_loaders_match_jax_and_png(tree, packs, hosts):
    """PackedFlatLoader (shuffled, drop-last) and PackedTestLoader (in order,
    the last batch padded) over two epochs: byte-equal to the JAX packed
    loaders and to the port's FlatLoader and TestLoader."""
    host_count, host_index = hosts
    hk = dict(host_count=host_count, host_index=host_index)
    ppack, jpack = packs["flat"]
    pidx, jidx = _indices(tree, "flat")
    flat = dict(batch_size=3, seed=5, **hk)
    got = _two_epochs(packed.PackedFlatLoader(pidx, ppack, **flat))
    _assert_batches_equal(got, _two_epochs(jax_packed.PackedFlatLoader(jidx, jpack, **flat)))
    _assert_batches_equal(got, _two_epochs(
        loader.FlatLoader(pidx, image_size=24, num_workers=2, **flat)))
    got = _two_epochs(packed.PackedTestLoader(pidx, ppack, batch_size=5, **hk))
    _assert_batches_equal(got, _two_epochs(
        jax_packed.PackedTestLoader(jidx, jpack, batch_size=5, **hk)))
    _assert_batches_equal(got, _two_epochs(
        loader.TestLoader(pidx, 5, 24, num_workers=2, **hk)))
    n = len(range(host_index, len(pidx), host_count))
    assert sum(int(b["valid"].sum()) for b in got) == 2 * n
    with pytest.raises(ValueError, match="pack is 24px"):
        packed.PackedTestLoader(pidx, ppack, batch_size=5, image_size=16)


@pytest.mark.parametrize("hosts", HOSTS, ids=str)
def test_packed_mat_crop_loader_matches_jax_and_mat(mat_tree, tmp_path, hosts):
    """PackedMatCropLoader over two epochs: byte-equal to the JAX one and to
    the port's MatCropLoader (per-file loadmat + resize) at 16 px."""
    host_count, host_index = hosts
    pidx = index.MatCropIndex(str(mat_tree), "test", CLASSES)
    jidx = jax_index.MatCropIndex(str(mat_tree), "test", CLASSES)
    ppack = packed.pack_mat_index(pidx, tmp_path / "port", 16, num_workers=2)
    jpack = jax_packed.pack_mat_index(jidx, tmp_path / "jax", 16, num_workers=2)
    kw = dict(batch_size=4, host_count=host_count, host_index=host_index)
    got = _two_epochs(packed.PackedMatCropLoader(pidx, ppack, **kw))
    _assert_batches_equal(got, _two_epochs(jax_packed.PackedMatCropLoader(jidx, jpack, **kw)))
    _assert_batches_equal(got, _two_epochs(
        loader.MatCropLoader(pidx, image_size=16, num_workers=2, **kw)))


def test_default_cache_dir_matches_jax(tmp_path):
    """`--packed-cache auto` names the same directory in both packages."""
    for kw in ({}, {"kind": "mat", "split": "val"}, {"split": "test"}):
        assert (packed.default_cache_dir(tmp_path / "train", 224, **kw)
                == jax_packed.default_cache_dir(tmp_path / "train", 224, **kw))
    assert packed.default_cache_dir(tmp_path / "t", 32) == tmp_path / ".packed" / "t_32px"


def test_build_machinery(tree, tmp_path):
    """A sibling tmp build dir with fresh activity counts as a live builder
    and survives the orphan sweep; one older than the age limit is swept;
    a waiting packer with no grace and no live builder builds itself."""
    cache = tmp_path / "cache"
    live = packed._fresh_tmp_dir(cache)
    stale = tmp_path / ".cache.stale-1"
    stale.mkdir()
    old = packed._fresh_tmp_dir(cache)
    (old / "x.npy").write_bytes(b"0")
    for p in (old / "x.npy", old, stale):
        os.utime(p, (1.0, 1.0))
    assert packed._builder_active(cache)
    packed._sweep_orphans(cache)
    assert live.exists() and not old.exists() and not stale.exists()
    with packed._Heartbeat(live):
        assert (live / ".alive").exists()
    assert not (live / ".alive").exists()
    live.rmdir()
    assert not packed._builder_active(cache)
    pidx, _ = _indices(tree, "flat")
    got = packed.pack_index(pidx, cache, 24, num_workers=2, wait_for_builder=True,
                            wait_grace_s=0.0)
    assert got.cache_dir == cache and (cache / "meta.json").exists()
    assert packed.pack_index(pidx, cache, 24, wait_for_builder=True).meta == got.meta
