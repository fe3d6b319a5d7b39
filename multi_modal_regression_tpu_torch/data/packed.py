"""Pre-decoded uint8 crop caches (the port's copy of the JAX package's
data/packed.py).

The reference ships a pre-decoded fast path: setupDataOriginal_pascal3d.m:
73-124 writes 224x224 crops into per-image .mat files that Pascal3dAll then
reads without touching PNG/JPEG (dataGenerators.py:80-124). The PNG loaders
(data/loader.py) decode and resize every image of every epoch. This module
decodes each class's images once into ONE contiguous uint8 .npy
(memmap-readable), so a training batch becomes a handful of page-cache
slice gathers instead of 96 decodes.

Layout: `<cache_dir>/<cls>.npy` with shape (n_images, S, S, 3) in the
index's canonical name order, plus `meta.json` recording the source path,
image size, per-class name lists (used both to map shuffled names to rows
and to detect a stale cache) and a per-class digest over every file's
(name, size, mtime_ns), so a re-generated tree (even with unchanged names)
is detected as stale. The layout and `meta.json` are the JAX package's byte
for byte, so a cache packed by either package is adopted by the other.
Caches are built in a private uuid-named tmp directory and installed with
one atomic adopt-don't-destroy rename: concurrent packers never observe a
partial cache, never tear down a winner readers already mmap, and a crash
never leaves a torn `meta.json` behind (orphans are age-swept).

`PackedBalancedLoader` / `PackedFlatLoader` / `PackedTestLoader`
reproduce the exact sampling semantics of their PNG counterparts
(class-balanced modulo cycling with per-class reshuffles / shuffled flat
batches / flat padded test batches): they subclass the PNG loaders and
override only the pixel source. `pack_mat_index`/`PackedMatCropLoader`
do the same for the Pascal3dAll .mat crop protocol (per-class crop
memmaps + per-file row ranges), so every input protocol has a packed
fast path.
"""

from __future__ import annotations

import concurrent.futures as cf
import hashlib
import json
import os
import shutil
import time
import uuid
from pathlib import Path
from typing import Iterator, Sequence

import numpy as np

from multi_modal_regression_tpu_torch.data.index import ClassBalancedIndex, FlatTestIndex
from multi_modal_regression_tpu_torch.data import native
from multi_modal_regression_tpu_torch.data.loader import (
    BalancedLoader,
    FlatLoader,
    MatCropLoader,
    TestLoader,
    _decode_image_pil,
    decode_image,
    load_mat_crops,
)


# on-disk layout versions, recorded in meta.json: adopting a cache written
# by an incompatible layout must REPACK, not crash mid-epoch. PNG caches
# default to 1 when absent (the layout never changed); mat caches REQUIRE
# the marker (the pre-format layout used one global crops.npy and 2-wide
# file_rows).
_PNG_FORMAT = 1
_MAT_FORMAT = 2


class PackedCrops:
    """Handle over a packed cache directory: per-class memmaps + name->row."""

    def __init__(self, cache_dir: str | Path):
        self.cache_dir = Path(cache_dir)
        with open(self.cache_dir / "meta.json") as f:
            self.meta = json.load(f)
        self.image_size = int(self.meta["image_size"])
        self._arrays: dict[str, np.ndarray] = {}
        self._rows: dict[str, dict[str, int]] = {}
        for cls, names in self.meta["classes"].items():
            self._rows[cls] = {n: i for i, n in enumerate(names)}

    def array(self, cls: str) -> np.ndarray:
        """The class's (n, S, S, 3) uint8 memmap (opened lazily, cached)."""
        if cls not in self._arrays:
            self._arrays[cls] = np.load(
                self.cache_dir / f"{cls}.npy", mmap_mode="r"
            )
        return self._arrays[cls]

    def rows(self, cls: str, names: Sequence[str]) -> np.ndarray:
        r = self._rows[cls]
        return np.asarray([r[n] for n in names], np.int64)

    def matches(
        self,
        db_path: str,
        per_class: dict[str, list[str]],
        image_size: int,
        fingerprint: dict[str, str],
    ) -> bool:
        """True iff this cache was packed from exactly this source: same
        tree, same per-class name lists, same size, and same per-class
        stat digest (any per-file size/mtime/name change — a re-crop, a
        re-prep, an added or removed image — changes the digest)."""
        return (
            self.meta.get("format", _PNG_FORMAT) == _PNG_FORMAT
            and self.image_size == int(image_size)
            and self.meta.get("db_path") == str(db_path)
            and self.meta.get("classes") == per_class
            and self.meta.get("fingerprint") == fingerprint
        )


def default_cache_dir(
    tree: str | Path,
    image_size: int,
    kind: str | None = None,
    split: str | None = None,
) -> Path:
    """The `--packed-cache auto` layout: caches live NEXT TO their tree
    (`<parent>/.packed/<name>[_<split>]_<size>px[_<kind>]`). One
    definition shared by train/evaluate/predict and `cli pack` (and by the
    JAX package's commands) for BOTH the PNG packs (kind None) and the
    .mat crop packs (kind 'mat', split 'val'/'test'), so the same tree
    never packs twice."""
    tree = Path(tree)
    parts = [tree.name]
    if split:
        parts.append(split)
    parts.append(f"{image_size}px")
    if kind:
        parts.append(kind)
    return tree.parent / ".packed" / "_".join(parts)


def _per_class_names(
    index: ClassBalancedIndex | FlatTestIndex,
) -> dict[str, list[str]]:
    """Canonical-order image names per class (both index kinds)."""
    if isinstance(index, ClassBalancedIndex):
        return {
            cls: [str(n) for n in names]
            for cls, names in zip(index.classes, index.list_image_names)
        }
    return {
        cls: [
            str(n)
            for n, l in zip(index.image_names, index.labels)
            if index.classes[l] == cls
        ]
        for cls in index.classes
    }


def _source_fingerprint(
    db_path: str | Path,
    per_class: dict[str, list[str]],
    suffix: str = ".png",
) -> dict[str, str]:
    """Per-class sha256 over every file's (name, size, mtime_ns).

    One stat per image; ANY per-file change — a rewrite, a re-prep, a
    timestamp-preserving restore whose sizes differ — changes the digest
    (aggregate count/total/newest fingerprints miss restores that keep
    old mtimes). The remaining blind spot is the same as
    make/rsync's: equal-size content swaps under preserved timestamps."""
    fp: dict[str, str] = {}
    for cls, names in per_class.items():
        h = hashlib.sha256()
        for n in names:
            fname = n if n.endswith(suffix) else f"{n}{suffix}"
            st = os.stat(Path(db_path) / cls / fname)
            h.update(f"{n}:{st.st_size}:{st.st_mtime_ns};".encode())
        fp[cls] = h.hexdigest()
    return fp


def _fresh_tmp_dir(cache_dir: Path) -> Path:
    """A collision-proof private build dir: pid alone is NOT unique
    across hosts on a shared filesystem (two --distributed processes on
    different machines can share a pid), so a uuid
    component guarantees no packer ever touches another's live build."""
    tmp = cache_dir.parent / (
        f".{cache_dir.name}.tmp-{os.getpid()}-{uuid.uuid4().hex[:8]}"
    )
    tmp.mkdir(parents=True)
    return tmp


def _atomic_install(tmp: Path, cache_dir: Path, existing):
    """Install a fully built tmp dir as `cache_dir` with one rename.

    Adopt-don't-destroy: if a MATCHING cache appeared while we built
    (`existing()` returns a handle), it is adopted and tmp discarded —
    never tear down a cache concurrent readers may be training from. A
    genuinely stale cache is moved aside before deletion (open memmaps
    stay valid on the unlinked inodes). Returns the adopted handle, or
    None when tmp was installed (caller constructs the fresh handle)."""
    cache_dir.parent.mkdir(parents=True, exist_ok=True)
    for _ in range(2):
        pack = existing()
        if pack is not None:
            shutil.rmtree(tmp, ignore_errors=True)
            return pack
        if cache_dir.exists():
            stale = cache_dir.parent / f".{cache_dir.name}.stale-{os.getpid()}"
            try:
                os.rename(cache_dir, stale)
            except OSError:
                pass  # another packer already moved it
            else:
                shutil.rmtree(stale, ignore_errors=True)
        try:
            os.rename(tmp, cache_dir)
            return None
        except OSError:
            continue  # lost the install race; re-check the winner
    shutil.rmtree(tmp, ignore_errors=True)
    raise RuntimeError(
        f"concurrent pack at {cache_dir} does not match this index; "
        f"remove the directory and re-run"
    )


def _builder_active(cache_dir: Path, fresh_s: float = 60.0) -> bool:
    """True if a sibling tmp build dir shows write activity within
    `fresh_s` — some other process is packing this cache right now."""
    parent = cache_dir.parent
    if not parent.exists():
        return False
    now = time.time()
    for d in parent.iterdir():
        if not d.name.startswith(f".{cache_dir.name}.tmp-"):
            continue
        try:
            newest = max(
                (p.stat().st_mtime for p in d.rglob("*")),
                default=d.stat().st_mtime,
            )
        except OSError:
            continue
        if now - newest < fresh_s:
            return True
    return False


def _wait_for_pack(cache_dir: Path, existing, grace_s: float):
    """Non-builder hosts' path: poll for a finished cache while a builder
    is visibly active (or within the startup grace window in which one
    should appear). Returns the adopted pack, or None when it's time to
    build ourselves (no cache and nobody building).

    The (potentially expensive) `existing()` validation only re-runs when
    meta.json's mtime changes — a stale cache next to a long rebuild is
    not re-parsed every poll."""
    deadline = time.time() + grace_s
    meta = cache_dir / "meta.json"
    last_mtime = -1
    while True:
        try:
            mtime = meta.stat().st_mtime_ns
        except OSError:
            mtime = -2
        if mtime != last_mtime:
            last_mtime = mtime
            pack = existing()
            if pack is not None:
                return pack
        if time.time() >= deadline and not _builder_active(cache_dir):
            return None
        time.sleep(2.0)


class _Heartbeat:
    """Touches `<tmp>/.alive` every 15 s while a pack builds.

    np.save only lands once per CLASS, so a long class decode would look
    dead to _builder_active/_sweep_orphans; the
    heartbeat keeps the tmp dir visibly fresh for waiters and sweepers
    for the whole build."""

    def __init__(self, tmp: Path):
        self._path = tmp / ".alive"
        self._stop = None

    def __enter__(self):
        import threading

        self._stop = threading.Event()
        stop = self._stop
        path = self._path

        def beat():
            while not stop.wait(15.0):
                try:
                    path.touch()
                except OSError:
                    return  # tmp gone (installed or swept): stop quietly

        self._thread = threading.Thread(
            target=beat, name="pack-heartbeat", daemon=True
        )
        path.touch()
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()
        self._path.unlink(missing_ok=True)
        return False


def _sweep_orphans(cache_dir: Path, max_age_s: float = 600.0) -> None:
    """Remove crashed packers' leftovers: sibling `.<name>.tmp-*` /
    `.<name>.stale-*` directories whose newest content mtime is older
    than `max_age_s`. A LIVE concurrent pack keeps its tmp dir fresh
    (np.save streams into it), so the age guard never sweeps an
    in-progress build; a SIGKILLed pack of a production-size tree no
    longer strands tens of GB next to the data."""
    parent = cache_dir.parent
    if not parent.exists():
        return
    now = time.time()
    prefixes = (f".{cache_dir.name}.tmp-", f".{cache_dir.name}.stale-")
    for d in parent.iterdir():
        if not d.name.startswith(prefixes):
            continue
        try:
            newest = max(
                (p.stat().st_mtime for p in d.rglob("*")),
                default=d.stat().st_mtime,
            )
        except OSError:
            continue  # vanished under us (another sweeper)
        if now - newest > max_age_s:
            shutil.rmtree(d, ignore_errors=True)


def pack_index(
    index: ClassBalancedIndex | FlatTestIndex,
    cache_dir: str | Path,
    image_size: int = 224,
    num_workers: int = 8,
    wait_for_builder: bool = False,
    wait_grace_s: float = 120.0,
) -> PackedCrops:
    """Decode every image of `index` once into `<cache_dir>/<cls>.npy`.

    Idempotent: a cache whose source tree, name lists, size, and stat
    fingerprint all match is reused; anything else (including a torn
    meta.json from a crashed pack) triggers a repack. The build happens in
    a sibling tmp directory installed by one atomic rename, so concurrent
    packers on a shared filesystem are safe: the first rename wins and the
    loser adopts the winner's cache.

    wait_for_builder: multi-host etiquette for non-primary processes —
    poll for a finished cache while another process is visibly building
    (fresh tmp-dir activity) or within `wait_grace_s` for one to appear,
    and only fall back to building when nobody is (e.g. the primary
    died). Turns the N-way duplicate decode of a distributed cold start
    into one build + N-1 adoptions.
    """
    cache_dir = Path(cache_dir)
    per_class = _per_class_names(index)
    fingerprint = _source_fingerprint(index.db_path, per_class)

    def _existing() -> PackedCrops | None:
        try:
            pack = PackedCrops(cache_dir)
        except (FileNotFoundError, json.JSONDecodeError, KeyError, OSError):
            return None  # absent, torn, or unreadable -> repack
        if pack.matches(index.db_path, per_class, image_size, fingerprint):
            return pack
        return None

    pack = _existing()
    if pack is not None:
        return pack
    if wait_for_builder:
        pack = _wait_for_pack(cache_dir, _existing, wait_grace_s)
        if pack is not None:
            return pack
    _sweep_orphans(cache_dir)
    tmp = _fresh_tmp_dir(cache_dir)
    with _Heartbeat(tmp):
        for cls, names in per_class.items():
            paths = [
                str(Path(index.db_path) / cls / f"{n}.png") for n in names
            ]
            res = native.decode_batch_native(paths, image_size, num_workers)
            if res is not None:
                # one GIL-free C++ call decodes the whole class in
                # parallel; refused files (alpha/16-bit) fill in via PIL
                out, ok = res
                for i in np.flatnonzero(~ok):
                    out[i] = _decode_image_pil(paths[i], image_size)
            else:  # no native library: PIL decode on a thread pool
                out = np.empty(
                    (len(names), image_size, image_size, 3), np.uint8
                )
                with cf.ThreadPoolExecutor(num_workers) as pool:
                    for i, img in enumerate(
                        pool.map(
                            lambda p: decode_image(p, image_size), paths
                        )
                    ):
                        out[i] = img
            np.save(tmp / f"{cls}.npy", out)
        meta = {
            "format": _PNG_FORMAT,
            "db_path": str(index.db_path),
            "image_size": int(image_size),
            "classes": per_class,
            "fingerprint": fingerprint,
        }
        with open(tmp / "meta.json", "w") as f:
            json.dump(meta, f)
    adopted = _atomic_install(tmp, cache_dir, _existing)
    return adopted if adopted is not None else PackedCrops(cache_dir)


class PackedMatCrops:
    """Handle over a packed .mat-crop cache: per-class crop memmaps +
    ydata arrays + per-file row ranges [class_idx, start, count] in the
    index's file order (host striding runs over FILES, exactly like
    MatCropLoader)."""

    def __init__(self, cache_dir: str | Path):
        self.cache_dir = Path(cache_dir)
        with open(self.cache_dir / "meta.json") as f:
            self.meta = json.load(f)
        self.image_size = int(self.meta["image_size"])
        self.class_list = list(self.meta["classes"])
        self.file_rows = np.asarray(self.meta["file_rows"], np.int64)
        self._crops: dict[str, np.ndarray] = {}
        self._ydata: dict[str, np.ndarray] = {}

    def crops(self, cls: str) -> np.ndarray:
        if cls not in self._crops:
            self._crops[cls] = np.load(
                self.cache_dir / f"crops_{cls}.npy", mmap_mode="r"
            )
        return self._crops[cls]

    def ydata(self, cls: str) -> np.ndarray:
        if cls not in self._ydata:
            self._ydata[cls] = np.load(self.cache_dir / f"ydata_{cls}.npy")
        return self._ydata[cls]

    def matches(
        self,
        db_path: str,
        split: str,
        per_class: dict[str, list[str]],
        image_size: int,
        fingerprint: dict[str, str],
    ) -> bool:
        return (
            # pre-format caches (one global crops.npy, 2-wide file_rows)
            # must repack, not crash on the 3-wide unpack mid-epoch
            self.meta.get("format") == _MAT_FORMAT
            and self.image_size == int(image_size)
            and self.meta.get("db_path") == str(db_path)
            and self.meta.get("split") == split
            and self.meta.get("classes") == per_class
            # dict == is key-order-insensitive but file_rows' class
            # indices are POSITIONAL: a different class order must repack
            and list(self.meta.get("classes", {})) == list(per_class)
            and self.meta.get("fingerprint") == fingerprint
        )


def pack_mat_index(
    index,  # MatCropIndex
    cache_dir: str | Path,
    image_size: int,
    num_workers: int = 8,
    wait_for_builder: bool = False,
    wait_grace_s: float = 120.0,
) -> PackedMatCrops:
    """Pack a MatCropIndex's per-image .mat crop sets (the reference's
    Pascal3dAll eval protocol, dataGenerators.py:80-124) into per-class
    uint8 memmaps + ydata arrays, resized once to `image_size` with the
    SAME code MatCropLoader runs per epoch (loader.load_mat_crops). The
    snapshot-ensemble protocol re-reads the whole test set once PER
    SNAPSHOT (5-9 passes); the pack pays the loadmat+resize cost once.
    Per-class streaming bounds peak RAM by the largest class, like
    pack_index. Same idempotence/staleness/atomicity guarantees."""
    cache_dir = Path(cache_dir)
    per_class: dict[str, list[str]] = {c: [] for c in index.classes}
    for n, l in zip(index.image_names, index.labels):
        per_class[index.classes[l]].append(str(n))
    fingerprint = _source_fingerprint(
        index.db_path, per_class, suffix=".mat"
    )

    def _existing() -> PackedMatCrops | None:
        try:
            pack = PackedMatCrops(cache_dir)
        except (FileNotFoundError, json.JSONDecodeError, KeyError, OSError):
            return None
        if pack.matches(
            index.db_path, index.split, per_class, image_size, fingerprint
        ):
            return pack
        return None

    pack = _existing()
    if pack is not None:
        return pack
    if wait_for_builder:
        pack = _wait_for_pack(cache_dir, _existing, wait_grace_s)
        if pack is not None:
            return pack
    _sweep_orphans(cache_dir)
    tmp = _fresh_tmp_dir(cache_dir)
    rows: list[list[int]] = [[0, 0, 0]] * len(index)
    with _Heartbeat(tmp), cf.ThreadPoolExecutor(num_workers) as pool:
        for ci, cls in enumerate(index.classes):
            positions = np.flatnonzero(np.asarray(index.labels) == ci)
            loaded = list(pool.map(
                lambda i: load_mat_crops(index.path(int(i)), image_size),
                positions,
            ))
            start = 0
            for pos, (x, _) in zip(positions, loaded):
                rows[int(pos)] = [ci, start, len(x)]
                start += len(x)
            crops = (
                np.concatenate([x for x, _ in loaded])
                if loaded
                else np.zeros((0, image_size, image_size, 3), np.uint8)
            )
            ydata = (
                np.concatenate([y for _, y in loaded])
                if loaded
                else np.zeros((0, 3), np.float32)
            )
            np.save(tmp / f"crops_{cls}.npy", crops)
            np.save(tmp / f"ydata_{cls}.npy", ydata)
        meta = {
            "format": _MAT_FORMAT,
            "db_path": str(index.db_path),
            "split": index.split,
            "image_size": int(image_size),
            "classes": per_class,
            "fingerprint": fingerprint,
            "file_rows": rows,
        }
        with open(tmp / "meta.json", "w") as f:
            json.dump(meta, f)
    adopted = _atomic_install(tmp, cache_dir, _existing)
    return adopted if adopted is not None else PackedMatCrops(cache_dir)


class PackedBalancedLoader(BalancedLoader):
    """BalancedLoader with pixels from a PackedCrops cache.

    Sampling semantics (per-class modulo cycling, independent reshuffles,
    host striding, batch layout) are inherited unchanged — only
    `_make_batch` swaps 96 PNG decodes for per-class memmap gathers.
    """

    def __init__(self, index: ClassBalancedIndex, pack: PackedCrops, **kwargs):
        kwargs.setdefault("num_workers", 1)  # gathers are memcpy-bound
        kwargs.setdefault("image_size", pack.image_size)
        super().__init__(index, **kwargs)
        if self.image_size != pack.image_size:
            raise ValueError(
                f"pack is {pack.image_size}px, loader wants {self.image_size}px"
            )
        self.pack = pack

    def _make_batch(self, item_ids: np.ndarray, pool: cf.Executor) -> dict:
        idx = self.index
        C = idx.num_classes
        ipb = len(item_ids)
        S = self.image_size
        x = np.empty((ipb, C, S, S, 3), np.uint8)
        eulers = np.empty((ipb, C, 3), np.float32)
        for c in range(C):
            names = [
                str(idx.image_names[c][int(i) % idx.num_images[c]])
                for i in item_ids
            ]
            rows = self.pack.rows(idx.classes[c], names)
            x[:, c] = self.pack.array(idx.classes[c])[rows]
        for j, i in enumerate(item_ids):
            eulers[j] = idx.item_euler(int(i))
        labels = np.tile(np.arange(C, dtype=np.int32), ipb)
        return {
            "xdata": x.reshape(ipb * C, S, S, 3),
            "euler": eulers.reshape(ipb * C, 3),
            "label": labels,
        }


class PackedFlatLoader(FlatLoader):
    """FlatLoader (the ObjectNet shuffled flat train protocol,
    learnObjectnetBDModel.py:74) with pixels from a PackedCrops cache."""

    def __init__(self, index: FlatTestIndex, pack: PackedCrops, **kwargs):
        kwargs.setdefault("num_workers", 1)
        kwargs.setdefault("image_size", pack.image_size)
        super().__init__(index, **kwargs)
        if self.image_size != pack.image_size:
            raise ValueError(
                f"pack is {pack.image_size}px, loader wants {self.image_size}px"
            )
        self.pack = pack

    def _gen(self, pool: cf.Executor) -> Iterator[dict]:
        n = len(self.index)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        S = self.image_size
        for b in range(len(self)):
            g = (b * self.host_count + self.host_index) * self.batch_size
            ids = order[g : g + self.batch_size]
            xdata = np.empty((len(ids), S, S, 3), np.uint8)
            for j, i in enumerate(ids):
                cls = self.index.classes[self.index.labels[int(i)]]
                row = self.pack.rows(
                    cls, [str(self.index.image_names[int(i)])]
                )[0]
                xdata[j] = self.pack.array(cls)[row]
            yield {
                "xdata": xdata,
                "euler": np.stack(
                    [self.index.euler(int(i)) for i in ids]
                ).astype(np.float32),
                "label": self.index.labels[ids].astype(np.int32),
            }


class PackedMatCropLoader(MatCropLoader):
    """MatCropLoader with crops from a PackedMatCrops cache.

    The file-level iteration order, host striding, buffering, and
    padded-batch semantics are inherited unchanged — only `_load` swaps
    the per-file loadmat+resize for memmap row slices."""

    def __init__(self, index, pack: PackedMatCrops, **kwargs):
        kwargs.setdefault("num_workers", 1)  # slices are memcpy-bound
        kwargs.setdefault("image_size", pack.image_size)
        super().__init__(index, **kwargs)
        if self.image_size not in (None, pack.image_size):
            raise ValueError(
                f"pack is {pack.image_size}px, loader wants {self.image_size}px"
            )
        self.image_size = pack.image_size
        self.pack = pack

    def _load(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        ci, s, n = self.pack.file_rows[i]
        cls = self.pack.class_list[ci]
        return (
            np.asarray(self.pack.crops(cls)[s : s + n]),
            np.asarray(self.pack.ydata(cls)[s : s + n]),
            np.full(n, self.index.labels[i], np.int32),
        )


class PackedTestLoader(TestLoader):
    """TestLoader with pixels from a PackedCrops cache (same padding/valid
    semantics and host striding; flat row order inherited)."""

    def __init__(self, index: FlatTestIndex, pack: PackedCrops, **kwargs):
        kwargs.setdefault("num_workers", 1)
        kwargs.setdefault("image_size", pack.image_size)
        super().__init__(index, **kwargs)
        if self.image_size != pack.image_size:
            raise ValueError(
                f"pack is {pack.image_size}px, loader wants {self.image_size}px"
            )
        self.pack = pack

    def _gen(self, pool: cf.Executor) -> Iterator[dict]:
        all_ids = self._ids()
        n = len(all_ids)
        S = self.image_size
        for start in range(0, n, self.batch_size):
            ids = all_ids[start : start + self.batch_size]
            xdata = np.empty((len(ids), S, S, 3), np.uint8)
            for j, i in enumerate(ids):
                cls = self.index.classes[self.index.labels[int(i)]]
                row = self.pack.rows(cls, [str(self.index.image_names[int(i)])])[0]
                xdata[j] = self.pack.array(cls)[row]
            euler = np.stack(
                [self.index.euler(int(i)) for i in ids]
            ).astype(np.float32)
            label = self.index.labels[ids].astype(np.int32)
            valid = np.ones(len(ids), bool)
            pad = self.batch_size - len(ids)
            if pad:
                xdata = np.concatenate(
                    [xdata, np.zeros((pad, S, S, 3), np.uint8)]
                )
                euler = np.concatenate([euler, np.zeros((pad, 3), np.float32)])
                label = np.concatenate([label, np.zeros(pad, np.int32)])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
            yield {"xdata": xdata, "euler": euler, "label": label, "valid": valid}
