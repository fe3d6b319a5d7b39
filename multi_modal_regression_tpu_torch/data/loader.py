"""Host-side image loading with threaded prefetch; normalization on device
(the port's copy of the JAX package's data/loader.py).

The reference decodes + resizes + normalizes per image in DataLoader worker
processes and ships float32 tensors to the GPU (dataGenerators.py:21-23,39-54).
Here the host only decodes and resizes to uint8; batches cross to the card
as uint8 (4x less H2D traffic) and the (x/255 - mean)/std normalization runs
on the device in the step (the normalize kernel, whose plain version is
`normalize_images`). Pose targets stay Euler angles on the host; the
rotation, bin and residual math runs on the device (data.targets).

A batch from BalancedLoader is the reference's effective step layout: each
of `items_per_batch` items contributes one image per class, concatenated
(my_collate, dataGenerators.py:127-132) -> B = items_per_batch * num_classes
images, exactly the 2 loaders x 4 items x 12 classes = 96-image step of
learnGeodesicBDModel.py:78-79 when items_per_batch=4.

PIL is imported only by the functions that decode or resize with it: the
native library (data/native.py) decodes every 8-bit PNG without it.
"""

from __future__ import annotations

import concurrent.futures as cf
import queue
import threading
from typing import Iterator

import numpy as np
import torch

from multi_modal_regression_tpu_torch.data import native
from multi_modal_regression_tpu_torch.data.index import ClassBalancedIndex, FlatTestIndex

# ImageNet normalization (dataGenerators.py:21)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], np.float32)


def _decode_image_pil(path: str, size: int) -> np.ndarray:
    """The reference-semantics decode: PIL convert('RGB') + BILINEAR."""
    from PIL import Image

    with Image.open(path) as img:
        img = img.convert("RGB")
        if img.size != (size, size):
            img = img.resize((size, size), Image.BILINEAR)
        return np.asarray(img, np.uint8)


def decode_image(path: str, size: int = 224) -> np.ndarray:
    """PNG -> uint8 (size, size, 3). Bilinear resize like transforms.Resize.

    Decodes through the native C++ library when available (byte-identical
    pixels, GIL released -> loader threads scale; data/native.py) and
    falls back to PIL for anything the native path refuses (alpha,
    16-bit, non-PNG) or when the library is unavailable.
    """
    arr = native.decode_image_native(path, size)
    if arr is not None:
        return arr
    return _decode_image_pil(path, size)


def load_mat_crops(
    path: str, image_size: int | None
) -> tuple[np.ndarray, np.ndarray]:
    """One .mat crop set (Pascal3dAll protocol): (crops uint8, ydata f32),
    the crops resized with PIL BILINEAR when they are not image_size."""
    import scipy.io as spio

    tmp = spio.loadmat(path, verify_compressed_data_integrity=False)
    x = np.asarray(tmp["xdata"], np.uint8)
    if image_size is not None and x.shape[1:3] != (image_size, image_size):
        from PIL import Image

        x = np.stack([
            np.asarray(
                Image.fromarray(c).resize(
                    (image_size, image_size), Image.BILINEAR
                ),
                np.uint8,
            )
            for c in x
        ])
    y = np.asarray(tmp["ydata"], np.float32).reshape(len(x), -1)
    return x, y


def _decode_many(
    paths: list[str], size: int, pool: cf.Executor, num_workers: int
) -> np.ndarray:
    """(n, S, S, 3) uint8 batch decode: ONE native call (all files decode
    on parallel C++ threads, the GIL released once for the whole batch)
    with per-file PIL fallback for refused files; a pure-PIL pool.map when
    the native library is unavailable. Pixels identical either way."""
    res = native.decode_batch_native(paths, size, num_workers)
    if res is None:
        return np.stack(
            list(pool.map(lambda p: decode_image(p, size), paths))
        )
    out, ok = res
    for i in np.flatnonzero(~ok):
        out[i] = _decode_image_pil(paths[i], size)
    return out


def normalize_images(
    x_uint8: torch.Tensor, dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """(x/255 - mean)/std on (..., H, W, 3) uint8, on the tensor's device.

    The arithmetic runs in at least float32 (float64 stays float64); only
    the output takes `dtype`. This is the plain version of the normalize
    kernel (ops/preprocess.py) and its reference.
    """
    compute = torch.promote_types(torch.float32, dtype)
    x = x_uint8.to(compute) / 255.0
    mean = torch.as_tensor(IMAGENET_MEAN, device=x.device).to(compute)
    std = torch.as_tensor(IMAGENET_STD, device=x.device).to(compute)
    return ((x - mean) / std).to(dtype)


def _prefetched(make_gen, num_workers: int, depth: int) -> Iterator:
    """Run `make_gen(pool)` in a daemon thread with a depth-limited queue.

    The worker thread owns the decode thread-pool, and shuts down cleanly
    when the consumer abandons iteration early (e.g. max_iterations caps)
    — the stop event is set from the consumer's GeneratorExit.
    """
    q: queue.Queue = queue.Queue(maxsize=depth)
    sentinel = object()
    stop = threading.Event()

    def _put(item) -> bool:
        """Blocking put that gives up if the consumer abandoned iteration."""
        while not stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def worker():
        err = None
        try:
            with cf.ThreadPoolExecutor(num_workers) as pool:
                for item in make_gen(pool):
                    if not _put(item):
                        return
        except Exception as e:  # surface producer failures, don't
            err = e  # silently truncate the epoch (re-raised below)
        finally:
            _put((sentinel, err))

    thread = threading.Thread(target=worker, daemon=True)
    thread.start()
    try:
        while True:
            item = q.get()
            if isinstance(item, tuple) and len(item) == 2 and item[0] is sentinel:
                if item[1] is not None:
                    raise item[1]
                return
            yield item
    finally:
        stop.set()
        while True:  # unblock a producer stuck on a full queue
            try:
                q.get_nowait()
            except queue.Empty:
                break


class BalancedLoader:
    """Iterate class-balanced training batches from a ClassBalancedIndex.

    Yields dicts of numpy arrays:
      xdata  (B, S, S, 3) uint8
      euler  (B, 3) float32  — (az, el, ct) with the db tilt sign applied
      label  (B,)  int32
    with B = items_per_batch * num_classes. Epoch length (in items) is the
    max class size; len(self) is the number of full batches per epoch
    (drop_last semantics: every batch has the same shape).
    """

    def __init__(
        self,
        index: ClassBalancedIndex,
        items_per_batch: int = 4,
        image_size: int = 224,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch_depth: int = 2,
        host_count: int = 1,
        host_index: int = 0,
    ):
        """host_count/host_index: per-host input sharding for multi-host
        runs — each host reads a disjoint stride of the epoch's batches
        (all hosts must use the same seed so the strides partition one
        shared shuffled order)."""
        self.index = index
        self.items_per_batch = items_per_batch
        self.image_size = image_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.host_count = host_count
        self.host_index = host_index
        self._rng = np.random.default_rng(seed)

    @property
    def batch_images(self) -> int:
        return self.items_per_batch * self.index.num_classes

    def __len__(self) -> int:
        return (len(self.index) // self.items_per_batch) // self.host_count

    def _make_batch(self, item_ids: np.ndarray, pool: cf.Executor) -> dict:
        paths, labels, eulers = [], [], []
        for idx in item_ids:
            p, l = self.index.item_paths_labels(int(idx))
            paths.extend(p)
            labels.append(l)
            eulers.append(self.index.item_euler(int(idx)))
        return {
            "xdata": _decode_many(
                paths, self.image_size, pool, self.num_workers
            ),
            "euler": np.concatenate(eulers).astype(np.float32),
            "label": np.concatenate(labels).astype(np.int32),
        }

    def _epoch_gen(self, pool: cf.Executor) -> Iterator[dict]:
        n_items = len(self.index)
        order = (
            self._rng.permutation(n_items) if self.shuffle else np.arange(n_items)
        )
        ipb = self.items_per_batch
        for b in range(len(self)):
            g = (b * self.host_count + self.host_index) * ipb
            yield self._make_batch(order[g : g + ipb], pool)

    def __iter__(self) -> Iterator[dict]:
        if self.shuffle:
            self.index.shuffle(self._rng)
        yield from _prefetched(
            self._epoch_gen, self.num_workers, self.prefetch_depth
        )


class FlatLoader:
    """Shuffled fixed-size training batches over a FlatTestIndex.

    The ObjectNet3D protocol trains from a flat per-image dataset
    (DataLoader(batch_size=96, shuffle=True), learnObjectnetBDModel.py:74)
    instead of the class-balanced ImagesAll sampler. Drop-last for static
    shapes. Yields {'xdata' uint8, 'euler', 'label'}.
    """

    def __init__(
        self,
        index,
        batch_size: int = 96,
        image_size: int = 224,
        shuffle: bool = True,
        seed: int = 0,
        num_workers: int = 8,
        prefetch_depth: int = 2,
        host_count: int = 1,
        host_index: int = 0,
    ):
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.shuffle = shuffle
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.host_count = host_count
        self.host_index = host_index
        self._rng = np.random.default_rng(seed)

    def __len__(self) -> int:
        return (len(self.index) // self.batch_size) // self.host_count

    def _gen(self, pool: cf.Executor) -> Iterator[dict]:
        n = len(self.index)
        order = self._rng.permutation(n) if self.shuffle else np.arange(n)
        for b in range(len(self)):
            g = (b * self.host_count + self.host_index) * self.batch_size
            ids = order[g : g + self.batch_size]
            yield {
                "xdata": _decode_many(
                    [self.index.path(int(i)) for i in ids],
                    self.image_size, pool, self.num_workers,
                ),
                "euler": np.stack(
                    [self.index.euler(int(i)) for i in ids]
                ).astype(np.float32),
                "label": self.index.labels[ids].astype(np.int32),
            }

    def __iter__(self) -> Iterator[dict]:
        yield from _prefetched(self._gen, self.num_workers, self.prefetch_depth)


class MatCropLoader:
    """Fixed-size eval batches over precomputed .mat crops (Pascal3dAll).

    The reference's Pascal3dAll dataset reads per-image .mat files holding
    n crops each (xdata (n,224,224,3), ydata (n,3) axis-angle) and batches
    them via my_collate (dataGenerators.py:80-124). Here all crops are
    flattened into one padded fixed-shape stream (valid mask marks the
    padding), with the axis-angle 'ydata' passed through.
    """

    def __init__(
        self,
        index,  # MatCropIndex
        batch_size: int = 96,
        image_size: int | None = None,
        num_workers: int = 8,
        prefetch_depth: int = 2,
        host_count: int = 1,
        host_index: int = 0,
    ):
        """image_size: resize the stored crops to this size (None keeps
        whatever the .mat holds, 224 in the reference layout). Pass the
        experiment's image size so the mat protocol evaluates at the SAME
        resolution the model trains at. host_count/host_index stride the
        per-image .mat files across hosts."""
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.host_count = host_count
        self.host_index = host_index

    def _load(self, i: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        x, y = load_mat_crops(self.index.path(i), self.image_size)
        lab = np.full(len(x), self.index.labels[i], np.int32)
        return x, y, lab

    def _gen(self, pool: cf.Executor) -> Iterator[dict]:
        buf_x, buf_y, buf_l = [], [], []
        count = 0
        for x, y, lab in pool.map(
            self._load, range(self.host_index, len(self.index), self.host_count)
        ):
            buf_x.append(x)
            buf_y.append(y)
            buf_l.append(lab)
            count += len(x)
            while count >= self.batch_size:
                X = np.concatenate(buf_x)
                Y = np.concatenate(buf_y)
                L = np.concatenate(buf_l)
                yield {
                    "xdata": X[: self.batch_size],
                    "ydata": Y[: self.batch_size],
                    "label": L[: self.batch_size],
                    "valid": np.ones(self.batch_size, bool),
                }
                buf_x = [X[self.batch_size :]]
                buf_y = [Y[self.batch_size :]]
                buf_l = [L[self.batch_size :]]
                count -= self.batch_size
        if count:
            X = np.concatenate(buf_x)
            Y = np.concatenate(buf_y)
            L = np.concatenate(buf_l)
            pad = self.batch_size - count
            yield {
                "xdata": np.concatenate(
                    [X, np.zeros((pad, *X.shape[1:]), X.dtype)]
                ),
                "ydata": np.concatenate([Y, np.zeros((pad, Y.shape[1]), Y.dtype)]),
                "label": np.concatenate([L, np.zeros(pad, np.int32)]),
                "valid": np.concatenate([np.ones(count, bool), np.zeros(pad, bool)]),
            }

    def __iter__(self) -> Iterator[dict]:
        yield from _prefetched(self._gen, self.num_workers, self.prefetch_depth)


class TestLoader:
    """Fixed-size batches over a FlatTestIndex, padded to one shape.

    Yields dicts with 'xdata' uint8, 'euler', 'label', and a boolean 'valid'
    mask (False on padding rows of the final batch).
    """

    def __init__(
        self,
        index: FlatTestIndex,
        batch_size: int = 96,
        image_size: int = 224,
        num_workers: int = 8,
        prefetch_depth: int = 2,
        host_count: int = 1,
        host_index: int = 0,
    ):
        """host_count/host_index: multi-host striding — each host reads the
        disjoint image stride host_index::host_count (the per-host shard of
        the test set)."""
        self.index = index
        self.batch_size = batch_size
        self.image_size = image_size
        self.num_workers = num_workers
        self.prefetch_depth = prefetch_depth
        self.host_count = host_count
        self.host_index = host_index

    def _ids(self) -> np.ndarray:
        return np.arange(len(self.index))[self.host_index :: self.host_count]

    def __len__(self) -> int:
        return -(-len(self._ids()) // self.batch_size)

    def _gen(self, pool: cf.Executor) -> Iterator[dict]:
        all_ids = self._ids()
        n = len(all_ids)
        for start in range(0, n, self.batch_size):
            ids = all_ids[start : start + self.batch_size]
            xdata = _decode_many(
                [self.index.path(int(i)) for i in ids],
                self.image_size, pool, self.num_workers,
            )
            euler = np.stack([self.index.euler(int(i)) for i in ids]).astype(np.float32)
            label = self.index.labels[ids].astype(np.int32)
            valid = np.ones(len(ids), bool)
            pad = self.batch_size - len(ids)
            if pad:
                xdata = np.concatenate([xdata, np.zeros((pad, *xdata.shape[1:]), xdata.dtype)])
                euler = np.concatenate([euler, np.zeros((pad, 3), np.float32)])
                label = np.concatenate([label, np.zeros(pad, np.int32)])
                valid = np.concatenate([valid, np.zeros(pad, bool)])
            yield {"xdata": xdata, "euler": euler, "label": label, "valid": valid}

    def __iter__(self) -> Iterator[dict]:
        yield from _prefetched(self._gen, self.num_workers, self.prefetch_depth)
