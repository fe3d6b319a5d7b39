"""Dataset index construction and class-balanced sampling (the port's copy
of the JAX package's data/index.py).

  ImagesAll    (dataGenerators.py:26-77): one "item" = one image from EVERY
               class; image i of class c is `names[c][idx % num_images[c]]`;
               epoch length = max class size; per-class independent
               reshuffles at epoch end (shuffle_images, :76-77).
  TestImages   (dataGenerators.py:181-221): flat concatenation of all
               classes' images with per-image labels.
  Pascal3dAll  (dataGenerators.py:80-124): flat index over precomputed .mat
               crops, 'val' -> pascal_train names, 'test' -> pascal_val.

Index sources: `<cls>_info.mat` files (squeeze_me semantics, the reference
layout) with a directory-scan fallback so synthetic/test datasets need no
MATLAB artifacts.
"""

from __future__ import annotations

import dataclasses
import os
from pathlib import Path
from typing import Sequence

import numpy as np

from multi_modal_regression_tpu_torch.data.naming import PASCAL3D_CLASSES, parse_name


def _class_image_names(
    db_path: str | Path,
    cls: str,
    info_key: str = "image_names",
    info_suffix: str = "_info",
) -> np.ndarray:
    """Image names for one class: from `<cls><info_suffix>.mat` if present,
    else by scanning `<db_path>/<cls>/*.png`. The ablation protocol reads
    `<cls>_train_info` files for its real-data train/val split
    (ablationFunctions.py:27-28)."""
    info_file = Path(db_path) / f"{cls}{info_suffix}.mat"
    if info_file.exists():
        import scipy.io as spio

        tmp = spio.loadmat(str(info_file), squeeze_me=True)
        names = tmp[info_key]
        if isinstance(names, str):  # squeeze_me collapses singleton lists
            names = [names]
        return np.asarray([str(n).strip() for n in names])
    cls_dir = Path(db_path) / cls
    names = sorted(p.stem for p in cls_dir.glob("*.png"))
    if not names:
        raise FileNotFoundError(f"no index for class {cls!r} under {db_path}")
    return np.asarray(names)


@dataclasses.dataclass
class ClassBalancedIndex:
    """The ImagesAll index: per-class name lists + pose targets.

    db_type 'real' uses R(az, el, ct); 'render' uses R(az, el, -ct)
    (dataGenerators.py:57-62: rendered images follow the opposite tilt-sign
    convention).
    """

    db_path: str
    db_type: str  # 'real' | 'render'
    classes: Sequence[str] = PASCAL3D_CLASSES
    info_key: str = "image_names"
    info_suffix: str = "_info"  # ablation real split uses "_train_info"

    def __post_init__(self):
        if self.db_type not in ("real", "render"):
            raise ValueError(f"db_type must be real|render, got {self.db_type!r}")
        self.num_classes = len(self.classes)
        self.list_image_names = [
            _class_image_names(self.db_path, c, self.info_key, self.info_suffix)
            for c in self.classes
        ]
        self.num_images = np.array([len(n) for n in self.list_image_names])
        # current (possibly shuffled) per-class orders
        self.image_names = [np.array(n) for n in self.list_image_names]

    def __len__(self) -> int:
        """Epoch length = the largest class size (dataGenerators.py:43-44)."""
        return int(np.amax(self.num_images))

    def shuffle(self, rng: np.random.Generator) -> None:
        """Independent per-class reshuffle (shuffle_images, :76-77)."""
        self.image_names = [
            rng.permutation(n) for n in self.list_image_names
        ]

    def item_paths_labels(self, idx: int) -> tuple[list[str], np.ndarray]:
        """Item idx -> (num_classes image paths, labels 0..C-1)."""
        paths = []
        for c in range(self.num_classes):
            name = self.image_names[c][idx % self.num_images[c]]
            paths.append(
                os.path.join(self.db_path, self.classes[c], name + ".png")
            )
        return paths, np.arange(self.num_classes, dtype=np.int64)

    def item_euler(self, idx: int) -> np.ndarray:
        """Item idx -> (num_classes, 3) euler angles with the db_type's
        tilt-sign convention applied."""
        out = np.zeros((self.num_classes, 3), np.float64)
        for c in range(self.num_classes):
            name = self.image_names[c][idx % self.num_images[c]]
            p = parse_name(name)
            ct = p.ct if self.db_type == "real" else -p.ct
            out[c] = (p.az, p.el, ct)
        return out


@dataclasses.dataclass
class FlatTestIndex:
    """The TestImages index: all classes concatenated, per-image labels."""

    db_path: str
    classes: Sequence[str] = PASCAL3D_CLASSES
    info_key: str = "image_names"

    def __post_init__(self):
        self.num_classes = len(self.classes)
        names, labels = [], []
        for i, c in enumerate(self.classes):
            n = _class_image_names(self.db_path, c, self.info_key)
            names.append(n)
            labels.append(np.full(len(n), i, dtype=np.int64))
        self.image_names = np.concatenate(names)
        self.labels = np.concatenate(labels)

    def __len__(self) -> int:
        return len(self.image_names)

    def path(self, idx: int) -> str:
        return os.path.join(
            self.db_path,
            self.classes[self.labels[idx]],
            self.image_names[idx] + ".png",
        )

    def euler(self, idx: int) -> np.ndarray:
        p = parse_name(self.image_names[idx])
        return np.array((p.az, p.el, p.ct), np.float64)


@dataclasses.dataclass
class MatCropIndex:
    """The Pascal3dAll index over precomputed per-image .mat crops.

    split 'val' reads the pascal_train name lists, 'test' pascal_val
    (dataGenerators.py:92-97 — 'val' is the ablation model-selection split).
    """

    db_path: str
    split: str  # 'val' | 'test'
    classes: Sequence[str] = PASCAL3D_CLASSES

    def __post_init__(self):
        import scipy.io as spio

        key = "pascal_train" if self.split == "val" else "pascal_val"
        names, labels = [], []
        for i, c in enumerate(self.classes):
            tmp = spio.loadmat(
                str(Path(self.db_path) / f"{c}_info.mat"), squeeze_me=True
            )
            n = tmp[key]
            if isinstance(n, str):
                n = [n]
            n = np.asarray([str(s).strip() for s in n])
            names.append(n)
            labels.append(np.full(len(n), i, dtype=np.int64))
        self.image_names = np.concatenate(names)
        self.labels = np.concatenate(labels)

    def __len__(self) -> int:
        return len(self.image_names)

    def path(self, idx: int) -> str:
        return os.path.join(
            self.db_path, self.classes[self.labels[idx]], str(self.image_names[idx])
        )
