"""Synthetic pose datasets with filename-encoded poses (the port's copy of
`render_pose_pattern` and `generate_pose_dataset` from the JAX package's
tools/synthetic.py).

Writes the reference's on-disk training layout
(`<root>/<cls>/<prefix>_a<az>_e<el>_t<ct>_d<dist>.png`,
setupDataFlipped_pascal3d.m:120-121) with small images and uniform random
viewpoints, so the data -> train -> eval path runs without PASCAL3D+
downloads. PNGs are written by `data/native.save_png` (libpng where the
native library builds, PIL otherwise; the pixels are the same).
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from multi_modal_regression_tpu_torch.data.naming import PASCAL3D_CLASSES, make_name
from multi_modal_regression_tpu_torch.data.native import save_png


def render_pose_pattern(
    az: float, el: float, ct: float, image_size: int
) -> np.ndarray:
    """A pose-dependent image: a fixed colored 3D point cloud rotated by
    R(az, el, ct) and orthographically splatted. A CNN can recover the
    viewpoint from it, so end-to-end learning is demonstrable without
    PASCAL3D+ data (used by the 'pose' pattern of generate_pose_dataset).
    """
    prng = np.random.default_rng(1234)  # the object: shared by all images
    pts = prng.uniform(-1, 1, (160, 3))
    colors = prng.integers(64, 256, (160, 3))
    a, e, c = np.radians([az, el, ct])
    Ra = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]])
    Rb = np.array([[1, 0, 0], [0, np.cos(e), -np.sin(e)], [0, np.sin(e), np.cos(e)]])
    Rc = np.array([[np.cos(c), -np.sin(c), 0], [np.sin(c), np.cos(c), 0], [0, 0, 1]])
    P = pts @ (Rc @ Rb @ Ra).T
    order = np.argsort(P[:, 2])  # painter's order on depth
    s = image_size
    img = np.zeros((s, s, 3), np.uint8)
    xy = ((P[:, :2] * 0.4 + 0.5) * (s - 4)).astype(int) + 2
    for i in order:
        x, y = xy[i]
        img[max(0, y - 1) : y + 2, max(0, x - 1) : x + 2] = colors[i]
    return img


def generate_pose_dataset(
    root: str | Path,
    classes: Sequence[str] = PASCAL3D_CLASSES,
    images_per_class: int = 8,
    image_size: int = 64,
    seed: int = 0,
    write_info_mat: bool = False,
    pattern: str = "noise",  # 'noise' (fast) | 'pose' (learnable content)
) -> Path:
    """Write a synthetic filename-encoded pose dataset; returns its root.

    Viewpoints: az ~ U(0, 360), el ~ U(-90, 90), ct ~ U(-45, 45),
    dist ~ U(2, 10). pattern='noise' images carry no signal (pipeline
    tests); pattern='pose' renders a viewpoint-dependent point cloud so
    the pose is learnable from pixels. With write_info_mat, also writes
    `<cls>_info.mat` index files like setupDataOriginal_pascal3d.m:70.
    """
    root = Path(root)
    rng = np.random.default_rng(seed)
    for ci, cls in enumerate(classes):
        cls_dir = root / cls
        cls_dir.mkdir(parents=True, exist_ok=True)
        names = []
        # vary the per-class count a little so class-balanced modulo
        # indexing is exercised (same shape as real data)
        n = images_per_class + (ci % 3)
        for i in range(n):
            az = float(rng.uniform(0, 360))
            el = float(rng.uniform(-90, 90))
            ct = float(rng.uniform(-45, 45))
            d = float(rng.uniform(2, 10))
            name = make_name(f"{cls}_img{i:03d}object1", az, el, ct, d)
            if pattern == "pose":
                img = render_pose_pattern(az, el, ct, image_size)
            else:
                img = rng.integers(0, 256, (image_size, image_size, 3), np.uint8)
            save_png(img, cls_dir / f"{name}.png")
            names.append(name)
        if write_info_mat:
            import scipy.io as spio

            # object dtype -> a MATLAB cell array (cellstr), like the real
            # setup scripts save; a str array would load space-padded
            spio.savemat(
                str(root / f"{cls}_info.mat"),
                {"image_names": np.array(names, dtype=object)},
            )
    return root
