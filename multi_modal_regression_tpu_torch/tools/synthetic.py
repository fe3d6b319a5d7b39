"""Synthetic datasets and releases (the port's copy of the JAX package's
tools/synthetic.py).

`generate_pose_dataset` writes the reference's on-disk training layout
(`<root>/<cls>/<prefix>_a<az>_e<el>_t<ct>_d<dist>.png`,
setupDataFlipped_pascal3d.m:120-121) with small images and uniform random
viewpoints, so the data -> train -> eval path runs without PASCAL3D+
downloads. Its PNGs are written by `data/native.save_png` (libpng where the
native library builds, PIL otherwise; the pixels are the same).

The release writers (`generate_pascal3d_release`,
`generate_objectnet3d_release`, `generate_detection_set`) synthesize what
the ingest walkers and the detection index read: JPEGs through PIL and
`.mat` files through scipy (each imported by the function that uses it), as
the JAX writers write them, so one seed
gives the same files from either package.
"""

from __future__ import annotations

from pathlib import Path
from typing import Sequence

import numpy as np

from multi_modal_regression_tpu_torch.data.naming import PASCAL3D_CLASSES, make_name
from multi_modal_regression_tpu_torch.data.native import save_png


def generate_detection_set(
    root: str | Path,
    num_images: int = 6,
    max_boxes: int = 3,
    image_size: int = 64,
    num_classes: int = 12,
    seed: int = 0,
) -> Path:
    """Write a synthetic detector-crop set in the reference layout:
    `dbinfo.mat` (image_names) + `all/<name>.mat` with xdata/bboxes/labels
    (1-based), matching setupDataDetection_*.m output and DetImages'
    expectations (evaluateModelDetectedBBoxes.py:43-64). Some images get
    zero boxes (empty xdata) to exercise that path."""
    import scipy.io as spio

    root = Path(root)
    (root / "all").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    names = [f"img{i:04d}" for i in range(num_images)]
    for i, name in enumerate(names):
        if i == 0:
            n = max_boxes
        elif i == 1:
            n = 0  # always exercise the empty-image path
        else:
            n = int(rng.integers(0, max_boxes + 1))
        if n == 0:
            spio.savemat(
                str(root / "all" / f"{name}.mat"),
                {"xdata": np.zeros((0,)), "bboxes": np.zeros((0, 4)),
                 "labels": np.zeros((0,), np.int64)},
            )
            continue
        x1 = rng.uniform(0, 200, n)
        y1 = rng.uniform(0, 200, n)
        spio.savemat(
            str(root / "all" / f"{name}.mat"),
            {
                "xdata": rng.integers(
                    0, 256, (n, image_size, image_size, 3), np.uint8
                ),
                "bboxes": np.stack(
                    [x1, y1, x1 + rng.uniform(20, 100, n),
                     y1 + rng.uniform(20, 100, n)], axis=1
                ),
                "labels": rng.integers(1, num_classes + 1, n),  # 1-based
            },
        )
    spio.savemat(
        str(root / "dbinfo.mat"),
        {"image_names": np.array(names, dtype=object)},  # cellstr layout
    )
    return root


def _save_record(path: Path, objects: list[dict]) -> None:
    """Write an Annotations/<image>.mat with a record.objects struct array
    (the PASCAL3D+/ObjectNet3D annotation layout the ingest readers parse)."""
    import scipy.io as spio

    dt = [(k, object) for k in
          ("class", "bbox", "truncated", "occluded", "difficult",
           "cad_index", "viewpoint")]
    arr = np.zeros((len(objects),), dtype=dt)
    for i, o in enumerate(objects):
        for k in arr.dtype.names:
            arr[i][k] = o[k]
    path.parent.mkdir(parents=True, exist_ok=True)
    spio.savemat(str(path), {"record": {"objects": arr}})


def _random_object(rng, cls: str, img_w: int, img_h: int, *,
                   coarse_only: bool = False, **flags) -> dict:
    x1 = float(rng.uniform(2, img_w * 0.4))
    y1 = float(rng.uniform(2, img_h * 0.4))
    az = float(rng.uniform(0, 360))
    el = float(rng.uniform(-45, 45))
    ct = float(rng.uniform(-30, 30))
    vp = {
        "theta": ct,
        "distance": 0.0 if coarse_only else float(rng.uniform(3, 8)),
        "azimuth_coarse": az, "elevation_coarse": el,
        "focal": 1.0, "viewport": 3000.0,
        "px": img_w / 2.0, "py": img_h / 2.0,
    }
    if not coarse_only:
        vp.update(azimuth=az, elevation=el)
    return {
        "class": cls,
        "bbox": np.array(
            [x1, y1, x1 + float(rng.uniform(img_w * 0.3, img_w * 0.5)),
             y1 + float(rng.uniform(img_h * 0.3, img_h * 0.5))]
        ),
        "truncated": int(flags.get("truncated", 0)),
        "occluded": int(flags.get("occluded", 0)),
        "difficult": int(flags.get("difficult", 0)),
        "cad_index": int(flags.get("cad_index", 1)),  # 1-based
        "viewpoint": vp,
    }


def generate_pascal3d_release(
    root: str | Path,
    classes: Sequence[str] = ("aeroplane", "bicycle", "boat"),
    images_per_split: int = 3,
    image_size: int = 96,
    seed: int = 0,
) -> tuple[Path, Path]:
    """Synthesize a mini PASCAL3D+ release + VOC2012 devkit skeleton.

    Produces the directories the ingest walkers read: Images/<cls>_{imagenet,
    pascal}/, Annotations/... record .mat files, Image_sets set files, the
    VOC ImageSets/Main per-class (name, flag) files, JPEGImages for the
    detection pipelines, and CAD/<cls>.mat vertex models. Includes the edge
    cases the reference filters: a truncated object, a difficult object, a
    gray image, and an image with a missing annotation file.
    Returns (db_path, voc_dir).
    """
    import scipy.io as spio
    from PIL import Image

    root = Path(root)
    rng = np.random.default_rng(seed)
    voc_dir = root / "PASCAL" / "VOCdevkit" / "VOC2012"
    (voc_dir / "ImageSets" / "Main").mkdir(parents=True, exist_ok=True)
    (voc_dir / "JPEGImages").mkdir(parents=True, exist_ok=True)
    (root / "Image_sets").mkdir(parents=True, exist_ok=True)

    all_pascal_names: list[str] = []
    for ci, cls in enumerate(classes):
        # CAD model: two random vertex clouds (cad_index exercises both)
        dt = [("vertices", object)]
        models = np.zeros((2,), dtype=dt)
        for m in range(2):
            models[m]["vertices"] = rng.uniform(-0.5, 0.5, (60, 3))
        (root / "CAD").mkdir(parents=True, exist_ok=True)
        spio.savemat(str(root / "CAD" / f"{cls}.mat"), {cls: models})

        # imagenet images: n02xxx_<i> style names (underscore in the id)
        for split in ("train", "val"):
            names = [
                f"n{2000 + ci:05d}_{split}{i}" for i in range(images_per_split)
            ]
            (root / "Image_sets" / f"{cls}_imagenet_{split}.txt").write_text(
                "\n".join(names) + "\n"
            )
            img_dir = root / "Images" / f"{cls}_imagenet"
            anno_dir = root / "Annotations" / f"{cls}_imagenet"
            img_dir.mkdir(parents=True, exist_ok=True)
            for i, name in enumerate(names):
                if split == "val" and i == images_per_split - 1:
                    # gray image: the prep must skip it (d ~= 3)
                    Image.fromarray(
                        rng.integers(0, 255, (image_size, image_size), np.uint8)
                    ).save(img_dir / f"{name}.JPEG")
                else:
                    Image.fromarray(
                        rng.integers(0, 255, (image_size, image_size, 3), np.uint8)
                    ).save(img_dir / f"{name}.JPEG")
                objs = [_random_object(rng, cls, image_size, image_size)]
                if i == 0:  # filtered flavors
                    objs.append(_random_object(rng, cls, image_size, image_size,
                                               truncated=1))
                    objs.append(_random_object(rng, "other", image_size, image_size))
                if split == "train" and i == images_per_split - 1:
                    continue  # missing annotation file: prep must skip
                _save_record(anno_dir / f"{name}.mat", objs)

        # pascal images: VOC-style 20xx_000xxx names, shared JPEGImages
        for split in ("train", "val"):
            names = [
                f"200{ci}_{split_i:06d}"
                for split_i in range(
                    (0 if split == "train" else 100),
                    (0 if split == "train" else 100) + images_per_split,
                )
            ]
            # VOC set file lists extra negative-flag rows too
            lines = [f"{n}  1" for n in names] + [f"2099_{900 + ci:06d} -1"]
            (voc_dir / "ImageSets" / "Main" / f"{cls}_{split}.txt").write_text(
                "\n".join(lines) + "\n"
            )
            img_dir = root / "Images" / f"{cls}_pascal"
            anno_dir = root / "Annotations" / f"{cls}_pascal"
            img_dir.mkdir(parents=True, exist_ok=True)
            for i, name in enumerate(names):
                img = rng.integers(0, 255, (image_size, image_size, 3), np.uint8)
                Image.fromarray(img).save(img_dir / f"{name}.jpg")
                Image.fromarray(img).save(voc_dir / "JPEGImages" / f"{name}.jpg")
                objs = [_random_object(rng, cls, image_size, image_size,
                                       cad_index=1 + (i % 2))]
                if split == "val" and i == 0:
                    objs.append(_random_object(rng, cls, image_size, image_size,
                                               difficult=1))
                _save_record(anno_dir / f"{name}.mat", objs)
                all_pascal_names.append(name)
    (voc_dir / "ImageSets" / "Main" / "val.txt").write_text(
        "\n".join(sorted({n for n in all_pascal_names if "_0001" in n})) + "\n"
    )
    return root, voc_dir


def generate_objectnet3d_release(
    root: str | Path,
    classes: Sequence[str] = ("bed", "coffee_maker", "shoe"),
    num_train: int = 4,
    num_test: int = 3,
    image_size: int = 96,
    seed: int = 0,
) -> Path:
    """Synthesize a mini ObjectNet3D release: Images/*.JPEG (multi-class
    objects per image, some coarse-only viewpoints, one gray image),
    Annotations/*.mat, Image_sets/{classes,train,val}.txt."""
    from PIL import Image

    root = Path(root)
    rng = np.random.default_rng(seed)
    (root / "Images").mkdir(parents=True, exist_ok=True)
    (root / "Annotations").mkdir(parents=True, exist_ok=True)
    (root / "Image_sets").mkdir(parents=True, exist_ok=True)
    (root / "Image_sets" / "classes.txt").write_text("\n".join(classes) + "\n")

    def write_split(prefix: str, n: int) -> list[str]:
        names = []
        for i in range(n):
            name = f"{prefix}_{i:05d}"
            names.append(name)
            if i == 0:  # gray image: ObjectNet prep converts, not skips
                img = rng.integers(0, 255, (image_size, image_size), np.uint8)
            else:
                img = rng.integers(0, 255, (image_size, image_size, 3), np.uint8)
            Image.fromarray(img).save(root / "Images" / f"{name}.JPEG")
            objs = [
                _random_object(
                    rng, classes[(i + j) % len(classes)],
                    image_size, image_size, coarse_only=(j == 1),
                )
                for j in range(1 + i % 2)
            ]
            _save_record(root / "Annotations" / f"{name}.mat", objs)
        return names

    train = write_split("o3dtrain", num_train)
    test = write_split("o3dval", num_test)
    (root / "Image_sets" / "train.txt").write_text("\n".join(train) + "\n")
    (root / "Image_sets" / "val.txt").write_text("\n".join(test) + "\n")
    return root


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
