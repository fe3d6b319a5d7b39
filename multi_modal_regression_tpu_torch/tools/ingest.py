"""PASCAL3D+ / ObjectNet3D release ingestion (the port's copy of the JAX
package's tools/ingest.py; host code, numpy, PIL and scipy).

The reference's setupData*.m scripts are complete dataset walkers; this
module is their Python re-design, layered on the per-object compute in
tools.pascal3d_prep:

  record readers      Annotations/<...>/<image>.mat `record.objects` ->
                      ObjectAnnotation lists (setupDataOriginal_pascal3d.m:82-103)
  split construction  Image_sets/<cls>_imagenet_{train,val}.txt +
                      VOC2012 ImageSets/Main/<cls>_{train,val}.txt readers
                      (setupDataFlipped_pascal3d.m:39-74, read_file/read_file2)
  CAD loading         CAD/<cls>.mat vertex models for the homography
                      augmentation (setupDataAugmented_pascal3d.m:12-15,81-83)
  dataset walkers     prepare_pascal3d / prepare_objectnet3d drive the full
                      release -> train/test/augmented2/original trees +
                      <cls>_info.mat index files the data.index loaders
                      consume unchanged
  detector parsers    V&K / Render4CNN .mat and MaskRCNN / Fast-RCNN .txt
                      detection outputs -> the {image: (boxes, labels)} form
                      write_detection_crops consumes
                      (setupDataDetection_{vk,r4cnn,maskrcnn}.m,
                      setupDataDetected_objectnet3d.m)

Bounding boxes are kept in the release's MATLAB 1-based convention (the
crop helpers treat them as 0-based — a <=1 px shift, same order as the
reference's own numpy reuse of MATLAB-saved boxes).
"""

from __future__ import annotations

import concurrent.futures as cf
from pathlib import Path
from typing import Callable, Sequence

import numpy as np

from multi_modal_regression_tpu_torch.data.naming import PASCAL3D_CLASSES, make_name
from multi_modal_regression_tpu_torch.data.native import save_png
from multi_modal_regression_tpu_torch.tools.pascal3d_prep import (
    ObjectAnnotation,
    crop_patch,
    write_augmented_crops,
    write_flipped_crops,
    write_info_mat,
    write_original_crops,
)


# ---------------------------------------------------------------------------
# set-file readers (read_file / read_file2)
# ---------------------------------------------------------------------------

def read_image_set(path: str | Path) -> list[str]:
    """Whitespace-token image list (read_file, setupDataOriginal:139-145)."""
    return Path(path).read_text().split()


def read_voc_image_set(path: str | Path) -> list[str]:
    """VOC per-class set file: `<name> <flag>` rows, keep flag > 0
    (read_file2, setupDataOriginal:148-155)."""
    names = []
    for line in Path(path).read_text().splitlines():
        parts = line.split()
        if len(parts) >= 2 and int(parts[1]) > 0:
            names.append(parts[0])
    return names


def image_id(image_name: str) -> str:
    """Underscore-free image id used in crop filenames (get_id)."""
    return image_name.replace("_", "")


# ---------------------------------------------------------------------------
# MATLAB record -> ObjectAnnotation
# ---------------------------------------------------------------------------

def _num(struct, field: str, default: float | None) -> float | None:
    """A numeric viewpoint field; missing/empty -> default (the ObjectNet3D
    records omit fine `azimuth` for coarse-only annotations,
    setupDataFlipped_objectnet3d.m:93-103)."""
    v = getattr(struct, field, None)
    if v is None:
        return default
    arr = np.asarray(v).ravel()
    if arr.size == 0:
        return default
    return float(arr[0])


def _object_to_annotation(o) -> ObjectAnnotation | None:
    cls = getattr(o, "class", None)
    bbox = getattr(o, "bbox", None)
    if cls is None or bbox is None:
        return None
    bbox = np.asarray(bbox, np.float64).ravel()[:4]
    vp = getattr(o, "viewpoint", None)
    if vp is not None and np.asarray(vp).size == 0:
        vp = None

    class _Empty:  # pragma: no cover - trivial
        pass

    vp = vp if vp is not None else _Empty()
    az = _num(vp, "azimuth", None)
    el = _num(vp, "elevation", None)
    az_coarse = _num(vp, "azimuth_coarse", 0.0)
    el_coarse = _num(vp, "elevation_coarse", 0.0)
    focal = _num(vp, "focal", 1.0) or 1.0
    viewport = _num(vp, "viewport", 3000.0) or 3000.0
    return ObjectAnnotation(
        cls=str(np.asarray(cls).ravel()[0] if not isinstance(cls, str) else cls),
        bbox=bbox,
        # fine angles with the coarse fallback applied lazily by callers that
        # want it; az/el default to the coarse values when fine are absent
        az=az if az is not None else az_coarse,
        el=el if el is not None else el_coarse,
        ct=_num(vp, "theta", 0.0) or 0.0,
        distance=_num(vp, "distance", 0.0) or 0.0,
        focal=focal * viewport,
        px=_num(vp, "px", 0.0) or 0.0,
        py=_num(vp, "py", 0.0) or 0.0,
        # MATLAB cad_index is 1-based; stored 0-based for direct list indexing
        cad_index=max(int(_num(o, "cad_index", 1) or 1) - 1, 0),
        truncated=bool(_num(o, "truncated", 0.0)),
        occluded=bool(_num(o, "occluded", 0.0)),
        difficult=bool(_num(o, "difficult", 0.0)),
        azimuth_coarse=az_coarse,
        elevation_coarse=el_coarse,
    )


def load_record_objects(mat_path: str | Path) -> list[ObjectAnnotation]:
    """Annotations/<image>.mat -> per-object annotations.

    Reads `record.objects` (struct array; scalar for single-object images),
    mirroring setupDataOriginal_pascal3d.m:82-103 / computeAVP.m:40-63. The
    viewpoint subset kept matches the reference's usage: fine az/el/theta/
    distance, focal*viewport, principal point, coarse fallbacks, the
    truncated/occluded/difficult flags, and cad_index.
    """
    import scipy.io as spio

    tmp = spio.loadmat(str(mat_path), squeeze_me=True, struct_as_record=False)
    record = tmp.get("record")
    if record is None:
        return []
    objects = getattr(record, "objects", None)
    if objects is None:
        return []
    out = []
    for o in np.atleast_1d(objects):
        ann = _object_to_annotation(o)
        if ann is not None:
            out.append(ann)
    return out


def load_annotations_for_images(
    anno_dir: str | Path, image_names: Sequence[str]
) -> list[list[ObjectAnnotation] | None]:
    """Per-image annotation lists for the AVP/ARP ground truth
    (computeAVP.m:40-43: a missing annotation file yields None and the
    image's detections are skipped by the metric)."""
    anno_dir = Path(anno_dir)
    out: list[list[ObjectAnnotation] | None] = []
    for name in image_names:
        p = anno_dir / f"{name}.mat"
        out.append(load_record_objects(p) if p.exists() else None)
    return out


def load_cad_vertices(cad_mat: str | Path, cls: str) -> list[np.ndarray]:
    """CAD/<cls>.mat -> list of (N, 3) vertex arrays, list index = the
    0-based cad_index (setupDataAugmented_pascal3d.m:12-15: `models =
    tmp.(cls)`, vertices at `models(cad_index).vertices`)."""
    import scipy.io as spio

    tmp = spio.loadmat(str(cad_mat), squeeze_me=True, struct_as_record=False)
    models = tmp.get(cls)
    if models is None:
        raise KeyError(f"no '{cls}' variable in {cad_mat}")
    return [
        np.asarray(m.vertices, np.float64).reshape(-1, 3)
        for m in np.atleast_1d(models)
    ]


# ---------------------------------------------------------------------------
# image loading
# ---------------------------------------------------------------------------

IMAGE_EXTENSIONS = (".JPEG", ".jpg", ".jpeg", ".png")


def load_rgb_image(
    base: str | Path, extensions: Sequence[str] = IMAGE_EXTENSIONS,
    gray_to_rgb: bool = False,
) -> np.ndarray | None:
    """Image for `base` (no extension) trying each extension. Returns None
    for missing files and — unless gray_to_rgb — for non-RGB images (the
    PASCAL3D+ prep skips them, `if d ~= 3, return`; the ObjectNet3D prep
    instead stacks gray to 3 channels, setupDataFlipped_objectnet3d.m:164)."""
    from PIL import Image

    for ext in extensions:
        p = Path(str(base) + ext)
        if p.exists():
            with Image.open(p) as img:
                if img.mode != "RGB":
                    if not gray_to_rgb:
                        return None
                    img = img.convert("RGB")
                return np.asarray(img, np.uint8)
    return None


def _bad_bbox(obj: ObjectAnnotation, img: np.ndarray) -> bool:
    """`bbox(1) > nC || bbox(2) > nR` (setupDataOriginal:104)."""
    h, w = img.shape[:2]
    return obj.bbox[0] > w or obj.bbox[1] > h


def _filter_objects(
    objects: Sequence[ObjectAnnotation], img: np.ndarray
) -> list[ObjectAnnotation]:
    return [o for o in objects if not _bad_bbox(o, img)]


def write_test_crops(
    img: np.ndarray,
    objects: Sequence[ObjectAnnotation],
    imageid: str,
    save_dir: str | Path,
    cls: str,
) -> list[str]:
    """Unflipped pose-named crops for the test split (process_image2,
    setupDataFlipped_pascal3d.m:157-196)."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for j, obj in enumerate(objects, start=1):
        if obj.cls != cls or not obj.usable:
            continue
        patch = crop_patch(img, obj.bbox)
        name = make_name(
            f"{cls}_{imageid}object{j}", obj.az, obj.el, obj.ct, obj.distance
        )
        save_png(patch, save_dir / f"{name}.png")
        names.append(name)
    return names


# ---------------------------------------------------------------------------
# PASCAL3D+ walker
# ---------------------------------------------------------------------------

def pascal3d_splits(
    db_path: str | Path, voc_dir: str | Path, cls: str
) -> dict[str, list[str]]:
    """The four per-class image lists (setupDataFlipped_pascal3d.m:39-74):
    imagenet train/val from Image_sets, pascal train/val from the VOC2012
    devkit Main sets."""
    db_path, voc_dir = Path(db_path), Path(voc_dir)
    sets = db_path / "Image_sets"
    main = voc_dir / "ImageSets" / "Main"
    return {
        "imagenet_train": read_image_set(sets / f"{cls}_imagenet_train.txt"),
        "imagenet_val": read_image_set(sets / f"{cls}_imagenet_val.txt"),
        "pascal_train": read_voc_image_set(main / f"{cls}_train.txt"),
        "pascal_val": read_voc_image_set(main / f"{cls}_val.txt"),
    }


def _pascal3d_sources(db_path: Path, cls: str) -> dict[str, tuple[Path, Path]]:
    """(image_dir, anno_dir) per source db."""
    return {
        "imagenet": (
            db_path / "Images" / f"{cls}_imagenet",
            db_path / "Annotations" / f"{cls}_imagenet",
        ),
        "pascal": (
            db_path / "Images" / f"{cls}_pascal",
            db_path / "Annotations" / f"{cls}_pascal",
        ),
    }


def prepare_pascal3d(
    db_path: str | Path,
    voc_dir: str | Path,
    out_root: str | Path,
    classes: Sequence[str] = PASCAL3D_CLASSES,
    kinds: Sequence[str] = ("flipped", "original", "augmented"),
    workers: int = 8,
    log: Callable[[str], None] = print,
) -> dict:
    """Walk a PASCAL3D+ release and write every training/eval tree.

    Outputs under out_root (layouts identical to the MATLAB scripts', so the
    data.index / data.loader classes consume them unchanged):

      train/<cls>/*.png + train/<cls>_info.mat      flipped crops of
          imagenet train+val + pascal train (setupDataFlipped:41-74)
      test/<cls>/*.png + test/<cls>_info.mat        unflipped pascal-val crops
      augmented2/<cls>/*.png + _info.mat            homography pose-jitter
          grid over the train images (setupDataAugmented; needs CAD/<cls>.mat)
      original/<cls>/<image>.mat + original/<cls>_info.mat
          224^2 GT crops + axis-angle ydata, with the four split name lists
          (setupDataOriginal:70 — the Pascal3dAll 'val'/'test' protocols)
      dbinfo.mat                                    per-class surviving splits
    """
    db_path, out_root = Path(db_path), Path(out_root)
    kinds = tuple(kinds)
    unknown = set(kinds) - {"flipped", "original", "augmented"}
    if unknown:
        raise ValueError(f"unknown kinds: {sorted(unknown)}")
    summary: dict[str, dict] = {"classes": {}}
    dbinfo: dict[str, list] = {
        k: [] for k in ("imagenet_train", "imagenet_val", "pascal_train", "pascal_val")
    }

    for cls in classes:
        splits = pascal3d_splits(db_path, voc_dir, cls)
        sources = _pascal3d_sources(db_path, cls)
        cad = None
        if "augmented" in kinds:
            cad_file = db_path / "CAD" / f"{cls}.mat"
            if cad_file.exists():
                cad = load_cad_vertices(cad_file, cls)
            else:
                log(f"[{cls}] no CAD model file, skipping augmentation")

        train_names: list[str] = []
        test_names: list[str] = []
        aug_names: list[str] = []
        original_names: dict[str, list[str]] = {k: [] for k in splits}
        surviving: dict[str, list[str]] = {k: [] for k in splits}

        def process_one(split: str, name: str) -> tuple[str, str, dict] | None:
            source = "imagenet" if split.startswith("imagenet") else "pascal"
            image_dir, anno_dir = sources[source]
            anno_file = anno_dir / f"{name}.mat"
            if not anno_file.exists():
                return None
            img = load_rgb_image(image_dir / name)
            if img is None:
                return None
            objects = _filter_objects(load_record_objects(anno_file), img)
            iid = image_id(name)
            wrote: dict[str, list[str]] = {}
            is_train = split != "pascal_val"
            if "flipped" in kinds:
                if is_train:
                    wrote["train"] = write_flipped_crops(
                        img, objects, iid, out_root / "train" / cls, cls
                    )
                else:
                    wrote["test"] = write_test_crops(
                        img, objects, iid, out_root / "test" / cls, cls
                    )
            if "original" in kinds:
                wrote["original"] = write_original_crops(
                    img, objects, name, out_root / "original" / cls, cls
                )
            if "augmented" in kinds and cad is not None and is_train:
                wrote["augmented"] = write_augmented_crops(
                    img, objects, cad, iid, out_root / "augmented2" / cls, cls
                )
            return split, name, wrote

        jobs = [(split, n) for split, names in splits.items() for n in names]
        with cf.ThreadPoolExecutor(max(workers, 1)) as pool:
            results = list(pool.map(lambda a: process_one(*a), jobs))
        for res in results:
            if res is None:
                continue
            split, name, wrote = res
            if any(wrote.values()):
                surviving[split].append(name)
            train_names += wrote.get("train", [])
            test_names += wrote.get("test", [])
            aug_names += wrote.get("augmented", [])
            if wrote.get("original"):
                original_names[split].append(name)

        # index files consumed by ClassBalancedIndex / FlatTestIndex /
        # MatCropIndex (ImagesAll reads <tree>/<cls>_info.mat 'image_names',
        # dataGenerators.py:35-37; Pascal3dAll reads pascal_train/pascal_val)
        if "flipped" in kinds:
            write_info_mat(out_root / "train", cls, train_names)
            write_info_mat(out_root / "test", cls, test_names)
        if "augmented" in kinds and cad is not None:
            write_info_mat(out_root / "augmented2", cls, aug_names)
        if "original" in kinds:
            write_info_mat(
                out_root / "original", cls,
                [n for v in original_names.values() for n in v],
                pascal_train=original_names["pascal_train"],
                pascal_val=original_names["pascal_val"],
            )
            if original_names["imagenet_train"] or original_names["imagenet_val"]:
                import scipy.io as spio

                # object dtype -> MATLAB cellstr (what the real setup
                # scripts save; char matrices load space-padded)
                extra = {
                    k: np.array(original_names[k], dtype=object)
                    for k in ("imagenet_train", "imagenet_val",
                              "pascal_train", "pascal_val")
                }
                extra["image_names"] = np.array(
                    [n for v in original_names.values() for n in v],
                    dtype=object,
                )
                spio.savemat(
                    str(out_root / "original" / f"{cls}_info.mat"), extra
                )
        for k in dbinfo:
            dbinfo[k].append(np.array(surviving[k]))
        summary["classes"][cls] = {
            "train_crops": len(train_names),
            "test_crops": len(test_names),
            "augmented_crops": len(aug_names),
            "original_images": sum(len(v) for v in original_names.values()),
        }
        log(f"[{cls}] " + ", ".join(
            f"{k}={v}" for k, v in summary["classes"][cls].items()
        ))

    import scipy.io as spio

    out_root.mkdir(parents=True, exist_ok=True)
    # object cell arrays need element-wise assignment
    tmp = {k: np.empty(len(v), object) for k, v in dbinfo.items()}
    for k, v in dbinfo.items():
        for i, arr in enumerate(v):
            tmp[k][i] = arr
    tmp["classes"] = np.array(list(classes), dtype=object)  # cellstr
    spio.savemat(str(out_root / "dbinfo.mat"), tmp)
    return summary


# ---------------------------------------------------------------------------
# ObjectNet3D walker
# ---------------------------------------------------------------------------

def prepare_objectnet3d(
    db_path: str | Path,
    out_root: str | Path,
    workers: int = 8,
    log: Callable[[str], None] = print,
) -> dict:
    """Walk an ObjectNet3D release (setupDataFlipped_objectnet3d.m).

    Reads Image_sets/classes.txt + train.txt/val.txt, crops every annotated
    object (coarse-viewpoint fallback; no truncated/occluded filter — the
    ObjectNet protocol keeps everything), and writes:

      train/<cls>/*.png   8 copies per object: {orig, flip} x {0, 90, 180,
                          270} deg rotations with ct adjusted by the
                          rotation and (az, ct) negated for flips
      test/<cls>/*.png    one plain crop per object
      {train,test}/<cls>_info.mat, dbinfo.mat

    Class ids in filenames drop underscores (get_id is applied to the class
    name too, :89-90), and the directory name keeps the raw class name.
    """
    db_path, out_root = Path(db_path), Path(out_root)
    sets = db_path / "Image_sets"
    classes = read_image_set(sets / "classes.txt")
    train_images = read_image_set(sets / "train.txt")
    test_images = read_image_set(sets / "val.txt")
    image_dir = db_path / "Images"
    anno_dir = db_path / "Annotations"

    train_path = out_root / "train"
    test_path = out_root / "test"

    def crops_for(obj: ObjectAnnotation, img: np.ndarray) -> np.ndarray | None:
        if _bad_bbox(obj, img):
            return None
        return crop_patch(img, obj.bbox)

    def process(name: str, train: bool) -> list[tuple[str, str]]:
        """-> [(cls, written_name)]"""
        img = load_rgb_image(image_dir / name, gray_to_rgb=True)
        anno_file = anno_dir / f"{name}.mat"
        if img is None or not anno_file.exists():
            return []
        iid = image_id(name)
        written = []
        for j, obj in enumerate(load_record_objects(anno_file), start=1):
            patch = crops_for(obj, img)
            if patch is None or obj.cls not in classes:
                continue
            clsid = image_id(obj.cls)
            save_dir = (train_path if train else test_path) / obj.cls
            save_dir.mkdir(parents=True, exist_ok=True)
            prefix = f"{clsid}_{iid}object{j}"
            az, el, ct, d = obj.az, obj.el, obj.ct, obj.distance
            if not train:
                name_out = make_name(prefix, az, el, ct, d)
                save_png(patch, save_dir / f"{name_out}.png")
                written.append((obj.cls, name_out))
                continue
            flipped = np.ascontiguousarray(patch[:, ::-1])
            for base, (a, c) in ((patch, (az, ct)), (flipped, (-az, -ct))):
                for k in range(4):  # imrotate 0/90/180/270 (CCW), ct - 90k
                    rot = np.ascontiguousarray(np.rot90(base, k))
                    name_out = make_name(prefix, a, el, c - 90.0 * k, d)
                    save_png(rot, save_dir / f"{name_out}.png")
                    written.append((obj.cls, name_out))
        return written

    names_by_cls: dict[str, dict[str, list[str]]] = {
        c: {"train": [], "test": []} for c in classes
    }
    with cf.ThreadPoolExecutor(max(workers, 1)) as pool:
        for written in pool.map(lambda n: process(n, True), train_images):
            for cls, n in written:
                names_by_cls[cls]["train"].append(n)
        for written in pool.map(lambda n: process(n, False), test_images):
            for cls, n in written:
                names_by_cls[cls]["test"].append(n)

    import scipy.io as spio

    for cls in classes:
        for split, path in (("train", train_path), ("test", test_path)):
            (path / cls).mkdir(parents=True, exist_ok=True)
            write_info_mat(path, cls, sorted(names_by_cls[cls][split]))
        log(
            f"[{cls}] train={len(names_by_cls[cls]['train'])} "
            f"test={len(names_by_cls[cls]['test'])}"
        )
    out_root.mkdir(parents=True, exist_ok=True)
    spio.savemat(
        str(out_root / "dbinfo.mat"),
        {
            "classes": np.array(classes),
            "train_images": np.array(train_images),
            "test_images": np.array(test_images),
        },
    )
    return {
        c: {k: len(v) for k, v in d.items()} for c, d in names_by_cls.items()
    }


# ---------------------------------------------------------------------------
# detector-output parsers (setupDataDetection_*.m)
# ---------------------------------------------------------------------------

VK_CLASS_INDS = (1, 2, 4, 5, 6, 7, 9, 11, 14, 18, 19, 20)  # 1-based VOC ids


def _cell_list(arr) -> list:
    """Flatten a MATLAB cell array (object ndarray) into a Python list."""
    return list(np.asarray(arr, object).ravel())


def parse_vk_detections(
    det_mat: str | Path, num_images: int | None = None
) -> list[tuple[np.ndarray, np.ndarray]]:
    """V&K VOC2012_val_det.mat -> per-image (boxes (n,5) with score column,
    labels (n,) 1-based) (setupDataDetection_vk.m:26-47: `chosenboxes` /
    `topscores` cells over the 20 VOC classes, subset to the 12 rigid ones)."""
    import scipy.io as spio

    tmp = spio.loadmat(str(det_mat), squeeze_me=False)
    chosen = _cell_list(tmp["chosenboxes"])
    tops = _cell_list(tmp["topscores"])
    per_class = []
    for ind in VK_CLASS_INDS:
        boxes_imgs = _cell_list(chosen[ind - 1])
        score_imgs = _cell_list(tops[ind - 1])
        per_class.append((boxes_imgs, score_imgs))
    n = num_images or len(per_class[0][0])
    out = []
    for i in range(n):
        rows, labels = [], []
        for ci, (boxes_imgs, score_imgs) in enumerate(per_class, start=1):
            b = np.asarray(boxes_imgs[i], np.float64).reshape(-1, 4) \
                if np.asarray(boxes_imgs[i]).size else np.zeros((0, 4))
            s = np.asarray(score_imgs[i], np.float64).reshape(-1, 1) \
                if np.asarray(score_imgs[i]).size else np.zeros((0, 1))
            if len(b) == 0:
                continue
            rows.append(np.concatenate([b, s], axis=1))
            labels.append(np.full(len(b), ci, np.int64))
        if rows:
            out.append((np.concatenate(rows), np.concatenate(labels)))
        else:
            out.append((np.zeros((0, 5)), np.zeros(0, np.int64)))
    return out


def parse_r4cnn_detections(
    det_dir: str | Path,
    classes: Sequence[str] = PASCAL3D_CLASSES,
    num_images: int | None = None,
) -> list[tuple[np.ndarray, np.ndarray]]:
    """Render4CNN per-class `<cls>_pruned_boxes_voc_2012_val_bbox_reg.mat`
    (a `boxes` cell of (n,5) score rows per image,
    setupDataDetection_r4cnn.m:26-30) -> per-image (boxes, labels)."""
    import scipy.io as spio

    det_dir = Path(det_dir)
    per_class = []
    for cls in classes:
        tmp = spio.loadmat(
            str(det_dir / f"{cls}_pruned_boxes_voc_2012_val_bbox_reg.mat"),
            squeeze_me=False,
        )
        per_class.append(_cell_list(tmp["boxes"]))
    n = num_images or len(per_class[0])
    out = []
    for i in range(n):
        rows, labels = [], []
        for ci, boxes_imgs in enumerate(per_class, start=1):
            b = np.asarray(boxes_imgs[i], np.float64)
            b = b.reshape(-1, b.shape[-1]) if b.size else np.zeros((0, 5))
            if len(b) == 0:
                continue
            rows.append(b)
            labels.append(np.full(len(b), ci, np.int64))
        if rows:
            out.append((np.concatenate(rows), np.concatenate(labels)))
        else:
            out.append((np.zeros((0, 5)), np.zeros(0, np.int64)))
    return out


def parse_maskrcnn_results(
    results_dir: str | Path,
    image_names: Sequence[str],
    classes: Sequence[str] = PASCAL3D_CLASSES,
    file_pattern: str = "results_{cls}.txt",
) -> list[tuple[np.ndarray, np.ndarray]]:
    """MaskRCNN `results_<cls>.txt` files (`<image> x1 y1 x2 y2 score` rows,
    setupDataDetection_maskrcnn.m:31-44; the files use 'motorcycle' for the
    'motorbike' class — pass the detector's own class spellings) -> per-image
    (boxes (n,5), labels)."""
    results_dir = Path(results_dir)
    index = {n: i for i, n in enumerate(image_names)}
    rows: list[list[np.ndarray]] = [[] for _ in image_names]
    labs: list[list[int]] = [[] for _ in image_names]
    for ci, cls in enumerate(classes, start=1):
        f = results_dir / file_pattern.format(cls=cls)
        if not f.exists():
            continue
        for line in f.read_text().splitlines():
            parts = line.split()
            if len(parts) < 6 or parts[0] not in index:
                continue
            i = index[parts[0]]
            rows[i].append(np.asarray([float(v) for v in parts[1:6]]))
            labs[i].append(ci)
    out = []
    for i in range(len(image_names)):
        if rows[i]:
            out.append(
                (np.stack(rows[i]), np.asarray(labs[i], np.int64))
            )
        else:
            out.append((np.zeros((0, 5)), np.zeros(0, np.int64)))
    return out


def parse_objectnet_detections(
    txt_path: str | Path,
) -> dict[str, np.ndarray]:
    """Fast-RCNN `detections_<cls>.txt` rows
    `<image> x1 y1 x2 y2 score y1 y2 y3`
    (setupDataDetected_objectnet3d.m:24-29) -> arrays {image_names, bboxes,
    det_scores, ypred} — the `<cls>_detinfo.mat` payload."""
    names, boxes, scores, ypred = [], [], [], []
    for line in Path(txt_path).read_text().splitlines():
        parts = line.split()
        if len(parts) < 9:
            continue
        names.append(parts[0])
        vals = [float(v) for v in parts[1:9]]
        boxes.append(vals[:4])
        scores.append(vals[4])
        ypred.append(vals[5:8])
    return {
        "image_names": np.array(names),
        "bboxes": np.asarray(boxes, np.float64).reshape(-1, 4),
        "det_scores": np.asarray(scores, np.float64),
        "ypred": np.asarray(ypred, np.float64).reshape(-1, 3),
    }


def prepare_detection_set(
    images_dir: str | Path,
    image_names: Sequence[str],
    detections: Sequence[tuple[np.ndarray, np.ndarray]],
    out_dir: str | Path,
    size: int = 224,
    workers: int = 8,
) -> None:
    """Crop a parsed detection list into the `dbinfo.mat + all/<img>.mat`
    layout detection.DetectionSetIndex reads (the shared tail of every
    setupDataDetection_*.m script). Boxes keep their score column."""
    import scipy.io as spio

    from multi_modal_regression_tpu_torch.tools.pascal3d_prep import crop_patch_resized

    out_dir = Path(out_dir)
    (out_dir / "all").mkdir(parents=True, exist_ok=True)
    images_dir = Path(images_dir)

    def process(args) -> None:
        name, (boxes, labels) = args
        payload = {
            "xdata": np.zeros((0,)),
            "bboxes": np.asarray(boxes, np.float64),
            "labels": np.asarray(labels, np.int64),
        }
        img = load_rgb_image(images_dir / name, gray_to_rgb=True)
        if img is not None and len(boxes):
            payload["xdata"] = np.stack(
                [crop_patch_resized(img, b[:4], size) for b in boxes]
            )
        spio.savemat(str(out_dir / "all" / f"{name}.mat"), payload)

    with cf.ThreadPoolExecutor(max(workers, 1)) as pool:
        list(pool.map(process, zip(image_names, detections)))
    spio.savemat(
        str(out_dir / "dbinfo.mat"),
        {"image_names": np.array(list(image_names), dtype=object)},  # cellstr
    )


def prepare_objectnet_detected(
    det_path: str | Path,
    image_dir: str | Path,
    out_dir: str | Path,
    classes: Sequence[str],
    size: int = 224,
    workers: int = 8,
) -> int:
    """The setupDataDetected_objectnet3d.m script (reference :24-41).

    Per class: parse the Fast-RCNN `detections_<cls>.txt`, save
    `<out>/<cls>_detinfo.mat` ({image_names, bboxes, det_scores, ypred} —
    the reference's save at :33) and write the crop tree
    `<out>/<cls>/<cls>_%08d.png` (1-based, downscale-only patches like the
    reference's get_patch at :45-53).

    Additionally composes ALL classes into the `dbinfo.mat + all/<img>.mat`
    detection-set layout (prepare_detection_set), so the same `<out>` path
    feeds `cli predict --det-path` directly — the MATLAB pipeline stops at
    PNG trees and leaves batching to a separate script. Returns the total
    number of detections written.
    """
    import scipy.io as spio

    det_path = Path(det_path)
    image_dir = Path(image_dir)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    per_image: dict[str, tuple[list, list]] = {}
    total = 0
    for ci, cls in enumerate(classes, start=1):
        txt = det_path / f"detections_{cls}.txt"
        if not txt.exists():
            continue
        info = parse_objectnet_detections(txt)
        cls_dir = out_dir / cls
        cls_dir.mkdir(parents=True, exist_ok=True)
        spio.savemat(str(out_dir / f"{cls}_detinfo.mat"), info)

        def process(args) -> int:
            j, name, box = args
            img = load_rgb_image(image_dir / str(name), gray_to_rgb=True)
            if img is None:
                return 0
            patch = crop_patch(img, box, max_size=size)
            save_png(patch, cls_dir / f"{cls}_{j:08d}.png")
            return 1

        rows = [
            (j + 1, n, b)
            for j, (n, b) in enumerate(
                zip(info["image_names"], info["bboxes"])
            )
        ]
        with cf.ThreadPoolExecutor(max(workers, 1)) as pool:
            # count WRITTEN crops: rows whose source image is missing get
            # no PNG (the 1-based numbering still tracks the detinfo rows)
            total += sum(pool.map(process, rows))
        for name, box, score in zip(
            info["image_names"], info["bboxes"], info["det_scores"]
        ):
            b, l = per_image.setdefault(str(name), ([], []))
            b.append(np.concatenate([box, [score]]))
            l.append(ci)
    image_names = sorted(per_image)
    detections = [
        (np.stack(per_image[n][0]), np.asarray(per_image[n][1], np.int64))
        for n in image_names
    ]
    prepare_detection_set(
        image_dir, image_names, detections, out_dir, size=size,
        workers=workers,
    )
    return total
