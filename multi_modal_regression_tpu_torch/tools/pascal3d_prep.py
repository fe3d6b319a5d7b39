"""PASCAL3D+ / ObjectNet3D data preparation (the port's copy of the JAX
package's tools/pascal3d_prep.py, itself a Python port of the MATLAB layer).

Replaces the reference's offline MATLAB scripts:

  setupDataOriginal_pascal3d.m   GT-bbox crops resized to 224^2 saved as
                                 per-image .mat (xdata, ydata) + <cls>_info
                                 split files (:73-136)
  setupDataFlipped_pascal3d.m    PNG crops with pose-encoded filenames +
                                 horizontally flipped copies with
                                 (-az, el, -ct) (:110-135)
  setupDataAugmented_pascal3d.m  pose-jittered augmentation: project visible
                                 CAD vertices at the GT pose and a perturbed
                                 pose, fit a homography, warp, re-crop
                                 (:118-221)
  setupDataDetection_*.m         224^2 patches from third-party detector
                                 boxes -> all/<img>.mat + dbinfo

Pure numpy/PIL (PIL imported by the functions that resize) — these run
on host as offline prep (parallelize with any process pool; the reference
used MATLAB parfor). The one exception, `write_original_crops`' axis-angle
targets, goes through the port's geometry/so3 on the CPU in float32, as
the JAX writer goes through its jax.numpy so3 in float32. The camera model
matches get_R.m / project(): object->camera via ZXZ Euler (-az, 90+el,
-ct), then perspective projection with focal*viewport and principal point
(px, py).
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Sequence

import numpy as np

from multi_modal_regression_tpu_torch.data.naming import make_name
from multi_modal_regression_tpu_torch.data.native import save_png


# ---------------------------------------------------------------------------
# camera model (setupDataAugmented_pascal3d.m:175-221)
# ---------------------------------------------------------------------------

def camera_rotation(az: float, el: float, ct: float) -> np.ndarray:
    """Object->camera rotation: ZXZ Euler of (-az, 90+el, -ct) degrees."""
    a, b, c = -az, 90.0 + el, -ct
    sa, ca = np.sin(np.radians(a)), np.cos(np.radians(a))
    sb, cb = np.sin(np.radians(b)), np.cos(np.radians(b))
    sc, cc = np.sin(np.radians(c)), np.cos(np.radians(c))
    Rz_c = np.array([[cc, -sc, 0], [sc, cc, 0], [0, 0, 1]])
    Rx_b = np.array([[1, 0, 0], [0, cb, -sb], [0, sb, cb]])
    Rz_a = np.array([[ca, -sa, 0], [sa, ca, 0], [0, 0, 1]])
    return Rz_c @ Rx_b @ Rz_a


def project_vertices(
    P: np.ndarray, az: float, el: float, ct: float, d: float,
    f: float, px: float, py: float,
) -> tuple[np.ndarray, np.ndarray]:
    """Project (N, 3) object-space vertices to image (x, y) pixels."""
    R = camera_rotation(az, el, ct)
    Pn = P @ R.T + np.array([0.0, 0.0, d])
    x = f * Pn[:, 0] / Pn[:, 2] + px
    y = f * Pn[:, 1] / Pn[:, 2] + py
    return x, y


def visible_vertices(
    P: np.ndarray, az: float, el: float, ct: float, d: float
) -> np.ndarray:
    """Boolean mask of the ~25% of vertices closest to the camera (the
    reference's visibility heuristic, setupDataAugmented_pascal3d.m:174-196)."""
    R = camera_rotation(az, el, ct)
    Pn = P @ R.T + np.array([0.0, 0.0, d])
    dist = np.linalg.norm(Pn, axis=1)
    th = np.sort(dist)[int(np.ceil(0.25 * len(dist))) - 1]
    return dist < th


# ---------------------------------------------------------------------------
# homography fitting + warping (fitgeotrans 'projective' / imwarp)
# ---------------------------------------------------------------------------

def fit_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares projective transform H with dst ~ H @ src (DLT + SVD).

    src, dst: (N, 2) point correspondences, N >= 4.
    """
    src = np.asarray(src, np.float64)
    dst = np.asarray(dst, np.float64)
    n = len(src)
    if n < 4:
        raise ValueError("need >= 4 correspondences")
    # normalize for conditioning
    def norm_T(p):
        c = p.mean(0)
        s = np.sqrt(2.0) / max(np.mean(np.linalg.norm(p - c, axis=1)), 1e-12)
        T = np.array([[s, 0, -s * c[0]], [0, s, -s * c[1]], [0, 0, 1]])
        return T

    Ts, Td = norm_T(src), norm_T(dst)
    sh = (src @ Ts[:2, :2].T) + Ts[:2, 2]
    dh = (dst @ Td[:2, :2].T) + Td[:2, 2]
    A = np.zeros((2 * n, 9))
    for i in range(n):
        X, Y = sh[i]
        u, v = dh[i]
        A[2 * i] = [-X, -Y, -1, 0, 0, 0, u * X, u * Y, u]
        A[2 * i + 1] = [0, 0, 0, -X, -Y, -1, v * X, v * Y, v]
    _, _, Vt = np.linalg.svd(A)
    Hn = Vt[-1].reshape(3, 3)
    H = np.linalg.inv(Td) @ Hn @ Ts
    return H / H[2, 2]


def warp_image(
    img: np.ndarray, H: np.ndarray
) -> tuple[np.ndarray, tuple[float, float]]:
    """Forward-warp an image under homography H with auto output bounds
    (imwarp semantics). Returns (warped, (x_offset, y_offset)) where offsets
    map warped coordinates back to transformed-source coordinates."""
    h, w = img.shape[:2]
    corners = np.array([[0, 0], [w - 1, 0], [0, h - 1], [w - 1, h - 1]], float)
    ch = np.concatenate([corners, np.ones((4, 1))], axis=1) @ H.T
    cx, cy = ch[:, 0] / ch[:, 2], ch[:, 1] / ch[:, 2]
    x0, x1 = np.floor(cx.min()), np.ceil(cx.max())
    y0, y1 = np.floor(cy.min()), np.ceil(cy.max())
    out_w, out_h = int(x1 - x0 + 1), int(y1 - y0 + 1)
    if out_w <= 0 or out_h <= 0 or out_w * out_h > 64e6:
        raise ValueError("degenerate homography output bounds")
    # inverse map output grid -> source, bilinear sample
    Hinv = np.linalg.inv(H)
    ys, xs = np.mgrid[0:out_h, 0:out_w]
    pts = np.stack(
        [xs.ravel() + x0, ys.ravel() + y0, np.ones(out_h * out_w)], axis=1
    )
    sp = pts @ Hinv.T
    sx = sp[:, 0] / sp[:, 2]
    sy = sp[:, 1] / sp[:, 2]
    valid = (sx >= 0) & (sx <= w - 1) & (sy >= 0) & (sy <= h - 1)
    sx = np.clip(sx, 0, w - 1)
    sy = np.clip(sy, 0, h - 1)
    x0i = np.floor(sx).astype(int)
    y0i = np.floor(sy).astype(int)
    x1i = np.minimum(x0i + 1, w - 1)
    y1i = np.minimum(y0i + 1, h - 1)
    fx = (sx - x0i)[:, None]
    fy = (sy - y0i)[:, None]
    src = img.reshape(h * w, -1).astype(np.float64)
    idx = lambda yy, xx: src[yy * w + xx]
    out = (
        idx(y0i, x0i) * (1 - fx) * (1 - fy)
        + idx(y0i, x1i) * fx * (1 - fy)
        + idx(y1i, x0i) * (1 - fx) * fy
        + idx(y1i, x1i) * fx * fy
    )
    out[~valid] = 0
    out = out.reshape(out_h, out_w, -1)
    if img.ndim == 2:
        out = out[..., 0]
    return out.astype(img.dtype), (float(x0), float(y0))


# ---------------------------------------------------------------------------
# crops (get_patch, setupDataFlipped_pascal3d.m:126-135)
# ---------------------------------------------------------------------------

def crop_patch(img: np.ndarray, bbox: Sequence[float], max_size: int = 224) -> np.ndarray:
    """Extract the bbox patch with downscale-only resize (aspect kept)."""
    from PIL import Image

    h, w = img.shape[:2]
    x1 = max(0, int(round(bbox[0])))
    y1 = max(0, int(round(bbox[1])))
    x2 = min(w - 1, int(round(bbox[2])))
    y2 = min(h - 1, int(round(bbox[3])))
    patch = img[y1 : y2 + 1, x1 : x2 + 1]
    ph, pw = patch.shape[:2]
    scale = max(ph / max_size, pw / max_size)
    if scale > 1:
        patch = np.asarray(
            Image.fromarray(patch).resize(
                (max(1, int(round(pw / scale))), max(1, int(round(ph / scale)))),
                Image.BILINEAR,
            )
        )
    return patch


def crop_patch_resized(img: np.ndarray, bbox: Sequence[float], size: int = 224) -> np.ndarray:
    """Extract the bbox patch resized exactly to size^2
    (setupDataOriginal_pascal3d.m:127-136 / setupDataDetection_*.m)."""
    from PIL import Image

    patch = crop_patch(img, bbox, max_size=10**9)  # no downscale cap
    return np.asarray(
        Image.fromarray(patch).resize((size, size), Image.BILINEAR)
    )


@dataclasses.dataclass
class ObjectAnnotation:
    """One annotated object (the PASCAL3D+ record.objects entry subset)."""

    cls: str
    bbox: np.ndarray  # (4,) [x1 y1 x2 y2]
    az: float
    el: float
    ct: float
    distance: float
    focal: float = 3000.0  # focal * viewport
    px: float = 0.0
    py: float = 0.0
    cad_index: int = 0
    truncated: bool = False
    occluded: bool = False
    # evaluation-protocol fields (computeAVP.m:49-63): 'difficult' is the
    # eval filter; coarse angles are the fallback when distance == 0
    difficult: bool = False
    azimuth_coarse: float = 0.0
    elevation_coarse: float = 0.0

    @property
    def usable(self) -> bool:
        """The TRAINING-prep filters (setupDataOriginal_pascal3d.m:89-94).
        Evaluation GT uses only the `difficult` flag (computeAVP.m:49-50)."""
        return not self.truncated and not self.occluded and self.distance != 0

    @property
    def eval_angles(self) -> tuple[float, float, float]:
        """(az, el, ct) with the coarse fallback for distance == 0
        (computeARP.m:57-67)."""
        if self.distance == 0:
            return self.azimuth_coarse, self.elevation_coarse, self.ct
        return self.az, self.el, self.ct


def _correct_angle(x: float) -> float:
    return x + 360.0 if x < 0 else x


def write_flipped_crops(
    img: np.ndarray,
    objects: Sequence[ObjectAnnotation],
    image_id: str,
    save_dir: str | Path,
    cls: str,
) -> list[str]:
    """setupDataFlipped port: write each usable object's crop + flipped copy
    with pose in the filename (cls_{id}object{j}_a.._e.._t.._d..). Returns
    the written image names (no extension)."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for j, obj in enumerate(objects, start=1):
        if obj.cls != cls or not obj.usable:
            continue
        patch = crop_patch(img, obj.bbox)
        prefix = f"{cls}_{image_id}object{j}"
        for p, (az, el, ct) in (
            (patch, (obj.az, obj.el, obj.ct)),
            (np.ascontiguousarray(patch[:, ::-1]), (-obj.az, obj.el, -obj.ct)),
        ):
            name = make_name(prefix, az, el, ct, obj.distance)
            save_png(p, save_dir / f"{name}.png")
            names.append(name)
    return names


def write_original_crops(
    img: np.ndarray,
    objects: Sequence[ObjectAnnotation],
    image_id: str,
    save_dir: str | Path,
    cls: str,
) -> list[str]:
    """setupDataOriginal port: per-object 224^2 crops + axis-angle targets
    in one `<image_id>.mat` (xdata (n,224,224,3), ydata (n,3)); returns
    [image_id + '.mat'] if any object was usable."""
    import scipy.io as spio

    import torch

    from multi_modal_regression_tpu_torch.geometry.so3 import log_so3, rotation_from_euler

    xs, ys = [], []
    for obj in objects:
        if obj.cls != cls or not obj.usable:
            continue
        xs.append(crop_patch_resized(img, obj.bbox))
        # float32 on the CPU: host prep, not a device entry point
        az, el, ct = (torch.tensor(v, dtype=torch.float32)
                      for v in (obj.az, obj.el, obj.ct))
        ys.append(log_so3(rotation_from_euler(az, el, ct)).numpy())
    if not xs:
        return []
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    spio.savemat(
        str(save_dir / f"{image_id}.mat"),
        {"xdata": np.stack(xs), "ydata": np.stack(ys)},
    )
    return [f"{image_id}.mat"]


def augmented_patches(
    img: np.ndarray,
    obj: ObjectAnnotation,
    vertices: np.ndarray,
    az_range: Sequence[float] = (-1, 0, 1),
    el_range: Sequence[float] = (-1, 0, 1),
    ct_range: Sequence[float] = (-4, -2, 0, 2, 4),
) -> list[tuple[np.ndarray, tuple[float, float, float]]]:
    """Pose-jittered augmentation (setupDataAugmented_pascal3d.m:118-171):
    for each (daz, del, dct) in the grid, fit the homography between the
    visible-vertex projections at the annotated and perturbed poses, warp
    the image, re-crop via the warped bbox mask, and also emit the
    horizontal flip with (-az, el, -ct). Returns (patch, (az, el, ct))."""
    from PIL import Image

    h, w = img.shape[:2]
    x1 = max(0, int(round(obj.bbox[0])))
    y1 = max(0, int(round(obj.bbox[1])))
    x2 = min(w - 1, int(round(obj.bbox[2])))
    y2 = min(h - 1, int(round(obj.bbox[3])))
    mask = np.zeros((h, w), np.uint8)
    mask[y1 : y2 + 1, x1 : x2 + 1] = 255

    vis = visible_vertices(vertices, obj.az, obj.el, obj.ct, obj.distance)
    x, y = project_vertices(
        vertices[vis], obj.az, obj.el, obj.ct, obj.distance,
        obj.focal, obj.px, obj.py,
    )
    src = np.stack([x, y], axis=1)

    out = []
    for daz in az_range:
        for dele in el_range:
            for dct in ct_range:
                az_n, el_n, ct_n = obj.az + daz, obj.el + dele, obj.ct + dct
                xt, yt = project_vertices(
                    vertices[vis], az_n, el_n, ct_n, obj.distance,
                    obj.focal, obj.px, obj.py,
                )
                try:
                    H = fit_homography(src, np.stack([xt, yt], axis=1))
                    # extreme shape change -> skip (reference :149-151)
                    ch = (
                        np.array([[0, 0, 1], [w - 1, h - 1, 1]], float) @ H.T
                    )
                    cx = ch[:, 0] / ch[:, 2]
                    cy = ch[:, 1] / ch[:, 2]
                    if abs(cx[1] - cx[0]) > 10 * w and abs(cy[1] - cy[0]) > 10 * h:
                        continue
                    new_img, _ = warp_image(img, H)
                    new_mask, _ = warp_image(mask, H)
                except (ValueError, np.linalg.LinAlgError):
                    continue
                cols = np.where(new_mask.sum(axis=0) > 0)[0]
                rows = np.where(new_mask.sum(axis=1) > 0)[0]
                if len(cols) == 0 or len(rows) == 0:
                    continue
                patch = new_img[rows[0] : rows[-1] + 1, cols[0] : cols[-1] + 1]
                ph, pw = patch.shape[:2]
                if ph < 2 or pw < 2:
                    continue
                scale = max(ph / 224, pw / 224)
                if scale > 1:
                    patch = np.asarray(
                        Image.fromarray(patch).resize(
                            (int(round(pw / scale)), int(round(ph / scale))),
                            Image.BILINEAR,
                        )
                    )
                out.append((patch, (az_n, el_n, ct_n)))
                out.append(
                    (
                        np.ascontiguousarray(patch[:, ::-1]),
                        (-az_n, el_n, -ct_n),
                    )
                )
    return out


def write_augmented_crops(
    img: np.ndarray,
    objects: Sequence[ObjectAnnotation],
    vertices_by_cad: Sequence[np.ndarray],
    image_id: str,
    save_dir: str | Path,
    cls: str,
) -> list[str]:
    """Full setupDataAugmented per-image writer: augmentation grid for each
    usable object (falling back to the plain crop on failure), filenames
    with angles wrapped to [0, 360) (correct_angle, :228-233)."""
    save_dir = Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    names = []
    for j, obj in enumerate(objects, start=1):
        if obj.cls != cls or not obj.usable:
            continue
        try:
            patches = augmented_patches(
                img, obj, vertices_by_cad[obj.cad_index]
            )
        except Exception:
            patches = []
        if not patches:
            patches = [(crop_patch(img, obj.bbox), (obj.az, obj.el, obj.ct))]
        prefix = f"{cls}_{image_id}object{j}"
        for k, (patch, (az, el, ct)) in enumerate(patches):
            name = make_name(
                prefix,
                _correct_angle(az), _correct_angle(el), _correct_angle(ct),
                obj.distance,
            )
            save_png(patch, save_dir / f"{name}.png")
            names.append(name)
    return names


def write_info_mat(
    db_path: str | Path,
    cls: str,
    image_names: Sequence[str],
    *,
    pascal_train: Sequence[str] | None = None,
    pascal_val: Sequence[str] | None = None,
    suffix: str = "_info",
) -> Path:
    """Write a `<cls><suffix>.mat` index file (the split files the readers
    consume: setupDataOriginal_pascal3d.m:70 writes image_names plus
    pascal_train/pascal_val name lists)."""
    import scipy.io as spio

    out = Path(db_path) / f"{cls}{suffix}.mat"
    # object dtype -> MATLAB cell arrays, the layout the real setup scripts
    # save (cellstr). A plain str array becomes a space-padded char matrix,
    # which the reference's own readers (dataGenerators.py:36 — no strip)
    # cannot open paths from.
    payload = {"image_names": np.array(list(image_names), dtype=object)}
    if pascal_train is not None:
        payload["pascal_train"] = np.array(list(pascal_train), dtype=object)
    if pascal_val is not None:
        payload["pascal_val"] = np.array(list(pascal_val), dtype=object)
    spio.savemat(str(out), payload)
    return out


def write_detection_crops(
    images: dict[str, np.ndarray],
    detections: dict[str, tuple[np.ndarray, np.ndarray]],
    out_dir: str | Path,
    size: int = 224,
) -> None:
    """setupDataDetection port: for each image name -> (boxes (n,4),
    labels (n,) 1-based), write `all/<name>.mat` with resized crops and a
    `dbinfo.mat` index — the layout detection.DetectionSetIndex reads."""
    import scipy.io as spio

    out_dir = Path(out_dir)
    (out_dir / "all").mkdir(parents=True, exist_ok=True)
    names = sorted(images)
    for name in names:
        img = images[name]
        boxes, labels = detections.get(name, (np.zeros((0, 4)), np.zeros(0)))
        if len(boxes) == 0:
            spio.savemat(
                str(out_dir / "all" / f"{name}.mat"),
                {"xdata": np.zeros((0,)), "bboxes": np.zeros((0, 4)),
                 "labels": np.zeros((0,), np.int64)},
            )
            continue
        crops = np.stack(
            [crop_patch_resized(img, b, size) for b in np.asarray(boxes)]
        )
        spio.savemat(
            str(out_dir / "all" / f"{name}.mat"),
            {
                "xdata": crops,
                "bboxes": np.asarray(boxes, np.float64),
                "labels": np.asarray(labels, np.int64),
            },
        )
    spio.savemat(
        str(out_dir / "dbinfo.mat"),
        {"image_names": np.array(names, dtype=object)},  # cellstr layout
    )
