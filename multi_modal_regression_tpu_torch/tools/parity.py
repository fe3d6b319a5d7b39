"""The dictionary stage of the quality-parity chain (port of the JAX
package's tools/parity.py, as far as `cli dictionary` needs it):

  learnKmeansDictionary.py:25-47: parse every filename-encoded pose of a
  render tree, fit a kmeans dictionary on the device, save it as an npz.

The rest of the chain (data prep, train, snapshot-ensemble evaluation,
detection metrics; `run_parity_gate`) arrives with those slices
(ROADMAP.md).
"""

from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from multi_modal_regression_tpu_torch.data.index import ClassBalancedIndex
from multi_modal_regression_tpu_torch.data.naming import parse_name
from multi_modal_regression_tpu_torch.data.targets import euler_to_pose
from multi_modal_regression_tpu_torch.dictionary.kmeans import fit_kmeans


def gather_tree_poses(
    tree_root: str | Path, db_type: str = "render",
    classes: tuple[str, ...] | None = None,
    device: torch.device | str = "cuda",
) -> np.ndarray:
    """Axis-angle poses (N, 3) float32 of every filename-encoded image in
    the tree, with the db tilt-sign convention applied (real uses +ct,
    render uses -ct, dataGenerators.py:57-62; the loaders train against the
    same signs). The Euler -> axis-angle map runs on `device`."""
    ct_sign = 1.0 if db_type == "real" else -1.0
    kw = {"classes": classes} if classes is not None else {}
    index = ClassBalancedIndex(str(tree_root), db_type, **kw)
    eulers = []
    for c in range(index.num_classes):
        for name in index.list_image_names[c]:
            p = parse_name(name)
            eulers.append((p.az, p.el, ct_sign * p.ct))
    euler = torch.as_tensor(np.asarray(eulers, np.float32), device=device)
    return euler_to_pose(euler).cpu().numpy()


def fit_pose_dictionary(
    tree_root: str | Path, size: int, out_path: str | Path, seed: int = 0,
    classes: tuple[str, ...] | None = None, db_type: str = "render",
    log: Callable[[str], None] = print,
    device: torch.device | str = "cuda",
) -> None:
    """learnKmeansDictionary.py:25-47: parse every filename-encoded pose in
    the tree, fit kmeans on `device`, save npz. db_type selects the
    tilt-sign convention the poses are parsed with; it must match the tree
    the training loader reads (the no-render fallback fits on the REAL train
    tree, whose targets use +ct)."""
    y = gather_tree_poses(tree_root, db_type, classes, device)
    log(f"[dictionary] {len(y)} poses; fitting kmeans K={size}")
    d = fit_kmeans(y, size, seed=seed, device=device)
    d.save(out_path)
