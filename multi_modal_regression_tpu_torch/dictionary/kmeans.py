"""KMeans pose dictionary (port of the JAX package's dictionary/kmeans.py).

Reads and writes the same `.npz` files as the JAX package's `cli dictionary`
(`cluster_centers`, `inertia`). Fitting and `predict` arrive with the
assignment kernel (ROADMAP.md); until then this class has no `predict`.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np


@dataclasses.dataclass
class KMeansDictionary:
    """A fitted pose dictionary: cluster centers (K, D) + fit metadata."""

    cluster_centers: np.ndarray
    inertia: float = 0.0

    @property
    def n_clusters(self) -> int:
        return int(self.cluster_centers.shape[0])

    def save(self, path: str | Path) -> None:
        np.savez(path, cluster_centers=self.cluster_centers, inertia=self.inertia)

    @classmethod
    def load(cls, path: str | Path) -> "KMeansDictionary":
        with np.load(path) as f:
            return cls(
                cluster_centers=f["cluster_centers"], inertia=float(f["inertia"])
            )
