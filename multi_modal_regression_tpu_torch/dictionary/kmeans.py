"""KMeans pose-dictionary learning (port of the JAX package's
dictionary/kmeans.py): greedy kmeans++ seeding, then Lloyd's algorithm.

The replacement for the reference's host-side sklearn KMeans(K).fit over
all render poses (learnKmeansDictionary.py:41-47). Everything runs on the
fit's device, the card unless the caller asks for "cpu". There the
assignment step of every Lloyd iteration and `KMeansDictionary.predict` go
through the hand-written assign kernel (ops/assign.py), so a fit over
millions of poses never holds an (N, K) distance matrix for them.

The fitted dictionary is a plain array in an `.npz` (`cluster_centers`,
`inertia`), the same file the JAX package writes and reads.

Random numbers: an explicit `torch.Generator` on the fit's device, seeded
`seed + restart`. It cannot reproduce the JAX package's `jax.random`
streams, and a CPU and a CUDA generator give different streams from one
seed: fits agree across the three in quality, not in their bits. On one
device a fit repeats its bits from run to run: candidates are drawn by the
Gumbel-max trick (uniform draws and an argmax, not torch.multinomial), and
the cluster sums are one-hot matrix products taken in a fixed order, not
atomic adds.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from multi_modal_regression_tpu_torch.dictionary.common import pairwise_sqeuclidean
from multi_modal_regression_tpu_torch.ops.assign import assign_bins

# rows per one-hot block of the cluster sums: (2**16, K) float32 is 52 MB at K = 200
_SUM_ROWS = 1 << 16


def _as_float32(y, device) -> torch.Tensor:
    """Array-like or tensor -> float32 tensor on `device`."""
    return torch.as_tensor(y).to(device=device, dtype=torch.float32)


@dataclasses.dataclass
class KMeansDictionary:
    """A fitted pose dictionary: cluster centers (K, D) + fit metadata."""

    cluster_centers: np.ndarray
    inertia: float = 0.0

    @property
    def n_clusters(self) -> int:
        return int(self.cluster_centers.shape[0])

    def predict(self, y, device: torch.device | str = "cuda") -> np.ndarray:
        """Hard bin assignment (N,) int32: the nearest center of each row,
        computed on `device` (on the card by the assign kernel: no (N, K)
        matrix in device memory)."""
        bins = assign_bins(_as_float32(y, device), _as_float32(self.cluster_centers, device))
        return bins.cpu().numpy()

    def residuals(
        self, y, bins: np.ndarray | None = None, device: torch.device | str = "cuda"
    ) -> np.ndarray:
        if bins is None:
            bins = self.predict(y, device)
        y = y.cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        return y - self.cluster_centers[bins]

    def save(self, path: str | Path) -> None:
        np.savez(path, cluster_centers=self.cluster_centers, inertia=self.inertia)

    @classmethod
    def load(cls, path: str | Path) -> "KMeansDictionary":
        with np.load(path) as f:
            return cls(
                cluster_centers=f["cluster_centers"], inertia=float(f["inertia"])
            )


def kmeans_assign(y: torch.Tensor, centers: torch.Tensor) -> torch.Tensor:
    """Hard assignment of rows of y (N, D) to the nearest of centers (K, D):
    the argmin of the clamped distance expansion, as the JAX function of
    this name (an (N, K) matrix; `ops.assign.assign_bins` is the streaming
    form)."""
    return torch.argmin(pairwise_sqeuclidean(y, centers), dim=-1)


def _greedy_pick(
    y: torch.Tensor, dmin: torch.Tensor, cand_idx: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Among the candidate rows `cand_idx` (T,) of y, the one that leaves the
    least potential sum_i min(dmin_i, |y_i - cand|^2): (its row (D,), the
    new dmin (N,)). The first candidate wins a tie."""
    cand = y[cand_idx]  # (T, D)
    new_dmin = torch.minimum(dmin[:, None], pairwise_sqeuclidean(y, cand))  # (N, T)
    best = torch.argmin(new_dmin.sum(dim=0))
    return cand[best], new_dmin[:, best]


def _draw_candidates(
    weights: torch.Tensor, n_trials: int, generator: torch.Generator
) -> torch.Tensor:
    """`n_trials` row indices drawn with replacement with probability
    proportional to `weights` (N,), by the Gumbel-max trick (as
    jax.random.categorical draws): argmax_i(log w_i + G_i), G standard
    Gumbel noise from `generator`. Uniform draws and an argmax repeat their
    bits from one seed; torch.multinomial on the card does not (its sampling
    goes through a prefix sum whose order of additions varies from run to
    run: measured on an H100, 72 of 200 draws of 9 among 2,000,000 weights
    differed between two generators of one seed)."""
    u = torch.rand(
        (n_trials, weights.shape[0]), generator=generator, device=weights.device,
        dtype=weights.dtype,
    )
    return torch.argmax(torch.log(weights) - torch.log(-torch.log(u)), dim=1)


def _kmeans_pp_init(y: torch.Tensor, k: int, generator: torch.Generator) -> torch.Tensor:
    """Greedy kmeans++ seeding: for each new center draw 2 + log2(k)
    candidates with probability proportional to max(dmin, 1e-12), dmin the
    squared distance to the chosen set, and keep the one that minimizes the
    resulting potential (the sklearn-quality variant). Every center is a row
    of y. `generator` lives on y's device."""
    n = y.shape[0]
    n_trials = 2 + int(math.log2(max(k, 2)))
    first = y[torch.randint(n, (1,), generator=generator, device=y.device)[0]]
    centers = torch.zeros((k, y.shape[1]), dtype=y.dtype, device=y.device)
    centers[0] = first
    dmin = torch.sum((y - first) ** 2, dim=-1)
    for i in range(1, k):
        cand_idx = _draw_candidates(torch.clamp(dmin, min=1e-12), n_trials, generator)
        centers[i], dmin = _greedy_pick(y, dmin, cand_idx)
    return centers


def _cluster_sums(y: torch.Tensor, assign: torch.Tensor, k: int) -> torch.Tensor:
    """(K, D) sums of the rows of y by cluster: one-hot products over blocks
    of rows, added in block order, so the same inputs give the same bits
    (an index_add_ on the card adds with atomics in no fixed order)."""
    sums = torch.zeros((k, y.shape[1]), dtype=y.dtype, device=y.device)
    ids = torch.arange(k, device=y.device, dtype=assign.dtype)
    for lo in range(0, y.shape[0], _SUM_ROWS):
        onehot = (assign[lo : lo + _SUM_ROWS, None] == ids).to(y.dtype)  # (rows, K)
        sums += onehot.T @ y[lo : lo + _SUM_ROWS]
    return sums


def _lloyd(
    y: torch.Tensor, centers0: torch.Tensor, num_iters: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """`num_iters` fixed Lloyd steps from `centers0` (K, D): (centers,
    inertia). An empty cluster keeps its old center. The inertia is
    sum_i |y_i - c[assign_i]|^2 for the final centers, accumulated in
    float64 (the JAX function takes the minimum of the clamped distance
    expansion; the two agree to float32 rounding)."""
    centers = centers0
    k = centers.shape[0]
    for _ in range(num_iters):
        assign = assign_bins(y, centers)
        counts = torch.bincount(assign, minlength=k).to(y.dtype)
        new = _cluster_sums(y, assign, k) / torch.clamp(counts, min=1.0)[:, None]
        centers = torch.where((counts > 0)[:, None], new, centers)
    nearest = centers[assign_bins(y, centers).long()]
    inertia = torch.sum((y - nearest).double() ** 2)
    return centers, inertia


def fit_kmeans(
    y,
    n_clusters: int,
    *,
    num_iters: int = 100,
    n_init: int = 4,
    seed: int = 0,
    device: torch.device | str = "cuda",
) -> KMeansDictionary:
    """Fit a K-atom pose dictionary on `device`; the best of `n_init`
    restarts, restart r seeded `seed + r`. On the card each restart launches
    the assign kernel num_iters + 1 times."""
    yt = _as_float32(y, device)
    if yt.ndim != 2 or yt.shape[0] < 1:
        raise ValueError(f"expected poses (N, D) with N >= 1, got {tuple(yt.shape)}")
    best_c, best_i = None, np.inf
    for r in range(n_init):
        gen = torch.Generator(device=yt.device).manual_seed(seed + r)
        centers, inertia = _lloyd(yt, _kmeans_pp_init(yt, n_clusters, gen), num_iters)
        inertia = float(inertia)
        if inertia < best_i:
            best_c, best_i = centers.cpu().numpy(), inertia
    if best_c is None:
        raise ValueError("kmeans: the inertia of every restart is not finite")
    return KMeansDictionary(cluster_centers=best_c, inertia=best_i)
