"""Gaussian-mixture pose-dictionary learning, full-covariance EM (port of
the JAX package's dictionary/gmm.py).

The replacement for the reference's sklearn GaussianMixture(K,
covariance_type='full', n_init=10) (learnGMMDictionary.py:41-47). EM runs on
the fit's device, the card unless the caller asks for "cpu";
responsibilities come from a stable log-sum-exp. Saved as `.npz` arrays
(`means`, `covariances`, `weights`, `log_likelihood`), the same file the JAX
package writes and reads.

The JAX functions broadcast (K, N, D) differences under vmap. Here the
E-step walks blocks of rows and the covariance update blocks of components,
so that a fit of 200 components over millions of poses holds no tensor of
that size; the results are the same sums.
"""

from __future__ import annotations

import dataclasses
import math
from pathlib import Path

import numpy as np
import torch

from multi_modal_regression_tpu_torch.dictionary.kmeans import (
    _as_float32,
    _kmeans_pp_init,
)

# elements of the largest (rows, K, D) or (components, N, D) temporary: 128 MB in float32
_BLOCK_ELEMS = 1 << 25


@dataclasses.dataclass
class GMMDictionary:
    """A fitted GMM pose dictionary."""

    means: np.ndarray  # (K, D)
    covariances: np.ndarray  # (K, D, D)
    weights: np.ndarray  # (K,)
    log_likelihood: float = 0.0

    @property
    def n_components(self) -> int:
        return int(self.means.shape[0])

    def predict_proba(self, y, device: torch.device | str = "cuda") -> np.ndarray:
        """Posterior responsibilities (N, K), the reference's soft bins,
        computed on `device`."""
        resp, _ = _log_resp(
            _as_float32(y, device), _as_float32(self.means, device),
            _as_float32(self.covariances, device), _as_float32(self.weights, device),
        )
        return resp.cpu().numpy()

    def predict(self, y, device: torch.device | str = "cuda") -> np.ndarray:
        return np.argmax(self.predict_proba(y, device), axis=-1)

    def save(self, path: str | Path) -> None:
        np.savez(
            path,
            means=self.means,
            covariances=self.covariances,
            weights=self.weights,
            log_likelihood=self.log_likelihood,
        )

    @classmethod
    def load(cls, path: str | Path) -> "GMMDictionary":
        with np.load(path) as f:
            return cls(
                means=f["means"],
                covariances=f["covariances"],
                weights=f["weights"],
                log_likelihood=float(f["log_likelihood"]),
            )


def _log_gauss(y: torch.Tensor, means: torch.Tensor, covs: torch.Tensor) -> torch.Tensor:
    """Per-component log N(y | mu_k, Sigma_k): (N, K). One batched Cholesky,
    then a batched triangular solve per block of rows."""
    n, d = y.shape
    k = means.shape[0]
    chol = torch.linalg.cholesky(covs)  # (K, D, D)
    logdet = 2.0 * torch.sum(torch.log(torch.diagonal(chol, dim1=-2, dim2=-1)), dim=-1)
    const = logdet + d * math.log(2.0 * math.pi)  # (K,)
    out = torch.empty((n, k), dtype=y.dtype, device=y.device)
    rows = max(1, _BLOCK_ELEMS // (k * d))
    for lo in range(0, n, rows):
        diff = y[lo : lo + rows, None, :] - means[None, :, :]  # (rows, K, D)
        sol = torch.linalg.solve_triangular(chol, diff.permute(1, 2, 0), upper=False)
        maha = torch.sum(sol * sol, dim=1)  # (K, rows)
        out[lo : lo + rows] = (-0.5 * (maha + const[:, None])).T
    return out


def _log_resp(y, means, covs, weights) -> tuple[torch.Tensor, torch.Tensor]:
    """(responsibilities (N, K), the log-likelihood sum_i log p(y_i))."""
    logp = _log_gauss(y, means, covs) + torch.log(torch.clamp(weights, min=1e-12))[None, :]
    norm = torch.logsumexp(logp, dim=-1, keepdim=True)
    return torch.exp(logp - norm), torch.sum(norm)


def _weighted_covs(y: torch.Tensor, means: torch.Tensor, resp: torch.Tensor) -> torch.Tensor:
    """(K, D, D): sum_i r_ik (y_i - mu_k)(y_i - mu_k)^T / max(sum_i r_ik, 1e-8),
    a block of components at a time."""
    n, d = y.shape
    k = means.shape[0]
    out = torch.empty((k, d, d), dtype=y.dtype, device=y.device)
    comps = max(1, _BLOCK_ELEMS // (n * d))
    for lo in range(0, k, comps):
        r = resp[:, lo : lo + comps].T  # (comps, N)
        diff = y[None, :, :] - means[lo : lo + comps, None, :]  # (comps, N, D)
        c = (diff * r[:, :, None]).transpose(1, 2) @ diff  # (comps, D, D)
        out[lo : lo + comps] = c / torch.clamp(r.sum(dim=1), min=1e-8)[:, None, None]
    return out


def _em(
    y: torch.Tensor, means0: torch.Tensor, num_iters: int, reg: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """`num_iters` EM steps from the means `means0` (K, D), covariances
    eye * var(y) (the biased variance over all elements, as jnp.var) and
    weights 1/K: (means, covariances, weights, log-likelihood). The
    log-likelihood is the last E-step's, of the parameters before the last
    update; 0 when num_iters is 0."""
    n, d = y.shape
    k = means0.shape[0]
    eye = torch.eye(d, dtype=y.dtype, device=y.device)
    means = means0
    covs = eye.expand(k, d, d) * y.var(unbiased=False)
    weights = torch.full((k,), 1.0 / k, dtype=y.dtype, device=y.device)
    ll = torch.zeros((), dtype=y.dtype, device=y.device)
    for _ in range(num_iters):
        resp, ll = _log_resp(y, means, covs, weights)  # (N, K)
        nk = resp.sum(dim=0)  # (K,)
        means = (resp.T @ y) / torch.clamp(nk, min=1e-8)[:, None]
        covs = _weighted_covs(y, means, resp) + reg * eye
        weights = nk / n
    return means, covs, weights, ll


def fit_gmm(
    y,
    n_components: int,
    *,
    num_iters: int = 100,
    n_init: int = 4,
    seed: int = 0,
    reg_covar: float = 1e-6,
    device: torch.device | str = "cuda",
) -> GMMDictionary:
    """Fit a full-covariance GMM pose dictionary on `device`; the best of
    `n_init` restarts by log-likelihood, restart r seeded `seed + r` (greedy
    kmeans++ means, see dictionary/kmeans.py on the random streams)."""
    yt = _as_float32(y, device)
    if yt.ndim != 2 or yt.shape[0] < 1:
        raise ValueError(f"expected poses (N, D) with N >= 1, got {tuple(yt.shape)}")
    best, best_ll = None, -np.inf
    for r in range(n_init):
        gen = torch.Generator(device=yt.device).manual_seed(seed + r)
        means0 = _kmeans_pp_init(yt, n_components, gen)
        means, covs, weights, ll = _em(yt, means0, num_iters, reg_covar)
        ll = float(ll)
        if ll > best_ll:
            best = tuple(t.cpu().numpy() for t in (means, covs, weights))
            best_ll = ll
    if best is None:
        raise ValueError("gmm: the log-likelihood of every restart is not finite")
    return GMMDictionary(
        means=best[0], covariances=best[1], weights=best[2], log_likelihood=best_ll
    )
