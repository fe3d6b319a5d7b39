"""Pose-dictionary learning: kmeans (Lloyd's) and GMM (EM) over pose targets.

Replaces the reference's host-side sklearn KMeans/GaussianMixture pickles
(learnKmeansDictionary.py, learnGMMDictionary.py) with PyTorch
implementations that run on the card and are saved as plain npz arrays, the
files the JAX package's dictionary classes read and write too.
"""

from multi_modal_regression_tpu_torch.dictionary.common import get_gamma
from multi_modal_regression_tpu_torch.dictionary.gmm import GMMDictionary, fit_gmm
from multi_modal_regression_tpu_torch.dictionary.kmeans import (
    KMeansDictionary,
    fit_kmeans,
    kmeans_assign,
)

__all__ = [
    "KMeansDictionary",
    "fit_kmeans",
    "kmeans_assign",
    "GMMDictionary",
    "fit_gmm",
    "get_gamma",
]
