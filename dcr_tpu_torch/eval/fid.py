"""Fréchet Inception Distance: activation statistics, the Fréchet distance
and the statistics cache.

Own copy of ``dcr_tpu/eval/fid.py`` (numpy, on the host, in float64):
FID = |mu1 - mu2|² + tr(S1 + S2 - 2 sqrtm(S1 S2)), with the trace term from
the PSD identity tr sqrtm(S1 S2) = sum sqrt eig(sqrtm(S1) S2 sqrtm(S1)) by
two symmetric eigendecompositions, the eps*I fallback for near-singular
covariances, and the .npz statistics cache.
"""

from __future__ import annotations

import logging
from pathlib import Path
from typing import Optional

import numpy as np

log = logging.getLogger("dcr_tpu_torch")


def activation_statistics(features: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(mu [D], sigma [D, D]) in float64."""
    feats = np.asarray(features, np.float64)
    return feats.mean(axis=0), np.cov(feats, rowvar=False)


def _sym_sqrtm(mat: np.ndarray, eps: float = 1e-12) -> np.ndarray:
    vals, vecs = np.linalg.eigh(mat)
    vals = np.clip(vals, 0.0, None)
    return (vecs * np.sqrt(vals + eps)) @ vecs.T


def frechet_distance(mu1: np.ndarray, sigma1: np.ndarray, mu2: np.ndarray,
                     sigma2: np.ndarray, eps: float = 1e-6) -> float:
    mu1, mu2 = np.atleast_1d(mu1), np.atleast_1d(mu2)
    sigma1, sigma2 = np.atleast_2d(sigma1), np.atleast_2d(sigma2)
    diff = mu1 - mu2
    s1 = _sym_sqrtm(sigma1)
    vals = np.linalg.eigvalsh(s1 @ sigma2 @ s1)
    if not np.isfinite(vals).all() or vals.min() < -1e-3 * max(1.0, abs(vals.max())):
        log.warning("FID: ill-conditioned covariances; adding eps=%g to diagonals", eps)
        off = eps * np.eye(sigma1.shape[0])
        s1 = _sym_sqrtm(sigma1 + off)
        vals = np.linalg.eigvalsh(s1 @ (sigma2 + off) @ s1)
    tr_covmean = np.sum(np.sqrt(np.clip(vals, 0.0, None)))
    return float(diff @ diff + np.trace(sigma1) + np.trace(sigma2) - 2.0 * tr_covmean)


def save_stats(path: str | Path, mu: np.ndarray, sigma: np.ndarray) -> None:
    np.savez(path, mu=mu, sigma=sigma)


def load_stats(path: str | Path) -> tuple[np.ndarray, np.ndarray]:
    with np.load(path) as z:
        return z["mu"], z["sigma"]


def fid_from_features(feats1: np.ndarray, feats2: np.ndarray, *,
                      cache1: Optional[str | Path] = None,
                      cache2: Optional[str | Path] = None) -> float:
    """FID between two activation sets; a cache path that exists is read
    instead of the features, one that does not is written."""

    def stats(feats, cache):
        if cache is not None and Path(cache).exists():
            return load_stats(cache)
        mu, sigma = activation_statistics(feats)
        if cache is not None:
            save_stats(cache, mu, sigma)
        return mu, sigma

    mu1, s1 = stats(feats1, cache1)
    mu2, s2 = stats(feats2, cache2)
    return frechet_distance(mu1, s1, mu2, s2)
