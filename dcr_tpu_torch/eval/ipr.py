"""Improved Precision and Recall (k-NN manifold estimation).

Counterpart of ``dcr_tpu/eval/ipr.py``: precision is the share of generated
samples inside the real features' manifold (the union of k-NN balls),
recall the share of real samples inside the generated manifold; plus the
per-sample realism score and the radii cache. Squared pairwise distances
run on the device in row blocks; the k-NN radii and the ball tests are numpy
on the host, as in the JAX package.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from dcr_tpu_torch.core.device import resolve_device


def pairwise_distances_squared(a: np.ndarray, b: np.ndarray, block_size: int = 4096,
                               device: str | torch.device = "cuda") -> np.ndarray:
    """[N, M] squared euclidean distances, |a|² + |b|² - 2 a·b clamped at 0,
    computed on ``device`` in blocks of ``block_size`` rows of ``a``."""
    device = resolve_device(device)
    bt = torch.as_tensor(np.asarray(b, np.float32), device=device)
    a = np.asarray(a, np.float32)
    out = []
    with torch.inference_mode():
        b_sq = (bt ** 2).sum(dim=1)
        for start in range(0, a.shape[0], block_size):
            q = torch.as_tensor(a[start:start + block_size], device=device)
            d = (q ** 2).sum(dim=1)[:, None] + b_sq[None, :] - 2.0 * (q @ bt.T)
            out.append(d.clamp(min=0.0).cpu().numpy())
    return np.concatenate(out, axis=0)


def knn_radii(features: np.ndarray, k: int = 3,
              device: str | torch.device = "cuda") -> np.ndarray:
    """Distance to the k-th nearest other sample, per sample."""
    d = pairwise_distances_squared(features, features, device=device)
    np.fill_diagonal(d, np.inf)
    return np.sqrt(np.partition(d, k - 1, axis=1)[:, k - 1])


@dataclass
class Manifold:
    features: np.ndarray
    radii: np.ndarray
    device: str | torch.device = "cuda"

    @staticmethod
    def build(features: np.ndarray, k: int = 3, cache: Optional[str | Path] = None,
              device: str | torch.device = "cuda") -> "Manifold":
        if cache is not None and Path(cache).exists():
            with np.load(cache) as z:
                return Manifold(z["features"], z["radii"], device)
        m = Manifold(np.asarray(features), knn_radii(features, k, device), device)
        if cache is not None:
            np.savez(cache, features=m.features, radii=m.radii)
        return m

    def contains(self, queries: np.ndarray) -> np.ndarray:
        """[N] bool: query inside any feature's k-NN ball."""
        d = np.sqrt(pairwise_distances_squared(queries, self.features, device=self.device))
        return np.any(d <= self.radii[None, :], axis=1)

    def realism(self, queries: np.ndarray) -> np.ndarray:
        """max over balls of radius / distance per query (higher = more
        realistic), leaving out balls over 10x the median radius."""
        d = np.sqrt(pairwise_distances_squared(queries, self.features, device=self.device))
        mask = self.radii < np.median(self.radii) * 10
        ratio = self.radii[None, mask] / np.maximum(d[:, mask], 1e-12)
        return np.max(ratio, axis=1)


def precision_recall(real_features: np.ndarray, fake_features: np.ndarray, k: int = 3,
                     real_cache: Optional[str | Path] = None,
                     device: str | torch.device = "cuda") -> dict:
    real = Manifold.build(real_features, k, cache=real_cache, device=device)
    fake = Manifold.build(fake_features, k, device=device)
    return {
        "precision": float(np.mean(real.contains(fake_features))),
        "recall": float(np.mean(fake.contains(real_features))),
    }
