"""Data-duplication regimes: per-sample sampling weights with on-disk caching.

Own copy of ``dcr_tpu/data/duplication.py``: under ``dup_both``/``dup_image``
a random ``weight_pc`` fraction of samples gets weight ``dup_weight`` (others
1), cached to a pickle keyed by (weight_pc, dup_weight, seed) next to the
data. The file name and pickle format are the reference's
(datasets.py:76-90), and the draws come from the same host streams, so the
two packages read and write the same file and agree bit for bit.
"""

from __future__ import annotations

import pickle
from pathlib import Path
from typing import Sequence

import numpy as np

from dcr_tpu_torch.core.rng import host_python_rng


def weights_cache_path(data_root: str | Path, weight_pc: float, dup_weight: int,
                       seed: int) -> Path:
    # same naming convention as the reference (datasets.py:77)
    return Path(data_root) / f"weights_{weight_pc}_{dup_weight}_seed{seed}.pickle"


def make_sampling_weights(num_samples: int, weight_pc: float, dup_weight: int,
                          seed: int) -> np.ndarray:
    """weight_pc fraction of samples get integer weight dup_weight, rest 1."""
    weights = np.ones(num_samples, np.int64)
    rng = host_python_rng(seed, "dup_weights")
    chosen = rng.choice(num_samples, int(weight_pc * num_samples), replace=False)
    weights[chosen] = int(dup_weight)
    return weights


def load_or_create_weights(data_root: str | Path, num_samples: int,
                           weight_pc: float, dup_weight: int,
                           seed: int) -> np.ndarray:
    path = weights_cache_path(data_root, weight_pc, dup_weight, seed)
    if path.exists():
        with open(path, "rb") as f:
            weights = np.asarray(pickle.load(f))
        if len(weights) != num_samples:
            raise ValueError(
                f"cached weights at {path} cover {len(weights)} samples, "
                f"dataset has {num_samples}; delete the stale cache or fix the data dir")
        return weights
    weights = make_sampling_weights(num_samples, weight_pc, dup_weight, seed)
    with open(path, "wb") as f:
        pickle.dump(weights.tolist(), f, protocol=pickle.HIGHEST_PROTOCOL)
    return weights


def weighted_sample_indices(weights: Sequence[float], num_draws: int,
                            seed: int, epoch: int) -> np.ndarray:
    """Weighted sampling WITH replacement (the reference's WeightedRandomSampler,
    diff_train.py:470-479), deterministic per (seed, epoch)."""
    weights = np.asarray(weights, np.float64)
    p = weights / weights.sum()
    rng = host_python_rng(seed, f"weighted_sampler_epoch{epoch}")
    return rng.choice(len(weights), size=num_draws, replace=True, p=p)


def shuffled_indices(num_samples: int, seed: int, epoch: int) -> np.ndarray:
    rng = host_python_rng(seed, f"shuffle_epoch{epoch}")
    return rng.permutation(num_samples)
