"""Similarity matrices and the copying statistics.

Counterpart of ``dcr_tpu/eval/similarity.py`` (the reference's
diff_retrieval.py:391-483):

- ``dotproduct``: sim = query @ valuesᵀ on L2-normalised features;
- ``splitloss``: features split into C chunks, per-chunk dot products,
  reduced by max, mean, or over every chunk pair ("cross");
- gen↔train statistics: mean, std, 75/90/95th percentiles of each
  generation's top-1 train similarity, and the headline ``sim_gt_05pc``,
  the share of generations whose top-1 similarity exceeds 0.5;
- the train↔train background: each training image's top-1 similarity to
  the rest of the training set (self masked by global row index).

The products run in row blocks of ``block_size`` query rows and come back
as numpy; percentiles and argmax stay numpy on the host, as in the JAX
package. On a mesh (``mesh=``, one process per device) each block's query
rows split over every rank, as the JAX ``_row_sharded`` spreads them over
every mesh device (``dcr_tpu/eval/similarity.py:38-60``): the block is
padded with zero rows to a multiple of the rank count, each rank computes
its slab against the whole (replicated) values, and the slabs are gathered
in rank order, so every rank holds the whole matrix.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.parallel import mesh as pmesh


def l2_normalize(x: np.ndarray, axis: int = -1, eps: float = 1e-12) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=axis, keepdims=True), eps)


def _block_fn(metric: str, num_chunks: int, chunk_style: str, d: int):
    if metric == "dotproduct":
        return lambda q, v: q @ v.T
    if metric != "splitloss":
        raise ValueError(f"unknown similarity metric {metric!r}")
    if d % num_chunks:
        raise ValueError(f"feature dim {d} not divisible by {num_chunks} chunks")
    if chunk_style not in ("max", "mean", "cross"):
        raise ValueError(f"unknown chunk_style {chunk_style!r} (max | mean | cross)")
    p = d // num_chunks

    def f(q, v):
        qc = q.reshape(q.shape[0], num_chunks, p)
        vc = v.reshape(v.shape[0], num_chunks, p)
        if chunk_style == "cross":
            # every chunk pair, max over both (reference 'cross' style)
            return torch.einsum("mcp,ndp->mncd", qc, vc).amax(dim=(-2, -1))
        chunk_dp = torch.einsum("mcp,ncp->mnc", qc, vc)
        return chunk_dp.amax(dim=-1) if chunk_style == "max" else chunk_dp.mean(dim=-1)
    return f


def _row_split(block: np.ndarray, mesh: Optional[pmesh.Mesh]) -> tuple[np.ndarray, int]:
    """This rank's slab of a block of query rows zero-padded to a multiple
    of the mesh's ranks, and where the slab starts in the block."""
    if mesh is None or mesh.world == 1:
        return block, 0
    padded = pmesh.pad_rows(block, mesh.world)
    sl = pmesh.rank_slab(padded.shape[0], mesh.world, mesh.rank)
    return padded[sl], sl.start


def similarity_matrix(values: np.ndarray, query: np.ndarray, *,
                      metric: str = "dotproduct", num_chunks: int = 1,
                      chunk_style: str = "max", block_size: int = 8192,
                      device: str | torch.device = "cuda",
                      mesh: Optional[pmesh.Mesh] = None) -> np.ndarray:
    """sim [N_query, N_train] (the simscores orientation the reference
    analyses), computed on ``device`` in blocks of ``block_size`` query rows,
    each block's rows split over the mesh's ranks (module docstring)."""
    device = resolve_device(device)
    f = _block_fn(metric, num_chunks, chunk_style, values.shape[1])
    v = torch.as_tensor(np.asarray(values, np.float32), device=device)
    q_all = np.asarray(query, np.float32)
    blocks = []
    with torch.inference_mode():
        for start in range(0, q_all.shape[0], block_size):
            block = q_all[start:start + block_size]
            mine, _ = _row_split(block, mesh)
            q = torch.as_tensor(mine, device=device)
            blocks.append(pmesh.gather_world_rows(f(q, v), mesh)[:block.shape[0]])
    return np.concatenate(blocks, axis=0)


@dataclass
class SimilarityStats:
    sim_mean: float
    sim_std: float
    sim_75pc: float
    sim_90pc: float
    sim_95pc: float
    sim_gt_05pc: float
    top1: np.ndarray        # [N_query] top-1 train similarity
    top1_index: np.ndarray  # [N_query] argmax train index

    def scalars(self, prefix: str = "sim") -> dict:
        return {
            f"{prefix}_mean": self.sim_mean, f"{prefix}_std": self.sim_std,
            f"{prefix}_75pc": self.sim_75pc, f"{prefix}_90pc": self.sim_90pc,
            f"{prefix}_95pc": self.sim_95pc,
            **({"sim_gt_05pc": self.sim_gt_05pc} if prefix == "sim" else {}),
        }


def gen_train_stats(sim: np.ndarray, threshold: float = 0.5) -> SimilarityStats:
    """sim: [N_query, N_train]."""
    top1_index = np.argmax(sim, axis=1)
    top1 = sim[np.arange(sim.shape[0]), top1_index]
    return SimilarityStats(
        sim_mean=float(np.mean(top1)), sim_std=float(np.std(top1)),
        sim_75pc=float(np.percentile(top1, 75)),
        sim_90pc=float(np.percentile(top1, 90)),
        sim_95pc=float(np.percentile(top1, 95)),
        sim_gt_05pc=float(np.mean(top1 > threshold)),
        top1=top1, top1_index=top1_index,
    )


def train_train_background(values: np.ndarray, *, block_size: int = 8192,
                           device: str | torch.device = "cuda",
                           mesh: Optional[pmesh.Mesh] = None) -> np.ndarray:
    """[N_train] top-1 similarity of each training image to the rest of the
    training set (the reference's top-2-minus-self): each block's own rows
    are masked by their global index, each block's rows split over the
    mesh's ranks (a pad row masks nothing and is dropped)."""
    device = resolve_device(device)
    values = np.asarray(values, np.float32)
    v = torch.as_tensor(values, device=device)
    out = []
    with torch.inference_mode():
        for start in range(0, v.shape[0], block_size):
            block = values[start:start + block_size]
            mine, first = _row_split(block, mesh)
            q = torch.as_tensor(mine, device=device)
            sim = q @ v.T
            own = torch.arange(q.shape[0], device=device)
            real = own + first < block.shape[0]
            sim[own[real], own[real] + first + start] = -torch.inf
            out.append(pmesh.gather_world_rows(sim.amax(dim=1), mesh)[:block.shape[0]])
    return np.concatenate(out)


def background_stats(bg_top1: np.ndarray) -> dict:
    return {
        "bg_mean": float(np.mean(bg_top1)), "bg_std": float(np.std(bg_top1)),
        "bg_75pc": float(np.percentile(bg_top1, 75)),
        "bg_90pc": float(np.percentile(bg_top1, 90)),
        "bg_95pc": float(np.percentile(bg_top1, 95)),
    }


def topk_matches(sim: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """(values [N, k], indices [N, k]) of the k best train matches per query."""
    idx = np.argsort(-sim, axis=1)[:, :k]
    vals = np.take_along_axis(sim, idx, axis=1)
    return vals, idx


def dup_vs_nondup_means(top1: np.ndarray, top1_index: np.ndarray,
                        weights: np.ndarray) -> dict:
    """Mean top-1 similarity split by whether the matched training image was
    duplicated (the data of the reference's dup-weights barplot)."""
    matched_w = np.asarray(weights)[top1_index]
    dup = matched_w > 1
    return {
        "dupsim_mean": float(np.mean(top1[dup])) if dup.any() else float("nan"),
        "nondupsim_mean": float(np.mean(top1[~dup])) if (~dup).any() else float("nan"),
        "dup_match_fraction": float(np.mean(dup)),
    }
