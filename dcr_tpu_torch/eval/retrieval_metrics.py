"""Ranked-retrieval quality metrics: mAP, precision@k, recall@k, MRR.

Counterpart of ``dcr_tpu/eval/retrieval_metrics.py`` (the reference's
retrieval scoring toolkit, utils_ret.py:300-417), in numpy as there. The
reference's ``micro_average_precision`` is dead code that crashes on call
(utils_ret.py:890-902) and is not reproduced.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def average_precision(ranked_relevant: Sequence[bool], num_relevant_total: int) -> float:
    """AP of one query from the relevance of its ranked results."""
    if num_relevant_total == 0:
        return float("nan")
    rel = np.asarray(ranked_relevant, bool)
    if not rel.any():
        return 0.0
    precision_at = np.cumsum(rel) / (np.arange(len(rel)) + 1)
    return float(np.sum(precision_at * rel) / num_relevant_total)


def _ranked_relevance(sim: np.ndarray, relevance: np.ndarray) -> np.ndarray:
    return np.take_along_axis(relevance, np.argsort(-sim, axis=1), axis=1)


def mean_average_precision(sim: np.ndarray, relevance: np.ndarray) -> float:
    """sim: [Q, N] scores; relevance: [Q, N] bool ground truth."""
    ranked = _ranked_relevance(sim, relevance)
    return float(np.nanmean([average_precision(ranked[q], int(relevance[q].sum()))
                             for q in range(sim.shape[0])]))


def precision_at_k(sim: np.ndarray, relevance: np.ndarray, k: int) -> float:
    rel = _ranked_relevance(sim, relevance)[:, :k]
    return float(np.mean(rel.sum(axis=1) / k))


def recall_at_k(sim: np.ndarray, relevance: np.ndarray, k: int) -> float:
    rel = _ranked_relevance(sim, relevance)[:, :k]
    total = relevance.sum(axis=1)
    valid = total > 0
    if not valid.any():
        return float("nan")
    return float(np.mean(rel.sum(axis=1)[valid] / total[valid]))


def mean_reciprocal_rank(sim: np.ndarray, relevance: np.ndarray) -> float:
    ranked = _ranked_relevance(sim, relevance)
    rr = []
    for q in range(sim.shape[0]):
        hits = np.flatnonzero(ranked[q])
        rr.append(1.0 / (hits[0] + 1) if len(hits) else 0.0)
    return float(np.mean(rr))


def compute_map_revisited(ranks: np.ndarray, gnd: Sequence[dict],
                          kappas: Sequence[int] = ()) -> tuple:
    """Revisited-Oxford mAP with junk filtering, the reference toolkit's
    semantics (utils_ret.py:322-417): trapezoidal AP, P@k with the
    k := min(max(rank), k) clamp, recall@k over true matches, and MRR taken
    before the junk adjustment and averaged over all queries.

    ranks: [db_size, n_queries] of 0-based db ids, best first. gnd: per
    query {"ok": ids, "junk": ids}; queries with no positives are left out
    of mAP, P@k and recall but still dilute MRR. Returns
    (mAP, P@kappas, recall@kappas, MRR)."""
    kappas = list(kappas)
    n_q = len(gnd)
    ap_sum, n_empty, mrr = 0.0, 0, 0.0
    pr_sum = np.zeros(len(kappas))
    recalls = []
    for q in range(n_q):
        ok = np.asarray(gnd[q].get("ok", ()), dtype=np.int64)
        if ok.size == 0:
            n_empty += 1
            continue
        junk = np.asarray(gnd[q].get("junk", ()), dtype=np.int64)
        ranked = ranks[:, q]
        pos = np.flatnonzero(np.isin(ranked, ok))
        junk_pos = np.flatnonzero(np.isin(ranked, junk))
        mrr += 1.0 / (pos.min() + 1)
        if junk_pos.size:       # each positive moves up past the junk above it
            pos = pos - np.searchsorted(junk_pos, pos)
        j = np.arange(pos.size, dtype=np.float64)
        prec_before = np.where(pos == 0, 1.0, j / np.maximum(pos, 1))
        prec_at = (j + 1) / (pos + 1)
        ap_sum += float(np.sum(prec_before + prec_at)) / (2.0 * ok.size)
        pos1 = pos + 1
        row = []
        for i, k in enumerate(kappas):
            kq = min(pos1.max(), k)
            pr_sum[i] += float(np.sum(pos1 <= kq)) / kq
            row.append(float(np.sum(pos1 <= k)) / ok.size)
        recalls.append(row)
    n_eval = max(n_q - n_empty, 1)
    recs = (np.mean(np.asarray(recalls), axis=0) if recalls
            else np.full(len(kappas), np.nan))
    return ap_sum / n_eval, pr_sum / n_eval, recs, mrr / n_q


def retrieval_report(sim: np.ndarray, relevance: np.ndarray,
                     ks: Sequence[int] = (1, 5, 10)) -> dict:
    out = {"mAP": mean_average_precision(sim, relevance),
           "MRR": mean_reciprocal_rank(sim, relevance)}
    for k in ks:
        out[f"precision@{k}"] = precision_at_k(sim, relevance, k)
        out[f"recall@{k}"] = recall_at_k(sim, relevance, k)
    return out
