"""The port's retrieval metrics (``dcr_tpu_torch/eval/retrieval_metrics``)
against the JAX package's module and against the executed reference's
numbers in ``tests/goldens/retrieval_metrics_reference.npz``. Both are
numpy: results must be equal to 1e-12."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from dcr_tpu.eval import retrieval_metrics as JRM
from dcr_tpu_torch.eval import retrieval_metrics as RM

GOLD = Path(__file__).parent / "goldens" / "retrieval_metrics_reference.npz"


def _problem(seed: int, q: int = 7, n: int = 30):
    rng = np.random.default_rng(seed)
    sim = rng.normal(size=(q, n))
    relevance = rng.uniform(size=(q, n)) < 0.15
    relevance[0] = False                               # a query with no positives
    return sim, relevance


@pytest.mark.parametrize("seed", range(4))
def test_ranked_metrics_match_jax(seed):
    sim, rel = _problem(seed)
    assert np.isnan(RM.average_precision([True], 0)) and np.isnan(JRM.average_precision([True], 0))
    for q in range(1, sim.shape[0]):
        ranked = rel[q][np.argsort(-sim[q])]
        assert RM.average_precision(ranked, int(rel[q].sum())) == pytest.approx(
            JRM.average_precision(ranked, int(rel[q].sum())), abs=1e-12)
    assert RM.mean_average_precision(sim, rel) == pytest.approx(
        JRM.mean_average_precision(sim, rel), abs=1e-12)
    assert RM.mean_reciprocal_rank(sim, rel) == pytest.approx(
        JRM.mean_reciprocal_rank(sim, rel), abs=1e-12)
    for k in (1, 3, 10):
        assert RM.precision_at_k(sim, rel, k) == pytest.approx(JRM.precision_at_k(sim, rel, k),
                                                                abs=1e-12)
        assert RM.recall_at_k(sim, rel, k) == pytest.approx(JRM.recall_at_k(sim, rel, k),
                                                             abs=1e-12)
    ours, ref = RM.retrieval_report(sim, rel), JRM.retrieval_report(sim, rel)
    assert list(ours) == list(ref)
    for name in ref:
        assert ours[name] == pytest.approx(ref[name], abs=1e-12), name


def test_recall_without_positives_is_nan_in_both():
    sim, rel = _problem(0)
    rel[:] = False
    assert np.isnan(RM.recall_at_k(sim, rel, 5)) and np.isnan(JRM.recall_at_k(sim, rel, 5))


def _gnd(data):
    gnd = []
    for q in range(data["ok"].shape[0]):
        gnd.append({"ok": [int(i) for i in data["ok"][q] if i >= 0],
                    "junk": [int(i) for i in data["junk"][q] if i >= 0]})
    return gnd


def test_map_revisited_matches_the_executed_reference():
    data = np.load(GOLD)
    m, pr, recs, mrr = RM.compute_map_revisited(data["ranks"], _gnd(data),
                                                [int(k) for k in data["kappas"]])
    assert m == pytest.approx(float(data["map"]), abs=1e-12)
    assert mrr == pytest.approx(float(data["mrr"]), abs=1e-12)
    np.testing.assert_allclose(pr, data["pr"], atol=1e-12)
    np.testing.assert_allclose(recs, data["recs"], atol=1e-12)


@pytest.mark.parametrize("seed", range(3))
def test_map_revisited_matches_jax(seed):
    rng = np.random.default_rng(seed)
    db, nq = 25, 5
    ranks = np.stack([rng.permutation(db) for _ in range(nq)], axis=1)
    gnd = [{"ok": rng.choice(db, 3, replace=False).tolist(),
            "junk": rng.choice(db, 2, replace=False).tolist()} for _ in range(nq - 1)]
    gnd.append({"ok": [], "junk": [1]})                 # excluded from mAP, dilutes MRR
    ours = RM.compute_map_revisited(ranks, gnd, [1, 5, 10])
    ref = JRM.compute_map_revisited(ranks, gnd, [1, 5, 10])
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a, b, atol=1e-12)
    empty = RM.compute_map_revisited(ranks, [{"ok": []}], [1])
    assert np.isnan(empty[2]).all()
