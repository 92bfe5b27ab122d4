"""The online recall probe: the port's ``obs/recall_probe.RecallProbe``
against ``search/annindex.spot_check_recall`` and the JAX package's
``dcr_tpu.obs.recall_probe.RecallProbe``, on the CPU over a clustered store
at DIM 16 (the cases of ``tests/test_slo.py``'s probe section).

- on the served shortlist the probe's recall is within 0.05 of the offline
  spot check, and equal to the JAX probe's on the same tier and queries;
  the gauges and the counter publish;
- every ``every_n``-th call probes; ``recall_degrade`` pins a probe to 0
  without changing what the engine answers;
- the live tail merges into the probe's oracle as into the served answer.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dcr_tpu.obs import recall_probe as JRP  # noqa: E402
from dcr_tpu.search import annindex as JAI  # noqa: E402
from dcr_tpu.search import shardindex as JSI  # noqa: E402
from dcr_tpu.utils import faults as jfaults  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.obs.recall_probe import RecallProbe  # noqa: E402
from dcr_tpu_torch.search import ann  # noqa: E402
from dcr_tpu_torch.search import annindex as AI  # noqa: E402
from dcr_tpu_torch.search import store as ST  # noqa: E402
from dcr_tpu_torch.search.shardindex import merge_topk, open_engine  # noqa: E402
from dcr_tpu_torch.utils import faults  # noqa: E402
from tests.test_torch_search import assert_topk_agree  # noqa: E402

DIM = 16


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small matmuls run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DCR_FAULTS", raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


@pytest.fixture(scope="module")
def tier(tmp_path_factory):
    """A clustered store of 256 rows with an 8-list tier (the port's), the
    port's and the JAX package's engines at nprobe 2 and exact engines, and
    12 queries from the clusters (``tests/test_slo.py``'s ``_ann_setup``)."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, DIM)).astype(np.float32) * 4.0
    feats = (centers[rng.integers(0, 8, 256)]
             + rng.standard_normal((256, DIM)).astype(np.float32) * 0.1)
    store = tmp_path_factory.mktemp("probe") / "store"
    w = ST.EmbeddingStoreWriter.create(store, shard_rows=64)
    w.add(feats, [f"r{i}" for i in range(256)])
    w.finalize()
    ann.train_ivf(store, n_lists=8, iters=5, seed=0, device="cpu")
    q = (centers[rng.integers(0, 8, 12)]
         + rng.standard_normal((12, DIM)).astype(np.float32) * 0.1)
    return {"store": store, "feats": feats, "keys": [f"r{i}" for i in range(256)], "q": q,
            "eng": AI.open_ann_engine(store, top_k=10, nprobe=2, query_batch=16, device="cpu"),
            "exact": open_engine(store, top_k=10, query_batch=16, device="cpu"),
            "jeng": JAI.open_ann_engine(store, top_k=10, nprobe=2, query_batch=16),
            "jexact": JSI.open_engine(store, top_k=10, query_batch=16)}


def _gauge(name: str) -> float:
    return tracing.registry().snapshot()["gauges"][name]


def test_online_recall_matches_the_spot_check_and_the_jax_probe(tier):
    tracing.registry().reset("ann/recall")
    eng, q = tier["eng"], tier["q"]
    served = eng.query(q)
    probe = RecallProbe(every_n=1, k=10, window=8)
    online = probe.observe(eng, q, served[1])
    offline = AI.spot_check_recall(eng, tier["exact"], q, k=10)
    assert online is not None and abs(online - offline) <= 0.05
    assert _gauge("ann/recall_online_pct") == int(round(online * 100))
    assert _gauge("ann/recall_online_samples") == 1
    assert tracing.registry().counters("ann/")["ann/recall_probe_total"] == 1
    stats = probe.stats()
    assert stats["probes"] == 1 and stats["rolling_recall"] == round(online, 4)
    # the JAX probe on its own engine over the same tier
    jserved = tier["jeng"].query(q)
    assert_topk_agree(*served, *jserved, q, tier["feats"], tier["keys"])
    theirs = JRP.RecallProbe(every_n=1, k=10, window=8).observe(tier["jeng"], q, jserved[1])
    assert abs(online - theirs) <= 0.05
    assert abs(theirs - JAI.spot_check_recall(tier["jeng"], tier["jexact"], q, k=10)) <= 0.05


def test_every_nth_call_probes_and_recall_degrade_pins_zero(tier):
    eng, q = tier["eng"], tier["q"]
    scores, keys = eng.query(q)
    probe = RecallProbe(every_n=4, k=10, window=8)
    results = [probe.observe(eng, q, keys) for _ in range(8)]
    assert [r is not None for r in results] == [True, False, False, False] * 2
    assert probe.stats()["probes"] == 2
    rolling = probe.stats()["rolling_recall"]
    faults.install("recall_degrade@probe=3")
    assert probe.observe(eng, q, keys) == 0.0            # call 9 is probe 3
    assert probe.stats()["rolling_recall"] < rolling
    again = eng.query(q)                                 # what is served is unchanged
    np.testing.assert_array_equal(again[0], scores)
    np.testing.assert_array_equal(again[1], keys)
    for bad in ({"every_n": 0}, {"k": 0}, {"window": 0}):
        with pytest.raises(ValueError):
            RecallProbe(**bad)


def test_the_live_tail_merges_into_the_oracle(tier):
    """Tail rows, in no list, are scanned exactly on both sides: a served
    answer with the tail merged probes at full recall at nprobe = n_lists,
    and the oracle's keys are the JAX probe's."""
    eng, q = tier["eng"], tier["q"]
    rng = np.random.default_rng(1)
    # the dot product favours large norms: a scaled copy is its query's top-1
    tail = (3.0 * q[:4] + 0.01 * rng.standard_normal((4, DIM))).astype(np.float32)
    tail_keys = [f"tail{i}" for i in range(4)]
    full = eng.query(q, nprobe=eng.ann.n_lists)
    served = merge_topk(*full, *eng.query_rows(q, tail, tail_keys))
    assert {f"tail{i}" for i in range(4)} <= set(served[1][:, 0])
    probe = RecallProbe(every_n=1, k=10)
    assert probe.observe(eng, q, served[1], tail_feats=tail, tail_keys=tail_keys) == 1.0
    np.testing.assert_array_equal(probe._oracle(eng, q, tail, tail_keys), served[1])
    jeng = tier["jeng"]
    theirs = merge_topk(*jeng.query(q, nprobe=jeng.ann.n_lists),
                        *jeng.query_rows(q, tail, tail_keys))
    np.testing.assert_array_equal(JRP.RecallProbe._oracle(jeng, q, tail, tail_keys), theirs[1])
    assert_topk_agree(*served, *theirs, q, np.concatenate([tier["feats"], tail]),
                      tier["keys"] + tail_keys)
