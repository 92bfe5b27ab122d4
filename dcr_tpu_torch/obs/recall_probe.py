"""A sampled shadow-exact recall probe for the online ANN path.

Counterpart of ``dcr_tpu/obs/recall_probe.py``. A recall measured once
offline (``search/annindex.spot_check_recall``) says nothing about the
corpus the service holds later. This probe measures it on the served
queries: every ``every_n``-th ANN scoring call re-runs the same queries
through the same :class:`~dcr_tpu_torch.search.annindex.AnnEngine` with
every list probed (``nprobe = n_lists``). Then the candidate set is the
whole committed corpus and the engine's f32 re-rank is exact, so the
full-probe answer is the exact top-k with no second engine and no second
copy of the store. The live WAL tail, already scanned exactly by
``query_rows``, merges into both sides alike, so the probe measures only
what the production shortlists miss: candidates the IVF probe pruned.

Results feed a rolling window published as the ``ann/recall_online_pct``
and ``ann/recall_online_samples`` gauges (``dcr_ann_recall_online_pct`` on
``/metrics?format=prometheus``) and the ``ann/recall_probe_total`` counter.
The ``recall_degrade`` fault kind corrupts only the shortlist the probe
judges, never the answer served.
"""

from __future__ import annotations

import logging
import threading
from collections import deque
from typing import Optional, Sequence

import numpy as np

from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.search.shardindex import merge_topk
from dcr_tpu_torch.utils import faults

log = logging.getLogger("dcr_tpu_torch")


class RecallProbe:
    """Rolling online recall@k, sampled once per ``every_n`` ANN calls.

    Thread-safe: the serve worker and the ``/check`` handler threads share
    one probe per risk index. The full-probe query runs outside the lock;
    only the sampling decision and the window update are serialized."""

    def __init__(self, *, every_n: int = 32, k: int = 10, window: int = 64):
        if every_n < 1:
            raise ValueError(f"every_n must be >= 1, got {every_n}")
        if k < 1 or window < 1:
            raise ValueError(f"k/window must be >= 1, got {k}/{window}")
        self.every_n = int(every_n)
        self.k = int(k)
        self.window = int(window)
        self._lock = threading.Lock()
        self._calls = 0
        self._probes = 0
        self._recalls: deque = deque(maxlen=self.window)

    def observe(self, engine, q: np.ndarray, ann_keys: np.ndarray, *,
                tail_feats: Optional[np.ndarray] = None,
                tail_keys: Optional[Sequence[str]] = None) -> Optional[float]:
        """Called by the copy-risk scorer with the [n, K] key table it just
        served (the tail merge included). Returns this sample's recall when
        the call was probed, else None."""
        with self._lock:
            self._calls += 1
            if (self._calls - 1) % self.every_n != 0:
                return None
            self._probes += 1
            probe_idx = self._probes
        if faults.fire("recall_degrade", probe=probe_idx):
            # corrupt the shortlist the probe judges (the served answer is
            # untouched): every key misses, recall pins to 0
            ann_keys = np.full_like(np.asarray(ann_keys, dtype=object), "__recall_degrade__")
        truth_keys = self._oracle(engine, q, tail_feats, tail_keys)
        recall = self._recall_at_k(ann_keys, truth_keys)
        with self._lock:
            self._recalls.append(recall)
            rolling = sum(self._recalls) / len(self._recalls)
            samples = len(self._recalls)
        reg = tracing.registry()
        reg.gauge("ann/recall_online_pct").set(int(round(rolling * 100)))
        reg.gauge("ann/recall_online_samples").set(samples)
        reg.counter("ann/recall_probe_total").inc()
        log.debug("ann recall probe: recall@%d %.4f over %d queries (rolling %.4f, %d samples)",
                  self.k, recall, int(np.asarray(q).shape[0]), rolling, samples)
        return recall

    @staticmethod
    def _oracle(engine, q, tail_feats, tail_keys) -> np.ndarray:
        """The exact top-k key table: the full-probe IVF query merged with
        the exact tail scan."""
        e_scores, e_keys = engine.query(q, nprobe=engine.ann.n_lists)
        if tail_feats is not None and len(tail_feats):
            t_scores, t_keys = engine.query_rows(q, tail_feats, tail_keys)
            _, e_keys = merge_topk(e_scores, e_keys, t_scores, t_keys)
        return e_keys

    def _recall_at_k(self, ann_keys: np.ndarray, truth_keys: np.ndarray) -> float:
        """The set-overlap recall of ``annindex.spot_check_recall``: one
        definition of recall offline and online."""
        ann_keys = np.asarray(ann_keys, dtype=object)
        kk = min(self.k, ann_keys.shape[1], truth_keys.shape[1])
        hits = total = 0
        for arow, erow in zip(ann_keys, truth_keys):
            truth = set(x for x in erow[:kk] if x)
            if not truth:
                continue
            hits += len(truth & set(arow[:kk].tolist()))
            total += len(truth)
        return hits / total if total else 1.0

    def stats(self) -> dict:
        with self._lock:
            samples = len(self._recalls)
            rolling = (sum(self._recalls) / samples) if samples else None
            return {"calls": self._calls, "probes": self._probes, "samples": samples,
                    "every_n": self.every_n, "k": self.k,
                    "rolling_recall": round(rolling, 4) if rolling is not None else None}
