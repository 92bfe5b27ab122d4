"""The nprobe-bounded IVF scan engine with exact f32 re-ranking.

Counterpart of ``dcr_tpu/search/annindex.py``, on one device and in one
process, over :mod:`dcr_tpu_torch.search.ann`'s inverted lists. Where the
exact engine (:mod:`~dcr_tpu_torch.search.shardindex`) scans every committed
row per query, this engine:

- finds each query's ``nprobe`` nearest centroids on the host (an
  [B, n_lists] matmul) and scans only the segments that hold a probed list;
- packs the lists into fixed padded segments of int8 codes; :func:`ivf_scan`
  computes approximate scores from the int8 operand (``(q @ codes.T) *
  scale + zero * sum(q)``), so the device holds the corpus as int8, ~4x
  smaller than f32;
- re-ranks the shortlist in f32 through the exact engine's own
  :func:`~dcr_tpu_torch.search.shardindex.topk` at one fixed shape, so the
  scores it returns are exact dot products;
- groups queries by their top probe before chunking (a stable sort,
  scattered back), so a chunk's probed-list union stays small and whole
  segments skip.

A chunk re-ranks the union of its queries' shortlists in one call, so a
query can gain candidates from its chunk-mates' probed lists: recall is
bounded below by per-query IVF and the answer is fixed for a fixed query
array. Segments stay on the device up to ``max_resident_rows`` int8 rows and
are otherwise uploaded from pinned host memory per chunk. A list that fails
verification at build is quarantined and counted by the reader and rebuilt
from the committed store (``ann.rebuild_list``): the ``ivf_list_corrupt``
fault kind drives that path. One process owns every list. A mesh, the warm
cache and the live tail (``query_rows``) are not ported.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.config import NotPortedError
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.search import ann as annmod
from dcr_tpu_torch.search.ann import AnnError, AnnIndexReader
from dcr_tpu_torch.search.shardindex import full_f32_matmul, topk
from dcr_tpu_torch.search.store import EmbeddingStoreReader, normalize_rows

log = logging.getLogger("dcr_tpu_torch")

#: default probed lists per query
DEFAULT_NPROBE = 8
#: default int8 shortlist per (query, segment): the re-rank budget
DEFAULT_SHORTLIST_K = 32
#: rows per packed int8 segment (the probe-skipping granule, so smaller than
#: the exact engine's)
DEFAULT_SEGMENT_ROWS = 8192
#: engines of at most this many int8 rows keep their segments on the device
DEFAULT_MAX_RESIDENT_ROWS = 1 << 22


def ivf_scan(codes: torch.Tensor, scale: torch.Tensor, zero: torch.Tensor,
             row_list: torch.Tensor, valid: torch.Tensor, probed: torch.Tensor,
             q: torch.Tensor, shortlist_k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``(scores [B, k], idx [B, k])``: the approximate top ``shortlist_k``
    of ``q [B, D]`` over one packed segment (``codes`` int8 [S, D], per-row
    ``scale``, ``zero`` and list id ``row_list`` [S], ``valid`` [S]), rows
    whose list is not in the query's row of ``probed`` [B, L] (and pad rows)
    at ``-inf``.

    ``feats ~= codes*scale + zero`` per list, so ``q @ feats.T ~= (q @
    codes.T)*scale + zero*sum(q)``: the f32 rows never reach the device.
    Quantised scores tie often, and ``lax.top_k`` puts the lower index first
    where ``torch.topk`` on a GPU promises no order, so the shortlist is a
    stable descending sort cut to ``shortlist_k``: ties in index order."""
    with full_f32_matmul():
        approx = (q @ codes.T.float()) * scale[None, :] \
            + zero[None, :] * q.sum(-1, keepdim=True)
    mask = probed.index_select(1, row_list) & valid[None, :]
    scores = approx.masked_fill(~mask, float("-inf"))
    s, idx = torch.sort(scores, dim=1, descending=True, stable=True)
    return s[:, :shortlist_k], idx[:, :shortlist_k]


def _merge_shortlist(scores: np.ndarray, rows: np.ndarray, new_scores: np.ndarray,
                     new_rows: np.ndarray, keep: int) -> tuple[np.ndarray, np.ndarray]:
    """Host merge of two per-query approximate shortlists ``(scores [B, k],
    global row ids [B, k])``, keeping the best ``keep`` (stable)."""
    all_scores = np.concatenate([scores, new_scores], axis=1)
    all_rows = np.concatenate([rows, new_rows], axis=1)
    order = np.argsort(-all_scores, axis=1, kind="stable")[:, :keep]
    return (np.take_along_axis(all_scores, order, axis=1),
            np.take_along_axis(all_rows, order, axis=1))


class AnnEngine:
    """IVF + int8 approximate top-k with exact re-rank: the ``ann``
    counterpart of :class:`~dcr_tpu_torch.search.shardindex.ShardedTopK`,
    with its query and table contract. ``build`` is eager and idempotent;
    ``normalize_queries`` and ``require_normalized_rows`` are the cosine
    convention of copy-risk scoring.
    """

    def __init__(self, store_dir, *, mesh=None, top_k: int = 1,
                 nprobe: int = DEFAULT_NPROBE, query_batch: int = 64,
                 shortlist_k: int = DEFAULT_SHORTLIST_K, segment_rows: int = 0,
                 max_resident_rows: int = DEFAULT_MAX_RESIDENT_ROWS,
                 normalize_queries: bool = False, require_normalized_rows: bool = False,
                 warm_dir: str = "", device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotPortedError("a device mesh for the ANN engine is not ported to "
                                 "dcr_tpu_torch yet (ROADMAP Queue A item 9)")
        if warm_dir:
            raise NotPortedError("warm_dir (the warm executable cache) is not ported to "
                                 "dcr_tpu_torch yet (ROADMAP Queue A item 7)")
        self.store_dir = store_dir
        self.reader = EmbeddingStoreReader(store_dir)
        self.ann = AnnIndexReader(store_dir)
        if self.ann.embed_dim != self.reader.embed_dim:
            raise AnnError(f"ann width {self.ann.embed_dim} != store width "
                           f"{self.reader.embed_dim} — retrain (`dcr-search train-ivf`)")
        if require_normalized_rows and not self.ann.normalized:
            raise AnnError("this consumer needs cosine scores but the ann index was trained "
                           "over unnormalized rows — retrain with `dcr-search train-ivf "
                           "--ivf_normalize=true`")
        self.device = resolve_device(device)
        self.top_k = max(1, int(top_k))
        self.nprobe = max(1, min(int(nprobe), self.ann.n_lists))
        self.query_batch = max(1, int(query_batch))
        self.shortlist_k = max(int(shortlist_k), self.top_k)
        self.normalize_queries = bool(normalize_queries)
        want = int(segment_rows) if segment_rows > 0 else DEFAULT_SEGMENT_ROWS
        self.segment_rows = max(want, self.shortlist_k)
        self.max_resident_rows = int(max_resident_rows)
        # the f32 candidate pool per chunk: every query's whole shortlist
        self.rerank_rows = self.query_batch * self.shortlist_k
        self._centroids: Optional[np.ndarray] = None
        self._feats: Optional[np.ndarray] = None   # host f32 [N, D], list order
        self._keys: Optional[np.ndarray] = None
        # (codes, row_list, scale, zero, valid, first row): on the device
        # when resident, in (pinned) host memory otherwise
        self._segments: list[tuple] = []
        self._seg_lists: list[set[int]] = []
        self.resident = False
        self.num_segments = 0
        self._built = False

    @property
    def total(self) -> int:
        return self.ann.total

    # -- construction --------------------------------------------------------

    def _load_lists(self) -> tuple[np.ndarray, ...]:
        """Verified rows of every list, packed in list-id order: ``(codes
        [N, D] int8, feats [N, D] f32, keys [N] object, row_list [N] int32,
        scale [N] f32, zero [N] f32)``. A list that fails verification is
        rebuilt from the committed store."""
        by_id = {int(e["list"]): e for e in self.ann.lists}
        parts: list[tuple] = []
        for list_id in range(self.ann.n_lists):
            entry = by_id.get(list_id)
            if entry is None:
                raise AnnError(f"ann manifest has no list {list_id}")
            loaded = self.ann.load_list(entry)
            if loaded is None:
                annmod.rebuild_list(self.store_dir, list_id)
                fresh = AnnIndexReader(self.store_dir)
                loaded = fresh.load_list({int(e["list"]): e for e in fresh.lists}[list_id])
            if loaded is None:
                log.warning("annindex: list %d unavailable after quarantine — serving the "
                            "surviving lists", list_id)
                continue
            codes, feats, keys, scale, zero = loaded
            n = codes.shape[0]
            if n == 0:
                continue
            parts.append((codes, feats, keys, np.full((n,), list_id, np.int32),
                          np.full((n,), scale, np.float32), np.full((n,), zero, np.float32)))
        if not parts:
            dim = self.ann.embed_dim
            return (np.zeros((0, dim), np.int8), np.zeros((0, dim), np.float32),
                    np.zeros((0,), dtype=object), np.zeros((0,), np.int32),
                    np.zeros((0,), np.float32), np.zeros((0,), np.float32))
        return tuple(np.concatenate([p[i] for p in parts]) for i in range(6))

    def _pad_segment(self, codes, row_list, scale, zero, start: int) -> tuple:
        """One segment's tensors, zero-padded to ``segment_rows``."""
        s, n = self.segment_rows, codes.shape[0]
        pin = self.device.type == "cuda" and not self.resident

        def padded(arr: np.ndarray, fill, dtype) -> torch.Tensor:
            t = torch.full((s, *arr.shape[1:]), fill, dtype=dtype, pin_memory=pin)
            t[:n] = torch.from_numpy(np.ascontiguousarray(arr))
            return t

        valid = torch.zeros((s,), dtype=torch.bool, pin_memory=pin)
        valid[:n] = True
        seg = (padded(codes, 0, torch.int8), padded(row_list, 0, torch.int32),
               padded(scale, 1.0, torch.float32), padded(zero, 0.0, torch.float32), valid)
        if self.resident:
            seg = tuple(t.to(self.device) for t in seg)
        return seg + (start,)

    def build(self) -> "AnnEngine":
        """Load, verify (rebuilding damaged lists) and place the segments."""
        if self._built:
            return self
        self._centroids = self.ann.load_centroids()
        codes, feats, keys, row_list, scale, zero = self._load_lists()
        self._feats, self._keys = feats, keys
        n_owned = codes.shape[0]
        self.resident = n_owned <= max(self.max_resident_rows, self.segment_rows)
        self._segments, self._seg_lists = [], []
        for start in range(0, max(n_owned, 1), self.segment_rows):
            end = min(start + self.segment_rows, n_owned)
            self._segments.append(self._pad_segment(codes[start:end], row_list[start:end],
                                                    scale[start:end], zero[start:end], start))
            self._seg_lists.append(set(row_list[start:end].tolist()))
        self.num_segments = len(self._segments)
        self._built = True
        reg = tracing.registry()
        reg.gauge("ann/index_rows").set(self.ann.total)
        reg.gauge("ann/lists").set(self.ann.n_lists)
        reg.gauge("ann/owned_lists").set(self.ann.n_lists)
        reg.gauge("ann/segments").set(self.num_segments)
        reg.gauge("ann/nprobe").set(self.nprobe)
        log.info("annindex: ready — %d rows (%d lists) in %d segment(s) of %d, nprobe=%d, "
                 "shortlist=%d, top_k=%d (%s, %s)", n_owned, self.ann.n_lists,
                 self.num_segments, self.segment_rows, self.nprobe, self.shortlist_k,
                 self.top_k, "device-resident" if self.resident else "host-streamed",
                 self.device)
        return self

    def _put_segment(self, seg: tuple) -> tuple:
        *tensors, start = seg
        return tuple(t.to(self.device, non_blocking=True) for t in tensors) + (start,)

    # -- query ---------------------------------------------------------------

    def _probe(self, q: np.ndarray, nprobe: int) -> np.ndarray:
        """Each query's ``nprobe`` nearest centroids, on the host (a stable
        sort: ties in index order)."""
        scores = (q @ self._centroids.T
                  - 0.5 * np.sum(self._centroids * self._centroids, axis=-1)[None, :])
        return np.argsort(-scores, axis=1, kind="stable")[:, :nprobe]

    def query(self, q: np.ndarray, *, nprobe: int = 0) -> tuple[np.ndarray, np.ndarray]:
        """Approximate top-k of every query row against the whole store, with
        the exact engine's [n, K] descending table contract: the scores are
        exact f32 dot products of the re-ranked shortlist; only the
        candidate set is approximate. ``nprobe`` overrides the engine's
        default for this call."""
        if not self._built:
            self.build()
        q = np.asarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.ann.embed_dim:
            raise ValueError(f"queries must be [n, {self.ann.embed_dim}], got {q.shape}")
        n = q.shape[0]
        out_scores = np.full((n, self.top_k), -np.inf, np.float32)
        out_keys = np.full((n, self.top_k), "", dtype=object)
        if n == 0:
            return out_scores, out_keys
        nprobe = max(1, min(int(nprobe) or self.nprobe, self.ann.n_lists))
        reg = tracing.registry()
        reg.counter("ann/query_total").inc()
        reg.counter("ann/query_rows_total").inc(n)
        reg.gauge("ann/nprobe").set(nprobe)
        qn = normalize_rows(q) if self.normalize_queries else q
        probes = self._probe(qn, nprobe)
        # probe locality: queries sharing a top centroid share a chunk, so the
        # chunk's probed-list union stays small and whole segments skip
        order = np.argsort(probes[:, 0], kind="stable")
        for start in range(0, n, self.query_batch):
            sel = order[start:start + self.query_batch]
            out_scores[sel], out_keys[sel] = self._query_chunk(qn[sel], probes[sel], nprobe)
        return out_scores, out_keys

    def _query_chunk(self, q: np.ndarray, probes: np.ndarray, nprobe: int
                     ) -> tuple[np.ndarray, np.ndarray]:
        m, b = q.shape[0], self.query_batch
        if m < b:
            q = np.concatenate([q, np.repeat(q[-1:], b - m, axis=0)])
            probes = np.concatenate([probes, np.repeat(probes[-1:], b - m, axis=0)])
        probed = np.zeros((b, self.ann.n_lists), bool)
        np.put_along_axis(probed, probes, True, axis=1)
        probed_union = set(np.unique(probes[:m]).tolist())
        q_dev = torch.from_numpy(q).to(self.device)
        probed_dev = torch.from_numpy(probed).to(self.device)
        k_short = self.shortlist_k
        short_scores = np.full((m, k_short), -np.inf, np.float32)
        short_rows = np.full((m, k_short), -1, np.int64)
        reg = tracing.registry()
        scanned = skipped = 0
        for si, seg in enumerate(self._segments):
            hit = self._seg_lists[si] & probed_union
            if not hit:
                skipped += 1
                continue
            if not self.resident:
                seg = self._put_segment(seg)
            codes, row_list, scale, zero, valid, seg_start = seg
            s, idx = ivf_scan(codes, scale, zero, row_list, valid, probed_dev, q_dev, k_short)
            s, idx = s[:m].cpu().numpy(), idx[:m].cpu().numpy()
            scanned += 1
            reg.counter("ann/lists_scanned_total").inc(len(hit))
            rows = np.where(np.isneginf(s), -1, seg_start + idx)
            short_scores, short_rows = _merge_shortlist(short_scores, short_rows, s, rows,
                                                        k_short)
        reg.counter("ann/segments_scanned_total").inc(scanned)
        reg.counter("ann/segments_skipped_total").inc(skipped)
        log.debug("ann query funnel: batch=%d nprobe=%d lists_probed=%d segments scanned=%d "
                  "skipped=%d shortlist=%d", m, nprobe, len(probed_union), scanned, skipped,
                  int((short_rows >= 0).sum()))
        return self._rerank(q_dev, short_rows, m)

    def _rerank(self, q_dev: torch.Tensor, short_rows: np.ndarray, m: int
                ) -> tuple[np.ndarray, np.ndarray]:
        """Exact f32 re-rank of the chunk's candidate union through
        :func:`shardindex.topk` at the fixed ``rerank_rows`` shape."""
        out_scores = np.full((m, self.top_k), -np.inf, np.float32)
        out_keys = np.full((m, self.top_k), "", dtype=object)
        cand = np.unique(short_rows[short_rows >= 0])[:self.rerank_rows]
        if cand.size == 0:
            return out_scores, out_keys
        nc = int(cand.size)
        feats = torch.zeros((self.rerank_rows, self.ann.embed_dim), dtype=torch.float32)
        feats[:nc] = torch.from_numpy(self._feats[cand])
        valid = torch.zeros((self.rerank_rows,), dtype=torch.bool)
        valid[:nc] = True
        tracing.registry().counter("ann/rerank_rows_total").inc(nc)
        s, idx = topk(feats.to(self.device), valid.to(self.device), q_dev,
                      min(self.top_k, self.rerank_rows))
        s, idx = s[:m].cpu().numpy(), idx[:m].cpu().numpy()
        kr = s.shape[1]
        out_scores[:, :kr] = s
        out_keys[:, :kr] = np.where(np.isneginf(s), "", self._keys[cand[np.clip(idx, 0, nc - 1)]])
        return out_scores, out_keys


def spot_check_recall(engine: AnnEngine, exact_engine, q: np.ndarray, *, k: int = 10,
                      nprobe: int = 0) -> float:
    """recall@k of the ann engine against the exact engine on ``q``, also
    set as the ``ann/recall_spot_pct`` gauge and logged."""
    _, a_keys = engine.query(q, nprobe=nprobe)
    _, e_keys = exact_engine.query(q)
    kk = min(k, a_keys.shape[1], e_keys.shape[1])
    hits = total = 0
    for arow, erow in zip(a_keys, e_keys):
        truth = set(x for x in erow[:kk] if x)
        if not truth:
            continue
        hits += len(truth & set(arow[:kk].tolist()))
        total += len(truth)
    recall = hits / total if total else 1.0
    tracing.registry().gauge("ann/recall_spot_pct").set(int(round(recall * 100)))
    log.info("ann recall spot check: recall@%d %.4f over %d queries (nprobe=%d)", kk, recall,
             q.shape[0], int(nprobe) or engine.nprobe)
    return recall


def open_ann_engine(store_dir, *, mesh=None, top_k: int = 1, nprobe: int = DEFAULT_NPROBE,
                    query_batch: int = 64, shortlist_k: int = DEFAULT_SHORTLIST_K,
                    segment_rows: int = 0, normalize_queries: bool = False,
                    require_normalized_rows: bool = False, warm_dir: str = "",
                    device: str | torch.device = "cuda") -> AnnEngine:
    """Reader and built engine in one call."""
    return AnnEngine(store_dir, mesh=mesh, top_k=top_k, nprobe=nprobe,
                     query_batch=query_batch, shortlist_k=shortlist_k,
                     segment_rows=segment_rows, normalize_queries=normalize_queries,
                     require_normalized_rows=require_normalized_rows, warm_dir=warm_dir,
                     device=device).build()
