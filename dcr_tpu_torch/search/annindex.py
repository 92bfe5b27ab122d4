"""The nprobe-bounded IVF scan engine with exact f32 re-ranking.

Counterpart of ``dcr_tpu/search/annindex.py`` over
:mod:`dcr_tpu_torch.search.ann`'s inverted lists, on one device or a mesh of
ranks. Where the exact engine (:mod:`~dcr_tpu_torch.search.shardindex`)
scans every committed row per query, this engine:

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
fault kind drives that path. The live tier's WAL tail, whose rows are in no
list, scans exactly through the same re-rank (:meth:`AnnEngine.query_rows`).

On a mesh (``mesh=``) the rows of each list segment split over the
``data`` x ``fsdp`` ranks as the JAX engine shards them (``segment_rows``
and ``rerank_rows`` padded to the rank count, ``dcr_tpu/search/
annindex.py:125-160``): each rank reads only the lists that hold its slabs
(a damaged one is rebuilt once, by rank 0, and read again by all) and
scans them with the probe every rank computes alike. Per query call, one
exchange merges the ranks' approximate shortlists into the one-device
shortlist (score descending, the lower global row first, as ``lax.top_k``
over the whole segment and the stable merge give it), each rank re-ranks
the candidates it holds, and a second merges the exact tables
(:func:`~dcr_tpu_torch.parallel.mesh.exchange_topk`): no exchange per
scanned segment. Every rank returns the same answer. The scan launches no
native kernel, so the warm cache (``core/warmcache.py``) has nothing of its
own to hold.
"""

from __future__ import annotations

import logging
from typing import Optional, Sequence

import numpy as np
import torch

from dcr_tpu_torch.core import dist, tracing
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.search import ann as annmod
from dcr_tpu_torch.search.ann import AnnError, AnnIndexReader
from dcr_tpu_torch.search.shardindex import check_mesh, full_f32_matmul, merge_topk, topk
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


@compile_surface("search/ivf_scan")
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


class AnnEngine:
    """IVF + int8 approximate top-k with exact re-rank: the ``ann``
    counterpart of :class:`~dcr_tpu_torch.search.shardindex.ShardedTopK`,
    with its query and table contract, on one device or over a mesh's
    ``data`` x ``fsdp`` ranks (module docstring). ``build`` is eager and
    idempotent; ``normalize_queries`` and ``require_normalized_rows`` are
    the cosine convention of copy-risk scoring.
    """

    def __init__(self, store_dir, *, mesh=None, top_k: int = 1,
                 nprobe: int = DEFAULT_NPROBE, query_batch: int = 64,
                 shortlist_k: int = DEFAULT_SHORTLIST_K, segment_rows: int = 0,
                 max_resident_rows: int = DEFAULT_MAX_RESIDENT_ROWS,
                 normalize_queries: bool = False, require_normalized_rows: bool = False,
                 device: str | torch.device = "cuda"):
        check_mesh(mesh)
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
        self.mesh = mesh
        self.device = resolve_device(device)
        self.top_k = max(1, int(top_k))
        self.nprobe = max(1, min(int(nprobe), self.ann.n_lists))
        self.query_batch = max(1, int(query_batch))
        self.shortlist_k = max(int(shortlist_k), self.top_k)
        self.normalize_queries = bool(normalize_queries)
        want = int(segment_rows) if segment_rows > 0 else DEFAULT_SEGMENT_ROWS
        self.slabs = pmesh.Slabs.of(max(want, self.shortlist_k), mesh)
        self.segment_rows = self.slabs.segment_rows
        self.max_resident_rows = int(max_resident_rows)
        # the f32 candidate pool per chunk: every query's whole shortlist
        # (padded to the ranks as the JAX engine pads it)
        self.rerank_rows = pmesh.Slabs.of(self.query_batch * self.shortlist_k,
                                          mesh).segment_rows
        self._centroids: Optional[np.ndarray] = None
        # this rank's rows, slab after slab: host f32 [n, D] and keys, and
        # where each segment's slab starts in them (-1: no rows here)
        self._feats: Optional[np.ndarray] = None
        self._keys: Optional[np.ndarray] = None
        self._slab_start: Optional[np.ndarray] = None
        # (codes, row_list, scale, zero, valid, first global row) per slab:
        # on the device when resident, in (pinned) host memory otherwise
        self._segments: list[tuple] = []
        self._seg_lists: list[set[int]] = []
        self.resident = False
        self.num_segments = 0
        self.rows_held = 0
        self._built = False

    @property
    def total(self) -> int:
        return self.ann.total

    # -- construction --------------------------------------------------------

    def _load_lists(self) -> tuple[list[int], list[int], dict[int, tuple]]:
        """The lists laid out (ids in order, their row counts) and this
        rank's loaded ones ``{id: (codes, feats, keys, scale, zero)}``. The
        lists pack in list-id order; each rank verifies the lists that hold
        its slabs. A list that fails on any rank is rebuilt from the
        committed store (by rank 0 on a mesh, the others waiting) and read
        again; one that fails again drops out of every rank's layout."""
        reader = self.ann
        excluded: set[int] = set()
        rebuilt: set[int] = set()
        cache: dict[int, tuple] = {}
        while True:
            by_id = {int(e["list"]): e for e in reader.lists}
            missing = [i for i in range(self.ann.n_lists) if i not in by_id]
            if missing:
                raise AnnError(f"ann manifest has no list {missing[0]}")
            order = [i for i in range(self.ann.n_lists)
                     if i not in excluded and int(by_id[i].get("count", 0)) > 0]
            counts = [int(by_id[i]["count"]) for i in order]
            offsets = np.cumsum([0] + counts)
            failed = set()
            for j, lid in enumerate(order):
                if lid in cache or not self.slabs.meets(int(offsets[j]), int(offsets[j + 1]),
                                                        int(offsets[-1])):
                    continue
                loaded = reader.load_list(by_id[lid])
                if loaded is None:
                    failed.add(lid)
                else:
                    cache[lid] = loaded
            failed = pmesh.union_over_ranks(failed, "ann_lists", self.mesh)
            if not failed:
                return order, counts, cache
            for lid in sorted(failed & rebuilt):
                log.warning("annindex: list %d unavailable after quarantine — serving the "
                            "surviving lists", lid)
            excluded |= failed & rebuilt
            retry = failed - rebuilt
            for lid in failed:
                cache.pop(lid, None)
            if retry:
                if self.mesh is None or dist.is_primary():
                    for lid in sorted(retry):
                        annmod.rebuild_list(self.store_dir, lid)
                if self.mesh is not None and self.mesh.world > 1:
                    dist.barrier("ann_rebuild", timeout_s=dist.default_allgather_timeout_s())
                reader = AnnIndexReader(self.store_dir)
                rebuilt |= retry

    def _pad_segment(self, codes, row_list, scale, zero, start: int) -> tuple:
        """One slab's tensors, zero-padded to ``slabs.rows``."""
        s, n = self.slabs.rows, codes.shape[0]
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
        """Load, verify (rebuilding damaged lists) and place this rank's
        slabs."""
        if self._built:
            return self
        self._centroids = self.ann.load_centroids()
        order, counts, cache = self._load_lists()
        offsets = np.cumsum([0] + counts)
        total = int(offsets[-1])
        self.resident = total <= max(self.max_resident_rows, self.segment_rows)
        self.num_segments = max(1, -(-total // self.segment_rows))
        self._segments, self._seg_lists = [], []
        self._slab_start = np.full((self.num_segments,), -1, np.int64)
        feats_all, keys_all, held_lists = [], [], set()
        self.rows_held = 0
        for seg in range(self.num_segments):
            lo, hi = self.slabs.slab(seg, total)
            if hi <= lo:
                continue
            parts = []
            for j in np.nonzero((offsets[1:] > lo) & (offsets[:-1] < hi))[0]:
                codes, feats, keys, scale, zero = cache[order[j]]
                a, e = max(lo, offsets[j]) - offsets[j], min(hi, offsets[j + 1]) - offsets[j]
                n = e - a
                parts.append((codes[a:e], feats[a:e], np.asarray(keys[a:e], dtype=object),
                              np.full((n,), order[j], np.int32),
                              np.full((n,), scale, np.float32), np.full((n,), zero, np.float32)))
                held_lists.add(order[j])
                if offsets[j + 1] <= hi:  # no later slab of this rank reads it
                    cache.pop(order[j], None)
            codes, feats, keys, row_list, scale, zero = (
                np.concatenate([p[i] for p in parts]) for i in range(6))
            self._slab_start[seg] = self.rows_held
            self.rows_held += hi - lo
            feats_all.append(feats)
            keys_all.append(keys)
            self._segments.append(self._pad_segment(codes, row_list, scale, zero, lo))
            self._seg_lists.append(set(row_list.tolist()))
        dim = self.ann.embed_dim
        self._feats = np.concatenate(feats_all) if feats_all else np.zeros((0, dim), np.float32)
        self._keys = np.concatenate(keys_all) if keys_all else np.zeros((0,), dtype=object)
        self._built = True
        reg = tracing.registry()
        reg.gauge("ann/index_rows").set(self.ann.total)
        reg.gauge("ann/lists").set(self.ann.n_lists)
        reg.gauge("ann/owned_lists").set(len(held_lists))
        reg.gauge("ann/segments").set(self.num_segments)
        reg.gauge("ann/nprobe").set(self.nprobe)
        log.info("annindex: ready — %d rows (%d lists) in %d segment(s) of %d, nprobe=%d, "
                 "shortlist=%d, top_k=%d (%s, %s%s)", total, self.ann.n_lists,
                 self.num_segments, self.segment_rows, self.nprobe, self.shortlist_k,
                 self.top_k, "device-resident" if self.resident else "host-streamed",
                 self.device, "" if self.mesh is None else
                 f"; rank slab {self.slabs.index}/{self.slabs.parts}: {self.rows_held} rows "
                 f"of {len(held_lists)} list(s)")
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
        if n == 0:
            return (np.full((0, self.top_k), -np.inf, np.float32),
                    np.full((0, self.top_k), "", dtype=object))
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
        k_short = min(self.shortlist_k, self.segment_rows)
        short_scores = np.full((n, k_short), -np.inf, np.float32)
        short_rows = np.full((n, k_short), -1, np.int64)
        chunks = []
        for start in range(0, n, self.query_batch):
            sel = order[start:start + self.query_batch]
            q_dev, s, r = self._scan_chunk(qn[sel], probes[sel], nprobe, k_short)
            short_scores[sel], short_rows[sel] = s, r
            chunks.append((sel, q_dev))
        # the ranks' shortlists into the one-device shortlist
        _, short_rows, _ = pmesh.exchange_topk(short_scores, short_rows, None, k_short,
                                               self.mesh)
        out = (np.full((n, self.top_k), -np.inf, np.float32),
               np.full((n, self.top_k), -1, np.int64),
               np.full((n, self.top_k), "", dtype=object))
        for sel, q_dev in chunks:
            for table, part in zip(out, self._rerank(q_dev, short_rows[sel], len(sel))):
                table[sel] = part
        scores, _, keys = pmesh.exchange_topk(*out, self.top_k, self.mesh)
        return scores, keys

    def _scan_chunk(self, q: np.ndarray, probes: np.ndarray, nprobe: int, k_short: int
                    ) -> tuple[torch.Tensor, np.ndarray, np.ndarray]:
        """The chunk's queries on the device, and their approximate
        shortlist ``(scores, global rows)`` [m, k_short] over this rank's
        slabs."""
        m, b = q.shape[0], self.query_batch
        if m < b:
            q = np.concatenate([q, np.repeat(q[-1:], b - m, axis=0)])
            probes = np.concatenate([probes, np.repeat(probes[-1:], b - m, axis=0)])
        probed = np.zeros((b, self.ann.n_lists), bool)
        np.put_along_axis(probed, probes, True, axis=1)
        probed_union = set(np.unique(probes[:m]).tolist())
        q_dev = torch.from_numpy(q).to(self.device)
        probed_dev = torch.from_numpy(probed).to(self.device)
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
            short_scores, short_rows, _ = pmesh.merge_candidates(
                np.concatenate([short_scores, s], axis=1),
                np.concatenate([short_rows, seg_start + idx.astype(np.int64)], axis=1),
                None, k_short)
        reg.counter("ann/segments_scanned_total").inc(scanned)
        reg.counter("ann/segments_skipped_total").inc(skipped)
        log.debug("ann query funnel: batch=%d nprobe=%d lists_probed=%d segments scanned=%d "
                  "skipped=%d shortlist=%d", m, nprobe, len(probed_union), scanned, skipped,
                  int((short_rows >= 0).sum()))
        return q_dev, short_scores, short_rows

    def _local(self, rows: np.ndarray) -> np.ndarray:
        """This rank's index of each global row in its held rows, -1 where
        another rank holds it."""
        seg, off = rows // self.segment_rows, rows % self.segment_rows
        mine = (off // self.slabs.rows == self.slabs.index) & (self._slab_start[seg] >= 0)
        return np.where(mine, self._slab_start[seg] + off % self.slabs.rows, -1)

    def _rerank(self, q_dev: torch.Tensor, short_rows: np.ndarray, m: int
                ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Exact f32 re-rank of the chunk's candidate union through
        :func:`shardindex.topk` at the fixed ``rerank_rows`` shape, over the
        candidates this rank holds: ``(scores, global rows, keys)`` [m, K]."""
        out_scores = np.full((m, self.top_k), -np.inf, np.float32)
        out_rows = np.full((m, self.top_k), -1, np.int64)
        out_keys = np.full((m, self.top_k), "", dtype=object)
        cand = np.unique(short_rows[short_rows >= 0])[:self.rerank_rows]
        local = self._local(cand)
        cand, local = cand[local >= 0], local[local >= 0]
        if cand.size == 0:
            return out_scores, out_rows, out_keys
        nc = int(cand.size)
        feats = torch.zeros((self.rerank_rows, self.ann.embed_dim), dtype=torch.float32)
        feats[:nc] = torch.from_numpy(self._feats[local])
        valid = torch.zeros((self.rerank_rows,), dtype=torch.bool)
        valid[:nc] = True
        tracing.registry().counter("ann/rerank_rows_total").inc(nc)
        s, idx = topk(feats.to(self.device), valid.to(self.device), q_dev,
                      min(self.top_k, self.rerank_rows))
        s, idx = s[:m].cpu().numpy(), np.clip(idx[:m].cpu().numpy(), 0, nc - 1)
        kr = s.shape[1]
        pad = np.isneginf(s)
        out_scores[:, :kr] = s
        out_rows[:, :kr] = np.where(pad, -1, cand[idx])
        out_keys[:, :kr] = np.where(pad, "", self._keys[local[idx]])
        return out_scores, out_rows, out_keys

    def query_rows(self, q: np.ndarray, feats: np.ndarray,
                   keys: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Exact top-k of ``q`` against ad-hoc rows (the live WAL tail)
        through the f32 re-rank at its fixed ``rerank_rows`` shape: tail rows
        are in no inverted list, so they are scanned whole, and their exact
        scores merge with :meth:`query`'s (also exact) scores through
        :func:`~dcr_tpu_torch.search.shardindex.merge_topk`. Rows follow the
        tier's normalisation, queries the engine's."""
        if not self._built:
            self.build()
        q = np.asarray(q, np.float32)
        feats = np.asarray(feats, np.float32)
        keys_arr = np.asarray(keys, dtype=object)
        dim = self.ann.embed_dim
        if q.ndim != 2 or q.shape[1] != dim:
            raise ValueError(f"queries must be [n, {dim}], got {q.shape}")
        if feats.ndim != 2 or feats.shape[1] != dim:
            raise ValueError(f"tail rows must be [n, {dim}], got {feats.shape}")
        if len(keys_arr) != feats.shape[0]:
            raise ValueError(f"{feats.shape[0]} tail rows but {len(keys_arr)} keys")
        n = q.shape[0]
        out_scores = np.full((n, self.top_k), -np.inf, np.float32)
        out_keys = np.full((n, self.top_k), "", dtype=object)
        if n == 0 or feats.shape[0] == 0:
            return out_scores, out_keys
        if self.ann.normalized:
            feats = normalize_rows(feats)
        qn = normalize_rows(q) if self.normalize_queries else q
        b, r = self.query_batch, self.rerank_rows
        k = min(self.top_k, r)
        for qs in range(0, n, b):
            chunk = qn[qs:qs + b]
            m = chunk.shape[0]
            if m < b:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], b - m, axis=0)])
            q_dev = torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)
            for rs in range(0, feats.shape[0], r):
                part, pk = feats[rs:rs + r], keys_arr[rs:rs + r]
                nc = part.shape[0]
                pad = torch.zeros((r, dim), dtype=torch.float32)
                pad[:nc] = torch.from_numpy(np.ascontiguousarray(part))
                valid = torch.zeros((r,), dtype=torch.bool)
                valid[:nc] = True
                s, idx = topk(pad.to(self.device), valid.to(self.device), q_dev, k)
                s, idx = s[:m].cpu().numpy(), idx[:m].cpu().numpy()
                seg_keys = np.full((m, self.top_k), "", dtype=object)
                seg_scores = np.full((m, self.top_k), -np.inf, np.float32)
                seg_scores[:, :k] = s
                seg_keys[:, :k] = np.where(np.isneginf(s), "", pk[np.clip(idx, 0, nc - 1)])
                sl = slice(qs, qs + m)
                out_scores[sl], out_keys[sl] = merge_topk(out_scores[sl], out_keys[sl],
                                                          seg_scores, seg_keys)
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
                    require_normalized_rows: bool = False,
                    device: str | torch.device = "cuda") -> AnnEngine:
    """Reader and built engine in one call."""
    return AnnEngine(store_dir, mesh=mesh, top_k=top_k, nprobe=nprobe,
                     query_batch=query_batch, shortlist_k=shortlist_k,
                     segment_rows=segment_rows, normalize_queries=normalize_queries,
                     require_normalized_rows=require_normalized_rows,
                     device=device).build()
