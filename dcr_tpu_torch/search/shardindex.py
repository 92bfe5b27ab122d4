"""The top-k engine over an embedding store, on one device.

Counterpart of ``dcr_tpu/search/shardindex.py``. The store's shards regroup
into fixed segments of ``segment_rows`` rows (the last padded, its pad rows
masked to ``-inf`` with key ``""``); :func:`topk` scores a batch of queries
against one segment on the device (one matmul, the pad mask, ``torch.topk``,
as ``make_topk`` at ``dcr_tpu/search/shardindex.py:59-81``) and the [B, K]
tables of the segments merge on the host with :func:`merge_topk`: K rows per
query and segment cross to the host, not the segment's similarities.

A store of up to ``max_resident_rows`` rows stays on the device between
queries. A larger one keeps its segments on the host (pinned when the device
is a GPU) and uploads each once per :meth:`ShardedTopK.query`, segments
outermost, as the JAX engine streams them (``:269-272``). Queries run in
chunks of ``query_batch`` rows, the last padded with copies of its last row,
so a query's scores do not depend on the rows it is batched with.

The matmuls run in full f32 whatever the global flags say (TF32 would move
scores by ~1e-3 relative and change neighbours). No two f32 paths are
bit-equal (the card against the CPU, the store against the brute force, the
port against JAX: cuBLAS and XLA round differently for different shapes),
and ``torch.topk`` orders ties arbitrarily on a GPU, where ``lax.top_k``
puts the lower index first; results agree to within f32 rounding, and keys
agree wherever the scores are not near-ties. A mesh and the warm cache are
not ported.
"""

from __future__ import annotations

import logging
from contextlib import contextmanager
from typing import Iterator, Sequence

import numpy as np
import torch

from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.config import NotPortedError
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.search.store import EmbeddingStoreReader, StoreError, normalize_rows

log = logging.getLogger("dcr_tpu_torch")

#: default rows per device segment; smaller stores take their own size
DEFAULT_SEGMENT_ROWS = 65536
#: stores of at most this many rows stay on the device between queries;
#: larger ones stream their segments from the host per query
DEFAULT_MAX_RESIDENT_ROWS = 1 << 20


@contextmanager
def full_f32_matmul() -> Iterator[None]:
    """f32 matmuls without TF32 inside the block; the global flag is
    restored after it."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def topk(feats: torch.Tensor, valid: torch.Tensor, q: torch.Tensor, k: int,
         normalize_queries: bool = False) -> tuple[torch.Tensor, torch.Tensor]:
    """``(scores [B, k] descending, idx [B, k])`` of ``q [B, D]`` against
    ``feats [R, D]``, rows where ``valid [R]`` is False scored ``-inf``.
    ``normalize_queries`` L2-normalises the queries first (the copy-risk
    cosine convention)."""
    if normalize_queries:
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
    with full_f32_matmul():
        sims = q @ feats.T
    sims.masked_fill_(~valid[None, :], float("-inf"))
    return torch.topk(sims, k, dim=1)


def merge_topk(scores: np.ndarray, keys: np.ndarray, new_scores: np.ndarray,
               new_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host merge of two [N, K] top-k tables (descending), the current
    table's entries first among equal scores (a stable sort). The brute
    force merges across folders with it too."""
    all_scores = np.concatenate([scores, new_scores], axis=1)
    all_keys = np.concatenate([keys, new_keys], axis=1)
    order = np.argsort(-all_scores, axis=1, kind="stable")[:, : scores.shape[1]]
    return (np.take_along_axis(all_scores, order, axis=1),
            np.take_along_axis(all_keys, order, axis=1))


class ShardedTopK:
    """Top-k over an :class:`EmbeddingStoreReader` on one device.

    :meth:`build` loads and verifies the store, regroups it into segments
    and places them (on the device when the store fits under
    ``max_resident_rows``); :meth:`query` then answers any number of
    queries. ``normalize_rows`` L2-normalises the store's rows as they load.
    """

    def __init__(self, reader: EmbeddingStoreReader, *, mesh=None,
                 top_k: int = 1, query_batch: int = 64,
                 segment_rows: int = 0,
                 max_resident_rows: int = DEFAULT_MAX_RESIDENT_ROWS,
                 normalize_queries: bool = False,
                 normalize_rows: bool = False, warm_dir: str = "",
                 device: str | torch.device = "cuda"):
        if mesh is not None:
            raise NotPortedError("a device mesh for the top-k engine is not ported to "
                                 "dcr_tpu_torch yet (ROADMAP Queue A item 9)")
        if warm_dir:
            raise NotPortedError("warm_dir (the warm executable cache) is not ported to "
                                 "dcr_tpu_torch yet (ROADMAP Queue A item 7)")
        self.reader = reader
        self.device = resolve_device(device)
        self.top_k = max(1, int(top_k))
        self.query_batch = max(1, int(query_batch))
        self.normalize_queries = bool(normalize_queries)
        want = int(segment_rows) if segment_rows > 0 else min(
            max(1, reader.total), DEFAULT_SEGMENT_ROWS)
        # K can never exceed the segment
        self.segment_rows = max(want, self.top_k)
        self.resident = reader.total <= max(max_resident_rows, self.segment_rows)
        # (features [segment_rows, D], valid [segment_rows], keys
        # [segment_rows] object ""-padded, n_rows): on the device when
        # resident, on the host otherwise
        self._segments: list[tuple] = []
        self.num_segments = 0
        self._normalize_rows = bool(normalize_rows)
        self._built = False

    @property
    def total(self) -> int:
        return self.reader.total

    # -- construction --------------------------------------------------------

    def _host_segments(self) -> Iterator[tuple]:
        """Verified store shards regrouped into fixed padded segments."""
        rows: list[np.ndarray] = []
        keys: list[np.ndarray] = []
        pending = 0
        for feats, ks in self.reader.iter_shards():
            if self._normalize_rows:
                feats = normalize_rows(feats)
            rows.append(feats)
            keys.append(np.asarray(ks, dtype=object))
            pending += feats.shape[0]
            while pending >= self.segment_rows:
                feats_all = np.concatenate(rows)
                keys_all = np.concatenate(keys)
                yield self._pad_segment(feats_all[:self.segment_rows],
                                        keys_all[:self.segment_rows])
                rows = [feats_all[self.segment_rows:]]
                keys = [keys_all[self.segment_rows:]]
                pending = rows[0].shape[0]
        if pending:
            yield self._pad_segment(np.concatenate(rows), np.concatenate(keys))

    def _pad_segment(self, feats: np.ndarray, keys: np.ndarray) -> tuple:
        n, dim = feats.shape[0], self.reader.embed_dim
        # a streamed segment waits in pinned memory for its uploads
        pin = self.device.type == "cuda" and not self.resident
        padded = torch.zeros((self.segment_rows, dim), dtype=torch.float32, pin_memory=pin)
        padded[:n] = torch.from_numpy(np.ascontiguousarray(feats, np.float32))
        valid = torch.zeros((self.segment_rows,), dtype=torch.bool, pin_memory=pin)
        valid[:n] = True
        if n < self.segment_rows:
            keys = np.concatenate([keys, np.full((self.segment_rows - n,), "", dtype=object)])
        if self.resident:
            return padded.to(self.device), valid.to(self.device), keys, n
        return padded, valid, keys, n

    def build(self) -> "ShardedTopK":
        """Load, verify and place the segments. Idempotent."""
        if self._built:
            return self
        self._segments = list(self._host_segments())
        if not self._segments:
            raise StoreError(f"store {self.reader.dir} holds no rows")
        self.num_segments = len(self._segments)
        self._built = True
        log.info("shardindex: ready — %d rows in %d segment(s) of %d (top_k=%d, batch=%d, "
                 "%s, %s)", self.reader.total, self.num_segments, self.segment_rows,
                 min(self.top_k, self.segment_rows), self.query_batch,
                 "device-resident" if self.resident else "host-streamed", self.device)
        return self

    def _put_segment(self, seg: tuple) -> tuple:
        feats, valid, keys, n = seg
        return (feats.to(self.device, non_blocking=True),
                valid.to(self.device, non_blocking=True), keys, n)

    # -- query ---------------------------------------------------------------

    def _check_queries(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.reader.embed_dim:
            raise ValueError(f"queries must be [n, {self.reader.embed_dim}], got {q.shape}")
        return q

    def query(self, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Top-k of every query row against the whole store.

        ``q`` is float32 [n, D]. Returns ``(scores [n, top_k] descending,
        keys [n, top_k] object)``, padded with ``-inf`` / ``""`` when the
        store holds fewer than ``top_k`` rows (the brute force's contract)."""
        if not self._built:
            self.build()
        q = self._check_queries(q)
        n = q.shape[0]
        out_scores = np.full((n, self.top_k), -np.inf, np.float32)
        out_keys = np.full((n, self.top_k), "", dtype=object)
        if n == 0:
            return out_scores, out_keys
        reg = tracing.registry()
        reg.counter("search/query_total").inc()
        reg.counter("search/query_rows_total").inc(n)
        chunks = self._chunked_queries(q)
        for seg in self._segments:
            if not self.resident:
                seg = self._put_segment(seg)
            out_scores, out_keys = self._scan_segment(seg, chunks, out_scores, out_keys)
        return out_scores, out_keys

    def _chunked_queries(self, q: np.ndarray) -> list[tuple[int, torch.Tensor]]:
        """Every chunk of ``query_batch`` rows padded and on the device up
        front, so the segments can be the outer loop."""
        chunks = []
        for start in range(0, q.shape[0], self.query_batch):
            chunk = q[start:start + self.query_batch]
            m = chunk.shape[0]
            if m < self.query_batch:
                chunk = np.concatenate([chunk, np.repeat(chunk[-1:], self.query_batch - m,
                                                         axis=0)])
            chunks.append((m, torch.from_numpy(chunk).to(self.device)))
        return chunks

    def _scan_segment(self, seg: tuple, chunks, out_scores: np.ndarray,
                      out_keys: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Every query chunk against one placed segment; the segment's
        [n, K] table crosses to the host once and merges into the answer."""
        feats, valid, keys, _ = seg
        k = min(self.top_k, self.segment_rows)
        parts = [topk(feats, valid, chunk, k, self.normalize_queries) for _, chunk in chunks]
        scores = torch.cat([s[:m] for (m, _), (s, _) in zip(chunks, parts)]).cpu().numpy()
        idx = torch.cat([i[:m] for (m, _), (_, i) in zip(chunks, parts)]).cpu().numpy()
        tracing.registry().counter("search/segments_scanned_total").inc(len(chunks))
        # pad hits (score -inf) keep key "": invisible after the merge
        seg_keys = np.where(np.isneginf(scores), "", keys[idx])
        return merge_topk(out_scores, out_keys, scores, seg_keys)

    def query_rows(self, q: np.ndarray, feats: np.ndarray,
                   keys: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Top-k of ``q`` against ad-hoc rows (the live tier's WAL tail)
        through the same :func:`topk` and segment padding as the store's
        rows, following the engine's normalisation; callers merge the result
        with :meth:`query`'s through :func:`merge_topk`."""
        if not self._built:
            self.build()
        q = self._check_queries(q)
        feats = np.asarray(feats, np.float32)
        keys_arr = np.asarray(keys, dtype=object)
        if feats.ndim != 2 or feats.shape[1] != self.reader.embed_dim:
            raise ValueError(
                f"tail rows must be [n, {self.reader.embed_dim}], got {feats.shape}")
        if len(keys_arr) != feats.shape[0]:
            raise ValueError(f"{feats.shape[0]} tail rows but {len(keys_arr)} keys")
        n = q.shape[0]
        out_scores = np.full((n, self.top_k), -np.inf, np.float32)
        out_keys = np.full((n, self.top_k), "", dtype=object)
        if n == 0 or feats.shape[0] == 0:
            return out_scores, out_keys
        if self._normalize_rows:
            feats = normalize_rows(feats)
        chunks = self._chunked_queries(q)
        for start in range(0, feats.shape[0], self.segment_rows):
            seg = self._pad_segment(feats[start:start + self.segment_rows],
                                    keys_arr[start:start + self.segment_rows])
            if not self.resident:
                seg = self._put_segment(seg)
            out_scores, out_keys = self._scan_segment(seg, chunks, out_scores, out_keys)
        return out_scores, out_keys


def open_engine(store_dir, *, mesh=None, top_k: int = 1, query_batch: int = 64,
                segment_rows: int = 0, normalize_queries: bool = False,
                normalize_rows: bool = False, warm_dir: str = "",
                device: str | torch.device = "cuda") -> ShardedTopK:
    """Reader + built engine in one call."""
    engine = ShardedTopK(
        EmbeddingStoreReader(store_dir), mesh=mesh, top_k=top_k, query_batch=query_batch,
        segment_rows=segment_rows, normalize_queries=normalize_queries,
        normalize_rows=normalize_rows, warm_dir=warm_dir, device=device)
    return engine.build()
