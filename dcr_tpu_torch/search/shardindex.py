"""The top-k engine over an embedding store, on one device or a mesh of ranks.

Counterpart of ``dcr_tpu/search/shardindex.py``. The store's shards regroup
into fixed segments of ``segment_rows`` rows (the last padded, its pad rows
masked to ``-inf`` with key ``""``); :func:`topk` scores a batch of queries
against one segment on the device (one matmul, the pad mask, ``torch.topk``,
as ``make_topk`` at ``dcr_tpu/search/shardindex.py:59-81``) and the [B, K]
tables of the segments merge on the host: K rows per query and segment
cross to the host, not the segment's similarities.

On a mesh (``mesh=``, one process per device) the rows of each segment
split over the ``data`` x ``fsdp`` ranks as the JAX engine shards them
(``P((data, fsdp))``, ``:190-232``): ``segment_rows`` is padded up to a
multiple of the rank count, exactly as in JAX, and rank i holds slab i of
every segment. Each rank reads from the store only the shards that hold its
slabs (the ranks agree on the shards that fail verification, and lay the
rows out over the survivors), scores its slabs, and keeps its own top-k
with each candidate's global row. One exchange per query call
(:func:`~dcr_tpu_torch.parallel.mesh.exchange_topk`) merges the ranks'
tables in the one-device order: score descending, the lower global row
first on equal scores, as ``lax.top_k`` over the whole segment orders them.
Every rank returns the same ``(scores, keys)``. The ``tensor`` and ``seq``
replicas hold the same slabs. Ad-hoc rows (the live tier's WAL tail,
:meth:`ShardedTopK.query_rows`) are few and scanned whole on every rank.

A store of up to ``max_resident_rows`` rows (the store's total, on a mesh
too) stays on the device between queries. A larger one keeps its slabs on
the host (pinned when the device is a GPU) and uploads each once per
:meth:`ShardedTopK.query`, segments outermost, as the JAX engine streams
them (``:269-272``). Queries run in chunks of ``query_batch`` rows, the last
padded with copies of its last row, so a query's scores do not depend on the
rows it is batched with.

The matmuls run in full f32 whatever the global flags say (TF32 would move
scores by ~1e-3 relative and change neighbours). No two f32 paths are
bit-equal (the card against the CPU, the store against the brute force, the
port against JAX: cuBLAS and XLA round differently for different shapes);
results agree to within f32 rounding, and keys agree wherever the scores are
not near-ties. The engine launches no native kernel, so the warm cache
(``core/warmcache.py``) has nothing of its own to hold.
"""

from __future__ import annotations

import logging
import time
from contextlib import contextmanager
from typing import Iterator, Sequence

import numpy as np
import torch

from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.parallel import mesh as pmesh
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


@compile_surface("search/topk")
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


def check_mesh(mesh) -> None:
    if mesh is not None and not isinstance(mesh, pmesh.Mesh):
        raise TypeError(f"mesh must be a dcr_tpu_torch.parallel.mesh.Mesh (make_mesh), "
                        f"got {type(mesh).__name__}")


class ShardedTopK:
    """Top-k over an :class:`EmbeddingStoreReader`, on one device or over a
    mesh's ``data`` x ``fsdp`` ranks (module docstring).

    :meth:`build` loads and verifies the rank's rows, regroups them into
    segments and places them (on the device when the store fits under
    ``max_resident_rows``); :meth:`query` then answers any number of
    queries. ``normalize_rows`` L2-normalises the store's rows as they load.
    """

    def __init__(self, reader: EmbeddingStoreReader, *, mesh=None,
                 top_k: int = 1, query_batch: int = 64,
                 segment_rows: int = 0,
                 max_resident_rows: int = DEFAULT_MAX_RESIDENT_ROWS,
                 normalize_queries: bool = False,
                 normalize_rows: bool = False,
                 device: str | torch.device = "cuda"):
        check_mesh(mesh)
        self.reader = reader
        self.mesh = mesh
        self.device = resolve_device(device)
        self.top_k = max(1, int(top_k))
        self.query_batch = max(1, int(query_batch))
        self.normalize_queries = bool(normalize_queries)
        want = int(segment_rows) if segment_rows > 0 else min(
            max(1, reader.total), DEFAULT_SEGMENT_ROWS)
        # K can never exceed the segment; the segment splits over the ranks
        self.slabs = pmesh.Slabs.of(max(want, self.top_k), mesh)
        self.segment_rows = self.slabs.segment_rows
        self.resident = reader.total <= max(max_resident_rows, self.segment_rows)
        # this rank's slab of each segment: (features [slabs.rows, D], valid
        # [slabs.rows], keys [slabs.rows] object ""-padded, n_rows, first
        # global row); on the device when resident, on the host otherwise
        self._segments: list[tuple] = []
        self.num_segments = 0
        self._normalize_rows = bool(normalize_rows)
        #: build's store read: seconds, shards read and rows held by this rank
        self.build_s = 0.0
        self.shards_read = 0
        self.rows_held = 0
        self._built = False

    @property
    def total(self) -> int:
        return self.reader.total

    # -- construction --------------------------------------------------------

    def _load(self) -> tuple[list[int], dict[int, tuple]]:
        """The surviving shards (manifest positions) and this rank's loaded
        ones. Each rank verifies the shards it needs; a shard that fails on
        any rank drops out of every rank's layout, and the shards the new
        layout needs are read."""
        shards = self.reader.shards
        dead: set[int] = set()
        cache: dict[int, tuple] = {}
        while True:
            live = [i for i in range(len(shards)) if i not in dead]
            counts = [int(shards[i].get("count", 0)) for i in live]
            offsets = np.cumsum([0] + counts)
            failed = set()
            for j, i in enumerate(live):
                if i in cache or not counts[j] or not self.slabs.meets(
                        int(offsets[j]), int(offsets[j + 1]), int(offsets[-1])):
                    continue
                arrays = self.reader.load_shard(i)
                if arrays is None:
                    failed.add(i)
                else:
                    cache[i] = arrays
                    self.shards_read += 1
            failed = pmesh.union_over_ranks(failed, "store_shards", self.mesh)
            if not failed:
                break
            dead |= failed
            for i in failed:
                cache.pop(i, None)
        if shards and len(dead) == len(shards):
            raise StoreError(f"store {self.reader.dir}: no shard survived verification "
                             f"({len(shards)} listed)")
        return live, cache

    def _pad_segment(self, feats: np.ndarray, keys: np.ndarray, size: int,
                     first_row: int) -> tuple:
        n, dim = feats.shape[0], self.reader.embed_dim
        # a streamed segment waits in pinned memory for its uploads
        pin = self.device.type == "cuda" and not self.resident
        padded = torch.zeros((size, dim), dtype=torch.float32, pin_memory=pin)
        padded[:n] = torch.from_numpy(np.ascontiguousarray(feats, np.float32))
        valid = torch.zeros((size,), dtype=torch.bool, pin_memory=pin)
        valid[:n] = True
        if n < size:
            keys = np.concatenate([keys, np.full((size - n,), "", dtype=object)])
        if self.resident:
            return padded.to(self.device), valid.to(self.device), keys, n, first_row
        return padded, valid, keys, n, first_row

    def build(self) -> "ShardedTopK":
        """Load, verify and place this rank's slabs. Idempotent."""
        if self._built:
            return self
        t0 = time.perf_counter()
        live, cache = self._load()
        shards = self.reader.shards
        counts = [int(shards[i].get("count", 0)) for i in live]
        offsets = np.cumsum([0] + counts)
        total = int(offsets[-1])
        if total == 0:
            raise StoreError(f"store {self.reader.dir} holds no rows")
        self.num_segments = -(-total // self.segment_rows)
        self._segments, self.rows_held = [], 0
        j = 0  # the first live shard that may still hold rows of a later slab
        for seg in range(self.num_segments):
            lo, hi = self.slabs.slab(seg, total)
            if hi <= lo:
                continue
            feats, keys = [], []
            while offsets[j + 1] <= lo:
                j += 1
            jj = j
            while jj < len(live) and offsets[jj] < hi:
                f, k = cache[live[jj]]
                a = max(lo, offsets[jj]) - offsets[jj]
                e = min(hi, offsets[jj + 1]) - offsets[jj]
                f = f[a:e]
                feats.append(normalize_rows(f) if self._normalize_rows else f)
                keys.append(np.asarray(k[a:e], dtype=object))
                if offsets[jj + 1] <= hi:  # no later slab of this rank reads it
                    cache.pop(live[jj], None)
                jj += 1
            self._segments.append(self._pad_segment(np.concatenate(feats),
                                                    np.concatenate(keys), self.slabs.rows, lo))
            self.rows_held += hi - lo
        self.build_s = time.perf_counter() - t0
        self._built = True
        log.info("shardindex: ready — %d rows in %d segment(s) of %d (top_k=%d, batch=%d, "
                 "%s, %s%s)", self.reader.total, self.num_segments, self.segment_rows,
                 min(self.top_k, self.segment_rows), self.query_batch,
                 "device-resident" if self.resident else "host-streamed", self.device,
                 "" if self.mesh is None else
                 f"; rank slab {self.slabs.index}/{self.slabs.parts}: {self.rows_held} rows "
                 f"from {self.shards_read} shard(s)")
        return self

    def _put_segment(self, seg: tuple) -> tuple:
        feats, valid, *rest = seg
        return (feats.to(self.device, non_blocking=True),
                valid.to(self.device, non_blocking=True), *rest)

    # -- query ---------------------------------------------------------------

    def _check_queries(self, q: np.ndarray) -> np.ndarray:
        q = np.asarray(q, np.float32)
        if q.ndim != 2 or q.shape[1] != self.reader.embed_dim:
            raise ValueError(f"queries must be [n, {self.reader.embed_dim}], got {q.shape}")
        return q

    def _empty(self, n: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return (np.full((n, self.top_k), -np.inf, np.float32),
                np.full((n, self.top_k), -1, np.int64),
                np.full((n, self.top_k), "", dtype=object))

    def query(self, q: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """Top-k of every query row against the whole store.

        ``q`` is float32 [n, D], the same on every rank of a mesh. Returns
        ``(scores [n, top_k] descending, keys [n, top_k] object)``, padded
        with ``-inf`` / ``""`` when the store holds fewer than ``top_k``
        rows (the brute force's contract), the same on every rank."""
        if not self._built:
            self.build()
        q = self._check_queries(q)
        n = q.shape[0]
        table = self._empty(n)
        if n == 0:
            return table[0], table[2]
        reg = tracing.registry()
        reg.counter("search/query_total").inc()
        reg.counter("search/query_rows_total").inc(n)
        chunks = self._chunked_queries(q)
        for seg in self._segments:
            if not self.resident:
                seg = self._put_segment(seg)
            table = self._scan_segment(seg, chunks, *table)
        scores, _, keys = pmesh.exchange_topk(*table, self.top_k, self.mesh)
        return scores, keys

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

    def _scan_segment(self, seg: tuple, chunks, scores: np.ndarray, rows: np.ndarray,
                      keys: np.ndarray) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Every query chunk against one placed segment (or slab); its [n, k]
        table crosses to the host once and merges into the running table of
        ``(scores, global rows, keys)``."""
        feats, valid, seg_keys, _, first_row = seg
        k = min(self.top_k, feats.shape[0])
        parts = [topk(feats, valid, chunk, k, self.normalize_queries) for _, chunk in chunks]
        s = torch.cat([p[0][:m] for (m, _), p in zip(chunks, parts)]).cpu().numpy()
        idx = torch.cat([p[1][:m] for (m, _), p in zip(chunks, parts)]).cpu().numpy()
        tracing.registry().counter("search/segments_scanned_total").inc(len(chunks))
        # pad hits (score -inf) keep key "": invisible after the merge
        scores, rows, keys = pmesh.merge_candidates(
            np.concatenate([scores, s], axis=1),
            np.concatenate([rows, first_row + idx.astype(np.int64)], axis=1),
            np.concatenate([keys, np.where(np.isneginf(s), "", seg_keys[idx])], axis=1),
            self.top_k)
        return scores, rows, keys

    def query_rows(self, q: np.ndarray, feats: np.ndarray,
                   keys: Sequence[str]) -> tuple[np.ndarray, np.ndarray]:
        """Top-k of ``q`` against ad-hoc rows (the live tier's WAL tail)
        through the same :func:`topk` and ``segment_rows`` padding as the
        store's rows, following the engine's normalisation; callers merge
        the result with :meth:`query`'s through :func:`merge_topk`. On a
        mesh every rank scans the rows whole (the tail is few rows), so the
        answer is the same on each without an exchange."""
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
        table = self._empty(n)
        if n == 0 or feats.shape[0] == 0:
            return table[0], table[2]
        if self._normalize_rows:
            feats = normalize_rows(feats)
        chunks = self._chunked_queries(q)
        for start in range(0, feats.shape[0], self.segment_rows):
            seg = self._pad_segment(feats[start:start + self.segment_rows],
                                    keys_arr[start:start + self.segment_rows],
                                    self.segment_rows, start)
            if not self.resident:
                seg = self._put_segment(seg)
            table = self._scan_segment(seg, chunks, *table)
        return table[0], table[2]


def open_engine(store_dir, *, mesh=None, top_k: int = 1, query_batch: int = 64,
                segment_rows: int = 0, normalize_queries: bool = False,
                normalize_rows: bool = False,
                device: str | torch.device = "cuda") -> ShardedTopK:
    """Reader + built engine in one call."""
    engine = ShardedTopK(
        EmbeddingStoreReader(store_dir), mesh=mesh, top_k=top_k, query_batch=query_batch,
        segment_rows=segment_rows, normalize_queries=normalize_queries,
        normalize_rows=normalize_rows, device=device)
    return engine.build()
