"""The WAL live tier: crash-safe streaming provenance ingest into the store.

Counterpart of ``dcr_tpu/search/livestore.py``, on the same on-disk format,
so a WAL that either package writes is read, recovered and compacted by the
other. Serving streams every scored generation's SSCD embedding in; each
failure the process can meet (SIGKILL, preemption, a torn write) must leave
a store that serves exactly the acked rows:

- **WAL appends**: every acked append is one sha256-framed record in a
  write-ahead-log segment, fsynced before the ack. Recovery scans segments
  front to back; the first frame that fails any check (magic, header,
  payload sha, commit marker, payload shape) marks the torn tail, which is
  truncated, counted (``ingest/torn_total``) and never served. Unacked rows
  may be lost; acked rows may not.
- **Idempotent replay**: records carry a monotonic ``seq``; the committed
  manifest records ``wal_through`` (the highest folded seq), so a crash
  after the manifest commit and before the WAL's deletion never ingests a
  row twice.
- **One writer**: the store's heartbeat writer lease
  (:class:`~dcr_tpu_torch.search.store.StoreWriterLease`); a second writer
  gets :class:`~dcr_tpu_torch.search.store.StoreLeaseHeldError`, a crashed
  one's stale lease is taken over.
- **Versioned snapshots**: compaction folds sealed WAL segments into
  committed shards through :class:`~dcr_tpu_torch.search.store.
  EmbeddingStoreWriter`'s append path, publishes ``store_manifest.v<N+1>.json``
  and flips ``CURRENT`` atomically. The flip is the commit point: a crash
  mid-compaction (``compact_crash``) leaves the previous snapshot serving and
  the WAL intact. With an ``ann/`` tier the same rows then fold into their
  inverted lists (:func:`dcr_tpu_torch.search.ann.fold_rows`).
- **Live queries**: :func:`query_live` answers from the committed snapshot
  through the top-k engine plus the WAL tail through the same engine's
  :meth:`~dcr_tpu_torch.search.shardindex.ShardedTopK.query_rows`, merged on
  the host, so a row scores the same before and after compaction and a
  recovered store is query-equal to a rebuild over the acked rows.

WAL record framing (little-endian)::

    b"DCW1" | u32 header_len | header JSON | payload (npz) | b"DCC1"
             header: {seq, rows, dim, payload_bytes, sha256, ts}
             payload: np.savez(features float32 [n, D], keys [n] str)

Fault kinds (:mod:`dcr_tpu_torch.utils.faults`): ``wal_torn@append=N`` (a
torn frame at the Nth append, not acked), ``ingest_crash@append=N`` (SIGKILL
mid-frame), ``compact_crash@seal=N`` (SIGKILL after the new manifest is
written, before the ``CURRENT`` flip).

Layout::

    <dir>/wal/wal_00000000.log    # sealed and active WAL segments
    <dir>/store_manifest.v<N>.json + CURRENT + writer.lease.json + shards
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import signal
import struct
import threading
import time
from collections import deque
from io import BytesIO
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.search import ann
from dcr_tpu_torch.search.shardindex import full_f32_matmul, merge_topk, open_engine
from dcr_tpu_torch.search.store import (CURRENT_NAME, DEFAULT_LEASE_S, DEFAULT_SHARD_ROWS,
                                        MANIFEST_NAME, EmbeddingStoreWriter, StoreError,
                                        StoreWriterLease, normalize_rows,
                                        read_store_manifest, snapshot_version)
from dcr_tpu_torch.utils import faults

log = logging.getLogger("dcr_tpu_torch")

WAL_DIR = "wal"
RECORD_MAGIC = b"DCW1"
COMMIT_MAGIC = b"DCC1"
_U32 = struct.Struct("<I")
#: rows per WAL segment before the active segment seals
DEFAULT_SEAL_ROWS = 4096


def _segment_name(index: int) -> str:
    return f"wal_{int(index):08d}.log"


def _wal_dir(store_dir: str | Path) -> Path:
    return Path(store_dir) / WAL_DIR


def _has_committed(store_dir: Path) -> bool:
    return (store_dir / MANIFEST_NAME).exists() or (store_dir / CURRENT_NAME).exists()


def _encode_record(seq: int, features: np.ndarray, keys: np.ndarray) -> bytes:
    buf = BytesIO()
    np.savez(buf, features=features, keys=keys)
    payload = buf.getvalue()
    header = json.dumps(
        {"seq": int(seq), "rows": int(features.shape[0]),
         "dim": int(features.shape[1]), "payload_bytes": len(payload),
         "sha256": hashlib.sha256(payload).hexdigest(), "ts": time.time()},
        sort_keys=True).encode("utf-8")
    return RECORD_MAGIC + _U32.pack(len(header)) + header + payload + COMMIT_MAGIC


def scan_wal_bytes(data: bytes) -> tuple[list[tuple[int, np.ndarray, np.ndarray]], int]:
    """Parse committed records off the front of one WAL segment.

    Returns ``(records, good_end)``: ``records`` is ``[(seq, features,
    keys), ...]`` and ``good_end`` the byte offset after the last fully
    verified frame. ``good_end < len(data)`` means a torn tail: every check a
    frame can fail (magic, header JSON, bounds, payload sha256, commit
    marker, payload shape) lands here, because a crashed writer can be
    interrupted between any two bytes."""
    records: list[tuple[int, np.ndarray, np.ndarray]] = []
    good_end = 0
    off = 0
    while off < len(data):
        if data[off:off + 4] != RECORD_MAGIC:
            break
        off += 4
        if off + _U32.size > len(data):
            break
        (hlen,) = _U32.unpack_from(data, off)
        off += _U32.size
        if off + hlen > len(data):
            break
        try:
            header = json.loads(data[off:off + hlen].decode("utf-8"))
            seq = int(header["seq"])
            rows = int(header["rows"])
            dim = int(header["dim"])
            payload_bytes = int(header["payload_bytes"])
            payload_sha = str(header["sha256"])
        except (ValueError, KeyError, TypeError, UnicodeDecodeError):
            break
        off += hlen
        if payload_bytes < 0 or off + payload_bytes + len(COMMIT_MAGIC) > len(data):
            break
        payload = data[off:off + payload_bytes]
        off += payload_bytes
        if data[off:off + len(COMMIT_MAGIC)] != COMMIT_MAGIC:
            break
        off += len(COMMIT_MAGIC)
        if hashlib.sha256(payload).hexdigest() != payload_sha:
            break
        try:
            with np.load(BytesIO(payload), allow_pickle=False) as z:
                feats = np.asarray(z["features"], np.float32)
                keys = np.asarray(z["keys"], dtype=str)
        except Exception:  # any damage np.load can meet in the bytes
            break
        if (feats.ndim != 2 or feats.shape != (rows, dim) or len(keys) != rows
                or not np.isfinite(feats).all()):
            break
        records.append((seq, feats, keys))
        good_end = off
    return records, good_end


def load_wal_tail(store_dir: str | Path, *, after_seq: Optional[int] = None,
                  embed_dim: Optional[int] = None) -> tuple[np.ndarray, np.ndarray, dict]:
    """Read-only scan of the WAL tail: every committed record with ``seq >
    after_seq`` across all segments (``after_seq`` defaults to the committed
    manifest's ``wal_through``). For readers that do not hold the writer
    lease (``query --live``, ``stats``, inspection after a crash): it never
    truncates and counts no recovery, which is :meth:`LiveStore.open`'s job.
    Returns ``(features [n, D], keys [n], stats)`` with ``stats = {records,
    rows, torn_segments}``."""
    store_dir = Path(store_dir)
    if after_seq is None:
        try:
            after_seq = int(read_store_manifest(store_dir, quarantine=False)
                            .get("wal_through", 0))
        except StoreError:
            after_seq = 0
    feats_parts: list[np.ndarray] = []
    key_parts: list[np.ndarray] = []
    records = torn = 0
    dim = embed_dim
    wal = _wal_dir(store_dir)
    for path in sorted(wal.glob("wal_*.log")) if wal.is_dir() else []:
        data = path.read_bytes()
        segment_records, good_end = scan_wal_bytes(data)
        if good_end < len(data):
            torn += 1
        for seq, f, k in segment_records:
            if seq <= after_seq:
                continue
            records += 1
            dim = f.shape[1]
            feats_parts.append(f)
            key_parts.append(np.asarray(k, dtype=object))
    if not feats_parts:
        return (np.zeros((0, int(dim or 0)), np.float32), np.zeros((0,), dtype=object),
                {"records": 0, "rows": 0, "torn_segments": torn})
    feats = np.concatenate(feats_parts)
    return feats, np.concatenate(key_parts), {"records": records, "rows": int(feats.shape[0]),
                                              "torn_segments": torn}


class LiveStore:
    """WAL-backed live tier in front of a committed embedding store.

    Open with :meth:`open` (takes the writer lease, recovers the WAL);
    :meth:`append` is a synchronous acked write; :meth:`compact` folds the
    sealed WAL into committed shards and publishes the next snapshot;
    :meth:`tail` serves the unfolded rows to live queries. One writer per
    store: a second open raises
    :class:`~dcr_tpu_torch.search.store.StoreLeaseHeldError`.
    """

    #: the window of the store-growth gauge
    GROWTH_WINDOW_S = 60.0

    def __init__(self, store_dir: str | Path, lease: StoreWriterLease, *,
                 embed_dim: Optional[int] = None, seal_rows: int = DEFAULT_SEAL_ROWS):
        self.dir = Path(store_dir)
        self.seal_rows = max(1, int(seal_rows))
        self.embed_dim = embed_dim
        self._lease = lease
        self._mu = threading.Lock()
        # unfolded rows, ascending seq: [(seq, features [n, D], keys [n])]
        self._tail: list[tuple[int, np.ndarray, np.ndarray]] = []
        self._tail_rows = 0
        self._next_seq = 1
        self._wal_through = 0
        self._active_index = 0
        self._active_rows = 0
        self._active_file = None
        self._append_count = 0
        self._compact_count = 0
        # lag and growth bookkeeping: the ack time of each unfolded seq
        # (recovered rows get the recovery time) and a sliding window of
        # (ts, rows) for the growth-rate gauge
        self._seq_ts: dict[int, float] = {}
        self._growth: deque = deque()
        self.committed_total = 0
        self.snapshot = 0
        self.recovered_rows = 0
        self.torn_segments = 0
        self.closed = False

    # -- construction --------------------------------------------------------

    @classmethod
    def open(cls, store_dir: str | Path, *, embed_dim: Optional[int] = None,
             seal_rows: int = DEFAULT_SEAL_ROWS, lease_s: float = DEFAULT_LEASE_S, owner: str = "") -> "LiveStore":
        """Acquire the writer lease and recover: truncate torn WAL tails
        (counted, never served), reload acked but unfolded rows, delete
        fully folded segments and resume the sequence counter."""
        store_dir = Path(store_dir)
        lease = StoreWriterLease(store_dir, owner=owner, lease_s=lease_s).acquire()
        try:
            live = cls(store_dir, lease, embed_dim=embed_dim, seal_rows=seal_rows)
            live._recover()
            return live
        except BaseException:
            lease.release()
            raise

    def _recover(self) -> None:
        _wal_dir(self.dir).mkdir(parents=True, exist_ok=True)
        if _has_committed(self.dir):
            committed = read_store_manifest(self.dir)
            dim = int(committed["embed_dim"])
            if self.embed_dim is not None and int(self.embed_dim) != dim:
                raise StoreError(f"live store width {self.embed_dim} != committed store "
                                 f"width {dim}")
            self.embed_dim = dim
            self.committed_total = int(committed["total"])
            self.snapshot = int(committed.get("snapshot", 0))
            self._wal_through = int(committed.get("wal_through", 0))
            if bool(committed.get("normalized", False)):
                raise StoreError(
                    "live ingest requires a store built without ingest normalization "
                    "(normalized=True folds rows it cannot reproduce from raw embeddings)")
        max_seq = self._wal_through
        max_index = -1
        rows = torn = segments = 0
        t0 = time.monotonic()
        for path in sorted(_wal_dir(self.dir).glob("wal_*.log")):
            segments += 1
            try:
                max_index = max(max_index, int(path.stem.split("_", 1)[1]))
            except ValueError:
                pass
            data = path.read_bytes()
            records, good_end = scan_wal_bytes(data)
            if good_end < len(data):
                torn += 1
                lost = len(data) - good_end
                R.log_event("wal_torn_tail", segment=str(path), kept_records=len(records),
                            truncated_bytes=lost)
                log.warning("livestore %s: torn WAL tail in %s — truncating %d byte(s) after "
                            "%d committed record(s)", self.dir, path.name, lost, len(records))
                if good_end == 0:
                    path.unlink()
                else:
                    with open(path, "r+b") as f:
                        f.truncate(good_end)
            kept = [(seq, f, k) for seq, f, k in records if seq > self._wal_through]
            if records and not kept and good_end == len(data):
                # every record already folded into the committed store: the
                # segment survived a crash between the manifest commit and
                # its deletion; finish the deletion now
                path.unlink()
            for seq, feats, keys in kept:
                max_seq = max(max_seq, seq)
                if self.embed_dim is None:
                    self.embed_dim = int(feats.shape[1])
                if int(feats.shape[1]) != int(self.embed_dim):
                    raise StoreError(f"WAL record width {feats.shape[1]} != store width "
                                     f"{self.embed_dim}")
                self._tail.append((seq, feats, np.asarray(keys, dtype=object)))
                rows += feats.shape[0]
            if records:
                max_seq = max(max_seq, max(seq for seq, _, _ in records))
        self._tail.sort(key=lambda r: r[0])
        self._tail_rows = rows
        self._next_seq = max_seq + 1
        self._active_index = max_index + 1
        self.recovered_rows = rows
        self.torn_segments = torn
        reg = tracing.registry()
        if rows:
            reg.counter("ingest/recovered_total").inc(rows)
        if torn:
            reg.counter("ingest/torn_total").inc(torn)
        now = time.time()
        for seq, _, _ in self._tail:
            self._seq_ts[seq] = now
        self._update_lag_gauges_locked()
        if rows or torn:
            log.info("livestore %s: recovered %d row(s) from %d segment(s), %d torn, next seq "
                     "%d (%.3f ms)", self.dir, rows, segments, torn, self._next_seq,
                     1e3 * (time.monotonic() - t0))

    # -- properties ----------------------------------------------------------

    @property
    def tail_rows(self) -> int:
        """Unpruned in-memory tail rows (may include folded rows kept for
        readers still on the previous snapshot)."""
        return self._tail_rows

    @property
    def total_rows(self) -> int:
        """Committed rows plus unfolded live rows: the queryable corpus."""
        unfolded = sum(f.shape[0] for seq, f, _ in self._tail if seq > self._wal_through)
        return self.committed_total + unfolded

    @property
    def wal_through(self) -> int:
        return self._wal_through

    @property
    def next_seq(self) -> int:
        return self._next_seq

    def report(self) -> dict:
        return {"store": str(self.dir), "snapshot": self.snapshot,
                "committed_rows": self.committed_total, "tail_rows": self.tail_rows,
                "total_rows": self.total_rows, "recovered_rows": self.recovered_rows,
                "torn_segments": self.torn_segments, "wal_through": self._wal_through,
                "next_seq": self._next_seq}

    # -- append (the acked write path) ---------------------------------------

    def _open_active(self):
        if self._active_file is None:
            path = _wal_dir(self.dir) / _segment_name(self._active_index)
            self._active_file = open(path, "ab")
        return self._active_file

    def _roll(self) -> None:
        if self._active_file is not None:
            self._active_file.close()
            self._active_file = None
        self._active_index += 1
        self._active_rows = 0

    def append(self, features: np.ndarray, keys: Sequence[str]) -> int:
        """Durably append one batch of rows; returns the record's ``seq``
        once it is fsynced (the ack). A bad batch is rejected before any
        bytes land, with the committed writer's checks."""
        if self.closed:
            raise StoreError(f"live store {self.dir} is closed")
        features = np.asarray(features, np.float32)
        if features.ndim != 2:
            raise StoreError(f"features must be [N, D], got shape {features.shape}")
        if len(keys) != features.shape[0]:
            raise StoreError(f"{features.shape[0]} features but {len(keys)} keys — torn input")
        if features.shape[0] == 0:
            raise StoreError("empty append")
        if self.embed_dim is None:
            self.embed_dim = int(features.shape[1])
        if features.shape[1] != self.embed_dim:
            raise StoreError(f"embedding width {features.shape[1]} != store width "
                             f"{self.embed_dim}")
        if not np.isfinite(features).all():
            raise StoreError("input features contain non-finite values")
        keys_arr = np.asarray([str(k) for k in keys], dtype=str)
        n = int(features.shape[0])
        with self._mu:
            ac = self._append_count
            self._append_count += 1
            seq = self._next_seq
            blob = _encode_record(seq, features, keys_arr)
            f = self._open_active()
            if faults.fire("wal_torn", append=ac):
                # a torn frame as a crash mid-write leaves it: half the
                # bytes, no commit marker, never acked; the active segment
                # is abandoned so later appends stay recoverable behind it
                f.write(blob[:max(8, len(blob) // 2)])
                f.flush()
                os.fsync(f.fileno())
                self._roll()
                raise StoreError(f"injected wal_torn fault at append {ac} — torn frame "
                                 "written, record not acked")
            if faults.fire("ingest_crash", append=ac):
                f.write(blob[:max(8, len(blob) // 2)])
                f.flush()
                os.fsync(f.fileno())
                os.kill(os.getpid(), signal.SIGKILL)
            f.write(blob)
            f.flush()
            os.fsync(f.fileno())
            self._next_seq = seq + 1
            self._tail.append((seq, features, np.asarray(keys_arr, dtype=object)))
            self._tail_rows += n
            self._active_rows += n
            now = time.time()
            self._seq_ts[seq] = now
            self._growth.append((now, n))
            tracing.registry().counter("ingest/acked_total").inc(n)
            self._update_lag_gauges_locked()
            if self._active_rows >= self.seal_rows:
                self._roll()
        return seq

    # -- compaction (WAL -> committed shards -> next snapshot) ---------------

    def compact(self, *, prune: bool = True) -> dict:
        """Fold every sealed WAL row into committed shards through the
        store's append path, publish snapshot v+1 (the manifest, then the
        atomic ``CURRENT`` flip, the commit point), then delete the folded
        segments. A crash before the flip leaves the previous snapshot
        serving and the WAL replayable; a crash after it leaves a WAL whose
        rows ``wal_through`` already excludes.

        ``prune=False`` keeps folded rows in the in-memory tail, so readers
        still paired with the previous snapshot keep a complete view; the
        caller prunes (:meth:`prune`) after refreshing its engines."""
        if self.closed:
            raise StoreError(f"live store {self.dir} is closed")
        with self._mu:
            if self._active_rows:
                self._roll()
            elif self._active_file is not None:
                self._active_file.close()
                self._active_file = None
            cc = self._compact_count
            self._compact_count += 1
            folds = [(seq, f, k) for seq, f, k in self._tail if seq > self._wal_through]
            if not folds:
                return {"folded_rows": 0, "records": 0, "snapshot": self.snapshot,
                        "ann_lists_folded": 0}
            folded_files = sorted(p for p in _wal_dir(self.dir).glob("wal_*.log")
                                  if p.name != _segment_name(self._active_index))
            rows = sum(f.shape[0] for _, f, _ in folds)
            last_seq = folds[-1][0]
            t0 = time.monotonic()
            if _has_committed(self.dir):
                writer = EmbeddingStoreWriter.append(self.dir, lease=self._lease)
            else:
                writer = EmbeddingStoreWriter(self.dir, embed_dim=self.embed_dim,
                                              shard_rows=DEFAULT_SHARD_ROWS,
                                              lease=self._lease)
            writer.mark_live()
            for _, feats, keys in folds:
                writer.add(feats, [str(k) for k in keys])
            writer.mark_wal_through(last_seq)

            def pre_current():
                # die after the new manifest is on disk but before the
                # CURRENT flip: the previous snapshot must keep serving
                if faults.fire("compact_crash", seal=cc):
                    os.kill(os.getpid(), signal.SIGKILL)

            manifest = writer.finalize(_pre_current=pre_current)
            self.committed_total = writer._total
            self._wal_through = last_seq
            self.snapshot = snapshot_version(self.dir)
            store_s = time.monotonic() - t0
            # the same rows fold into their inverted lists; only the lists
            # they touch are rewritten. The store commit above comes first,
            # so a damaged list can always be rebuilt from the store: a
            # folded row is never in the ann tier alone. A failed fold is
            # counted and logged (the tier lags this snapshot; the exact
            # path and the next fold are unaffected), never a failed
            # compaction
            ann_folded = 0
            if ann.has_ann_index(self.dir):
                try:
                    fold_feats = np.concatenate([f for _, f, _ in folds])
                    fold_keys = np.concatenate(
                        [np.asarray([str(k) for k in ks], dtype=object) for _, _, ks in folds])
                    ann_folded = int(ann.fold_rows(self.dir, fold_feats,
                                                   fold_keys)["lists_rewritten"])
                except (StoreError, OSError) as e:
                    R.log_event("ann_fold_failed", error=repr(e), rows=rows)
                    tracing.registry().counter("ann/fold_failed").inc()
                    log.warning("compact: ann fold failed (%r) — the ann tier lags this "
                                "snapshot", e)
            for path in folded_files:
                try:
                    path.unlink()
                except OSError:
                    pass
            seconds = time.monotonic() - t0
            log.info("livestore %s: compacted %d row(s) in %d record(s) into snapshot v%d "
                     "(wal_through %d; %.3f s, %.3f s of it the store commit; %d ann "
                     "list(s) folded)", self.dir, rows, len(folds), self.snapshot, last_seq,
                     seconds, store_s, ann_folded)
            if prune:
                self._prune_locked(last_seq)
            self._update_lag_gauges_locked()
            return {"folded_rows": rows, "records": len(folds), "snapshot": self.snapshot,
                    "wal_through": last_seq, "manifest": str(manifest),
                    "ann_lists_folded": ann_folded,
                    "wal_segments_deleted": len(folded_files)}

    def _prune_locked(self, through_seq: int) -> None:
        kept = [(seq, f, k) for seq, f, k in self._tail if seq > through_seq]
        self._tail = kept
        self._tail_rows = sum(f.shape[0] for _, f, _ in kept)
        self._seq_ts = {seq: ts for seq, ts in self._seq_ts.items() if seq > through_seq}

    def prune(self) -> None:
        """Drop folded rows from the in-memory tail once no reader needs
        the previous snapshot (see :meth:`compact` ``prune=False``)."""
        with self._mu:
            self._prune_locked(self._wal_through)

    # -- lag and growth gauges -----------------------------------------------

    def _update_lag_gauges_locked(self) -> None:
        """Refresh the ingest-lag, store-growth and staleness gauges. The
        caller holds ``_mu`` or is single-threaded (recovery). O(tail
        records), no I/O."""
        now = time.time()
        while self._growth and self._growth[0][0] < now - self.GROWTH_WINDOW_S:
            self._growth.popleft()
        unfolded_ts = [ts for seq, ts in self._seq_ts.items() if seq > self._wal_through]
        unfolded_rows = sum(f.shape[0] for seq, f, _ in self._tail if seq > self._wal_through)
        reg = tracing.registry()
        reg.gauge("store/rows_total").set(self.committed_total + unfolded_rows)
        reg.gauge("ingest/backlog_rows").set(unfolded_rows)
        reg.gauge("ingest/lag_seqs").set(max(0, self._next_seq - 1 - self._wal_through))
        reg.gauge("ingest/oldest_unfolded_age_s").set(
            round(now - min(unfolded_ts), 3) if unfolded_ts else 0.0)
        reg.gauge("store/growth_rows_per_s").set(
            round(sum(n for _, n in self._growth) / self.GROWTH_WINDOW_S, 4))

    def update_lag_gauges(self) -> None:
        """The ingest pump calls this on idle ticks, so the age gauge keeps
        aging (and the growth gauge decaying) between appends."""
        with self._mu:
            self._update_lag_gauges_locked()

    # -- live reads ----------------------------------------------------------

    def tail(self, after_seq: Optional[int] = None) -> tuple[np.ndarray, np.ndarray]:
        """The acked rows newer than ``after_seq`` (default: this writer's
        ``wal_through``) as ``(features [n, D], keys [n])``. A reader paired
        with snapshot v passes v's ``wal_through``, so committed plus tail is
        one consistent corpus: no row twice, none missing."""
        after = self._wal_through if after_seq is None else int(after_seq)
        with self._mu:
            parts = [(f, k) for seq, f, k in self._tail if seq > after]
        if not parts:
            return (np.zeros((0, int(self.embed_dim or 0)), np.float32),
                    np.zeros((0,), dtype=object))
        return np.concatenate([f for f, _ in parts]), np.concatenate([k for _, k in parts])

    # -- lifecycle -----------------------------------------------------------

    def close(self) -> None:
        """Flush and close the active segment and release the writer lease.
        Close deletes no WAL row: it is not compaction."""
        if self.closed:
            return
        self.closed = True
        with self._mu:
            if self._active_file is not None:
                self._active_file.flush()
                os.fsync(self._active_file.fileno())
                self._active_file.close()
                self._active_file = None
        self._lease.release()

    def __enter__(self) -> "LiveStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


# ---------------------------------------------------------------------------
# Live queries: the committed snapshot's engine plus the WAL tail, merged
# ---------------------------------------------------------------------------

def _host_topk(q: np.ndarray, feats: np.ndarray, keys: np.ndarray, *, top_k: int,
               normalize_queries: bool, normalize_tail_rows: bool,
               device: torch.device) -> tuple[np.ndarray, np.ndarray]:
    """Top-k over the tail alone (no committed snapshot yet): the matmul on
    the device in full f32, the selection on the host (``argpartition``, then
    a stable sort), as the JAX package's ``_host_topk`` does."""
    if normalize_tail_rows:
        feats = normalize_rows(feats)
    if normalize_queries:
        q = normalize_rows(q)
    with full_f32_matmul():
        sims = (torch.from_numpy(np.ascontiguousarray(q, np.float32)).to(device)
                @ torch.from_numpy(np.ascontiguousarray(feats, np.float32)).to(device).T)
    sims = sims.cpu().numpy()
    k = min(top_k, sims.shape[1])
    top_idx = np.argpartition(-sims, k - 1, axis=1)[:, :k]
    top_scores = np.take_along_axis(sims, top_idx, axis=1)
    order = np.argsort(-top_scores, axis=1, kind="stable")
    top_idx = np.take_along_axis(top_idx, order, axis=1)
    top_scores = np.take_along_axis(top_scores, order, axis=1)
    out_keys = np.asarray(keys, dtype=object)[top_idx]
    if k < top_k:
        pad = top_k - k
        top_scores = np.pad(top_scores, ((0, 0), (0, pad)), constant_values=-np.inf)
        out_keys = np.concatenate(
            [out_keys, np.full((out_keys.shape[0], pad), "", dtype=object)], axis=1)
    return top_scores.astype(np.float32), out_keys


def query_live(store_dir: str | Path, queries: np.ndarray, *, top_k: int = 1, mesh=None,
               query_batch: int = 64, segment_rows: int = 0, normalize_queries: bool = False,
               normalize_rows: bool = False, engine=None,
               tail: Optional[tuple[np.ndarray, np.ndarray]] = None,
               device: str | torch.device = "cuda") -> tuple[np.ndarray, np.ndarray]:
    """Top-k against the live corpus: the committed snapshot through the
    top-k engine plus the WAL tail through the same engine's ``query_rows``,
    merged on the host. ``engine`` reuses a built engine, exact or IVF (the
    search stage's ``--ann``, the risk index); ``tail`` serves an in-memory
    tail (the ingesting worker's). Otherwise both come from disk, the tail
    read-only and paired with the engine snapshot's ``wal_through``, so no
    row is seen twice or missed. With ``mesh`` the engine it opens shards
    the committed rows over the mesh's ranks; the tail is merged on the host
    alike on every rank, so every rank returns the same answer."""
    q = np.asarray(queries, np.float32)
    store_dir = Path(store_dir)
    if engine is None and _has_committed(store_dir):
        engine = open_engine(store_dir, mesh=mesh, top_k=top_k, query_batch=query_batch,
                             segment_rows=segment_rows, normalize_queries=normalize_queries,
                             normalize_rows=normalize_rows, device=device)
    after = engine.reader.wal_through if engine is not None else 0
    if tail is None:
        tail_feats, tail_keys, _ = load_wal_tail(
            store_dir, after_seq=after,
            embed_dim=engine.reader.embed_dim if engine is not None else None)
    else:
        tail_feats, tail_keys = tail
    if engine is None and not len(tail_feats):
        raise StoreError(f"{store_dir} has neither a committed snapshot nor WAL rows — "
                         "nothing to query")
    if engine is None:
        return _host_topk(q, tail_feats, tail_keys, top_k=top_k,
                          normalize_queries=normalize_queries,
                          normalize_tail_rows=normalize_rows, device=resolve_device(device))
    scores, keys = engine.query(q)
    if len(tail_feats):
        tail_scores, tail_out = engine.query_rows(q, tail_feats, tail_keys)
        scores, keys = merge_topk(scores, keys, tail_scores, tail_out)
    return scores, keys
