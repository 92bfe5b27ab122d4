"""Serve-side live ingest: stream scored generations into the store.

Counterpart of ``dcr_tpu/serve/ingest.py``: the bridge between copy-risk
scoring and the WAL live tier (:mod:`dcr_tpu_torch.search.livestore`). Every
generation the worker scores already has its SSCD embedding in hand, so
:class:`IngestPump` puts ``(embedding, key)`` on a bounded queue and a
background appender thread makes it durable. The response path calls
:meth:`IngestPump.offer` and nothing else: it never blocks and never
touches the filesystem, and a full queue drops the row and counts it
(``ingest/dropped_total``), because a slow disk must cost provenance
coverage, not generation latency.

The appender owns the store's writer lease. While another process holds it
(a previous incarnation whose lease has not expired), the pump reports
``waiting_lease`` and retries until the stale lease ages out and is taken
over. Every ``compact_rows`` acked but unfolded rows it compacts
(``prune=False``), lets the worker refresh its risk engine onto the new
snapshot (``on_snapshot``), then prunes: an in-flight ``/check`` keeps the
snapshot it started with, and no row is served twice or missed.

The ``ingest_stall@row=N`` fault kind stalls the appender for
``DCR_INGEST_STALL_S`` seconds (default 30): rows are delayed, never
dropped.
"""

from __future__ import annotations

import logging
import os
import queue
import threading
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np

from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.search.livestore import DEFAULT_SEAL_ROWS, LiveStore
from dcr_tpu_torch.search.store import DEFAULT_LEASE_S, StoreError, StoreLeaseHeldError
from dcr_tpu_torch.utils import faults

log = logging.getLogger("dcr_tpu_torch")

#: default bound on the response-path queue (rows, not batches)
DEFAULT_QUEUE_MAX = 1024


class IngestPump:
    """A bounded queue that never blocks its producer, and the durable
    appender thread behind it."""

    def __init__(self, store_dir: str | Path, *, embed_dim: int = 512,
                 queue_max: int = DEFAULT_QUEUE_MAX, batch_rows: int = 16,
                 seal_rows: int = DEFAULT_SEAL_ROWS, compact_rows: int = 0,
                 lease_s: float = DEFAULT_LEASE_S, owner: str = "",
                 on_snapshot: Optional[Callable[[int], None]] = None):
        self.dir = Path(store_dir)
        self.embed_dim = int(embed_dim)
        self.batch_rows = max(1, int(batch_rows))
        self.seal_rows = int(seal_rows)
        self.compact_rows = int(compact_rows)  # 0 = never compact on its own
        self.lease_s = float(lease_s)
        self.owner = owner or f"ingest-pump.{self.dir.name}"
        self.on_snapshot = on_snapshot
        self._q: "queue.Queue[tuple[float, np.ndarray, str]]" = queue.Queue(
            maxsize=max(1, int(queue_max)))
        self._stop = threading.Event()
        self._live: Optional[LiveStore] = None
        self._thread: Optional[threading.Thread] = None
        # guards what the appender thread writes (status, counters,
        # last_error, _live) against stats() and tail(); offer() never
        # takes it
        self._stats_lock = threading.Lock()
        self.status = "starting"
        self.appended_rows = 0
        self.dropped_rows = 0
        self.compactions = 0
        self.last_error = ""

    # -- the response path: never blocks -------------------------------------

    def offer(self, features_row: np.ndarray, key: str) -> bool:
        """Queue one embedding row for a durable append. ``put_nowait``: a
        full queue drops the row and counts it, never stalls a response."""
        row = np.asarray(features_row, np.float32).reshape(-1)
        try:
            self._q.put_nowait((time.time(), row, str(key)))
        except queue.Full:
            self.dropped_rows += 1
            tracing.registry().counter("ingest/dropped_total").inc()
            return False
        tracing.registry().gauge("ingest/queue_depth").set(self._q.qsize())
        return True

    # -- the appender thread -------------------------------------------------

    def start(self) -> "IngestPump":
        self._thread = threading.Thread(target=self._run, name="ingest-pump", daemon=True)
        self._thread.start()
        return self

    def _open_with_retry(self) -> Optional[LiveStore]:
        while not self._stop.is_set():
            try:
                live = LiveStore.open(self.dir, embed_dim=self.embed_dim,
                                      seal_rows=self.seal_rows, lease_s=self.lease_s,
                                      owner=self.owner)
                with self._stats_lock:
                    self.status = "ok"
                return live
            except StoreLeaseHeldError as e:
                # another writer (likely a crashed predecessor) still holds
                # the lease: wait out its heartbeat, then take over
                with self._stats_lock:
                    self.status = "waiting_lease"
                    self.last_error = str(e)
                tracing.registry().counter("ingest/lease_wait_total").inc()
                self._stop.wait(max(0.5, self.lease_s / 4))
            except StoreError as e:
                with self._stats_lock:
                    self.status = "error"
                    self.last_error = str(e)
                log.error("ingest: cannot open live store %s: %s", self.dir, e)
                return None
        return None

    def _drain_batch(self, first) -> tuple[float, np.ndarray, list[str]]:
        items = [first]
        while len(items) < self.batch_rows:
            try:
                items.append(self._q.get_nowait())
            except queue.Empty:
                break
        return items[0][0], np.stack([row for _, row, _ in items]), [k for _, _, k in items]

    def _run(self) -> None:
        live = self._open_with_retry()
        if live is None:
            return
        with self._stats_lock:
            self._live = live
        reg = tracing.registry()
        try:
            while True:
                try:
                    first = self._q.get(timeout=0.2)
                except queue.Empty:
                    if self._stop.is_set():
                        break
                    reg.gauge("ingest/lag_seconds").set(0.0)
                    reg.gauge("ingest/queue_depth").set(0)
                    # a quiet pump with an unfolded row must still age
                    live.update_lag_gauges()
                    continue
                oldest_ts, feats, keys = self._drain_batch(first)
                if faults.fire("ingest_stall", row=self.appended_rows):
                    self._stall(reg, oldest_ts)
                try:
                    live.append(feats, keys)
                    with self._stats_lock:
                        self.appended_rows += feats.shape[0]
                except StoreError as e:
                    # the injected wal_torn frame too: not acked, the batch
                    # is lost and counted, the pump keeps pumping
                    with self._stats_lock:
                        self.last_error = str(e)
                    reg.counter("ingest/append_failed_total").inc(feats.shape[0])
                    log.warning("ingest: append failed (%d rows): %s", feats.shape[0], e)
                reg.gauge("ingest/lag_seconds").set(max(0.0, time.time() - oldest_ts))
                reg.gauge("ingest/queue_depth").set(self._q.qsize())
                if (self.compact_rows > 0
                        and live.total_rows - live.committed_total >= self.compact_rows):
                    self._compact(live)
        finally:
            with self._stats_lock:
                self._live = None
            live.close()
            with self._stats_lock:
                if self.status == "ok":
                    self.status = "stopped"

    def _stall(self, reg, oldest_ts: float) -> None:
        """The injected ``ingest_stall``: no acks for ``DCR_INGEST_STALL_S``
        seconds while the lag gauges keep reporting the truth. The batch
        appends after the stall: delayed, never dropped."""
        stall_s = float(os.environ.get("DCR_INGEST_STALL_S", "30"))
        with self._stats_lock:
            self.status = "stalled"
        log.warning("ingest: injected stall for %.1fs at row %d", stall_s, self.appended_rows)
        deadline = time.monotonic() + stall_s
        while not self._stop.is_set() and time.monotonic() < deadline:
            reg.gauge("ingest/lag_seconds").set(max(0.0, time.time() - oldest_ts))
            reg.gauge("ingest/queue_depth").set(self._q.qsize())
            self._stop.wait(0.1)
        with self._stats_lock:
            self.status = "ok"

    def _compact(self, live: LiveStore) -> None:
        try:
            report = live.compact(prune=False)
        except StoreError as e:
            with self._stats_lock:
                self.last_error = str(e)
            log.error("ingest: compaction failed: %s", e)
            return
        with self._stats_lock:
            self.compactions += 1
        if self.on_snapshot is not None:
            try:
                # the worker swaps its risk engine onto the new snapshot
                # before the prune, so no row is ever in neither the engine
                # nor the tail
                self.on_snapshot(int(report.get("snapshot", 0)))
            except Exception:
                log.exception("ingest: on_snapshot callback failed (snapshot v%s)",
                              report.get("snapshot"))
        live.prune()

    # -- introspection and lifecycle -----------------------------------------

    def stats(self) -> dict:
        with self._stats_lock:
            live = self._live
            doc = {"status": self.status, "queued": self._q.qsize(),
                   "appended_rows": self.appended_rows, "dropped_rows": self.dropped_rows,
                   "compactions": self.compactions}
            last_error = self.last_error
        if last_error:
            doc["last_error"] = last_error
        if live is not None:
            doc.update(snapshot=live.snapshot, total_rows=live.total_rows,
                       tail_rows=live.tail_rows)
        return doc

    def tail(self, after_seq: int) -> tuple[np.ndarray, np.ndarray]:
        """The live-tail provider of :class:`~dcr_tpu_torch.obs.copyrisk.
        CopyRiskIndex`: the acked rows newer than the caller's snapshot
        (empty until the store is open)."""
        with self._stats_lock:
            live = self._live
        if live is None:
            return np.zeros((0, self.embed_dim), np.float32), np.zeros((0,), dtype=object)
        return live.tail(after_seq)

    def stop(self, timeout: float = 10.0) -> None:
        """Drain and stop: the appender appends the queued backlog (every
        acked row stays durable in the WAL, and recovery replays it), then
        releases the lease."""
        self._stop.set()
        t = self._thread
        if t is not None:
            t.join(timeout=max(1.0, timeout))
        self._thread = None

    def __enter__(self) -> "IngestPump":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
