"""The sharded embedding store: manifest-keyed, sha256-verified shards.

Counterpart of ``dcr_tpu/search/store.py``, on the same on-disk format, so a
store that either package writes loads in the other. Embeddings land in
fixed-capacity shards under one manifest: a corpus of millions of vectors is
ingested once (streaming, from ``search/embed`` ``.npz`` dumps and the
reference's pickles), verified on every read, and served to the top-k
engine (:mod:`dcr_tpu_torch.search.shardindex`) segment by segment.

- Every shard is sha256-verified from its bytes before ``np.load`` (with
  ``allow_pickle=False``) touches it, then checked for shape, width, key
  count and finiteness. A damaged shard is quarantine-renamed, counted
  (``search/store_shard_corrupt``) and its rows drop out: the rest serve.
- The manifest commits last (write-to-temp, fsync, atomic rename), so a
  killed build or append leaves the previous store or the new one. Shards a
  committed manifest names are immutable; ``append`` adds shards.
- One writer per store: :class:`StoreWriterLease`, a file lease renewed by
  a heartbeat thread; a stale lease (a dead writer) is taken over, counted
  and logged. A second live writer gets :class:`StoreLeaseHeldError`.
- Versioned snapshots (``store_manifest.v<N>.json`` + an atomically renamed
  ``CURRENT`` pointer) are read, and written after :meth:`mark_live`; a
  reader re-checks the snapshot before each shard and raises the retryable
  :class:`StoreSnapshotChangedError` if it moved.

Shards are ``np.savez(features=float32 [n, D], keys=<U str [n])``. The zip
stamps its time, so the two packages write different sha256s for the same
rows; rows, keys and features are what match.

Layout::

    <dir>/store_manifest.json     # kind/version/embed_dim + per-shard shas
    <dir>/store_manifest.v2.json  # versioned snapshots ...
    <dir>/CURRENT                 # ... named by this atomic pointer
    <dir>/writer.lease.json       # single-writer heartbeat lease
    <dir>/shard_00000.npz         # features float32 [n, D], keys [n] str
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import threading
import time
from io import BytesIO
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np

from dcr_tpu_torch.core import fsio
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.fsio import quarantine_rename
from dcr_tpu_torch.utils import faults

log = logging.getLogger("dcr_tpu_torch")

STORE_VERSION = 1
STORE_KIND = "dcr_embedding_store"
MANIFEST_NAME = "store_manifest.json"
#: atomically-renamed pointer naming the live snapshot's manifest file
CURRENT_NAME = "CURRENT"
#: single-writer heartbeat lease file (StoreWriterLease)
LEASE_NAME = "writer.lease.json"
#: default writer-lease duration; a writer silent for this long is dead
DEFAULT_LEASE_S = 10.0
#: rows per shard file — the ingest/IO unit, NOT the query unit (the query
#: engine regroups shards into fixed device segments)
DEFAULT_SHARD_ROWS = 4096

_VERSIONED_RE = re.compile(r"^store_manifest\.v(\d+)\.json$")


def versioned_manifest_name(snapshot: int) -> str:
    return f"store_manifest.v{int(snapshot)}.json"


class StoreError(RuntimeError):
    """Typed: the store directory cannot serve this caller (absent/corrupt
    manifest, wrong kind/width, or no shard survived verification). The
    caller decides whether that is fatal (an explicit --store_dir) or a
    degrade (copy-risk scoring disabled)."""


class StoreLeaseHeldError(StoreError):
    """Typed: another live writer holds this store's single-writer lease.
    Concurrent builds/appends on one directory would silently interleave
    shard numbering — the second writer must wait (or the holder must die
    and its lease expire) rather than corrupt the store."""


class StoreSnapshotChangedError(StoreError):
    """Typed + retryable: the store's snapshot (``CURRENT``) moved while a
    reader was mid-iteration. Serving on would mix rows from two snapshots;
    the caller re-opens the reader against the new snapshot and retries."""

    retryable = True


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def normalize_rows(features: np.ndarray) -> np.ndarray:
    norms = np.linalg.norm(features, axis=-1, keepdims=True)
    return features / np.maximum(norms, 1e-12)


# ---------------------------------------------------------------------------
# Single-writer heartbeat lease
# ---------------------------------------------------------------------------

class StoreWriterLease:
    """File-backed single-writer lease over a store directory.

    A file, not a coordination service: the lease must survive, and be
    inspectable after, the failures it guards against (SIGKILL, OOM,
    preemption), and the JAX package's writers hold the same file. The holder
    publishes ``{pid, owner, token, renewed_at, lease_s}`` with
    write-to-temp + atomic rename and renews ``renewed_at`` from a
    heartbeat thread; a lease whose ``renewed_at`` is older than
    ``lease_s`` is stale and taken over (counted + logged — a takeover is
    always evidence of a dead writer). A malformed lease file reads as
    absent-but-loud, never as held. Acquisition is read-check-replace, not
    a kernel lock: the window is one rename against a multi-second lease,
    and both sides of a real race are visible in the journal.
    """

    def __init__(self, store_dir: str | Path, *, owner: str = "",
                 lease_s: float = DEFAULT_LEASE_S, heartbeat_s: float = 0.0):
        self.dir = Path(store_dir)
        self.path = self.dir / LEASE_NAME
        # the lease file names its writer (``train-ivf``, ``serve-worker.<pid>``)
        # as the JAX package's does
        self.owner = owner or f"pid{os.getpid()}"
        self.lease_s = float(lease_s)
        self.heartbeat_s = (float(heartbeat_s) if heartbeat_s > 0
                            else max(0.2, self.lease_s / 3.0))
        # token makes renew/release self-owned: a taken-over writer that
        # limps back can never delete or renew the usurper's lease
        self.token = (f"{os.getpid()}.{threading.get_ident()}."
                      f"{os.urandom(4).hex()}")
        self.held = False
        self._started_at = 0.0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _read(self) -> Optional[dict]:
        try:
            raw = self.path.read_text()
        except FileNotFoundError:
            return None
        except OSError as e:
            R.log_event("store_lease_unreadable", path=str(self.path),
                        error=repr(e))
            return None
        try:
            doc = json.loads(raw)
            if not isinstance(doc, dict):
                raise ValueError("lease doc is not an object")
            return doc
        except ValueError as e:
            # malformed = absent-but-loud (torn lease write from a killed
            # holder) — it must not wedge the store forever
            R.log_event("store_lease_malformed", path=str(self.path),
                        error=repr(e))
            tracing.registry().counter("search/store_lease_malformed").inc()
            return None

    def _write(self) -> None:
        doc = {"owner": self.owner, "pid": os.getpid(), "token": self.token,
               "lease_s": self.lease_s, "started_at": self._started_at,
               "renewed_at": time.time()}
        tmp = self.path.with_name(
            f"{LEASE_NAME}.tmp.{os.getpid()}.{threading.get_ident()}")
        fsio.publish_durable(tmp, self.path,
                             json.dumps(doc, sort_keys=True) + "\n")

    def acquire(self) -> "StoreWriterLease":
        """Take the lease or raise :class:`StoreLeaseHeldError`."""
        self.dir.mkdir(parents=True, exist_ok=True)
        now = time.time()
        doc = self._read()
        if doc is not None and doc.get("token") != self.token:
            renewed = float(doc.get("renewed_at") or 0.0)
            held_s = float(doc.get("lease_s") or 0.0)
            if now <= renewed + held_s:
                raise StoreLeaseHeldError(
                    f"store {self.dir} writer lease held by "
                    f"{doc.get('owner')!r} (pid {doc.get('pid')}, renewed "
                    f"{now - renewed:.1f}s ago, lease {held_s:.1f}s) — one "
                    "writer per store; retry after it finalizes or its "
                    "lease expires")
            R.log_event("store_lease_takeover", path=str(self.path),
                        stale_owner=doc.get("owner"),
                        stale_pid=doc.get("pid"),
                        stale_for_s=round(now - renewed - held_s, 3))
            tracing.registry().counter("search/store_lease_takeover").inc()
            log.warning("store %s: taking over stale writer lease from %r "
                        "(pid %s)", self.dir, doc.get("owner"),
                        doc.get("pid"))
        self._started_at = now
        self._write()
        self.held = True
        self._stop.clear()
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="store-lease")
        self._thread.start()
        return self

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self._write()
            except OSError as e:  # keep renewing through transient FS blips
                R.log_event("store_lease_renew_failed", path=str(self.path),
                            error=repr(e))

    def release(self) -> None:
        """Stop the heartbeat and delete the lease iff it is still ours."""
        if not self.held:
            return
        self.held = False
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=max(1.0, 2 * self.heartbeat_s))
            self._thread = None
        doc = self._read()
        if doc is not None and doc.get("token") == self.token:
            try:
                self.path.unlink()
            except OSError:
                pass

    def __enter__(self) -> "StoreWriterLease":
        return self

    def __exit__(self, *exc) -> None:
        self.release()


# ---------------------------------------------------------------------------
# Writer: streaming build/append
# ---------------------------------------------------------------------------

class EmbeddingStoreWriter:
    """Accumulate embedding rows and persist fixed-capacity shards.

    Streaming by construction: ``add`` flushes a shard every ``shard_rows``
    rows, so peak host memory during ingestion is one shard, not the
    corpus. ``normalize=True`` L2-normalizes rows at ingest (recorded in
    the manifest so query layers know whether scores are cosine); the
    default preserves dump bytes exactly, so store-backed scores are the
    brute force's dot products on the same rows.
    """

    def __init__(self, store_dir: str | Path, *, embed_dim: Optional[int] = None,
                 shard_rows: Optional[int] = None, normalize: bool = False,
                 _resume: Optional[dict] = None,
                 lease: Optional[StoreWriterLease] = None):
        self.dir = Path(store_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.embed_dim = embed_dim
        self.shard_rows = max(1, int(shard_rows or DEFAULT_SHARD_ROWS))
        self.normalize = bool(normalize)
        self._rows: list[tuple[np.ndarray, np.ndarray]] = []
        self._pending = 0
        self._shards: list[dict] = list((_resume or {}).get("shards", []))
        self._total = int((_resume or {}).get("total", 0))
        self._sources: list[str] = list((_resume or {}).get("sources", []))
        self._snapshot = int((_resume or {}).get("snapshot", 0))
        self._wal_through = int((_resume or {}).get("wal_through", 0))
        self._live = False
        # single-writer discipline: hold the store's writer lease for the
        # writer's whole life (a borrowed lease, the live tier's compaction,
        # stays owned by the borrower)
        self._owns_lease = lease is None
        self._lease: Optional[StoreWriterLease] = (
            StoreWriterLease(self.dir).acquire() if lease is None else lease)

    # -- construction --------------------------------------------------------

    @classmethod
    def create(cls, store_dir: str | Path, *, embed_dim: Optional[int] = None,
               shard_rows: Optional[int] = None, normalize: bool = False,
               lease: Optional[StoreWriterLease] = None) -> "EmbeddingStoreWriter":
        """Start a NEW store; refuses to clobber a committed one (build over
        an existing manifest would orphan its shards — use append)."""
        if ((Path(store_dir) / MANIFEST_NAME).exists()
                or (Path(store_dir) / CURRENT_NAME).exists()):
            raise StoreError(
                f"{store_dir} already holds a committed store "
                f"({MANIFEST_NAME} exists) — use append, or point build at "
                "a fresh directory")
        return cls(store_dir, embed_dim=embed_dim, shard_rows=shard_rows,
                   normalize=normalize, lease=lease)

    @classmethod
    def append(cls, store_dir: str | Path, *,
               lease: Optional[StoreWriterLease] = None) -> "EmbeddingStoreWriter":
        """Extend a committed store: new rows land in NEW shards (committed
        shards are immutable), and the manifest re-commits atomically at
        finalize — a crash mid-append leaves the previous store intact."""
        manifest = read_store_manifest(Path(store_dir))
        return cls(store_dir, embed_dim=int(manifest["embed_dim"]),
                   shard_rows=int(manifest["shard_rows"]),
                   normalize=bool(manifest["normalized"]),
                   _resume=manifest, lease=lease)

    def close(self) -> None:
        """Release the writer lease without committing (the abort path;
        :meth:`finalize` calls this after the manifest lands); a borrowed
        lease stays with its owner. Idempotent."""
        if self._owns_lease and self._lease is not None:
            self._lease.release()
        self._lease = None

    def __enter__(self) -> "EmbeddingStoreWriter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- versioned snapshots (the live tier's hooks) -------------------------

    def mark_live(self) -> None:
        """Commit versioned (``store_manifest.v<N>.json`` + ``CURRENT``)
        even on a store that never had a ``CURRENT`` pointer — the live
        tier's first compaction promotes the store to snapshot serving."""
        self._live = True

    def mark_wal_through(self, seq: int) -> None:
        """Record the highest WAL sequence folded into this commit; WAL
        replay after a crash skips rows at or below it (idempotence)."""
        self._wal_through = max(self._wal_through, int(seq))

    # -- ingestion -----------------------------------------------------------

    def add(self, features: np.ndarray, keys: Sequence[str]) -> int:
        """Buffer rows; flush full shards. Raises StoreError on a width or
        row-count mismatch BEFORE anything is written."""
        features = np.asarray(features, np.float32)
        if features.ndim != 2:
            raise StoreError(
                f"features must be [N, D], got shape {features.shape}")
        if len(keys) != features.shape[0]:
            raise StoreError(
                f"{features.shape[0]} features but {len(keys)} keys — "
                "torn input")
        if self.embed_dim is None:
            self.embed_dim = int(features.shape[1])
        if features.shape[1] != self.embed_dim:
            raise StoreError(
                f"embedding width {features.shape[1]} != store width "
                f"{self.embed_dim}")
        if not np.isfinite(features).all():
            raise StoreError("input features contain non-finite values")
        if self.normalize:
            features = normalize_rows(features)
        self._rows.append((features, np.asarray([str(k) for k in keys],
                                                dtype=str)))
        self._pending += features.shape[0]
        while self._pending >= self.shard_rows:
            self._flush_shard(self.shard_rows)
        return features.shape[0]

    def add_dump(self, path: str | Path) -> int:
        """Ingest one embedding dump (our .npz or a reference pickle);
        returns rows added. Load/verify errors propagate typed — the
        build/append callers decide whether to skip-and-count or fail."""
        from dcr_tpu_torch.search.embed import load_embeddings

        features, keys = load_embeddings(path)
        n = self.add(features, keys)
        self._sources.append(str(path))
        return n

    def _flush_shard(self, take: int) -> None:
        # consume rows from the FRONT of the buffer; the remainder stays as
        # views, never re-concatenated — one big add() flushes its shards
        # with linear copy traffic, not quadratic
        feat_parts: list[np.ndarray] = []
        key_parts: list[np.ndarray] = []
        got = 0
        while got < take and self._rows:
            f, k = self._rows[0]
            need = take - got
            if len(f) <= need:
                feat_parts.append(f)
                key_parts.append(k)
                got += len(f)
                self._rows.pop(0)
            else:
                feat_parts.append(f[:need])
                key_parts.append(k[:need])
                self._rows[0] = (f[need:], k[need:])
                got = take
        feats = (feat_parts[0] if len(feat_parts) == 1
                 else np.concatenate(feat_parts))
        keys = (key_parts[0] if len(key_parts) == 1
                else np.concatenate(key_parts))
        take = got
        buf = BytesIO()
        np.savez(buf, features=feats, keys=keys)
        blob = buf.getvalue()
        name = f"shard_{len(self._shards):05d}.npz"
        path = self.dir / name
        tmp = path.with_name(f"{name}.tmp.{os.getpid()}")
        fsio.publish_durable(tmp, path, blob)
        self._shards.append({"file": name, "sha256": _sha(blob),
                             "count": int(take)})
        self._total += take
        tracing.registry().counter("search/ingest_rows_total").inc(take)
        self._pending -= take

    def finalize(self, *, _pre_current: Optional[Callable[[], None]] = None) -> Path:
        """Flush the tail shard and commit the manifest (atomically, last).

        Legacy stores re-commit the single ``store_manifest.json``. A live
        store (``CURRENT`` exists, resumed from a versioned snapshot, or
        :meth:`mark_live`) commits ``store_manifest.v<N+1>.json`` first and
        then flips ``CURRENT`` — the flip IS the commit point, so a crash
        between the two leaves the previous snapshot serving.
        ``_pre_current`` runs between the two writes (the live tier's
        ``compact_crash`` injection point)."""
        while self._pending:
            self._flush_shard(self.shard_rows)
        live = (self._live or self._snapshot > 0
                or (self.dir / CURRENT_NAME).exists())
        snapshot = self._snapshot + 1 if live else 0
        doc = {
            "version": STORE_VERSION,
            "kind": STORE_KIND,
            "created_at": time.time(),
            "embed_dim": int(self.embed_dim or 0),
            "shard_rows": self.shard_rows,
            "normalized": self.normalize,
            "total": self._total,
            "snapshot": snapshot,
            "wal_through": self._wal_through,
            "shards": self._shards,
            "sources": self._sources,
        }
        name = versioned_manifest_name(snapshot) if live else MANIFEST_NAME
        path = self.dir / name
        tmp = path.with_name(f"{name}.tmp.{os.getpid()}")
        # dir fsync: the CURRENT flip below is the commit point — the
        # manifest it names (and the shards the manifest names) must be
        # durable strictly before the flip itself can be
        fsio.publish_durable(tmp, path,
                             json.dumps(doc, indent=1, sort_keys=True) + "\n",
                             sync_dir=True)
        if live:
            if _pre_current is not None:
                _pre_current()
            cur = self.dir / CURRENT_NAME
            ctmp = cur.with_name(f"{CURRENT_NAME}.tmp.{os.getpid()}")
            fsio.publish_durable(ctmp, cur, name + "\n", sync_dir=True)
        self.close()
        return path


# ---------------------------------------------------------------------------
# Manifest + reader: verify before load, quarantine on damage
# ---------------------------------------------------------------------------

def _read_current_pointer(store_dir: Path, *,
                          quarantine: bool = True) -> Optional[str]:
    """Resolve ``CURRENT`` to a versioned manifest filename, or None for a
    legacy (pre-live) store. A pointer naming anything but a versioned
    manifest is corruption of the commit point itself: quarantined +
    counted + typed, exactly like a corrupt manifest."""
    cur = Path(store_dir) / CURRENT_NAME
    try:
        raw = cur.read_text()
    except FileNotFoundError:
        return None
    except OSError as e:
        raise StoreError(f"store CURRENT pointer unreadable: {e!r}") from e
    name = raw.strip()
    if not _VERSIONED_RE.match(name):
        dest = quarantine_rename(cur) if quarantine else None
        R.log_event("store_manifest_corrupt", error=f"CURRENT names {name!r}",
                    path=str(cur),
                    quarantined_to=str(dest) if dest else None)
        tracing.registry().counter("search/store_manifest_corrupt").inc()
        raise StoreError(
            f"store manifest corrupt (CURRENT names {name!r}, not a "
            "versioned manifest); quarantined — recover or rebuild the "
            "store")
    return name


def snapshot_version(store_dir: str | Path) -> int:
    """The store's current snapshot: the ``CURRENT`` pointer's version for
    a live store, 0 for a legacy single-manifest (or absent) store."""
    name = _read_current_pointer(Path(store_dir), quarantine=False)
    return int(_VERSIONED_RE.match(name).group(1)) if name else 0


def read_store_manifest(store_dir: Path, *, quarantine: bool = True) -> dict:
    """Load + structurally verify the store manifest — the ``CURRENT``
    snapshot when the store is live, else the legacy single
    ``store_manifest.json``. Raises :class:`StoreError`; a corrupt
    (unparseable) manifest is additionally quarantine-renamed so the next
    incarnation isn't poisoned by the same bytes — unless
    ``quarantine=False`` (read-only inspection of a possibly-shared store
    must not rename anything)."""
    current = _read_current_pointer(Path(store_dir), quarantine=quarantine)
    name = current or MANIFEST_NAME
    path = Path(store_dir) / name
    try:
        raw = R.read_bytes_with_retry(path, name="store_manifest")
    except FileNotFoundError:
        if current is not None:
            raise StoreError(
                f"store manifest corrupt: {CURRENT_NAME} names {name} but "
                "the file is missing — recover or rebuild the store"
            ) from None
        raise StoreError(
            f"{store_dir} has no {MANIFEST_NAME} — not an embedding store "
            "(run `dcr-search build` first)") from None
    except OSError as e:
        raise StoreError(f"store manifest unreadable: {e!r}") from e
    try:
        doc = json.loads(raw.decode("utf-8"))
        if doc.get("kind") != STORE_KIND:
            raise ValueError(f"kind is {doc.get('kind')!r}, not {STORE_KIND}")
        if not isinstance(doc.get("shards"), list):
            raise ValueError("manifest missing shards list")
        for field in ("embed_dim", "shard_rows", "total"):
            if not isinstance(doc.get(field), int):
                raise ValueError(f"manifest field {field!r} missing/not int")
    except (UnicodeDecodeError, ValueError) as e:
        dest = quarantine_rename(path) if quarantine else None
        R.log_event("store_manifest_corrupt", error=repr(e), path=str(path),
                    quarantined_to=str(dest) if dest else None)
        tracing.registry().counter("search/store_manifest_corrupt").inc()
        raise StoreError(
            f"store manifest corrupt ({e}); quarantined — rebuild the "
            "store") from e
    # the pointer, not the doc, is the commit point — trust its version
    doc["snapshot"] = (int(_VERSIONED_RE.match(current).group(1))
                       if current else 0)
    doc.setdefault("wal_through", 0)
    return doc


class EmbeddingStoreReader:
    """Verify-before-load shard access with per-shard quarantine.

    Construction reads ONLY the manifest (a million-row store opens in
    milliseconds); shards stream through :meth:`iter_shards` so callers —
    the query engine's segment builder, ``dcr-search verify`` — control
    residency. ``quarantine=False`` makes
    verification read-only (the CLI ``verify`` subcommand inspects a
    possibly-shared store without renaming anything).
    """

    def __init__(self, store_dir: str | Path, *, quarantine: bool = True):
        self.dir = Path(store_dir)
        self.quarantine = bool(quarantine)
        self.manifest = read_store_manifest(self.dir,
                                            quarantine=self.quarantine)
        self.embed_dim = int(self.manifest["embed_dim"])
        self.normalized = bool(self.manifest.get("normalized", False))
        self.shard_rows = int(self.manifest["shard_rows"])
        self.total = int(self.manifest["total"])
        self.snapshot = int(self.manifest.get("snapshot", 0))
        self.wal_through = int(self.manifest.get("wal_through", 0))
        # the shard read index: the `load` coordinate of store_shard_corrupt
        self._load_seq = 0

    @property
    def shards(self) -> list[dict]:
        return list(self.manifest["shards"])

    # -- verification --------------------------------------------------------

    def _load_shard(self, shard: dict) -> Optional[tuple[np.ndarray, np.ndarray]]:
        path = self.dir / str(shard.get("file", ""))
        try:
            blob = R.read_bytes_with_retry(path, name="store_shard")
        except (FileNotFoundError, OSError) as e:
            self._quarantine(path, "store_shard_missing", repr(e),
                             rename=False)
            return None
        seq, self._load_seq = self._load_seq, self._load_seq + 1
        if faults.fire("store_shard_corrupt", load=seq):
            # damage the bytes in memory so the real verify, quarantine and
            # degrade path runs
            mid = len(blob) // 2
            blob = blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:] if blob else b""
        if _sha(blob) != shard.get("sha256"):
            self._quarantine(path, "store_shard_corrupt", "sha256 mismatch")
            return None
        try:
            with np.load(BytesIO(blob), allow_pickle=False) as z:
                feats = np.asarray(z["features"], np.float32)
                keys = np.asarray(z["keys"], dtype=str)
        except Exception as e:
            self._quarantine(path, "store_shard_corrupt",
                             f"unreadable npz: {e!r}")
            return None
        n = feats.shape[0] if feats.ndim == 2 else -1
        if not (feats.ndim == 2 and feats.shape[1] == self.embed_dim
                and len(keys) == n == shard.get("count")):
            self._quarantine(path, "store_shard_corrupt",
                             f"shape/count mismatch: features "
                             f"{feats.shape}, {len(keys)} keys, manifest "
                             f"count {shard.get('count')}")
            return None
        if not np.isfinite(feats).all():
            self._quarantine(path, "store_shard_corrupt",
                             "non-finite features")
            return None
        return feats, keys

    def _quarantine(self, path: Path, kind: str, detail: str,
                    rename: bool = True) -> None:
        dest = quarantine_rename(path) if rename and self.quarantine else None
        R.log_event("store_shard_quarantined", kind=kind, detail=detail,
                    shard=str(path),
                    quarantined_to=str(dest) if dest else None)
        tracing.registry().counter(f"search/{kind}").inc()

    # -- serving -------------------------------------------------------------

    def load_shard(self, index: int) -> Optional[tuple[np.ndarray, np.ndarray]]:
        """Verified ``(features [n, D], keys [n])`` of the manifest's shard
        ``index``, or None once it is quarantined and counted; the snapshot
        is checked first, as :meth:`iter_shards` checks it (a rank of a mesh
        reads only the shards that hold its rows)."""
        self.check_snapshot()
        return self._load_shard(self.manifest["shards"][index])

    def check_snapshot(self) -> None:
        """Raise :class:`StoreSnapshotChangedError` when the store's
        snapshot moved since this reader opened. Called before every shard
        read (one tiny pointer stat/read against a multi-MB shard load) —
        rows from two snapshots must never mix in one iteration."""
        now = snapshot_version(self.dir)
        if now != self.snapshot:
            tracing.registry().counter("search/store_snapshot_changed").inc()
            raise StoreSnapshotChangedError(
                f"store {self.dir} snapshot moved v{self.snapshot} -> "
                f"v{now} mid-read — re-open the reader against the new "
                "snapshot and retry")

    def iter_shards(self) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Yield verified ``(features [n, D], keys [n])`` per surviving
        shard, manifest order. Corrupt shards are quarantined + counted and
        simply not yielded; zero survivors raises StoreError (a store that
        can serve NOTHING must be loud, not an empty result set). A
        snapshot that moves mid-iteration raises the retryable
        :class:`StoreSnapshotChangedError` before any cross-snapshot row
        can be served."""
        survivors = 0
        for shard in self.manifest["shards"]:
            self.check_snapshot()
            arrays = self._load_shard(shard)
            if arrays is None:
                continue
            survivors += 1
            yield arrays
        if self.manifest["shards"] and not survivors:
            raise StoreError(
                f"store {self.dir}: no shard survived verification "
                f"({len(self.manifest['shards'])} listed)")

    def load_all(self) -> tuple[np.ndarray, list[str]]:
        """Concatenated ``(features, keys)`` of every surviving shard — the
        small-store convenience path (tests, equality pins)."""
        feats, keys = [], []
        for f, k in self.iter_shards():
            feats.append(f)
            keys.extend(k.tolist())
        if not feats:
            return np.zeros((0, self.embed_dim), np.float32), []
        return np.concatenate(feats), keys

    def verify(self) -> dict:
        """Walk every shard through the full verification path; returns
        ``{shards, ok, corrupt, rows_ok, total}`` (``dcr-search verify``)."""
        ok = corrupt = rows = 0
        for shard in self.manifest["shards"]:
            arrays = self._load_shard(shard)
            if arrays is None:
                corrupt += 1
            else:
                ok += 1
                rows += arrays[0].shape[0]
        return {"shards": len(self.manifest["shards"]), "ok": ok,
                "corrupt": corrupt, "rows_ok": rows, "total": self.total}


# ---------------------------------------------------------------------------
# Build/append (the CLI's workhorses)
# ---------------------------------------------------------------------------

def _dump_sources(sources: Sequence[str | Path]) -> Iterator[Path]:
    """Resolve each source to an embedding dump file: a file passes
    through; a directory resolves via find_embedding_file; a directory of
    chunk directories (the reference's laion_folder layout) expands."""
    from dcr_tpu_torch.search.embed import find_embedding_file

    for src in sources:
        src = Path(src)
        if src.is_file():
            yield src
            continue
        direct = find_embedding_file(src)
        if direct is not None:
            yield direct
            continue
        for sub in sorted(p for p in src.iterdir() if p.is_dir()):
            dump = find_embedding_file(sub)
            if dump is not None:
                yield dump


def ingest_dumps(writer: EmbeddingStoreWriter,
                 sources: Sequence[str | Path]) -> dict:
    """Stream every resolvable dump under ``sources`` into ``writer`` and
    finalize. A dump that fails to load/verify is counted + logged and
    skipped (corrupt chunks are expected at corpus scale — same tolerance
    as the brute-force search path, but never silent); the manifest commits
    only once at the end. A run that ingested ZERO rows raises
    :class:`StoreError` WITHOUT committing — exit-0 success over an empty
    (or unchanged, for append) store would just defer the failure to the
    first query, and a committed empty build would block the corrected
    rebuild behind the clobber refusal."""
    rows = dumps = skipped = 0
    for dump in _dump_sources(sources):
        try:
            rows += writer.add_dump(dump)
            dumps += 1
        except Exception as e:  # corrupt chunks are expected at scale
            skipped += 1
            R.log_event("store_ingest_dump_failed", path=str(dump),
                        error=repr(e))
            tracing.registry().counter("search/ingest_dump_failed").inc()
            log.warning("store ingest: skipping %s (%r)", dump, e)
    if rows == 0:
        writer.close()  # aborting: the writer lease must not outlive it
        raise StoreError(
            f"ingested 0 rows from {[str(s) for s in sources]} "
            f"({skipped} dump(s) failed, {dumps} readable) — "
            "not committing a manifest")
    manifest_path = writer.finalize()
    return {"rows": rows, "dumps": dumps, "skipped": skipped,
            "shards": len(writer._shards), "total": writer._total,
            "manifest": str(manifest_path)}
