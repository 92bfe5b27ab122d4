"""The IVF coarse quantizer and the int8 inverted lists over the store.

Counterpart of ``dcr_tpu/search/ann.py``, on the same on-disk format, so an
``ann/`` tier that either package writes loads in the other. The exact engine
(:mod:`dcr_tpu_torch.search.shardindex`) scans every committed row per query;
this module trains a k-means coarse quantizer on the device over the
committed store and materialises each centroid's rows as an int8-coded
*inverted list* that the scan engine (:mod:`dcr_tpu_torch.search.annindex`)
probes selectively.

Training is Lloyd's algorithm, one :func:`make_kmeans_step` call per fixed
corpus segment: assignment is ``argmax(feats @ C.T - 0.5*||C||^2)`` (exact
L2 nearest centroid, the first index on ties) and the per-centroid sums and
counts come from a one-hot matmul, never a scatter (``index_add_`` on CUDA
adds with atomics in no fixed order), so the same seed and the same shards
give bit-identical centroids run to run on one device. List membership
always comes from the one host-side :func:`assign_rows`, so training and
rebuilds and the live tier's incremental folds (:func:`fold_rows`) agree, and
agree with the JAX package's lists. A non-finite centroid
update (the ``kmeans_nan@iter=N`` fault kind drives this) restarts training
with a shifted seed, counted and bounded, never committed.

Storage follows the store's discipline, under ``<store_dir>/ann/``::

    ann/ann_manifest.v<N>.json   # per-list sha256 + scale/zero-point
    ann/CURRENT                  # atomic pointer: the commit point
    ann/writer.lease.json        # single-writer heartbeat lease
    ann/centroids_v<N>.npz       # f32 [n_lists, D]
    ann/list_00007_v<N>.npz      # codes int8 [n,D], feats f32, keys, ...

- every list and centroid blob is sha256-verified from its bytes before
  ``np.load``; a damaged list is quarantine-renamed, counted as
  ``ann/ivf_list_corrupt`` and rebuilt from the committed store (a list is
  a projection of the store). The ``ivf_list_corrupt@load=N`` fault kind
  damages the Nth list read in memory, so the real verify, quarantine and
  rebuild path runs;
- the manifest commits last and ``CURRENT`` flips atomically
  (:func:`fsio.publish_durable`): a killed training run leaves the previous
  snapshot serving.

Codes are per-list affine int8: ``zero = (hi+lo)/2``, ``scale =
max((hi-lo)/254, 1e-12)``, code range [-127, 127]; the f32 rows ride in the
list for the exact re-rank of the shortlist. Files of superseded snapshots
stay on disk, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import re
import time
from io import BytesIO
from pathlib import Path
from typing import Optional, Sequence

import numpy as np
import torch

from dcr_tpu_torch.core import fsio
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.core.fsio import quarantine_rename
from dcr_tpu_torch.search.shardindex import full_f32_matmul
from dcr_tpu_torch.search.store import (
    EmbeddingStoreReader,
    StoreError,
    StoreWriterLease,
    normalize_rows,
)
from dcr_tpu_torch.utils import faults

log = logging.getLogger("dcr_tpu_torch")

ANN_VERSION = 1
ANN_KIND = "dcr_ann_index"
#: the ann tier lives in this subdirectory of the store it indexes
ANN_DIRNAME = "ann"
CURRENT_NAME = "CURRENT"
#: default number of coarse centroids (inverted lists)
DEFAULT_N_LISTS = 64
#: default Lloyd iterations
DEFAULT_IVF_ITERS = 10
#: bounded non-finite-centroid restarts (the seed shifts by +1 each restart)
MAX_KMEANS_RESTARTS = 3
#: rows per k-means segment
DEFAULT_TRAIN_SEGMENT_ROWS = 65536
#: training sets of at most this many rows stay on the device for the whole
#: Lloyd loop; larger ones upload each segment per iteration
DEFAULT_MAX_RESIDENT_TRAIN_ROWS = 1 << 22

_ANN_VERSIONED_RE = re.compile(r"^ann_manifest\.v(\d+)\.json$")


class AnnError(StoreError):
    """Typed: the ann tier cannot serve (absent or corrupt manifest or
    centroids, a training failure, or a width mismatch with its store). The
    exact path stays available; callers decide whether the absence is fatal
    (an explicit ``--ann``) or a degrade."""


def ann_dir(store_dir: str | Path) -> Path:
    return Path(store_dir) / ANN_DIRNAME


def versioned_ann_manifest_name(snapshot: int) -> str:
    return f"ann_manifest.v{int(snapshot)}.json"


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _read_current_pointer(adir: Path, *, quarantine: bool = True) -> Optional[str]:
    """Resolve the ann ``CURRENT`` pointer, or None when no index exists. A
    pointer naming anything but a versioned ann manifest is corruption of the
    commit point: quarantined, counted and typed."""
    cur = adir / CURRENT_NAME
    try:
        raw = cur.read_text()
    except FileNotFoundError:
        return None
    except OSError as e:
        raise AnnError(f"ann CURRENT pointer unreadable: {e!r}") from e
    name = raw.strip()
    if not _ANN_VERSIONED_RE.match(name):
        dest = quarantine_rename(cur) if quarantine else None
        R.log_event("ann_manifest_corrupt", error=f"CURRENT names {name!r}", path=str(cur),
                    quarantined_to=str(dest) if dest else None)
        tracing.registry().counter("ann/manifest_corrupt").inc()
        raise AnnError(f"ann manifest corrupt (CURRENT names {name!r}); quarantined — "
                       "re-run `dcr-search train-ivf`")
    return name


def has_ann_index(store_dir: str | Path) -> bool:
    """True iff ``store_dir`` carries a committed ann tier (one pointer read,
    no quarantine)."""
    try:
        return _read_current_pointer(ann_dir(store_dir), quarantine=False) is not None
    except AnnError:
        return False


def ann_snapshot_version(store_dir: str | Path) -> int:
    name = _read_current_pointer(ann_dir(store_dir), quarantine=False)
    return int(_ANN_VERSIONED_RE.match(name).group(1)) if name else 0


def read_ann_manifest(store_dir: str | Path, *, quarantine: bool = True) -> dict:
    """Load and structurally verify the committed ann manifest. Raises
    :class:`AnnError`; an unparseable manifest is quarantine-renamed unless
    ``quarantine=False`` (read-only inspection)."""
    adir = ann_dir(store_dir)
    current = _read_current_pointer(adir, quarantine=quarantine)
    if current is None:
        raise AnnError(f"{store_dir} has no ann index — run `dcr-search train-ivf` first "
                       "(exact search works without one)")
    path = adir / current
    try:
        raw = R.read_bytes_with_retry(path, name="ann_manifest")
    except FileNotFoundError:
        raise AnnError(f"ann manifest corrupt: {CURRENT_NAME} names {current} but the file "
                       "is missing — re-run `dcr-search train-ivf`") from None
    except OSError as e:
        raise AnnError(f"ann manifest unreadable: {e!r}") from e
    try:
        doc = json.loads(raw.decode("utf-8"))
        if doc.get("kind") != ANN_KIND:
            raise ValueError(f"kind is {doc.get('kind')!r}, not {ANN_KIND}")
        for field in ("embed_dim", "n_lists", "total"):
            if not isinstance(doc.get(field), int):
                raise ValueError(f"manifest field {field!r} missing/not int")
        if not isinstance(doc.get("lists"), list):
            raise ValueError("manifest missing lists")
        if not isinstance(doc.get("centroids"), dict):
            raise ValueError("manifest missing centroids entry")
    except (UnicodeDecodeError, ValueError) as e:
        dest = quarantine_rename(path) if quarantine else None
        R.log_event("ann_manifest_corrupt", error=repr(e), path=str(path),
                    quarantined_to=str(dest) if dest else None)
        tracing.registry().counter("ann/manifest_corrupt").inc()
        raise AnnError(f"ann manifest corrupt ({e}); quarantined — re-run "
                       "`dcr-search train-ivf`") from e
    doc["snapshot"] = int(_ANN_VERSIONED_RE.match(current).group(1))
    return doc


# ---------------------------------------------------------------------------
# The Lloyd iteration on the device
# ---------------------------------------------------------------------------

@compile_surface("search/kmeans")
def make_kmeans_step(n_lists: int):
    """``(feats [R, D], valid [R], centroids [L, D]) -> (sums [L, D],
    counts [L])``: one Lloyd accumulation over one corpus segment, on the
    tensors' device.

    Assignment is the exact L2 nearest centroid in the expanded form
    ``argmax(feats @ C.T - 0.5*||C||^2)`` (``||feats||^2`` is constant per
    row); ``torch.argmax`` returns the first maximal index. The reduction is
    a one-hot matmul with pad rows (``valid`` False) in no centroid: fixed
    shapes and no atomics, so it is bit-identical run to run. TF32 stays off."""
    def step(feats: torch.Tensor, valid: torch.Tensor, centroids: torch.Tensor):
        with full_f32_matmul():
            scores = feats @ centroids.T - 0.5 * (centroids * centroids).sum(-1)[None, :]
            assign = scores.argmax(dim=-1)
            lists = torch.arange(n_lists, device=feats.device)
            member = ((assign[:, None] == lists[None, :]) & valid[:, None]).float()
            sums = member.T @ feats
        return sums, member.sum(0)

    return step


def assign_rows(feats: np.ndarray, centroids: np.ndarray) -> np.ndarray:
    """Host-side nearest-centroid assignment: the one function that every
    materialisation path (training, rebuilds) routes membership through, so
    a row never lands in different lists depending on the path. The same
    formula and first-index tie-break as the device step."""
    feats = np.asarray(feats, np.float32)
    centroids = np.asarray(centroids, np.float32)
    scores = (feats @ centroids.T
              - 0.5 * np.sum(centroids * centroids, axis=-1)[None, :])
    return np.argmax(scores, axis=1)


def quantize_list(feats: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Per-list affine int8: ``(codes, scale, zero)`` with ``feats ~= codes *
    scale + zero`` (code range [-127, 127]; -128 unused so negation cannot
    overflow). An empty list quantizes to identity parameters."""
    feats = np.asarray(feats, np.float32)
    if feats.size == 0:
        return np.zeros(feats.shape, np.int8), 1.0, 0.0
    lo = float(feats.min())
    hi = float(feats.max())
    zero = (hi + lo) / 2.0
    scale = max((hi - lo) / 254.0, 1e-12)
    codes = np.clip(np.rint((feats - zero) / scale), -127, 127)
    return codes.astype(np.int8), scale, zero


def dequantize(codes: np.ndarray, scale: float, zero: float) -> np.ndarray:
    return codes.astype(np.float32) * np.float32(scale) + np.float32(zero)


# ---------------------------------------------------------------------------
# Reader: verify before load, quarantine on damage, rebuild from the store
# ---------------------------------------------------------------------------

class AnnIndexReader:
    """Verify-before-load access to a committed ann index.

    Construction reads only the manifest; centroids and lists load on
    demand. A list that fails verification is quarantine-renamed, counted
    (``ann/ivf_list_corrupt``) and listed in :attr:`failed_lists`, so the
    engine can rebuild it from the committed store. ``quarantine=False``
    makes verification read-only (``stats`` on a shared store renames
    nothing).
    """

    def __init__(self, store_dir: str | Path, *, quarantine: bool = True):
        self.store_dir = Path(store_dir)
        self.dir = ann_dir(store_dir)
        self.quarantine = bool(quarantine)
        self.manifest = read_ann_manifest(store_dir, quarantine=self.quarantine)
        self.embed_dim = int(self.manifest["embed_dim"])
        self.n_lists = int(self.manifest["n_lists"])
        self.normalized = bool(self.manifest.get("normalized", False))
        self.total = int(self.manifest["total"])
        self.snapshot = int(self.manifest["snapshot"])
        self.store_snapshot = int(self.manifest.get("store_snapshot", 0))
        #: list ids that failed verification during this reader's life
        self.failed_lists: list[int] = []
        # the list read index: the `load` coordinate of ivf_list_corrupt
        self._load_seq = 0

    @property
    def lists(self) -> list[dict]:
        return list(self.manifest["lists"])

    def load_centroids(self) -> np.ndarray:
        """Verified centroids [n_lists, D]. Damage is typed, not rebuilt:
        lists are projections of the store, the centroids are the projection
        rule, so the remedy is retraining."""
        entry = self.manifest["centroids"]
        path = self.dir / str(entry.get("file", ""))
        try:
            blob = R.read_bytes_with_retry(path, name="ann_centroids")
        except OSError as e:
            raise AnnError(f"ann centroids unreadable: {e!r} — re-run "
                           "`dcr-search train-ivf`") from e
        if _sha(blob) != entry.get("sha256"):
            dest = quarantine_rename(path) if self.quarantine else None
            R.log_event("ann_centroids_corrupt", path=str(path),
                        quarantined_to=str(dest) if dest else None)
            tracing.registry().counter("ann/centroids_corrupt").inc()
            raise AnnError("ann centroids corrupt (sha256 mismatch); quarantined — re-run "
                           "`dcr-search train-ivf`")
        with np.load(BytesIO(blob), allow_pickle=False) as z:
            centroids = np.asarray(z["centroids"], np.float32)
        if centroids.shape != (self.n_lists, self.embed_dim) or not np.isfinite(centroids).all():
            raise AnnError(f"ann centroids invalid (shape {centroids.shape}, expected "
                           f"({self.n_lists}, {self.embed_dim})) — re-run `dcr-search train-ivf`")
        return centroids

    def load_list(self, entry: dict) -> Optional[
            tuple[np.ndarray, np.ndarray, np.ndarray, float, float]]:
        """Verified ``(codes int8 [n,D], feats f32 [n,D], keys [n], scale,
        zero)`` of one manifest list entry, or None after quarantine on
        damage (the caller rebuilds from the store)."""
        list_id = int(entry.get("list", -1))
        if int(entry.get("count", 0)) == 0 and not entry.get("file"):
            empty = np.zeros((0, self.embed_dim), np.float32)
            return (np.zeros((0, self.embed_dim), np.int8), empty,
                    np.zeros((0,), dtype=object), 1.0, 0.0)
        path = self.dir / str(entry.get("file", ""))
        try:
            blob = R.read_bytes_with_retry(path, name="ann_list")
        except OSError as e:
            self._quarantine(list_id, path, repr(e), rename=False)
            return None
        seq, self._load_seq = self._load_seq, self._load_seq + 1
        if faults.fire("ivf_list_corrupt", load=seq):
            # damage the bytes in memory so the real verify, quarantine and
            # rebuild path runs
            mid = len(blob) // 2
            blob = blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:] if blob else b""
        if _sha(blob) != entry.get("sha256"):
            self._quarantine(list_id, path, "sha256 mismatch")
            return None
        try:
            with np.load(BytesIO(blob), allow_pickle=False) as z:
                codes = np.asarray(z["codes"], np.int8)
                feats = np.asarray(z["features"], np.float32)
                keys = np.asarray(z["keys"], dtype=str).astype(object)
                scale = float(z["scale"])
                zero = float(z["zero"])
        except Exception as e:  # any damage np.load can meet in the bytes
            self._quarantine(list_id, path, f"unreadable npz: {e!r}")
            return None
        n = codes.shape[0] if codes.ndim == 2 else -1
        if not (codes.ndim == 2 and codes.shape[1] == self.embed_dim
                and feats.shape == codes.shape and len(keys) == n
                and n == entry.get("count")):
            self._quarantine(list_id, path,
                             f"shape/count mismatch: codes {codes.shape}, features "
                             f"{feats.shape}, {len(keys)} keys, manifest count "
                             f"{entry.get('count')}")
            return None
        if not (np.isfinite(feats).all() and np.isfinite(scale) and np.isfinite(zero)
                and scale > 0):
            self._quarantine(list_id, path, "non-finite payload")
            return None
        return codes, feats, keys, scale, zero

    def _quarantine(self, list_id: int, path: Path, detail: str, rename: bool = True) -> None:
        dest = quarantine_rename(path) if rename and self.quarantine else None
        if list_id >= 0 and list_id not in self.failed_lists:
            self.failed_lists.append(list_id)
        R.log_event("ann_list_quarantined", list=list_id, detail=detail, path=str(path),
                    quarantined_to=str(dest) if dest else None)
        tracing.registry().counter("ann/ivf_list_corrupt").inc()

    def verify(self) -> dict:
        """Walk every list through the full verification path; returns
        ``{lists, ok, corrupt, rows_ok, total}``."""
        ok = corrupt = rows = 0
        for entry in self.manifest["lists"]:
            loaded = self.load_list(entry)
            if loaded is None:
                corrupt += 1
            else:
                ok += 1
                rows += loaded[0].shape[0]
        return {"lists": len(self.manifest["lists"]), "ok": ok, "corrupt": corrupt,
                "rows_ok": rows, "total": self.total}


# ---------------------------------------------------------------------------
# Training and materialisation
# ---------------------------------------------------------------------------

def _pad_segments(feats: np.ndarray, segment_rows: int, device: torch.device,
                  resident: bool) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """Split rows into fixed ``(feats [S, D], valid [S])`` segments
    (zero-padded), so every Lloyd step has one shape: on the device when
    ``resident``, else on the host (pinned on a GPU) for an upload per step."""
    pin = device.type == "cuda" and not resident
    segs = []
    for start in range(0, feats.shape[0], segment_rows):
        chunk = feats[start:start + segment_rows]
        n = chunk.shape[0]
        padded = torch.zeros((segment_rows, feats.shape[1]), dtype=torch.float32, pin_memory=pin)
        padded[:n] = torch.from_numpy(np.ascontiguousarray(chunk, np.float32))
        valid = torch.zeros((segment_rows,), dtype=torch.bool, pin_memory=pin)
        valid[:n] = True
        if resident:
            padded, valid = padded.to(device), valid.to(device)
        segs.append((padded, valid))
    return segs


def _publish_blob(adir: Path, name: str, blob: bytes) -> dict:
    path = adir / name
    fsio.publish_durable(path.with_name(f"{name}.tmp.{os.getpid()}"), path, blob)
    return {"file": name, "sha256": _sha(blob)}


def _list_blob(codes: np.ndarray, feats: np.ndarray, keys: np.ndarray, scale: float,
               zero: float) -> bytes:
    buf = BytesIO()
    np.savez(buf, codes=codes, features=feats,
             keys=np.asarray([str(k) for k in keys], dtype=str),
             scale=np.float32(scale), zero=np.float32(zero))
    return buf.getvalue()


def _commit_manifest(adir: Path, doc: dict, snapshot: int) -> Path:
    """Manifest first (directory fsynced), then the atomic ``CURRENT`` flip:
    the flip is the commit point."""
    name = versioned_ann_manifest_name(snapshot)
    path = adir / name
    fsio.publish_durable(path.with_name(f"{name}.tmp.{os.getpid()}"), path,
                         json.dumps(doc, indent=1, sort_keys=True) + "\n", sync_dir=True)
    cur = adir / CURRENT_NAME
    fsio.publish_durable(cur.with_name(f"{CURRENT_NAME}.tmp.{os.getpid()}"), cur,
                         name + "\n", sync_dir=True)
    return path


def _materialize_lists(adir: Path, snapshot: int, n_lists: int, assign: np.ndarray,
                       feats: np.ndarray, keys: np.ndarray) -> tuple[list[dict], int]:
    """Quantize and publish every list of a full build; returns the
    manifest's ``lists`` entries and the row total. A stable sort by list
    keeps each list's rows in store order, as a mask per list would."""
    order = np.argsort(assign, kind="stable")
    bounds = np.searchsorted(assign[order], np.arange(n_lists + 1))
    entries: list[dict] = []
    for list_id in range(n_lists):
        rows = order[bounds[list_id]:bounds[list_id + 1]]
        entries.append(_publish_list(adir, snapshot, list_id, feats[rows], keys[rows]))
    return entries, sum(int(e["count"]) for e in entries)


def _publish_list(adir: Path, snapshot: int, list_id: int, feats: np.ndarray,
                  keys: np.ndarray) -> dict:
    """Quantize and durably publish one inverted list; returns its manifest
    entry. An empty list gets an entry with no file."""
    n = int(feats.shape[0])
    if n == 0:
        return {"list": list_id, "file": "", "sha256": "", "count": 0, "scale": 1.0,
                "zero": 0.0}
    codes, scale, zero = quantize_list(feats)
    entry = _publish_blob(adir, f"list_{list_id:05d}_v{snapshot}.npz",
                          _list_blob(codes, feats, keys, scale, zero))
    entry.update(list=list_id, count=n, scale=scale, zero=zero)
    return entry


def kmeans(train_feats: np.ndarray, n_lists: int, iters: int, seed: int, *,
           device: str | torch.device = "cuda") -> tuple[np.ndarray, int]:
    """Lloyd's algorithm over ``train_feats`` on ``device``: ``(centroids
    f32 [n_lists, D], restarts)``. Initial centroids are ``n_lists`` rows
    drawn from ``np.random.default_rng(seed + restart)``; a non-finite
    update restarts with the next seed, at most :data:`MAX_KMEANS_RESTARTS`
    times, then raises :class:`AnnError`."""
    device = resolve_device(device)
    rows, dim = train_feats.shape
    seg_rows = min(max(rows, 1), DEFAULT_TRAIN_SEGMENT_ROWS)
    resident = rows <= DEFAULT_MAX_RESIDENT_TRAIN_ROWS
    segments = _pad_segments(train_feats, seg_rows, device, resident)
    step = make_kmeans_step(n_lists)
    restarts = 0
    for restart in range(MAX_KMEANS_RESTARTS + 1):
        rng = np.random.default_rng(seed + restart)
        cand = np.ascontiguousarray(train_feats[np.sort(rng.choice(rows, n_lists,
                                                                   replace=False))], np.float32)
        finite = True
        for it in range(int(iters)):
            cand_dev = torch.from_numpy(cand).to(device)
            # f32 partial sums per segment, accumulated in float64 in segment
            # order: the JAX package's host accumulation, kept on the device
            sums = torch.zeros((n_lists, dim), dtype=torch.float64, device=device)
            counts = torch.zeros((n_lists,), dtype=torch.float64, device=device)
            for seg_feats, seg_valid in segments:
                if not resident:
                    seg_feats = seg_feats.to(device, non_blocking=True)
                    seg_valid = seg_valid.to(device, non_blocking=True)
                s, c = step(seg_feats, seg_valid, cand_dev)
                sums += s.double()
                counts += c.double()
            sums, counts = sums.cpu().numpy(), counts.cpu().numpy()
            # an empty centroid keeps its position (deterministic; no
            # resampling mid-run)
            nxt = np.where(counts[:, None] > 0, sums / np.maximum(counts, 1.0)[:, None],
                           cand.astype(np.float64)).astype(np.float32)
            if faults.fire("kmeans_nan", iter=it):
                # a non-finite update, the shape a numerics fault or corrupt
                # input takes
                nxt[0, 0] = np.nan
            if not np.isfinite(nxt).all():
                finite = False
                restarts += 1
                tracing.registry().counter("ann/kmeans_restart").inc()
                R.log_event("ann_kmeans_restart", iter=it, restart=restart, seed=seed + restart)
                log.warning("train_ivf: non-finite centroids at iter %d (restart %d) — "
                            "restarting with seed %d", it, restart, seed + restart + 1)
                break
            cand = nxt
        if finite:
            return cand, restarts
    raise AnnError(f"k-means produced non-finite centroids through "
                   f"{MAX_KMEANS_RESTARTS + 1} seeded restarts — inspect the store for "
                   "pathological rows (`dcr-search verify`)")


def train_ivf(store_dir: str | Path, *, n_lists: int = DEFAULT_N_LISTS,
              iters: int = DEFAULT_IVF_ITERS, seed: int = 0, train_rows: int = 0,
              normalize: bool = False,
              device: str | torch.device = "cuda") -> dict:
    """Train the IVF quantizer over the committed store on ``device``
    (:func:`kmeans`) and materialise the inverted lists as a new ann
    snapshot.

    ``train_rows > 0`` subsamples the corpus for the Lloyd loop
    (deterministically, from ``seed``); materialisation covers every
    committed row. ``normalize=True`` L2-normalises rows before training and
    materialisation (recorded in the manifest; cosine consumers need it when
    the store was not built normalised). Returns the report the CLI prints.
    """
    if int(n_lists) < 1:
        raise AnnError(f"n_lists must be >= 1, got {n_lists}")
    if int(iters) < 1:
        raise AnnError(f"iters must be >= 1, got {iters}")
    device = resolve_device(device)
    reader = EmbeddingStoreReader(store_dir)
    feats, key_list = reader.load_all()
    keys = np.asarray(key_list, dtype=object)
    total = feats.shape[0]
    if total < n_lists:
        raise AnnError(f"store has {total} rows < n_lists={n_lists} — lower --n_lists or "
                       "grow the store (IVF needs at least one row per centroid)")
    if normalize and not reader.normalized:
        feats = normalize_rows(feats)
    normalized = bool(normalize) or reader.normalized
    if train_rows and 0 < train_rows < total:
        pick = np.sort(np.random.default_rng(seed).choice(total, int(train_rows),
                                                          replace=False))
        train_feats = feats[pick]
    else:
        train_feats = feats
    t0 = time.monotonic()
    centroids, restarts = kmeans(train_feats, int(n_lists), int(iters), int(seed),
                                 device=device)
    assign = assign_rows(feats, centroids)
    adir = ann_dir(store_dir)
    adir.mkdir(parents=True, exist_ok=True)
    with StoreWriterLease(adir, owner="train-ivf").acquire():
        snapshot = ann_snapshot_version(store_dir) + 1
        buf = BytesIO()
        np.savez(buf, centroids=centroids)
        cent_entry = _publish_blob(adir, f"centroids_v{snapshot}.npz", buf.getvalue())
        entries, list_total = _materialize_lists(adir, snapshot, n_lists, assign, feats, keys)
        doc = {
            "version": ANN_VERSION,
            "kind": ANN_KIND,
            "created_at": time.time(),
            "embed_dim": reader.embed_dim,
            "n_lists": int(n_lists),
            "normalized": normalized,
            "seed": int(seed),
            "iters": int(iters),
            "train_rows": int(train_feats.shape[0]),
            "restarts": restarts,
            "total": list_total,
            "store_snapshot": reader.snapshot,
            "store_wal_through": reader.wal_through,
            "centroids": cent_entry,
            "lists": entries,
        }
        _commit_manifest(adir, doc, snapshot)
    nonempty = sum(1 for e in entries if e["count"])
    reg = tracing.registry()
    reg.gauge("ann/lists").set(n_lists)
    reg.gauge("ann/index_rows").set(list_total)
    seconds = round(time.monotonic() - t0, 3)
    log.info("train_ivf: committed ann snapshot v%d — %d rows in %d/%d nonempty lists "
             "(%d iters, %d restart(s), %.3f s on %s)", snapshot, list_total, nonempty,
             n_lists, iters, restarts, seconds, device)
    return {"snapshot": snapshot, "n_lists": int(n_lists), "rows": list_total,
            "nonempty_lists": nonempty, "iters": int(iters), "restarts": restarts,
            "normalized": normalized, "seconds": seconds}


# ---------------------------------------------------------------------------
# Incremental folds and list rebuild (the store is the source of truth)
# ---------------------------------------------------------------------------

def fold_rows(store_dir: str | Path, feats: np.ndarray, keys: Sequence[str]) -> dict:
    """Fold new rows (the live tier's just-compacted WAL rows) into their
    inverted lists: assign them against the committed centroids, rewrite only
    the lists they touch under a new snapshot, and keep every other list's
    manifest entry (file and sha256) byte-identical. A touched list that
    fails verification is first rebuilt from the committed store, so a fold
    never drops the rows a list held."""
    feats = np.asarray(feats, np.float32)
    keys_arr = np.asarray([str(k) for k in keys], dtype=object)
    if feats.ndim != 2 or len(keys_arr) != feats.shape[0]:
        raise AnnError(f"fold_rows: features {feats.shape} with {len(keys_arr)} keys — "
                       "torn input")
    reader = AnnIndexReader(store_dir)
    if feats.shape[0] and feats.shape[1] != reader.embed_dim:
        raise AnnError(f"fold_rows: width {feats.shape[1]} != ann width {reader.embed_dim}")
    if feats.shape[0] == 0:
        return {"rows": 0, "lists_rewritten": 0, "snapshot": reader.snapshot}
    centroids = reader.load_centroids()
    if reader.normalized:
        feats = normalize_rows(feats)
    assign = assign_rows(feats, centroids)
    affected = sorted(set(int(a) for a in assign))
    adir = reader.dir
    with StoreWriterLease(adir, owner="ann-fold").acquire():
        snapshot = reader.snapshot + 1
        by_id = {int(e["list"]): dict(e) for e in reader.manifest["lists"]}
        rebuilt = 0
        for list_id in affected:
            entry = by_id.get(list_id)
            if entry is None:
                raise AnnError(f"ann manifest has no list {list_id} (n_lists={reader.n_lists})")
            loaded = reader.load_list(entry)
            if loaded is None:
                old_feats, old_keys = _derive_list_rows(store_dir, centroids, list_id,
                                                        normalized=reader.normalized)
                rebuilt += 1
                tracing.registry().counter("ann/list_rebuilt").inc()
            else:
                _codes, old_feats, old_keys, _s, _z = loaded
            mask = assign == list_id
            new_feats = (np.concatenate([old_feats, feats[mask]]) if old_feats.size
                         else feats[mask])
            new_keys = (np.concatenate([old_keys, keys_arr[mask]]) if len(old_keys)
                        else keys_arr[mask])
            by_id[list_id] = _publish_list(adir, snapshot, list_id, new_feats, new_keys)
        entries = [by_id[i] for i in sorted(by_id)]
        doc = dict(reader.manifest)
        doc.pop("snapshot", None)
        doc.update(created_at=time.time(), total=sum(int(e["count"]) for e in entries),
                   lists=entries)
        _commit_manifest(adir, doc, snapshot)
    reg = tracing.registry()
    reg.counter("ann/fold_rows_total").inc(int(feats.shape[0]))
    reg.counter("ann/lists_folded_total").inc(len(affected))
    reg.gauge("ann/index_rows").set(int(doc["total"]))
    log.info("fold_rows: %d row(s) into %d list(s) (%d rebuilt) — ann snapshot v%d",
             feats.shape[0], len(affected), rebuilt, snapshot)
    return {"rows": int(feats.shape[0]), "lists_rewritten": len(affected),
            "lists_rebuilt": rebuilt, "snapshot": snapshot}


def _derive_list_rows(store_dir: str | Path, centroids: np.ndarray, list_id: int, *,
                      normalized: bool) -> tuple[np.ndarray, np.ndarray]:
    """Re-derive one list's rows from the committed store: a quarantined
    list loses nothing that cannot be recomputed."""
    store = EmbeddingStoreReader(store_dir)
    feats_parts: list[np.ndarray] = []
    keys_parts: list[np.ndarray] = []
    for feats, ks in store.iter_shards():
        if normalized and not store.normalized:
            feats = normalize_rows(feats)
        mask = assign_rows(feats, centroids) == list_id
        if mask.any():
            feats_parts.append(feats[mask])
            keys_parts.append(np.asarray(ks, dtype=object)[mask])
    if not feats_parts:
        return np.zeros((0, store.embed_dim), np.float32), np.zeros((0,), dtype=object)
    return np.concatenate(feats_parts), np.concatenate(keys_parts)


def rebuild_list(store_dir: str | Path, list_id: int) -> dict:
    """Rebuild one quarantined or damaged inverted list from the committed
    store and commit it under a new snapshot (verify, quarantine, rebuild:
    the recovery the ``ivf_list_corrupt`` fault kind drives)."""
    reader = AnnIndexReader(store_dir)
    if not 0 <= int(list_id) < reader.n_lists:
        raise AnnError(f"list {list_id} out of range (n_lists={reader.n_lists})")
    centroids = reader.load_centroids()
    feats, keys = _derive_list_rows(store_dir, centroids, int(list_id),
                                    normalized=reader.normalized)
    adir = reader.dir
    with StoreWriterLease(adir, owner="ann-rebuild").acquire():
        snapshot = reader.snapshot + 1
        by_id = {int(e["list"]): dict(e) for e in reader.manifest["lists"]}
        by_id[int(list_id)] = _publish_list(adir, snapshot, int(list_id), feats, keys)
        entries = [by_id[i] for i in sorted(by_id)]
        doc = dict(reader.manifest)
        doc.pop("snapshot", None)
        doc.update(created_at=time.time(), total=sum(int(e["count"]) for e in entries),
                   lists=entries)
        _commit_manifest(adir, doc, snapshot)
    tracing.registry().counter("ann/list_rebuilt").inc()
    log.info("rebuild_list: list %d rebuilt from store (%d rows) — ann snapshot v%d",
             list_id, feats.shape[0], snapshot)
    return {"list": int(list_id), "rows": int(feats.shape[0]), "snapshot": snapshot}


def ann_stats(store_dir: str | Path) -> Optional[dict]:
    """Read-only summary of the ann tier for ``stats`` (None when no index
    is committed; never quarantines)."""
    if not has_ann_index(store_dir):
        return None
    reader = AnnIndexReader(store_dir, quarantine=False)
    counts = [int(e["count"]) for e in reader.manifest["lists"]]
    return {
        "snapshot": reader.snapshot,
        "store_snapshot": reader.store_snapshot,
        "n_lists": reader.n_lists,
        "nonempty_lists": sum(1 for c in counts if c),
        "rows": reader.total,
        "max_list_rows": max(counts) if counts else 0,
        "normalized": reader.normalized,
        "quantization": "int8-affine-per-list",
        "seed": reader.manifest.get("seed"),
        "iters": reader.manifest.get("iters"),
    }
