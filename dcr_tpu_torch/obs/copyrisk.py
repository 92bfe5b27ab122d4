"""Live copy-risk scoring: online SSCD gen↔train similarity.

Counterpart of ``dcr_tpu/obs/copyrisk.py``. A :class:`CopyRiskIndex` holds
a train-set embedding index on the device and scores batches of generated
images as they are produced: the serving layer's ``copy_risk`` response
field and ``POST /check``, and the trainer's sample-grid ``risk/*`` gauges.

- Dumps interoperate: :func:`load_risk_dump` reads the ``search/embed``
  ``.npz`` format (either package's) and the reference toolchain's pickle
  ``{'features', 'indexes'}`` through ``search/embed.load_embeddings``; a
  dump that cannot be parsed is quarantined
  (``<name>.quarantined.<pid>.<ts>``) and counted, one that parses but fails
  verification stays in place; both raise :class:`RiskIndexError`.
- Three backends, one API: a dense index (``risk.index_path``, the whole
  dump on the device, one f32 matmul and ``torch.topk``), a store
  (``risk.store_dir``, scored through ``search/shardindex.ShardedTopK``
  with ``normalize_queries``), or the store's IVF tier (``risk.ann``,
  ``search/annindex.AnnEngine``, trained with ``--ivf_normalize=true``).
- With a store, :meth:`CopyRiskIndex.refresh_store` swaps the engine onto
  the store's newest snapshot (the ingest pump calls it after each
  compaction), and ``live_tail`` merges the acked but uncompacted WAL rows
  into every answer. ``recall_probe`` (:mod:`dcr_tpu_torch.obs.recall_probe`)
  samples the ANN answers against the full-probe oracle.
- The query embedder is SSCD from ``eval/runner.build_backbone``, with the
  weights of ``risk.weights_path`` or the seeded init (seed 0) the port's
  ``search/embed.embed_images`` uses, so an index embedded by the port
  scores the same pixels at ~1.0.
- Scoring never perturbs generation: images are scored on host copies after
  the sampler ran.
- The index stays on one local device, in a job of several processes too,
  as the JAX index keeps a local 1-device mesh on purpose
  (``dcr_tpu/obs/copyrisk.py:382-387``): its engines are built without a
  mesh, so scoring never enters a cross-rank exchange or barrier (serve and
  the trainer's sample hook, which scores on rank 0 alone).

Similarity is cosine: index rows are L2-normalised at load and queries in
the scorer. The JAX scorer is an XLA program, not a Pallas kernel; here it
is PyTorch ops with TF32 off (``shardindex.full_f32_matmul``). Scores agree
with the JAX index to f32 rounding and keys away from near-ties (the search
slice's tie rule); ``torch.topk`` orders exact ties arbitrarily on a GPU.
"""

from __future__ import annotations

import base64
import json
import logging
import threading
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dcr_tpu_torch.core import fsio
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.config import RiskConfig
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.data.dataset import resize_shorter_side
from dcr_tpu_torch.eval.features import IMAGENET_NORM, make_extractor, reference_resize_for
from dcr_tpu_torch.native import jpeg_decoder
from dcr_tpu_torch.sampling.png import SIGNATURE as PNG_SIGNATURE
from dcr_tpu_torch.sampling.png import decode_png, write_png
from dcr_tpu_torch.search.shardindex import full_f32_matmul

log = logging.getLogger("dcr_tpu_torch")

#: SSCD embedding width; a dump of another width fails verification loudly
EMBED_DIM = 512


class RiskIndexError(RuntimeError):
    """The train-embedding dump could not be loaded or verified. The serve
    worker maps this to risk status "failed" (scoring disabled, admission
    unaffected)."""


class RiskUnavailableError(RuntimeError):
    """A /check query arrived while no loaded index can serve it (status
    absent, loading or failed): HTTP 503."""

    def __init__(self, msg: str, status: str = "absent"):
        super().__init__(msg)
        self.status = status


# ---------------------------------------------------------------------------
# Dump loading: verify before use, quarantine on damage
# ---------------------------------------------------------------------------

def verify_risk_dump(features: np.ndarray, keys: Sequence[str]) -> np.ndarray:
    """Structural checks a dump must pass before anything touches it;
    returns float32 features. Raises RiskIndexError naming the defect."""
    features = np.asarray(features)
    if features.ndim != 2 or features.shape[0] == 0:
        raise RiskIndexError(
            f"embedding dump features must be a non-empty [N, D] matrix, "
            f"got shape {features.shape}")
    if features.shape[1] != EMBED_DIM:
        raise RiskIndexError(
            f"embedding dump width {features.shape[1]} != SSCD embed dim "
            f"{EMBED_DIM} — wrong backbone or truncated dump")
    features = features.astype(np.float32, copy=False)
    if not np.isfinite(features).all():
        raise RiskIndexError("embedding dump contains non-finite features")
    if len(keys) != features.shape[0]:
        raise RiskIndexError(
            f"embedding dump has {features.shape[0]} features but "
            f"{len(keys)} indexes — torn dump")
    return features


def load_risk_dump(path: str | Path, *,
                   quarantine: bool = True) -> tuple[np.ndarray, list[str]]:
    """Read and verify a train-embedding dump (.npz or reference pickle).

    A file that cannot be parsed at all (a truncated zip, a bit-flipped
    pickle, a sidecar mismatch) is quarantine-renamed, so the next
    incarnation does not retry a known-bad dump forever; a readable dump
    that fails verification (wrong width, torn, non-finite rows) stays in
    place, since it may be a valid artifact of the wrong kind shared by
    others. Every failure bumps a ``copy_risk/*`` counter and raises
    :class:`RiskIndexError`."""
    from dcr_tpu_torch.search.embed import load_embeddings

    path = Path(path)
    if not path.exists():
        raise RiskIndexError(f"no embedding dump at {path}")
    try:
        features, keys = load_embeddings(path)
    except Exception as e:  # unreadable, unpicklable or corrupt-zip damage
        _quarantine_dump(path, repr(e), quarantine)
        raise RiskIndexError(f"corrupt embedding dump {path}: {e!r}") from e
    try:
        features = verify_risk_dump(features, keys)
    except RiskIndexError as e:
        R.log_event("risk_index_invalid", path=str(path), error=str(e))
        R.bump_counter("copy_risk/index_invalid_total")
        raise
    return features, [str(k) for k in keys]


def _quarantine_dump(path: Path, reason: str, quarantine: bool) -> None:
    R.log_event("risk_index_corrupt", path=str(path), error=reason)
    R.bump_counter("copy_risk/index_corrupt_total")
    if quarantine:
        from dcr_tpu_torch.search.embed import quarantine_sidecar

        dest = fsio.quarantine_rename(path)
        quarantine_sidecar(path)
        if dest is not None:
            log.warning("copyrisk: quarantined corrupt dump %s -> %s", path, dest.name)


# ---------------------------------------------------------------------------
# The scorer
# ---------------------------------------------------------------------------

@compile_surface("risk/score")
def make_risk_scorer(top_k: int) -> Callable[[torch.Tensor, torch.Tensor],
                                             tuple[torch.Tensor, torch.Tensor]]:
    """``(index_feats [N, D], q [B, D]) -> (sims [B, K], idx [B, K])``: the
    queries L2-normalised (the index is normalised once at load), one f32
    matmul without TF32, ``torch.topk``. The index rides as an argument, so
    one scorer serves any index of the same width."""

    def score(index_feats: torch.Tensor, q: torch.Tensor):
        q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True).clamp_min(1e-12)
        with full_f32_matmul():
            sims = q @ index_feats.T
        return torch.topk(sims, top_k, dim=1)

    return score


# ---------------------------------------------------------------------------
# Image preparation: the embed pipeline's transform, inline
# ---------------------------------------------------------------------------

def prepare_images(images: np.ndarray, image_size: int) -> np.ndarray:
    """Generated float [B, H, W, 3] images in [0, 1] -> the SSCD input batch.

    The port's embedding pipeline exactly (``search/embed.embed_images`` on
    a folder: shorter-side resize to the reference's 256/224 ratio with
    ``data/dataset.resize_shorter_side``, centre crop, ImageNet
    normalisation), INCLUDING the uint8 round trip a PNG on disk takes, so
    an index built by embedding saved generations scores a live generation
    of the same pixels at ~1.0."""
    mean = np.asarray(IMAGENET_NORM[0], np.float32)
    std = np.asarray(IMAGENET_NORM[1], np.float32)
    resize_to = reference_resize_for(image_size)
    out = []
    for img in np.asarray(images):
        arr = (np.clip(img, 0.0, 1.0) * 255.0).round().astype(np.uint8)
        arr = resize_shorter_side(arr, resize_to)
        h, w = arr.shape[:2]
        left, top = (w - image_size) // 2, (h - image_size) // 2
        arr = np.asarray(arr[top:top + image_size, left:left + image_size], np.float32) / 255.0
        out.append((arr - mean) / std)
    return np.stack(out)


def decode_image_b64(body: dict) -> np.ndarray:
    """``POST /check`` body -> float [H, W, 3] image in [0, 1], with the
    port's PNG and JPEG readers. ValueError (a 400-class error) on anything
    undecodable: client input never becomes a 500."""
    data = body.get("image_png_b64") or body.get("image_b64")
    if not isinstance(data, str) or not data:
        raise ValueError("body must carry 'image_png_b64' (base64-encoded PNG/JPEG)")
    try:
        raw = base64.b64decode(data, validate=True)
        if raw.startswith(PNG_SIGNATURE):
            arr = decode_png(raw)
        elif raw.startswith(b"\xff\xd8"):
            arr = jpeg_decoder.decode(raw, name="check request")
        else:
            raise ValueError("neither a PNG nor a JPEG")
    except Exception as e:
        raise ValueError(f"undecodable image: {e!r}") from e
    return np.asarray(arr, np.float32) / 255.0


# ---------------------------------------------------------------------------
# The index
# ---------------------------------------------------------------------------

@dataclass
class RiskScore:
    """One generation's copy-risk verdict."""

    max_sim: float
    top_key: str
    topk: list            # [(train key, sim)] best-first, top_k entries

    def doc(self, threshold: float) -> dict:
        """The wire form (the ``copy_risk`` response field, POST /check)."""
        return {"max_sim": round(self.max_sim, 6), "top_key": self.top_key,
                "flagged": bool(self.max_sim >= threshold),
                "topk": [[k, round(s, 6)] for k, s in self.topk]}


class CopyRiskIndex:
    """A train-set embedding index and its scoring pipeline on ``device``.

    ``score_batch`` is thread-safe after :meth:`build` (the serve worker
    thread and /check handler threads share one index); ``build`` and
    :meth:`refresh_store` are serialized by an internal lock, and each
    scoring call keeps the engine it started with. Dense mode holds the
    whole dump on the device; store mode (``store``, an
    ``EmbeddingStoreReader``) scores through the search slice's
    ``ShardedTopK``, or with ``cfg.ann`` through the IVF tier's
    ``AnnEngine``."""

    def __init__(self, features: Optional[np.ndarray], keys: Optional[Sequence[str]],
                 cfg: RiskConfig, *, batch: int, store=None,
                 device: str | torch.device = "cuda"):
        self._store = store
        if store is None:
            features = verify_risk_dump(features, keys)
            norms = np.linalg.norm(features, axis=-1, keepdims=True)
            self._features_host = features / np.maximum(norms, 1e-12)
            self.keys = [str(k) for k in keys]
            n_index = len(self.keys)
        else:
            if store.embed_dim != EMBED_DIM:
                raise RiskIndexError(
                    f"embedding store width {store.embed_dim} != SSCD embed "
                    f"dim {EMBED_DIM} — wrong backbone")
            if store.total <= 0:
                raise RiskIndexError(f"embedding store {store.dir} holds no rows")
            self._features_host = None
            self.keys = []            # never materialized in store mode
            n_index = store.total
        self.cfg = cfg
        self.batch = int(batch)
        self.top_k = min(int(cfg.top_k), n_index)
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        self._built = False
        self._feats_dev = None
        self._extract = None
        self._score = None
        self._engine = None           # ShardedTopK or AnnEngine (store mode)
        # the live-tail provider: the serve worker sets it to the ingest
        # pump's ``tail(after_seq)``, called with the engine snapshot's
        # wal_through, so committed plus tail is one consistent corpus
        self.live_tail: Optional[Callable[[int], tuple[np.ndarray, np.ndarray]]] = None
        # the sampled shadow-exact recall probe (obs/recall_probe.RecallProbe),
        # attached by the serve worker when the ANN tier scores
        self.recall_probe = None

    def __len__(self) -> int:
        return self._store.total if self._store is not None else len(self.keys)

    # -- construction --------------------------------------------------------

    @classmethod
    def load(cls, cfg: RiskConfig, *, batch: int, device: str | torch.device = "cuda",
             build: bool = True) -> "CopyRiskIndex":
        """Load ``cfg.store_dir`` (takes precedence) or ``cfg.index_path``
        and, with ``build``, the scoring pipeline too, so a status of "ok"
        means scoring is ready. Raises :class:`RiskIndexError` on a bad dump
        or store."""
        if cfg.store_dir:
            from dcr_tpu_torch.search.store import EmbeddingStoreReader, StoreError

            try:
                reader = EmbeddingStoreReader(cfg.store_dir)
            except StoreError as e:
                R.log_event("risk_store_invalid", path=cfg.store_dir, error=str(e))
                R.bump_counter("copy_risk/index_invalid_total")
                raise RiskIndexError(f"embedding store {cfg.store_dir}: {e}") from e
            index = cls(None, None, cfg, batch=batch, store=reader, device=device)
        else:
            features, keys = load_risk_dump(cfg.index_path)
            index = cls(features, keys, cfg, batch=batch, device=device)
        if build:
            index.build()
        return index

    def _sscd_state(self) -> Optional[dict]:
        """SSCD weights of ``cfg.weights_path``, else None: the seeded init
        (seed 0) the port's embedding pipeline uses, self-consistent with
        the dumps it writes."""
        if not self.cfg.weights_path:
            return None
        from dcr_tpu_torch.eval.runner import load_backbone_params

        return R.retry_call(
            lambda: load_backbone_params("sscd", "resnet50_disc", self.cfg.weights_path),
            name="load_risk_sscd_weights")

    def build(self) -> "CopyRiskIndex":
        """Build SSCD and put the index on the device. Idempotent; safe to
        call from a background loader thread while admission proceeds."""
        from dcr_tpu_torch.eval.runner import build_backbone

        with self._lock, torch.inference_mode():
            if self._built:
                return self
            model = build_backbone("sscd", "resnet50_disc", self.device,
                                   state_dict=self._sscd_state(), seed=0)
            self._extract = make_extractor(model, self.device)
            if self._store is not None:
                self._engine = self._store_engine(self._store, self.cfg.segment_rows)
            else:
                self._feats_dev = torch.from_numpy(
                    np.ascontiguousarray(self._features_host)).to(self.device)
                self._score = make_risk_scorer(self.top_k)
            self._built = True
            log.info("copyrisk: index ready — %d train embeddings, batch=%d, top_k=%d (%s)",
                     len(self), self.batch, self.top_k,
                     "dense" if self._store is None else "ann" if self.cfg.ann else "store")
        return self

    def _store_engine(self, reader, segment_rows: int):
        """The built engine over ``reader``'s store: the IVF tier with
        ``cfg.ann`` (cosine: queries normalised, the tier must hold
        normalised rows, else the engine refuses rather than mis-rank), else
        the exact engine (queries normalised on the device, rows at segment
        load unless the store was built normalised)."""
        if self.cfg.ann:
            from dcr_tpu_torch.search.annindex import AnnEngine

            return AnnEngine(reader.dir, top_k=self.top_k, nprobe=self.cfg.nprobe,
                             query_batch=self.batch, segment_rows=segment_rows,
                             normalize_queries=True, require_normalized_rows=True,
                             device=self.device).build()
        from dcr_tpu_torch.search.shardindex import ShardedTopK

        return ShardedTopK(reader, top_k=self.top_k, query_batch=self.batch,
                           segment_rows=segment_rows, normalize_queries=True,
                           normalize_rows=not reader.normalized, device=self.device).build()

    def refresh_store(self) -> bool:
        """Re-open the store at its newest snapshot and rebuild the engine
        with the running one's kind and geometry, then swap it in under the
        lock: a scoring call in flight keeps the engine, and so the
        snapshot, it started with. True when a newer snapshot was picked up.
        A compaction racing the rebuild raises the retryable
        :class:`~dcr_tpu_torch.search.store.StoreSnapshotChangedError`; one
        retry lands on the newer snapshot."""
        from dcr_tpu_torch.search.store import EmbeddingStoreReader, StoreSnapshotChangedError

        if self._store is None:
            return False
        with self._lock, torch.inference_mode():
            if not self._built:
                return False
            old = self._engine
            for attempt in (0, 1):
                reader = EmbeddingStoreReader(self._store.dir)
                if reader.snapshot == self._store.snapshot and reader.total == self._store.total:
                    return False
                try:
                    engine = self._store_engine(reader, old.segment_rows)
                    break
                except StoreSnapshotChangedError as e:
                    if attempt:
                        raise
                    log.info("copyrisk: %s — retrying against the newer snapshot", e)
            self._engine = engine
            self._store = reader
            log.info("copyrisk: store refreshed — snapshot v%d, %d rows", reader.snapshot,
                     reader.total)
            return True

    # -- scoring -------------------------------------------------------------

    def score_batch(self, images: np.ndarray) -> list[RiskScore]:
        """Score up to ``batch`` generated images (float [n, H, W, 3] in [0,
        1]); pads to the fixed batch shape with copies of the last image and
        discards the pad rows."""
        return self.score_batch_with_features(images)[0]

    def score_batch_with_features(self, images: np.ndarray
                                  ) -> tuple[list[RiskScore], np.ndarray]:
        """:meth:`score_batch` plus the SSCD embeddings [n, 512] it scored."""
        if not self._built:
            self.build()
        images = np.asarray(images)
        if images.ndim == 3:
            images = images[None]
        n = images.shape[0]
        if n == 0:
            return [], np.zeros((0, EMBED_DIM), np.float32)
        if n > self.batch:
            raise ValueError(f"score_batch of {n} exceeds the batch shape {self.batch}")
        prep = prepare_images(images, self.cfg.image_size)
        if n < self.batch:
            prep = np.concatenate([prep, np.repeat(prep[-1:], self.batch - n, axis=0)])
        with torch.inference_mode():
            feats = self._extract(prep).float()
            feats_n = feats.cpu().numpy()[:n]
            engine = self._engine   # one engine per call: a refresh swaps it whole
            if engine is not None:
                sims, key_rows = self._query_store(engine, feats_n)
                scores = [RiskScore(max_sim=float(row_sims[0]), top_key=str(row_keys[0]),
                                    topk=[(str(k), float(s))
                                          for s, k in zip(row_sims, row_keys)])
                          for row_sims, row_keys in zip(sims, key_rows)]
                return scores, feats_n
            sims, idx = self._score(self._feats_dev, feats)
            sims = sims.cpu().numpy()[:n]
            idx = idx.cpu().numpy()[:n]
        out = []
        for row_sims, row_idx in zip(sims, idx):
            topk = [(self.keys[int(i)], float(s)) for s, i in zip(row_sims, row_idx)]
            out.append(RiskScore(max_sim=topk[0][1], top_key=topk[0][0], topk=topk))
        return out, feats_n

    def _query_store(self, engine, feats_n: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """The engine's top-k merged with the live tail's, the
        ``ann/staleness_rows`` gauge and the recall probe (ANN only)."""
        from dcr_tpu_torch.search.livestore import query_live

        tail_feats = tail_keys = None
        if self.live_tail is None:
            sims, key_rows = engine.query(feats_n)
        else:
            tail_feats, tail_keys = self.live_tail(engine.reader.wal_through)
            sims, key_rows = query_live(engine.reader.dir, feats_n, engine=engine,
                                        tail=(tail_feats, tail_keys))
        if hasattr(engine, "ann"):
            # the rows the inverted lists do not cover yet (committed but
            # unfolded, and the live tail): still served exactly, but rows
            # the approximate candidate walk cannot return
            stale = max(0, int(engine.reader.total) - int(engine.total))
            if tail_feats is not None:
                stale += int(len(tail_feats))
            tracing.registry().gauge("ann/staleness_rows").set(stale)
            probe = self.recall_probe
            if probe is not None:
                try:
                    probe.observe(engine, feats_n, key_rows, tail_feats=tail_feats,
                                  tail_keys=tail_keys)
                except Exception:
                    # the probe is observability, scoring is the product: a
                    # probe failure is logged, never raised into a response
                    log.exception("copyrisk: recall probe failed")
        return sims, key_rows


# ---------------------------------------------------------------------------
# Shared scoring and telemetry helpers (serve worker + trainer sample hook)
# ---------------------------------------------------------------------------

def observe_scores(scores: Sequence[RiskScore], threshold: float) -> dict:
    """Feed one scored batch into the telemetry registry (the
    ``dcr_copy_risk_sim`` summary and the ``dcr_copy_risk_*_total``
    counters) and return the aggregate the caller logs or exports."""
    reg = tracing.registry()
    hist = reg.histogram("copy_risk/sim")
    flagged = 0
    for s in scores:
        hist.observe(s.max_sim)
        if s.max_sim >= threshold:
            flagged += 1
    reg.counter("copy_risk/scored_total").inc(len(scores))
    if flagged:
        reg.counter("copy_risk/flagged_total").inc(flagged)
    sims = [s.max_sim for s in scores]
    return {"scored": len(scores), "flagged": flagged,
            "max_sim": max(sims) if sims else 0.0,
            "mean_sim": float(np.mean(sims)) if sims else 0.0}


class EvidenceRecorder:
    """Bounded evidence dumps for flagged generations: the image (PNG) and a
    JSON sidecar naming the nearest train key, at most ``max_evidence`` per
    process. A write failure is counted, never raised, and refunds its
    slot: the bound is on evidence kept, not on attempts."""

    def __init__(self, directory: Optional[str | Path], max_evidence: int):
        self.dir = Path(directory) if directory else None
        self.max_evidence = int(max_evidence)
        self._count = 0
        self._lock = threading.Lock()

    def record(self, image: np.ndarray, score: RiskScore,
               threshold: float, **context) -> Optional[Path]:
        """Returns the JSON sidecar path, or None when disabled or saturated."""
        if self.dir is None or self.max_evidence <= 0:
            return None
        with self._lock:
            if self._count >= self.max_evidence:
                tracing.registry().counter("copy_risk/evidence_dropped_total").inc()
                return None
            self._count += 1
            seq = self._count
        try:
            self.dir.mkdir(parents=True, exist_ok=True)
            stem = f"flagged_{seq:04d}_{context.get('request_id', 'x')}"
            arr = (np.clip(np.asarray(image), 0, 1) * 255).round()
            write_png(self.dir / f"{stem}.png", arr.astype(np.uint8))
            doc = {"max_sim": score.max_sim, "top_key": score.top_key,
                   "topk": score.topk, "threshold": threshold,
                   "image": f"{stem}.png", "time": time.time(), **context}
            path = self.dir / f"{stem}.json"
            path.write_text(json.dumps(doc, sort_keys=True) + "\n")
            tracing.registry().counter("copy_risk/evidence_dumped_total").inc()
            return path
        except Exception as e:
            # evidence is diagnostics: a full disk must not fail generation
            with self._lock:
                self._count -= 1
            R.log_event("risk_evidence_write_failed", error=repr(e))
            R.bump_counter("copy_risk/evidence_write_failed")
            return None
