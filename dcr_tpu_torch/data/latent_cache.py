"""The persistent latent cache: the frozen encoders' work, computed once.

Counterpart of ``dcr_tpu/data/latent_cache.py``, with its on-disk format, so
a cache either package writes opens in the other's reader.
``dcr-precompute-latents-torch`` (``cli/precompute.py``) runs the encode
stage (``diffusion/encode_stage.py``, ``emit="moments"``) over a dataset
once; this module keeps, per active dataset index:

- the VAE posterior moments (mean and std, not a sample: the sample stays a
  draw of each occurrence on the ``vae_sample`` stream, so one cache serves
  every epoch and duplication regime);
- the frozen text embedding (``ctx``) of that index's caption.

A manifest keys the cache on a fingerprint of everything the rows depend
on: the frozen VAE and text params (:func:`params_digest`, the JAX
package's digest of the Flax trees, byte for byte), the dataset's paths,
resolution, crop and caption regime, and the tokenizer. A cache built from
other weights or another dataset is refused by key, never trained on.

Every shard is sha256-verified from its bytes before ``np.load`` reads it,
then checked for row counts and finite values; a damaged shard is
quarantine-renamed, counted (``latentcache/*``) and its indices become
misses, which the producer encodes live (``encode_stage.cached_encode``).
``latent_cache_corrupt@load=N`` (``utils/faults.py``) damages the Nth shard
read in memory, to drive that path. The JAX package's
``latentcache/finalized`` and ``latentcache/loaded`` trace events wait for
the port's trace sink.

Layout (arrays as the JAX package writes them: ``mean`` and ``std``
[N, h, w, C] f32, ``ctx`` [N, L, D] f32, ``index`` [N] int64)::

    <dir>/manifest.json           # version, fingerprint, total, shards
    <dir>/shard_00000.npz         # index / mean / std / ctx
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from io import BytesIO
from pathlib import Path
from typing import Any, Iterator, Optional

import numpy as np
import torch

from dcr_tpu_torch.core import fsio
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core.fsio import quarantine_rename

CACHE_VERSION = 1
MANIFEST_NAME = "manifest.json"
DEFAULT_SHARD_SIZE = 512


class LatentCacheError(RuntimeError):
    """The cache directory cannot serve this run: no manifest, a corrupt
    or mismatched one, or no shard that verifies."""


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def _flax_leaves(tree: Any, path: tuple = ()) -> Iterator[tuple[str, np.ndarray]]:
    """(keystr, leaf) of a nested dict, the key path written as
    ``jax.tree_util.keystr`` writes one of dict keys: ``['a']['b']``."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flax_leaves(v, path + (k,))
    else:
        yield "".join(f"[{k!r}]" for k in path), tree


def params_digest(tree: dict) -> str:
    """The JAX package's content digest of a Flax param tree (nested dicts
    of arrays): per leaf, in key-path order, the key path, dtype, shape and
    bytes. Port state dicts go through ``models/export.*_to_flax`` first
    (:func:`frozen_digests`)."""
    h = hashlib.sha256()
    for key, leaf in sorted(_flax_leaves(tree), key=lambda kv: kv[0]):
        arr = np.asarray(leaf)
        h.update(key.encode())
        h.update(str(arr.dtype).encode() + str(arr.shape).encode())
        h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def frozen_digests(vae_params: dict[str, torch.Tensor], text_params: dict[str, torch.Tensor],
                   text_heads: int) -> tuple[str, str]:
    """(vae_sha, text_sha) of the port's state dicts, as the JAX package
    digests the same weights in its own layout."""
    from dcr_tpu_torch.models import export as EX

    return (params_digest(EX.vae_to_flax(vae_params)),
            params_digest(EX.text_to_flax(text_params, text_heads)))


def cache_fingerprint(cfg, dataset, tokenizer, *, vae_params, text_params) -> dict:
    """Everything a cached row depends on: equal fingerprints mean the
    cache holds what this run's encoders would compute. ``vae_params`` and
    ``text_params`` are the port's state dicts."""
    paths_sha = _sha("\n".join(
        dataset.paths[int(i)] for i in dataset.active_indices).encode())
    d, m = cfg.data, cfg.model
    vae_sha, text_sha = frozen_digests(vae_params, text_params, m.text_heads)
    fp = {
        "version": CACHE_VERSION,
        "vae_sha": vae_sha,
        "text_sha": text_sha,
        "tokenizer": tokenizer.fingerprint(),
        "dataset_sha": paths_sha,
        "samples": int(len(dataset)),
        "data": {
            "resolution": d.resolution, "center_crop": d.center_crop,
            "random_flip": d.random_flip, "class_prompt": d.class_prompt,
            "instance_prompt": d.instance_prompt,
            "caption_jsons": list(d.caption_jsons),
            "rand_caption_tokens": d.rand_caption_tokens,
            "trainsubset": d.trainsubset, "seed": d.seed,
        },
        "model": {
            "sample_size": m.sample_size,
            "vae_block_out_channels": list(m.vae_block_out_channels),
            "vae_latent_channels": m.vae_latent_channels,
            "vae_scaling_factor": m.vae_scaling_factor,
            "text_hidden_size": m.text_hidden_size,
            "text_max_length": m.text_max_length,
            "mixed_precision": cfg.mixed_precision,
        },
    }
    # one JSON round trip, so the fingerprint equals what a manifest reads
    # back as (tuples become lists)
    return json.loads(json.dumps(fp, sort_keys=True, default=str))


class LatentCacheWriter:
    """Gathers encoded rows and writes shards, then the manifest.

    Shards first, manifest last (temp file, fsync, rename): a killed
    precompute leaves a whole cache or no manifest, never a manifest naming
    shards that do not verify."""

    def __init__(self, cache_dir: str | Path, fingerprint: dict, *,
                 shard_size: Optional[int] = None):
        self.dir = Path(cache_dir)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.fingerprint = fingerprint
        self.shard_size = max(1, shard_size or DEFAULT_SHARD_SIZE)
        self._rows: list[tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]] = []
        self._pending = 0
        self._shards: list[dict] = []
        self._total = 0

    def add(self, index: np.ndarray, mean: np.ndarray, std: np.ndarray,
            ctx: np.ndarray) -> None:
        """Rows in the on-disk layout: ``mean``/``std`` [B, h, w, C]."""
        index = np.asarray(index, np.int64)
        self._rows.append((index, np.asarray(mean, np.float32),
                           np.asarray(std, np.float32), np.asarray(ctx, np.float32)))
        self._pending += len(index)
        while self._pending >= self.shard_size:
            self._flush_shard(self.shard_size)

    def _flush_shard(self, take: int) -> None:
        idx, mean, std, ctx = (np.concatenate([r[f] for r in self._rows]) for f in range(4))
        take = min(take, len(idx))
        buf = BytesIO()
        np.savez(buf, index=idx[:take], mean=mean[:take], std=std[:take], ctx=ctx[:take])
        blob = buf.getvalue()
        name = f"shard_{len(self._shards):05d}.npz"
        path = self.dir / name
        fsio.publish_durable(path.with_name(f"{name}.tmp.{os.getpid()}"), path, blob)
        self._shards.append({"file": name, "sha256": _sha(blob), "count": int(take)})
        self._total += take
        rest = (idx[take:], mean[take:], std[take:], ctx[take:])
        self._rows = [rest] if len(rest[0]) else []
        self._pending = len(rest[0])

    def finalize(self) -> Path:
        """Flush the tail shard and commit the manifest."""
        while self._pending:
            self._flush_shard(self.shard_size)
        doc = {"version": CACHE_VERSION, "created_at": time.time(),
               "fingerprint": self.fingerprint, "total": self._total,
               "shards": self._shards}
        path = self.dir / MANIFEST_NAME
        # the directory fsync: the manifest names the shards, so its rename
        # must not become durable before theirs
        fsio.publish_durable(path.with_name(f"{MANIFEST_NAME}.tmp.{os.getpid()}"), path,
                             json.dumps(doc, indent=1, sort_keys=True) + "\n",
                             sync_dir=True)
        return path


class LatentCacheReader:
    """Verify-before-load reader with quarantine per shard.

    Construction loads and verifies the whole cache. A manifest that is
    missing, unreadable or of another fingerprint raises
    :class:`LatentCacheError` (a run that asked for a cache must not fall
    back to a slow path unseen); a corrupt shard is quarantined and its
    indices become misses, so one bad shard does not cost the rest."""

    def __init__(self, cache_dir: str | Path, expected_fingerprint: Optional[dict] = None):
        self.dir = Path(cache_dir)
        self._load_seq = 0
        manifest = self._read_manifest()
        if expected_fingerprint is not None and \
                manifest["fingerprint"] != expected_fingerprint:
            diffs = _fingerprint_diff(manifest["fingerprint"], expected_fingerprint)
            R.bump_counter("latentcache/fingerprint_mismatch")
            raise LatentCacheError(
                f"latent cache {self.dir} was built for a different run: fingerprint "
                f"differs at {diffs} — re-run dcr-precompute-latents-torch for this "
                "config/weights")
        self.fingerprint = manifest["fingerprint"]
        self.total = int(manifest.get("total", 0))
        # per-shard arrays, gathered through an index -> (shard, row) map:
        # host memory holds the verified shards once
        self._row_of: dict[int, tuple[int, int]] = {}
        self._shards: list[tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        for shard in manifest["shards"]:
            arrays = self._load_shard(shard)
            if arrays is None:
                continue
            idx, mean, std, ctx = arrays
            si = len(self._shards)
            for j, i in enumerate(idx):
                self._row_of[int(i)] = (si, j)
            self._shards.append((mean, std, ctx))
        if not self._shards:
            raise LatentCacheError(f"latent cache {self.dir}: no shard survived "
                                   f"verification ({len(manifest['shards'])} listed)")
        self.cached = len(self._row_of)

    def _read_manifest(self) -> dict:
        path = self.dir / MANIFEST_NAME
        try:
            raw = R.read_bytes_with_retry(path, name="latent_cache_manifest")
        except FileNotFoundError:
            raise LatentCacheError(f"latent cache {self.dir} has no {MANIFEST_NAME} — run "
                                   "dcr-precompute-latents-torch first") from None
        except OSError as e:
            raise LatentCacheError(f"latent cache manifest unreadable: {e!r}") from e
        try:
            doc = json.loads(raw.decode("utf-8"))
            if not isinstance(doc.get("shards"), list) or "fingerprint" not in doc:
                raise ValueError("manifest missing shards/fingerprint")
            return doc
        except (UnicodeDecodeError, ValueError, AttributeError) as e:
            dest = quarantine_rename(path)
            R.log_event("latent_cache_manifest_corrupt", error=repr(e), path=str(path),
                        quarantined_to=str(dest) if dest else None)
            R.bump_counter("latentcache/manifest_corrupt")
            raise LatentCacheError(f"latent cache manifest corrupt ({e}); quarantined — "
                                   "re-run dcr-precompute-latents-torch") from e

    def _load_shard(self, shard: dict):
        from dcr_tpu_torch.utils import faults

        path = self.dir / str(shard.get("file", ""))
        try:
            blob = R.read_bytes_with_retry(path, name="latent_cache_shard")
        except OSError as e:
            self._quarantine(path, "shard_missing", repr(e), rename=False)
            return None
        seq = self._load_seq
        self._load_seq += 1
        if faults.fire("latent_cache_corrupt", load=seq) and blob:
            # damage the bytes in memory, so the real verify path runs
            mid = len(blob) // 2
            blob = blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:]
        if _sha(blob) != shard.get("sha256"):
            self._quarantine(path, "shard_corrupt", "sha256 mismatch")
            return None
        try:
            with np.load(BytesIO(blob)) as z:
                idx = np.asarray(z["index"], np.int64)
                mean, std, ctx = (np.asarray(z[k], np.float32) for k in ("mean", "std", "ctx"))
        except Exception as e:  # any damage np.load can meet
            self._quarantine(path, "shard_corrupt", f"unreadable npz: {e!r}")
            return None
        n = len(idx)
        if not (len(mean) == len(std) == len(ctx) == n == shard.get("count")):
            self._quarantine(path, "shard_corrupt", "row-count mismatch")
            return None
        if not (np.isfinite(mean).all() and np.isfinite(std).all()
                and np.isfinite(ctx).all()):
            self._quarantine(path, "shard_corrupt", "non-finite values")
            return None
        return idx, mean, std, ctx

    def _quarantine(self, path: Path, kind: str, detail: str, rename: bool = True) -> None:
        dest = quarantine_rename(path) if rename else None
        R.log_event("latent_cache_quarantined", kind=kind, detail=detail, shard=str(path),
                    quarantined_to=str(dest) if dest else None)
        R.bump_counter(f"latentcache/{kind}")

    def lookup(self, indices: np.ndarray):
        """(mean, std, ctx) rows for ``indices``, or None when any index is
        not cached (the caller encodes that batch live)."""
        rows = []
        for i in np.asarray(indices):
            row = self._row_of.get(int(i))
            if row is None:
                return None
            rows.append(row)
        return tuple(np.stack([self._shards[si][f][rj] for si, rj in rows])
                     for f in range(3))

    def coverage(self) -> tuple[int, int]:
        """(indices served from the cache, indices the manifest promised)."""
        return self.cached, self.total


def _fingerprint_diff(a: dict, b: dict, prefix: str = "") -> list[str]:
    """Dotted paths where two fingerprints differ."""
    diffs: list[str] = []
    for key in sorted(set(a) | set(b)):
        va, vb = a.get(key), b.get(key)
        path = f"{prefix}{key}"
        if isinstance(va, dict) and isinstance(vb, dict):
            diffs.extend(_fingerprint_diff(va, vb, prefix=f"{path}."))
        elif va != vb:
            diffs.append(path)
    return diffs[:10]
