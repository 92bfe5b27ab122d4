"""Stage 3: search the generations' embeddings against every LAION chunk.

Counterpart of ``dcr_tpu/search/search.py`` (the reference's
embedding_search/similarity_search.py). The brute force
(:func:`search_folders`) streams each chunk's dump to the device, scores
the generations against it in ``num_chunks`` chunks and takes each chunk's
top-k there with ``torch.topk``; only the [M, K] tables cross to the host,
where they merge into a running answer (the JAX version ships each [M, N]
similarity slab to the host and partitions it there; the answer is the same
up to f32 rounding and the order of near-ties). :func:`search_store` asks
the store's top-k engine instead, and :func:`search_store_ann` the IVF
tier's approximate engine; with ``live`` both merge in the store's WAL tail
(:mod:`dcr_tpu_torch.search.livestore`). Results land in a ``.npz`` with
named fields, as the JAX package writes them.

:func:`run_search` builds the mesh of ``cfg.mesh`` over the job's processes
(one process per device, ``core/dist``) and hands it to the engines, which
shard the store's rows over its ``data`` x ``fsdp`` ranks; every rank gets
the whole answer and rank 0 writes the file. The brute force takes no mesh
in the JAX package: on a mesh it runs on rank 0 alone.
"""

from __future__ import annotations

import logging
import time
from pathlib import Path
from typing import Sequence

import numpy as np
import torch

from dcr_tpu_torch.core import dist
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.compile_surface import compile_surface
from dcr_tpu_torch.core.config import SearchConfig
from dcr_tpu_torch.core.device import resolve_device
from dcr_tpu_torch.core.fsio import quarantine_rename
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.search.annindex import DEFAULT_NPROBE, DEFAULT_SHORTLIST_K, open_ann_engine
from dcr_tpu_torch.search.embed import find_embedding_file, load_embeddings, quarantine_sidecar
from dcr_tpu_torch.search.livestore import query_live
from dcr_tpu_torch.search.shardindex import merge_topk, open_engine, topk

log = logging.getLogger("dcr_tpu_torch")


#: the JAX package's name for the host merge; the brute force and the store
#: engine share one merge and one device top-k (:func:`shardindex.topk`)
topk_merge = merge_topk


def load_folder_embeddings(emb_file: Path, *, quarantine: bool = True):
    """One folder's dump as ``(features, keys)``, or None when the folder
    cannot serve.

    An unreadable dump (truncated zip, damaged pickle, sidecar mismatch) is
    corrupt: quarantine-renamed with its sidecar, counted
    (``search/folder_corrupt``) and logged. A readable dump that fails
    validation (rows and keys disagree, features not 2-D) stays in place,
    counted as ``search/folder_invalid``. A transient read error that outlived
    the retries skips the folder and keeps the dump."""
    reg = tracing.registry()
    try:
        feats, keys = load_embeddings(emb_file)
    except OSError as e:
        R.log_event("search_folder_read_error", path=str(emb_file), error=repr(e))
        reg.counter("search/folder_read_error").inc()
        log.warning("unreadable (I/O) embedding dump %s (%r); left in place, skipping",
                    emb_file, e)
        return None
    except Exception as e:  # unreadable or corrupt bytes
        dest = quarantine_rename(emb_file) if quarantine else None
        if quarantine:
            quarantine_sidecar(emb_file)
        R.log_event("search_folder_corrupt", path=str(emb_file), error=repr(e),
                    quarantined_to=str(dest) if dest else None)
        reg.counter("search/folder_corrupt").inc()
        log.warning("corrupt embedding dump %s (%r); quarantined -> %s", emb_file, e,
                    dest.name if dest else "<rename failed>")
        return None
    feats = np.asarray(feats)
    if feats.ndim != 2 or feats.shape[0] != len(keys):
        R.log_event("search_folder_invalid", path=str(emb_file), shape=list(feats.shape),
                    keys=len(keys))
        reg.counter("search/folder_invalid").inc()
        log.warning("invalid embedding dump %s (features %s, %d keys); left in place, "
                    "skipping", emb_file, feats.shape, len(keys))
        return None
    return np.asarray(feats, np.float32), keys


def _empty_result(top_k: int) -> dict:
    return {"scores": np.zeros((0, top_k), np.float32),
            "keys": np.zeros((0, top_k), dtype=object),
            "gen_images": np.asarray([], dtype=object)}


@compile_surface("search/matmul")
def search_folders(gen_features: np.ndarray, gen_keys: Sequence[str],
                   laion_folders: Sequence[str | Path], *, top_k: int = 1,
                   num_chunks: int = 20, device: str | torch.device = "cuda") -> dict:
    """Running top-k of every generation against all LAION chunks.

    Returns ``{"scores": [N, K], "keys": [N, K] laion ids, "gen_images":
    [N]}``, padded with ``-inf`` scores where the chunks hold fewer than K
    rows."""
    device = resolve_device(device)
    n = len(gen_features)
    if n == 0:
        return _empty_result(top_k)
    num_chunks = max(1, min(num_chunks, n))
    chunk_size = -(-n // num_chunks)
    best_scores = np.full((n, top_k), -np.inf, np.float32)
    best_keys = np.full((n, top_k), "", dtype=object)
    gen = torch.from_numpy(np.ascontiguousarray(gen_features, np.float32)).to(device)
    folders_done = tracing.registry().counter("search/folders_done")
    for folder in laion_folders:
        emb_file = find_embedding_file(folder)
        if emb_file is None:
            log.warning("no embedding dump under %s; skipping", folder)
            continue
        loaded = load_folder_embeddings(emb_file)
        if loaded is None:
            continue
        feats, keys = loaded
        if not len(feats):
            continue
        t0 = time.time()
        keys_arr = np.asarray(keys, dtype=object)
        feats_dev = torch.from_numpy(feats).to(device)
        valid = torch.ones(len(feats), dtype=torch.bool, device=device)
        k = min(top_k, feats.shape[0])
        for start in range(0, n, chunk_size):
            # one span per chunk's device top-k and host copy: the search
            # stage's time breakdown in trace_report
            with tracing.span("search/chunk", folder=str(folder), start=start,
                              rows=int(min(chunk_size, n - start)),
                              index_size=int(feats.shape[0])):
                top_scores, top_idx = topk(feats_dev, valid, gen[start:start + chunk_size], k)
                top_scores, top_idx = top_scores.cpu().numpy(), top_idx.cpu().numpy()
            if k < top_k:  # pad tiny chunks
                pad = top_k - k
                top_scores = np.pad(top_scores, ((0, 0), (0, pad)), constant_values=-np.inf)
                top_idx = np.pad(top_idx, ((0, 0), (0, pad)))
            sl = slice(start, start + len(top_scores))
            best_scores[sl], best_keys[sl] = merge_topk(
                best_scores[sl], best_keys[sl], top_scores, keys_arr[top_idx])
        del feats_dev, valid
        folders_done.inc()
        log.info("searched %s (%d embeddings) in %.1fs", folder, len(feats), time.time() - t0)
    return {"scores": best_scores, "keys": best_keys,
            "gen_images": np.asarray(list(gen_keys), dtype=object)}


def search_store(gen_features: np.ndarray, gen_keys: Sequence[str],
                 store_dir: str | Path, *, top_k: int = 1, mesh=None,
                 query_batch: int = 64, segment_rows: int = 0,
                 device: str | torch.device = "cuda") -> dict:
    """The store-backed :func:`search_folders`: one top-k engine over a built
    store instead of the per-folder loop, with the same result contract."""
    n = len(gen_features)
    if n == 0:
        return _empty_result(top_k)
    engine = open_engine(store_dir, mesh=mesh, top_k=top_k, query_batch=query_batch,
                         segment_rows=segment_rows, device=device)
    t0 = time.time()
    scores, keys = engine.query(np.asarray(gen_features, np.float32))
    log.info("store search: %d queries x %d rows in %.1fs", n, engine.total, time.time() - t0)
    return {"scores": scores, "keys": keys,
            "gen_images": np.asarray(list(gen_keys), dtype=object)}


def search_store_ann(gen_features: np.ndarray, gen_keys: Sequence[str],
                     store_dir: str | Path, *, top_k: int = 1, mesh=None, nprobe: int = 0,
                     shortlist_k: int = 0, query_batch: int = 64, segment_rows: int = 0,
                     live: bool = False, device: str | torch.device = "cuda") -> dict:
    """The ann path of :func:`search_store`: an nprobe-bounded IVF scan over
    the store's int8 inverted lists with exact f32 re-ranking
    (:mod:`dcr_tpu_torch.search.annindex`), with the same result contract.
    ``live`` also scans the WAL tail exactly (its rows are in no list) and
    merges it in."""
    n = len(gen_features)
    if n == 0:
        return _empty_result(top_k)
    engine = open_ann_engine(store_dir, mesh=mesh, top_k=top_k,
                             nprobe=int(nprobe) or DEFAULT_NPROBE,
                             shortlist_k=int(shortlist_k) or DEFAULT_SHORTLIST_K,
                             query_batch=query_batch, segment_rows=segment_rows,
                             device=device)
    q = np.asarray(gen_features, np.float32)
    t0 = time.time()
    if live:
        scores, keys = query_live(store_dir, q, engine=engine)
    else:
        scores, keys = engine.query(q)
    log.info("ann search: %d queries x %d rows (nprobe=%d) in %.1fs", n, engine.total,
             engine.nprobe, time.time() - t0)
    return {"scores": scores, "keys": keys,
            "gen_images": np.asarray(list(gen_keys), dtype=object)}


def run_search(cfg: SearchConfig, *, laion_folders: Sequence[str | Path] = (),
               top_k: int = 1, device: str | torch.device = "cuda") -> Path:
    """The whole stage: load the generations' embeddings, search (the IVF
    tier when ``cfg.ann``, the committed store plus its WAL tail when
    ``cfg.live``, store-backed when ``cfg.store_dir`` names a built store,
    else the per-folder brute force) and write ``cfg.out_path``, on the
    mesh of ``cfg.mesh`` over the job's processes (module docstring)."""
    device = dist.job_device(device)
    dist.initialize(device)
    mesh = pmesh.make_mesh(cfg.mesh)
    primary = dist.is_primary()
    out = Path(cfg.out_path)
    gen_emb = find_embedding_file(cfg.gen_folder)
    if gen_emb is None:
        raise FileNotFoundError(
            f"no embedding dump under {cfg.gen_folder}; run search.embed first")
    gen_features, gen_keys = load_embeddings(gen_emb)
    top_k = max(top_k, cfg.top_k)
    if cfg.ann:
        if not cfg.store_dir:
            raise ValueError("--ann needs --store_dir (the IVF tier indexes a built store)")
        result = search_store_ann(gen_features, gen_keys, cfg.store_dir, top_k=top_k,
                                  mesh=mesh, nprobe=cfg.nprobe, shortlist_k=cfg.shortlist_k,
                                  query_batch=cfg.query_batch, segment_rows=cfg.segment_rows,
                                  live=cfg.live, device=device)
    elif cfg.store_dir and cfg.live:
        scores, keys = query_live(cfg.store_dir, np.asarray(gen_features, np.float32),
                                  top_k=top_k, mesh=mesh, query_batch=cfg.query_batch,
                                  segment_rows=cfg.segment_rows, device=device)
        result = {"scores": scores, "keys": keys,
                  "gen_images": np.asarray(list(gen_keys), dtype=object)}
    elif cfg.store_dir:
        result = search_store(gen_features, gen_keys, cfg.store_dir, top_k=top_k, mesh=mesh,
                              query_batch=cfg.query_batch, segment_rows=cfg.segment_rows,
                              device=device)
    elif primary:
        result = search_folders(gen_features, gen_keys, laion_folders, top_k=top_k,
                                num_chunks=cfg.num_chunks, device=device)
    if primary:
        out.parent.mkdir(parents=True, exist_ok=True)
        np.savez(out, scores=result["scores"], keys=result["keys"].astype(str),
                 gen_images=result["gen_images"].astype(str))
        log.info("search results -> %s", out)
    return out
