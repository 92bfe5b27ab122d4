"""LAION search (PyTorch port of ``dcr-search``): the reference's
embedding_search/ scripts plus the sharded embedding store.

    python -m dcr_tpu_torch.cli.search <subcommand> --key=value ...

    download  --parquet_path=... --laion_folder=...
    embed     --gen_folder=<images-or-tars-dir> [--embedding_out=...]
    search    --gen_folder=... --laion_folder=<dir-of-chunk-dirs> --out_path=...
              [--store_dir=<built store>]   # store-backed instead of brute force
    build     --store_dir=... --laion_folder=<dir-of-chunk-dirs> [--dumps=a.npz,b.pkl]
              [--shard_rows=N] [--store_normalize=true]
    append    --store_dir=... --laion_folder=... [--dumps=...]
    verify    --store_dir=...            # read-only; exit 1 on corrupt shards
    query     --store_dir=... --gen_folder=... --out_path=... [--top_k=K]
              [--query_batch=B] [--segment_rows=R]
    stats     --store_dir=... [--json_out=true]

Same flags and ``--config=<config.json>`` as the JAX package's
``dcr-search``. It runs on one CUDA device (``DCR_TPU_PLATFORM=cpu`` selects
the CPU). ``recover``, ``compact`` and ``train-ivf``, the settings ``ann``,
``live``, ``warm_dir``, ``logdir`` and a mesh, and a store that holds a WAL
(``wal/``) or an IVF tier (``ann/``) raise ``NotPortedError``.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core.config import (
    NotPortedError,
    SearchConfig,
    parse_cli,
    validate_search_config,
)
from dcr_tpu_torch.search import embed as E
from dcr_tpu_torch.search import search as S
from dcr_tpu_torch.search.store import (
    EmbeddingStoreReader,
    EmbeddingStoreWriter,
    ingest_dumps,
    read_store_manifest,
)

USAGE = ("usage: dcr-search {download|embed|search|build|append|verify|query|stats} "
         "--key=value ...")
# the JAX package's directories of the live and approximate tiers
# (dcr_tpu/search/livestore.py WAL_DIR, dcr_tpu/search/ann.py ANN_DIRNAME)
WAL_DIR, ANN_DIR = "wal", "ann"
LIVE_AND_ANN = ("recover", "compact", "train-ivf")


def refuse_unported_tiers(store_dir: str) -> None:
    """NotPortedError for a store that carries the JAX package's WAL live
    tail or IVF tier: the port reads neither, so its answers and stats
    would leave them out."""
    for name, what in ((WAL_DIR, "a WAL live tail"), (ANN_DIR, "an IVF tier")):
        if (Path(store_dir) / name).exists():
            raise NotPortedError(
                f"store {store_dir} holds {what} ({name}/), which dcr_tpu_torch does not "
                "read yet (ROADMAP Queue A item 14); use the JAX package's dcr-search")


def _store_dir(cfg: SearchConfig, command: str) -> str:
    if not cfg.store_dir:
        raise SystemExit(f"{command} needs --store_dir=<dir>")
    return cfg.store_dir


def _store_sources(cfg: SearchConfig) -> list:
    sources = [Path(p) for p in cfg.dumps]
    if cfg.laion_folder:
        sources.append(Path(cfg.laion_folder))
    if not sources:
        raise SystemExit("build/append needs --laion_folder=<dir> and/or --dumps=<files>")
    return sources


def _cmd_build(cfg: SearchConfig, append: bool) -> None:
    store_dir = _store_dir(cfg, "build/append")
    if append:
        refuse_unported_tiers(store_dir)
        writer = EmbeddingStoreWriter.append(store_dir)
    else:
        writer = EmbeddingStoreWriter.create(store_dir, shard_rows=cfg.shard_rows,
                                             normalize=cfg.store_normalize)
    print(json.dumps(ingest_dumps(writer, _store_sources(cfg)), indent=1, sort_keys=True))


def _cmd_verify(cfg: SearchConfig) -> None:
    # read-only: inspecting a possibly-shared store renames nothing
    report = EmbeddingStoreReader(_store_dir(cfg, "verify"), quarantine=False).verify()
    print(json.dumps(report, indent=1, sort_keys=True))
    if report["corrupt"]:
        raise SystemExit(1)


def store_stats(store_dir: str) -> dict:
    """The ``stats`` payload: the committed section, and the live and ann
    sections as the JAX package reports them for a store that has neither."""
    refuse_unported_tiers(store_dir)
    manifest = read_store_manifest(Path(store_dir), quarantine=False)
    return {"store_dir": str(store_dir), "committed": {
        "snapshot": int(manifest.get("snapshot", 0)),
        "rows": int(manifest["total"]),
        "shards": len(manifest["shards"]),
        "shard_rows": int(manifest["shard_rows"]),
        "embed_dim": int(manifest["embed_dim"]),
        "normalized": bool(manifest.get("normalized", False)),
        "wal_through": int(manifest.get("wal_through", 0)),
    }, "live": {"tail_rows": 0, "records": 0, "torn_segments": 0}, "ann": None}


def _cmd_stats(cfg: SearchConfig) -> None:
    report = store_stats(_store_dir(cfg, "stats"))
    if cfg.json_out:
        print(json.dumps(report, indent=1, sort_keys=True))
        return
    c, lv = report["committed"], report["live"]
    print(f"store      {report['store_dir']}")
    print(f"committed  {c['rows']} rows in {c['shards']} shard(s) "
          f"(snapshot v{c['snapshot']}, shard_rows={c['shard_rows']}, "
          f"dim={c['embed_dim']}, {'normalized' if c['normalized'] else 'raw'}, "
          f"wal_through={c['wal_through']})")
    print(f"live       {lv['tail_rows']} uncompacted WAL row(s) in "
          f"{lv['records']} record(s), {lv['torn_segments']} torn")
    print("ann        (none — run `dcr-search train-ivf`)")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        force=True)
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("--"):
        raise SystemExit(USAGE)
    command, rest = argv[0], argv[1:]
    if command in LIVE_AND_ANN:
        raise NotPortedError(
            f"dcr-search {command} (the WAL live tier and the IVF tier) is not ported to "
            "dcr_tpu_torch yet (ROADMAP Queue A item 14); use the JAX package's dcr-search")
    cfg = parse_cli(SearchConfig, rest)
    validate_search_config(cfg)
    device = device_from_env()
    if command == "download":
        E.download_laion_chunk(cfg.parquet_path, cfg.laion_folder, image_size=cfg.image_size)
        E.embed_images(cfg, source=cfg.laion_folder, device=device)
        if cfg.delete_tars:
            E.cleanup_tars(cfg.laion_folder)
    elif command == "embed":
        E.embed_images(cfg, source=cfg.gen_folder, out_path=cfg.embedding_out or None,
                       device=device)
    elif command == "search":
        folders = ()
        if cfg.store_dir:
            refuse_unported_tiers(cfg.store_dir)
        else:
            folders = sorted(p for p in Path(cfg.laion_folder).iterdir() if p.is_dir())
        S.run_search(cfg, laion_folders=folders, device=device)
    elif command == "build":
        _cmd_build(cfg, append=False)
    elif command == "append":
        _cmd_build(cfg, append=True)
    elif command == "verify":
        _cmd_verify(cfg)
    elif command == "query":
        refuse_unported_tiers(_store_dir(cfg, "query"))
        print(f"search results -> {S.run_search(cfg, device=device)}")
    elif command == "stats":
        _cmd_stats(cfg)
    else:
        raise SystemExit(f"unknown subcommand {command!r}")


if __name__ == "__main__":
    main()
