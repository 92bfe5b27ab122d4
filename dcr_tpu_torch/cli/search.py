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
              [--ann=true --nprobe=N]    # IVF tier instead of the exact scan
    train-ivf --store_dir=... [--n_lists=L] [--ivf_iters=I] [--ivf_seed=S]
              [--ivf_train_rows=N] [--ivf_normalize=true]
                                         # train the IVF quantizer and commit
                                         # the int8 inverted lists
    stats     --store_dir=... [--json_out=true]

Same flags and ``--config=<config.json>`` as the JAX package's
``dcr-search``. It runs on one CUDA device (``DCR_TPU_PLATFORM=cpu`` selects
the CPU). ``recover`` and ``compact``, the settings ``live``, ``warm_dir``,
``logdir`` and a mesh, and a store that holds a WAL (``wal/``) raise
``NotPortedError``.
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
from dcr_tpu_torch.search import ann
from dcr_tpu_torch.search import embed as E
from dcr_tpu_torch.search import search as S
from dcr_tpu_torch.search.store import (
    EmbeddingStoreReader,
    EmbeddingStoreWriter,
    ingest_dumps,
    read_store_manifest,
)

USAGE = ("usage: dcr-search {download|embed|search|build|append|verify|query|train-ivf|"
         "stats} --key=value ...")
# the JAX package's directory of the live tier (dcr_tpu/search/livestore.py
# WAL_DIR)
WAL_DIR = "wal"
LIVE = ("recover", "compact")


def refuse_unported_tiers(store_dir: str) -> None:
    """NotPortedError for a store that carries the JAX package's WAL live
    tail: the port does not read it, so its answers and stats would leave
    the tail out."""
    if (Path(store_dir) / WAL_DIR).exists():
        raise NotPortedError(
            f"store {store_dir} holds a WAL live tail ({WAL_DIR}/), which dcr_tpu_torch does "
            "not read yet (ROADMAP Queue A item 3); use the JAX package's dcr-search")


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


def _cmd_train_ivf(cfg: SearchConfig, device: str) -> None:
    store_dir = _store_dir(cfg, "train-ivf")
    refuse_unported_tiers(store_dir)
    report = ann.train_ivf(store_dir, n_lists=cfg.n_lists, iters=cfg.ivf_iters,
                           seed=cfg.ivf_seed, train_rows=cfg.ivf_train_rows,
                           normalize=cfg.ivf_normalize, device=device)
    print(json.dumps(report, indent=1, sort_keys=True))


def store_stats(store_dir: str) -> dict:
    """The ``stats`` payload: the committed and ann sections, and the live
    section as the JAX package reports it for a store without a WAL."""
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
    }, "live": {"tail_rows": 0, "records": 0, "torn_segments": 0},
        "ann": ann.ann_stats(store_dir)}


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
    a = report["ann"]
    if a is None:
        print("ann        (none — run `dcr-search train-ivf`)")
    else:
        print(f"ann        {a['rows']} rows in {a['nonempty_lists']}/{a['n_lists']} lists "
              f"(snapshot v{a['snapshot']}, {a['quantization']}, "
              f"{'normalized' if a['normalized'] else 'raw'}, "
              f"max list {a['max_list_rows']} rows, seed={a['seed']})")


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        force=True)
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("--"):
        raise SystemExit(USAGE)
    command, rest = argv[0], argv[1:]
    if command in LIVE:
        raise NotPortedError(
            f"dcr-search {command} (the WAL live tier) is not ported to dcr_tpu_torch yet "
            "(ROADMAP Queue A item 3); use the JAX package's dcr-search")
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
    elif command == "train-ivf":
        _cmd_train_ivf(cfg, device)
    elif command == "stats":
        _cmd_stats(cfg)
    else:
        raise SystemExit(f"unknown subcommand {command!r}")


if __name__ == "__main__":
    main()
