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
              [--live=true]              # include the WAL live tail
              [--ann=true --nprobe=N]    # IVF tier instead of the exact scan
    recover   --store_dir=...            # replay the WAL: truncate torn
                                         # tails, reload acked rows, print
                                         # the recovery report
    compact   --store_dir=...            # recover, then fold the WAL into
                                         # committed shards and a new snapshot
                                         # (and into the IVF lists)
    train-ivf --store_dir=... [--n_lists=L] [--ivf_iters=I] [--ivf_seed=S]
              [--ivf_train_rows=N] [--ivf_normalize=true]
                                         # train the IVF quantizer and commit
                                         # the int8 inverted lists
    stats     --store_dir=... [--json_out=true]
                                         # committed, live and ann tiers

Same flags and ``--config=<config.json>`` as the JAX package's
``dcr-search``, on stores either package wrote. It runs on one CUDA device
(``DCR_TPU_PLATFORM=cpu`` selects the CPU), or as N processes, one device
each, under torchrun or the JAX package's variables, laid out by
``--mesh.*`` (the store's rows and the embed batches split over ``data`` x
``fsdp``):

    torchrun --nproc_per_node=N -m dcr_tpu_torch.cli.search query \
        --store_dir=... --gen_folder=... --out_path=... --mesh.data=N
    COORDINATOR_ADDRESS=host:port NUM_PROCESSES=N PROCESS_ID=<r> \
        python -m dcr_tpu_torch.cli.search embed --gen_folder=... --mesh.data=N

``embed``, ``query`` and ``search`` with ``--store_dir`` run on every rank,
each answer whole on every rank; rank 0 writes the files. The subcommands
that write a store or print a report (``build``, ``append``, ``verify``,
``recover``, ``compact``, ``train-ivf``, ``stats``) take no mesh in the JAX
package: they run once, on rank 0, as does the brute-force ``search`` and
``download``'s fetch. Every rank waits at a named barrier before the
command returns. ``--logdir=<dir>`` writes the command's spans
(``search/chunk`` per query chunk of the folder search) to
``<dir>/trace.jsonl`` (rank r > 0: ``trace.p<r>.jsonl``).
``--warm_dir=<dir>`` is accepted and builds nothing: the engines launch no
native kernel, so the warm cache (``core/warmcache.py``) has nothing to hold.
"""

from __future__ import annotations

import json
import logging
import sys
from pathlib import Path

import torch.distributed as tdist

from dcr_tpu_torch.cli import device_from_env
from dcr_tpu_torch.core import dist, tracing
from dcr_tpu_torch.core.config import SearchConfig, parse_cli
from dcr_tpu_torch.search import ann
from dcr_tpu_torch.search import embed as E
from dcr_tpu_torch.search import search as S
from dcr_tpu_torch.search.livestore import LiveStore, load_wal_tail
from dcr_tpu_torch.search.store import (
    EmbeddingStoreReader,
    EmbeddingStoreWriter,
    ingest_dumps,
    read_store_manifest,
)

USAGE = ("usage: dcr-search {download|embed|search|build|append|verify|query|recover|"
         "compact|train-ivf|stats} --key=value ...")
#: the subcommands that run once, on rank 0, in a job of several processes
RANK0_COMMANDS = ("build", "append", "verify", "recover", "compact", "train-ivf", "stats")


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


def _cmd_recover(cfg: SearchConfig, compact: bool) -> None:
    """Take the writer lease, replay the WAL (truncating torn tails) and,
    with ``compact``, fold the recovered tail into committed shards and
    publish the next snapshot: by hand, what a restarted ingesting worker
    does when it opens the store."""
    with LiveStore.open(_store_dir(cfg, "recover/compact")) as live:
        report = live.report()
        if compact:
            report["compaction"] = live.compact()
    print(json.dumps(report, indent=1, sort_keys=True))


def _cmd_train_ivf(cfg: SearchConfig, device: str) -> None:
    store_dir = _store_dir(cfg, "train-ivf")
    report = ann.train_ivf(store_dir, n_lists=cfg.n_lists, iters=cfg.ivf_iters,
                           seed=cfg.ivf_seed, train_rows=cfg.ivf_train_rows,
                           normalize=cfg.ivf_normalize, device=device)
    print(json.dumps(report, indent=1, sort_keys=True))


def store_stats(store_dir: str) -> dict:
    """The ``stats`` payload: the committed, live (the WAL tail, read-only)
    and ann sections, read-only (nothing is quarantined)."""
    manifest = read_store_manifest(Path(store_dir), quarantine=False)
    try:
        feats, _keys, wal = load_wal_tail(store_dir)
        live = {"tail_rows": int(feats.shape[0]), "records": int(wal["records"]),
                "torn_segments": int(wal["torn_segments"])}
    except OSError:  # an unreadable WAL reports as empty, as the JAX stats do
        live = {"tail_rows": 0, "records": 0, "torn_segments": 0}
    return {"store_dir": str(store_dir), "committed": {
        "snapshot": int(manifest.get("snapshot", 0)),
        "rows": int(manifest["total"]),
        "shards": len(manifest["shards"]),
        "shard_rows": int(manifest["shard_rows"]),
        "embed_dim": int(manifest["embed_dim"]),
        "normalized": bool(manifest.get("normalized", False)),
        "wal_through": int(manifest.get("wal_through", 0)),
    }, "live": live, "ann": ann.ann_stats(store_dir)}


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


def _run(command: str, cfg: SearchConfig, device: str) -> None:
    if command == "download":
        if dist.is_primary():
            E.download_laion_chunk(cfg.parquet_path, cfg.laion_folder,
                                   image_size=cfg.image_size)
        dist.barrier("search:download")  # a fetch has no bound: wait for rank 0
        E.embed_images(cfg, source=cfg.laion_folder, device=device)
        if cfg.delete_tars and dist.is_primary():
            E.cleanup_tars(cfg.laion_folder)
    elif command == "embed":
        E.embed_images(cfg, source=cfg.gen_folder, out_path=cfg.embedding_out or None,
                       device=device)
    elif command == "search":
        folders = ()
        if not cfg.store_dir:
            folders = sorted(p for p in Path(cfg.laion_folder).iterdir() if p.is_dir())
        S.run_search(cfg, laion_folders=folders, device=device)
    elif command == "query":
        _store_dir(cfg, "query")
        out = S.run_search(cfg, device=device)
        if dist.is_primary():
            print(f"search results -> {out}")
    elif not dist.is_primary():
        return
    elif command == "build":
        _cmd_build(cfg, append=False)
    elif command == "append":
        _cmd_build(cfg, append=True)
    elif command == "verify":
        _cmd_verify(cfg)
    elif command == "recover":
        _cmd_recover(cfg, compact=False)
    elif command == "compact":
        _cmd_recover(cfg, compact=True)
    elif command == "train-ivf":
        _cmd_train_ivf(cfg, device)
    elif command == "stats":
        _cmd_stats(cfg)


def main(argv=None) -> None:
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(name)s %(message)s",
                        force=True)
    argv = list(sys.argv[1:] if argv is None else argv)
    if not argv or argv[0].startswith("--"):
        raise SystemExit(USAGE)
    command, rest = argv[0], argv[1:]
    if command not in ("download", "embed", "search", "query", *RANK0_COMMANDS):
        raise SystemExit(f"unknown subcommand {command!r}")
    cfg = parse_cli(SearchConfig, rest)
    joined_here = not tdist.is_initialized()
    device = str(dist.job_device(device_from_env()))
    dist.initialize(device)
    cfg.mesh.axis_sizes(dist.process_count())  # a mesh the job cannot hold fails first
    if cfg.logdir:
        tracing.configure(cfg.logdir, rank=dist.process_index())
    _run(command, cfg, device)
    # no rank returns while another still works on (or writes) the answer;
    # rank 0's own subcommands (a build, a k-means) have no bound
    dist.barrier(f"search:{command}", timeout_s=0.0 if command in RANK0_COMMANDS
                 else dist.default_allgather_timeout_s())
    if joined_here:
        dist.shutdown()


if __name__ == "__main__":
    main()
