"""The WAL live tier: the port's ``search/livestore`` against the JAX
package's ``dcr_tpu.search.livestore`` on the same numpy rows, on the CPU,
at DIM 8-32 and a few dozen rows.

- WAL frames: the two packages encode a record to the same bytes (at one
  clock), and each package's ``scan_wal_bytes`` and ``load_wal_tail`` read
  the other's WAL;
- the torn-tail matrix of ``tests/test_livestore.py`` (a cut inside every
  part of a frame, bit rot), recovery that truncates and counts a torn tail
  and serves the acked rows, recovery that skips rows already folded;
- compaction's versioned snapshots are read by both packages' readers and
  live stores, whichever package compacted; the normalized-store refusal,
  the typed lease error and a stale lease taken over;
- ``query_live`` against the JAX ``query_live`` under the tie rule of
  ``tests/test_torch_search.assert_topk_agree``, committed plus tail and
  tail alone; a recovered store is query-equal to one rebuilt over the acked
  rows;
- the fault kinds: ``wal_torn`` in-process, ``ingest_crash`` and
  ``compact_crash`` in a subprocess that SIGKILLs itself;
- ``dcr-search-torch recover`` / ``compact`` / ``query --live`` / ``stats``
  on a store the JAX package wrote, and the JAX command line on one the port
  wrote;
- ``tests/fixtures/jax_wal_store``, a live store the JAX package wrote
  (regenerated here byte for byte; ``chip_smoke.py`` phase 17 reads it on
  the card): ``python -m tests.test_torch_livestore`` rewrites it.
"""

from __future__ import annotations

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dcr_tpu.cli import search as jax_cli  # noqa: E402
from dcr_tpu.search import livestore as JL  # noqa: E402
from dcr_tpu.search import store as JST  # noqa: E402
from dcr_tpu.utils import faults as jfaults  # noqa: E402
from dcr_tpu_torch.cli import search as cli  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.search import livestore as L  # noqa: E402
from dcr_tpu_torch.search import store as ST  # noqa: E402
from dcr_tpu_torch.search.shardindex import open_engine  # noqa: E402
from dcr_tpu_torch.utils import faults  # noqa: E402
from tests.test_torch_search import assert_topk_agree  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
DIM = 8
FIXTURE = REPO / "tests" / "fixtures" / "jax_wal_store"
# the fixture's recipe (chip_smoke.py phase 17 regenerates its rows)
FIXTURE_SEED, FIXTURE_DIM, FIXTURE_CLOCK = 2026, 32, 1.7e9


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # small matmuls run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def _clean_faults(monkeypatch):
    monkeypatch.delenv("DCR_FAULTS", raising=False)
    faults.clear()
    jfaults.clear()
    yield
    faults.clear()
    jfaults.clear()


PKGS = {"jax": JL, "port": L}
STORES = {"jax": JST, "port": ST}


def _counter(name: str) -> int:
    return tracing.registry().counters(name.split("/")[0] + "/").get(name, 0)


def _rows(rng, n, dim=DIM):
    return rng.standard_normal((n, dim)).astype(np.float32)


def _fill(live, rows, prefix="k", batch=4):
    return [live.append(rows[s:s + batch], [f"{prefix}{s + j}" for j in range(len(
        rows[s:s + batch]))]) for s in range(0, rows.shape[0], batch)]


def _child_env():
    env = {k: v for k, v in os.environ.items() if k != "DCR_FAULTS"}
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _open_retry(mod, store, timeout: float = 60.0, **kw):
    """Open after a SIGKILLed writer: its heartbeat died with it, so its
    lease must age out before the takeover, as on a real restart."""
    deadline = time.monotonic() + timeout
    while True:
        try:
            return mod.LiveStore.open(store, **kw)
        except STORES["jax" if mod is JL else "port"].StoreLeaseHeldError:
            if time.monotonic() > deadline:
                raise
            time.sleep(0.2)


def _rebuild_over(store: Path, out: Path, dim: int = DIM) -> tuple[np.ndarray, list]:
    """A store rebuilt after the fact: committed shards plus every acked WAL
    row; returns its rows and keys."""
    feats, keys = ST.EmbeddingStoreReader(store).load_all()
    tail, tkeys, _ = L.load_wal_tail(store, embed_dim=dim)
    feats = np.concatenate([feats, tail]) if len(tail) else feats
    keys = list(keys) + [str(k) for k in tkeys]
    w = ST.EmbeddingStoreWriter.create(out, embed_dim=dim)
    w.add(feats, keys)
    w.finalize()
    return feats, keys


# ---------------------------------------------------------------------------
# 1. WAL framing: one format, both directions
# ---------------------------------------------------------------------------

def test_records_encode_to_the_same_bytes(monkeypatch):
    rng = np.random.default_rng(0)
    feats = _rows(rng, 3)
    keys = np.asarray(["a", "b", "gen/7"], dtype=str)
    monkeypatch.setattr(time, "time", lambda: FIXTURE_CLOCK)
    monkeypatch.setattr(time, "localtime", time.gmtime)
    assert L._encode_record(5, feats, keys) == JL._encode_record(5, feats, keys)
    assert (L.RECORD_MAGIC, L.COMMIT_MAGIC) == (JL.RECORD_MAGIC, JL.COMMIT_MAGIC)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_each_package_reads_the_others_wal(tmp_path, writer):
    rng = np.random.default_rng(1)
    rows = _rows(rng, 10)
    with PKGS[writer].LiveStore.open(tmp_path / "s", embed_dim=DIM, seal_rows=4) as live:
        seqs = _fill(live, rows, batch=3)
    assert seqs == [1, 2, 3, 4]
    for reader in ("jax", "port"):
        feats, keys, stats = PKGS[reader].load_wal_tail(tmp_path / "s")
        np.testing.assert_array_equal(feats, rows)
        assert list(keys) == [f"k{i}" for i in range(10)]
        assert stats == {"records": 4, "rows": 10, "torn_segments": 0}
        feats, keys, _ = PKGS[reader].load_wal_tail(tmp_path / "s", after_seq=2)
        np.testing.assert_array_equal(feats, rows[6:])
    for path in sorted((tmp_path / "s" / "wal").glob("wal_*.log")):
        data = path.read_bytes()
        mine, theirs = L.scan_wal_bytes(data), JL.scan_wal_bytes(data)
        assert mine[1] == theirs[1] == len(data)
        assert [(s, k.tolist()) for s, _, k in mine[0]] == [(s, k.tolist())
                                                          for s, _, k in theirs[0]]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_torn_tail_truncated_at_every_frame_boundary(writer):
    """A crash can stop the writer between any two bytes: whatever prefix
    of the last frame survives, both scanners keep exactly the committed
    records."""
    rng = np.random.default_rng(2)
    enc = PKGS[writer]._encode_record
    r1 = enc(1, _rows(rng, 2), np.asarray(["a", "b"]))
    r2 = enc(2, _rows(rng, 2), np.asarray(["c", "d"]))
    cuts = [len(r1) + 2, len(r1) + 6, len(r1) + 30, len(r1) + len(r2) // 2,
            len(r1) + len(r2) - len(L.COMMIT_MAGIC), len(r1) + len(r2) - 1]
    for cut in cuts:
        for mod in PKGS.values():
            records, good_end = mod.scan_wal_bytes((r1 + r2)[:cut])
            assert len(records) == 1 and good_end == len(r1), (cut, mod.__name__)
    damaged = bytearray(r1 + r2)
    damaged[len(r1) + 60] ^= 0xFF          # bit rot inside a payload
    assert L.scan_wal_bytes(bytes(damaged))[1] == len(r1)
    records, good_end = L.scan_wal_bytes(r1 + b"\x00garbage")
    assert len(records) == 1 and good_end == len(r1)


def test_recovery_truncates_a_torn_tail_counts_and_serves_the_acked(tmp_path):
    rng = np.random.default_rng(3)
    store, rows = tmp_path / "s", _rows(rng, 8)
    with JL.LiveStore.open(store, embed_dim=DIM) as live:      # the JAX writer
        _fill(live, rows, batch=4)
    wal = sorted((store / "wal").glob("wal_*.log"))[-1]
    wal.write_bytes(wal.read_bytes()[:-5])                     # tear record 2
    before = _counter("ingest/torn_total")
    with L.LiveStore.open(store) as live:
        assert live.torn_segments == 1 and live.recovered_rows == 4
        np.testing.assert_array_equal(live.tail()[0], rows[:4])
        live.append(rows[4:], [f"re{j}" for j in range(4)])
    assert _counter("ingest/torn_total") == before + 1
    with JL.LiveStore.open(store) as live:                     # healed for both
        assert live.torn_segments == 0
        feats, keys = live.tail()
        assert feats.shape[0] == 8 and list(keys[4:]) == [f"re{j}" for j in range(4)]


def test_recovery_skips_rows_already_folded(tmp_path):
    """A crash between the manifest commit and the WAL's deletion: the
    segment survives, but every seq <= wal_through; nothing is doubled."""
    rng = np.random.default_rng(4)
    store = tmp_path / "s"
    with L.LiveStore.open(store, embed_dim=DIM) as live:
        _fill(live, _rows(rng, 8), batch=4)
        stash = [(p.name, p.read_bytes()) for p in (store / "wal").glob("wal_*.log")]
        live.compact()
    for name, data in stash:
        (store / "wal" / name).write_bytes(data)
    before = _counter("ingest/recovered_total")
    with L.LiveStore.open(store) as live:
        assert live.recovered_rows == 0 and live.total_rows == 8
        assert not list((store / "wal").glob("wal_*.log"))
    assert _counter("ingest/recovered_total") == before


def test_append_validation_rejects_bad_batches(tmp_path):
    rng = np.random.default_rng(5)
    with L.LiveStore.open(tmp_path / "s", embed_dim=DIM) as live:
        live.append(_rows(rng, 2), ["a", "b"])
        for feats, keys, match in ((_rows(rng, 2, 5), ["a", "b"], "width"),
                                   (_rows(rng, 2), ["a"], "keys"),
                                   (np.zeros((0, DIM), np.float32), [], "empty"),
                                   (np.full((2, DIM), np.nan, np.float32), ["a", "b"],
                                    "finite")):
            with pytest.raises(ST.StoreError, match=match):
                live.append(feats, keys)


# ---------------------------------------------------------------------------
# 2. compaction: versioned snapshots both packages read
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("compactor", ["jax", "port"])
def test_compaction_snapshots_read_in_both_packages(tmp_path, compactor):
    rng = np.random.default_rng(6)
    store, rows = tmp_path / "s", _rows(rng, 12)
    other = "port" if compactor == "jax" else "jax"
    with PKGS[compactor].LiveStore.open(store, embed_dim=DIM, seal_rows=4) as live:
        _fill(live, rows[:8], batch=4)
        rep = live.compact()
        assert rep["snapshot"] == 1 and rep["folded_rows"] == 8
        assert rep["ann_lists_folded"] == 0
        assert not list((store / "wal").glob("wal_*.log"))
    with PKGS[other].LiveStore.open(store, seal_rows=4) as live:   # the other folds next
        assert live.snapshot == 1 and live.committed_total == 8
        _fill(live, rows[8:], prefix="t", batch=4)
        assert live.compact()["snapshot"] == 2
    for pkg in ("jax", "port"):
        reader = STORES[pkg].EmbeddingStoreReader(store)
        assert (reader.snapshot, reader.total, reader.wal_through) == (2, 12, 3)
        feats, keys = reader.load_all()
        np.testing.assert_array_equal(feats, rows)
        assert list(keys) == [f"k{i}" for i in range(8)] + [f"t{i}" for i in range(4)]
    assert (store / "store_manifest.v1.json").exists()          # readers of v1 keep it


def test_live_store_refuses_a_normalized_store_and_a_second_writer(tmp_path):
    rng = np.random.default_rng(7)
    w = ST.EmbeddingStoreWriter.create(tmp_path / "n", embed_dim=DIM, normalize=True)
    w.add(_rows(rng, 4), [f"k{j}" for j in range(4)])
    w.finalize()
    with pytest.raises(ST.StoreError, match="normaliz"):
        L.LiveStore.open(tmp_path / "n")
    store = tmp_path / "s"
    w1 = ST.EmbeddingStoreWriter.create(store, embed_dim=DIM)
    for mod in PKGS.values():
        with pytest.raises(ST.StoreLeaseHeldError if mod is L else JST.StoreLeaseHeldError,
                           match="one writer per store"):
            mod.LiveStore.open(store)
    w1.add(_rows(rng, 4), [f"k{j}" for j in range(4)])
    w1.finalize()
    with L.LiveStore.open(store) as live:
        assert live.committed_total == 4
        with pytest.raises(JST.StoreLeaseHeldError):
            JST.EmbeddingStoreWriter.append(store)


def test_a_stale_lease_is_taken_over(tmp_path):
    rng = np.random.default_rng(8)
    live = JL.LiveStore.open(tmp_path / "s", embed_dim=DIM, lease_s=0.3)
    live._lease._stop.set()                   # its heartbeat stops: a dead writer
    live._lease._thread.join()
    time.sleep(0.5)
    before = _counter("search/store_lease_takeover")
    with L.LiveStore.open(tmp_path / "s", embed_dim=DIM) as live2:
        live2.append(_rows(rng, 2), ["a", "b"])
    assert _counter("search/store_lease_takeover") == before + 1


def test_lag_gauges_drain_to_zero_after_compact(tmp_path):
    rng = np.random.default_rng(9)
    gauge = lambda name: tracing.registry().snapshot()["gauges"][name]  # noqa: E731
    with L.LiveStore.open(tmp_path / "s", embed_dim=DIM) as live:
        live.append(_rows(rng, 8), [f"k{i}" for i in range(8)])
        live.update_lag_gauges()
        assert gauge("ingest/backlog_rows") == 8 and gauge("store/rows_total") == 8
        assert gauge("ingest/lag_seqs") == 1 and gauge("store/growth_rows_per_s") > 0
        live.compact()
        assert gauge("ingest/backlog_rows") == 0 and gauge("ingest/lag_seqs") == 0
        assert gauge("ingest/oldest_unfolded_age_s") == 0.0
        assert gauge("store/rows_total") == 8


# ---------------------------------------------------------------------------
# 3. live queries
# ---------------------------------------------------------------------------

def test_query_live_agrees_with_jax_and_with_a_rebuilt_store(tmp_path):
    rng = np.random.default_rng(10)
    rows, keys = _rows(rng, 24), [f"k{j:02d}" for j in range(24)]
    store = tmp_path / "live"
    with L.LiveStore.open(store, embed_dim=DIM) as live:
        for s in range(0, 16, 4):
            live.append(rows[s:s + 4], keys[s:s + 4])
        live.compact()
        for s in range(16, 24, 4):
            live.append(rows[s:s + 4], keys[s:s + 4])
    q = _rows(rng, 5)
    mine = L.query_live(store, q, top_k=3, segment_rows=8, device="cpu")
    theirs = JL.query_live(store, q, top_k=3, segment_rows=8)
    assert_topk_agree(*mine, *theirs, q, rows, keys)
    _rebuild_over(store, tmp_path / "rebuilt")
    rebuilt = open_engine(tmp_path / "rebuilt", top_k=3, query_batch=5, segment_rows=8,
                          device="cpu").query(q)
    assert_topk_agree(*mine, *rebuilt, q, rows, keys)
    # the normalised convention through both
    mine = L.query_live(store, q, top_k=3, normalize_queries=True, normalize_rows=True,
                        device="cpu")
    theirs = JL.query_live(store, q, top_k=3, normalize_queries=True, normalize_rows=True)
    unit = rows / np.linalg.norm(rows, axis=1, keepdims=True)
    assert_topk_agree(*mine, *theirs, q / np.linalg.norm(q, axis=1, keepdims=True), unit, keys)


def test_query_live_over_a_tail_alone(tmp_path):
    rng = np.random.default_rng(11)
    rows = _rows(rng, 10)
    with JL.LiveStore.open(tmp_path / "w", embed_dim=DIM) as live:
        _fill(live, rows, batch=5)
    q = _rows(rng, 3)
    for top_k in (2, 12):                     # 12 > rows: padded as the JAX package pads
        mine = L.query_live(tmp_path / "w", q, top_k=top_k, device="cpu")
        theirs = JL.query_live(tmp_path / "w", q, top_k=top_k)
        assert_topk_agree(*mine, *theirs, q, rows, [f"k{i}" for i in range(10)])
    with pytest.raises(ST.StoreError, match="neither"):
        L.query_live(tmp_path / "empty", q, top_k=1, device="cpu")


# ---------------------------------------------------------------------------
# 4. the fault kinds
# ---------------------------------------------------------------------------

def test_wal_torn_rolls_the_segment_and_keeps_later_appends(tmp_path):
    rng = np.random.default_rng(12)
    faults.install("wal_torn@append=1")
    with L.LiveStore.open(tmp_path / "s", embed_dim=DIM) as live:
        live.append(_rows(rng, 2), ["a", "b"])
        with pytest.raises(ST.StoreError, match="wal_torn"):
            live.append(_rows(rng, 2), ["c", "d"])
        live.append(_rows(rng, 2), ["e", "f"])
    for mod in (L, JL):
        with mod.LiveStore.open(tmp_path / "s") as live:
            assert live.torn_segments == (1 if mod is L else 0)   # the port truncated it
            assert list(live.tail()[1]) == ["a", "b", "e", "f"]


_CHILD_APPEND = """
import sys
import numpy as np
from dcr_tpu_torch.search.livestore import LiveStore
from dcr_tpu_torch.utils import faults

faults.install(sys.argv[2])
rng = np.random.default_rng(11)
with LiveStore.open(sys.argv[1], embed_dim={dim}, lease_s=1.0) as live:
    for i in range(10):
        live.append(rng.standard_normal((3, {dim})).astype(np.float32),
                    ["b%d_%d" % (i, j) for j in range(3)])
sys.exit(7)
"""

_CHILD_COMPACT = """
import sys
import numpy as np
from dcr_tpu_torch.search.livestore import LiveStore
from dcr_tpu_torch.utils import faults

faults.install(sys.argv[2])
rng = np.random.default_rng(12)
with LiveStore.open(sys.argv[1], lease_s=1.0) as live:
    live.append(rng.standard_normal((4, {dim})).astype(np.float32),
                ["c%d" % j for j in range(4)])
    live.compact()
sys.exit(7)
"""


def _run_child(script: str, store: Path, spec: str) -> None:
    proc = subprocess.run([sys.executable, "-c", script.format(dim=DIM), str(store), spec],
                          env=_child_env(), cwd=REPO, capture_output=True, text=True,
                          timeout=240)
    assert proc.returncode == -signal.SIGKILL, (proc.returncode, proc.stdout, proc.stderr)


def _assert_query_equal(store: Path, rebuilt: Path, feats, keys, q) -> None:
    live = L.query_live(store, q, top_k=3, segment_rows=8, device="cpu")
    reb = open_engine(rebuilt, top_k=3, segment_rows=8,
                      device="cpu").query(q)
    np.testing.assert_array_equal(live[0], reb[0])
    np.testing.assert_array_equal(np.asarray(live[1], str), np.asarray(reb[1], str))
    assert_topk_agree(*live, *JL.query_live(store, q, top_k=3, segment_rows=8), q, feats,
                      keys)


def test_ingest_crash_mid_append_recovers_query_equal(tmp_path):
    """SIGKILL halfway through the 5th append: recovery serves exactly the
    4 acked records, query-equal to a store rebuilt over them."""
    rng = np.random.default_rng(13)
    store = tmp_path / "s"
    with L.LiveStore.open(store, embed_dim=DIM) as live:
        _fill(live, _rows(rng, 8), prefix="base", batch=4)
        live.compact()
    _run_child(_CHILD_APPEND, store, "ingest_crash@append=4")
    before = _counter("ingest/torn_total")
    with _open_retry(L, store) as live:
        assert live.torn_segments == 1 and live.recovered_rows == 12
    assert _counter("ingest/torn_total") == before + 1
    feats, keys = _rebuild_over(store, tmp_path / "rebuilt")
    assert len(keys) == 8 + 12
    _assert_query_equal(store, tmp_path / "rebuilt", feats, keys, _rows(rng, 4))


def test_compact_crash_keeps_the_previous_snapshot_serving(tmp_path):
    """SIGKILL after the new manifest, before the CURRENT flip: v1 serves,
    the WAL replays, and the next compaction completes."""
    rng = np.random.default_rng(14)
    store = tmp_path / "s"
    with L.LiveStore.open(store, embed_dim=DIM) as live:
        _fill(live, _rows(rng, 8), prefix="base", batch=4)
        live.compact()
    _run_child(_CHILD_COMPACT, store, "compact_crash@seal=0")
    assert ST.snapshot_version(store) == 1 and JST.snapshot_version(store) == 1
    assert ST.read_store_manifest(store)["total"] == 8
    assert L.load_wal_tail(store)[0].shape[0] == 4
    with _open_retry(L, store) as live:
        assert live.snapshot == 1 and live.recovered_rows == 4
        assert live.compact()["snapshot"] == 2
    assert JST.read_store_manifest(store)["total"] == 12
    feats, keys = _rebuild_over(store, tmp_path / "rebuilt")
    _assert_query_equal(store, tmp_path / "rebuilt", feats, keys, _rows(rng, 4))


# ---------------------------------------------------------------------------
# 5. the command line across packages
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_cli_recover_compact_query_live_and_stats(tmp_path, monkeypatch, capsys, writer):
    """The JAX package writes a live store that the port's command line
    recovers, queries live and compacts (and the other way round)."""
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    from dcr_tpu.search.embed import save_embeddings

    rng = np.random.default_rng(15)
    rows = _rows(rng, 10)
    keys = [f"k{i}" for i in range(10)]
    store = tmp_path / "s"
    with PKGS[writer].LiveStore.open(store, embed_dim=DIM) as live:
        live.append(rows[:6], keys[:6])
        live.compact()
        live.append(rows[6:], keys[6:])
    reader_main = jax_cli.main if writer == "port" else cli.main
    other_main = cli.main if writer == "port" else jax_cli.main
    capsys.readouterr()
    reader_main(["stats", f"--store_dir={store}", "--json_out=true"])
    stats = json.loads(capsys.readouterr().out)
    assert stats["live"] == {"tail_rows": 4, "records": 1, "torn_segments": 0}
    other_main(["stats", f"--store_dir={store}", "--json_out=true"])
    assert json.loads(capsys.readouterr().out) == stats
    gens = tmp_path / "gens"
    gens.mkdir()
    q = _rows(rng, 3)
    save_embeddings(gens / "embedding.npz", q, ["g0", "g1", "g2"])
    outs = {}
    for name, main in (("port", cli.main), ("jax", jax_cli.main)):
        main(["query", f"--store_dir={store}", f"--gen_folder={gens}", "--live=true",
              "--top_k=3", f"--out_path={tmp_path / name}.npz"])
        with np.load(tmp_path / f"{name}.npz") as z:
            outs[name] = z["scores"], z["keys"].astype(object)
    assert_topk_agree(*outs["port"], *outs["jax"], q, rows, keys)
    capsys.readouterr()
    reader_main(["recover", f"--store_dir={store}"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["tail_rows"] == 4 and rep["snapshot"] == 1 and rep["committed_rows"] == 6
    reader_main(["compact", f"--store_dir={store}"])
    rep = json.loads(capsys.readouterr().out)
    assert rep["compaction"]["snapshot"] == 2 and rep["compaction"]["folded_rows"] == 4
    for mod in STORES.values():
        assert mod.read_store_manifest(store)["total"] == 10


# ---------------------------------------------------------------------------
# 6. a live store the JAX package wrote, committed as a fixture
# ---------------------------------------------------------------------------

def fixture_rows() -> tuple[np.ndarray, list[str]]:
    """The fixture's 26 rows and keys: 12 committed by a build, 6 folded by
    a compaction, 6 acked in the WAL tail (3 records), 2 in a torn frame."""
    rows = np.random.default_rng(FIXTURE_SEED).standard_normal(
        (26, FIXTURE_DIM)).astype(np.float32)
    keys = ([f"c{i:02d}" for i in range(12)] + [f"w{i:02d}" for i in range(6)]
            + [f"t{i:02d}" for i in range(6)] + ["torn0", "torn1"])
    return rows, keys


def write_jax_wal_fixture(out: Path) -> None:
    """The JAX package writes the fixture at a fixed clock (the WAL header's
    ``ts``, the manifests' ``created_at`` and the npz zip entries' times), so
    it regenerates byte for byte: a build of 12 rows in shards of 8, a live
    compaction of 6 rows in 3 records (snapshot v1, wal_through 3), then 3
    acked records (seqs 4-6) and between the second and third a torn frame
    (``wal_torn``), which shares its segment with seqs 4 and 5."""
    real_time, real_localtime = time.time, time.localtime
    time.time = lambda: FIXTURE_CLOCK
    time.localtime = time.gmtime
    try:
        rows, keys = fixture_rows()
        w = JST.EmbeddingStoreWriter.create(out, embed_dim=FIXTURE_DIM, shard_rows=8)
        w.add(rows[:12], keys[:12])
        w.finalize()
        with JL.LiveStore.open(out, seal_rows=4) as live:
            for s in range(12, 18, 2):
                live.append(rows[s:s + 2], keys[s:s + 2])
            live.compact()
        jfaults.install("wal_torn@append=2")
        try:
            with JL.LiveStore.open(out, seal_rows=64) as live:
                for s in (18, 20):
                    live.append(rows[s:s + 2], keys[s:s + 2])
                with pytest.raises(JST.StoreError, match="wal_torn"):
                    live.append(rows[24:26], keys[24:26])
                live.append(rows[22:24], keys[22:24])
        finally:
            jfaults.clear()
    finally:
        time.time, time.localtime = real_time, real_localtime


def _tree(root: Path) -> dict[str, bytes]:
    return {str(p.relative_to(root)): p.read_bytes() for p in sorted(root.rglob("*"))
            if p.is_file()}


def test_the_jax_wal_fixture_regenerates_byte_for_byte(tmp_path):
    write_jax_wal_fixture(tmp_path / "store")
    mine, committed = _tree(tmp_path / "store"), _tree(FIXTURE)
    assert sorted(mine) == sorted(committed)
    for name in mine:
        assert mine[name] == committed[name], name


def test_the_port_recovers_and_queries_the_jax_wal_fixture(tmp_path):
    rows, keys = fixture_rows()
    store = tmp_path / "store"
    shutil.copytree(FIXTURE, store)
    tail, tkeys, stats = L.load_wal_tail(store)
    assert stats == {"records": 3, "rows": 6, "torn_segments": 1}
    np.testing.assert_array_equal(tail, rows[18:24])
    q = rows[[3, 14, 20]] + 0.01
    live_rows, live_keys = rows[:24], keys[:24]
    assert_topk_agree(*L.query_live(store, q, top_k=4, device="cpu"),
                      *JL.query_live(store, q, top_k=4), q, live_rows, live_keys)
    with L.LiveStore.open(store) as live:
        assert (live.snapshot, live.committed_total, live.wal_through) == (1, 18, 3)
        assert (live.recovered_rows, live.torn_segments, live.next_seq) == (6, 1, 7)
        assert list(live.tail()[1]) == keys[18:24]
        assert live.compact()["snapshot"] == 2
    feats, got = JST.EmbeddingStoreReader(store).load_all()
    np.testing.assert_array_equal(feats, live_rows)
    assert got == live_keys


if __name__ == "__main__":
    shutil.rmtree(FIXTURE, ignore_errors=True)
    write_jax_wal_fixture(FIXTURE)
    print(f"wrote {FIXTURE}: {sorted(_tree(FIXTURE))}")
