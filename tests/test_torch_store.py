"""The sharded embedding store on disk: the port's writer and reader against
the JAX package's, on the CPU.

The store is one format for both packages: a store that either writes loads
in the other, rows, keys and features bit for bit. Shard bytes are not
compared (``np.savez`` stamps the zip's time, so each writer's sha256s are
its own); manifests are, field by field, less the shas and times.
"""

from __future__ import annotations

import json
import time

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dcr_tpu.search import store as JST  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.search import embed as E  # noqa: E402
from dcr_tpu_torch.search import store as ST  # noqa: E402

# manifest fields that differ between two writers of the same rows
UNSTABLE = ("created_at", "sources")


def _dumps(root, rng, sizes, dim=16, prefix="laion"):
    folders = []
    for i, n in enumerate(sizes):
        folder = root / f"{prefix}{i}"
        folder.mkdir(parents=True)
        E.save_embeddings(folder / "embedding.npz",
                          rng.standard_normal((n, dim)).astype(np.float32),
                          [f"{prefix}{i}_img{j}" for j in range(n)])
        folders.append(folder)
    return folders


def _stable(manifest: dict) -> dict:
    doc = {k: v for k, v in manifest.items() if k not in UNSTABLE}
    doc["shards"] = [{k: v for k, v in s.items() if k != "sha256"} for s in doc["shards"]]
    return doc


def _assert_same_rows(a, b):
    fa, ka = a.load_all()
    fb, kb = b.load_all()
    assert fa.dtype == fb.dtype == np.float32
    np.testing.assert_array_equal(fa, fb)
    assert ka == kb


def _counter(name: str) -> int:
    return tracing.registry().counters("search/").get(name, 0)


def test_build_append_verify_round_trip_equals_jax(tmp_path):
    rng = np.random.default_rng(0)
    folders = _dumps(tmp_path / "dumps", rng, [10, 7, 13])
    extra = _dumps(tmp_path / "extra", rng, [5], prefix="extra")
    stores = {}
    for name, mod in (("port", ST), ("jax", JST)):
        store = tmp_path / name
        report = mod.ingest_dumps(mod.EmbeddingStoreWriter.create(store, shard_rows=8), folders)
        assert {k: report[k] for k in ("rows", "dumps", "skipped", "shards", "total")} == \
            {"rows": 30, "dumps": 3, "skipped": 0, "shards": 4, "total": 30}
        before = {s["file"]: s["sha256"] for s in mod.EmbeddingStoreReader(store).shards}
        report = mod.ingest_dumps(mod.EmbeddingStoreWriter.append(store), extra)
        assert report["rows"] == 5 and report["total"] == 35
        after = mod.EmbeddingStoreReader(store).shards
        assert all(s["sha256"] == before[s["file"]] for s in after if s["file"] in before)
        stores[name] = store
    port, ref = (ST.EmbeddingStoreReader(stores[n]) for n in ("port", "jax"))
    assert _stable(port.manifest) == _stable(ref.manifest)
    assert [s["count"] for s in port.shards] == [8, 8, 8, 6, 5]
    _assert_same_rows(port, ref)
    want = np.concatenate([E.load_embeddings(f / "embedding.npz")[0] for f in folders + extra])
    np.testing.assert_array_equal(port.load_all()[0], want)   # ingest keeps the bytes
    assert port.verify() == ref.verify() == {"shards": 5, "ok": 5, "corrupt": 0,
                                             "rows_ok": 35, "total": 35}
    # shards hold unicode keys, never pickled objects
    with np.load(stores["port"] / "shard_00000.npz", allow_pickle=False) as z:
        assert z["keys"].dtype.kind == "U" and z["features"].dtype == np.float32


def test_normalize_at_ingest_equals_jax(tmp_path):
    rng = np.random.default_rng(1)
    folders = _dumps(tmp_path / "dumps", rng, [6])
    readers = []
    for name, mod in (("port", ST), ("jax", JST)):
        mod.ingest_dumps(mod.EmbeddingStoreWriter.create(tmp_path / name, shard_rows=4,
                                                         normalize=True), folders)
        readers.append(mod.EmbeddingStoreReader(tmp_path / name))
    assert readers[0].normalized is True
    np.testing.assert_allclose(np.linalg.norm(readers[0].load_all()[0], axis=1), 1.0,
                               atol=1e-6)
    _assert_same_rows(*readers)
    np.testing.assert_array_equal(ST.normalize_rows(np.eye(3, dtype=np.float32) * 3),
                                  JST.normalize_rows(np.eye(3, dtype=np.float32) * 3))


def test_writer_refuses_bad_rows_and_clobber(tmp_path):
    rng = np.random.default_rng(2)
    w = ST.EmbeddingStoreWriter.create(tmp_path / "s", shard_rows=4)
    w.add(rng.standard_normal((3, 8)).astype(np.float32), ["a", "b", "c"])
    for feats, keys, match in ((np.zeros((2, 9), np.float32), ["d", "e"], "width"),
                               (np.zeros((2, 8), np.float32), ["d"], "torn"),
                               (np.full((1, 8), np.nan, np.float32), ["d"], "non-finite"),
                               (np.zeros((4,), np.float32), list("abcd"), "N, D")):
        with pytest.raises(ST.StoreError, match=match):
            w.add(feats, keys)
    w.finalize()
    with pytest.raises(ST.StoreError, match="committed store"):
        ST.EmbeddingStoreWriter.create(tmp_path / "s")
    with pytest.raises(ST.StoreError, match="not an embedding store"):
        ST.EmbeddingStoreWriter.append(tmp_path / "nowhere")


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_damaged_shard_is_quarantined_and_survivors_serve(tmp_path, writer):
    rng = np.random.default_rng(3)
    folders = _dumps(tmp_path / "dumps", rng, [16])
    mod = ST if writer == "port" else JST
    store = tmp_path / "store"
    mod.ingest_dumps(mod.EmbeddingStoreWriter.create(store, shard_rows=4), folders)
    shard1 = store / "shard_00001.npz"
    blob = shard1.read_bytes()
    shard1.write_bytes(blob[:len(blob) // 2] + b"\xff" + blob[len(blob) // 2:])
    # read-only verify leaves the damage in place
    assert ST.EmbeddingStoreReader(store, quarantine=False).verify()["corrupt"] == 1
    assert shard1.exists()
    before = _counter("search/store_shard_corrupt")
    feats, keys = ST.EmbeddingStoreReader(store).load_all()
    assert _counter("search/store_shard_corrupt") == before + 1
    assert feats.shape == (12, 16) and "laion0_img4" not in keys and "laion0_img8" in keys
    assert not shard1.exists() and list(store.glob("shard_00001.npz.quarantined.*"))
    want, want_keys = E.load_embeddings(folders[0] / "embedding.npz")
    np.testing.assert_array_equal(feats, np.concatenate([want[:4], want[8:]]))
    # with every shard gone the store is loud, not empty
    for s in store.glob("shard_*.npz"):
        s.write_bytes(b"junk")
    with pytest.raises(ST.StoreError, match="no shard survived"):
        ST.EmbeddingStoreReader(store).load_all()


def test_corrupt_manifest_is_typed_and_quarantined(tmp_path):
    rng = np.random.default_rng(4)
    folders = _dumps(tmp_path / "dumps", rng, [5])
    store = tmp_path / "store"
    ST.ingest_dumps(ST.EmbeddingStoreWriter.create(store), folders)
    (store / ST.MANIFEST_NAME).write_text("{not json")
    with pytest.raises(ST.StoreError, match="manifest corrupt"):
        ST.EmbeddingStoreReader(store)
    assert not (store / ST.MANIFEST_NAME).exists()


def test_zero_row_commit_is_refused(tmp_path):
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "embedding.npz").write_bytes(b"garbage")
    for mod, name in ((ST, "port"), (JST, "jax")):
        with pytest.raises(mod.StoreError, match="ingested 0 rows"):
            mod.ingest_dumps(mod.EmbeddingStoreWriter.create(tmp_path / name), [bad])
        assert not (tmp_path / name / ST.MANIFEST_NAME).exists()
        assert not (tmp_path / name / ST.LEASE_NAME).exists()
    # the corrected rebuild works in place
    folders = _dumps(tmp_path / "dumps", np.random.default_rng(5), [3])
    ST.ingest_dumps(ST.EmbeddingStoreWriter.create(tmp_path / "port"), folders)
    assert ST.EmbeddingStoreReader(tmp_path / "port").total == 3


@pytest.mark.parametrize("holder", ["port", "jax"])
def test_second_writer_gets_lease_held_error(tmp_path, holder):
    mod = ST if holder == "port" else JST
    first = mod.EmbeddingStoreWriter.create(tmp_path / "s")
    try:
        with pytest.raises(ST.StoreLeaseHeldError, match="writer lease held"):
            ST.EmbeddingStoreWriter.create(tmp_path / "s")
    finally:
        first.close()
    assert not (tmp_path / "s" / ST.LEASE_NAME).exists()
    ST.EmbeddingStoreWriter.create(tmp_path / "s").close()


def test_stale_lease_is_taken_over(tmp_path):
    store = tmp_path / "s"
    store.mkdir()
    (store / ST.LEASE_NAME).write_text(json.dumps(
        {"owner": "dead", "pid": 1, "token": "x", "lease_s": 0.1,
         "renewed_at": time.time() - 60}))
    before = _counter("search/store_lease_takeover")
    w = ST.EmbeddingStoreWriter.create(store)
    assert _counter("search/store_lease_takeover") == before + 1
    assert json.loads((store / ST.LEASE_NAME).read_text())["token"] == w._lease.token
    w.close()


def test_jax_snapshot_store_reads_in_the_port_and_back(tmp_path):
    """A store the JAX package commits as versioned snapshots (CURRENT ->
    store_manifest.v2.json after a live commit and an append) reads in the
    port bit for bit; the port appends the next snapshot, which JAX reads."""
    rng = np.random.default_rng(6)
    folders = _dumps(tmp_path / "dumps", rng, [9, 4], dim=8)
    store = tmp_path / "store"
    w = JST.EmbeddingStoreWriter.create(store, shard_rows=4)
    w.mark_live()
    w.mark_wal_through(7)
    JST.ingest_dumps(w, folders[:1])
    JST.ingest_dumps(JST.EmbeddingStoreWriter.append(store), folders[1:])
    assert (store / ST.CURRENT_NAME).read_text().strip() == "store_manifest.v2.json"
    port, ref = ST.EmbeddingStoreReader(store), JST.EmbeddingStoreReader(store)
    assert port.manifest == ref.manifest
    assert (port.snapshot, port.wal_through, port.total) == (2, 7, 13)
    assert ST.snapshot_version(store) == JST.snapshot_version(store) == 2
    _assert_same_rows(port, ref)

    extra = _dumps(tmp_path / "extra", rng, [3], dim=8, prefix="port")
    ST.ingest_dumps(ST.EmbeddingStoreWriter.append(store), extra)
    assert (store / ST.CURRENT_NAME).read_text().strip() == "store_manifest.v3.json"
    ref3 = JST.EmbeddingStoreReader(store)
    assert ref3.snapshot == 3 and ref3.total == 16 and ref3.wal_through == 7
    _assert_same_rows(ST.EmbeddingStoreReader(store), ref3)
    assert ref3.load_all()[1][-3:] == ["port0_img0", "port0_img1", "port0_img2"]


def test_port_store_reads_in_jax_and_reference_pickles_ingest(tmp_path):
    import pickle

    import torch

    rng = np.random.default_rng(7)
    npz = _dumps(tmp_path / "dumps", rng, [6], dim=8)
    ref_dir = tmp_path / "ref"
    ref_dir.mkdir()
    feats = rng.standard_normal((5, 8)).astype(np.float32)
    with open(ref_dir / "embedding.pkl", "wb") as f:   # the reference toolchain's dump
        pickle.dump({"features": torch.from_numpy(feats), "indexes": list(range(5))}, f)
    store = tmp_path / "store"
    ST.ingest_dumps(ST.EmbeddingStoreWriter.create(store, shard_rows=4), npz + [ref_dir])
    port, ref = ST.EmbeddingStoreReader(store), JST.EmbeddingStoreReader(store)
    assert ref.verify()["corrupt"] == 0 and ref.manifest == port.manifest
    _assert_same_rows(port, ref)
    got, keys = ref.load_all()
    np.testing.assert_array_equal(got[6:], feats)
    assert keys[6:] == ["0", "1", "2", "3", "4"]


def test_snapshot_change_mid_read_is_typed(tmp_path):
    rng = np.random.default_rng(8)
    folders = _dumps(tmp_path / "dumps", rng, [8], dim=4)
    store = tmp_path / "store"
    w = ST.EmbeddingStoreWriter.create(store, shard_rows=4)
    w.mark_live()
    ST.ingest_dumps(w, folders)
    reader = ST.EmbeddingStoreReader(store)
    it = reader.iter_shards()
    next(it)
    ST.ingest_dumps(ST.EmbeddingStoreWriter.append(store), _dumps(tmp_path / "x", rng, [2],
                                                                  dim=4, prefix="x"))
    with pytest.raises(ST.StoreSnapshotChangedError):
        next(it)
