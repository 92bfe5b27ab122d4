"""The ANN slice: the port's IVF k-means, int8 inverted lists, scan engine and
``dcr-search train-ivf`` / ``query --ann`` / ``stats`` against the JAX
package's on the same numpy inputs, on the CPU, at DIM 16 and a few hundred
rows.

- ``assign_rows`` and ``quantize_list`` give equal arrays; from one seed on a
  clustered store, ``train_ivf`` gives equal lists (members, keys, codes,
  scale, zero) and centroids within the f32 bar;
- an ``ann/`` tier that either package trains loads and verifies clean in
  the other, and on either tier the two engines agree under the tie rule of
  ``tests/test_torch_search.assert_topk_agree``, resident and streamed;
- the port's own semantics as ``tests/test_ann.py`` pins the JAX package's:
  bit-deterministic training, the CURRENT flip, the two fault drills, exact
  re-ranked scores and recall, an exact engine that ignores the tier, the
  refusals, and the command line in-process.
"""

from __future__ import annotations

import json
import shutil

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dcr_tpu.cli import search as jax_cli  # noqa: E402
from dcr_tpu.search import ann as JANN  # noqa: E402
from dcr_tpu.search import annindex as JAI  # noqa: E402
from dcr_tpu.utils import faults as jfaults  # noqa: E402
from dcr_tpu_torch.cli import search as cli  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.core.config import NotPortedError  # noqa: E402
from dcr_tpu_torch.search import ann  # noqa: E402
from dcr_tpu_torch.search import annindex as AI  # noqa: E402
from dcr_tpu_torch.search import embed as E  # noqa: E402
from dcr_tpu_torch.search import shardindex as SI  # noqa: E402
from dcr_tpu_torch.search import store as ST  # noqa: E402
from dcr_tpu_torch.utils import faults  # noqa: E402
from tests.test_torch_search import assert_topk_agree  # noqa: E402

DIM = 16
# the f32 bar of the model-forward parity tests (tests/test_torch_parity.py)
ATOL, RTOL = 2e-4, 1e-3


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


def _counter(name: str) -> int:
    return tracing.registry().counters("ann/").get(name, 0)


def _clustered(rng, rows, clusters=8, dim=DIM, noise=0.1):
    centers = rng.standard_normal((clusters, dim)).astype(np.float32) * 4.0
    assign = rng.integers(0, clusters, rows)
    return centers[assign] + rng.standard_normal((rows, dim)).astype(np.float32) * noise


def _store(path, feats, *, shard_rows=64, normalize=False):
    w = ST.EmbeddingStoreWriter.create(path, shard_rows=shard_rows, normalize=normalize)
    w.add(feats, [f"r{i}" for i in range(feats.shape[0])])
    w.finalize()
    return path


def _keys(n):
    return [f"r{i}" for i in range(n)]


def _lists(store_dir, reader_cls):
    """{list id: (keys, codes, scale, zero)} of a committed tier."""
    reader = reader_cls(store_dir)
    out = {}
    for entry in reader.lists:
        codes, _, keys, scale, zero = reader.load_list(entry)
        out[int(entry["list"])] = (list(keys), codes, np.float32(scale), np.float32(zero))
    return out


def assert_ann_agree(sa, ka, sb, kb, q, feats, keys):
    """Two ANN tables agree under the tie rule, judged per query over the
    rows either table returned (the ANN answer ranks its candidates, not the
    whole corpus); ``-inf`` pads in the same places."""
    sa, sb = np.asarray(sa), np.asarray(sb)
    np.testing.assert_array_equal(np.isneginf(sa), np.isneginf(sb))
    row = {k: i for i, k in enumerate(keys)}
    for i in range(len(q)):
        n = int(np.isfinite(sa[i]).sum())
        rows = sorted({row[k] for k in (*ka[i, :n], *kb[i, :n])})
        assert_topk_agree(sa[i:i + 1, :n], ka[i:i + 1, :n], sb[i:i + 1, :n], kb[i:i + 1, :n],
                          q[i:i + 1], feats[rows], [keys[r] for r in rows])


# ---------------------------------------------------------------------------
# against the JAX package
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rows,lists", [(200, 8), (37, 5), (64, 64)])
def test_assign_rows_and_quantize_list_equal_jax(rows, lists):
    rng = np.random.default_rng(rows)
    feats = _clustered(rng, rows) * rng.uniform(0.5, 3.0)
    cents = feats[rng.choice(rows, lists, replace=False)] + 0.01
    np.testing.assert_array_equal(ann.assign_rows(feats, cents), JANN.assign_rows(feats, cents))
    for part in (feats, feats[:1], feats[:0]):
        codes, scale, zero = ann.quantize_list(part)
        jcodes, jscale, jzero = JANN.quantize_list(part)
        np.testing.assert_array_equal(codes, jcodes)
        assert codes.dtype == jcodes.dtype == np.int8
        assert (scale, zero) == (jscale, jzero)
        np.testing.assert_array_equal(ann.dequantize(codes, scale, zero),
                                      JANN.dequantize(jcodes, jscale, jzero))


def test_kmeans_step_equals_jax():
    rng = np.random.default_rng(3)
    feats = _clustered(rng, 96)
    valid = np.arange(96) < 90           # six pad rows in no centroid
    cents = feats[:6] + 0.05
    sums, counts = ann.make_kmeans_step(6)(torch.from_numpy(feats), torch.from_numpy(valid),
                                           torch.from_numpy(cents))
    jsums, jcounts = JANN.make_kmeans_step(6)(feats, valid, cents)
    np.testing.assert_allclose(sums.numpy(), np.asarray(jsums), atol=ATOL, rtol=RTOL)
    np.testing.assert_array_equal(counts.numpy(), np.asarray(jcounts))
    assert counts.sum().item() == 90


@pytest.mark.parametrize("kw", [{}, {"train_rows": 150}, {"normalize": True},
                                {"segment_rows": 64}],
                         ids=["all_rows", "train_rows", "normalize", "segments"])
def test_train_ivf_equals_jax(tmp_path, monkeypatch, kw):
    feats = _clustered(np.random.default_rng(1), 240)
    port = _store(tmp_path / "port", feats)
    ref = shutil.copytree(port, tmp_path / "jax")
    jkw = dict(kw)
    if "segment_rows" in kw:
        # four segments, the last padded: the per-segment sums accumulate
        monkeypatch.setattr(ann, "DEFAULT_TRAIN_SEGMENT_ROWS", kw.pop("segment_rows"))
    rp = ann.train_ivf(port, n_lists=8, iters=5, seed=7, device="cpu", **kw)
    rj = JANN.train_ivf(ref, n_lists=8, iters=5, seed=7, **jkw)
    drop = ("seconds",)
    assert {k: v for k, v in rp.items() if k not in drop} == \
        {k: v for k, v in rj.items() if k not in drop}
    np.testing.assert_allclose(ann.AnnIndexReader(port).load_centroids(),
                               JANN.AnnIndexReader(ref).load_centroids(), atol=ATOL, rtol=RTOL)
    lp, lj = _lists(port, ann.AnnIndexReader), _lists(ref, JANN.AnnIndexReader)
    assert sorted(lp) == sorted(lj) == list(range(8))
    for lid in lp:
        assert lp[lid][0] == lj[lid][0], lid                         # members and keys
        np.testing.assert_array_equal(lp[lid][1], lj[lid][1])       # codes, bit for bit
        assert lp[lid][2:] == lj[lid][2:]                           # scale, zero
    mp, mj = ann.read_ann_manifest(port), JANN.read_ann_manifest(ref)
    assert set(mp) == set(mj)
    for field in ("version", "kind", "embed_dim", "n_lists", "normalized", "seed", "iters",
                  "train_rows", "restarts", "total", "store_snapshot", "store_wal_through",
                  "snapshot"):
        assert mp[field] == mj[field], field
    assert [{k: e[k] for k in ("list", "count", "scale", "zero")} for e in mp["lists"]] == \
        [{k: e[k] for k in ("list", "count", "scale", "zero")} for e in mj["lists"]]


@pytest.fixture(scope="module")
def two_tiers(tmp_path_factory):
    """One clustered store of 300 rows trained by each package (8 lists)."""
    root = tmp_path_factory.mktemp("ann_tiers")
    rng = np.random.default_rng(5)
    feats = _clustered(rng, 300)
    port = _store(root / "port", feats)
    ref = shutil.copytree(port, root / "jax")
    ann.train_ivf(port, n_lists=8, iters=5, seed=0, device="cpu")
    JANN.train_ivf(ref, n_lists=8, iters=5, seed=0)
    q = (feats[rng.choice(300, 24, replace=False)]
         + rng.standard_normal((24, DIM)).astype(np.float32) * 0.05).astype(np.float32)
    return {"port": port, "jax": ref}, feats, q


@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_a_tier_loads_and_verifies_in_the_other_package(two_tiers, trained_by):
    stores, feats, _ = two_tiers
    store = stores[trained_by]
    for reader_cls in (ann.AnnIndexReader, JANN.AnnIndexReader):
        reader = reader_cls(store, quarantine=False)
        assert reader.verify() == {"lists": 8, "ok": 8, "corrupt": 0, "rows_ok": 300,
                                   "total": 300}
    np.testing.assert_array_equal(ann.AnnIndexReader(store).load_centroids(),
                                  JANN.AnnIndexReader(store).load_centroids())
    assert _lists(store, ann.AnnIndexReader).keys() == _lists(store, JANN.AnnIndexReader).keys()
    # and each package's engine builds over it and sees every row
    assert AI.open_ann_engine(store, device="cpu").total == 300
    assert JAI.open_ann_engine(store, query_batch=8).total == 300


@pytest.mark.parametrize("top_k", [1, 5, 40])
@pytest.mark.parametrize("trained_by", ["jax", "port"])
def test_engine_agrees_with_the_jax_engine(two_tiers, trained_by, top_k):
    stores, feats, q = two_tiers
    store, keys = stores[trained_by], _keys(300)
    js, jk = JAI.open_ann_engine(store, top_k=top_k, nprobe=3, query_batch=8).query(q)
    for limit in (AI.DEFAULT_MAX_RESIDENT_ROWS, 1):            # resident, then streamed
        eng = AI.AnnEngine(store, top_k=top_k, nprobe=3, query_batch=8, segment_rows=64,
                           max_resident_rows=limit, device="cpu").build()
        assert eng.resident == (limit > 1) and eng.num_segments == 5
        s, k = eng.query(q)
        assert s.shape == k.shape == (24, top_k)
        assert_ann_agree(s, k, js, jk, q, feats, keys)


def test_stats_payload_equals_jax(two_tiers, monkeypatch, capsys):
    stores, *_ = two_tiers
    for store in stores.values():
        assert ann.ann_stats(store) == JANN.ann_stats(store)
        assert cli.store_stats(str(store)) == jax_cli.store_stats(str(store))
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    cli.main(["stats", f"--store_dir={stores['jax']}"])
    text = capsys.readouterr().out.splitlines()
    jax_cli.main(["stats", f"--store_dir={stores['jax']}"])
    assert text == capsys.readouterr().out.splitlines()
    assert text[-1].startswith("ann        300 rows in 8/8 lists (snapshot v1")


def test_ivf_scan_ties_go_to_the_lower_index_as_in_lax_top_k():
    rng = np.random.default_rng(2)
    codes = rng.integers(-127, 128, (48, DIM)).astype(np.int8)
    codes[10:20] = codes[5]              # eleven rows with one score per query
    row_list = (np.arange(48) % 3).astype(np.int32)
    scale = np.full(48, 0.02, np.float32)
    zero = np.full(48, 0.1, np.float32)
    valid = np.arange(48) < 44
    probed = np.zeros((4, 3), bool)
    probed[:, 0] = probed[1:, 2] = True
    q = rng.standard_normal((4, DIM)).astype(np.float32)
    q[0] = codes[5] / 127.0
    t = [torch.from_numpy(a) for a in (codes, scale, zero, row_list, valid, probed, q)]
    s, idx = AI.ivf_scan(*t, shortlist_k=20)
    js, jidx = JAI.make_ivf_scan(20)(codes, scale, zero, row_list, valid, probed, q)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-5, atol=1e-5)
    # query 0 probes list 0, whose copies of row 5 (rows 12, 15, 18) tie on top
    assert list(idx.numpy()[0][:3]) == [12, 15, 18]
    tied = idx.numpy()[1][np.isin(idx.numpy()[1], [5, 11, 12, 14, 15, 17, 18])]
    assert len(tied) == 7 and list(tied) == sorted(tied)


# ---------------------------------------------------------------------------
# the port's own semantics (tests/test_ann.py's cases)
# ---------------------------------------------------------------------------

def test_kmeans_training_is_bit_deterministic(tmp_path, monkeypatch):
    feats = _clustered(np.random.default_rng(0), 200)
    a, b = _store(tmp_path / "a", feats), _store(tmp_path / "b", feats)
    ra = ann.train_ivf(a, n_lists=8, iters=6, seed=7, device="cpu")
    rb = ann.train_ivf(b, n_lists=8, iters=6, seed=7, device="cpu")
    assert ra["rows"] == rb["rows"] == 200
    ca, cb = ann.AnnIndexReader(a).load_centroids(), ann.AnnIndexReader(b).load_centroids()
    np.testing.assert_array_equal(ca, cb)
    np.testing.assert_array_equal(ann.assign_rows(feats, ca), ann.assign_rows(feats, cb))
    # segments uploaded per step (a training set above the resident limit)
    # give the same centroids as resident ones
    monkeypatch.setattr(ann, "DEFAULT_MAX_RESIDENT_TRAIN_ROWS", 0)
    monkeypatch.setattr(ann, "DEFAULT_TRAIN_SEGMENT_ROWS", 64)
    streamed, restarts = ann.kmeans(feats, 8, 6, 7, device="cpu")
    monkeypatch.setattr(ann, "DEFAULT_MAX_RESIDENT_TRAIN_ROWS", 1 << 22)
    resident, _ = ann.kmeans(feats, 8, 6, 7, device="cpu")
    np.testing.assert_array_equal(streamed, resident)
    assert restarts == 0


def test_train_commits_current_flip_stats_and_lease_owner(tmp_path, monkeypatch):
    store = _store(tmp_path / "s", _clustered(np.random.default_rng(1), 120))
    assert not ann.has_ann_index(store) and ann.ann_stats(store) is None
    leases = []
    acquire = ST.StoreWriterLease.acquire

    def spy(lease):
        leases.append((lease.dir.name, lease.owner))
        return acquire(lease)

    monkeypatch.setattr(ST.StoreWriterLease, "acquire", spy)
    report = ann.train_ivf(store, n_lists=4, iters=3, seed=0, device="cpu")
    assert leases == [("ann", "train-ivf")]
    adir = store / "ann"
    assert (adir / "CURRENT").read_text().strip() == "ann_manifest.v1.json"
    assert ann.has_ann_index(store) and ann.ann_snapshot_version(store) == 1
    assert not (adir / ST.LEASE_NAME).exists()            # released after the commit
    stats = ann.ann_stats(store)
    assert (stats["rows"], stats["n_lists"], stats["snapshot"], stats["seed"]) == (120, 4, 1, 0)
    assert report["nonempty_lists"] == stats["nonempty_lists"]
    assert ann.AnnIndexReader(store).verify()["corrupt"] == 0
    ann.train_ivf(store, n_lists=4, iters=3, seed=1, device="cpu")
    assert ann.ann_snapshot_version(store) == 2 and ann.ann_stats(store)["seed"] == 1


def test_ivf_list_corrupt_quarantines_counts_and_rebuilds(tmp_path):
    store = _store(tmp_path / "s", _clustered(np.random.default_rng(2), 100))
    ann.train_ivf(store, n_lists=4, iters=3, seed=0, device="cpu")
    reader = ann.AnnIndexReader(store)
    entry = next(e for e in reader.manifest["lists"] if e["count"])
    before = _counter("ann/ivf_list_corrupt")
    faults.install("ivf_list_corrupt@load=0")
    assert reader.load_list(entry) is None
    assert _counter("ann/ivf_list_corrupt") == before + 1
    assert int(entry["list"]) in reader.failed_lists
    assert list((store / "ann").glob(f"{entry['file']}.quarantined.*"))
    rebuilt = _counter("ann/list_rebuilt")
    rep = ann.rebuild_list(store, int(entry["list"]))
    assert rep == {"list": int(entry["list"]), "rows": int(entry["count"]), "snapshot": 2}
    assert _counter("ann/list_rebuilt") == rebuilt + 1
    fresh = ann.AnnIndexReader(store)
    assert fresh.verify()["corrupt"] == 0 and fresh.total == 100
    # the JAX package reads the rebuilt snapshot too
    assert JANN.AnnIndexReader(store).verify()["corrupt"] == 0


@pytest.mark.parametrize("damage", ["fault", "disk"])
def test_engine_rebuilds_a_corrupt_list_and_answers_as_unfaulted(tmp_path, damage):
    feats = _clustered(np.random.default_rng(3), 160)
    store = _store(tmp_path / "s", feats)
    ann.train_ivf(store, n_lists=6, iters=3, seed=0, device="cpu")
    q = feats[::10] + 0.01
    want = AI.open_ann_engine(store, top_k=3, nprobe=2, query_batch=8, device="cpu").query(q)
    before = _counter("ann/ivf_list_corrupt")
    if damage == "fault":
        faults.install("ivf_list_corrupt@load=3")
    else:
        entry = next(e for e in ann.read_ann_manifest(store)["lists"] if e["count"])
        path = store / "ann" / entry["file"]
        path.write_bytes(b"rotten" + path.read_bytes()[6:])
    eng = AI.open_ann_engine(store, top_k=3, nprobe=2, query_batch=8, device="cpu")
    assert _counter("ann/ivf_list_corrupt") == before + 1
    assert eng.ann.failed_lists and eng.total == 160
    assert ann.ann_snapshot_version(store) == 2            # the rebuilt list's snapshot
    got = eng.query(q)
    np.testing.assert_array_equal(got[0], want[0])
    assert (got[1] == want[1]).all()


def test_kmeans_nan_fault_restarts_bounded(tmp_path):
    store = _store(tmp_path / "s", _clustered(np.random.default_rng(4), 80))
    before = _counter("ann/kmeans_restart")
    faults.install("kmeans_nan@iter=1")
    report = ann.train_ivf(store, n_lists=4, iters=3, seed=0, device="cpu")
    assert report["restarts"] == 1 and _counter("ann/kmeans_restart") == before + 1
    assert ann.read_ann_manifest(store)["restarts"] == 1
    assert ann.AnnIndexReader(store).verify()["corrupt"] == 0
    # the restart trained from seed + 1, as the JAX package's does
    ref = _store(tmp_path / "ref", _clustered(np.random.default_rng(4), 80))
    jfaults.install("kmeans_nan@iter=1")
    JANN.train_ivf(ref, n_lists=4, iters=3, seed=0)
    np.testing.assert_allclose(ann.AnnIndexReader(store).load_centroids(),
                               JANN.AnnIndexReader(ref).load_centroids(), atol=ATOL, rtol=RTOL)
    # exhausting every restart raises the typed error and commits nothing
    store2 = _store(tmp_path / "s2", _clustered(np.random.default_rng(4), 80))
    faults.install(f"kmeans_nan@iter=0x{ann.MAX_KMEANS_RESTARTS + 1}")
    with pytest.raises(ann.AnnError, match="non-finite"):
        ann.train_ivf(store2, n_lists=4, iters=3, seed=0, device="cpu")
    assert not ann.has_ann_index(store2)


def test_rerank_scores_are_exact_dots_and_recall_high(tmp_path):
    feats = _clustered(np.random.default_rng(6), 300)
    store = _store(tmp_path / "s", feats)
    ann.train_ivf(store, n_lists=8, iters=5, seed=0, device="cpu")
    engine = AI.open_ann_engine(store, top_k=5, nprobe=4, query_batch=16, device="cpu")
    q = (feats[:20] + 0.01).astype(np.float32)
    scores, keys = engine.query(q)
    for i in range(q.shape[0]):
        for j in range(5):
            row = int(str(keys[i][j])[1:])
            np.testing.assert_allclose(scores[i][j], np.float32(q[i] @ feats[row]), rtol=1e-6)
    exact = SI.open_engine(store, top_k=10, query_batch=16, device="cpu")
    assert AI.spot_check_recall(engine, exact, q, k=5) >= 0.95
    assert tracing.registry().snapshot()["gauges"]["ann/recall_spot_pct"] >= 95


def test_exact_engine_is_bit_identical_with_an_ann_tier_on_disk(tmp_path):
    feats = _clustered(np.random.default_rng(7), 150)
    store = _store(tmp_path / "s", feats)
    q = (feats[:10] + 0.02).astype(np.float32)
    s1, k1 = SI.open_engine(store, top_k=3, query_batch=8, device="cpu").query(q)
    ann.train_ivf(store, n_lists=4, iters=3, seed=0, device="cpu")
    s2, k2 = SI.open_engine(store, top_k=3, query_batch=8, device="cpu").query(q)
    np.testing.assert_array_equal(s1, s2)
    assert (k1 == k2).all()


def test_engine_refuses_width_mismatch_raw_rows_for_cosine_and_unported(tmp_path):
    feats = _clustered(np.random.default_rng(8), 60)
    store = _store(tmp_path / "s", feats)
    ann.train_ivf(store, n_lists=4, iters=2, seed=0, device="cpu")
    with pytest.raises(ann.AnnError, match="ivf_normalize"):
        AI.AnnEngine(store, require_normalized_rows=True, device="cpu")
    store2 = _store(tmp_path / "s2", feats, normalize=True)
    ann.train_ivf(store2, n_lists=4, iters=2, seed=0, normalize=True, device="cpu")
    cosine = AI.open_ann_engine(store2, top_k=3, require_normalized_rows=True,
                                normalize_queries=True, device="cpu")
    q = feats[:5] * 3.0
    unit = q / np.linalg.norm(q, axis=1, keepdims=True)
    want = AI.open_ann_engine(store2, top_k=3, device="cpu").query(unit)
    got = cosine.query(q)
    np.testing.assert_allclose(got[0], want[0], rtol=1e-6)
    assert (got[1] == want[1]).all()
    # a tier trained over a store of another width
    other = _store(tmp_path / "s3", _clustered(np.random.default_rng(9), 60, dim=8))
    shutil.rmtree(other / "ann", ignore_errors=True)
    shutil.copytree(store / "ann", other / "ann")
    with pytest.raises(ann.AnnError, match="width"):
        AI.AnnEngine(other, device="cpu")
    with pytest.raises(NotPortedError, match="item 9"):
        AI.AnnEngine(store, mesh=object(), device="cpu")
    with pytest.raises(NotPortedError, match="item 7"):
        AI.AnnEngine(store, warm_dir="w", device="cpu")
    with pytest.raises(NotPortedError, match="item 7"):
        ann.train_ivf(store, n_lists=4, warm_dir="w", device="cpu")
    with pytest.raises(ann.AnnError, match="n_lists"):
        ann.train_ivf(store, n_lists=61, device="cpu")


def test_cli_train_ivf_stats_and_query_ann(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    feats = _clustered(np.random.default_rng(10), 120)
    store = _store(tmp_path / "s", feats)
    assert cli.store_stats(str(store))["ann"] is None
    cli.main(["train-ivf", f"--store_dir={store}", "--n_lists=4", "--ivf_iters=3"])
    out = json.loads(capsys.readouterr().out)
    assert out["snapshot"] == 1 and out["rows"] == 120 and out["restarts"] == 0
    cli.main(["stats", f"--store_dir={store}"])
    text = capsys.readouterr().out
    assert "committed  120 rows" in text and "ann        120 rows in 4/4 lists" in text
    cli.main(["stats", f"--store_dir={store}", "--json_out=true"])
    doc = json.loads(capsys.readouterr().out)
    assert doc["ann"]["rows"] == 120 and doc["live"]["tail_rows"] == 0
    gen_dir = tmp_path / "gen"
    gen_dir.mkdir()
    q = (feats[:6] + 0.01).astype(np.float32)
    E.save_embeddings(gen_dir / "embedding.npz", q, [f"g{i}" for i in range(6)])
    for name, extra in (("exact", []), ("ann", ["--ann=true", "--nprobe=4"])):
        cli.main(["query", f"--store_dir={store}", f"--gen_folder={gen_dir}",
                  f"--out_path={tmp_path / name}.npz", "--top_k=3", *extra])
    jax_cli.main(["query", f"--store_dir={store}", f"--gen_folder={gen_dir}",
                  f"--out_path={tmp_path / 'jax_ann.npz'}", "--top_k=3", "--ann=true",
                  "--nprobe=4"])
    capsys.readouterr()
    with np.load(tmp_path / "exact.npz") as ze, np.load(tmp_path / "ann.npz") as za, \
            np.load(tmp_path / "jax_ann.npz") as zj:
        # nprobe = n_lists: the ANN answer is the exact one
        assert_topk_agree(za["scores"], za["keys"], ze["scores"], ze["keys"], q, feats,
                          _keys(120))
        assert_topk_agree(za["scores"], za["keys"], zj["scores"], zj["keys"], q, feats,
                          _keys(120))
        assert list(za["gen_images"]) == [f"g{i}" for i in range(6)]
