"""The search slice: the port's top-k engine, brute force, ``run_search`` and
``dcr-search`` command line against the JAX package's on the same dumps and
stores, on the CPU.

No two f32 paths are bit-equal (XLA's CPU matmul rounds differently for
different shapes; so does cuBLAS), so results are held to the tie rule of
:func:`assert_topk_agree` rather than to equality:
- scores: |a - b| <= 1e-5 * ||q|| * ||x|| for each (query, neighbour);
- keys: equal at every rank whose exact (float64) score is more than twice
  that bound away from the exact scores on either side; a near-tie may swap;
- pads (a store smaller than top_k): ``-inf`` with key ``""`` in both.
"""

from __future__ import annotations

import json

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dcr_tpu.cli import search as jax_cli  # noqa: E402
from dcr_tpu.core.config import MeshConfig as JaxMeshConfig  # noqa: E402
from dcr_tpu.core.config import SearchConfig as JaxSearchConfig  # noqa: E402
from dcr_tpu.search import search as JS  # noqa: E402
from dcr_tpu.search import shardindex as JSI  # noqa: E402
from dcr_tpu.search import store as JST  # noqa: E402
from dcr_tpu_torch.cli import search as cli  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.core.config import MeshConfig, NotPortedError, SearchConfig  # noqa: E402
from dcr_tpu_torch.search import embed as E  # noqa: E402
from dcr_tpu_torch.search import search as S  # noqa: E402
from dcr_tpu_torch.search import shardindex as SI  # noqa: E402
from dcr_tpu_torch.search import store as ST  # noqa: E402

SCORE_RTOL = 1e-5


def assert_topk_agree(scores_a, keys_a, scores_b, keys_b, q, feats, keys):
    """Two top-k tables of the queries ``q`` over the corpus ``(feats,
    keys)`` agree under the tie rule (module docstring)."""
    scores_a, scores_b = np.asarray(scores_a, np.float64), np.asarray(scores_b, np.float64)
    keys_a, keys_b = np.asarray(keys_a, object), np.asarray(keys_b, object)
    assert scores_a.shape == scores_b.shape == keys_a.shape == keys_b.shape
    n, k = scores_a.shape
    feats = np.asarray(feats, np.float64)
    norm = dict(zip(keys, np.linalg.norm(feats, axis=1)))
    exact = np.sort(np.asarray(q, np.float64) @ feats.T, axis=1)[:, ::-1]
    qn = np.linalg.norm(np.asarray(q, np.float64), axis=1)
    big = max(norm.values())
    for i in range(n):
        for r in range(k):
            if r >= len(keys):       # a pad: the store holds fewer than k rows
                for s, key in ((scores_a[i, r], keys_a[i, r]), (scores_b[i, r], keys_b[i, r])):
                    assert np.isneginf(s) and key == "", (i, r, s, key)
                continue
            bound = SCORE_RTOL * qn[i] * max(norm[keys_a[i, r]], norm[keys_b[i, r]])
            assert abs(scores_a[i, r] - scores_b[i, r]) <= bound, (
                i, r, scores_a[i, r], scores_b[i, r], bound)
            # a gap is measured with the largest norm: neighbours differ
            gap_bound = 2 * SCORE_RTOL * qn[i] * big
            above = exact[i, r - 1] - exact[i, r] if r > 0 else np.inf
            below = exact[i, r] - exact[i, r + 1] if r + 1 < len(keys) else np.inf
            if min(above, below) > gap_bound:
                assert keys_a[i, r] == keys_b[i, r], (i, r, keys_a[i, r], keys_b[i, r])


def _dump_folders(root, rng, sizes, dim=16, prefix="laion"):
    folders = []
    for i, n in enumerate(sizes):
        folder = root / f"{prefix}{i}"
        folder.mkdir(parents=True)
        feats = rng.standard_normal((n, dim)).astype(np.float32)
        E.save_embeddings(folder / "embedding.npz", feats,
                          [f"{prefix}{i}_img{j}" for j in range(n)])
        folders.append(folder)
    return folders


def _corpus(folders):
    parts = [E.load_embeddings(f / "embedding.npz") for f in folders]
    return np.concatenate([p[0] for p in parts]), [k for p in parts for k in p[1]]


def _port_store(root, folders, name="store", **kw):
    ST.ingest_dumps(ST.EmbeddingStoreWriter.create(root / name, **kw), folders)
    return root / name


@pytest.fixture()
def corpus(tmp_path):
    """Three dumps (10, 7, 13 rows x 16), one store of 8-row shards, and 11
    queries, two of them copies of corpus rows."""
    rng = np.random.default_rng(0)
    folders = _dump_folders(tmp_path, rng, [10, 7, 13])
    feats, keys = _corpus(folders)
    q = rng.standard_normal((11, 16)).astype(np.float32)
    q[3], q[7] = feats[4], feats[21]
    store = _port_store(tmp_path, folders, shard_rows=8)
    return folders, store, feats, keys, q


def test_tie_rule_flags_a_wrong_key_and_a_wrong_score():
    rng = np.random.default_rng(1)
    feats = rng.standard_normal((6, 8))
    keys = [f"k{i}" for i in range(6)]
    q = rng.standard_normal((2, 8))
    sims = q @ feats.T
    order = np.argsort(-sims, axis=1)[:, :3]
    scores = np.take_along_axis(sims, order, axis=1)
    table = np.asarray(keys, object)[order]
    assert_topk_agree(scores, table, scores + 1e-7, table, q, feats, keys)
    swapped = table.copy()
    swapped[0, 0], swapped[0, 1] = table[0, 1], table[0, 0]
    with pytest.raises(AssertionError):
        assert_topk_agree(scores, table, scores, swapped, q, feats, keys)
    with pytest.raises(AssertionError):
        assert_topk_agree(scores, table, scores + 1e-3, table, q, feats, keys)


def test_merge_topk_equals_jax_with_inf_pads():
    rng = np.random.default_rng(2)
    s = np.sort(rng.standard_normal((5, 4)).astype(np.float32), axis=1)[:, ::-1].copy()
    s[1, 2:] = -np.inf
    s[3] = -np.inf
    k = np.asarray([[f"a{i}{j}" if np.isfinite(s[i, j]) else "" for j in range(4)]
                    for i in range(5)], object)
    ns = np.sort(rng.standard_normal((5, 4)).astype(np.float32), axis=1)[:, ::-1].copy()
    ns[0, 1:] = -np.inf
    ns[2] = s[2]                      # exact ties: the current table first
    nk = np.asarray([[f"b{i}{j}" for j in range(4)] for i in range(5)], object)
    mine, theirs = SI.merge_topk(s, k, ns, nk), JSI.merge_topk(s, k, ns, nk)
    np.testing.assert_array_equal(mine[0], theirs[0])
    assert (mine[1] == theirs[1]).all()
    assert (S.topk_merge(s, k, ns, nk)[1] == JS.topk_merge(s, k, ns, nk)[1]).all()


@pytest.mark.parametrize("resident", [True, False], ids=["resident", "streamed"])
@pytest.mark.parametrize("top_k", [1, 4, 40], ids=lambda k: f"k{k}")
def test_engine_equals_jax_engine(corpus, resident, top_k):
    """8-row segments over 30 rows (4 segments, the last padded), a
    query_batch of 4 over 11 queries; top_k 40 > the store's 30 rows (one
    40-row segment: K never exceeds the segment)."""
    _, store, feats, keys, q = corpus
    kw = dict(top_k=top_k, query_batch=4, segment_rows=8,
              max_resident_rows=1 << 20 if resident else 1)
    mine = SI.ShardedTopK(ST.EmbeddingStoreReader(store), device="cpu", **kw).build()
    theirs = JSI.ShardedTopK(JST.EmbeddingStoreReader(store), **kw).build()
    # a store within one segment is resident whatever the limit says
    assert mine.resident == theirs.resident == (resident or top_k > 30)
    assert mine.num_segments == theirs.num_segments == (4 if top_k <= 8 else 1)
    assert mine.segment_rows == theirs.segment_rows
    assert_topk_agree(*mine.query(q), *theirs.query(q), q, feats, keys)
    # a row alone scores as it does in its batch
    s1, k1 = mine.query(q[5:6])
    s_all, k_all = mine.query(q)
    np.testing.assert_array_equal(s1[0], s_all[5])
    assert (k1[0] == k_all[5]).all()


def test_engine_copies_are_top1_and_pads_keep_empty_keys(corpus):
    _, store, feats, keys, q = corpus
    scores, got = SI.open_engine(store, top_k=40, query_batch=4, device="cpu").query(q)
    assert got[3, 0] == keys[4] and got[7, 0] == keys[21]
    assert np.isneginf(scores[:, 30:]).all() and (got[:, 30:] == "").all()
    assert np.isfinite(scores[:, :30]).all()


def test_query_rows_equals_jax(corpus):
    _, store, feats, keys, q = corpus
    rng = np.random.default_rng(3)
    tail = rng.standard_normal((11, 16)).astype(np.float32)
    tail_keys = [f"tail{i}" for i in range(11)]
    mine = SI.open_engine(store, top_k=3, query_batch=4, segment_rows=8, device="cpu")
    theirs = JSI.open_engine(store, top_k=3, query_batch=4, segment_rows=8)
    assert_topk_agree(*mine.query_rows(q, tail, tail_keys),
                      *theirs.query_rows(q, tail, tail_keys), q, tail, tail_keys)


def test_normalized_queries_and_rows_equal_jax(corpus):
    _, store, feats, keys, q = corpus
    kw = dict(top_k=3, query_batch=4, normalize_queries=True, normalize_rows=True)
    mine = SI.open_engine(store, device="cpu", **kw).query(q)
    theirs = JSI.open_engine(store, **kw).query(q)
    unit = feats / np.linalg.norm(feats, axis=1, keepdims=True)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    assert_topk_agree(*mine, *theirs, qn, unit, keys)


@pytest.mark.parametrize("top_k", [1, 3, 40], ids=lambda k: f"k{k}")
def test_search_folders_and_store_equal_jax_and_each_other(corpus, top_k):
    folders, store, feats, keys, q = corpus
    gen_keys = [f"g{i}" for i in range(len(q))]
    brute = S.search_folders(q, gen_keys, folders, top_k=top_k, num_chunks=3, device="cpu")
    jbrute = JS.search_folders(q, gen_keys, folders, top_k=top_k, num_chunks=3)
    res = S.search_store(q, gen_keys, store, top_k=top_k, query_batch=4, device="cpu")
    jres = JS.search_store(q, gen_keys, store, top_k=top_k, query_batch=4)
    for a, b in ((brute, jbrute), (res, jres), (brute, res)):
        assert_topk_agree(a["scores"], a["keys"], b["scores"], b["keys"], q, feats, keys)
        assert list(a["gen_images"]) == list(b["gen_images"]) == gen_keys


def test_search_folders_quarantines_corrupt_and_keeps_invalid(tmp_path):
    rng = np.random.default_rng(4)
    good = _dump_folders(tmp_path, rng, [5], dim=8)
    bad = tmp_path / "bad"
    bad.mkdir()
    (bad / "embedding.npz").write_bytes(b"garbage")
    invalid = tmp_path / "invalid"
    invalid.mkdir()
    np.savez(invalid / "embedding.npz", features=np.zeros((3, 8), np.float32),
             indexes=np.asarray(["a", "b"]))
    before = tracing.registry().counters("search/")
    out = S.search_folders(rng.standard_normal((2, 8)).astype(np.float32), ["g0", "g1"],
                           good + [bad, invalid, tmp_path / "missing"], top_k=2,
                           device="cpu")
    after = tracing.registry().counters("search/")
    assert out["keys"][0, 0].startswith("laion0_")
    assert not (bad / "embedding.npz").exists()
    assert list(bad.glob("embedding.npz.quarantined.*"))
    assert (invalid / "embedding.npz").exists()
    for name in ("search/folder_corrupt", "search/folder_invalid"):
        assert after.get(name, 0) == before.get(name, 0) + 1


def test_empty_queries_give_empty_tables(corpus):
    folders, store, *_ = corpus
    empty = np.zeros((0, 16), np.float32)
    for res in (S.search_folders(empty, [], folders, top_k=2, device="cpu"),
                S.search_store(empty, [], store, top_k=2, device="cpu")):
        assert res["scores"].shape == (0, 2) and res["keys"].shape == (0, 2)


@pytest.mark.parametrize("use_store", [False, True], ids=["brute", "store"])
def test_run_search_equals_jax(corpus, tmp_path, use_store):
    folders, store, feats, keys, q = corpus
    gdir = tmp_path / "gens"
    gdir.mkdir()
    E.save_embeddings(gdir / "embedding.npz", q, [f"g{i}" for i in range(len(q))])
    extra = {"store_dir": str(store), "query_batch": 4} if use_store else {}
    out = {}
    for name, cfg_cls, run in (("port", SearchConfig, S.run_search),
                               ("jax", JaxSearchConfig, JS.run_search)):
        cfg = cfg_cls(gen_folder=str(gdir), top_k=3, num_chunks=4,
                      out_path=str(tmp_path / f"{name}.npz"), **extra)
        kw = {"device": "cpu"} if name == "port" else {}
        path = run(cfg, laion_folders=() if use_store else folders, **kw)
        with np.load(path) as z:
            out[name] = {k: z[k] for k in ("scores", "keys", "gen_images")}
    assert {k: v.dtype.kind for k, v in out["port"].items()} == \
        {k: v.dtype.kind for k, v in out["jax"].items()}
    assert_topk_agree(out["port"]["scores"], out["port"]["keys"], out["jax"]["scores"],
                      out["jax"]["keys"], q, feats, keys)
    assert (out["port"]["gen_images"] == out["jax"]["gen_images"]).all()


def _json_docs(text: str) -> list:
    """The JSON documents printed one after another."""
    docs, pos, dec = [], 0, json.JSONDecoder()
    while text[pos:].strip():
        doc, end = dec.raw_decode(text[pos:].lstrip())
        pos = len(text) - len(text[pos:].lstrip()) + end
        docs.append(doc)
    return docs


def test_cli_build_append_verify_query_stats(tmp_path, capsys, monkeypatch):
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    rng = np.random.default_rng(5)
    root = tmp_path / "corpus"
    _dump_folders(root, rng, [6, 5], dim=8, prefix="chunk")
    store, jstore = tmp_path / "store", tmp_path / "jstore"
    for main, s in ((cli.main, store), (jax_cli.main, jstore)):
        main(["build", f"--store_dir={s}", f"--laion_folder={root}", "--shard_rows=4"])
    mine, theirs = _json_docs(capsys.readouterr().out)
    assert mine["rows"] == 11 and mine["skipped"] == 0
    assert {k: v for k, v in mine.items() if k != "manifest"} == \
        {k: v for k, v in theirs.items() if k != "manifest"}
    extra = tmp_path / "more"
    _dump_folders(extra, rng, [3], dim=8, prefix="late")
    cli.main(["append", f"--store_dir={store}", f"--laion_folder={extra}"])
    jax_cli.main(["append", f"--store_dir={jstore}", f"--laion_folder={extra}"])
    capsys.readouterr()
    cli.main(["verify", f"--store_dir={store}"])
    assert json.loads(capsys.readouterr().out) == {
        "shards": 4, "ok": 4, "corrupt": 0, "rows_ok": 14, "total": 14}

    # stats: the committed section as the JAX CLI prints it for its own store
    cli.main(["stats", f"--store_dir={store}", "--json_out=true"])
    mine = json.loads(capsys.readouterr().out)
    jax_cli.main(["stats", f"--store_dir={jstore}", "--json_out=true"])
    theirs = json.loads(capsys.readouterr().out)
    assert mine["store_dir"] == str(store) and theirs["store_dir"] == str(jstore)
    for section in ("committed", "live", "ann"):
        assert mine[section] == theirs[section], section
    cli.main(["stats", f"--store_dir={store}"])
    text = capsys.readouterr().out.splitlines()
    jax_cli.main(["stats", f"--store_dir={jstore}"])
    jtext = capsys.readouterr().out.splitlines()
    assert text[1:] == jtext[1:] and len(text) == 4

    gen = rng.standard_normal((3, 8)).astype(np.float32)
    gdir = tmp_path / "gens"
    gdir.mkdir()
    E.save_embeddings(gdir / "embedding.npz", gen, ["g0", "g1", "g2"])
    for main, s, out in ((cli.main, store, "res.npz"), (jax_cli.main, jstore, "jres.npz")):
        main(["query", f"--store_dir={s}", f"--gen_folder={gdir}",
              f"--out_path={tmp_path / out}", "--top_k=2", "--query_batch=2"])
    feats, keys = ST.EmbeddingStoreReader(store).load_all()
    with np.load(tmp_path / "res.npz") as z, np.load(tmp_path / "jres.npz") as jz:
        assert list(z["gen_images"]) == ["g0", "g1", "g2"]
        assert_topk_agree(z["scores"], z["keys"], jz["scores"], jz["keys"], gen, feats, keys)

    # the brute force through the command line
    cli.main(["search", f"--gen_folder={gdir}", f"--laion_folder={root}",
              f"--out_path={tmp_path / 'brute.npz'}"])
    with np.load(tmp_path / "brute.npz") as z:
        assert z["scores"].shape == (3, 1)

    # verify on a damaged store: exit 1, read-only (nothing renamed)
    shard = store / "shard_00000.npz"
    shard.write_bytes(b"junk")
    with pytest.raises(SystemExit) as exc:
        cli.main(["verify", f"--store_dir={store}"])
    assert exc.value.code == 1 and shard.exists()


@pytest.mark.parametrize("argv", [
    ["query", "--live=true"], ["query", "--mesh.data=2"],
    ["query", "--warm_dir=w"], ["query", "--logdir=l"], ["recover"], ["compact"]],
    ids=lambda a: "_".join(a).replace("--", ""))
def test_unported_settings_and_subcommands_raise(tmp_path, monkeypatch, argv):
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    with pytest.raises(NotPortedError, match="ROADMAP Queue A item [379]"):
        cli.main(argv + [f"--store_dir={tmp_path}"])


@pytest.mark.parametrize("argv", [["query", "--ann=true", "--nprobe=4"], ["train-ivf"]],
                         ids=lambda a: "_".join(a[:2]).replace("--", ""))
def test_ann_settings_and_subcommands_run(corpus, tmp_path, monkeypatch, capsys, argv):
    """The IVF tier's command line runs: ``train-ivf`` commits a tier the JAX
    package verifies, and ``query --ann`` at nprobe = n_lists answers as the
    exact query does."""
    from dcr_tpu.search import ann as jann

    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    _, store, feats, keys, q = corpus
    gdir = tmp_path / "gens"
    gdir.mkdir()
    E.save_embeddings(gdir / "embedding.npz", q, [f"g{i}" for i in range(len(q))])
    if argv[0] == "query":
        cli.main(["train-ivf", f"--store_dir={store}", "--n_lists=4"])
    cli.main(argv + [f"--store_dir={store}", f"--gen_folder={gdir}", "--n_lists=4",
                     f"--out_path={tmp_path / 'ann.npz'}", "--top_k=3"])
    assert jann.AnnIndexReader(store).verify()["corrupt"] == 0
    if argv[0] == "train-ivf":
        assert json.loads(capsys.readouterr().out)["rows"] == len(keys)
        return
    cli.main(["query", f"--store_dir={store}", f"--gen_folder={gdir}",
              f"--out_path={tmp_path / 'exact.npz'}", "--top_k=3"])
    with np.load(tmp_path / "ann.npz") as za, np.load(tmp_path / "exact.npz") as ze:
        assert_topk_agree(za["scores"], za["keys"], ze["scores"], ze["keys"], q, feats, keys)


@pytest.mark.parametrize("field,value", [("live", True),
                                         ("mesh", MeshConfig(data=4)),
                                         ("warm_dir", "w"), ("logdir", "l")])
def test_run_search_refuses_unported_settings(corpus, tmp_path, field, value):
    folders, store, _, _, q = corpus
    gdir = tmp_path / "gens"
    gdir.mkdir()
    E.save_embeddings(gdir / "embedding.npz", q, [f"g{i}" for i in range(len(q))])
    cfg = SearchConfig(gen_folder=str(gdir), store_dir=str(store), **{field: value})
    with pytest.raises(NotPortedError):
        S.run_search(cfg, device="cpu")


def test_run_search_runs_ann_on_a_trained_store(corpus, tmp_path):
    """``run_search`` with ``ann`` answers through the IVF tier: at nprobe =
    n_lists as the exact engine does."""
    from dcr_tpu_torch.search import ann

    _, store, feats, keys, q = corpus
    ann.train_ivf(store, n_lists=4, iters=3, device="cpu")
    gdir = tmp_path / "gens"
    gdir.mkdir()
    E.save_embeddings(gdir / "embedding.npz", q, [f"g{i}" for i in range(len(q))])
    outs = {}
    for name, on in (("ann", True), ("exact", False)):
        cfg = SearchConfig(gen_folder=str(gdir), store_dir=str(store), ann=on, nprobe=4,
                           top_k=4, out_path=str(tmp_path / f"{name}.npz"))
        with np.load(S.run_search(cfg, device="cpu")) as z:
            outs[name] = z["scores"], z["keys"]
    assert_topk_agree(*outs["ann"], *outs["exact"], q, feats, keys)
    with pytest.raises(NotPortedError, match="item 3"):
        S.run_search(SearchConfig(gen_folder=str(gdir), store_dir=str(store), ann=True,
                                  live=True), device="cpu")


def test_engine_refuses_mesh_and_warm_dir(corpus):
    _, store, *_ = corpus
    reader = ST.EmbeddingStoreReader(store)
    with pytest.raises(NotPortedError, match="item 9"):
        SI.ShardedTopK(reader, mesh=object(), device="cpu")
    with pytest.raises(NotPortedError, match="item 7"):
        SI.ShardedTopK(reader, warm_dir="w", device="cpu")


@pytest.mark.parametrize("tier", ["wal"])
def test_store_with_a_wal_or_ivf_tier_raises(corpus, tmp_path, tier, monkeypatch):
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    _, store, *_ = corpus
    (store / tier).mkdir()
    for sub in ("stats", "query", "append", "train-ivf"):
        with pytest.raises(NotPortedError, match="item 3"):
            cli.main([sub, f"--store_dir={store}", f"--gen_folder={tmp_path}",
                      f"--laion_folder={tmp_path}"])


def test_store_with_an_ivf_tier_answers_as_without(corpus, tmp_path, monkeypatch, capsys):
    """An exact query, ``stats`` and ``append`` on a store with an ``ann/``
    tier run; the exact answer is bit-identical to the one before the tier."""
    from dcr_tpu_torch.search import ann

    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    folders, store, feats, keys, q = corpus
    gdir = tmp_path / "gens"
    gdir.mkdir()
    E.save_embeddings(gdir / "embedding.npz", q, [f"g{i}" for i in range(len(q))])

    def query(name):
        cli.main(["query", f"--store_dir={store}", f"--gen_folder={gdir}",
                  f"--out_path={tmp_path / name}", "--top_k=3"])
        with np.load(tmp_path / name) as z:
            return z["scores"], z["keys"]

    before = query("before.npz")
    ann.train_ivf(store, n_lists=4, iters=3, device="cpu")
    after = query("after.npz")
    np.testing.assert_array_equal(before[0], after[0])
    assert (before[1] == after[1]).all()
    capsys.readouterr()
    cli.main(["stats", f"--store_dir={store}", "--json_out=true"])
    assert json.loads(capsys.readouterr().out)["ann"]["rows"] == len(keys)
    cli.main(["append", f"--store_dir={store}", f"--dumps={folders[0] / 'embedding.npz'}"])
    assert ST.EmbeddingStoreReader(store).total == len(keys) + 10


def test_jax_ivf_and_wal_directories_are_the_ones_refused():
    """The port refuses the JAX package's WAL directory and reads its IVF
    directory under the same name."""
    from dcr_tpu.search import ann, livestore
    from dcr_tpu_torch.search import ann as port_ann

    assert (cli.WAL_DIR, port_ann.ANN_DIRNAME) == (livestore.WAL_DIR, ann.ANN_DIRNAME)


def test_engine_defaults_equal_jax():
    assert (SI.DEFAULT_SEGMENT_ROWS, SI.DEFAULT_MAX_RESIDENT_ROWS) == \
        (JSI.DEFAULT_SEGMENT_ROWS, JSI.DEFAULT_MAX_RESIDENT_ROWS)
    from dataclasses import asdict

    port, ref = asdict(SearchConfig()), asdict(JaxSearchConfig())
    assert port == ref
    assert asdict(MeshConfig()) == asdict(JaxMeshConfig())
