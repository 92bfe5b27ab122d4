"""Search on a mesh of ranks: the port's exact and ANN engines, ``query_live``
and ``dcr-search-torch query`` as gloo rank processes on the CPU, against
the JAX engines on a JAX CPU mesh of the same shape (conftest's 8 host
devices).

- The exact engine on two ranks, resident and streamed (``max_resident_rows``
  below the store), on ``data = 2`` and on ``fsdp = 2``; on four ranks as
  ``data = 2 x tensor = 2``, where the two tensor ranks of a batch rank hold
  the same rows. ``segment_rows`` equals the JAX engine's (101 requested: 102
  on two batch ranks, the store of 301 rows three segments, the last slab
  of rank 1 part pad).
- The ANN engine and ``query_live`` with a WAL tail on ``data = 2``.
- Two ranks of ``dcr-search-torch query`` leave one result file (rank 0's),
  equal to one process's.
- A copy-risk index built on each rank of a two-rank job makes no cross-rank
  exchange (``mesh.EXCHANGE_STATS`` stays empty).

Every rank returns the same table, held to the JAX engine's by the tie rule
of ``tests/test_torch_search.py`` ``assert_topk_agree`` (the ANN tables by
``tests/test_torch_ann.py`` ``assert_ann_agree``); one exchange of
candidates per exact query call (two gathers: the keys' width, then the
table) and two per ANN call (the shortlists, then the exact tables).
"""

from __future__ import annotations

import pickle

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dcr_tpu.core.config import MeshConfig as JaxMeshConfig  # noqa: E402
from dcr_tpu.parallel import mesh as JPM  # noqa: E402
from dcr_tpu.search import annindex as JAI  # noqa: E402
from dcr_tpu.search import livestore as JL  # noqa: E402
from dcr_tpu.search import shardindex as JSI  # noqa: E402
from dcr_tpu.search import store as JST  # noqa: E402
from dcr_tpu_torch.cli import search as cli  # noqa: E402
from dcr_tpu_torch.search import ann  # noqa: E402
from dcr_tpu_torch.search import embed as E  # noqa: E402
from dcr_tpu_torch.search import livestore as LS  # noqa: E402
from dcr_tpu_torch.search import store as ST  # noqa: E402
from tests._torch_ranks import Ranks, check  # noqa: E402
from tests.test_torch_ann import assert_ann_agree  # noqa: E402
from tests.test_torch_search import assert_topk_agree  # noqa: E402

DIM = 16
ROWS = 301
EXACT = dict(top_k=5, query_batch=8, segment_rows=101)
ANN = dict(top_k=5, nprobe=3, query_batch=8, segment_rows=64)
MESHES = {"data": dict(data=2), "fsdp": dict(data=1, fsdp=2),
          "tensor": dict(data=2, tensor=2)}


def _store(path, feats, keys):
    w = ST.EmbeddingStoreWriter.create(path, shard_rows=64)
    w.add(feats, keys)
    w.finalize()
    return path


def _jax_mesh(axes: dict):
    n = int(np.prod(list(axes.values())))
    return JPM.make_mesh(JaxMeshConfig(**axes), devices=jax.devices()[:n])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both rank jobs, started together: two ranks (every run but one) and
    four (``data = 2 x tensor = 2``)."""
    tmp = tmp_path_factory.mktemp("mesh_search")
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((8, DIM)).astype(np.float32) * 3
    feats = centers[rng.integers(0, 8, ROWS)] + rng.standard_normal((ROWS, DIM)).astype(
        np.float32) * 0.3
    feats[290:] = feats[:11]                 # exact duplicates: equal scores
    keys = [f"r{i}" for i in range(ROWS)]
    q = (feats[rng.choice(ROWS, 20, replace=False)]
         + rng.standard_normal((20, DIM)).astype(np.float32) * 0.1)
    exact = _store(tmp / "exact", feats, keys)
    ivf = _store(tmp / "ivf", feats, keys)
    ann.train_ivf(ivf, n_lists=8, iters=3, seed=0, device="cpu")
    live = _store(tmp / "live", feats, keys)
    # tail rows beside the first queries: they enter those answers
    tail = q[:7] * 1.5 + rng.standard_normal((7, DIM)).astype(np.float32) * 0.05
    with LS.LiveStore.open(live) as ls:
        ls.append(tail, [f"w{i}" for i in range(7)])
    risk = _store(tmp / "risk", rng.standard_normal((40, 512)).astype(np.float32),
                  [f"t{i}" for i in range(40)])
    gens = tmp / "gens"
    gens.mkdir()
    E.save_embeddings(gens / "embedding.npz", q, [f"g{i}" for i in range(len(q))])
    jobs = {}
    for world, names in ((2, ("data", "fsdp")), (4, ("tensor",))):
        d = tmp / f"world{world}"
        d.mkdir()
        np.save(d / "q.npy", q)
        plan = {}
        for name in names:
            plan[f"exact_{name}"] = dict(kind="exact", store=str(exact), mesh=MESHES[name],
                                         kw=EXACT)
            plan[f"exact_{name}_streamed"] = dict(kind="exact", store=str(exact),
                                                  mesh=MESHES[name],
                                                  kw=dict(EXACT, max_resident_rows=1))
        if world == 2:
            plan["exact_default"] = dict(kind="exact", store=str(exact), mesh=MESHES["data"],
                                         kw=dict(top_k=3))
            plan["ann"] = dict(kind="ann", store=str(ivf), mesh=MESHES["data"], kw=ANN)
            plan["live"] = dict(kind="live", store=str(live), mesh=MESHES["data"], kw=EXACT)
            plan["cli"] = dict(kind="cli", argv=[
                "query", f"--store_dir={exact}", f"--gen_folder={gens}",
                f"--out_path={d / 'out' / 'result.npz'}", "--top_k=5", "--query_batch=8",
                "--segment_rows=101", "--mesh.data=2"])
            plan["copyrisk"] = dict(kind="copyrisk", store=str(risk))
        jobs[world] = (d, Ranks("mesh_search", world, d, {"runs": plan}))
    got = {}
    for world, (d, job) in jobs.items():
        check(job.wait(timeout=300))
        got[world] = [pickle.loads((d / f"mesh_search_{r}.pkl").read_bytes())
                      for r in range(world)]
    return dict(tmp=tmp, feats=feats, keys=keys, q=q, tail=tail, exact=exact, ivf=ivf,
                live=live, gens=gens, got=got)


def _ranks(runs, name):
    """Every rank's record of run ``name``, after checking the ranks hold
    the same table."""
    world = 4 if name.startswith("exact_tensor") else 2
    recs = [r[name] for r in runs["got"][world]]
    for rec in recs[1:]:
        np.testing.assert_array_equal(rec["scores"], recs[0]["scores"])
        assert (rec["keys"] == recs[0]["keys"]).all()
    return recs


@pytest.mark.parametrize("name", ["data", "fsdp", "tensor"])
@pytest.mark.parametrize("streamed", [False, True], ids=["resident", "streamed"])
def test_exact_engine_on_a_mesh_agrees_with_the_jax_engine(runs, name, streamed):
    recs = _ranks(runs, f"exact_{name}" + ("_streamed" if streamed else ""))
    limit = 1 if streamed else JSI.DEFAULT_MAX_RESIDENT_ROWS
    jeng = JSI.ShardedTopK(JST.EmbeddingStoreReader(runs["exact"]),
                           mesh=_jax_mesh(MESHES[name]), max_resident_rows=limit, **EXACT).build()
    js, jk = jeng.query(runs["q"])
    assert recs[0]["segment_rows"] == jeng.segment_rows == 102
    assert {r["resident"] for r in recs} == {not streamed} == {jeng.resident}
    assert_topk_agree(recs[0]["scores"], recs[0]["keys"], js, jk, runs["q"], runs["feats"],
                      runs["keys"])
    # the batch ranks hold the store between them once; tensor ranks repeat it
    batch_ranks = 2
    assert sum(r["rows_held"] for r in recs) == ROWS * len(recs) // batch_ranks
    assert recs[0]["rows_held"] == 153 and recs[1]["rows_held"] == (153 if name == "tensor"
                                                                    else 148)
    # one candidate exchange per query call: the keys' width, then the table
    assert recs[0]["exchanges"]["topk_exchange"]["calls"] == 2


def test_default_segment_rows_pad_to_the_rank_count_as_jax(runs):
    rec = _ranks(runs, "exact_default")[0]
    jeng = JSI.ShardedTopK(JST.EmbeddingStoreReader(runs["exact"]),
                           mesh=_jax_mesh(MESHES["data"]), top_k=3).build()
    assert rec["segment_rows"] == jeng.segment_rows == 302
    js, jk = jeng.query(runs["q"])
    assert_topk_agree(rec["scores"], rec["keys"], js, jk, runs["q"], runs["feats"], runs["keys"])


def test_ann_engine_on_a_mesh_agrees_with_the_jax_engine(runs):
    rec = _ranks(runs, "ann")[0]
    jeng = JAI.AnnEngine(runs["ivf"], mesh=_jax_mesh(MESHES["data"]), **ANN).build()
    js, jk = jeng.query(runs["q"])
    assert (rec["segment_rows"], rec["rerank_rows"]) == (jeng.segment_rows, jeng.rerank_rows)
    assert_ann_agree(rec["scores"], rec["keys"], js, jk, runs["q"], runs["feats"], runs["keys"])
    # no exchange per scanned segment: the shortlists, then the exact tables
    assert rec["exchanges"]["topk_exchange"]["calls"] == 3


def test_query_live_on_a_mesh_merges_the_tail_as_jax(runs):
    rec = _ranks(runs, "live")[0]
    js, jk = JL.query_live(runs["live"], runs["q"], mesh=_jax_mesh(MESHES["data"]), **EXACT)
    feats = np.concatenate([runs["feats"], runs["tail"]])
    keys = runs["keys"] + [f"w{i}" for i in range(7)]
    assert_topk_agree(rec["scores"], rec["keys"], js, jk, runs["q"], feats, keys)
    assert [k.startswith("w") for k in rec["keys"][:7, 0]] == [True] * 7


def test_query_cli_on_two_ranks_writes_one_file_equal_to_one_process(runs, monkeypatch):
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    out = runs["tmp"] / "world2" / "out"
    assert sorted(p.name for p in out.iterdir()) == ["result.npz"]
    one = runs["tmp"] / "one" / "result.npz"
    cli.main(["query", f"--store_dir={runs['exact']}", f"--gen_folder={runs['gens']}",
              f"--out_path={one}", "--top_k=5", "--query_batch=8", "--segment_rows=101"])
    with np.load(out / "result.npz") as a, np.load(one) as b:
        assert list(a["gen_images"]) == list(b["gen_images"])
        assert_topk_agree(a["scores"], a["keys"], b["scores"], b["keys"], runs["q"],
                          runs["feats"], runs["keys"])


def test_copy_risk_index_in_a_rank_job_makes_no_exchange(runs):
    for rank in runs["got"][2]:
        rec = rank["copyrisk"]
        assert rec["exchanges"] == {} and np.isfinite(rec["scores"]).all()
