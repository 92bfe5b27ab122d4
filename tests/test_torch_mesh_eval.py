"""Eval and embedding on a mesh of ranks: ``dcr-eval-torch`` and
``dcr-search-torch embed`` as two gloo rank processes on the CPU
(``--mesh.data=2``) and, for the port's one-process reference, a job of one
rank, both started once for the whole file.

- ``run_eval`` on two ranks against the JAX ``run_eval`` on
  ``MeshConfig(data=2)`` (a JAX CPU mesh of two host devices) with the same
  SSCD weights, over ``tests/test_torch_eval_runner.py``'s folder and
  stages: every scalar at the f32 bar (atol 2e-4, rtol 1e-3,
  ``tests/test_torch_parity.py:69-71``), ``sim_gt_05pc`` equal, the
  similarity matrix at the bar.
- ``run_eval`` with every stage on (CLIP score, complexity, FID and
  precision/recall, whose extractors split each batch over the ranks) on
  two ranks against one process of the port: every scalar at the bar.
- The similarity matrix (dot product, and splitloss over every chunk pair)
  and the train↔train background over blocks whose rows do not divide over
  the ranks, against the JAX functions on a two-device mesh.
- An embed dump of a tar with a corrupt member on two ranks (batches of 2,
  one image per rank) against one process (batches of 1): keys equal and
  in order, features at the bar, each rank decoding only its rows.

Every rank returns the same scalars, and rank 0 alone writes: an audit hook
in each rank records every path it opens for writing under the outputs.
"""

from __future__ import annotations

import math
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from dcr_tpu.core.config import EvalConfig as JaxEvalConfig  # noqa: E402
from dcr_tpu.core.config import MeshConfig as JaxMeshConfig  # noqa: E402
from dcr_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from dcr_tpu.eval import similarity as JSIM  # noqa: E402
from dcr_tpu.eval.runner import run_eval as jax_run_eval  # noqa: E402
from dcr_tpu.parallel import mesh as JPM  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.search import embed as E  # noqa: E402
from tests._torch_ranks import Ranks, check  # noqa: E402
from tests.test_torch_eval_runner import _he_scaled_sscd_params, _write_folder  # noqa: E402
from tests.test_torch_search_embed import _image_bytes, _photo, _write_tar  # noqa: E402

ATOL, RTOL = 2e-4, 1e-3
COMMON = dict(pt_style="sscd", batch_size=8, image_size=32, galleries=True, gallery_topk=3,
              gallery_rows=4, gallery_max_rank=8)
SIM_STAGES = dict(compute_fid=False, compute_clip_score=False, compute_complexity=False)


def _argv(cfg: dict) -> list[str]:
    return [f"--{k}={v}" for k, v in cfg.items()]


def _close(a: float, b: float) -> bool:
    return (math.isnan(a) and math.isnan(b)) or abs(a - b) <= ATOL + RTOL * abs(b)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Two jobs started together, the port's two ranks and its one process
    (a job of one rank), while the JAX reference runs here."""
    tmp = tmp_path_factory.mktemp("mesh_eval")
    gen, train = _write_folder(tmp)
    # every stage over a smaller folder: 4 generations, 6 training images
    small_gen, small_train = _write_folder(tmp / "small", n_gen=4, per_class=3)
    params = _he_scaled_sscd_params()
    rng = np.random.default_rng(3)
    tars = tmp / "tars"
    tars.mkdir()
    members = {f"{i}.jpg": _image_bytes(_photo(rng, 40, 36), "JPEG") for i in range(7)}
    members = dict(list(members.items())[:3] + [("broken.jpg", b"\xff\xd8\xff junk")]
                   + list(members.items())[3:])
    _write_tar(tars / "000.tar", members)
    sim = {"values": rng.standard_normal((13, 16)).astype(np.float32),
           "query": rng.standard_normal((11, 16)).astype(np.float32)}
    sim_run = dict(query_dir=gen, values_dir=train, **COMMON, **SIM_STAGES,
                   dup_weights_pickle=tmp / "weights.pickle")
    every = dict(query_dir=small_gen, values_dir=small_train, **COMMON,
                 compute_complexity=True)
    jobs = {}
    for world in (2, 1):
        d = tmp / ("two" if world == 2 else "one")
        d.mkdir()
        torch.save(EX.sscd_from_flax(params), d / "sscd.pt")
        np.savez(d / "sim.npz", **sim)
        mesh = [f"--mesh.data={world}"]
        plan = {"watch": [str(d / "out")],
                "eval": {"every": _argv(dict(every, output_dir=d / "out" / "every")) + mesh
                         + [f"--values_caption_json={tmp / 'small' / 'caps.json'}"]},
                # one image per rank and batch on two ranks, as one process's batch of 1
                "embed": {"tars": [f"--gen_folder={tars}", "--image_size=32",
                                   f"--batch_size={world}",
                                   f"--embedding_out={d / 'out' / 'embed'}", *mesh]}}
        if world == 2:
            plan["eval"]["sim"] = _argv(dict(sim_run, output_dir=d / "out" / "sim")) + mesh
        jobs[world] = Ranks("mesh_eval", world, d, plan)
    mesh_of = JPM.make_mesh
    JPM.make_mesh = lambda cfg=None, devices=None: mesh_of(cfg, devices=jax.devices()[:2])
    try:
        ref = jax_run_eval(JaxEvalConfig(output_dir=str(tmp / "jax"), mesh=JaxMeshConfig(data=2),
                                         **{k: str(v) if hasattr(v, "parent") else v
                                            for k, v in sim_run.items()}),
                           backbone_params=params, tokenizer=JaxHashTokenizer(1000, 77))
    finally:
        JPM.make_mesh = mesh_of
    got = {}
    for world, job in jobs.items():
        check(job.wait(timeout=400))
        d = tmp / ("two" if world == 2 else "one")
        got[world] = [pickle.loads((d / f"mesh_eval_{r}.pkl").read_bytes())
                      for r in range(world)]
    return dict(tmp=tmp, ref=ref, sim=sim, got=got[2], one=got[1][0],
                two=tmp / "two" / "out", one_out=tmp / "one" / "out")


def _same_on_every_rank(got, name):
    a, b = (g["eval"][name] for g in got)
    assert list(a) == list(b)
    for k in a:
        assert a[k] == b[k] or (math.isnan(a[k]) and math.isnan(b[k])), (k, a[k], b[k])
    return a


def test_run_eval_on_two_ranks_matches_the_jax_mesh_run(runs):
    ours, ref = _same_on_every_rank(runs["got"], "sim"), runs["ref"]
    assert list(ours) == list(ref)
    for name in ref:
        assert _close(ours[name], ref[name]), (name, ours[name], ref[name])
    assert ours["sim_gt_05pc"] == ref["sim_gt_05pc"]
    sim = np.load(runs["two"] / "sim" / "similarity.npy")
    np.testing.assert_allclose(sim, np.load(runs["tmp"] / "jax" / "similarity.npy"),
                               atol=ATOL, rtol=RTOL)


def test_every_stage_on_two_ranks_matches_one_process(runs):
    ours, one = _same_on_every_rank(runs["got"], "every"), runs["one"]["eval"]["every"]
    assert list(ours) == list(one)
    for name in ("FID_val", "precision", "recall", "gen_clipscore", "train_clipscore",
                 "corr_entropy_sim", "sim_gt_05pc"):
        assert name in ours, name
    for name in one:
        assert _close(ours[name], one[name]), (name, ours[name], one[name])
    assert ours["sim_gt_05pc"] == one["sim_gt_05pc"]


def test_only_rank_zero_writes(runs):
    rank0, rank1 = (g["written"] for g in runs["got"])
    assert rank1 == []
    two = runs["two"]
    for path in (two / "sim" / "similarity.npy", two / "sim" / "logs" / "metrics.jsonl",
                 two / "every" / "fid_stats_values.npz", two / "every" / "provenance.json",
                 two / "embed.npz"):
        assert path.exists() and any(p.startswith(str(path)) for p in rank0), path
    assert list((two / "every" / "galleries").glob("gallery_rank*.png"))


def test_similarity_products_on_two_ranks_match_jax(runs):
    values, query = runs["sim"]["values"], runs["sim"]["query"]
    mesh = JPM.make_mesh(JaxMeshConfig(data=2), devices=jax.devices()[:2])
    want = {"dot": JSIM.similarity_matrix(values, query, block_size=5, mesh=mesh),
            "cross": JSIM.similarity_matrix(values, query, metric="splitloss", num_chunks=4,
                                            chunk_style="cross", block_size=5, mesh=mesh),
            "bg": JSIM.train_train_background(values, block_size=5, mesh=mesh)}
    for g in runs["got"]:
        for name, ref in want.items():
            np.testing.assert_allclose(g["sim"][name], np.asarray(ref), atol=ATOL, rtol=RTOL,
                                       err_msg=name)


def test_embed_dump_on_two_ranks_matches_one_process(runs):
    fa, ka = E.load_embeddings(runs["two"] / "embed.npz")
    fb, kb = E.load_embeddings(runs["one_out"] / "embed.npz")
    assert ka == kb == [f"000/{i}" for i in range(7)]
    np.testing.assert_allclose(fa, fb, atol=ATOL, rtol=RTOL)
    # 8 members, the corrupt one included: 4 batches of 2, one member per rank
    decoded = "search/embed_decoded_total"
    assert [g["embed"]["tars"][decoded] for g in runs["got"]] == [4, 4]
    assert runs["one"]["embed"]["tars"][decoded] == 8
