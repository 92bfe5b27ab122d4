"""PyTorch port: live copy-risk scoring (``dcr_tpu_torch.obs.copyrisk``)
against the JAX package's ``dcr_tpu.obs.copyrisk``, on the CPU.

- dumps: both formats load alike in both packages; the corrupt, torn,
  non-finite, wrong-width and missing inputs of ``tests/test_risk.py`` give
  the same typed errors, quarantines and counters;
- the scorer against ``make_risk_scorer`` under the search slice's tie rule
  (``tests/test_torch_search.assert_topk_agree``);
- ``prepare_images``: equal (1e-6) to the port's embedding pipeline reading
  the saved PNG; against the JAX one (PIL's bilinear) within one uint8 level
  after normalisation, (1/255)/min(std) = 0.0175, and equal where no
  resampling happens;
- ``CopyRiskIndex.score_batch``, dense and store-backed, against the JAX
  index with the same SSCD weights (one torch state-dict file read by both):
  SSCD features agree at the f32 bar (atol 2e-4, rtol 1e-3), so cosine
  scores are held within 1e-3 and keys wherever the exact gap exceeds
  twice that; the port's two modes agree with each other under the tie rule;
- the evidence recorder's bound and refund, ``flagged_pair_gallery``,
  ``observe_scores`` and ``RiskScore.doc`` against the JAX ones.
"""

from __future__ import annotations

import base64
import io
import json
import pickle

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from PIL import Image  # noqa: E402

import dcr_tpu.obs.copyrisk as JCR  # noqa: E402
import dcr_tpu_torch.obs.copyrisk as TCR  # noqa: E402
from dcr_tpu.core import resilience as JRes  # noqa: E402
from dcr_tpu.core.config import RiskConfig as JRiskConfig  # noqa: E402
from dcr_tpu.eval.gallery import flagged_pair_gallery as j_gallery  # noqa: E402
from dcr_tpu.search.embed import save_embeddings as j_save  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.core import tracing  # noqa: E402
from dcr_tpu_torch.eval.features import IMAGENET_NORM, EvalImageFolder, reference_resize_for  # noqa: E402
from dcr_tpu_torch.eval.gallery import flagged_pair_gallery  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.sampling.png import encode_png, read_png  # noqa: E402
from dcr_tpu_torch.search.embed import save_embeddings  # noqa: E402
from dcr_tpu_torch.search.store import EmbeddingStoreWriter  # noqa: E402
from tests.test_torch_eval_runner import _he_scaled_sscd_params  # noqa: E402
from tests.test_torch_search import assert_topk_agree  # noqa: E402

PKGS = {"jax": JCR, "port": TCR}
EMBED_DIM = 512
# one uint8 level after ImageNet normalisation
PREP_ATOL = (1 / 255) / min(IMAGENET_NORM[1]) + 1e-6
# cosine scores of SSCD features held at the f32 bar
SCORE_ATOL = 1e-3


def _faults(pkg: str) -> dict:
    if pkg == "jax":
        return JRes.counters()
    return {k[len("faults/"):]: v for k, v in tracing.registry().counters("faults/").items()}


def _features(n: int, dim: int = EMBED_DIM) -> np.ndarray:
    base = np.arange(n * dim, dtype=np.float32).reshape(n, dim)
    return np.cos(base * 0.37) + 0.01 * base / (n * dim)


def _keys(n: int) -> list:
    return [f"train/img_{i:04d}.png" for i in range(n)]


def _grad_image(i: int, size: int = 16) -> np.ndarray:
    x = np.linspace(0, 1, size * size * 3, dtype=np.float32)
    return np.roll(x, i * 97).reshape(size, size, 3) * ((i % 3 + 1) / 3.0)


def _uint8(img: np.ndarray) -> np.ndarray:
    return (np.clip(img, 0, 1) * 255).round().astype(np.uint8)


# ---------------------------------------------------------------------------
# dumps
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_dumps_load_alike_in_both_packages(tmp_path, writer):
    feats, keys = _features(5), _keys(5)
    (j_save if writer == "jax" else save_embeddings)(tmp_path / "embedding.npz", feats, keys)
    with open(tmp_path / "embedding.pkl", "wb") as f:
        pickle.dump({"features": torch.from_numpy(feats), "indexes": keys}, f)
    for name in ("embedding.npz", "embedding.pkl"):
        mine, theirs = TCR.load_risk_dump(tmp_path / name), JCR.load_risk_dump(tmp_path / name)
        assert mine[1] == theirs[1] == keys
        np.testing.assert_array_equal(mine[0], theirs[0])
        np.testing.assert_allclose(mine[0], feats, rtol=1e-6)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_corrupt_dump_is_quarantined_and_counted(tmp_path, pkg):
    path = tmp_path / "embedding.npz"
    path.write_bytes(b"this is not a zip archive at all")
    before = _faults(pkg).get("copy_risk/index_corrupt_total", 0)
    with pytest.raises(PKGS[pkg].RiskIndexError, match="corrupt embedding dump"):
        PKGS[pkg].load_risk_dump(path)
    assert not path.exists()
    assert len(list(tmp_path.glob("embedding.npz.quarantined.*"))) == 1
    assert _faults(pkg)["copy_risk/index_corrupt_total"] == before + 1


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_torn_nonfinite_and_wrong_width_dumps_are_refused_in_place(tmp_path, pkg):
    mod = PKGS[pkg]
    np.savez(tmp_path / "torn.npz", features=_features(4), indexes=np.asarray(_keys(3)))
    before = _faults(pkg).get("copy_risk/index_invalid_total", 0)
    with pytest.raises(mod.RiskIndexError, match="torn"):
        mod.load_risk_dump(tmp_path / "torn.npz")
    assert (tmp_path / "torn.npz").exists()
    assert not list(tmp_path.glob("torn.npz.quarantined.*"))
    assert _faults(pkg)["copy_risk/index_invalid_total"] == before + 1
    bad = _features(4)
    bad[2, 7] = np.nan
    save_embeddings(tmp_path / "nan.npz", bad, _keys(4))
    with pytest.raises(mod.RiskIndexError, match="non-finite"):
        mod.load_risk_dump(tmp_path / "nan.npz")
    assert (tmp_path / "nan.npz").exists()
    with pytest.raises(mod.RiskIndexError, match="width"):
        mod.verify_risk_dump(np.zeros((3, 64), np.float32), _keys(3))
    with pytest.raises(mod.RiskIndexError, match="non-empty"):
        mod.verify_risk_dump(np.zeros((0, EMBED_DIM), np.float32), [])
    with pytest.raises(mod.RiskIndexError, match="no embedding dump"):
        mod.load_risk_dump(tmp_path / "missing.npz")


def test_a_torn_sidecar_checked_dump_is_quarantined(tmp_path):
    """A dump failing its sha256 sidecar is damage: quarantined with its
    sidecar, so a rewritten dump is not condemned by the stale one."""
    path = save_embeddings(tmp_path / "embedding.npz", _features(4), _keys(4))
    path.write_bytes(path.read_bytes()[:-7])
    with pytest.raises(TCR.RiskIndexError, match="corrupt"):
        TCR.load_risk_dump(path)
    assert not path.exists() and not (tmp_path / "embedding.npz.sha256").exists()
    assert len(list(tmp_path.glob("*.quarantined.*"))) == 2


# ---------------------------------------------------------------------------
# scorer, transform, decode
# ---------------------------------------------------------------------------

def test_scorer_matches_jax_under_the_tie_rule():
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((64, EMBED_DIM)).astype(np.float32)
    feats /= np.linalg.norm(feats, axis=-1, keepdims=True)
    # queries NOT normalised: both scorers normalise; two are planted copies
    q = np.concatenate([feats[[3, 11]] * np.asarray([[7.5], [0.2]], np.float32),
                        rng.standard_normal((6, EMBED_DIM)).astype(np.float32)])
    j_sims, j_idx = (np.asarray(a) for a in JCR.make_risk_scorer(5)(feats, q))
    t_sims, t_idx = TCR.make_risk_scorer(5)(torch.from_numpy(feats), torch.from_numpy(q))
    keys = np.asarray([f"k{i}" for i in range(64)], object)
    qn = q / np.linalg.norm(q, axis=-1, keepdims=True)
    assert_topk_agree(t_sims.numpy(), keys[t_idx.numpy()], j_sims, keys[j_idx], qn, feats,
                      list(keys))
    assert list(t_idx[:2, 0].numpy()) == [3, 11]
    np.testing.assert_allclose(t_sims[:2, 0].numpy(), [1.0, 1.0], atol=1e-5)
    assert (np.diff(t_sims.numpy(), axis=1) <= 0).all()


@pytest.mark.parametrize("size,image_size", [(24, 16), (16, 32), (37, 32), (256, 224)])
def test_prepare_images_is_the_embed_pipelines_transform(tmp_path, size, image_size):
    img = _grad_image(1, size=size)
    (tmp_path / "gen_0.png").write_bytes(encode_png(_uint8(img)))
    folder = EvalImageFolder(tmp_path, image_size, resize_to=reference_resize_for(image_size),
                             normalize=IMAGENET_NORM)
    mine = TCR.prepare_images(img[None], image_size)
    np.testing.assert_allclose(mine[0], folder.load(0), atol=1e-6, rtol=0)
    theirs = JCR.prepare_images(img[None], image_size)
    assert mine.shape == theirs.shape == (1, image_size, image_size, 3)
    resampled = size != reference_resize_for(image_size)
    np.testing.assert_allclose(mine, theirs, atol=PREP_ATOL if resampled else 1e-6, rtol=0)


@pytest.mark.parametrize("fmt", ["PNG", "JPEG"])
def test_decode_image_b64_reads_what_pil_reads(fmt):
    buf = io.BytesIO()
    Image.fromarray(_uint8(_grad_image(2, 24))).save(buf, format=fmt)
    body = {"image_png_b64": base64.b64encode(buf.getvalue()).decode()}
    mine, theirs = TCR.decode_image_b64(body), JCR.decode_image_b64(body)
    assert mine.shape == theirs.shape == (24, 24, 3) and mine.dtype == np.float32
    np.testing.assert_array_equal(mine, theirs)


def test_decode_image_b64_refuses_bad_bodies():
    for mod in PKGS.values():
        with pytest.raises(ValueError, match="image_png_b64"):
            mod.decode_image_b64({})
        with pytest.raises(ValueError, match="undecodable"):
            mod.decode_image_b64({"image_png_b64": "bm90IGFuIGltYWdl"})
        with pytest.raises(ValueError, match="undecodable"):
            mod.decode_image_b64({"image_png_b64": "!!!"})


# ---------------------------------------------------------------------------
# the index against the JAX index
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def sscd_file(tmp_path_factory):
    """He-scaled Flax SSCD weights as a torch state-dict file, read by both
    packages through risk.weights_path."""
    path = tmp_path_factory.mktemp("sscd") / "sscd.pt"
    torch.save(EX.sscd_from_flax(_he_scaled_sscd_params()), path)
    return path


def _corpus(tmp_path, sscd_file, images):
    """A dump of 300 random unit rows plus the port's SSCD embeddings of
    ``images`` (keys ``planted/<i>``), and a store of the same rows."""
    from dcr_tpu_torch.eval.features import make_extractor
    from dcr_tpu_torch.eval.runner import build_backbone, load_backbone_params

    model = build_backbone("sscd", "resnet50_disc", "cpu",
                           state_dict=load_backbone_params("sscd", "resnet50_disc",
                                                           str(sscd_file)))
    planted = make_extractor(model, "cpu")(TCR.prepare_images(images, 32)).numpy()
    rng = np.random.default_rng(1)
    rows = rng.standard_normal((300, EMBED_DIM)).astype(np.float32)
    feats = np.concatenate([rows, planted])
    keys = [f"laion/{i}" for i in range(300)] + [f"planted/{i}" for i in range(len(images))]
    dump = save_embeddings(tmp_path / "train.npz", feats, keys)
    writer = EmbeddingStoreWriter.create(tmp_path / "store", embed_dim=EMBED_DIM,
                                         shard_rows=128)
    writer.add(feats, keys)
    writer.finalize()
    return dump, tmp_path / "store", feats, keys


def test_index_scores_match_the_jax_index(tmp_path, sscd_file):
    images = np.stack([_grad_image(i) for i in range(3)])
    dump, store, feats, keys = _corpus(tmp_path, sscd_file, images[:2])
    queries = np.concatenate([images, _grad_image(7)[None]])       # 2 copies, 2 others
    jidx = JCR.CopyRiskIndex.load(
        JRiskConfig(index_path=str(dump), image_size=32, top_k=3,
                    weights_path=str(sscd_file)), batch=4)
    theirs, j_feats = jidx.score_batch_with_features(queries)
    common = dict(image_size=32, top_k=3, weights_path=str(sscd_file))
    dense = TCR.CopyRiskIndex.load(TC.RiskConfig(index_path=str(dump), **common), batch=4,
                                   device="cpu")
    by_store = TCR.CopyRiskIndex.load(TC.RiskConfig(store_dir=str(store), segment_rows=100,
                                                    **common), batch=4, device="cpu")
    assert len(dense) == len(by_store) == len(jidx) == 302
    mine, t_feats = dense.score_batch_with_features(queries)
    np.testing.assert_allclose(t_feats, np.asarray(j_feats), atol=2e-4, rtol=1e-3)
    unit = feats / np.linalg.norm(feats, axis=-1, keepdims=True)
    qn = t_feats / np.linalg.norm(t_feats, axis=-1, keepdims=True)
    exact = np.sort(qn.astype(np.float64) @ unit.T.astype(np.float64), axis=1)[:, ::-1]
    for i, (m, t) in enumerate(zip(mine, theirs)):
        np.testing.assert_allclose([s for _, s in m.topk], [s for _, s in t.topk],
                                   atol=SCORE_ATOL, rtol=0)
        for r in range(3):
            gap = min(exact[i, r - 1] - exact[i, r] if r else np.inf,
                      exact[i, r] - exact[i, r + 1])
            if gap > 2 * SCORE_ATOL:
                assert m.topk[r][0] == t.topk[r][0], (i, r)
    assert [s.top_key for s in mine[:2]] == ["planted/0", "planted/1"]
    assert all(s.max_sim > 0.9999 for s in mine[:2])
    # the store-backed index: the same queries under the tie rule
    stored = by_store.score_batch(queries)
    assert_topk_agree(np.asarray([[s for _, s in r.topk] for r in stored]),
                      np.asarray([[k for k, _ in r.topk] for r in stored], object),
                      np.asarray([[s for _, s in r.topk] for r in mine]),
                      np.asarray([[k for k, _ in r.topk] for r in mine], object),
                      qn, unit, keys)
    assert mine[0].doc(0.5) == {"max_sim": round(mine[0].max_sim, 6), "top_key": "planted/0",
                                "flagged": True,
                                "topk": [[k, round(s, 6)] for k, s in mine[0].topk]}
    with pytest.raises(ValueError, match="exceeds"):
        dense.score_batch(np.stack([images[0]] * 5))


def test_ann_scoring_is_not_ported(tmp_path):
    with pytest.raises(TC.NotPortedError, match="item 1\\)"):
        TCR.CopyRiskIndex(_features(3), _keys(3), TC.RiskConfig(ann=True, store_dir="s"),
                          batch=2, device="cpu")
    cfg = TC.TrainConfig()
    cfg.risk = TC.RiskConfig(ann=True, store_dir="s")
    with pytest.raises(TC.NotPortedError, match="item 1\\)"):
        TC.validate_train_config(cfg)
    cfg.risk = TC.RiskConfig(index_path="train.npz")   # scored since the serving slice
    TC.validate_train_config(cfg)


# ---------------------------------------------------------------------------
# telemetry, evidence, gallery
# ---------------------------------------------------------------------------

def test_observe_scores_and_docs_match_jax():
    scores = [(0.99, "a"), (0.42, "b"), (0.5, "c")]
    mine = [TCR.RiskScore(s, k, [(k, s), ("z", 0.1)]) for s, k in scores]
    theirs = [JCR.RiskScore(s, k, [(k, s), ("z", 0.1)]) for s, k in scores]
    tracing.registry().reset("copy_risk/")
    assert TCR.observe_scores(mine, 0.5) == JCR.observe_scores(theirs, 0.5)
    assert [m.doc(0.5) for m in mine] == [t.doc(0.5) for t in theirs]
    reg = tracing.registry()
    assert reg.counters("copy_risk/") == {"copy_risk/scored_total": 3,
                                          "copy_risk/flagged_total": 2}
    assert reg.snapshot()["histograms"]["copy_risk/sim"]["count"] == 3


def test_evidence_recorder_is_bounded(tmp_path):
    tracing.registry().reset("copy_risk/evidence")
    rec = TCR.EvidenceRecorder(tmp_path / "ev", max_evidence=2)
    score = TCR.RiskScore(max_sim=0.99, top_key="train/x.png", topk=[("train/x.png", 0.99)])
    img = _grad_image(0)
    paths = [rec.record(img, score, 0.5, request_id=i, prompt="p", seed=7) for i in (1, 2, 3)]
    assert paths[0] is not None and paths[1] is not None and paths[2] is None
    docs = sorted((tmp_path / "ev").glob("flagged_*.json"))
    assert len(docs) == 2 and len(list((tmp_path / "ev").glob("flagged_*.png"))) == 2
    doc = json.loads(docs[0].read_text())
    assert doc["top_key"] == "train/x.png" and doc["request_id"] == 1
    np.testing.assert_array_equal(read_png(tmp_path / "ev" / doc["image"]), _uint8(img))
    counters = tracing.registry().counters("copy_risk/")
    assert counters["copy_risk/evidence_dumped_total"] == 2
    assert counters["copy_risk/evidence_dropped_total"] == 1
    assert TCR.EvidenceRecorder(None, 8).record(img, score, 0.5) is None


def test_evidence_write_failure_refunds_its_slot(tmp_path):
    blocker = tmp_path / "ev"
    blocker.write_text("a file where the evidence dir should be")
    rec = TCR.EvidenceRecorder(blocker, max_evidence=1)
    score = TCR.RiskScore(max_sim=0.99, top_key="train/x.png", topk=[("train/x.png", 0.99)])
    before = _faults("port").get("copy_risk/evidence_write_failed", 0)
    assert rec.record(_grad_image(0), score, 0.5, request_id=1) is None
    assert _faults("port")["copy_risk/evidence_write_failed"] == before + 1
    blocker.unlink()
    assert rec.record(_grad_image(0), score, 0.5, request_id=2) is not None
    assert len(list(blocker.glob("flagged_*.json"))) == 1


def test_flagged_pair_gallery_pages_like_jax(tmp_path):
    flags, matches = [], []
    for i in range(3):
        f, m = tmp_path / f"flag_{i}.png", tmp_path / f"match_{i}.png"
        f.write_bytes(encode_png(_uint8(_grad_image(i))))
        m.write_bytes(encode_png(_uint8(_grad_image(i + 5))))
        flags.append(f)
        matches.append(m)
    mine = flagged_pair_gallery(flags, matches, [0.7, 0.9, 0.8], tmp_path / "port", thumb=16)
    theirs = j_gallery(flags, matches, [0.7, 0.9, 0.8], tmp_path / "jax", thumb=16)
    assert [p.name for p in mine] == [p.name for p in theirs] == ["gallery_rank0_2.png"]
    page = read_png(mine[0])
    assert page.shape == (3 * 16 + 2 * 2, 2 * 16 + 2, 3)
    with Image.open(theirs[0]) as jpage:
        # thumbnails at their size: no resampling, the same pixels
        np.testing.assert_array_equal(page, np.asarray(jpage.convert("RGB")))
    with pytest.raises(ValueError, match="aligned"):
        flagged_pair_gallery(flags, matches[:2], [0.1, 0.2, 0.3], tmp_path / "bad")
    with pytest.raises(ValueError, match="no flagged"):
        flagged_pair_gallery([], [], [], tmp_path / "empty")


def test_prometheus_text_renders_like_jax():
    from dcr_tpu.core import tracing as JT

    mine, theirs = tracing.TelemetryRegistry(), JT.TelemetryRegistry()
    for reg in (mine, theirs):
        reg.counter("faults/x").inc(2)
        reg.counter("copy_risk/scored_total").inc(3)
        reg.gauge("serve/queue_depth").set(1.5)
        reg.gauge("odd name").set(float("inf"))
        for v in (0.1, 0.2, 0.9):
            reg.histogram("copy_risk/sim").observe(v)
    assert mine.prometheus_text() == theirs.prometheus_text()
    assert mine.snapshot() == theirs.snapshot()
    assert "dcr_faults_total 2" in mine.prometheus_text()
    assert "dcr_odd_name +Inf" in mine.prometheus_text()
