"""The port's similarity statistics, FID and precision/recall against the
JAX package's, on numpy-seeded features, on the CPU.

Every blocked function runs with ``block_size`` smaller than N, so the
blocks' seams (and the background's self mask by global row index) are
exercised. Bounds: similarity matrices and distances within 1e-6 (f32
products of unit vectors, summation order aside); scalars within 1e-6;
indices exact (the features are continuous random draws, so their values
are distinct).
"""

from __future__ import annotations

import numpy as np
import pytest

jax = pytest.importorskip("jax")

from dcr_tpu.eval import fid as JFID  # noqa: E402
from dcr_tpu.eval import ipr as JIPR  # noqa: E402
from dcr_tpu.eval import similarity as JSIM  # noqa: E402
from dcr_tpu_torch.eval import fid as FID  # noqa: E402
from dcr_tpu_torch.eval import ipr as IPR  # noqa: E402
from dcr_tpu_torch.eval import similarity as SIM  # noqa: E402


def _feats(seed, n, d=32):
    x = np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)
    return SIM.l2_normalize(x)


def test_l2_normalize_matches_jax():
    x = np.random.default_rng(0).standard_normal((5, 7)).astype(np.float32)
    x[2] = 0.0
    np.testing.assert_array_equal(SIM.l2_normalize(x), JSIM.l2_normalize(x))


@pytest.mark.parametrize("metric,chunks,style", [
    ("dotproduct", 1, "max"),
    ("splitloss", 4, "max"),
    ("splitloss", 4, "mean"),
    ("splitloss", 4, "cross"),
])
def test_similarity_matrix_matches_jax(metric, chunks, style):
    values, query = _feats(1, 23), _feats(2, 19)
    ref = JSIM.similarity_matrix(values, query, metric=metric, num_chunks=chunks,
                                 chunk_style=style, block_size=5)
    ours = SIM.similarity_matrix(values, query, metric=metric, num_chunks=chunks,
                                 chunk_style=style, block_size=5, device="cpu")
    assert ours.shape == ref.shape == (19, 23)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)


def test_similarity_matrix_refuses_what_jax_refuses():
    values, query = _feats(1, 4, 10), _feats(2, 3, 10)
    with pytest.raises(ValueError, match="divisible"):
        SIM.similarity_matrix(values, query, metric="splitloss", num_chunks=3, device="cpu")
    with pytest.raises(ValueError, match="metric"):
        SIM.similarity_matrix(values, query, metric="cosine", device="cpu")


def test_gen_train_stats_and_scalars_match_jax():
    sim = SIM.similarity_matrix(_feats(3, 40), _feats(4, 31), block_size=7, device="cpu")
    ours, ref = SIM.gen_train_stats(sim, 0.2), JSIM.gen_train_stats(sim, 0.2)
    so, sr = ours.scalars(), ref.scalars()
    assert list(so) == list(sr)
    for k in sr:
        assert abs(so[k] - sr[k]) <= 1e-6, k
    np.testing.assert_array_equal(ours.top1_index, ref.top1_index)
    np.testing.assert_array_equal(ours.top1, ref.top1)
    assert list(ours.scalars("bg")) == list(ref.scalars("bg"))


def test_background_masks_self_by_global_row():
    values = _feats(5, 21)
    values[13] = values[2]             # one exact duplicate pair across blocks
    ref = JSIM.train_train_background(values, block_size=4)
    ours = SIM.train_train_background(values, block_size=4, device="cpu")
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=0)
    # self is masked, the duplicate is not: both rows see similarity 1
    assert ours[2] == pytest.approx(1.0, abs=1e-6) and ours[13] == pytest.approx(1.0, abs=1e-6)
    brute = values @ values.T
    np.fill_diagonal(brute, -np.inf)
    np.testing.assert_allclose(ours, brute.max(axis=1), atol=1e-6, rtol=0)
    so, sr = SIM.background_stats(ours), JSIM.background_stats(ref)
    assert list(so) == list(sr) and all(abs(so[k] - sr[k]) <= 1e-6 for k in sr)


def test_topk_and_dup_split_match_jax():
    sim = SIM.similarity_matrix(_feats(6, 12), _feats(7, 9), block_size=4, device="cpu")
    vals, idx = SIM.topk_matches(sim, 3)
    rvals, ridx = JSIM.topk_matches(sim, 3)
    np.testing.assert_array_equal(idx, ridx)
    np.testing.assert_array_equal(vals, rvals)
    stats = SIM.gen_train_stats(sim)
    weights = np.array([5, 1, 1, 5, 1, 1, 1, 5, 1, 1, 1, 1])
    ours = SIM.dup_vs_nondup_means(stats.top1, stats.top1_index, weights)
    ref = JSIM.dup_vs_nondup_means(stats.top1, stats.top1_index, weights)
    assert ours.keys() == ref.keys()
    for k in ref:
        assert (np.isnan(ours[k]) and np.isnan(ref[k])) or abs(ours[k] - ref[k]) <= 1e-6


def test_fid_matches_jax_and_caches(tmp_path):
    rng = np.random.default_rng(8)
    a = rng.standard_normal((60, 8)).astype(np.float32)
    b = (rng.standard_normal((50, 8)) * 1.3 + 0.2).astype(np.float32)
    ours = FID.fid_from_features(a, b, cache1=tmp_path / "a.npz")
    ref = JFID.fid_from_features(a, b)
    assert abs(ours - ref) <= 1e-6 * max(1.0, abs(ref))
    # a cached statistics file is read instead of the features
    again = FID.fid_from_features(np.zeros_like(a), b, cache1=tmp_path / "a.npz")
    assert again == ours
    assert FID.fid_from_features(a, a) == pytest.approx(0.0, abs=1e-6)


def test_pairwise_distances_and_precision_recall_match_jax(tmp_path):
    rng = np.random.default_rng(9)
    real = rng.standard_normal((30, 16)).astype(np.float32)
    fake = (rng.standard_normal((25, 16)) * 1.2 + 0.3).astype(np.float32)
    ours = IPR.pairwise_distances_squared(fake, real, block_size=7, device="cpu")
    ref = JIPR.pairwise_distances_squared(fake, real, block_size=7)
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=1e-6)
    np.testing.assert_allclose(IPR.knn_radii(real, 3, device="cpu"), JIPR.knn_radii(real, 3),
                               rtol=1e-6, atol=1e-6)
    pr = IPR.precision_recall(real, fake, real_cache=tmp_path / "real.npz", device="cpu")
    assert pr == JIPR.precision_recall(real, fake)
    assert (tmp_path / "real.npz").exists()
    m = IPR.Manifold.build(real, 3, device="cpu")
    np.testing.assert_allclose(m.realism(fake), JIPR.Manifold.build(real, 3).realism(fake),
                               rtol=1e-5)
