"""The eval's complexity stage in the port (``dcr_tpu_torch/eval/complexity``)
against the JAX package's, function by function, and ``run_eval`` with the
JAX defaults (the complexity stage on) against the JAX ``run_eval``.

The JPEG sizes come from the port's encoder, byte-equal to the JAX
package's libjpeg sizes (``tests/test_torch_jpeg.py``), so every function
is held at 1e-12 and the ``corr_*`` / ``mean_*`` scalars of ``run_eval`` at
1e-6. The run_eval folders are written at the eval transform's resize size
(37 px shorter side for ``image_size=32``): neither package resamples the
values images, the port decodes the JPEG values to PIL's pixels, so the
matches, their pixels and their sizes are the same. The other scalars
follow ``tests/test_torch_eval_runner.py``: the SSCD statistics within
1e-4; FID, precision/recall and the CLIP scores resize (299 px, 224 px)
with the port's bilinear against PIL's, within one uint8 level, and are
held at 1e-3 relative to their scale (FID: 1e-3 of the value plus 1e-3).
"""

from __future__ import annotations

import io
import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
from PIL import Image  # noqa: E402

from dcr_tpu.core.config import EvalConfig as JaxEvalConfig  # noqa: E402
from dcr_tpu.data.tokenizer import HashTokenizer as JaxHashTokenizer  # noqa: E402
from dcr_tpu.eval import complexity as JCX  # noqa: E402
from dcr_tpu.eval.runner import run_eval as jax_run_eval  # noqa: E402
from dcr_tpu.models import clip_image as JCLIP  # noqa: E402
from dcr_tpu.models.inception import InceptionV3FID as JaxInception  # noqa: E402
from dcr_tpu.models.resnet import SSCDModel as JaxSSCD  # noqa: E402
from dcr_tpu.models.vgg import VGG16Features as JaxVGG  # noqa: E402
from dcr_tpu_torch.core import config as TC  # noqa: E402
from dcr_tpu_torch.data.tokenizer import HashTokenizer  # noqa: E402
from dcr_tpu_torch.eval import complexity as CX  # noqa: E402
from dcr_tpu_torch.eval import runner as RUN  # noqa: E402
from dcr_tpu_torch.models import clip_image as CLIP  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.sampling.png import write_png  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    # the tiny models run fastest on one intra-op thread, and the suite's
    # parallel workers share the box's cores
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


COMPLEXITY = ("corr_entropy_sim", "corr_jpegsize_sim", "corr_tv_sim", "corr_entropy_jpegsize",
              "mean_entropy", "mean_jpeg_bytes", "mean_tv")


def _images(n=6):
    rng = np.random.default_rng(3)
    out = []
    for i in range(n):
        h, w = 20 + 7 * i, 31 - 2 * i
        y, x = np.mgrid[0:h, 0:w]
        smooth = np.stack([x * 8, y * 6, (x + y) * 3], -1) % 256
        noise = rng.normal(0, 10 * i, (h, w, 3))
        out.append(np.clip(smooth + noise, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("i", range(6))
def test_each_proxy_matches_jax(i):
    img = _images()[i]
    as_float = img.astype(np.float32) / 255.0 * 2 - 1          # normalised, as the stage gets it
    for arr in (img, as_float):
        assert CX.shannon_entropy(arr) == pytest.approx(JCX.shannon_entropy(arr), abs=1e-12)
        assert CX.jpeg_size(arr) == JCX.jpeg_size(arr)
        assert CX.jpeg_size(arr, 75) == JCX.jpeg_size(arr, 75)
        assert CX.tv_loss(arr) == pytest.approx(JCX.tv_loss(arr), abs=1e-12)
        np.testing.assert_allclose(CX.complexity_triple(arr), JCX.complexity_triple(arr),
                                   atol=1e-12, rtol=0)


def test_pearson_matches_jax_including_degenerate_series():
    rng = np.random.default_rng(0)
    x, y = rng.normal(size=9), rng.normal(size=9)
    assert CX.pearson(x, y) == pytest.approx(JCX.pearson(x, y), abs=1e-12)
    for a, b in (([1.0], [2.0]), ([1, 1, 1], [1, 2, 3]), ([1, 2, 3], [4, 4, 4])):
        assert np.isnan(CX.pearson(a, b)) and np.isnan(JCX.pearson(a, b))


def test_streamed_series_and_correlations_match_jax():
    images = _images()
    indices = [3, 1, 1, 5, 0, 3, 3, 2]
    sims = np.linspace(0.2, 0.9, len(indices))
    ours = CX.streamed_series(lambda i: images[i], indices, workers=3)
    ref = JCX.streamed_series(lambda i: images[i], indices, workers=3)
    for k in ("entropy", "jpeg_bytes", "tv"):
        np.testing.assert_allclose(ours[k], ref[k], atol=1e-12, rtol=0)
    a, b = CX.correlations_from_series(ours, sims), JCX.correlations_from_series(ref, sims)
    assert list(a) == list(b) == list(COMPLEXITY)
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=1e-12), k
    empty = CX.streamed_series(lambda i: images[i], [])
    assert all(len(v) == 0 for v in empty.values())
    assert np.isnan(CX.correlations_from_series(empty, [])["mean_tv"])


def test_complexity_correlations_matches_jax():
    images = _images()
    sims = [0.1, 0.5, 0.3, 0.9, 0.2, 0.7]
    a, sa = CX.complexity_correlations(images, sims)
    b, sb = JCX.complexity_correlations(images, sims)
    for k in a:
        assert a[k] == pytest.approx(b[k], abs=1e-12), k
    for k in sa:
        np.testing.assert_allclose(sa[k], sb[k], atol=1e-12, rtol=0)


# -- run_eval with the JAX defaults -----------------------------------------

def _write_folders(root, n_gen=6, per_class=4):
    """PNG generations (37x37, prompts.txt beside them) and JPEG training
    images (37x40 / 40x37) in two class folders, all at the transform's
    resize size."""
    rng = np.random.default_rng(1)
    gen = root / "gens" / "generations"
    gen.mkdir(parents=True)
    for i in range(n_gen):
        write_png(gen / f"{i}.png", rng.integers(0, 256, (37, 37, 3), dtype=np.uint8))
    (root / "gens" / "prompts.txt").write_text("".join(f"prompt {i}\n" for i in range(3)))
    caps = {}
    for c in ("c0", "c1"):
        (root / "train" / c).mkdir(parents=True)
        for i in range(per_class):
            caps[str(root / "train" / c / f"{i}.jpg")] = [f"{c} photo {i}"]
            h, w = (37, 40) if i % 2 else (40, 37)
            y, x = np.mgrid[0:h, 0:w]
            img = np.clip(np.stack([x * 6, y * 5, (x * y) % 200], -1)
                          + rng.normal(0, 6 + 12 * i, (h, w, 3)), 0, 255).astype(np.uint8)
            buf = io.BytesIO()
            Image.fromarray(img).save(buf, "JPEG", quality=90)
            (root / "train" / c / f"{i}.jpg").write_bytes(buf.getvalue())
    (root / "caps.json").write_text(json.dumps(caps))
    return gen, root / "train"


def _he_scaled(params):
    return jax.tree_util.tree_map_with_path(
        lambda path, x: np.asarray(x) * (np.sqrt(2.0) if path[-1].key == "kernel" else 1.0),
        params)


@pytest.fixture(scope="module")
def both_runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("complexity_parity")
    gen, train = _write_folders(tmp)
    sscd = _he_scaled(JaxSSCD().init(jax.random.key(0), jnp.zeros((1, 32, 32, 3)))["params"])
    inception = JaxInception().init(jax.random.key(1), jnp.zeros((1, 299, 299, 3)))["params"]
    vgg = JaxVGG().init(jax.random.key(2), jnp.zeros((1, 224, 224, 3)))["params"]
    clip = JCLIP.init_clip_scorer(jax.random.key(7), JCLIP.make_clip_scorer())
    # every stage of EvalConfig()'s defaults on; only the folders and the sizes differ
    common = dict(query_dir=str(gen), values_dir=str(train), image_size=32, batch_size=8,
                  gallery_max_rank=4)
    caps = str(tmp / "caps.json")
    ref = jax_run_eval(JaxEvalConfig(output_dir=str(tmp / "jax"), **common),
                       backbone_params=sscd, inception_params=inception, vgg_params=vgg,
                       tokenizer=JaxHashTokenizer(1000, 77), values_caption_json=caps)
    scorer = CLIP.make_clip_scorer()
    scorer.load_state_dict(EX.clip_scorer_from_flax(jax.tree_util.tree_map(np.asarray, clip)))
    mp = pytest.MonkeyPatch()
    mp.setattr(RUN, "make_clip_scorer", lambda seed=7: scorer)   # the JAX scorer's key-7 weights
    try:
        ours = RUN.run_eval(TC.EvalConfig(output_dir=str(tmp / "port"), **common), device="cpu",
                            backbone_state_dict=EX.sscd_from_flax(sscd),
                            inception_state_dict=EX.inception_from_flax(
                                jax.tree_util.tree_map(np.asarray, inception)),
                            vgg_state_dict=EX.vgg16_from_flax(jax.tree_util.tree_map(np.asarray, vgg)),
                            tokenizer=HashTokenizer(1000, 77), values_caption_json=caps)
    finally:
        mp.undo()
    return tmp, ref, ours


def test_defaults_run_the_complexity_stage():
    cfg = TC.EvalConfig()
    assert cfg.compute_complexity and cfg.compute_fid and cfg.compute_clip_score
    TC.validate_eval_config(cfg)                     # no NotPortedError any more


def test_run_eval_defaults_match_jax(both_runs):
    tmp, ref, ours = both_runs
    assert list(ours) == list(ref)
    for name in COMPLEXITY:
        assert ours[name] == pytest.approx(ref[name], abs=1e-6, nan_ok=True), name
    for name in ("sim_mean", "sim_std", "sim_75pc", "sim_90pc", "sim_95pc", "sim_gt_05pc",
                 "bg_mean", "bg_std"):
        assert abs(ours[name] - ref[name]) <= 1e-4, (name, ours[name], ref[name])
    for name in ("precision", "recall", "gen_clipscore", "train_clipscore"):
        assert abs(ours[name] - ref[name]) <= 1e-3, (name, ours[name], ref[name])
    assert abs(ours["FID_val"] - ref["FID_val"]) <= 1e-3 * abs(ref["FID_val"]) + 1e-3
    sim_ours = np.load(tmp / "port" / "similarity.npy")
    sim_ref = np.load(tmp / "jax" / "similarity.npy")
    np.testing.assert_array_equal(sim_ours.argmax(1), sim_ref.argmax(1))   # the same matches
    for name in ("scatter_entropy.png", "scatter_jpegsize.png", "scatter_tv.png"):
        assert (tmp / "port" / name).exists() == (tmp / "jax" / name).exists(), name


def test_cli_runs_the_defaults_on_cpu(tmp_path, monkeypatch):
    from dcr_tpu_torch.cli import evaluate as eval_cli

    gen, train = _write_folders(tmp_path, n_gen=3, per_class=2)
    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    scalars = eval_cli.main([f"--query_dir={gen}", f"--values_dir={train}", "--image_size=32",
                             "--batch_size=4", "--compute_fid=false",
                             "--compute_clip_score=false", "--gallery_max_rank=2",
                             f"--output_dir={tmp_path / 'out'}"])
    for name in COMPLEXITY:
        assert name in scalars
    assert np.isfinite(scalars["mean_jpeg_bytes"]) and scalars["mean_jpeg_bytes"] > 0
