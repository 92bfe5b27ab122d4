"""The port's eval image folder and feature extraction against the JAX
package's (PIL) on the CPU: folder order, captions, pixels.

Pixels: exact where no resize happens (images written at the transform's
resize size, and crop=False at the target size); within one uint8 level
(1/255 before normalisation) where the port's bilinear resize stands in for
PIL's BILINEAR, crop=False's squash included. The multiscale extractor is
held at 1e-6 on a pixel-statistics forward, which sees its resizes.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from dcr_tpu.eval import features as JF  # noqa: E402
from dcr_tpu.parallel import mesh as pmesh  # noqa: E402
from dcr_tpu_torch.core.config import NotPortedError  # noqa: E402
from dcr_tpu_torch.eval import features as F  # noqa: E402
from dcr_tpu_torch.sampling.png import write_png  # noqa: E402

LEVEL = 1.0 / 255.0


def _png(path, shape, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    write_png(path, np.random.default_rng(seed).integers(0, 256, shape, dtype=np.uint8))


def test_constants_match_jax():
    assert F.HALF_NORM == JF.HALF_NORM and F.IMAGENET_NORM == JF.IMAGENET_NORM
    for size in (16, 32, 64, 224, 299):
        assert F.reference_resize_for(size) == JF.reference_resize_for(size)


def test_natural_order_and_prompts_beside_the_folder(tmp_path):
    gen = tmp_path / "run" / "generations"
    for i, name in enumerate(["10.png", "2.png", "1.png", "gen_3.png"]):
        _png(gen / name, (8, 8, 3), i)
    (tmp_path / "run" / "prompts.txt").write_text("a\nb\n")
    ours, ref = F.EvalImageFolder(gen, 8), JF.EvalImageFolder(gen, 8)
    assert [p.name for p in ours.paths] == [p.name for p in ref.paths]
    assert [p.name for p in ours.paths] == ["1.png", "2.png", "10.png", "gen_3.png"]
    assert ours.captions == ref.captions == ["a", "a", "b", "b"]
    (gen / "prompts.txt").write_text("x\ny\nz\nw\n")   # one in the folder wins
    assert F.EvalImageFolder(gen, 8).captions == JF.EvalImageFolder(gen, 8).captions


def test_class_tree_and_caption_json_aliases(tmp_path, caplog):
    for c in ("b", "a"):
        for i in range(3):
            _png(tmp_path / "train" / c / f"im{i}.png", (8, 8, 3), i)
    _png(tmp_path / "train" / "a" / "unlisted.png", (8, 8, 3), 9)
    table = {f"./elsewhere/im{i}.png": [f"cap {i}"] for i in range(2)}
    table[str(tmp_path / "train" / "b" / "im2.png")] = ["absolute"]
    (tmp_path / "caps.json").write_text(json.dumps(table))
    ours = F.EvalImageFolder(tmp_path / "train", 8, caption_json=tmp_path / "caps.json")
    ref = JF.EvalImageFolder(tmp_path / "train", 8, caption_json=tmp_path / "caps.json")
    assert [str(p) for p in ours.paths] == [str(p) for p in ref.paths]
    assert ours.captions == ref.captions
    assert "" in ours.captions and "absolute" in ours.captions
    assert any("matched only" in r.message for r in caplog.records)


@pytest.mark.parametrize("shape,image_size,resize_to,crop,exact", [
    ((37, 37, 3), 32, 37, True, True),       # at resize_to: no resample
    ((37, 52, 3), 32, 37, True, True),       # shorter side at resize_to
    ((64, 48, 3), 32, 37, True, False),      # downscale
    ((20, 30, 3), 32, 37, True, False),      # upscale
    ((40, 40, 3), 40, None, False, True),    # crop=False at the target size
    ((64, 40, 3), 32, None, False, False),   # crop=False squash
])
@pytest.mark.parametrize("normalize", [None, F.HALF_NORM])
def test_pixels_match_jax(tmp_path, shape, image_size, resize_to, crop, exact, normalize):
    for i in range(3):
        _png(tmp_path / f"{i}.png", shape, 10 + i)
    kw = dict(resize_to=resize_to, crop=crop, normalize=normalize)
    ours = F.EvalImageFolder(tmp_path, image_size, **kw)
    ref = JF.EvalImageFolder(tmp_path, image_size, **kw)
    scale = 1.0 if normalize is None else 2.0       # HALF_NORM divides by 0.5
    for i in range(3):
        a, b = ours.load(i), ref.load(i)
        assert a.shape == b.shape == (image_size, image_size, 3) and a.dtype == np.float32
        if exact:
            np.testing.assert_array_equal(a, b)
        else:
            assert np.abs(a - b).max() <= scale * LEVEL + 1e-6


def test_batches_pad_only_when_asked(tmp_path):
    for i in range(5):
        _png(tmp_path / f"{i}.png", (8, 8, 3), i)
    folder = F.EvalImageFolder(tmp_path, 8)
    assert [len(m) for _, m in folder.batches(2)] == [2, 2, 1]
    imgs, mask = list(folder.batches(2, pad_to=2))[-1]
    assert imgs.shape[0] == 2 and mask.tolist() == [True, False]
    np.testing.assert_array_equal(imgs[1], imgs[0])


def test_non_png_is_refused(tmp_path):
    _png(tmp_path / "a.png", (8, 8, 3), 0)
    (tmp_path / "b.jpg").write_bytes(b"\xff\xd8\xff")
    folder = F.EvalImageFolder(tmp_path, 8)
    with pytest.raises(NotPortedError, match="PNG"):
        folder.load(1)


@pytest.mark.parametrize("multiscale", [False, True])
def test_extractor_and_extract_features_match_jax(tmp_path, multiscale, cpu_devices):
    for i in range(10):
        _png(tmp_path / f"{i}.png", (32, 32, 3), 20 + i)
    folder = F.EvalImageFolder(tmp_path, 32, normalize=F.HALF_NORM)

    def jax_fn(p, x):            # NHWC: per-channel mean, mean square and max
        return jnp.concatenate([x.mean((1, 2)), (x ** 2).mean((1, 2)), x.max((1, 2))], -1) * p

    def torch_fn(x):             # NCHW
        return torch.cat([x.mean((2, 3)), (x ** 2).mean((2, 3)), x.amax((2, 3))], -1) * 2.0

    mesh = pmesh.make_mesh()
    ref = JF.extract_features(JF.EvalImageFolder(tmp_path, 32, normalize=F.HALF_NORM),
                              JF.make_extractor(jax_fn, jnp.float32(2.0), mesh,
                                                multiscale=multiscale), batch_size=8)
    ours = F.extract_features(folder, F.make_extractor(torch_fn, "cpu", multiscale=multiscale),
                              batch_size=4)
    assert ours.shape == ref.shape == (10, 9)
    np.testing.assert_allclose(ours, ref, atol=1e-6, rtol=1e-6)
