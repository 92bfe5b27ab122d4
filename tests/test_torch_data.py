"""PyTorch port: the training data path against the JAX package.

Duplication weights (and their pickle), sampling plans and captions for
every regime must be bit-identical to dcr_tpu.data's: they are host-side
numpy draws from the same streams. The port decodes PNG itself (the card's
machine has no PIL): its pixels must equal PIL's. Its resize is torch's
antialiased bilinear, held within 2/255 of PIL's BILINEAR (in [0, 1]
units); an image already at the target size is not resampled and must be
exact. Loader batches (index order, input_ids, pixels) must be equal.
"""

from __future__ import annotations

import dataclasses
import io
import json
import pickle
import zlib

import numpy as np
import pytest
from PIL import Image

from dcr_tpu.core.config import CONDITIONING_REGIMES, TRAIN_MITIGATIONS, DataConfig
from dcr_tpu.data import captions as JC
from dcr_tpu.data import dataset as JDS
from dcr_tpu.data import duplication as JD
from dcr_tpu.data import loader as JL
from dcr_tpu.data.tokenizer import HashTokenizer as JHash
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core.rng import host_python_rng
from dcr_tpu_torch.data import captions as TCap
from dcr_tpu_torch.data import dataset as TDS
from dcr_tpu_torch.data import duplication as TD
from dcr_tpu_torch.data import loader as TL
from dcr_tpu_torch.data.tokenizer import HashTokenizer as THash
from dcr_tpu_torch.sampling import png as TPNG

SIZE = 16


def _folder(root, sizes=((16, 16), (20, 24), (30, 17)), per_class=4, classes=2):
    """class-folder of PNGs (seeded noise), sizes cycling per image."""
    rng = np.random.default_rng(0)
    captions = {}
    n = 0
    for c in range(classes):
        d = root / f"c{c}"
        d.mkdir(parents=True)
        for i in range(per_class):
            h, w = sizes[n % len(sizes)]
            p = d / f"{i}.png"
            Image.fromarray(rng.integers(0, 256, (h, w, 3), dtype=np.uint8)).save(p)
            captions[str(p)] = [f"a photo number {n} of thing {c}",
                                f"another view {n} of item {c}"]
            n += 1
    return captions


def _cfgs(root, **kw):
    j = DataConfig(train_data_dir=str(root), resolution=SIZE, seed=3, **kw)
    return j, TC.from_dict(TC.DataConfig, dataclasses.asdict(j))


# -- duplication ------------------------------------------------------------

@pytest.mark.parametrize("n,pc,w,seed", [(10, 0.1, 5, 42), (37, 0.3, 3, 7), (5, 0.0, 5, 1)])
def test_duplication_weights_and_plans_identical(tmp_path, n, pc, w, seed):
    np.testing.assert_array_equal(TD.make_sampling_weights(n, pc, w, seed),
                                  JD.make_sampling_weights(n, pc, w, seed))
    weights = TD.make_sampling_weights(n, pc, w, seed)
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(TD.weighted_sample_indices(weights, n, seed, epoch),
                                      JD.weighted_sample_indices(weights, n, seed, epoch))
        np.testing.assert_array_equal(TD.shuffled_indices(n, seed, epoch),
                                      JD.shuffled_indices(n, seed, epoch))


def test_weights_pickle_is_shared_both_ways(tmp_path):
    a, b = tmp_path / "a", tmp_path / "b"
    a.mkdir(), b.mkdir()
    assert TD.weights_cache_path(a, 0.2, 4, 9).name == JD.weights_cache_path(a, 0.2, 4, 9).name
    # written by the port, read by the JAX package, and the reverse
    wt = TD.load_or_create_weights(a, 20, 0.2, 4, 9)
    np.testing.assert_array_equal(JD.load_or_create_weights(a, 20, 0.2, 4, 9), wt)
    wj = JD.load_or_create_weights(b, 20, 0.2, 4, 9)
    np.testing.assert_array_equal(TD.load_or_create_weights(b, 20, 0.2, 4, 9), wj)
    with open(TD.weights_cache_path(a, 0.2, 4, 9), "rb") as f:
        assert isinstance(pickle.load(f), list)


# -- captions ---------------------------------------------------------------

@pytest.mark.parametrize("class_prompt", CONDITIONING_REGIMES)
@pytest.mark.parametrize("duplication", ["nodup", "dup_image"])
def test_captions_identical_for_every_regime(class_prompt, duplication):
    prompts = {"p.png": ["first caption here", "second caption words", "third one"]}
    if class_prompt == "instancelevel_random":
        prompts = {"p.png": ["[11, 22, 33, 44]", "[5, 6]"]}
    for trainspecial in (TRAIN_MITIGATIONS if class_prompt == "instancelevel_blip"
                         else ("none",)):
        kw = dict(class_prompt=class_prompt, duplication=duplication,
                  instance_prompt="An image", trainspecial=trainspecial,
                  trainspecial_prob=0.5)
        jspec, tspec = JC.CaptionSpec(**kw), TCap.CaptionSpec(**kw)
        for i in range(12):
            args = dict(path="p.png", label=1, classnames=["dog", "cat"], prompts=prompts,
                        sampling_weight=5.0 if i % 2 else 1.0)
            want = JC.assign_caption(jspec, tokenizer=JHash(49408, 16),
                                     rng=host_python_rng(0, f"cap{i}"), **args)
            got = TCap.assign_caption(tspec, tokenizer=THash(49408, 16),
                                      rng=host_python_rng(0, f"cap{i}"), **args)
            assert got == want, (trainspecial, i)


def test_classnames_identical():
    assert TCap.get_classnames("/data/imagenette2") == JC.get_classnames("/data/imagenette2")


# -- PNG decode -------------------------------------------------------------

@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("optimize", [False, True])
def test_png_decode_equals_pil(tmp_path, mode, optimize):
    rng = np.random.default_rng(1)
    chans = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
    # smooth ramps plus noise, so PIL's adaptive filtering picks several of
    # the five row filters
    ramp = np.add.outer(np.arange(23), np.arange(31)).astype(np.int64)
    arr = ((ramp[..., None] * (1 + np.arange(chans)) + rng.integers(0, 9, (23, 31, chans)))
           % 256).astype(np.uint8)
    img = Image.fromarray(arr[..., 0] if chans == 1 else arr, mode)
    buf = io.BytesIO()
    img.save(buf, format="PNG", optimize=optimize)
    got = TPNG.decode_png(buf.getvalue())
    want = np.asarray(Image.open(io.BytesIO(buf.getvalue())).convert("RGB"))
    np.testing.assert_array_equal(got, want)


def test_png_decode_refuses_what_it_does_not_read(tmp_path):
    img = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    # an Adam7-interlaced header (PIL does not write interlaced PNGs)
    data = bytearray(TPNG.encode_png(np.zeros((8, 8, 3), np.uint8)))
    data[28] = 1
    data[29:33] = zlib.crc32(bytes(data[12:29])).to_bytes(4, "big")
    with pytest.raises(TPNG.PNGFormatError, match="interlace 1"):
        TPNG.decode_png(bytes(data))
    buf = io.BytesIO()
    Image.fromarray(np.zeros((8, 8), np.uint16)).save(buf, format="PNG")
    with pytest.raises(TPNG.PNGFormatError):
        TPNG.decode_png(buf.getvalue())
    with pytest.raises(TPNG.PNGFormatError):
        TPNG.decode_png(b"GIF89a")
    bmp = tmp_path / "x.bmp"       # JPEG is read since the codec came (test_torch_jpeg.py)
    img.save(bmp)
    with pytest.raises(TC.NotPortedError, match="x.bmp"):
        TDS.load_and_transform(str(bmp), 8, center_crop=True, random_flip=False,
                               rng=host_python_rng(0, "x"))


# -- transform, dataset, loader --------------------------------------------

@pytest.mark.parametrize("center_crop,random_flip", [(True, False), (False, True)])
def test_load_and_transform_close_to_jax(tmp_path, center_crop, random_flip):
    _folder(tmp_path)
    for p in sorted(tmp_path.rglob("*.png")):
        kw = dict(center_crop=center_crop, random_flip=random_flip)
        want = JDS.load_and_transform(str(p), SIZE, rng=host_python_rng(0, p.name), **kw)
        got = TDS.load_and_transform(str(p), SIZE, rng=host_python_rng(0, p.name), **kw)
        assert got.shape == want.shape == (SIZE, SIZE, 3) and got.dtype == np.float32
        if Image.open(p).size == (SIZE, SIZE):
            np.testing.assert_array_equal(got, want)      # not resampled
        else:
            # [-1, 1] values: 2/255 in [0, 1] units is 4/255 here
            np.testing.assert_allclose(got, want, atol=4 / 255 + 1e-6, rtol=0)


@pytest.mark.parametrize("regime", [
    dict(class_prompt="classlevel"),
    dict(class_prompt="instancelevel_blip", duplication="dup_image", weight_pc=0.5),
    dict(class_prompt="instancelevel_blip", trainspecial="wordrepeat", trainspecial_prob=0.5),
    dict(class_prompt="instancelevel_random", duplication="dup_both", weight_pc=0.3),
])
def test_dataset_examples_identical(tmp_path, regime):
    caps = _folder(tmp_path / "data", sizes=((16, 16),))
    if regime["class_prompt"] == "instancelevel_random":     # token-id lists
        caps = {p: [f"[{5 + i}, 17, 23]", "[7, 8]"] for i, p in enumerate(caps)}
    capfile = tmp_path / "caps.json"
    capfile.write_text(json.dumps(caps))
    jcfg, tcfg = _cfgs(tmp_path / "data", caption_jsons=(str(capfile),), **regime)
    jds = JDS.ObjectAttributeDataset(jcfg, JHash(49408, 16))
    tds = TDS.ObjectAttributeDataset(tcfg, THash(49408, 16))
    np.testing.assert_array_equal(TL.sampling_plan(tds, epoch=1, seed=3),
                                  JL.sampling_plan(jds, epoch=1, seed=3))
    for pos in range(len(jds)):
        want, got = jds.get(pos, epoch=2, slot=pos + 1), tds.get(pos, epoch=2, slot=pos + 1)
        assert got.caption == want.caption and got.index == want.index
        np.testing.assert_array_equal(got.input_ids, want.input_ids)
        np.testing.assert_array_equal(got.pixel_values, want.pixel_values)


def test_loader_batches_identical(tmp_path):
    _folder(tmp_path / "data", sizes=((16, 16),), per_class=5)
    jcfg, tcfg = _cfgs(tmp_path / "data", class_prompt="classlevel", center_crop=False,
                       random_flip=True, duplication="dup_both", weight_pc=0.4)
    jl = JL.DataLoader(JDS.ObjectAttributeDataset(jcfg, JHash(49408, 16)), batch_size=3,
                       num_workers=2, seed=3)
    tl = TL.DataLoader(TDS.ObjectAttributeDataset(tcfg, THash(49408, 16)), batch_size=3,
                       num_workers=3, seed=3)
    assert tl.steps_per_epoch() == jl.steps_per_epoch() == 3
    for epoch, start in ((0, 0), (1, 1)):
        jb, tb = list(jl.epoch(epoch, start)), list(tl.epoch(epoch, start))
        assert len(tb) == len(jb) == 3 - start
        for want, got in zip(jb, tb):
            assert set(got) == {"pixel_values", "input_ids", "index"}
            for k in got:
                np.testing.assert_array_equal(got[k], want[k])


def test_loader_fails_fast_on_a_bad_sample(tmp_path):
    _folder(tmp_path / "data", sizes=((16, 16),))
    (tmp_path / "data" / "c0" / "0.png").write_bytes(b"not a png")
    _, tcfg = _cfgs(tmp_path / "data")
    loader = TL.DataLoader(TDS.ObjectAttributeDataset(tcfg, THash(100, 16)), batch_size=8,
                           num_workers=2, seed=0)
    # the default budget 0: the error reaches the consumer after the
    # dataset's retry, as the JAX loader's SampleDecodeError does
    with pytest.raises(TDS.SampleDecodeError) as err:
        list(loader.epoch(0))
    assert isinstance(err.value.cause, TPNG.PNGFormatError)
