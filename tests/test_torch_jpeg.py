"""The port's JPEG codec (``dcr_tpu_torch/native``) against PIL and the JAX
package's libjpeg helpers, and the JPEG paths of training and eval.

Bounds, each in uint8 levels unless said otherwise:
- full-scale decode against PIL: max |diff| <= 1 (expect 0: the decoder
  follows libjpeg-turbo's islow IDCT, fancy upsampling and colour tables);
- scaled decode against ``dcr_tpu.native.jpeg_decoder.decode_scaled`` at
  every scale M/8 the rule picks: the same shape, max <= 2, mean <= 0.1
  (expect 0);
- encoder against the JAX ``complexity.jpeg_size`` at quality 95 and 75:
  within 0.5 % (expect byte-equal); PIL's decode of the port's bytes within
  1 level of PIL's decode of its own file;
- training pixels (``load_and_transform``) against the JAX loader: the
  scaled-decode bound plus the resize bound (1 level), 3 levels, that is
  6/255 in [-1, 1] units; eval pixels (``EvalImageFolder``, full-scale
  decode) 2 levels, in the same units.
The committed fixtures (``tests/fixtures/jpeg``) let the card check the
codec without PIL: PIL writes small JPEGs of the variants the decoder
reads (and a CMYK one it refuses) with PIL's decoded pixels beside each as
a PNG; PIL cannot write 4:4:0, so OpenCV (libjpeg-turbo as well) writes
that one. ``manifest.json`` also lists PIL's sizes for a few inputs
(committed as PNGs) and PIL's decode of its own file of each. A test here
rebuilds them and checks them; to rewrite them:

    python -m tests.test_torch_jpeg
"""

from __future__ import annotations

import io
import json
from pathlib import Path

import numpy as np
import pytest
from PIL import Image, ImageFile

from dcr_tpu.data import dataset as JDS
from dcr_tpu.data import loader as JL
from dcr_tpu.data.tokenizer import HashTokenizer as JHash
from dcr_tpu.eval import complexity as JCX
from dcr_tpu.eval import features as JF
from dcr_tpu.native import jpeg_decoder as jax_jpeg
from dcr_tpu_torch.core import config as TC
from dcr_tpu_torch.core.rng import host_python_rng
from dcr_tpu_torch.data import dataset as TDS
from dcr_tpu_torch.data import loader as TL
from dcr_tpu_torch.data.tokenizer import HashTokenizer as THash
from dcr_tpu_torch.eval import features as TF
from dcr_tpu_torch.native import jpeg_decoder as D
from dcr_tpu_torch.native import jpeg_helper as H
from dcr_tpu_torch.sampling.png import read_png

ImageFile.MAXBLOCK = 1 << 22     # progressive saves to memory need the room
LEVEL = 1.0 / 255.0

# -- the committed fixtures and how they are made ---------------------------

FIXTURES = Path(__file__).parent / "fixtures" / "jpeg"

# name -> (height, width, PIL save options); "mode" "L" writes grayscale
VARIANTS = {
    "baseline_444_q95.jpg": (17, 23, dict(quality=95, subsampling=0)),
    "baseline_422_q75.jpg": (20, 33, dict(quality=75, subsampling=1)),
    "baseline_420_q50.jpg": (25, 31, dict(quality=50, subsampling=2)),
    "gray_q75.jpg": (19, 26, dict(quality=75, mode="L")),
    "progressive_420_q90.jpg": (24, 40, dict(quality=90, subsampling=2, progressive=True)),
    "progressive_444_q75.jpg": (13, 21, dict(quality=75, subsampling=0, progressive=True)),
    "restart_420_q90.jpg": (32, 40, dict(quality=90, subsampling=2, restart_marker_blocks=2)),
    "adobe_rgb_q90.jpg": (18, 22, dict(quality=90, keep_rgb=True)),
}
OPENCV_440 = ("sampling_440_q90.jpg", (22, 27))
REFUSED = {"cmyk.jpg": (12, 12)}
ENCODE_INPUTS = {"encode_input_0.png": (24, 40, 0), "encode_input_1.png": (33, 17, 1),
                 "encode_input_2.png": (16, 16, 2)}
QUALITIES = (95, 75)


def fixture_image(seed: int, h: int, w: int) -> np.ndarray:
    """A seeded smooth image with some noise: uint8 [h, w, 3]."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    base = np.stack([x * 255 / max(w - 1, 1), y * 255 / max(h - 1, 1),
                     128 + 100 * np.sin((x + 2 * y) / 3.0)], axis=-1)
    return np.clip(base + rng.normal(0, 12, (h, w, 3)), 0, 255).astype(np.uint8)


def build_fixtures(out_dir: Path = FIXTURES) -> None:
    """Write every fixture and manifest.json into ``out_dir``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    manifest: dict = {"decoded": {}, "refused": sorted(REFUSED), "sizes": []}

    def decoded_png(name: str, data: bytes) -> None:
        with Image.open(io.BytesIO(data)) as im:
            pix = np.asarray(im.convert("RGB"))
        png = name.replace(".jpg", ".png")
        Image.fromarray(pix).save(out_dir / png, optimize=False, compress_level=9)
        manifest["decoded"][name] = png

    for i, (name, (h, w, opts)) in enumerate(sorted(VARIANTS.items())):
        opts = dict(opts)
        img = Image.fromarray(fixture_image(10 + i, h, w))
        if opts.pop("mode", None) == "L":
            img = img.convert("L")
        buf = io.BytesIO()
        img.save(buf, "JPEG", **opts)
        (out_dir / name).write_bytes(buf.getvalue())
        decoded_png(name, buf.getvalue())
    import cv2

    name, (h, w) = OPENCV_440
    ok, enc = cv2.imencode(".jpg", fixture_image(30, h, w)[..., ::-1],
                           [cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
                            cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440])
    assert ok
    (out_dir / name).write_bytes(enc.tobytes())
    decoded_png(name, enc.tobytes())
    for name, (h, w) in REFUSED.items():
        buf = io.BytesIO()
        Image.fromarray(fixture_image(40, h, w)).convert("CMYK").save(buf, "JPEG", quality=90)
        (out_dir / name).write_bytes(buf.getvalue())
    for name, (h, w, seed) in ENCODE_INPUTS.items():
        pix = fixture_image(50 + seed, h, w)
        Image.fromarray(pix).save(out_dir / name, optimize=False, compress_level=9)
        for q in QUALITIES:
            buf = io.BytesIO()
            Image.fromarray(pix).save(buf, "JPEG", quality=q)
            decoded = name.replace(".png", f"_q{q}_decoded.png")
            with Image.open(io.BytesIO(buf.getvalue())) as im:
                Image.fromarray(np.asarray(im.convert("RGB"))).save(
                    out_dir / decoded, optimize=False, compress_level=9)
            manifest["sizes"].append({"input": name, "quality": q, "pil_bytes": buf.tell(),
                                      "pil_decoded": decoded})
    (out_dir / "manifest.json").write_text(json.dumps(manifest, indent=1, sort_keys=True) + "\n")


def _image(seed: int, h: int, w: int, kind: str = "smooth") -> np.ndarray:
    if kind == "noise":
        return np.random.default_rng(seed).integers(0, 256, (h, w, 3), dtype=np.uint8)
    return fixture_image(seed, h, w)


def _pil_jpeg(img: np.ndarray, **opts) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    return buf.getvalue()


def _pil_decode(data: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


# -- full-scale decode against PIL ------------------------------------------

CASES = [
    # (h, w, kind, save options)
    *[(48, 40, kind, dict(quality=q, subsampling=s))
      for kind in ("smooth", "noise") for q in (50, 75, 95) for s in (0, 1, 2)],
    *[(h, w, "noise", dict(quality=75, subsampling=s))
      for (h, w) in ((1, 1), (9, 17), (257, 513)) for s in (0, 1, 2)],
    *[(37, 45, "smooth", dict(quality=q, subsampling=s, progressive=True))
      for q in (75, 95) for s in (0, 1, 2)],
    (17, 9, "noise", dict(quality=95, subsampling=2, progressive=True)),
    *[(64, 72, "smooth", dict(quality=90, subsampling=s, restart_marker_blocks=r))
      for s in (0, 2) for r in (1, 3)],
    (40, 48, "smooth", dict(quality=90, subsampling=2, progressive=True,
                            restart_marker_blocks=2)),
    (3, 17, "noise", dict(quality=90, subsampling=2)),     # chroma 2 wide: no fancy
    (30, 20, "smooth", dict(quality=90, keep_rgb=True)),   # Adobe transform 0
]


@pytest.mark.parametrize("h,w,kind,opts", CASES)
def test_decode_equals_pil(h, w, kind, opts):
    data = _pil_jpeg(_image(h * 31 + w, h, w, kind), **opts)
    ours = D.decode(data)
    ref = _pil_decode(data)
    assert ours.shape == ref.shape == (h, w, 3) and ours.dtype == np.uint8
    assert np.abs(ours.astype(int) - ref).max() <= 1


@pytest.mark.parametrize("quality", [50, 75, 95])
def test_grayscale_decodes_to_replicated_rgb(quality):
    gray = _image(3, 23, 31)[..., 0]
    buf = io.BytesIO()
    Image.fromarray(gray).save(buf, "JPEG", quality=quality)
    ours = D.decode(buf.getvalue())
    assert ours.shape == (23, 31, 3)
    assert np.abs(ours.astype(int) - _pil_decode(buf.getvalue())).max() <= 1


# -- scaled decode against the JAX package's libjpeg helper -----------------

SCALED = {
    "420_500x375": (375, 500, dict(quality=90, subsampling=2)),
    "422_513x257": (257, 513, dict(quality=75, subsampling=1)),
    "444_37x100": (100, 37, dict(quality=95, subsampling=0)),
    "420_progressive": (150, 200, dict(quality=90, subsampling=2, progressive=True)),
    "gray": (64, 80, dict(quality=75)),
}


def _scaled_cases():
    cases = []
    for name, (h, w, _) in SCALED.items():
        short = min(h, w)
        for m in range(1, 9):          # a min_side that picks scale m/8
            if short * m // 8 > short * (m - 1) // 8:
                cases.append((name, m, short * m // 8))
    return cases


@pytest.fixture(scope="module")
def jax_helper():
    if not jax_jpeg.available():
        pytest.skip("the JAX package's libjpeg helper is not built here (g++ or libjpeg "
                    "missing), so there is no reference for the scaled decode")
    return jax_jpeg


@pytest.mark.parametrize("name,m,min_side", _scaled_cases())
def test_scaled_decode_matches_jax_helper(jax_helper, name, m, min_side):
    h, w, opts = SCALED[name]
    img = _image(m + len(name), h, w)
    data = _pil_jpeg(img[..., 0] if name == "gray" else img, **opts)
    ref = jax_helper.decode_scaled(data, min_side)
    ours = D.decode_scaled(data, min_side)
    assert ours.shape == ref.shape == (-(-h * m // 8), -(-w * m // 8), 3)
    diff = np.abs(ours.astype(int) - ref)
    assert diff.max() <= 2 and diff.mean() <= 0.1


def test_scaled_decode_of_440_matches_jax_helper(jax_helper):
    data = (FIXTURES / OPENCV_440[0]).read_bytes()
    short = min(OPENCV_440[1])
    for m in range(1, 9):
        ref = jax_helper.decode_scaled(data, short * m // 8)
        ours = D.decode_scaled(data, short * m // 8)
        assert ours.shape == ref.shape
        diff = np.abs(ours.astype(int) - ref)
        assert diff.max() <= 2 and diff.mean() <= 0.1, m


def test_sof_dims_matches_jax_parser():
    for h, w in ((1, 1), (375, 500), (17, 9)):
        data = _pil_jpeg(_image(1, h, w))
        assert D.sof_dims(data) == jax_jpeg._parse_sof_dims(data) == (w, h)
    assert D.sof_dims(b"\xff\xd8garbage") is None


# -- what the decoder refuses -----------------------------------------------

def _baseline() -> bytes:
    return _pil_jpeg(_image(5, 24, 24), quality=90)


def _replace_sof(data: bytes, new: bytes) -> bytes:
    assert data.count(b"\xff\xc0") == 1
    return data.replace(b"\xff\xc0", new, 1)


def _corrupt_entropy(data: bytes) -> bytes:
    i = data.index(b"\xff\xda")
    start = i + 2 + int.from_bytes(data[i + 2:i + 4], "big")
    return data[:start] + b"\xff\x00" * 40 + data[start + 80:]   # all-ones codes


def _corrupt_dht(data: bytes) -> bytes:
    i = data.index(b"\xff\xc4")
    return data[:i + 5] + b"\xff" * 16 + data[i + 21:]          # > 256 codes


@pytest.mark.parametrize("make,variant", [
    (lambda: (FIXTURES / "cmyk.jpg").read_bytes(), "4-component"),
    (lambda: _replace_sof(_baseline(), b"\xff\xc9"), "arithmetic-coded JPEG .SOF9"),
    (lambda: _replace_sof(_baseline(), b"\xff\xca"), "arithmetic-coded JPEG .SOF10"),
    (lambda: _replace_sof(_baseline(), b"\xff\xc3"), "lossless JPEG .SOF3"),
    (lambda: _baseline().replace(b"\xff\xc0\x00\x11\x08", b"\xff\xc0\x00\x11\x0c", 1),
     "12-bit samples"),
])
def test_unsupported_variants_raise_not_ported(make, variant):
    with pytest.raises(TC.NotPortedError, match=f"x.jpg: {variant}"):
        D.decode(make(), name="x.jpg")


@pytest.mark.parametrize("make,what", [
    (lambda d: d[:len(d) // 2], "truncated"),
    (lambda d: d[:-2], "truncated: no EOI"),
    (lambda d: d[:200], "truncated"),
    (lambda d: d[:3], "truncated"),
    (_corrupt_entropy, "invalid Huffman code"),
    (_corrupt_dht, "more than 256 codes"),
    (lambda d: b"GIF89a" + d, "not a JPEG"),
])
def test_truncated_or_corrupt_data_raises_value_error(make, what):
    with pytest.raises(ValueError, match=f"x.jpg: .*{what}"):
        D.decode(make(_baseline()), name="x.jpg")


# -- the committed fixtures ---------------------------------------------------

MANIFEST = json.loads((FIXTURES / "manifest.json").read_text())


@pytest.mark.parametrize("name", sorted(MANIFEST["decoded"]))
def test_committed_fixture_decodes_to_its_png(name):
    ours = D.decode((FIXTURES / name).read_bytes())
    ref = read_png(FIXTURES / MANIFEST["decoded"][name])
    assert ours.shape == ref.shape and np.abs(ours.astype(int) - ref).max() <= 1


@pytest.mark.parametrize("entry", MANIFEST["sizes"], ids=lambda e: f"{e['input']}-q{e['quality']}")
def test_encoder_size_and_round_trip_match_manifest(entry):
    data = H.encode(read_png(FIXTURES / entry["input"]), entry["quality"])
    assert abs(len(data) - entry["pil_bytes"]) <= 0.005 * entry["pil_bytes"]
    back = D.decode(data).astype(int) - read_png(FIXTURES / entry["pil_decoded"])
    assert np.abs(back).max() <= 1


def test_fixtures_regenerate_as_committed(tmp_path):
    pytest.importorskip("cv2", reason="the 4:4:0 fixture is written by OpenCV")
    build_fixtures(tmp_path)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted(p.name for p in FIXTURES.iterdir())
    assert json.loads((tmp_path / "manifest.json").read_text()) == MANIFEST
    for path in FIXTURES.iterdir():
        if path.suffix == ".jpg":
            assert (tmp_path / path.name).read_bytes() == path.read_bytes(), path.name
        elif path.suffix == ".png":
            np.testing.assert_array_equal(read_png(tmp_path / path.name), read_png(path))
    total = sum(p.stat().st_size for p in FIXTURES.iterdir())
    assert total < 100_000, total


# -- the encoder --------------------------------------------------------------

ENCODE = [(i, (224, 224), "smooth") for i in range(4)] + [
    (4, (37, 40), "noise"), (5, (17, 9), "noise"), (6, (1, 1), "noise"), (7, (300, 199), "smooth"),
    (8, (64, 63), "noise"), (9, (33, 17), "smooth"), (10, (2, 3), "smooth"),
    (11, (375, 500), "smooth"), (12, (16, 16), "noise"), (13, (15, 31), "smooth"),
    (14, (100, 7), "noise"), (15, (9, 130), "smooth"), (16, (255, 257), "noise"),
    (17, (48, 48), "smooth"), (18, (31, 33), "noise"), (19, (8, 8), "smooth")]


@pytest.mark.parametrize("quality", [95, 75])
@pytest.mark.parametrize("seed,shape,kind", ENCODE)
def test_encoded_size_within_half_percent_of_jax(seed, shape, kind, quality):
    img = _image(seed, *shape, kind)
    ours, ref = H.encoded_size(img, quality), JCX.jpeg_size(img, quality)
    assert abs(ours - ref) <= 0.005 * ref, (ours, ref)


def test_encoded_sizes_are_byte_equal_to_jax():
    """The share of the 40 sizes above that equal the JAX package's exactly
    (the port computes what libjpeg-turbo writes): all of them."""
    equal = sum(H.encoded_size(_image(s, *shape, kind), q) == JCX.jpeg_size(_image(s, *shape, kind), q)
                for s, shape, kind in ENCODE for q in (95, 75))
    assert equal == 2 * len(ENCODE), f"{equal}/{2 * len(ENCODE)} byte-equal"


@pytest.mark.parametrize("quality", [95, 75, 50])
@pytest.mark.parametrize("seed,shape,kind", ENCODE[::4])
def test_pil_decodes_the_port_encode(seed, shape, kind, quality):
    img = _image(seed, *shape, kind)
    ours = H.encode(img, quality)
    assert len(ours) == H.encoded_size(img, quality)
    theirs = _pil_decode(_pil_jpeg(img, quality=quality))
    assert np.abs(_pil_decode(ours).astype(int) - theirs).max() <= 1
    # and the port reads its own file as PIL does
    assert np.abs(D.decode(ours).astype(int) - _pil_decode(ours)).max() <= 1


def test_encoder_refuses_what_is_not_an_rgb_image():
    for bad in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 4), np.uint8),
                np.zeros((4, 4, 3), np.float32), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            H.encoded_size(bad)


# -- training and eval on JPEG folders --------------------------------------

def _jpeg_folder(root, sizes=((40, 37), (37, 52), (20, 24), (64, 48)), per_class=3):
    """two class folders of PIL-written JPEGs of several sizes and layouts."""
    n = 0
    for c in ("c0", "c1"):
        (root / c).mkdir(parents=True)
        for i in range(per_class):
            h, w = sizes[n % len(sizes)]
            data = _pil_jpeg(_image(n, h, w), quality=85, subsampling=n % 3,
                             progressive=bool(n % 2))
            (root / c / f"{i}.jpg").write_bytes(data)
            n += 1


@pytest.mark.parametrize("size,center_crop,random_flip", [
    (16, True, False), (16, False, True), (32, False, True)])
def test_training_pixels_match_jax_loader(tmp_path, size, center_crop, random_flip):
    _jpeg_folder(tmp_path)
    for p in sorted(tmp_path.rglob("*.jpg")):
        kw = dict(center_crop=center_crop, random_flip=random_flip)
        want = JDS.load_and_transform(str(p), size, rng=host_python_rng(0, p.name), **kw)
        got = TDS.load_and_transform(str(p), size, rng=host_python_rng(0, p.name), **kw)
        assert got.shape == want.shape == (size, size, 3) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=6 * LEVEL + 1e-6, rtol=0)


def test_training_decode_is_the_jax_helpers_scaled_decode(tmp_path, jax_helper):
    _jpeg_folder(tmp_path)
    for p in sorted(tmp_path.rglob("*.jpg")):
        np.testing.assert_array_equal(TDS.decode_image(str(p), 16),
                                      jax_helper.decode_scaled(p.read_bytes(), 16))


def test_epoch_plans_and_batches_on_a_jpeg_folder(tmp_path):
    from dcr_tpu.core.config import DataConfig

    _jpeg_folder(tmp_path / "data", sizes=((24, 24), (20, 30)), per_class=4)
    kw = dict(train_data_dir=str(tmp_path / "data"), resolution=16, class_prompt="classlevel",
              duplication="dup_both", weight_pc=0.4, center_crop=False, random_flip=True)
    jds = JDS.ObjectAttributeDataset(DataConfig(**kw), JHash(49408, 16))
    tds = TDS.ObjectAttributeDataset(TC.DataConfig(**kw), THash(49408, 16))
    for epoch in (0, 1, 2):
        np.testing.assert_array_equal(TL.sampling_plan(tds, epoch=epoch, seed=3),
                                      JL.sampling_plan(jds, epoch=epoch, seed=3))
    jb = list(JL.DataLoader(jds, batch_size=3, num_workers=2, seed=3).epoch(1, 0))
    tb = list(TL.DataLoader(tds, batch_size=3, num_workers=3, seed=3).epoch(1, 0))
    assert len(tb) == len(jb)
    for want, got in zip(jb, tb):
        np.testing.assert_array_equal(got["index"], want["index"])
        np.testing.assert_array_equal(got["input_ids"], want["input_ids"])
        np.testing.assert_allclose(got["pixel_values"], want["pixel_values"],
                                   atol=6 * LEVEL + 1e-6, rtol=0)


@pytest.mark.parametrize("crop", [True, False])
def test_eval_folder_pixels_match_jax(tmp_path, crop):
    _jpeg_folder(tmp_path)
    kw = dict(normalize=TF.HALF_NORM, resize_to=37) if crop else dict(crop=False)
    ours = TF.EvalImageFolder(tmp_path, 32, **kw)
    ref = JF.EvalImageFolder(tmp_path, 32, **kw)
    assert [p.name for p in ours.paths] == [p.name for p in ref.paths]
    scale = 2.0 if crop else 1.0                     # HALF_NORM doubles a level
    for i in range(len(ours)):
        np.testing.assert_allclose(ours.load(i), ref.load(i), atol=2 * scale * LEVEL + 1e-6,
                                   rtol=0)


def test_eval_decode_is_full_scale_pil(tmp_path):
    _jpeg_folder(tmp_path)
    for p in sorted(tmp_path.rglob("*.jpg")):
        with Image.open(p) as im:
            np.testing.assert_array_equal(TDS.decode_image(str(p)), np.asarray(im.convert("RGB")))


def test_other_formats_still_raise_not_ported(tmp_path):
    for suffix in ("bmp", "webp", "ppm", "tif"):
        path = tmp_path / f"x.{suffix}"
        Image.fromarray(_image(0, 8, 8)).save(path)
        with pytest.raises(TC.NotPortedError, match=f"x.{suffix}: dcr_tpu_torch reads PNG and JPEG"):
            TDS.decode_image(str(path))


MUTATE = r'''
import io, json, sys
import numpy as np
from PIL import Image, ImageFile
from dcr_tpu_torch.core.config import NotPortedError
from dcr_tpu_torch.native import jpeg_decoder as D

ImageFile.MAXBLOCK = 1 << 22
rng = np.random.default_rng(int(sys.argv[1]))
bases = []
for opts in (dict(quality=90), dict(quality=50, subsampling=0), dict(quality=80, progressive=True),
             dict(quality=85, restart_marker_blocks=1)):
    img = rng.integers(0, 256, (int(rng.integers(1, 40)), int(rng.integers(1, 40)), 3), np.uint8)
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, "JPEG", **opts)
    bases.append(buf.getvalue())
outcomes = {"decoded": 0, "refused": 0}
for it in range(400):
    data = bytearray(bases[it % len(bases)])
    for _ in range(int(rng.integers(1, 6))):
        pos = int(rng.integers(0, len(data)))
        if rng.random() < 0.6:
            data[pos] = int(rng.integers(0, 256))
        else:
            del data[pos:pos + int(rng.integers(1, 16))]
    try:
        D.decode_scaled(bytes(data), int(rng.choice([0, 3])))
        outcomes["decoded"] += 1
    except (ValueError, NotPortedError):
        outcomes["refused"] += 1
print(json.dumps(outcomes))
'''


def test_mutated_files_decode_or_raise_and_never_crash():
    """The decoder runs inside the trainer's process: a damaged file must
    decode or raise ValueError / NotPortedError, never crash the process.
    400 randomly mutated files in a child process."""
    import subprocess
    import sys
    from pathlib import Path

    proc = subprocess.run([sys.executable, "-c", MUTATE, "3"], capture_output=True, text=True,
                          timeout=300, cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stderr[-2000:]
    outcomes = json.loads(proc.stdout.strip().splitlines()[-1])
    assert outcomes["decoded"] + outcomes["refused"] == 400 and outcomes["refused"] > 0


if __name__ == "__main__":
    build_fixtures()
