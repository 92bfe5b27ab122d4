"""Embedding dumps and the embed stage: the port's ``search/embed`` against
the JAX package's, on the CPU.

Tars are built with PIL. JPEG members decode to PIL's pixels in both
packages; the resize is the port's bilinear against PIL's (within 2/255 at
other sizes, exact where the member is already at the size), so the
``embed_images`` parity runs on members at ``image_size`` (and folder images
at its resize size), where both see the same pixels. SSCD weights are a
Flax init carried across with ``models/export.sscd_from_flax``; features are
held to the f32 bar (atol 2e-4, rtol 1e-3).
"""

from __future__ import annotations

import io
import json
import pickle
import tarfile

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
from PIL import Image  # noqa: E402

from dcr_tpu.core.config import SearchConfig as JaxSearchConfig  # noqa: E402
from dcr_tpu.search import embed as JE  # noqa: E402
from dcr_tpu_torch.core.config import NotPortedError, SearchConfig  # noqa: E402
from dcr_tpu_torch.models import export as EX  # noqa: E402
from dcr_tpu_torch.search import embed as E  # noqa: E402
from tests.test_torch_eval_runner import _he_scaled_sscd_params  # noqa: E402


def _image_bytes(img: np.ndarray, fmt: str) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt, **({"quality": 90} if fmt == "JPEG" else {}))
    return buf.getvalue()


def _write_tar(path, members: dict[str, bytes]) -> None:
    with tarfile.open(path, "w") as tf:
        for name, data in members.items():
            info = tarfile.TarInfo(name)
            info.size = len(data)
            tf.addfile(info, io.BytesIO(data))


def _photo(rng, h, w) -> np.ndarray:
    """Smooth photo-like pixels (JPEG keeps them close)."""
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([np.sin(x / 5.0 + c) * np.cos(y / 7.0 - c) for c in range(3)], -1)
    return np.clip(127 + 100 * base + rng.normal(0, 8, (h, w, 3)), 0, 255).astype(np.uint8)


@pytest.mark.parametrize("fmt", ["npz", "pickle", "pickle_torch"])
def test_dump_round_trips(tmp_path, fmt):
    feats = np.random.default_rng(0).standard_normal((5, 8)).astype(np.float32)
    keys = [f"k{i}" for i in range(5)]
    if fmt == "npz":
        path = E.save_embeddings(tmp_path / "embedding", feats, keys)
        assert path.name == "embedding.npz" and (tmp_path / "embedding.npz.sha256").exists()
    else:
        path = tmp_path / "embedding.pkl"
        payload = torch.from_numpy(feats) if fmt == "pickle_torch" else feats
        path.write_bytes(pickle.dumps({"features": payload, "indexes": keys}))
    for load in (E.load_embeddings, JE.load_embeddings):
        got, got_keys = load(path)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, feats)
        assert got_keys == keys
    assert E.find_embedding_file(tmp_path) == path


@pytest.mark.parametrize("damage", ["bytes", "rows"])
def test_torn_dump_is_caught_by_its_sidecar(tmp_path, damage):
    feats = np.random.default_rng(1).standard_normal((6, 4)).astype(np.float32)
    path = E.save_embeddings(tmp_path / "embedding.npz", feats, list("abcdef"))
    side = tmp_path / "embedding.npz.sha256"
    if damage == "bytes":
        blob = path.read_bytes()
        path.write_bytes(blob[: len(blob) // 2] + bytes([blob[len(blob) // 2] ^ 0xFF])
                         + blob[len(blob) // 2 + 1:])
        match = "sha256"
    else:
        doc = json.loads(side.read_text())
        other = E.save_embeddings(tmp_path / "other.npz", feats[:5], list("abcde"))
        doc["sha256"] = json.loads((tmp_path / "other.npz.sha256").read_text())["sha256"]
        path.write_bytes(other.read_bytes())
        side.write_text(json.dumps(doc))
        match = "rows"
    with pytest.raises(E.EmbeddingDumpError, match=match):
        E.load_embeddings(path)
    with pytest.raises(JE.EmbeddingDumpError, match=match):
        JE.load_embeddings(path)
    E.quarantine_sidecar(path)
    assert not side.exists() and list(tmp_path.glob("embedding.npz.sha256.quarantined.*"))


def test_unreadable_sidecar_loads_unverified(tmp_path):
    feats = np.ones((2, 3), np.float32)
    path = E.save_embeddings(tmp_path / "embedding.npz", feats, ["a", "b"])
    (tmp_path / "embedding.npz.sha256").write_text("{not json")
    np.testing.assert_array_equal(E.load_embeddings(path)[0], feats)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_dumps_load_in_the_other_package(tmp_path, writer):
    feats = np.random.default_rng(2).standard_normal((7, 16)).astype(np.float32)
    keys = [f"chunk/{i}" for i in range(7)]
    save, load = (E.save_embeddings, JE.load_embeddings) if writer == "port" else \
        (JE.save_embeddings, E.load_embeddings)
    path = save(tmp_path / "embedding.npz", feats, keys)
    got, got_keys = load(path)
    np.testing.assert_array_equal(got, feats)
    assert got_keys == keys
    # the same sidecar document
    E.save_embeddings(tmp_path / "a.npz", feats, keys)
    JE.save_embeddings(tmp_path / "b.npz", feats, keys)
    a, b = (json.loads((tmp_path / f"{n}.npz.sha256").read_text()) for n in "ab")
    assert sorted(a) == sorted(b) == ["bytes", "rows", "sha256"] and a["rows"] == b["rows"]


def _tars(root, rng):
    """Two tars: JPEG members of several sizes, RGB / gray / RGBA PNGs, a
    text member, and a corrupt JPEG and PNG (skipped by both packages)."""
    _write_tar(root / "000.tar", {
        "a.jpg": _image_bytes(_photo(rng, 40, 48), "JPEG"),
        "a.txt": b"a caption",
        "b.jpeg": _image_bytes(_photo(rng, 31, 24), "JPEG"),
        "c.png": _image_bytes(rng.integers(0, 256, (20, 26, 3), dtype=np.uint8), "PNG"),
        "bad.jpg": b"not an image",
    })
    gray = rng.integers(0, 256, (18, 18), dtype=np.uint8)
    rgba = rng.integers(0, 256, (16, 22, 4), dtype=np.uint8)
    _write_tar(root / "001.tar", {
        "d.png": _image_bytes(gray, "PNG"),
        "e.png": _image_bytes(rgba, "PNG"),
        "bad.png": _image_bytes(gray, "PNG")[:40],
        "f.jpg": _image_bytes(np.repeat(_photo(rng, 16, 16)[:, :, :1], 3, 2), "JPEG"),
    })
    return sorted(root.glob("*.tar"))


@pytest.mark.parametrize("size", [16, 20])
def test_webdataset_images_match_jax(tmp_path, size):
    tars = _tars(tmp_path, np.random.default_rng(3))
    mine = list(E.iter_webdataset_images(tars, size))
    theirs = list(JE.iter_webdataset_images(tars, size))
    assert [k for k, _ in mine] == [k for k, _ in theirs] == [
        "000/a", "000/b", "000/c", "001/d", "001/e", "001/f"]
    for (key, a), (_, b) in zip(mine, theirs):
        assert a.shape == b.shape == (size, size, 3) and a.dtype == np.float32, key
        assert np.abs(a - b).max() <= 2 / 255 + 1e-7, key
        if key == "001/f" and size == 16:        # already at the size: exact
            np.testing.assert_array_equal(a, b)


def test_webp_member_raises_not_ported(tmp_path):
    rng = np.random.default_rng(4)
    _write_tar(tmp_path / "000.tar", {
        "a.jpg": _image_bytes(_photo(rng, 16, 16), "JPEG"),
        "b.webp": _image_bytes(_photo(rng, 16, 16), "WEBP"),
    })
    assert [k for k, _ in JE.iter_webdataset_images([tmp_path / "000.tar"], 16)] == \
        ["000/a", "000/b"]
    with pytest.raises(NotPortedError, match=r"000\.tar:b\.webp"):
        list(E.iter_webdataset_images([tmp_path / "000.tar"], 16))


@pytest.fixture(scope="module")
def sscd():
    params = _he_scaled_sscd_params()
    return params, EX.sscd_from_flax(params)


def test_embed_images_from_tars_matches_jax(tmp_path, sscd):
    """Members already at image_size (32): JPEG, PNG and a corrupt one, over
    two tars and batches of 3 that do not divide the 7 images."""
    params, state = sscd
    rng = np.random.default_rng(5)
    src = tmp_path / "laion"
    src.mkdir()
    for t in range(2):
        members = {f"{i}.jpg" if i % 2 else f"{i}.png": _image_bytes(
            _photo(rng, 32, 32), "JPEG" if i % 2 else "PNG") for i in range(4 - t)}
        members["broken.jpg"] = b"\xff\xd8\xff garbage"
        _write_tar(src / f"{t:03d}.tar", members)
    mine = E.embed_images(SearchConfig(image_size=32, batch_size=3), source=src,
                          sscd_state=state, out_path=tmp_path / "port.npz", device="cpu")
    theirs = JE.embed_images(JaxSearchConfig(image_size=32, batch_size=3), source=src,
                             sscd_params=params, out_path=tmp_path / "jax.npz")
    (fa, ka), (fb, kb) = E.load_embeddings(mine), JE.load_embeddings(theirs)
    assert ka == kb and len(ka) == 7 and ka[0] == "000/0"
    assert fa.shape == fb.shape == (7, 512)
    np.testing.assert_allclose(fa, fb, atol=2e-4, rtol=1e-3)
    # the images' features differ by far more than the bar (the parity
    # is not that of a degenerate embedder)
    apart = np.abs(fa[:, None] - fa[None]).max(-1)[~np.eye(7, dtype=bool)]
    assert apart.min() > 20 * (2e-4 + 1e-3 * np.abs(fa).max())


def test_embed_images_from_a_folder_matches_jax(tmp_path, sscd):
    """A folder at the transform's resize size (37 px for image_size 32):
    no resampling in either package."""
    params, state = sscd
    rng = np.random.default_rng(6)
    folder = tmp_path / "gens"
    folder.mkdir()
    for i in range(5):
        Image.fromarray(_photo(rng, 37, 37)).save(folder / f"{i}.png")
    mine = E.embed_images(SearchConfig(image_size=32, batch_size=2), source=folder,
                          sscd_state=state, device="cpu")
    assert mine == folder / "embedding.npz"
    fa, ka = E.load_embeddings(mine)
    theirs = JE.embed_images(JaxSearchConfig(image_size=32, batch_size=2), source=folder,
                             sscd_params=params, out_path=tmp_path / "jax.npz")
    fb, kb = JE.load_embeddings(theirs)
    assert ka == kb == [str(folder / f"{i}.png") for i in range(5)]
    np.testing.assert_allclose(fa, fb, atol=2e-4, rtol=1e-3)


def test_embed_cli_and_cleanup(tmp_path, monkeypatch):
    from dcr_tpu_torch.cli import search as cli

    monkeypatch.setenv("DCR_TPU_PLATFORM", "cpu")
    rng = np.random.default_rng(7)
    _write_tar(tmp_path / "000.tar", {f"{i}.jpg": _image_bytes(_photo(rng, 24, 24), "JPEG")
                                      for i in range(3)})
    cli.main(["embed", f"--gen_folder={tmp_path}", "--image_size=32", "--batch_size=2",
              f"--embedding_out={tmp_path / 'out'}"])
    feats, keys = E.load_embeddings(tmp_path / "out.npz")
    assert feats.shape == (3, 512) and np.isfinite(feats).all() and keys[0] == "000/0"
    assert E.cleanup_tars(tmp_path) == 1 and not list(tmp_path.glob("*.tar"))


def test_download_raises_with_the_img2dataset_command(tmp_path):
    with pytest.raises(RuntimeError, match="img2dataset --url_list part.parquet"):
        E.download_laion_chunk("part.parquet", str(tmp_path))
    with pytest.raises(NotPortedError, match="item 9"):
        E.embed_images(SearchConfig(mesh=__import__(
            "dcr_tpu_torch.core.config", fromlist=["MeshConfig"]).MeshConfig(data=2)),
            source=tmp_path, device="cpu")
