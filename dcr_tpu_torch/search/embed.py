"""Stage 1+2 of the LAION pipeline: download a chunk, embed it, dump features.

Counterpart of ``dcr_tpu/search/embed.py`` (the reference's
embedding_search/download_and_generate_embedding.py and utils.py):
img2dataset orchestration, SSCD embedding of webdataset tars or of an image
folder, and the embedding dump. Dumps are compressed ``.npz`` (features
float32 [N, D], indexes) with a ``<name>.sha256`` sidecar, under the JAX
package's file names and sidecar JSON, so each package reads the other's;
the reference's pickle ``{'features', 'indexes'}`` (a pickled torch tensor
included) reads too, unverified.

Tar members are decoded by the port's own readers (the card's machine has no
PIL): JPEG at full scale with ``native/jpeg_decoder.decode`` (PIL's pixels),
PNG with ``sampling/png``, then ``data/dataset.resize_shorter_side`` (within
one uint8 level of PIL's bilinear; an image already at the size is not
resampled) and the centre crop. A member whose bytes are corrupt is skipped
with a warning, as the JAX reader skips it; a ``.webp`` member raises
:class:`NotPortedError`, since skipping it would quietly shrink the corpus.

On a mesh (``cfg.mesh`` over the job's processes, one per device) each
batch of ``batch_size`` images splits over the ``data`` x ``fsdp`` ranks,
as the JAX extractor's batch sharding splits it (``dcr_tpu/search/
embed.py:265-286``): every rank reads the tars' bytes (cheap), decodes and
embeds only its slab of each batch (the batch padded with its last member
to a multiple of the rank count), and the features are gathered in the
batch's order, a member that failed to decode dropped on every rank alike.
Rank 0 writes the dump and its sidecar.

The JAX package initialises SSCD from ``jax.random.key(0)``; the port's
seeded init draws from torch's CPU generator, so the two differ by design.
Pass the JAX weights through ``models/export.sscd_from_flax`` to compare.
"""

from __future__ import annotations

import hashlib
import io
import itertools
import json
import logging
import os
import pickle
import tarfile
import time
import zlib
from pathlib import Path
from typing import Iterator, Mapping, Optional

import numpy as np
import torch

from dcr_tpu_torch.core import dist, fsio
from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core import tracing
from dcr_tpu_torch.core.config import NotPortedError, SearchConfig
from dcr_tpu_torch.data.dataset import resize_shorter_side
from dcr_tpu_torch.eval.features import (
    IMAGENET_NORM,
    EvalImageFolder,
    extract_features,
    make_extractor,
    reference_resize_for,
)
from dcr_tpu_torch.native import jpeg_decoder
from dcr_tpu_torch.parallel import mesh as pmesh
from dcr_tpu_torch.sampling.png import decode_png
from dcr_tpu_torch.utils import faults

log = logging.getLogger("dcr_tpu_torch")


def download_laion_chunk(parquet_path: str, out_folder: str, *,
                         image_size: int = 256, processes: int = 16,
                         threads: int = 32) -> None:
    """img2dataset orchestration (reference download stage). The tool is not
    bundled; raise with the exact command to run where network access
    exists."""
    try:
        import img2dataset
    except ImportError:
        raise RuntimeError(
            "img2dataset is not installed in this environment. Run the download "
            f"stage on a networked host:\n  img2dataset --url_list {parquet_path} "
            f"--input_format parquet --url_col URL --caption_col TEXT "
            f"--output_format webdataset --output_folder {out_folder} "
            f"--image_size {image_size} --processes_count {processes} "
            f"--thread_count {threads} --resize_mode center_crop"
        ) from None
    img2dataset.download(
        url_list=parquet_path, input_format="parquet", url_col="URL",
        caption_col="TEXT", output_format="webdataset",
        output_folder=out_folder, image_size=image_size,
        processes_count=processes, thread_count=threads,
        resize_mode="center_crop")


def iter_webdataset_members(tar_paths: list[Path]) -> Iterator[tuple[str, str, str, bytes]]:
    """``(key, name, suffix, bytes)`` of every image member of
    webdataset-style tars, undecoded; the key is ``<tar stem>/<member
    stem>``. A ``.webp`` member raises :class:`NotPortedError` here, on
    every rank that reads the tar."""
    for tar_path in tar_paths:
        tar_path = Path(tar_path)
        with tarfile.open(tar_path) as tf:
            for member in tf:
                suffix = Path(member.name).suffix.lower()
                if suffix not in (".jpg", ".jpeg", ".png", ".webp"):
                    continue
                data = tf.extractfile(member)
                if data is None:
                    continue
                name = f"{tar_path}:{member.name}"
                if suffix == ".webp":
                    raise NotPortedError(
                        f"{name}: dcr_tpu_torch reads JPEG and PNG tar members only (.webp "
                        "needs a decoder the port does not have)")
                yield f"{tar_path.stem}/{Path(member.name).stem}", name, suffix, data.read()


def decode_webdataset_member(name: str, suffix: str, data: bytes,
                             image_size: int) -> Optional[np.ndarray]:
    """One member as float32 [image_size, image_size, 3] in [0, 1] (the
    shorter side resized, the centre cropped), or None with a warning when
    its bytes are corrupt (expected at scale)."""
    try:
        img = decode_png(data) if suffix == ".png" else jpeg_decoder.decode(data, name=name)
    except (ValueError, zlib.error) as e:
        log.warning("skipping corrupt member %s (%s)", name, e)
        return None
    img = resize_shorter_side(img, image_size)
    h, w = img.shape[:2]
    left, top = (w - image_size) // 2, (h - image_size) // 2
    img = img[top:top + image_size, left:left + image_size]
    return np.asarray(img, np.float32) / 255.0


def iter_webdataset_images(tar_paths: list[Path], image_size: int,
                           ) -> Iterator[tuple[str, np.ndarray]]:
    """(key, image [H, W, 3] float32 in [0, 1]) from webdataset-style tars;
    the key is ``<tar stem>/<member stem>``; corrupt members are skipped."""
    for key, name, suffix, data in iter_webdataset_members(tar_paths):
        img = decode_webdataset_member(name, suffix, data, image_size)
        if img is not None:
            yield key, img


class EmbeddingDumpError(RuntimeError):
    """An embedding dump failed its sidecar check (sha256 or row count): a
    torn or bit-rotted dump, caught at load. Callers treat it as any other
    corrupt dump (quarantine)."""


#: per-process verified-dump read index: the ``load`` coordinate of the
#: ``search_dump_corrupt`` fault kind (utils/faults.py)
_load_seq = itertools.count()


def reset_dump_load_seq() -> None:
    """Restart the ``load`` coordinate at 0 (a harness that installs a
    ``search_dump_corrupt@load=N`` spec mid-process; a fresh process starts
    at 0)."""
    global _load_seq
    _load_seq = itertools.count()


def _sidecar_path(path: Path) -> Path:
    return path.with_name(path.name + ".sha256")


def save_embeddings(path: str | Path, features: np.ndarray, indexes: list[str]) -> Path:
    """Write a dump and its integrity sidecar (``<name>.sha256``: payload
    sha256, row count and bytes), each atomically, the sidecar after the
    dump. Returns the path written: ``.npz`` is appended when missing
    (``np.savez_compressed``'s rule; :func:`load_embeddings` tells npz from
    pickle by the suffix)."""
    path = Path(path)
    if not path.name.endswith(".npz"):
        path = path.with_name(path.name + ".npz")
    features = np.asarray(features, np.float32)
    buf = io.BytesIO()
    np.savez_compressed(buf, features=features, indexes=np.asarray(indexes))
    blob = buf.getvalue()
    fsio.publish_durable(path.with_name(f"{path.name}.tmp.{os.getpid()}"), path, blob)
    side = _sidecar_path(path)
    # dir fsync after the sidecar: a sidecar condemns any dump it mismatches,
    # so it must never survive a crash that lost the dump
    fsio.publish_durable(side.with_name(f"{side.name}.tmp.{os.getpid()}"), side, json.dumps(
        {"sha256": hashlib.sha256(blob).hexdigest(), "rows": int(features.shape[0]),
         "bytes": len(blob)}, sort_keys=True) + "\n", sync_dir=True)
    return path


def quarantine_sidecar(path: str | Path) -> None:
    """Rename a quarantined dump's sidecar along with it: a stale sidecar
    would condemn any replacement dump to a false sha mismatch."""
    side = _sidecar_path(Path(path))
    if side.exists():
        fsio.quarantine_rename(side)


def _read_sidecar(path: Path) -> Optional[dict]:
    side = _sidecar_path(path)
    if not side.exists():
        return None          # reference dumps: unverified
    try:
        doc = json.loads(side.read_text())
        if not isinstance(doc.get("sha256"), str) or not isinstance(doc.get("rows"), int):
            raise ValueError("sidecar missing sha256/rows")
        return doc
    except (OSError, ValueError) as e:
        # a corrupt sidecar must not take down a possibly-fine dump: load
        # proceeds unverified, loudly
        R.log_event("search_dump_sidecar_unreadable", path=str(side), error=repr(e))
        tracing.registry().counter("search/dump_sidecar_unreadable").inc()
        return None


def load_embeddings(path: str | Path) -> tuple[np.ndarray, list[str]]:
    """(features float32 [N, D], keys) from a ``.npz`` dump or a reference
    pickle. With a sidecar, the payload's sha256 and row count are checked
    first and a mismatch raises :class:`EmbeddingDumpError`; a dump without
    one (the reference toolchain's) loads unverified. The
    ``search_dump_corrupt@load=N`` fault damages the Nth verified read."""
    path = Path(path)
    sidecar = _read_sidecar(path)
    if sidecar is not None:
        # transient I/O surfaces as OSError only after backoff; callers treat
        # OSError as "skip, keep the dump", never as corruption
        blob = R.read_bytes_with_retry(path, name=f"embedding_dump:{path.name}")
        if faults.fire("search_dump_corrupt", load=next(_load_seq)):
            # damage the bytes in memory so the real verification path runs
            mid = len(blob) // 2
            blob = blob[:mid] + bytes([blob[mid] ^ 0xFF]) + blob[mid + 1:] if blob else b""
        if hashlib.sha256(blob).hexdigest() != sidecar["sha256"]:
            tracing.registry().counter("search/dump_corrupt").inc()
            raise EmbeddingDumpError(
                f"embedding dump {path} fails its sha256 sidecar — torn or bit-rotted dump")
        source = io.BytesIO(blob)
    else:
        # nothing to verify: parse from the file rather than hold the raw
        # bytes and the arrays at once (LAION chunks are GB-scale)
        source = path
    if path.name.endswith(".npz"):
        with np.load(source, allow_pickle=False) as z:
            features = np.asarray(z["features"], np.float32)
            keys = [str(i) for i in z["indexes"]]
    else:
        if isinstance(source, io.BytesIO):
            d = pickle.load(source)
        else:
            with open(source, "rb") as f:
                d = pickle.load(f)
        features = d["features"]
        if isinstance(features, torch.Tensor):   # the reference toolchain's dump
            features = features.detach().cpu().numpy()
        features = np.asarray(features, np.float32)
        keys = [str(i) for i in d["indexes"]]
    if sidecar is not None and features.shape[0] != sidecar["rows"]:
        tracing.registry().counter("search/dump_corrupt").inc()
        raise EmbeddingDumpError(
            f"embedding dump {path} has {features.shape[0]} rows but its sidecar "
            f"recorded {sidecar['rows']} — torn dump")
    return features, keys


def find_embedding_file(folder: str | Path) -> Optional[Path]:
    folder = Path(folder)
    for name in ("embedding.npz", "embedding.pkl", "embedding.pickle"):
        if (folder / name).exists():
            return folder / name
    return None


def _count_decodes(images: int, seconds: float) -> None:
    """The tar members this process decoded for the embed stage (a rank
    decodes only its slab of each batch): ``search/embed_decoded_total``
    and ``search/embed_decode_us_total``."""
    reg = tracing.registry()
    reg.counter("search/embed_decoded_total").inc(images)
    reg.counter("search/embed_decode_us_total").inc(int(seconds * 1e6))


def _embed_tars(tars: list[Path], cfg: SearchConfig, extractor,
                mesh: pmesh.Mesh) -> tuple[np.ndarray, list[str]]:
    """Features and keys of every decodable member of ``tars``, in member
    order. One process batches the decoded images, as the JAX loop does; on
    a mesh a batch is ``batch_size`` members and each rank decodes only its
    slab of it (module docstring)."""
    # the reference embedding pipeline normalises with ImageNet's
    # statistics (embedding_search/utils.py:35-40)
    mean = np.asarray(IMAGENET_NORM[0], np.float32)
    std = np.asarray(IMAGENET_NORM[1], np.float32)
    n = mesh.data_parallel_size
    feats_list, keys, batch = [], [], []

    def decode(member) -> Optional[np.ndarray]:
        t0 = time.perf_counter()
        img = decode_webdataset_member(*member[1:4], cfg.image_size)
        _count_decodes(1, time.perf_counter() - t0)
        return None if img is None else (img - mean) / std

    def flush():
        if not batch:
            return
        if n == 1:
            imgs, ok = [m[4] for m in batch], [True] * len(batch)
        else:
            members = batch + [batch[-1]] * ((-len(batch)) % n)
            imgs = [decode(m) for m in members[pmesh.rank_slab(len(members), n,
                                                                mesh.batch_index)]]
            ok = [img is not None for img in imgs]
            imgs = [np.zeros((cfg.image_size, cfg.image_size, 3), np.float32)
                    if img is None else img for img in imgs]
        out = extractor(np.stack(imgs)).float()
        flag = torch.tensor(ok, dtype=out.dtype, device=out.device)[:, None]
        # the decode flag rides as a last column, so one gather carries both
        got = pmesh.to_host(torch.cat([out, flag], dim=1), mesh)[:len(batch)]
        kept = got[:, -1] > 0.5
        feats_list.append(got[kept, :-1])
        keys.extend(m[0] for m, k in zip(batch, kept) if k)
        batch.clear()

    for member in iter_webdataset_members(tars):
        if n == 1:  # corrupt members never enter a batch
            img = decode(member)
            if img is None:
                continue
            member = (*member, img)
        batch.append(member)
        if len(batch) == cfg.batch_size:
            flush()
    flush()
    return (np.concatenate(feats_list) if feats_list
            else np.zeros((0, 512), np.float32)), keys


def embed_images(cfg: SearchConfig, *, source: str | Path,
                 sscd_state: Optional[Mapping[str, torch.Tensor]] = None,
                 out_path: Optional[str | Path] = None,
                 device: str | torch.device = "cuda") -> Path:
    """Embed a folder of webdataset tars (batches of ``cfg.batch_size``) or
    an image folder with SSCD on ``device``, over the mesh of ``cfg.mesh``
    (module docstring); rank 0 dumps ``.npz``. Returns the dump's path on
    every rank. Seeded random SSCD weights (seed 0) unless ``sscd_state`` is
    given."""
    from dcr_tpu_torch.eval.runner import build_backbone

    device = dist.job_device(device)
    dist.initialize(device)
    mesh = pmesh.make_mesh(cfg.mesh)
    model = build_backbone("sscd", "resnet50_disc", device, state_dict=sscd_state, seed=0)
    extractor = make_extractor(model, device)
    source = Path(source)
    tars = sorted(source.glob("*.tar"))
    if tars:
        features, keys = _embed_tars(tars, cfg, extractor, mesh)
    else:
        folder = EvalImageFolder(source, cfg.image_size,
                                 resize_to=reference_resize_for(cfg.image_size),
                                 normalize=IMAGENET_NORM)
        features = extract_features(folder, extractor, batch_size=cfg.batch_size, mesh=mesh)
        keys = [str(p) for p in folder.paths]
    out_path = Path(out_path or (source / "embedding.npz"))
    if not out_path.name.endswith(".npz"):  # the name save_embeddings writes
        out_path = out_path.with_name(out_path.name + ".npz")
    if dist.is_primary():
        save_embeddings(out_path, features, keys)
        log.info("embedded %d images from %s -> %s", len(keys), source, out_path)
    return out_path


def cleanup_tars(folder: str | Path) -> int:
    """Delete the tars after embedding (reference stage 3)."""
    n = 0
    for tar in Path(folder).glob("*.tar"):
        tar.unlink()
        n += 1
    return n
