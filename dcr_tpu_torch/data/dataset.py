"""Image-folder dataset with caption conditioning and duplication regimes.

Counterpart of ``dcr_tpu/data/dataset.py`` (the reference's
ObjectAttributeDataset, datasets.py:32-152): class-subdirectory image folder,
resize (shorter side) -> crop -> flip -> normalise to [-1, 1], caption
assignment per regime, cached duplication weights, tokenization to fixed
length. Every random decision draws from the same (seed, epoch, slot, index)
host stream as the JAX package's.

The port reads PNG and JPEG itself, because the machine with the card has no
PIL: PNG with :mod:`dcr_tpu_torch.sampling.png` (8-bit gray, gray + alpha,
RGB or RGBA), JPEG with :mod:`dcr_tpu_torch.native.jpeg_decoder` (baseline,
extended and progressive Huffman, 1 or 3 components, pixels equal to
libjpeg-turbo's). A training JPEG is decoded at the smallest DCT scale that
still covers the resolution, as the JAX loader's libjpeg fast path does.
The resize is ``F.interpolate(mode="bilinear", antialias=True)`` on uint8
values, which rounds back to uint8 as PIL's BILINEAR does (within one level
of it); an image already at the target size is not resampled. The other
formats (``.bmp``, ``.webp``, ``.ppm``, ``.tif``) raise
:class:`NotPortedError` naming the file. A sample that does not decode is
tried ``fault.decode_retries`` more times, each attempt from a fresh rng so a
retry returns the example a first-try success would, then raises
:class:`SampleDecodeError` for the loader's quarantine.
"""

from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from dcr_tpu_torch.core import resilience as R
from dcr_tpu_torch.core.config import DataConfig, FaultToleranceConfig, NotPortedError
from dcr_tpu_torch.core.rng import host_python_rng
from dcr_tpu_torch.data import captions as C
from dcr_tpu_torch.data import duplication as D
from dcr_tpu_torch.data.tokenizer import TokenizerBase
from dcr_tpu_torch.native import jpeg_decoder
from dcr_tpu_torch.sampling.png import read_png

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp", ".ppm", ".tif", ".tiff")


class SampleDecodeError(RuntimeError):
    """A sample failed to decode after all retry attempts; carries what the
    loader's quarantine manifest records."""

    def __init__(self, index: int, path: str, cause: BaseException):
        super().__init__(f"sample {index} ({path}) failed to decode: {cause!r}")
        self.index = index
        self.path = path
        self.cause = cause


def list_image_folder(root: str | Path) -> tuple[list[str], list[int], list[str]]:
    """(paths, labels, classnames) from a class-per-subdirectory layout, sorted
    deterministically (same contract as torchvision ImageFolder)."""
    root = Path(root)
    classes = sorted(d.name for d in root.iterdir() if d.is_dir())
    if not classes:
        raise FileNotFoundError(f"no class subdirectories under {root}")
    paths: list[str] = []
    labels: list[int] = []
    for li, cls in enumerate(classes):
        for p in sorted((root / cls).rglob("*")):
            if p.suffix.lower() in IMG_EXTENSIONS:
                paths.append(str(p))
                labels.append(li)
    if not paths:
        raise FileNotFoundError(f"no images under {root}")
    return paths, labels, classes


def decode_image(path: str, size: int = 0) -> np.ndarray:
    """uint8 [H, W, 3] RGB from a PNG or JPEG file. size > 0: a JPEG is
    decoded at the smallest DCT scale whose shorter side still covers
    ``size`` (the JAX loader's ``_open_image``); 0 decodes at full scale."""
    suffix = Path(path).suffix.lower()
    if suffix == ".png":
        return read_png(path)
    if suffix in (".jpg", ".jpeg"):
        return jpeg_decoder.decode_scaled(Path(path).read_bytes(), size, name=str(path))
    raise NotPortedError(
        f"{path}: dcr_tpu_torch reads PNG and JPEG images only ({suffix} needs a "
        "decoder the port does not have)")


def resize_shorter_side(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] with its shorter side resized to ``size`` (bilinear,
    antialiased, PIL's output size rule)."""
    h, w = img.shape[:2]
    if w <= h:
        nw, nh = size, max(size, round(h * size / w))
    else:
        nw, nh = max(size, round(w * size / h)), size
    if (nh, nw) == (h, w):
        return img
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(nh, nw), mode="bilinear", antialias=True,
                        align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


def load_and_transform(path: str, size: int, *, center_crop: bool,
                       random_flip: bool, rng: np.random.Generator) -> np.ndarray:
    """Decode + resize(shorter side) -> crop -> flip -> normalise to [-1, 1]
    NHWC f32 (reference transform stack, datasets.py:59-67)."""
    img = resize_shorter_side(decode_image(path, size), size)
    h, w = img.shape[:2]
    if center_crop:
        left, top = (w - size) // 2, (h - size) // 2
    else:
        left = int(rng.integers(0, w - size + 1))
        top = int(rng.integers(0, h - size + 1))
    arr = np.asarray(img[top:top + size, left:left + size], np.float32) / 255.0
    if random_flip and rng.uniform() < 0.5:
        arr = arr[:, ::-1, :]
    return arr * 2.0 - 1.0


@dataclass
class Example:
    pixel_values: np.ndarray  # [H, W, 3] f32 in [-1, 1]
    input_ids: np.ndarray     # [max_length] int32
    index: int
    caption: str


class ObjectAttributeDataset:
    """Deterministic map-style dataset over an image folder."""

    def __init__(self, cfg: DataConfig, tokenizer: TokenizerBase,
                 caption_tables: Optional[dict] = None,
                 fault: Optional[FaultToleranceConfig] = None):
        self.cfg = cfg
        self.tokenizer = tokenizer
        self.fault = fault or FaultToleranceConfig()
        self.paths, self.labels, self.classes = list_image_folder(cfg.train_data_dir)
        # classnames: Imagenette convention when recognizable, else folder names
        if any(s in str(cfg.train_data_dir) for s in ("imagenette", "Imagenette")):
            self.classnames = list(C.get_classnames(cfg.train_data_dir))
        else:
            self.classnames = self.classes
        self.prompts = caption_tables
        if self.prompts is None and cfg.caption_jsons:
            self.prompts = {}
            for j in cfg.caption_jsons:
                self.prompts.update(json.loads(R.read_bytes_with_retry(
                    j, attempts=self.fault.io_retries, name=f"captions:{j}")))
        needs_prompts = cfg.class_prompt.startswith("instancelevel") or (
            cfg.trainspecial not in (None, "none"))
        if needs_prompts and not self.prompts:
            raise ValueError(
                f"class_prompt={cfg.class_prompt!r}/trainspecial={cfg.trainspecial!r} "
                "need caption tables (data.caption_jsons)")
        if cfg.duplication in ("dup_both", "dup_image"):
            self.sampling_weights = D.load_or_create_weights(
                cfg.train_data_dir, len(self.paths), cfg.weight_pc,
                cfg.dup_weight, cfg.seed)
        else:
            self.sampling_weights = np.ones(len(self.paths), np.int64)
        self.spec = C.CaptionSpec(
            class_prompt=cfg.class_prompt,
            duplication=cfg.duplication,
            instance_prompt=cfg.instance_prompt,
            trainspecial=cfg.trainspecial,
            trainspecial_prob=cfg.trainspecial_prob,
        )
        # partial-data training (reference --trainsubset): the first N indices
        self.active_indices = np.arange(len(self.paths))
        if cfg.trainsubset and cfg.trainsubset > 0:
            self.active_indices = self.active_indices[: cfg.trainsubset]

    def __len__(self) -> int:
        return len(self.active_indices)

    def get(self, position: int, epoch: int = 0,
            slot: Optional[int] = None) -> Example:
        """position indexes the (possibly subset) dataset; (epoch, slot) feed
        the rng: slot is the occurrence's place in the epoch's sampling plan,
        so each occurrence of a duplicated image redraws crop, flip and
        caption. Defaults to position for direct use. A failed decode is
        retried ``fault.decode_retries`` times, then raises
        :class:`SampleDecodeError`; a format the port does not read raises
        :class:`NotPortedError` at once."""
        index = int(self.active_indices[position])
        slot = position if slot is None else slot

        def build() -> Example:
            # a fresh rng per attempt: a retried decode must produce the
            # byte-identical example a first-try success would have
            rng = host_python_rng(self.cfg.seed, f"sample_e{epoch}_s{slot}_i{index}")
            pixels = load_and_transform(
                self.paths[index], self.cfg.resolution,
                center_crop=self.cfg.center_crop,
                random_flip=self.cfg.random_flip, rng=rng)
            caption = C.assign_caption(
                self.spec, path=self.paths[index], label=self.labels[index],
                classnames=self.classnames, prompts=self.prompts,
                sampling_weight=float(self.sampling_weights[index]),
                tokenizer=self.tokenizer, rng=rng)
            ids = self.tokenizer(caption)[0]
            return Example(pixel_values=pixels, input_ids=ids, index=index, caption=caption)

        ft = self.fault
        try:
            # transient and deterministic decode errors alike: one spare
            # attempt is cheap, and a truly corrupt file fails identically
            return R.retry_call(build, attempts=1 + max(0, ft.decode_retries),
                                base_delay=ft.retry_base_delay,
                                max_delay=ft.retry_max_delay,
                                retry_on=(Exception,), give_up_on=(NotPortedError,),
                                name=f"decode:{Path(self.paths[index]).name}")
        except NotPortedError:
            raise
        except Exception as e:
            raise SampleDecodeError(index, self.paths[index], e) from e
