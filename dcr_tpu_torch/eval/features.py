"""Batch feature extraction over image folders.

Counterpart of ``dcr_tpu/eval/features.py``: ``EvalImageFolder`` (the
reference's SynthDataset role: a flat generations folder with a
``prompts.txt`` in it or beside it, or a class-tree training folder with a
caption json), the eval transform (shorter-side resize, centre crop,
normalise; or, with ``crop=False``, the whole image squashed to a square as
the FID loader does), ``make_extractor`` with the 3-scale ``multiscale``
pooling, and ``extract_features``.

Images are decoded by the port's PNG and JPEG readers, JPEG at full scale
as the JAX eval loader's plain PIL decode (its pixels are libjpeg-turbo's,
which PIL uses), and resized by the port's bilinear resize
(``dcr_tpu_torch/data/dataset.py``): within one uint8 level of PIL's
BILINEAR, and an image already at the target size is not resampled (PIL
does not resample it either), so folders written at the transform's size
give the JAX package's pixels exactly. Other formats raise NotPortedError.

The JAX extractor runs one jitted program over fixed-shape batches, so its
folder pads the last batch; the port's runs eagerly and pads only when
asked (``pad_to``).
"""

from __future__ import annotations

import json
import logging
import re
from pathlib import Path
from typing import Callable, Iterator, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from dcr_tpu_torch.data.dataset import IMG_EXTENSIONS, decode_image, resize_shorter_side

log = logging.getLogger("dcr_tpu_torch")

# the reference's eval-transform statistics: retrieval backbones see
# Normalize([0.5],[0.5]) inputs; the LAION embedding pipeline ImageNet's
HALF_NORM = ((0.5, 0.5, 0.5), (0.5, 0.5, 0.5))
IMAGENET_NORM = ((0.485, 0.456, 0.406), (0.229, 0.224, 0.225))


def reference_resize_for(crop_size: int) -> int:
    """Shorter-side resize before a centre crop, keeping the reference's
    Resize(256) + CenterCrop(224) ratio at any crop size."""
    return round(crop_size * 256 / 224)


def natsort_key(path: Path):
    """Natural sort (gen_0, gen_2, gen_10): generations must line up with
    the lines of prompts.txt."""
    return [int(t) if t.isdigit() else t for t in re.split(r"(\d+)", path.name)]


def resize_square(img: np.ndarray, size: int) -> np.ndarray:
    """uint8 [H, W, 3] squashed to [size, size, 3] (bilinear, antialiased, as
    PIL's ``resize((size, size), BILINEAR)``); unchanged when already there."""
    if img.shape[:2] == (size, size):
        return img
    t = torch.from_numpy(np.ascontiguousarray(img)).permute(2, 0, 1)[None]
    out = F.interpolate(t, size=(size, size), mode="bilinear", antialias=True,
                        align_corners=False)
    return out[0].permute(1, 2, 0).numpy()


class EvalImageFolder:
    """Flat or class-tree image folder with optional captions.

    - generations: flat files and a prompts.txt (one line per prompt) in the
      folder or its parent; images in natural order, ``len // len(prompts)``
      images per prompt.
    - training data: class subfolders and a caption json keyed by path (the
      key may be relative, absolute or a bare file name).
    """

    def __init__(self, root: str | Path, image_size: int = 224, *,
                 caption_json: Optional[str | Path] = None,
                 normalize: Optional[tuple[Sequence[float], Sequence[float]]] = None,
                 resize_to: Optional[int] = None, crop: bool = True):
        """resize_to: shorter-side resize before the centre crop (default
        image_size). crop=False squashes the whole image to image_size²."""
        self.root = Path(root)
        self.image_size = image_size
        self.resize_to = resize_to or image_size
        self.crop = crop
        self.normalize = normalize
        flat = sorted([p for p in self.root.iterdir() if p.suffix.lower() in IMG_EXTENSIONS],
                      key=natsort_key) if self.root.exists() else []
        self.paths = flat or sorted(p for p in self.root.rglob("*")
                                    if p.suffix.lower() in IMG_EXTENSIONS)
        if not self.paths:
            raise FileNotFoundError(f"no images under {root}")
        self.captions: Optional[list[str]] = None
        if caption_json is not None:
            self.captions = self._captions_from_json(Path(caption_json))
        else:
            prompts_file = self.root / "prompts.txt"
            if not prompts_file.exists():
                prompts_file = self.root.parent / "prompts.txt"
            if prompts_file.exists():
                prompts = prompts_file.read_text().splitlines()
                per = max(1, len(self.paths) // max(1, len(prompts)))
                self.captions = [prompts[min(i // per, len(prompts) - 1)]
                                 for i in range(len(self.paths))]

    def _captions_from_json(self, caption_json: Path) -> list[str]:
        table = json.loads(caption_json.read_text())
        # the table holds the training run's path strings, which may be
        # relative where ours are absolute (or the other way round)
        lookup: dict[str, str] = {}
        for key, caps in table.items():
            cap = str(caps[0]) if caps else ""
            kp = Path(key)
            for alias in (str(kp), str(kp.resolve()), kp.name):
                lookup.setdefault(alias, cap)
        captions, misses = [], 0
        for p in self.paths:
            for alias in (str(p), str(p.resolve()), p.name):
                if alias in lookup:
                    captions.append(lookup[alias])
                    break
            else:
                captions.append("")
                misses += 1
        if misses:
            log.warning("caption json %s matched only %d/%d images under %s; clip scores "
                        "over the misses are meaningless", caption_json,
                        len(self.paths) - misses, len(self.paths), self.root)
        return captions

    def __len__(self) -> int:
        return len(self.paths)

    def load(self, i: int) -> np.ndarray:
        """f32 [image_size, image_size, 3]: [0, 1], then ``normalize``."""
        img = decode_image(str(self.paths[i]))
        if self.crop:
            img = resize_shorter_side(img, self.resize_to)
            h, w = img.shape[:2]
            left, top = (w - self.image_size) // 2, (h - self.image_size) // 2
            img = img[top:top + self.image_size, left:left + self.image_size]
        else:
            img = resize_square(img, self.image_size)
        arr = np.asarray(img, np.float32) / 255.0
        if self.normalize is not None:
            mean, std = self.normalize
            arr = (arr - np.asarray(mean, np.float32)) / np.asarray(std, np.float32)
        return arr

    def batches(self, batch_size: int, pad_to: Optional[int] = None
                ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """(images [B, H, W, 3], valid mask [B]); the last batch is padded
        with copies of its last image up to ``pad_to`` when given."""
        for start in range(0, len(self), batch_size):
            idx = range(start, min(start + batch_size, len(self)))
            imgs = np.stack([self.load(i) for i in idx])
            mask = np.ones(len(idx), bool)
            if pad_to and len(idx) < pad_to:
                fill = pad_to - len(idx)
                imgs = np.concatenate([imgs, np.repeat(imgs[-1:], fill, 0)])
                mask = np.concatenate([mask, np.zeros(fill, bool)])
            yield imgs, mask


def make_extractor(forward: Callable[[torch.Tensor], torch.Tensor],
                   device: str | torch.device, *, multiscale: bool = False
                   ) -> Callable[[np.ndarray], torch.Tensor]:
    """images [B, H, W, 3] (numpy, NHWC as the folder gives them) -> [B, D]
    features on ``device``, from ``forward`` over NCHW tensors, under
    inference mode. multiscale: the mean of the features at scales 1,
    1/sqrt(2) and 1/2 (bilinear downsampling without antialias, as the
    reference's F.interpolate), L2-normalised."""
    device = torch.device(device)

    def extract(images: np.ndarray) -> torch.Tensor:
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device).permute(0, 3, 1, 2)
        with torch.inference_mode():
            if not multiscale:
                return forward(x)
            h, w = x.shape[2:]
            acc = None
            for s in (1.0, 2 ** -0.5, 0.5):
                inp = x if s == 1.0 else F.interpolate(
                    x, size=(int(h * s), int(w * s)), mode="bilinear", align_corners=False,
                    antialias=False)
                feats = forward(inp)
                acc = feats if acc is None else acc + feats
            acc = acc / 3.0
            return acc / acc.norm(dim=-1, keepdim=True)

    return extract


def extract_features(folder: EvalImageFolder, extractor, *,
                     batch_size: int = 64) -> np.ndarray:
    """[N, D] f32 features of every image of the folder, in folder order."""
    chunks = []
    for images, mask in folder.batches(batch_size):
        chunks.append(extractor(images).float().cpu().numpy()[mask])
    return np.concatenate(chunks, axis=0)
