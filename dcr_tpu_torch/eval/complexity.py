"""Image-complexity measures and their correlations with similarity.

Counterpart of ``dcr_tpu/eval/complexity.py`` (the reference's
diff_retrieval.py:497-559): for each generation's top-1 training match,
three complexity proxies of the matched image, each Pearson-correlated
with the top-1 similarity:

- grayscale Shannon entropy (skimage.measure.shannon_entropy equivalent);
- the JPEG byte size at quality 95 (cv2.imencode in the reference), from
  the port's own baseline encoder (:mod:`dcr_tpu_torch.native.jpeg_helper`,
  libjpeg-turbo's output under its defaults);
- total variation (tv_loss, diff_retrieval.py:113-121).

Host numpy, as in the JAX package. A float image is truncated to uint8 as
``(clip(x, 0, 1) * 255).astype(uint8)``, whatever its range: the eval
stage passes the loaded, normalised values images, as the JAX runner does.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Sequence

import numpy as np

from dcr_tpu_torch.native import jpeg_helper


def _uint8(image: np.ndarray) -> np.ndarray:
    arr = np.asarray(image)
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0, 1) * 255).astype(np.uint8)
    return arr


def shannon_entropy(image: np.ndarray) -> float:
    """Grayscale Shannon entropy in bits. image: [H, W, 3] float [0, 1] or uint8."""
    arr = _uint8(image)
    gray = np.round(arr.astype(np.float64) @ np.array([0.2125, 0.7154, 0.0721])
                    ).astype(np.uint8)
    counts = np.bincount(gray.ravel(), minlength=256)
    p = counts[counts > 0] / gray.size
    return float(-np.sum(p * np.log2(p)))


def jpeg_size(image: np.ndarray, quality: int = 95) -> int:
    """JPEG-compressed size in bytes (the complexity proxy)."""
    return jpeg_helper.encoded_size(_uint8(image), quality)


def tv_loss(image: np.ndarray) -> float:
    """Anisotropic total variation: mean absolute difference of vertical
    plus horizontal neighbours (diff_retrieval.py:113-121)."""
    arr = np.asarray(image, np.float64)
    dh = np.abs(arr[1:, :] - arr[:-1, :]).mean()
    dw = np.abs(arr[:, 1:] - arr[:, :-1]).mean()
    return float(dh + dw)


def pearson(x: Sequence[float], y: Sequence[float]) -> float:
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    if len(x) < 2 or x.std() == 0 or y.std() == 0:
        return float("nan")
    return float(np.corrcoef(x, y)[0, 1])


def complexity_triple(image: np.ndarray) -> tuple[float, float, float]:
    """(entropy, jpeg_bytes, tv) of one image."""
    return shannon_entropy(image), float(jpeg_size(image)), tv_loss(image)


def streamed_series(load: Callable[[int], np.ndarray], indices, *, workers: int = 8) -> dict:
    """Complexity series over top-1 match indices at any scale: each unique
    index is loaded once (on ``workers`` threads: the decoder and the
    encoder release the GIL), reduced to its three scalars at once, and the
    per-generation series come back through the inverse map."""
    uniq, inverse = np.unique(np.asarray(indices, np.int64), return_inverse=True)
    if len(uniq) == 0:
        empty = np.zeros((0,), np.float64)
        return {"entropy": empty, "jpeg_bytes": empty, "tv": empty}
    with ThreadPoolExecutor(max_workers=max(1, workers)) as ex:
        triples = list(ex.map(lambda i: complexity_triple(load(int(i))), uniq))
    t = np.asarray(triples, np.float64)[inverse]            # [N, 3]
    return {"entropy": t[:, 0], "jpeg_bytes": t[:, 1], "tv": t[:, 2]}


def correlations_from_series(series: dict, top1_sims) -> dict:
    """The reference's scalars (diff_retrieval.py:530-540): correlations of
    top-1 similarity with entropy / jpeg size / tv / entropy-vs-size, and
    the three means."""
    entropies, sizes, tvs = series["entropy"], series["jpeg_bytes"], series["tv"]
    return {
        "corr_entropy_sim": pearson(entropies, top1_sims),
        "corr_jpegsize_sim": pearson(sizes, top1_sims),
        "corr_tv_sim": pearson(tvs, top1_sims),
        "corr_entropy_jpegsize": pearson(entropies, sizes),
        "mean_entropy": float(np.mean(entropies)) if len(entropies) else float("nan"),
        "mean_jpeg_bytes": float(np.mean(sizes)) if len(sizes) else float("nan"),
        "mean_tv": float(np.mean(tvs)) if len(tvs) else float("nan"),
    }


def complexity_correlations(match_images: Sequence[np.ndarray],
                            top1_sims: Sequence[float]) -> tuple[dict, dict]:
    """One pass over in-memory images: (scalars, per-image series)."""
    triples = [complexity_triple(im) for im in match_images]
    t = np.asarray(triples, np.float64).reshape(-1, 3)
    series = {"entropy": t[:, 0], "jpeg_bytes": t[:, 1], "tv": t[:, 2]}
    return correlations_from_series(series, top1_sims), series
