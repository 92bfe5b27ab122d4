"""Ranked retrieval galleries and the eval plots.

Counterpart of ``dcr_tpu/eval/gallery.py`` without PIL (the card's machine
has none): images are uint8 [H, W, 3] numpy arrays, thumbnails come from the
port's PNG reader and bilinear resize, and pages are written by its PNG
writer. ``ranked_galleries`` pages rows of [query | its top-k train
matches], queries in descending top-1 similarity (reference
diff_retrieval.py:608-640); ``flagged_pair_gallery`` renders copy-risk
evidence as such pages. The plots need matplotlib and return None without
it, as the JAX package's do.
"""

from __future__ import annotations

from pathlib import Path
from typing import Optional, Sequence

import numpy as np

from dcr_tpu_torch.data.dataset import decode_image
from dcr_tpu_torch.eval.features import resize_square
from dcr_tpu_torch.sampling.png import write_png

WHITE = (255, 255, 255)


def concat_h(images: Sequence[np.ndarray], pad: int = 2,
             background: tuple[int, int, int] = WHITE) -> np.ndarray:
    """Images side by side, ``pad`` pixels apart, centred vertically."""
    if not images:
        raise ValueError("no images to concat")
    h = max(im.shape[0] for im in images)
    w = sum(im.shape[1] for im in images) + pad * (len(images) - 1)
    out = np.empty((h, w, 3), np.uint8)
    out[:] = background
    x = 0
    for im in images:
        top = (h - im.shape[0]) // 2
        out[top:top + im.shape[0], x:x + im.shape[1]] = im
        x += im.shape[1] + pad
    return out


def concat_v(images: Sequence[np.ndarray], pad: int = 2,
             background: tuple[int, int, int] = WHITE) -> np.ndarray:
    """Images stacked top to bottom, ``pad`` pixels apart, centred."""
    if not images:
        raise ValueError("no images to concat")
    w = max(im.shape[1] for im in images)
    h = sum(im.shape[0] for im in images) + pad * (len(images) - 1)
    out = np.empty((h, w, 3), np.uint8)
    out[:] = background
    y = 0
    for im in images:
        left = (w - im.shape[1]) // 2
        out[y:y + im.shape[0], left:left + im.shape[1]] = im
        y += im.shape[0] + pad
    return out


def image_grid(images: Sequence[np.ndarray], cols: int) -> np.ndarray:
    """A uint8 grid of float [0, 1] images [H, W, 3], ``cols`` per row: the
    trainer's periodic sample grids (values truncate to uint8 as in the JAX
    package's ``image_grid``)."""
    pix = [(np.clip(a, 0, 1) * 255).astype(np.uint8) for a in images]
    return concat_v([concat_h(pix[i:i + cols]) for i in range(0, len(pix), cols)])


def _load_thumb(path: str | Path, size: int) -> np.ndarray:
    return resize_square(decode_image(str(path)), size)


def ranked_galleries(query_paths: Sequence, train_paths: Sequence,
                     top1: np.ndarray, topk_idx: np.ndarray, out_dir: str | Path,
                     *, rows_per_page: int = 10, max_rank: int = 200,
                     thumb: int = 128) -> list[Path]:
    """PNG pages ``gallery_rank<first>_<last>.png`` of [query | top-k
    matches] rows, ``rows_per_page`` rows each, the ``max_rank`` queries of
    highest top-1 similarity first."""
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    order = np.argsort(-np.asarray(top1))[:max_rank]
    pages: list[Path] = []
    for page_start in range(0, len(order), rows_per_page):
        rows = []
        for qi in order[page_start:page_start + rows_per_page]:
            imgs = [_load_thumb(query_paths[qi], thumb)]
            imgs += [_load_thumb(train_paths[ti], thumb) for ti in topk_idx[qi]]
            rows.append(concat_h(imgs))
        path = out_dir / f"gallery_rank{page_start}_{page_start + len(rows) - 1}.png"
        write_png(path, concat_v(rows))
        pages.append(path)
    return pages


def flagged_pair_gallery(flag_paths: Sequence, match_paths: Sequence,
                         sims: Sequence[float], out_dir: str | Path, *,
                         thumb: int = 128, rows_per_page: int = 10) -> list[Path]:
    """Copy-risk evidence gallery: rows of [flagged generation | nearest
    train match], by descending similarity; the top-1 case of
    :func:`ranked_galleries` (identity match indices), so the pages are the
    offline galleries' kind of artifact."""
    if not (len(flag_paths) == len(match_paths) == len(sims)):
        raise ValueError(
            f"flagged-pair gallery needs aligned lists, got "
            f"{len(flag_paths)}/{len(match_paths)}/{len(sims)}")
    if not flag_paths:
        raise ValueError("no flagged pairs to render")
    return ranked_galleries(
        flag_paths, match_paths, np.asarray(sims, dtype=float),
        np.arange(len(flag_paths))[:, None], out_dir,
        rows_per_page=rows_per_page, max_rank=len(flag_paths), thumb=thumb)


def _pyplot():
    """matplotlib's pyplot on the Agg backend, or None without matplotlib."""
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError:
        return None
    return plt


def _save(plt, out_path: str | Path) -> Path:
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    plt.savefig(out_path)
    plt.close()
    return out_path


def histogram_plot(gen_top1: np.ndarray, bg_top1: np.ndarray,
                   out_path: str | Path) -> Optional[Path]:
    """sim(gen, train) against sim(train, train) density histograms."""
    plt = _pyplot()
    if plt is None:
        return None
    bins = np.linspace(0, 1, 200)
    plt.figure(figsize=(6, 4))
    plt.hist(gen_top1, bins, alpha=0.4, label="sim(gen,train)", density=True)
    plt.hist(bg_top1, bins, alpha=0.6, label="sim(train,train)", density=True)
    plt.legend(loc="upper right")
    return _save(plt, out_path)


def scatter_plot(x: np.ndarray, y: np.ndarray, xlabel: str, ylabel: str,
                 out_path: str | Path) -> Optional[Path]:
    plt = _pyplot()
    if plt is None:
        return None
    plt.figure(figsize=(5, 4))
    plt.scatter(x, y, s=4, alpha=0.5)
    plt.xlabel(xlabel)
    plt.ylabel(ylabel)
    return _save(plt, out_path)


def dup_barplot(dup_mean: float, nondup_mean: float,
                out_path: str | Path) -> Optional[Path]:
    plt = _pyplot()
    if plt is None:
        return None
    plt.figure(figsize=(4, 4))
    plt.bar(["duplicated", "not duplicated"], [dup_mean, nondup_mean])
    plt.ylabel("mean top-1 similarity")
    return _save(plt, out_path)
