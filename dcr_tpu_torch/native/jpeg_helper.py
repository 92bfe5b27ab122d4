"""ctypes binding of the port's baseline JPEG encoder (``jpeg_size.cc``).

The eval's complexity stage measures an image by its JPEG byte size at
quality 95. The JAX package asks libjpeg (or PIL) for it; the port encodes
with its own C++ code, which computes what libjpeg-turbo writes under
``jpeg_set_defaults`` + ``jpeg_set_quality(q, TRUE)`` (4:2:0, islow FDCT,
Annex K tables, standard Huffman tables, JFIF header). Built at first use
into ``dcr_tpu_torch/_build/``; a build or load failure raises.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import numpy as np

from dcr_tpu_torch.ops import build

SOURCE = Path(__file__).with_name("jpeg_size.cc")


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.jpeg_encode
    fn.restype = ctypes.c_long
    fn.argtypes = [ctypes.POINTER(ctypes.c_ubyte), ctypes.c_int, ctypes.c_int, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long]
    return lib


def _rgb(image: np.ndarray) -> np.ndarray:
    arr = np.ascontiguousarray(image)
    if arr.dtype != np.uint8 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"expected an HxWx3 uint8 image, got {arr.dtype} {arr.shape}")
    if not (0 < arr.shape[0] <= 65535 and 0 < arr.shape[1] <= 65535):
        raise ValueError(f"a JPEG side must be 1..65535 pixels, got {arr.shape[:2]}")
    return arr


def _encode(arr: np.ndarray, quality: int, out: np.ndarray | None) -> int:
    ptr = ctypes.POINTER(ctypes.c_ubyte)
    size = _library().jpeg_encode(
        arr.ctypes.data_as(ptr), arr.shape[0], arr.shape[1], int(quality),
        None if out is None else out.ctypes.data_as(ptr), 0 if out is None else out.size)
    if size < 0:
        raise ValueError(f"the JPEG encoder refused an image of shape {arr.shape}")
    return int(size)


def encoded_size(image: np.ndarray, quality: int = 95) -> int:
    """Byte count of the baseline JPEG of an HxWx3 uint8 image."""
    return _encode(_rgb(image), quality, None)


def encode(image: np.ndarray, quality: int = 95) -> bytes:
    """The baseline JPEG file of an HxWx3 uint8 image."""
    arr = _rgb(image)
    out = np.empty(_encode(arr, quality, None), np.uint8)
    _encode(arr, quality, out)
    return out.tobytes()
