"""ctypes binding of the port's JPEG decoder (``jpeg_decode.cc``).

The card's machine has no Pillow and may have no libjpeg, so the port
decodes JPEG with its own C++ code, built at first use into
``dcr_tpu_torch/_build/``. Its pixels follow libjpeg-turbo's defaults
(islow IDCT, fancy upsampling, jdcolor.c's tables), which PIL and the JAX
package's libjpeg helper use, so they can be equal to theirs.

``decode`` decodes at full scale (the JAX eval loader's plain PIL decode);
``decode_scaled`` at the smallest scale M/8 whose shorter side still covers
``min_side``, by the rule of ``dcr_tpu/native/jpeg_decode.cc`` (the JAX
training loader's fast path). A variant the decoder does not read
(arithmetic coding, lossless, hierarchical, 12-bit, CMYK/YCCK, sampling
factors above 2x2) raises :class:`NotPortedError`; truncated or corrupt
data raises ``ValueError``. Both name the file (``name``). There is no
fallback: a decoder that fails to build or load raises too. ctypes releases
the GIL during the call, so threads decode in parallel.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Optional

import numpy as np

from dcr_tpu_torch.core.config import NotPortedError
from dcr_tpu_torch.ops import build

SOURCE = Path(__file__).with_name("jpeg_decode.cc")
_UNSUPPORTED, _CORRUPT, _TOO_SMALL = 1, 2, 3
_ERR_LEN = 512


@functools.cache
def _library() -> ctypes.CDLL:
    lib = build.load(SOURCE)
    fn = lib.jpeg_decode_scaled
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_char_p, ctypes.c_long, ctypes.c_int,
                   ctypes.POINTER(ctypes.c_ubyte), ctypes.c_long,
                   ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
                   ctypes.c_char_p, ctypes.c_long]
    return lib


def sof_dims(data: bytes) -> Optional[tuple[int, int]]:
    """(width, height) from the first frame header, by a header-only scan
    of the marker segments (the JAX helper's ``_parse_sof_dims``); None if
    the scan finds none."""
    i, n = 2, len(data)
    while i + 9 < n:
        if data[i] != 0xFF:
            return None
        marker = data[i + 1]
        if 0xC0 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            return (data[i + 7] << 8) | data[i + 8], (data[i + 5] << 8) | data[i + 6]
        i += 2 + ((data[i + 2] << 8) | data[i + 3])
    return None


def decode_scaled(data: bytes, min_side: int, *, name: str = "JPEG data") -> np.ndarray:
    """uint8 [H, W, 3] RGB at the smallest scale M/8 (M = 1..8) whose
    shorter side, rounded down, is at least ``min_side`` (full scale when
    none is, or when ``min_side <= 0``). H and W round up: ceil(h * M / 8)."""
    lib = _library()
    data = bytes(data)
    dims = sof_dims(data)
    capacity = dims[0] * dims[1] * 3 if dims else 0
    err = ctypes.create_string_buffer(_ERR_LEN)
    for _ in range(2):
        out = np.empty(max(capacity, 1), np.uint8)
        w, h = ctypes.c_int(0), ctypes.c_int(0)
        rc = lib.jpeg_decode_scaled(
            data, len(data), int(min_side), out.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            capacity, ctypes.byref(w), ctypes.byref(h), err, _ERR_LEN)
        if rc != _TOO_SMALL:
            break
        capacity = w.value * h.value * 3   # the header's size disagreed with the scan
    if rc == 0:
        return out[:h.value * w.value * 3].reshape(h.value, w.value, 3)
    message = err.value.decode("utf-8", "replace")
    if rc == _UNSUPPORTED:
        raise NotPortedError(f"{name}: {message} is not read by dcr_tpu_torch's JPEG decoder")
    raise ValueError(f"{name}: {message}")


def decode(data: bytes, *, name: str = "JPEG data") -> np.ndarray:
    """uint8 [H, W, 3] RGB at full scale (grayscale replicated to RGB)."""
    return decode_scaled(data, 0, name=name)
