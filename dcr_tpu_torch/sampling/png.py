"""Minimal PNG codec with stdlib zlib + struct and numpy.

The writer emits 8-bit RGB with filter type 0 on every row. The reader takes
what image folders hold in practice: 8-bit gray, gray + alpha, RGB or RGBA,
non-interlaced, any of the five row filters, and returns RGB (alpha dropped,
gray repeated), as PIL's ``convert("RGB")`` does. Anything else raises
:class:`PNGFormatError`.
"""

from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}   # colour type -> samples per pixel


class PNGFormatError(ValueError):
    """A PNG this reader does not take (or not a PNG at all)."""


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def encode_png(img: np.ndarray) -> bytes:
    """uint8 [H, W, 3] -> PNG bytes (filter type 0 on every row)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8 or img.ndim != 3 or img.shape[2] != 3:
        raise ValueError(f"expected uint8 [H, W, 3], got {img.dtype} {img.shape}")
    h, w, _ = img.shape
    rows = np.concatenate([np.zeros((h, 1), np.uint8), img.reshape(h, w * 3)], axis=1)
    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)  # 8-bit, truecolour
    return (SIGNATURE + _chunk(b"IHDR", header)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), 6)) + _chunk(b"IEND", b""))


def write_png(path: str | Path, img: np.ndarray) -> None:
    Path(path).write_bytes(encode_png(img))


def _unfilter_row(kind: int, row: np.ndarray, prior: np.ndarray, bpp: int) -> np.ndarray:
    """Undo one scanline's filter (PNG spec 9.2); uint8 arithmetic wraps."""
    if kind == 0:
        return row
    if kind == 1:    # Sub: running sum along each channel
        return np.cumsum(row.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
    if kind == 2:    # Up
        return row + prior
    if kind not in (3, 4):
        raise PNGFormatError(f"unknown PNG filter type {kind}")
    out = bytearray(row.tobytes())
    up = prior.tobytes()
    for x in range(len(out)):
        a = out[x - bpp] if x >= bpp else 0
        b = up[x]
        if kind == 3:    # Average
            out[x] = (out[x] + ((a + b) >> 1)) & 0xFF
        else:            # Paeth
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
            out[x] = (out[x] + pred) & 0xFF
    return np.frombuffer(bytes(out), np.uint8)


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> uint8 [H, W, 3] RGB."""
    if not data.startswith(SIGNATURE):
        raise PNGFormatError("not a PNG file (bad signature)")
    pos, header, idat = len(SIGNATURE), None, []
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise PNGFormatError("truncated PNG chunk")
        if tag == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
        pos += 12 + length
    if header is None or not idat:
        raise PNGFormatError("PNG without IHDR or IDAT")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS or interlace != 0:
        raise PNGFormatError(
            f"PNG with bit depth {depth}, colour type {ctype}, interlace {interlace}: "
            "only 8-bit gray, gray+alpha, RGB or RGBA, non-interlaced, is read")
    bpp = _CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != h * (stride + 1):
        raise PNGFormatError(f"PNG data holds {raw.size} bytes, expected {h * (stride + 1)}")
    rows = raw.reshape(h, stride + 1)
    img = np.empty((h, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(h):
        prior = img[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prior, bpp)
    img = img.reshape(h, w, bpp)
    if bpp in (1, 2):
        return np.repeat(img[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(img[:, :, :3])


def read_png(path: str | Path) -> np.ndarray:
    return decode_png(Path(path).read_bytes())
