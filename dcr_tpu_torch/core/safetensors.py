"""A reader and writer of the safetensors format, with torch only.

The port's own copy of what the ``safetensors`` package does for the JAX
package (``safetensors.numpy.load_file`` / ``save_file``), because the
card's machine has no such package. The format: an 8-byte little-endian
header length N, N bytes of JSON ``{name: {"dtype", "shape",
"data_offsets": [begin, end]}, "__metadata__": {str: str}}`` padded with
spaces, then the raw little-endian tensor bytes, offsets counted from the
end of the header.

:func:`load_file` maps the file copy-on-write (``mmap.ACCESS_COPY``) and
returns tensors that view the mapping, so a 3.5 GB UNet is read from the
page cache once and not held twice in host memory; a tensor whose offset
is not a multiple of its element size is copied out instead. The header is
checked before any tensor is made: a malformed file raises ``ValueError``
and never yields a short tensor.
"""

from __future__ import annotations

import json
import math
import mmap
import struct
import sys
from pathlib import Path
from typing import Mapping, Optional

import torch

DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
          "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
          "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in DTYPES.items()}
# a header longer than this is not a header (the package's own limit)
MAX_HEADER = 100_000_000


def _header(buf, size: int, where: str) -> tuple[int, dict]:
    """(data start, parsed header) of a file of ``size`` bytes, checked."""
    if size < 8:
        raise ValueError(f"{where}: {size} bytes is too short for a safetensors header")
    (n,) = struct.unpack("<Q", buf[:8])
    if n > MAX_HEADER or 8 + n > size:
        raise ValueError(f"{where}: header length {n} exceeds the file ({size} bytes)")
    try:
        header = json.loads(bytes(buf[8:8 + n]).decode("utf-8"))
    except (UnicodeDecodeError, json.JSONDecodeError) as e:
        raise ValueError(f"{where}: header is not JSON ({e})") from e
    if not isinstance(header, dict):
        raise ValueError(f"{where}: header is not a JSON object")
    meta = header.pop("__metadata__", None)
    if meta is not None and not (isinstance(meta, dict) and all(
            isinstance(k, str) and isinstance(v, str) for k, v in meta.items())):
        raise ValueError(f"{where}: __metadata__ must map strings to strings")
    data_len = size - 8 - n
    spans = []
    for name, info in header.items():
        if not isinstance(info, dict) or set(info) != {"dtype", "shape", "data_offsets"}:
            raise ValueError(f"{where}: entry {name!r} is not "
                             "{dtype, shape, data_offsets}")
        dtype, shape, offsets = info["dtype"], info["shape"], info["data_offsets"]
        if dtype not in DTYPES:
            raise ValueError(f"{where}: {name!r} has unknown dtype {dtype!r}")
        if not (isinstance(shape, list) and all(
                isinstance(d, int) and not isinstance(d, bool) and d >= 0 for d in shape)):
            raise ValueError(f"{where}: {name!r} has a bad shape {shape!r}")
        if not (isinstance(offsets, list) and len(offsets) == 2 and all(
                isinstance(o, int) and not isinstance(o, bool) for o in offsets)):
            raise ValueError(f"{where}: {name!r} has bad data_offsets {offsets!r}")
        begin, end = offsets
        if not 0 <= begin <= end <= data_len:
            raise ValueError(f"{where}: {name!r} spans [{begin}, {end}) outside the "
                             f"{data_len} data bytes")
        itemsize = torch.empty((), dtype=DTYPES[dtype]).element_size()
        if end - begin != math.prod(shape) * itemsize:
            raise ValueError(f"{where}: {name!r} spans {end - begin} bytes but "
                             f"{dtype}{shape} needs {math.prod(shape) * itemsize}")
        spans.append((begin, end, name))
    spans.sort()
    for (_, end0, name0), (begin1, _, name1) in zip(spans, spans[1:]):
        if begin1 < end0:
            raise ValueError(f"{where}: {name0!r} and {name1!r} overlap")
    return 8 + n, header


def load_file(path: str | Path) -> dict[str, torch.Tensor]:
    """Every tensor of a safetensors file, on the CPU, in the header's order."""
    if sys.byteorder != "little":
        raise NotImplementedError("safetensors holds little-endian bytes; this host is not")
    where = str(path)
    with open(path, "rb") as f:
        size = f.seek(0, 2)
        if size == 0:
            raise ValueError(f"{where}: empty file")
        # the tensors keep the mapping alive; a private mapping is writable
        # without touching the file, so torch may view it
        buf = mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_COPY)
    start, header = _header(buf, size, where)
    out: dict[str, torch.Tensor] = {}
    for name, info in header.items():
        dtype, shape = DTYPES[info["dtype"]], info["shape"]
        begin, end = info["data_offsets"]
        itemsize = torch.empty((), dtype=dtype).element_size()
        if begin == end:
            out[name] = torch.empty(shape, dtype=dtype)
        elif (start + begin) % itemsize:
            raw = torch.frombuffer(buf, dtype=torch.uint8, count=end - begin,
                                   offset=start + begin)
            out[name] = raw.clone().view(dtype).reshape(shape)
        else:
            out[name] = torch.frombuffer(buf, dtype=dtype, count=(end - begin) // itemsize,
                                         offset=start + begin).reshape(shape)
    return out


def save_file(tensors: Mapping[str, torch.Tensor], path: str | Path,
              metadata: Optional[Mapping[str, str]] = None) -> int:
    """Write ``tensors`` (any device; copied to the host one at a time) in
    the given order; returns the bytes written. The header is padded with
    spaces to a multiple of 8 bytes, as the format asks."""
    if metadata is not None and not all(isinstance(k, str) and isinstance(v, str)
                                        for k, v in metadata.items()):
        raise ValueError("metadata must map strings to strings")
    header: dict = {} if metadata is None else {"__metadata__": dict(metadata)}
    offset = 0
    for name, t in tensors.items():
        if name == "__metadata__":
            raise ValueError("'__metadata__' is not a tensor name")
        if t.dtype not in _NAMES:
            raise ValueError(f"{name!r}: dtype {t.dtype} has no safetensors name")
        nbytes = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + nbytes]}
        offset += nbytes
    raw = json.dumps(header, separators=(",", ":")).encode("utf-8")
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for t in tensors.values():
            if t.numel():
                host = t.detach().to("cpu").contiguous().reshape(-1)
                f.write(host.view(torch.uint8).numpy().data)
    return 8 + len(raw) + offset
