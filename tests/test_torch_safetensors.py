"""PyTorch port: the safetensors reader and writer against the safetensors
package.

The port's writer is read by ``safetensors.numpy.load_file`` (and by
``safetensors.torch`` for bf16, which numpy lacks); the package's
``save_file`` (F32/F16/BF16/I64/I32, with ``__metadata__``) is read by the
port: bit for bit both ways. A malformed file raises ``ValueError``.
"""

from __future__ import annotations

import json
import struct

import numpy as np
import pytest
import safetensors.numpy as snp
import safetensors.torch as st
import torch

from dcr_tpu_torch.core import safetensors as S


def _tensors() -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(0)
    return {
        "conv.weight": torch.randn(8, 3, 3, 3, generator=g),
        "half": torch.randn(5, 7, generator=g).half(),
        "brain": torch.randn(3, 11, generator=g).bfloat16(),
        "ids": torch.arange(-3, 9, dtype=torch.int64).reshape(3, 4),
        "i32": torch.arange(7, dtype=torch.int32),
        "scalar": torch.tensor(2.5),
        "odd": torch.randn(3, generator=g).half(),     # leaves the next offset unaligned
        "after_odd": torch.randn(2, 2, generator=g),
        "empty": torch.zeros(0, 4),
    }


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def test_port_writer_is_read_by_the_package(tmp_path):
    t = _tensors()
    path = tmp_path / "w.safetensors"
    n = S.save_file(t, path, metadata={"format": "pt", "note": "port"})
    assert n == path.stat().st_size
    back = st.load_file(str(path))
    assert set(back) == set(t) and all(_same(back[k], t[k]) for k in t)
    # numpy has no bf16: the numpy reader gets the rest
    no_bf16 = {k: v for k, v in t.items() if v.dtype != torch.bfloat16}
    S.save_file(no_bf16, tmp_path / "n.safetensors")
    nb = snp.load_file(str(tmp_path / "n.safetensors"))
    for k, v in no_bf16.items():
        assert nb[k].dtype == v.numpy().dtype and np.array_equal(nb[k], v.numpy()), k
    # the header: 8-byte aligned, metadata kept, tensors in the given order
    raw = path.read_bytes()
    (hlen,) = struct.unpack("<Q", raw[:8])
    assert hlen % 8 == 0
    header = json.loads(raw[8:8 + hlen])
    assert header.pop("__metadata__") == {"format": "pt", "note": "port"}
    offsets = [header[k]["data_offsets"] for k in t]
    assert offsets == sorted(offsets) and offsets[0][0] == 0
    assert all(a[1] == b[0] for a, b in zip(offsets, offsets[1:]))


def test_package_writer_is_read_by_the_port(tmp_path):
    t = _tensors()
    st.save_file(t, str(tmp_path / "p.safetensors"), metadata={"format": "pt"})
    mine = S.load_file(tmp_path / "p.safetensors")
    assert set(mine) == set(t) and all(_same(mine[k], t[k]) for k in t)
    arrays = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
              "b": np.arange(5, dtype=np.float16), "c": np.arange(4, dtype=np.int64)}
    snp.save_file(arrays, str(tmp_path / "q.safetensors"))
    mine = S.load_file(tmp_path / "q.safetensors")
    for k, v in arrays.items():
        assert np.array_equal(mine[k].numpy(), v) and mine[k].numpy().dtype == v.dtype


def test_loaded_tensors_are_writable_and_leave_the_file_alone(tmp_path):
    path = tmp_path / "m.safetensors"
    st.save_file({"x": torch.ones(4, 4)}, str(path))
    before = path.read_bytes()
    x = S.load_file(path)["x"]
    x.add_(1)                                    # copy-on-write mapping
    assert torch.equal(x, torch.full((4, 4), 2.0))
    assert path.read_bytes() == before
    assert torch.equal(S.load_file(path)["x"], torch.ones(4, 4))


def _write_raw(path, header: dict, data: bytes) -> None:
    raw = json.dumps(header).encode()
    path.write_bytes(struct.pack("<Q", len(raw)) + raw + data)


@pytest.mark.parametrize("case", ["truncated", "header_past_end", "overlap", "bad_dtype",
                                  "short_span", "offsets_past_end", "not_json",
                                  "bad_metadata", "negative_shape", "empty"])
def test_malformed_files_raise_value_error(tmp_path, case):
    path = tmp_path / f"{case}.safetensors"
    ok = {"a": {"dtype": "F32", "shape": [2], "data_offsets": [0, 8]},
          "b": {"dtype": "F32", "shape": [2], "data_offsets": [8, 16]}}
    data = bytes(16)
    if case == "truncated":
        S.save_file({"a": torch.ones(64)}, path)
        path.write_bytes(path.read_bytes()[:-10])
    elif case == "header_past_end":
        path.write_bytes(struct.pack("<Q", 10_000) + b"{}")
    elif case == "overlap":
        _write_raw(path, {**ok, "b": {"dtype": "F32", "shape": [2], "data_offsets": [4, 12]}},
                   data)
    elif case == "bad_dtype":
        _write_raw(path, {**ok, "a": {"dtype": "F12", "shape": [2], "data_offsets": [0, 8]}},
                   data)
    elif case == "short_span":
        _write_raw(path, {**ok, "a": {"dtype": "F32", "shape": [3], "data_offsets": [0, 8]}},
                   data)
    elif case == "offsets_past_end":
        _write_raw(path, {**ok, "b": {"dtype": "F32", "shape": [4], "data_offsets": [8, 24]}},
                   data)
    elif case == "not_json":
        path.write_bytes(struct.pack("<Q", 4) + b"{{{{")
    elif case == "bad_metadata":
        _write_raw(path, {"__metadata__": {"k": 1}, **ok}, data)
    elif case == "negative_shape":
        _write_raw(path, {**ok, "a": {"dtype": "F32", "shape": [-2], "data_offsets": [0, 8]}},
                   data)
    elif case == "empty":
        path.write_bytes(b"")
    with pytest.raises(ValueError):
        S.load_file(path)


def test_writer_refuses_what_the_format_cannot_hold(tmp_path):
    with pytest.raises(ValueError):
        S.save_file({"c": torch.ones(2, dtype=torch.complex64)}, tmp_path / "c.safetensors")
    with pytest.raises(ValueError):
        S.save_file({"__metadata__": torch.ones(2)}, tmp_path / "m.safetensors")
    with pytest.raises(ValueError):
        S.save_file({"a": torch.ones(2)}, tmp_path / "n.safetensors", metadata={"k": 1})
