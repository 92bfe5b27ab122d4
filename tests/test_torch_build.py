"""PyTorch port: kernel builds follow their sources and headers.

``dcr_tpu_torch.ops.build.library_path`` names a kernel library by a hash of
its source, the headers the source includes from its own directory and the
nvcc flags, so an edited header rebuilds instead of loading a stale library.
No nvcc is needed: only the names are computed.
"""

from __future__ import annotations

import shutil

from dcr_tpu_torch.ops import build
from dcr_tpu_torch.ops import flash_attention as TFA

HEADER = build.CSRC_DIR / "mma_bf16.cuh"


def _csrc_copy(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in (TFA.SOURCE, HEADER):
        shutil.copy(path, csrc / path.name)
    return csrc / TFA.SOURCE.name, csrc / HEADER.name


def test_editing_an_included_header_changes_the_library(tmp_path):
    source, header = _csrc_copy(tmp_path)
    before = build.library_path(source)
    assert build.library_path(source) == before
    header.write_text(header.read_text() + "\n// edited\n")
    after = build.library_path(source)
    assert after != before
    assert after.parent == build.BUILD_DIR and after.name.startswith("libflash_attention_fwd-")


def test_editing_the_source_changes_the_library(tmp_path):
    source, _ = _csrc_copy(tmp_path)
    before = build.library_path(source)
    source.write_text(source.read_text() + "\n// edited\n")
    assert build.library_path(source) != before


def test_a_header_the_source_does_not_include_is_not_hashed(tmp_path):
    source, _ = _csrc_copy(tmp_path)
    before = build.library_path(source)
    (source.parent / "unused.cuh").write_text("// not included\n")
    assert build.library_path(source) == before


def test_both_kernel_sources_depend_on_the_shared_header():
    for source in (TFA.SOURCE, TFA.BWD_SOURCE):
        deps = build.dependencies(source)
        assert deps == [source, HEADER]
