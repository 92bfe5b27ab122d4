"""PyTorch port: kernel builds follow their sources and headers.

``dcr_tpu_torch.ops.build.library_path`` names a kernel library by a hash of
its source, the headers the source includes from its own directory and the
nvcc flags, so an edited header rebuilds instead of loading a stale library.
No nvcc is needed: only the names are computed.
"""

from __future__ import annotations

import importlib.util
import re
import shutil

from dcr_tpu_torch.ops import build
from dcr_tpu_torch.ops import flash_attention as TFA

HEADER = build.CSRC_DIR / "mma_bf16.cuh"
TF32_HEADER = build.CSRC_DIR / "mma_tf32.cuh"


def _csrc_copy(tmp_path):
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    for path in (TFA.SOURCE, *build.CSRC_DIR.glob("*.cuh")):
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
    """Both sources include the bf16 fragment header and the split-TF32 one
    (which includes the bf16 one for cp.async)."""
    assert build.dependencies(TFA.SOURCE) == [TFA.SOURCE, HEADER, TF32_HEADER]
    assert build.dependencies(TFA.BWD_SOURCE) == [TFA.BWD_SOURCE, HEADER, TF32_HEADER]
    assert build.dependencies(TF32_HEADER) == [TF32_HEADER, HEADER]


def _bodies(text: str, pattern: str) -> dict[str, str]:
    """{name: body} of the functions whose definitions match ``pattern``
    (group 1 is the name), each body found by matching braces."""
    out = {}
    for m in re.finditer(pattern, text):
        start = text.index("{", m.end())
        depth = 0
        for end in range(start, len(text)):
            depth += {"{": 1, "}": -1}.get(text[end], 0)
            if depth == 0:
                break
        out[m.group(1)] = text[start:end + 1]
    return out


def _calls_any(body: str, names) -> bool:
    return any(re.search(rf"\b{n}\(", body) for n in names)


def test_every_kernel_that_issues_mma_sync_is_held_to_the_tensor_cores():
    """chip_smoke.py's build phase fails when a kernel of TENSOR_CORE_KERNELS
    has no tensor-core instruction or spills at D=64; every __global__
    kernel in csrc/ that reaches an mma.sync helper must be named there."""
    headers = "".join(p.read_text() for p in sorted(build.CSRC_DIR.glob("*.cuh")))
    helpers = _bodies(headers, r"__device__ __forceinline__ \w+ (\w+)\(")
    issuing = {n for n, body in helpers.items() if "mma.sync" in body}
    while True:
        more = {n for n, body in helpers.items() if n not in issuing and _calls_any(body, issuing)}
        if not more:
            break
        issuing |= more
    assert {"mma", "mma3"} <= issuing
    kernels = {}
    for source in sorted(build.CSRC_DIR.glob("*.cu")):
        kernels.update(_bodies(source.read_text(),
                               r"__global__ void (?:__launch_bounds__\(\w+\) )?(\w+)\("))
    assert {"flash_fwd_tf32x3_kernel", "flash_bwd_dq_tf32x3_kernel",
            "flash_bwd_dkv_tf32x3_kernel"} <= set(kernels)
    on_tensor_cores = {n for n, body in kernels.items() if _calls_any(body, issuing)}
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  build.PKG_DIR.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert on_tensor_cores == set(chip_smoke.TENSOR_CORE_KERNELS)
